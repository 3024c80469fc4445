"""Pose, exposure and distortion-map optimization and the error map of the
port (``ops/rays.py``, ``train/nerf.py``) against ``nerfshop_tpu``: the
exp map and the pose delta, the differentiable rays, one training step's
gradients with the options on against JAX's ``make_grad_fn`` given the
same draws, the error map's deposit and the sampler's mapping exactly,
and the port's sampler against the map's probabilities; then the port's
``Testbed`` with every knob on, on the CPU.

Tolerances: rays and the exp map within 1e-6 (float32, the same formulas;
matrix products in another order); the step's loss within 1e-4 relative
and every gradient within 2e-3 relative L2 norm (the bound of
``tests/test_torch_train_step.py``: both sides round the MLPs' operands and
cotangents to bf16 at the same points, and a value on a rounding boundary
can round the other way under another summation order); the error map and
the cell-to-pixel mapping exactly."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfshop_tpu.ops import grid as jgrid, rays as jrays
from nerfshop_tpu.train import nerf as jnerf
from nerfshop_tpu_torch import weights
from nerfshop_tpu_torch.ops import rays as trays
from nerfshop_tpu_torch.train import nerf as tnerf
from test_torch_train_loop import _ball_grid
from test_torch_train_step import TINY, _models, _rel, sphere_dataset
from torch_one_thread import one_thread  # noqa: F401


def _rotvecs():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(8, 3)).astype(np.float32) * 0.3
    v[0] = 0.0
    v[1] = [3e-5, -2e-5, 1e-5]  # θ² < 1e-8: the series branch
    return v


def test_rodrigues_and_pose_delta_match_jax():
    v = _rotvecs()
    np.testing.assert_allclose(trays.rodrigues(torch.from_numpy(v)).numpy(), np.asarray(jrays.rodrigues(jnp.asarray(v))),
                               rtol=0, atol=1e-6)
    xf = sphere_dataset(8, 8).xforms
    t = np.random.default_rng(1).normal(size=(8, 3)).astype(np.float32) * 0.05
    got = trays.apply_pose_delta(torch.from_numpy(xf), torch.from_numpy(v), torch.from_numpy(t)).numpy()
    ref = np.asarray(jrays.apply_pose_delta(jnp.asarray(xf), jnp.asarray(v), jnp.asarray(t)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_rodrigues_gradient_at_zero_is_finite_and_matches():
    w = np.random.default_rng(2).normal(size=(3, 3)).astype(np.float32)
    ref = np.asarray(jax.grad(lambda r: jnp.sum(jrays.rodrigues(r) * w))(jnp.zeros(3)))
    r = torch.zeros(3, requires_grad=True)
    (trays.rodrigues(r) * torch.from_numpy(w)).sum().backward()
    assert np.isfinite(r.grad.numpy()).all() and np.abs(ref).max() > 0.1
    np.testing.assert_allclose(r.grad.numpy(), ref, rtol=0, atol=1e-6)


def _camera_leaves(n_images, res=8, seed=3):
    rng = np.random.default_rng(seed)
    return {
        "rot": rng.normal(size=(n_images, 3)).astype(np.float32) * 0.02,
        "trans": rng.normal(size=(n_images, 3)).astype(np.float32) * 0.02,
        "log_exposure": rng.normal(size=(n_images,)).astype(np.float32) * 0.1,
        "distortion_map": rng.normal(size=(res, res, 2)).astype(np.float32) * 0.01,
    }


def test_rays_from_pixels_with_camera_params_and_gradients():
    ds = sphere_dataset(3, 16)
    dev = jnerf.DeviceDataset.from_dataset(ds)
    cam = _camera_leaves(3)
    rng = np.random.default_rng(4)
    img_idx = rng.integers(0, 3, 64).astype(np.int32)
    pix = np.floor(rng.uniform(0, 1, (64, 2)) * 16).astype(np.float32)
    a, b = (rng.normal(size=(64, 3)).astype(np.float32) for _ in range(2))
    res = np.asarray([16.0, 16.0], np.float32)

    def jloss(c):
        bd = jrays.rays_from_pixels(jnp.asarray(img_idx), jnp.asarray(pix), dev.xforms, dev.focals, dev.principals,
                                    jnp.asarray(res), dev.distortions, c)
        return jnp.sum(bd.origins * a + bd.directions * b), bd

    (jl, jb), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))({k: jnp.asarray(v) for k, v in cam.items()})
    data = tnerf.DeviceDataset.from_dataset(ds, "cpu")
    tc = {k: torch.from_numpy(v).requires_grad_(True) for k, v in cam.items()}
    tb = trays.rays_from_pixels(torch.from_numpy(img_idx), torch.from_numpy(pix), data.xforms, data.focals,
                                data.principals, torch.from_numpy(res), data.distortions, tc)
    np.testing.assert_allclose(tb.origins.detach().numpy(), np.asarray(jb.origins), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tb.directions.detach().numpy(), np.asarray(jb.directions), rtol=0, atol=1e-6)
    (tb.origins * torch.from_numpy(a) + tb.directions * torch.from_numpy(b)).sum().backward()
    for k in ("rot", "trans", "distortion_map"):
        ref = np.asarray(jg[k])
        assert np.abs(ref).max() > 1e-3, k
        assert _rel(tc[k].grad.numpy(), ref) < 1e-5, k
    assert tc["log_exposure"].grad is None  # the rays do not read it


R, K = 64, 16


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, JAX params, port model) at the tiny config of
    ``tests/test_torch_train_step.py``, the port's weights carried from JAX."""
    return _models(TINY)


@pytest.fixture(scope="module")
def step_case(tiny):
    """JAX's make_grad_fn with extrinsics (pose deltas and the distortion
    map), exposure and the envmap on, and the draws it makes from its key,
    at the tiny config of ``tests/test_torch_train_step.py``."""
    ds = sphere_dataset(3, 16)
    jm, jp, tm = tiny
    jp = dict(jp, camera={k: jnp.asarray(v) for k, v in _camera_leaves(3).items()},
              envmap=jnp.asarray(np.random.default_rng(5).uniform(0, 1, (8, 16, 4)).astype(np.float32)))
    jcfg = jnerf.NerfTrainConfig(n_rays_per_batch=R, k_samples=K, n_candidates=256, near_distance=0.05,
                                 optimize_extrinsics=True, optimize_exposure=True, train_envmap=True)
    grid, occ = _ball_grid()
    jg_grid = jgrid.OccupancyGrid.create(1)._replace(occupancy=jnp.asarray(occ), mean_density=jnp.asarray(0.0))
    data = jnerf.DeviceDataset.from_dataset(ds)
    key = jax.random.PRNGKey(7)
    grads, aux = jax.jit(jnerf.make_grad_fn(jm, jcfg))(jp, jg_grid, data, key)
    # the draws make_grad_fn makes from its key (train/nerf.py, rays.py, march.py)
    k_rays, k_march, k_bg, _ = jax.random.split(key, 4)
    k_img, k_pix, _ = jax.random.split(k_rays, 3)
    img_idx = jax.random.randint(k_img, (R,), 0, 3)
    pix = jnp.clip(jnp.floor(jax.random.uniform(k_pix, (R, 2)) * 16.0), 0, 15)
    k1, k2 = jax.random.split(k_march)
    draws = (img_idx, pix, jax.random.uniform(k1, (R,)), jax.random.uniform(k2, (R, K)), jax.random.uniform(k_bg, (R, 3)))
    assert np.array_equal(np.asarray(aux["img_idx"]), np.asarray(img_idx)) and np.array_equal(aux["pix"], pix)
    return ds, jp, tm, grid, jcfg, grads, aux, tuple(torch.from_numpy(np.array(d)) for d in draws)


def test_step_gradients_match_make_grad_fn(step_case):
    ds, jp, tm, grid, jcfg, jgrads, jaux, draws = step_case
    cfg = tnerf.NerfTrainConfig(**{k: getattr(jcfg, k) for k in tnerf.NerfTrainConfig.__dataclass_fields__})
    extra = {k: v.requires_grad_(True) for k, v in weights.params_from_jax(jax.tree.map(np.asarray, jp)).items()
             if k == "envmap" or k.startswith("camera.")}
    assert set(extra) == {"camera.rot", "camera.trans", "camera.log_exposure", "camera.distortion_map", "envmap"}
    grads, aux = tnerf.grads_from_draws(tm, grid, tnerf.DeviceDataset.from_dataset(ds, "cpu"), cfg, *draws, extra=extra)
    assert int(aux["measured_samples"]) == int(jaux["measured_samples"]) > R
    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=1e-4)
    jflat = weights.params_from_jax(jax.tree.map(np.asarray, jgrads))
    assert set(jflat) == set(grads)
    for name, g in grads.items():
        assert float(g.abs().max()) > 0, name
        assert _rel(g.numpy(), jflat[name].numpy()) < 2e-3, (name, _rel(g.numpy(), jflat[name].numpy()))


def test_error_map_deposit_decay_and_sharpness_exact():
    # losses and sharpness on a 1/64 grid, so that every sum is exact
    # whatever its order
    rng = np.random.default_rng(6)
    n, N, H, W = 512, 3, 20, 24
    em = rng.integers(0, 64, (N, 8, 8)).astype(np.float32) / 64
    img_idx = rng.integers(0, N, n).astype(np.int32)
    pix = np.stack([rng.integers(0, W, n), rng.integers(0, H, n)], -1).astype(np.float32)
    loss = rng.integers(0, 64, n).astype(np.float32) / 64
    sharp = np.asarray([0.5, 1.25, 1.25], np.float32)
    for s in (None, sharp):
        ref = np.asarray(jnerf.update_error_map(jnp.asarray(em), jnp.asarray(img_idx), jnp.asarray(pix),
                                                jnp.asarray(loss), (N, H, W, 4), 0.75,
                                                None if s is None else jnp.asarray(s)))
        got = tnerf.update_error_map(torch.from_numpy(em), torch.from_numpy(img_idx), torch.from_numpy(pix),
                                     torch.from_numpy(loss), (N, H, W, 4), 0.75,
                                     None if s is None else torch.from_numpy(s))
        np.testing.assert_array_equal(got.numpy(), ref)


def test_error_map_pixels_match_jax_given_cells_and_jitter():
    rng = np.random.default_rng(7)
    N, H, W, n = 3, 37, 53, 4096
    images = jnp.asarray(rng.uniform(0, 1, (N, H, W, 4)).astype(np.float32))
    em = jnp.asarray(rng.uniform(0, 1, (N, 8, 16)).astype(np.float32))
    key = jax.random.PRNGKey(8)
    img_idx, pix, targets = jrays.sample_training_pixels(key, n, images, em)
    # the cells and jitter sample_training_pixels drew (ops/rays.py:243-270)
    k_img, k_pix, k_err = jax.random.split(key, 3)
    cells = jax.random.categorical(k_err, jnp.log(em[img_idx].reshape(n, -1) + 1e-8), axis=-1)
    jit = jax.random.uniform(k_pix, (n, 2))
    got = trays.pixels_from_cells(torch.from_numpy(np.array(cells)).long(), torch.from_numpy(np.array(jit)), (8, 16), W, H)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pix))


def _chi2_critical(k: int) -> float:
    """The chi-square statistic that k degrees of freedom exceed with
    probability 1e-3, by the Wilson-Hilferty cube-root normal approximation
    (within 0.6% of the exact quantile for k ≥ 10)."""
    z = 3.090232306167813  # the standard normal's 1 − 1e-3 quantile
    return k * (1.0 - 2.0 / (9.0 * k) + z * (2.0 / (9.0 * k)) ** 0.5) ** 3


def test_error_map_sampler_follows_the_map():
    # the port's cells (one uniform a ray through the per-image CDF) against
    # the map's probabilities: a chi-square test at a fixed seed, p > 1e-3
    rng = np.random.default_rng(9)
    em = torch.from_numpy(rng.uniform(0, 1, (4, 6, 6)).astype(np.float32) ** 3)
    em[2, 0, :] = 0.0  # cells a step never deposited into
    n = 1 << 15
    g = torch.Generator().manual_seed(10)
    img_idx = torch.randint(0, 4, (n,), generator=g)
    cells = trays.error_map_cells(img_idx, torch.rand(n, generator=g), trays.error_map_cdf(em), 36)
    for i in range(4):
        w = em[i].reshape(-1).double().numpy() + 1e-8
        obs = np.bincount(cells[img_idx == i].numpy(), minlength=36)
        exp = w / w.sum() * obs.sum()
        if i == 2:
            assert obs[:6].sum() == 0  # the empty row: expected 1.5e-5 draws in all
        # cells expecting fewer than 5 draws pooled into one bin (the
        # chi-square approximation's usual condition)
        keep = exp >= 5
        obs_b = np.append(obs[keep], obs[~keep].sum())
        exp_b = np.append(exp[keep], exp[~keep].sum())
        stat = float(((obs_b - exp_b) ** 2 / exp_b).sum())
        assert len(obs_b) > 10 and stat < _chi2_critical(len(obs_b) - 1), (i, stat)


def test_testbed_trains_with_every_option():
    # the knobs on the port's Testbed (CPU): the camera and envmap leaves
    # move, the error map changes, the loop runs its steps, and the render
    # composites the envmap behind the transparent pixels
    from nerfshop_tpu_torch.testbed import Testbed

    tb = Testbed("nerf", config=TINY, device="cpu", seed=2)
    t = tb.nerf.training
    t.optimize_extrinsics = t.optimize_exposure = t.optimize_distortion = t.use_error_map = t.train_envmap = True
    tb.set_training_data(sphere_dataset(3, 16))
    cfg = tb.train_config
    assert cfg.optimize_extrinsics and cfg.optimize_exposure and cfg.use_error_map and cfg.train_envmap
    extra = tb._state.extra
    assert set(extra) == {"camera.rot", "camera.trans", "camera.log_exposure", "camera.distortion_map", "envmap"}
    assert extra["camera.distortion_map"].shape == (32, 32, 2) and extra["envmap"].shape == (64, 128, 4)
    loss = tb.train(n_steps=3, batch_size=1 << 13)
    assert np.isfinite(loss) and tb.stats.step == 3
    for k, v in extra.items():
        assert float(v.detach().abs().max()) > 0, k
    em = tb._error_map
    assert em.shape == (3, 32, 32) and not torch.equal(em, torch.ones_like(em))
    img = tb.render(8, 6, linear=True)
    assert img.shape == (6, 8, 4) and float(img[..., 3].min()) > 0.99


def _optimizer_cfg():
    from nerfshop_tpu_torch.config import default_nerf_config

    return dict(default_nerf_config()["optimizer"])


def test_camera_and_envmap_leaves_step_as_jax(tiny):
    # JAX's create_train_state: the camera and envmap leaves beside the
    # network's in one Adam + EMA at the schedule's rate; the port's
    # TrainState on the same gradients gives the same leaves, within 1e-5
    # relative (float32 Adam, the same formulas)
    from nerfshop_tpu.train import optim as joptim
    from nerfshop_tpu_torch.train import optim as toptim

    _, jp, tm = tiny
    tm = copy.deepcopy(tm)
    cfg = _optimizer_cfg()
    cam = _camera_leaves(3)
    env = np.random.default_rng(14).uniform(0, 1, (4, 8, 4)).astype(np.float32)
    extra = {f"camera.{k}": torch.from_numpy(v) for k, v in cam.items()}
    extra["envmap"] = torch.from_numpy(env)
    state = toptim.TrainState(tm, toptim.build_optimizer(cfg), extra)
    rng = np.random.default_rng(13)
    steps = [{k: torch.from_numpy(rng.normal(size=tuple(p.shape)).astype(np.float32)) for k, p in state.named}
             for _ in range(2)]
    spec = joptim.build_optimizer(cfg)
    jstate = joptim.create_train_state(jax.tree.map(jnp.asarray, dict(jp, camera=cam, envmap=env)), spec)
    jstep = jax.jit(lambda s, g: joptim.apply_gradients(s, g, spec))
    for g in steps:
        state.apply_gradients(g)
        jgrads = weights.params_to_jax(g)
        jgrads["dir_encoding"] = jp["dir_encoding"]  # no trainable leaves
        jstate = jstep(jstate, jax.tree.map(jnp.asarray, jgrads))
    jflat = weights.params_from_jax(jax.tree.map(np.asarray, jstate.params))
    jema = weights.params_from_jax(jax.tree.map(np.asarray, jstate.ema_params))
    live = dict(state.named)
    ema = dict(state.inference_params, **state.inference_extra)
    assert set(live) == set(ema) and {"camera.rot", "camera.distortion_map", "envmap"} <= set(live)
    for name in live:
        np.testing.assert_allclose(live[name].detach().numpy(), jflat[name].numpy(), rtol=1e-5, atol=1e-7, err_msg=name)
        np.testing.assert_allclose(ema[name].numpy(), jema[name].numpy(), rtol=1e-5, atol=1e-7, err_msg=name)


@pytest.mark.xfail(strict=True, reason="F16 (ROADMAP.md Queue 3): nerfshop_tpu/train/optim.py:104 steps the camera "
                   "leaves in the network's one Adam at its rate (1e-2) every step, where the reference steps them "
                   "in Adams of their own every 16 steps with a decayed rate and L2 (SURVEY.md T6, R6): perturbed "
                   "poses drift away from the truth instead of back to it")
def test_jax_pose_refinement_keeps_perturbed_poses_near_the_truth(tiny, step_case):
    # JAX's make_grad_fn and apply_gradients from the step case's fixture
    # (its camera leaves perturb the poses by 0.042 rad and 0.035 units on
    # average):
    # after 16 steps the mean rotation and translation errors of the
    # corrected poses should not have doubled
    from nerfshop_tpu.train import optim as joptim

    jm = tiny[0]
    ds, jp, _, _, jcfg, _, _, _ = step_case
    _, occ = _ball_grid()
    grid = jgrid.OccupancyGrid.create(1)._replace(occupancy=jnp.asarray(occ), mean_density=jnp.asarray(0.0))
    data = jnerf.DeviceDataset.from_dataset(ds)
    spec = joptim.build_optimizer(dict(TINY["optimizer"]))
    grad_fn = jax.jit(jnerf.make_grad_fn(jm, jcfg))
    step = jax.jit(lambda s, g: joptim.apply_gradients(s, g, spec))
    state = joptim.create_train_state(jp, spec)

    def errors(p):
        return [float(np.linalg.norm(np.asarray(p["camera"][k]), axis=1).mean()) for k in ("rot", "trans")]

    start = errors(state.params)
    for key in jax.random.split(jax.random.PRNGKey(15), 16):
        grads, _ = grad_fn(state.params, grid, data, key)
        state = step(state, dict(grads, dir_encoding=state.params["dir_encoding"]))
    end = errors(state.params)
    assert end[0] < 2 * start[0] and end[1] < 2 * start[1], (start, end)
