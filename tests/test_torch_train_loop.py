"""The port's training loop (``nerfshop_tpu_torch/train/nerf.py::make_train_loop``)
against its own eager steps and against JAX's steps on the same draws, at
the tiny config of ``tests/test_torch_train_step.py`` (R = 64, K = 16, 3
steps). The optimizer is the default config's ``Ema { ExponentialDecay {
Adam } }`` with the decay every 2 steps from step 0, so the learning rate
changes inside the chunk (1e-2, 1e-2, 3.3e-3).

The JAX package is imported inside the fixture that needs it, so that the
card's test run (``-m cuda``, on a machine without JAX) collects this file
and runs its CUDA test, which builds everything from the port."""

import copy

import numpy as np
import pytest
import torch

from nerfshop_tpu_torch.config import default_nerf_config
from nerfshop_tpu_torch.data.nerf_loader import CameraIntrinsics, NerfDataset
from nerfshop_tpu_torch.models import nerf_network as tnn
from nerfshop_tpu_torch.ops import grid as tgrid
from nerfshop_tpu_torch.train import nerf as tnerf, optim as toptim
from torch_one_thread import one_thread  # noqa: F401

R, K, STEPS = 64, 16, 3


def _optimizer_cfg():
    cfg = dict(default_nerf_config()["optimizer"])
    cfg["nested"] = {**cfg["nested"], "decay_start": 0, "decay_interval": 2}
    return cfg


def _draws(n_images, res, seed=11):
    """Stacked numpy draws of STEPS steps: (img_idx, pix, t_jitter, spread, bg)."""
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, n_images, (STEPS, R)).astype(np.int64),
        np.floor(rng.uniform(0, 1, (STEPS, R, 2)) * res).astype(np.float32),
        rng.uniform(0, 1, (STEPS, R)).astype(np.float32),
        rng.uniform(0, 1, (STEPS, R, K)).astype(np.float32),
        rng.uniform(0, 1, (STEPS, R, 3)).astype(np.float32),
    )


def _ball_grid(seed=11):
    """A grid whose occupancy is a ball of jittered radius 0.3 → (grid, occupancy)."""
    rng = np.random.default_rng(seed)
    ijk = (np.indices((128,) * 3).transpose(1, 2, 3, 0) + 0.5) / 128
    occ = (np.linalg.norm(ijk - 0.5, axis=-1) < 0.3 + rng.uniform(-0.05, 0.05, (128,) * 3))[None]
    return tgrid.OccupancyGrid(torch.zeros(1, 128, 128, 128), torch.from_numpy(occ), torch.tensor(0.0)), occ


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / max(np.linalg.norm(np.asarray(b)), 1e-30))


@pytest.fixture(scope="module")
def setup():
    """(JAX model, JAX params, port model, dataset, port grid, occupancy,
    stacked numpy draws, train config), at the tiny config of
    ``tests/test_torch_train_step.py``."""
    pytest.importorskip("jax")
    from test_torch_train_step import TINY, _models, sphere_dataset

    ds = sphere_dataset(3, 16)
    jm, jp, tm = _models(TINY)
    cfg = tnerf.NerfTrainConfig(n_rays_per_batch=R, k_samples=K, n_candidates=256, near_distance=0.05)
    grid, occ = _ball_grid()
    return jm, jp, tm, ds, grid, occ, _draws(3, 16), cfg


def _state(tm):
    return toptim.TrainState(copy.deepcopy(tm), toptim.build_optimizer(_optimizer_cfg()))


def _torch_draws(draws, device="cpu"):
    return tuple(torch.from_numpy(d).to(device) for d in draws)


def test_loop_equals_eager_steps_bit_for_bit(setup):
    # the loop on the CPU runs the eager steps: losses, parameters, EMA and
    # Adam's moments bit-equal to three grads_from_draws + apply_gradients
    _, _, tm, ds, grid, _, draws, cfg = setup
    data = tnerf.DeviceDataset.from_dataset(ds, "cpu")
    seq, looped = _state(tm), _state(tm)
    td = _torch_draws(draws)
    losses = []
    for i in range(STEPS):
        grads, aux = tnerf.grads_from_draws(seq.model, grid, data, cfg, *(d[i] for d in td))
        seq.apply_gradients(grads)
        losses.append(aux["loss"])
    loop = tnerf.make_train_loop(looped, grid, data, cfg, STEPS)
    assert not loop.captured
    ys = loop.run(grid, td)
    assert set(ys) == set(tnerf.LOOP_OUTPUTS) and all(v.shape == (STEPS,) for v in ys.values())
    assert torch.equal(ys["loss"], torch.stack(losses))
    assert seq.step == looped.step == STEPS
    assert all(torch.equal(a, b) for a, b in zip(seq.tensors(), looped.tensors()))
    assert float(looped.lr) == pytest.approx(1e-2 * 0.33)  # the third step's rate


@pytest.mark.parametrize("decay", [False, True], ids=["constant-rate", "decay-every-2"])
def test_loop_matches_jax_steps(setup, decay):
    # three JAX steps (nerf_loss_fn under value_and_grad, then optax through
    # nerfshop_tpu.train.optim.apply_gradients) on the same draws: each
    # step's loss within 1e-4 relative; the parameters and the EMA after
    # them within 2e-3 (relative L2 norm), the bound of the gradients
    # (test_torch_train_step.py), since Adam's update is scale-free
    import jax
    import jax.numpy as jnp

    from nerfshop_tpu.ops import coords as jcoords, march as jmarch, rays as jrays
    from nerfshop_tpu.train import losses as jlosses, nerf as jnerf, optim as joptim
    from nerfshop_tpu_torch import weights

    jm, jp, tm, ds, grid, occ, draws, cfg = setup
    opt_cfg = _optimizer_cfg() if decay else {**_optimizer_cfg(), "nested": {
        **_optimizer_cfg()["nested"], "decay_interval": 10000}}
    spec = joptim.build_optimizer(opt_cfg)
    jstate = joptim.create_train_state(jp, spec)
    dev = jnerf.DeviceDataset.from_dataset(ds)
    aabb = jcoords.BoundingBox.from_aabb_scale(1)
    res = jnp.asarray([16.0, 16.0])
    occ_j = jnp.asarray(occ)

    @jax.jit
    def jax_step(params, img_idx, pix, t_jitter, spread, bg):
        bundle = jrays.rays_from_pixels(img_idx, pix, dev.xforms, dev.focals, dev.principals, res, dev.distortions)
        samples = jmarch.march_rays(
            bundle.origins, bundle.directions, occ_j, aabb.min, aabb.max, jnp.asarray(0.0), t_jitter=t_jitter,
            t_start_min=0.05, k_samples=K, n_candidates=256, selection="spread", spread_rng=spread,
        )
        targets = dev.images[img_idx, pix[:, 1].astype(jnp.int32), pix[:, 0].astype(jnp.int32)]
        return jax.value_and_grad(jnerf.nerf_loss_fn, has_aux=True)(
            params, jm, samples, bundle.origins, bundle.directions, targets, bg, aabb,
            jlosses.huber, cfg.min_transmittance, near_distance=0.05, mean_grid_density=jnp.asarray(0.0),
        )

    jlosses_ = []
    for i in range(STEPS):
        (jl, _), jg = jax_step(jstate.params, *(jnp.asarray(d[i]) for d in draws))
        jstate = joptim.apply_gradients(jstate, jg, spec)
        jlosses_.append(float(jl))

    state = toptim.TrainState(copy.deepcopy(tm), toptim.build_optimizer(opt_cfg))
    ys = tnerf.make_train_loop(state, grid, tnerf.DeviceDataset.from_dataset(ds, "cpu"), cfg, STEPS).run(
        grid, _torch_draws(draws)
    )
    np.testing.assert_allclose(ys["loss"].numpy(), jlosses_, rtol=1e-4)
    jparams = weights.params_from_jax(jax.tree.map(np.asarray, jstate.params))
    jema = weights.params_from_jax(jax.tree.map(np.asarray, jstate.ema_params))
    for name, p in state.model.named_parameters():
        assert _rel(p.detach().numpy(), jparams[name].numpy()) < 2e-3, name
        assert _rel(state.ema[name].numpy(), jema[name].numpy()) < 2e-3, name
    # the last step ran at the schedule's rate for its own step
    adam, sched, _ = joptim._unwrap(opt_cfg)
    assert float(state.lr) == pytest.approx(float(joptim.make_schedule(adam, sched)(STEPS - 1)), rel=1e-6)


def test_captured_loop_needs_cuda():
    data = tnerf.DeviceDataset(*(torch.zeros(s) for s in ((1, 4, 4, 4), (1, 3, 4), (1, 2), (1, 2), (1, 4))))
    model = tnn.build_nerf_network(CUDA_CFG, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tnerf.make_train_loop(toptim.TrainState(model, toptim.build_optimizer(_optimizer_cfg())), _ball_grid()[0],
                              data, tnerf.NerfTrainConfig(n_rays_per_batch=R, k_samples=K), STEPS, captured=True)


#: a small network inside kernels A, B and C's range (D = 3, F = 2; the
#: density MLP's 16 inputs and the rgb MLP's 32, 64 wide)
CUDA_CFG = {
    "loss": {"otype": "Huber"},
    "encoding": {"otype": "HashGrid", "n_levels": 8, "n_features_per_level": 2,
                 "log2_hashmap_size": 14, "base_resolution": 8, "per_level_scale": 1.5},
    "network": {"n_neurons": 64, "n_hidden_layers": 1},
    "dir_encoding": {"otype": "SphericalHarmonics", "degree": 4},
    "rgb_network": {"n_neurons": 64, "n_hidden_layers": 2},
}


def _look_at(eye):
    fwd = 0.5 - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    return np.concatenate([np.stack([right, np.cross(fwd, right), fwd], 1), eye[:, None]], 1).astype(np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the captured loop replays a CUDA graph")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_captured_loop_equals_eager_on_cuda(cuda):
    # two replays of the captured 3-step loop against the eager loop from the
    # same state and draws (random images seen by 3 cameras around the
    # ball): each step's loss within 1e-4 relative and every parameter,
    # Adam and EMA tensor within 1e-3 (relative L2 norm); bit-equal is
    # expected, since both run the same kernels in the same order
    res, n = 16, 3
    rng = np.random.default_rng(5)
    xforms = np.stack([_look_at(0.5 + 1.3 * np.array([np.cos(a), np.sin(a), 0.3], np.float32))
                       for a in np.linspace(0, 2 * np.pi, n, endpoint=False)])
    intr = [CameraIntrinsics(np.full(2, res * 1.1, np.float32), np.full(2, 0.5, np.float32), np.zeros(4, np.float32),
                             np.array([res, res], np.int32))] * n
    ds = NerfDataset(images=rng.uniform(0, 1, (n, res, res, 4)).astype(np.float32), xforms=xforms, intrinsics=intr,
                     paths=[""] * n, aabb_scale=1)
    data = tnerf.DeviceDataset.from_dataset(ds, cuda)
    grid, _ = _ball_grid()
    grid = tgrid.OccupancyGrid(grid.density.to(cuda), grid.occupancy.to(cuda), grid.mean_density.to(cuda))
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    model = tnn.build_nerf_network(CUDA_CFG, device=cuda, generator=g)
    cfg = tnerf.NerfTrainConfig(n_rays_per_batch=R, k_samples=K, n_candidates=256, near_distance=0.05)
    draws = tuple(torch.from_numpy(d).to(cuda) for d in _draws(n, res))
    runs = []
    for captured in (False, True):
        state = toptim.TrainState(copy.deepcopy(model), toptim.build_optimizer(_optimizer_cfg()))
        loop = tnerf.make_train_loop(state, grid, data, cfg, STEPS, captured=captured)
        losses = torch.cat([loop.run(grid, draws)["loss"] for _ in range(2)])
        runs.append((losses.cpu().numpy(), state, loop))
    (le, se, _), (lc, sc, loop) = runs
    assert loop.replays == 2 and loop.graph_launches
    assert np.isfinite(le).all()
    np.testing.assert_allclose(lc, le, rtol=1e-4)
    for a, b in zip(sc.tensors(), se.tensors()):
        assert _rel(a.cpu().numpy(), b.cpu().numpy()) < 1e-3
