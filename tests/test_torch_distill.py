"""The port's distillation (``nerfshop_tpu_torch/train/distill.py``) against
``nerfshop_tpu/train/distill.py`` on the same weights, operators and draws.

JAX's step is a closure over its draws, so the loss is rebuilt here from the
JAX package's public pieces (``teacher_field``, ``_edit_region_bounds``,
``rays_from_pixels``, ``march_rays(selection="spread")``, ``composite`` and
the network), term for term as ``make_distill_step``'s ``loss_of`` writes
it, and fed the draws the port takes as arrays. Both sides then march the
same samples: XLA compiles JAX's march with the ladder t0 + m·dt as one
fused multiply-add, so a candidate on a cell boundary may see the other
cell and a ray gain or lose a sample (one of 64 rays here); the test checks
that the port's own march agrees on all but a few rays and then hands the
JAX samples to the port's step (the march is held to JAX in
``test_torch_march_composite.py``). The loss is held within
1e-4 relative and every gradient within 2e-3 relative (L2): the bounds of
the training-step test, for the same bf16 rounding points."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfshop_tpu.ops import composite as jcomp
from nerfshop_tpu.ops import coords as jcoords
from nerfshop_tpu.ops import march as jmarch
from nerfshop_tpu.ops import rays as jrays
from nerfshop_tpu.train import distill as jdistill
from nerfshop_tpu.train import nerf as jnerf
from nerfshop_tpu_torch import weights
from nerfshop_tpu_torch.train import distill as tdistill
from nerfshop_tpu_torch.train import nerf as tnerf
from test_torch_edit_render import _close, jax_stack, scene  # noqa: F401 (fixtures)
from test_torch_editing import _stack_ambiguous
from test_torch_membrane import membrane_case  # noqa: F401 (fixture)
from test_torch_train_step import sphere_dataset
from torch_one_thread import one_thread  # noqa: F401

CPU = torch.device("cpu")
R, K, NF, NE = 64, 16, 256, 512


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def stacks(membrane_case, jax_stack):
    """[the moved cube cage with its membrane, an affine duplicate] (JAX) and
    the port's copy."""
    jop, *_ = membrane_case
    jops = [jop, jax_stack[0][1]]
    return jops, weights.operators_from_jax(jops, CPU)


def test_teacher_field_matches_jax(scene, stacks):
    jm, jparams, _, tm, _ = scene
    jops, tops = stacks
    rng = np.random.default_rng(0)
    p = rng.uniform(0.05, 0.95, (3000, 3)).astype(np.float32)
    d = rng.normal(size=(3000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    jr, js, jt = (np.asarray(a) for a in jdistill.teacher_field(
        jm, jparams, tuple(jops), jnp.asarray(p), jnp.asarray(d), jcoords.BoundingBox.unit()))
    tr, ts, tt = tdistill.teacher_field(tm, None, tuple(tops), torch.from_numpy(p), torch.from_numpy(d),
                                        tdistill.coords.BoundingBox.from_aabb_scale(1, device=CPU))
    ok = ~_stack_ambiguous(jops[0], p)
    np.testing.assert_array_equal(tt.numpy()[ok], jt[ok])
    assert jt.mean() > 0.1 and not jt.all()
    # the field's outputs: bf16 rounding flips reach a few 1e-4 on single
    # values (test_torch_edit_render.py's bound), 2e-3 relative (L2) overall
    _close(tr.numpy()[ok], jr[ok])
    assert _rel(tr.numpy()[ok], jr[ok]) < 2e-3 and _rel(ts.numpy()[ok], js[ok]) < 2e-3


def test_edit_region_bounds_match(stacks):
    jops, tops = stacks
    ref = jdistill._edit_region_bounds(tuple(jops))
    ours = tdistill._edit_region_bounds(tuple(tops))
    assert len(ours) == len(ref) == 4
    for (lo, hi), (jlo, jhi) in zip(ours, ref):
        np.testing.assert_allclose(lo.numpy(), np.asarray(jlo), rtol=0, atol=1e-6)
        np.testing.assert_allclose(hi.numpy(), np.asarray(jhi), rtol=0, atol=1e-6)


def _draws(n_regions, seed=1):
    rng = np.random.default_rng(seed)
    per = -(-NE // n_regions)
    f = np.float32
    return tdistill.DistillDraws(
        img_idx=torch.from_numpy(rng.integers(0, 3, R).astype(np.int32)),
        pix=torch.from_numpy(np.floor(rng.uniform(0, 1, (R, 2)) * 16).astype(f)),
        t_jitter=torch.from_numpy(rng.uniform(0, 1, R).astype(f)),
        spread=torch.from_numpy(rng.uniform(0, 1, (R, K)).astype(f)),
        free_u=torch.from_numpy(rng.uniform(0, 1, (NF, 3)).astype(f)),
        edit_u=torch.from_numpy(rng.uniform(0, 1, (n_regions, per, 3)).astype(f)),
        edit_normals=torch.from_numpy(rng.normal(size=(n_regions * per, 3)).astype(f)),
    )


def _jax_loss(jm, t_params, ops, data, occ, cfg, dr):
    """``make_distill_step``'s ``loss_of`` on the given draws → a function of
    the student's params → (loss, aux)."""
    aabb = jcoords.BoundingBox.from_aabb_scale(cfg.aabb_scale)
    img_idx, pix = jnp.asarray(dr.img_idx.numpy()), jnp.asarray(dr.pix.numpy())
    H, W = data.images.shape[1:3]
    bundle = jrays.rays_from_pixels(img_idx, pix, data.xforms, data.focals, data.principals,
                                    jnp.asarray([float(W), float(H)]), data.distortions)
    targets = data.images[img_idx, pix[:, 1].astype(int), pix[:, 0].astype(int)]
    samples = jmarch.march_rays(
        bundle.origins, bundle.directions, occ, aabb.min, aabb.max, jnp.asarray(cfg.cone_angle),
        t_jitter=jnp.asarray(dr.t_jitter.numpy()), t_start_min=cfg.near_distance, k_samples=cfg.k_samples,
        n_candidates=1024, selection="spread", spread_rng=jnp.asarray(dr.spread.numpy()),
    )
    Rr, Kk = samples.t.shape
    pos_world = (bundle.origins[:, None, :] + samples.t[..., None] * bundle.directions[:, None, :]).reshape(-1, 3)
    dir_world = jnp.broadcast_to(bundle.directions[:, None, :], (Rr, Kk, 3)).reshape(-1, 3)
    t_rgb, t_sigma, touched = jdistill.teacher_field(jm, t_params, ops, pos_world, dir_world, aabb)
    ray_clean = ~jnp.any(touched.reshape(Rr, Kk) & samples.valid, axis=1)
    pos_w = jnp.clip(jcoords.warp_position(pos_world, aabb), 0.0, 1.0)
    dir_w = jcoords.warp_direction(dir_world)
    vmask = samples.valid.reshape(-1)
    # jax.random.uniform(minval, maxval) = u·(max − min) + min
    pos_free = jnp.asarray(dr.free_u.numpy()) * (aabb.max - aabb.min) + aabb.min
    dir_free = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (NF, 1))
    regions = jdistill._edit_region_bounds(ops)
    u = jnp.asarray(dr.edit_u.numpy())
    pos_edit = jnp.concatenate([lo + u[i] * (hi - lo) for i, (lo, hi) in enumerate(regions)])
    dir_edit = jnp.asarray(dr.edit_normals.numpy())
    dir_edit = dir_edit / (jnp.linalg.norm(dir_edit, axis=-1, keepdims=True) + 1e-9)
    pos_free = jnp.concatenate([pos_free, pos_edit])
    dir_free = jnp.concatenate([dir_free, dir_edit])
    f_rgb, f_sigma, _ = jdistill.teacher_field(jm, t_params, ops, pos_free, dir_free, aabb)
    pw_free = jnp.clip(jcoords.warp_position(pos_free, aabb), 0.0, 1.0)
    dw_free = jcoords.warp_direction(dir_free)

    def loss_of(params):
        s_rgb, s_sigma = jm(params, pos_w, dir_w)
        d_sig = jnp.log1p(s_sigma) - jnp.log1p(t_sigma)
        field = jnp.mean(jnp.where(vmask, jnp.square(d_sig), 0.0)) + jnp.mean(
            jnp.where(vmask[:, None], jnp.square(s_rgb - t_rgb), 0.0))
        empty_here = vmask & (t_sigma <= 1e-3)
        field = field + 4.0 * jnp.mean(jnp.where(empty_here, jnp.log1p(s_sigma), 0.0))
        sf_rgb, sf_sigma = jm(params, pw_free, dw_free)
        df = jnp.log1p(sf_sigma) - jnp.log1p(f_sigma)
        field = field + jnp.mean(jnp.square(df)) + jnp.mean(jnp.square(sf_rgb - f_rgb)) + 4.0 * jnp.mean(
            jnp.where(f_sigma <= 1e-3, jnp.log1p(sf_sigma), 0.0))
        s_res = jcomp.composite(s_sigma.reshape(Rr, Kk), s_rgb.reshape(Rr, Kk, 3), samples.dt, samples.t,
                                samples.valid, cfg.min_transmittance)
        t_res = jcomp.composite(t_sigma.reshape(Rr, Kk), t_rgb.reshape(Rr, Kk, 3), samples.dt, samples.t,
                                samples.valid, cfg.min_transmittance)
        pix_l = jnp.mean(jnp.square(s_res.rgb - jax.lax.stop_gradient(t_res.rgb)))
        gt_rgb = targets[:, :3] * targets[:, 3:4]
        gt_err = jnp.mean(jnp.square(s_res.rgb - gt_rgb), axis=-1)
        gt = jnp.sum(jnp.where(ray_clean, gt_err, 0.0)) / jnp.maximum(jnp.sum(ray_clean.astype(jnp.float32)), 1.0)
        loss = cfg.field_loss_weight * field + cfg.pixel_loss_weight * pix_l + cfg.gt_loss_weight * gt
        return loss, {"field_loss": field, "pixel_loss": pix_l, "gt_loss": gt, "n_clean": jnp.sum(ray_clean)}

    return loss_of, samples


def test_distill_grads_from_draws_match_jax(scene, stacks, monkeypatch):
    jm, jparams, jg, tm, tg = scene
    jops, tops = stacks
    ds = sphere_dataset(3, 16)
    cfg = tdistill.DistillConfig(n_rays_per_batch=R, k_samples=K, n_free_samples=NF, n_edit_samples=NE)
    draws = _draws(len(jdistill._edit_region_bounds(tuple(jops))))
    # the student is the teacher, perturbed
    rng = np.random.default_rng(3)
    student_tree = jax.tree.map(lambda a: np.asarray(a) * (1.0 + 0.05 * rng.standard_normal(np.shape(a))).astype(np.float32),
                                jparams)
    loss_of, jsamples = _jax_loss(jm, jparams, tuple(jops), jnerf.DeviceDataset.from_dataset(ds), jg.occupancy, cfg,
                                  draws)
    (jl, jaux), jg_tree = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(jax.tree.map(jnp.asarray, student_tree))
    assert 0 < int(jaux["n_clean"]) < R  # both edited and edit-free rays

    port_march = tdistill.march.march_rays_training
    ours = []

    def jax_samples(*args, **kw):
        ours.append(port_march(*args, **kw))
        return tdistill.march.SampleBatch(*(torch.from_numpy(np.array(a)) for a in jsamples))

    tm.load_state_dict(weights.params_from_jax(student_tree))
    teacher = weights.params_from_jax(jax.tree.map(np.asarray, jparams))
    monkeypatch.setattr(tdistill.march, "march_rays_training", jax_samples)
    grads, aux = tdistill.distill_grads_from_draws(tm, teacher, tuple(tops), tg, tnerf.DeviceDataset.from_dataset(ds, CPU),
                                                   cfg, draws)
    # the fused ladder moves t by an ulp; a boundary flip moves a sample by a step
    same_rays = (np.abs(ours[0].t.numpy() - np.asarray(jsamples.t)) <= 1e-5).all(axis=1)
    assert same_rays.mean() >= 0.95, same_rays.mean()
    np.testing.assert_allclose(float(aux["loss"]), float(jl), rtol=1e-4)
    for k in ("field_loss", "pixel_loss", "gt_loss"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-4, err_msg=k)
    jflat = weights.params_from_jax(jax.tree.map(np.asarray, jg_tree))
    assert set(jflat) == set(grads)
    for name, g in grads.items():
        assert float(g.abs().max()) > 0, name
        assert _rel(g.numpy(), jflat[name].numpy()) < 2e-3, (name, _rel(g.numpy(), jflat[name].numpy()))
    # restore the scene's weights for the other tests of the module
    tm.load_state_dict(teacher)


def test_draws_have_the_shapes_of_the_step():
    ds = sphere_dataset(3, 16)
    data = tnerf.DeviceDataset.from_dataset(ds, CPU)
    cfg = tdistill.DistillConfig(n_rays_per_batch=R, k_samples=K, n_free_samples=NF, n_edit_samples=NE)
    dr = tdistill.draw_distill_step(cfg, data, torch.Generator().manual_seed(0), n_regions=3)
    assert dr.img_idx.shape == (R,) and dr.pix.shape == (R, 2) and dr.spread.shape == (R, K)
    assert dr.free_u.shape == (NF, 3) and dr.edit_u.shape == (3, 171, 3) and dr.edit_normals.shape == (513, 3)
    assert float(dr.pix.max()) < 16 and float(dr.free_u.max()) < 1.0
    none = tdistill.draw_distill_step(cfg, data, torch.Generator().manual_seed(0))
    assert none.edit_u.shape[0] == 0 and none.edit_normals.shape == (0, 3)


def test_distill_steps_lower_the_loss(scene, stacks):
    # a few steps of `distill` on the CPU, cold started so there is
    # something to learn: the loss falls and stays finite
    jm, jparams, jg, tm, tg = scene
    _, tops = stacks
    ds = sphere_dataset(3, 16)
    data = tnerf.DeviceDataset.from_dataset(ds, CPU)
    cfg = tdistill.DistillConfig(n_rays_per_batch=128, k_samples=16, n_free_samples=512, n_edit_samples=512)
    teacher = {k: v.detach().clone() for k, v in tm.named_parameters()}
    losses = []
    orig = tdistill.distill_step

    def spy(*a, **kw):
        aux = orig(*a, **kw)
        losses.append(float(aux["loss"]))
        return aux

    tdistill.distill_step = spy
    try:
        state = tdistill.distill(tm, teacher, tuple(tops), data, tg, torch.Generator().manual_seed(2), n_steps=16,
                                 cfg=cfg, warm_start=False)
    finally:
        tdistill.distill_step = orig
    assert len(losses) == 16 and all(np.isfinite(losses))
    assert np.mean(losses[-4:]) < 0.85 * np.mean(losses[:4]), losses
    assert state.step == 16 and state.model is not tm
    for k, v in tm.named_parameters():  # the teacher's model is untouched
        assert torch.equal(v.detach(), teacher[k])
    warm = tdistill.distill(tm, teacher, tuple(tops), data, tg, torch.Generator().manual_seed(2), n_steps=1, cfg=cfg)
    assert warm.step == 1


def test_distill_scale_mismatch_raises(scene, stacks):
    # F9: a DistillConfig of another scene scale than the edited grid's
    _, _, _, tm, tg = scene
    data = tnerf.DeviceDataset.from_dataset(sphere_dataset(3, 16), CPU)
    teacher = {k: v.detach() for k, v in tm.named_parameters()}
    with pytest.raises(ValueError, match="aabb_scale"):
        tdistill.distill(tm, teacher, tuple(stacks[1]), data, tg, torch.Generator(), n_steps=1,
                         cfg=tdistill.DistillConfig(aabb_scale=4))
    grid3 = type(tg)(torch.zeros((3, 128, 128, 128)), torch.ones((3, 128, 128, 128), dtype=torch.bool), torch.zeros(()))
    with pytest.raises(ValueError, match="implies 1 cascades, the edited grid has 3"):
        tdistill.distill(tm, teacher, tuple(stacks[1]), data, grid3, torch.Generator(), n_steps=1)


def test_distill_guards_a_diverged_loss(scene, stacks, monkeypatch):
    _, _, _, tm, tg = scene
    data = tnerf.DeviceDataset.from_dataset(sphere_dataset(3, 16), CPU)
    teacher = {k: v.detach() for k, v in tm.named_parameters()}
    monkeypatch.setattr(tdistill, "distill_step", lambda *a, **kw: {"loss": torch.tensor(float("nan"))})
    with pytest.raises(RuntimeError, match="step 0"):
        tdistill.distill(tm, teacher, tuple(stacks[1]), data, tg, torch.Generator(), n_steps=3)
