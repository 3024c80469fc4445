"""The port's march and compositing against ``nerfshop_tpu/ops/march.py``
and ``nerfshop_tpu/ops/composite.py`` on the same rays, grids and draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfshop_tpu.ops import composite as jcomp
from nerfshop_tpu.ops import march as jmarch
from nerfshop_tpu_torch.ops import composite as tcomp
from nerfshop_tpu_torch.ops import march as tmarch
from torch_one_thread import one_thread  # noqa: F401

R_RAYS, K = 96, 16


def _rays(seed, aabb_scale):
    rng = np.random.default_rng(seed)
    target = 0.5 + rng.uniform(-0.3, 0.3, (R_RAYS, 3)) * aabb_scale
    ang = rng.uniform(0, 2 * np.pi, R_RAYS)
    eye = 0.5 + np.stack([np.cos(ang), np.sin(ang), rng.uniform(-0.5, 0.5, R_RAYS)], -1) * 1.5 * aabb_scale
    d = target - eye
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return eye.astype(np.float32), d.astype(np.float32)


def _grid(kind, n_cascades, seed=0):
    if kind == "full":
        return np.ones((n_cascades, 128, 128, 128), bool)
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0, 1, (n_cascades, 16, 16, 16)) < 0.3
    fine = rng.uniform(0, 1, (n_cascades, 128, 128, 128)) < 0.5
    return np.repeat(np.repeat(np.repeat(coarse, 8, 1), 8, 2), 8, 3) & fine


CASES = [
    # (selection, cone, aabb_scale, n_cascades, grid kind)
    ("spread", 0.0, 1, 1, "random"),
    ("spread", 0.0, 1, 1, "full"),
    ("spread", 1 / 256, 4, 3, "random"),
    ("spread", 1 / 256, 4, 3, "full"),
    ("first", 0.0, 1, 1, "random"),
    ("first", 0.0, 1, 1, "full"),
    ("first", 1 / 256, 4, 3, "random"),
    ("first", 1 / 256, 4, 3, "full"),
]


@pytest.mark.parametrize("selection,cone,aabb_scale,n_cascades,kind", CASES)
def test_march_rays_matches(selection, cone, aabb_scale, n_cascades, kind):
    # n and valid exact; t and dt within 1e-6 (relative to |t| ≤ a few units)
    o, d = _rays(1, aabb_scale)
    occ = _grid(kind, n_cascades)
    rng = np.random.default_rng(2)
    t_jitter = rng.uniform(0, 1, R_RAYS).astype(np.float32)
    spread = rng.uniform(0, 1, (R_RAYS, K)).astype(np.float32)
    lo = np.full(3, 0.5 - 0.5 * aabb_scale, np.float32)
    hi = np.full(3, 0.5 + 0.5 * aabb_scale, np.float32)
    kw = dict(t_start_min=0.05, k_samples=K, n_candidates=256, selection=selection)
    ref = jmarch.march_rays(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(occ), jnp.asarray(lo), jnp.asarray(hi),
        jnp.asarray(cone, jnp.float32), t_jitter=jnp.asarray(t_jitter),
        spread_rng=jnp.asarray(spread) if selection == "spread" else None, **kw,
    )
    ours = tmarch.march_rays(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(occ), torch.from_numpy(lo),
        torch.from_numpy(hi), cone, t_jitter=torch.from_numpy(t_jitter),
        spread_rng=torch.from_numpy(spread) if selection == "spread" else None, **kw,
    )
    assert int(np.asarray(ref.n).sum()) > 0
    np.testing.assert_array_equal(ours.n.numpy(), np.asarray(ref.n))
    np.testing.assert_array_equal(ours.valid.numpy(), np.asarray(ref.valid))
    assert np.isfinite(ours.t.numpy()).all() and np.isfinite(ours.dt.numpy()).all()
    scale = max(1.0, float(np.abs(np.asarray(ref.t)).max()))
    np.testing.assert_allclose(ours.t.numpy(), np.asarray(ref.t), rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(ours.dt.numpy(), np.asarray(ref.dt), rtol=0, atol=1e-6)


@pytest.mark.parametrize("cone", [0.0, 1 / 256])
def test_step_ladder_matches(cone):
    t0 = np.random.default_rng(3).uniform(0.05, 6.0, 64).astype(np.float32)
    m = np.arange(0, 1024, 7, dtype=np.int32)
    JT, Jdt = jmarch.step_ladder(jnp.asarray(t0), jnp.asarray(m), jnp.asarray(cone, jnp.float32))
    TT, Tdt = tmarch.step_ladder(torch.from_numpy(t0), torch.from_numpy(m), cone)
    assert np.isfinite(TT.numpy()).all() and np.isfinite(Tdt.numpy()).all()
    np.testing.assert_allclose(TT.numpy(), np.asarray(JT), rtol=1e-6, atol=0)
    np.testing.assert_allclose(Tdt.numpy(), np.asarray(Jdt), rtol=1e-6, atol=0)


@pytest.mark.parametrize("n_cascades", [1, 3])
def test_coarse_occupancy_matches(n_cascades):
    occ = _grid("random", n_cascades, seed=5)
    ref = np.asarray(jmarch.build_coarse_occupancy(jnp.asarray(occ)))
    np.testing.assert_array_equal(tmarch.build_coarse_occupancy(torch.from_numpy(occ)).numpy(), ref)


def _composite_inputs(seed):
    rng = np.random.default_rng(seed)
    R, Kc = 48, 24
    sig = rng.uniform(0, 60, (R, Kc)).astype(np.float32)
    sig[:8] *= 20  # opaque rays: cross the transmittance cutoff early
    rgb = rng.uniform(0, 1, (R, Kc, 3)).astype(np.float32)
    dt = rng.uniform(0.002, 0.03, (R, Kc)).astype(np.float32)
    t = np.cumsum(dt, 1).astype(np.float32)
    n = rng.integers(0, Kc + 1, R)
    valid = np.arange(Kc)[None] < n[:, None]
    bg = rng.uniform(0, 1, (R, 3)).astype(np.float32)
    ct = rng.standard_normal((R, 3)).astype(np.float32)
    return sig, rgb, dt, t, valid, bg, ct


@pytest.mark.parametrize("seed", [0, 1])
def test_composite_forward_and_grads_match(seed):
    # forward and d/dsigma, d/drgb within 1e-5
    sig, rgb, dt, t, valid, bg, ct = _composite_inputs(seed)

    def jloss(s, c):
        res = jcomp.composite(s, c, jnp.asarray(dt), jnp.asarray(t), jnp.asarray(valid), 1e-4)
        out = jcomp.composite_with_background(res, jnp.asarray(bg))
        return jnp.sum(out * ct) + jnp.sum(res.depth), res

    (jl, jres), (jgs, jgc) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(sig), jnp.asarray(rgb))
    ts = torch.from_numpy(sig).requires_grad_(True)
    tc = torch.from_numpy(rgb).requires_grad_(True)
    res = tcomp.composite(ts, tc, torch.from_numpy(dt), torch.from_numpy(t), torch.from_numpy(valid), 1e-4)
    out = tcomp.composite_with_background(res, torch.from_numpy(bg))
    tl = (out * torch.from_numpy(ct)).sum() + res.depth.sum()
    tl.backward()
    assert (np.asarray(jres.n_used) < valid.sum(1)).any()  # the cutoff was crossed
    np.testing.assert_array_equal(res.n_used.numpy(), np.asarray(jres.n_used))
    np.testing.assert_array_equal(res.depth.detach().numpy(), np.asarray(jres.depth))
    for a, b in [(res.rgb, jres.rgb), (res.opacity, jres.opacity), (res.weights, jres.weights)]:
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jgs), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(jgc), rtol=0, atol=1e-5)


def test_samples_to_network_inputs_match():
    o, d = _rays(7, 1)
    rng = np.random.default_rng(8)
    t = rng.uniform(0, 3, (R_RAYS, K)).astype(np.float32)
    valid = rng.uniform(0, 1, (R_RAYS, K)) < 0.7
    from nerfshop_tpu.ops import coords as jcoords
    from nerfshop_tpu_torch.ops import coords as tcoords

    jb = jmarch.SampleBatch(jnp.asarray(t), jnp.asarray(t), jnp.asarray(valid), jnp.asarray(valid.sum(1)))
    tb = tmarch.SampleBatch(torch.from_numpy(t), torch.from_numpy(t), torch.from_numpy(valid), torch.from_numpy(valid.sum(1)))
    jp, jd = jmarch.samples_to_network_inputs(jb, jnp.asarray(o), jnp.asarray(d), jcoords.BoundingBox.from_aabb_scale(2))
    tp, td = tmarch.samples_to_network_inputs(tb, torch.from_numpy(o), torch.from_numpy(d), tcoords.BoundingBox.from_aabb_scale(2))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)


def _density(occ, seed):
    rng = np.random.default_rng(seed)
    return np.where(occ, rng.uniform(0, 1, occ.shape) ** 4 * 800, 0).astype(np.float32)


RENDER_CASES = [
    # (early stop tau or None, aabb_scale, n_cascades, cone)
    (2.0, 1, 1, 0.0),
    (2.0, 4, 3, 1 / 256),
    (8.0, 1, 1, 0.0),
    (8.0, 4, 3, 1 / 256),
    (None, 1, 1, 0.0),
    (None, 4, 3, 1 / 256),
]


@pytest.mark.parametrize("tau,aabb_scale,n_cascades,cone", RENDER_CASES)
def test_march_render_options_match(tau, aabb_scale, n_cascades, cone):
    # the renderer's march: precomputed coarse/fine fields, with and without
    # the grid early stop; n and valid exact, t within 1e-6·scale, dt within 1e-6
    o, d = _rays(11, aabb_scale)
    occ = _grid("random", n_cascades, seed=12)
    dens = _density(occ, 13)
    lo = np.full(3, 0.5 - 0.5 * aabb_scale, np.float32)
    hi = np.full(3, 0.5 + 0.5 * aabb_scale, np.float32)
    kw = dict(t_start_min=0.05, k_samples=K, n_candidates=256, selection="first")
    if tau is not None:
        kw.update(use_grid_early_stop=True, grid_stop_tau=tau)
    jf = (np.asarray(jmarch.build_coarse_occupancy(jnp.asarray(occ))).reshape(-1),
          np.asarray(jmarch.masked_density_field(jnp.asarray(occ), jnp.asarray(dens))).reshape(-1))
    ref = jmarch.march_rays(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(occ), jnp.asarray(lo), jnp.asarray(hi),
        jnp.asarray(cone, jnp.float32), coarse_field=jnp.asarray(jf[0]), fine_field=jnp.asarray(jf[1]), **kw,
    )
    ours = tmarch.march_rays(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(occ), torch.from_numpy(lo),
        torch.from_numpy(hi), cone, coarse_field=torch.from_numpy(jf[0].copy()),
        fine_field=torch.from_numpy(jf[1].copy()), **kw,
    )
    assert int(np.asarray(ref.n).sum()) > 0
    np.testing.assert_array_equal(ours.n.numpy(), np.asarray(ref.n))
    np.testing.assert_array_equal(ours.valid.numpy(), np.asarray(ref.valid))
    scale = max(1.0, float(np.abs(np.asarray(ref.t)).max()))
    np.testing.assert_allclose(ours.t.numpy(), np.asarray(ref.t), rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(ours.dt.numpy(), np.asarray(ref.dt), rtol=0, atol=1e-6)


def test_march_early_stop_saturates():
    o, d = _rays(11, 1)
    occ = _grid("full", 1)
    dens = np.full(occ.shape, 400.0, np.float32)
    t_occ = torch.from_numpy(occ)
    args = (torch.from_numpy(o), torch.from_numpy(d), t_occ, torch.zeros(3), torch.ones(3), 0.0)
    fine = tmarch.masked_density_field(t_occ, torch.from_numpy(dens)).reshape(-1)
    kw = dict(k_samples=64, n_candidates=256, fine_field=fine)
    stop = tmarch.march_rays(*args, use_grid_early_stop=True, **kw)
    free = tmarch.march_rays(*args, **kw)
    assert (stop.n <= free.n).all() and stop.n.sum() < free.n.sum()
