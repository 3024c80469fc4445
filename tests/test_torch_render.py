"""The port's exact renderer (``nerfshop_tpu_torch/render/renderer.py``)
against ``nerfshop_tpu/render/renderer.py::render_frame`` from the same
weights, the same seeded density grid and bitfield, and the same draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfshop_tpu.common import RenderMode
from nerfshop_tpu.models import nerf_network as jnn
from nerfshop_tpu.ops import grid as jgrid
from nerfshop_tpu.ops import sampling as jsampling
from nerfshop_tpu.render import renderer as jrender
from nerfshop_tpu_torch import common as tcommon
from nerfshop_tpu_torch import weights
from nerfshop_tpu_torch.models import nerf_network as tnn
from nerfshop_tpu_torch.ops import grid as tgrid
from nerfshop_tpu_torch.ops import sampling as tsampling
from nerfshop_tpu_torch.render import renderer as trender
from torch_one_thread import one_thread  # noqa: F401

CFG = {
    "encoding": {"otype": "HashGrid", "n_levels": 3, "n_features_per_level": 2,
                 "log2_hashmap_size": 12, "base_resolution": 8, "per_level_scale": 1.5},
    "network": {"n_neurons": 64, "n_hidden_layers": 1},
    "dir_encoding": {"otype": "SphericalHarmonics", "degree": 4},
    "rgb_network": {"n_neurons": 64, "n_hidden_layers": 2},
}
W, H = 24, 16
CENTER = np.array([0.5, 0.5, 0.5], np.float32)


def look_at(eye, target=CENTER, up=(0.0, 0.0, 1.0)):
    eye = np.asarray(eye, np.float32)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float32))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    return np.concatenate([np.stack([right, down, fwd], 1), eye[:, None]], 1).astype(np.float32)


def seeded_density(seed=0, n_cascades=1):
    """A dense ball (the early stop fires inside it) in sparse random haze."""
    rng = np.random.default_rng(seed)
    R = 128
    c = (np.arange(R) + 0.5) / R - 0.5
    r2 = c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None, :] ** 2
    ball = np.where(r2 < 0.35**2, 400.0, 0.0)
    haze = rng.uniform(0, 1, (n_cascades, R, R, R)) ** 8 * 50
    return (ball[None] + haze).astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    jm = jnn.build_nerf_network(CFG)
    tree = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    tree["pos_encoding"]["table"] = rng.uniform(-1, 1, tree["pos_encoding"]["table"].shape).astype(np.float32)
    tree["density_mlp"]["weights"][-1][:, 0] *= 3.0  # raw σ spread wide enough for opaque regions
    tm = tnn.build_nerf_network(CFG)
    tm.load_state_dict(weights.params_from_jax(tree))
    dens = seeded_density()
    jg = jgrid.update_bitfield(jgrid.OccupancyGrid.create(1)._replace(density=jnp.asarray(dens)))
    occ = np.asarray(jg.occupancy)
    assert 0.02 < occ.mean() < 0.5
    tg = tgrid.OccupancyGrid(torch.from_numpy(dens), torch.from_numpy(occ.copy()), torch.tensor(float(jg.mean_density)))
    jparams = jax.tree.map(jnp.asarray, tree)
    return jm, jparams, jg, tm, tg


def _render_both(scene, opts_kw, xform=None, focal=(20.0, 20.0), principal=(0.5, 0.5), distortion=None,
                 operators=(), **kw):
    """JAX's and the port's frame → (jax rgba, jax depth, port rgba, port
    depth); ``operators`` are JAX operators, carried over to the port."""
    jm, jparams, jg, tm, tg = scene
    xform = look_at(CENTER + np.array([1.1, -0.9, 0.4], np.float32)) if xform is None else xform
    base = dict(k_samples=16, n_windows=2, n_candidates=512, chunk=128)
    base.update(opts_kw)
    jopts = jrender.RenderOptions(**base)
    topts = trender.RenderOptions(**{**base, "mode": tcommon.RenderMode(jopts.mode.value)})
    jkw = {k: jnp.asarray(v) for k, v in kw.items() if v is not None and k != "lens"}
    tkw = {k: torch.from_numpy(np.asarray(v)) for k, v in kw.items() if v is not None and k != "lens"}
    if "lens" in kw:
        jkw["lens"] = tkw["lens"] = kw["lens"]
    f, p = np.asarray(focal, np.float32), np.asarray(principal, np.float32)
    d = None if distortion is None else np.asarray(distortion, np.float32)
    if operators:
        jkw["operators"] = tuple(operators)
        tkw["operators"] = tuple(weights.operators_from_jax(list(operators), torch.device("cpu")))
    ref = jrender.render_frame(
        jm, jparams, jg, (W, H), jnp.asarray(xform), jnp.asarray(f), jnp.asarray(p),
        distortion=None if d is None else jnp.asarray(d), opts=jopts, **jkw,
    )
    ours = trender.render_frame(
        tm, None, tg, (W, H), torch.from_numpy(xform), torch.from_numpy(f), torch.from_numpy(p),
        distortion=None if d is None else torch.from_numpy(d), opts=topts, **tkw,
    )
    return np.asarray(ref.rgba), np.asarray(ref.depth), ours.rgba.numpy(), ours.depth.numpy()


def _check_depth(jdepth, tdepth):
    """Depth is the t of the max-weight sample (ties pick the first slot in
    both frameworks): within 1e-5, the fp32 noise of t, on every pixel. The
    seeded scenes hold to that; a scene with near-equal largest weights
    would need the check restricted to pixels with a unique maximum."""
    np.testing.assert_allclose(tdepth, jdepth, rtol=0, atol=1e-5)


MODES = [RenderMode.Shade, RenderMode.Depth, RenderMode.Distance, RenderMode.Stepsize,
         RenderMode.Cost, RenderMode.AO, RenderMode.Positions, RenderMode.Slice]


@pytest.mark.parametrize("mode", MODES, ids=[m.value for m in MODES])
def test_render_modes_match(scene, mode):
    # rgba within 1e-4 absolute (bf16 MLP rounding points equal, fp32 sums
    # in another order); Cost exactly
    jr, jd, tr, td = _render_both(scene, dict(mode=mode, background=(0.1, 0.2, 0.3, 1.0)))
    assert tr.shape == (H, W, 4) and np.isfinite(tr).all()
    if mode == RenderMode.Cost:
        np.testing.assert_array_equal(tr, jr)
        assert tr[..., 0].max() > 0
    else:
        np.testing.assert_allclose(tr, jr, rtol=0, atol=1e-4)
    _check_depth(jd, td)
    if mode == RenderMode.AO:
        assert jr[..., 3].max() > 0.5 and jr[..., 3].max() - jr[..., 3].min() > 0.1  # content in view


@pytest.mark.parametrize("early_stop", [False, True])
def test_grid_early_stop_matches(scene, early_stop):
    jr, jd, tr, td = _render_both(scene, dict(use_grid_early_stop=early_stop, mode=RenderMode.Cost))
    np.testing.assert_array_equal(tr, jr)
    jr2, jd2, tr2, td2 = _render_both(scene, dict(use_grid_early_stop=early_stop))
    np.testing.assert_allclose(tr2, jr2, rtol=0, atol=1e-4)
    _check_depth(jd2, td2)


def test_early_stop_cuts_samples(scene):
    # without the transmittance cutoff, Cost counts every valid march sample
    kw = dict(mode=RenderMode.Cost, min_transmittance=0.0, k_samples=64)
    on = _render_both(scene, dict(use_grid_early_stop=True, **kw))
    off = _render_both(scene, dict(use_grid_early_stop=False, **kw))
    np.testing.assert_array_equal(on[2], on[0])
    assert on[2][..., 0].sum() < off[2][..., 0].sum()


def test_spp_jitter_matches(scene):
    # the port's copy of spp_jitter gives the same bits; frames within 1e-4
    jit = tsampling.spp_jitter(3, W * H, seed=7)
    np.testing.assert_array_equal(jit, jsampling.spp_jitter(3, W * H, seed=7))
    jr, jd, tr, td = _render_both(scene, {}, subpixel_jitter=jit)
    np.testing.assert_allclose(tr, jr, rtol=0, atol=1e-4)
    _check_depth(jd, td)


@pytest.mark.parametrize("lens", ["pinhole_distorted", "latlong", "ftheta"])
def test_lenses_match(scene, lens):
    # rays within 1e-6; frames within 1e-4 on 99% of values and 1e-3 on all:
    # the distortion fixed point and the f-theta polynomial round differently
    # in XLA and torch, and an ulp of position can move an MLP input across a
    # bf16 rounding boundary (a step of 2^-8 relative) on a few samples
    from nerfshop_tpu.ops import rays as jrays
    from nerfshop_tpu_torch.ops import rays as trays

    kw = {}
    if lens == "pinhole_distorted":
        kw["distortion"] = (0.05, -0.01, 0.002, -0.001)
    elif lens == "latlong":
        kw["lens"] = "latlong"
    else:
        kw["lens"] = "ftheta"
        kw["ftheta_coeffs"] = np.array([0.0, 0.06, 1e-4, 0.0, 0.0], np.float32)
    xf = look_at(CENTER + np.array([1.1, -0.9, 0.4], np.float32))
    f, p = np.array([20.0, 20.0], np.float32), np.array([0.5, 0.5], np.float32)
    rkw = {k: np.asarray(v, np.float32) for k, v in kw.items() if k != "lens"}
    jb = jrays.rays_for_image((W, H), jnp.asarray(xf), jnp.asarray(f), jnp.asarray(p), lens=kw.get("lens", "pinhole"),
                              **{k: jnp.asarray(v) for k, v in rkw.items()})
    tb = trays.rays_for_image((W, H), torch.from_numpy(xf), torch.from_numpy(f), torch.from_numpy(p),
                              lens=kw.get("lens", "pinhole"), **{k: torch.from_numpy(v) for k, v in rkw.items()})
    np.testing.assert_allclose(tb.directions.numpy(), np.asarray(jb.directions), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tb.origins.numpy(), np.asarray(jb.origins), rtol=0, atol=1e-6)
    jr, jd, tr, td = _render_both(scene, {}, **kw)
    assert np.isfinite(tr).all()
    err = np.abs(tr - jr)
    assert (err <= 1e-4).mean() >= 0.99 and err.max() <= 1e-3, err.max()


def test_depth_of_field_matches(scene):
    rng = np.random.default_rng(3)
    u = rng.uniform(0, 1, (W * H, 2))
    dof_uv = np.stack([np.sqrt(u[:, 0]) * np.cos(2 * np.pi * u[:, 1]), np.sqrt(u[:, 0]) * np.sin(2 * np.pi * u[:, 1])], -1)
    jr, jd, tr, td = _render_both(scene, dict(aperture=0.02, focus_z=1.4), dof_uv=dof_uv.astype(np.float32))
    np.testing.assert_allclose(tr, jr, rtol=0, atol=1e-4)
    _check_depth(jd, td)


def test_render_aabb_crop_matches(scene):
    crop = ((0.3, 0.3, 0.3), (0.6, 0.7, 0.65))
    jr, jd, tr, td = _render_both(scene, dict(render_aabb=crop))
    full = _render_both(scene, {})[2]
    np.testing.assert_allclose(tr, jr, rtol=0, atol=1e-4)
    _check_depth(jd, td)
    assert np.abs(tr - full).max() > 1e-3  # the crop changed the frame


@pytest.mark.parametrize("what", ["operators", "envmap", "extra_dims"])
def test_unported_options_raise(scene, what):
    _, _, _, tm, tg = scene
    opts, kw, error = trender.RenderOptions(chunk=128), {}, NotImplementedError
    if what == "operators":
        # edit operators and their Poisson membranes are ported; a membrane
        # that is not a poisson.MembraneData raises
        from nerfshop_tpu_torch.editing.operators import CageDeformationOp

        kw["operators"] = (CageDeformationOp(*([None] * 9), copy_mode=False, membrane=object()),)
        error = TypeError
    elif what == "envmap":
        # the envmap background is ported; a map that is not [h, w, 4] raises
        kw["envmap"] = torch.zeros(4, 8)
        error = ValueError
    else:
        # extra dims are ported (tests/test_torch_capture_options.py); a
        # value that is not one vector [E] raises
        kw["extra_dims"] = torch.zeros(2, 3)
        error = ValueError
    xf = torch.from_numpy(look_at(CENTER + np.array([1.1, -0.9, 0.4], np.float32)))
    with pytest.raises(error):
        trender.render_frame(tm, None, tg, (8, 8), xf, torch.tensor([8.0, 8.0]), opts=opts, **kw)


def _exact_field(p, d):
    """A field whose every output is one correctly rounded operation, so
    that JAX and torch compute it bit for bit."""
    return p + d, p[:, 0] * d[:, 1]


@pytest.mark.parametrize("share,budget", [(0.3, 512), (0.7, 256), (0.0, 256)], ids=["fits", "overflows", "none-valid"])
def test_compacted_field_eval_matches_jax(share, budget):
    # bit-equal: the same rows reach the same slab slots, and rows past the
    # budget (or invalid) read 0
    rng = np.random.default_rng(3)
    n = 1000
    pos = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    dirs = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    valid = rng.uniform(0, 1, n) < share
    assert (valid.sum() > budget) == (share == 0.7)
    jrgb, jsig = jrender._compacted_field_eval(_exact_field, jnp.asarray(pos), jnp.asarray(dirs), jnp.asarray(valid), budget)
    trgb, tsig = trender._compacted_field_eval(
        _exact_field, torch.from_numpy(pos), torch.from_numpy(dirs), torch.from_numpy(valid), budget
    )
    np.testing.assert_array_equal(trgb.numpy(), np.asarray(jrgb))
    np.testing.assert_array_equal(tsig.numpy(), np.asarray(jsig))
    kept = valid & (np.cumsum(valid) <= budget)
    assert (tsig.numpy()[~kept] == 0).all() and (tsig.numpy()[kept] != 0).all()


@pytest.mark.parametrize("edited", [False, True], ids=["plain", "affine-duplicate"])
@pytest.mark.parametrize("frac", [0.75, 0.05], ids=["no-drops", "drops"])
def test_compacted_render_matches_jax(scene, frac, edited):
    # the frame's chunks hold 4096 slots, 54-64% of them valid: the
    # 3072-row slab of 0.75 keeps every valid slot, and the port's frame
    # then equals its uncompacted frame; the 256-row slab of 0.05 drops
    # most, in both packages alike (rgba within 1e-4, as without compaction)
    ops = ()
    if edited:
        from nerfshop_tpu.editing import operators as jops

        ops = (jops.AffineDuplicationOp.create(center=[0.62, 0.5, 0.5], half_extents=[0.2, 0.2, 0.2],
                                               transform_t=[-0.3, 0.05, 0.1]),)
    jr, jd, tr, td = _render_both(scene, dict(compact_frac=frac), operators=ops)
    np.testing.assert_allclose(tr, jr, rtol=0, atol=1e-4)
    _check_depth(jd, td)
    _, _, full, _ = _render_both(scene, {}, operators=ops)
    if frac == 0.75:
        np.testing.assert_allclose(tr, full, rtol=0, atol=1e-6)
    else:
        assert np.abs(tr - full).max() > 1e-3


def test_render_options_match_jax_fields():
    import dataclasses

    # enums by value: each package has its own RenderMode
    def plain(v):
        return v.value if isinstance(v, (RenderMode, tcommon.RenderMode)) else v

    jf = {f.name: plain(f.default) for f in dataclasses.fields(jrender.RenderOptions)}
    tf = {f.name: plain(f.default) for f in dataclasses.fields(trender.RenderOptions)}
    assert jf == tf
