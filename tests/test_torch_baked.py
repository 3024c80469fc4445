"""The port's baked preview (``nerfshop_tpu_torch/render/baked.py`` and the
testbed's interactive methods) against ``nerfshop_tpu/render/baked.py``.

The bake: the same weights (``weights.params_from_jax``), grid and
operators (built by the JAX host code, carried over with
``weights.operators_from_jax``) give the canonical volume and its three
layouts within bf16 rounding: ≥ 99.99% of values within one bf16 ulp
(2^-7 relative) + 1e-6 and all within 2^-5 relative + 1e-6 (a hidden
activation within an ulp of a bf16 rounding tie rounds the other way in
one package and moves that row's outputs by ~2^-8).

The frame: the plain H and I on volumes carried over bit for bit
(``weights.baked_from_jax``) against JAX's ``render_baked``. JAX rounds the
fractions, each lerp and the packed raster to bf16 where the port keeps
float32: max |Δrgba| ≤ 2e-2, mean ≤ 1e-3. A float64 numpy model of the
kernels' per-texel and per-pixel arithmetic, in their order, holds the plain
versions (the kernels' CPU stand-ins) within 1e-5."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfshop_tpu.editing import operators as jops
from nerfshop_tpu.editing import poisson as jpoisson
from nerfshop_tpu.editing.tet_mesh import TetMesh as JTetMesh
from nerfshop_tpu.ops import coords as jcoords
from nerfshop_tpu.render import baked as jbaked
from nerfshop_tpu_torch import weights
from nerfshop_tpu_torch.editing.operators import AffineDuplicationOp
from nerfshop_tpu_torch.ops import coords as tcoords
from nerfshop_tpu_torch.ops import grid as tgrid
from nerfshop_tpu_torch.render import baked as tbaked
from test_torch_edit_render import scene  # noqa: F401 (fixture)
from test_torch_render import CENTER, CFG, look_at, seeded_density
from torch_one_thread import one_thread  # noqa: F401

CPU = torch.device("cpu")
B = 32
#: a cubic bake box whose lattice is on no cell boundary of the 128³ grid
LO = np.array([0.1037, 0.1213, 0.0819], np.float32)
HI = LO + np.float32(0.7931)
CAM = np.array([0.5, -1.0, 0.6], np.float32)
CHUNK = 1 << 13  # 8 slices a chunk


def kuhn_tets(lo, hi, n=2):
    """An n³ lattice of cubes over [lo, hi]³, six tets each → (vertices, tets)."""
    g = np.linspace(lo, hi, n + 1, dtype=np.float32)
    verts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)

    def vid(i, j, k):
        return (i * (n + 1) + j) * (n + 1) + k

    tets = []
    for i in range(n):
        for j in range(n):
            for k in range(n):
                corner = lambda b: vid(i + (b & 1), j + (b >> 1 & 1), k + (b >> 2 & 1))  # noqa: E731
                for a, b in ((1, 2), (2, 1), (1, 4), (4, 1), (2, 4), (4, 2)):
                    tets.append([corner(0), corner(a), corner(a | b), corner(7)])
    return verts, np.asarray(tets, np.int32)


@pytest.fixture(scope="module")
def jax_ops():
    """A cage of Kuhn-lattice tets moved +0.12 x carrying a membrane of
    seeded values (``test_torch_membrane.py`` holds ``compute_membrane``
    itself to JAX's), and an affine duplicate, built by the JAX package."""
    shift = np.array([0.12, 0.0, 0.0], np.float32)
    verts, tets = kuhn_tets(0.3, 0.7)
    jtm = JTetMesh(verts, verts + shift, tets)
    rng = np.random.default_rng(11)
    n = len(tets)
    mem = jpoisson.MembraneData(
        density=jnp.asarray(rng.uniform(0, 60, (n, 4)), jnp.float32),
        outside_density=jnp.asarray(rng.uniform(0, 40, (n, 4)) * (rng.uniform(size=(n, 4)) < 0.7), jnp.float32),
        sh=jnp.asarray(rng.normal(0, 0.2, (n, 4, 9, 3)), jnp.float32),
        amplitude=jnp.asarray(1.0, jnp.float32),
    )
    cage_op = jops.CageDeformationOp.from_tet_mesh(jtm, lut_res=24)._replace(membrane=mem)
    return {"cage": cage_op, "dup": _jax_dup(-0.3)}


def _jax_dup(tx, half=0.2):
    return jops.AffineDuplicationOp.create(center=[0.62, 0.5, 0.5], half_extents=[half] * 3,
                                           transform_t=[tx, 0.05, 0.1])


def _boxes():
    return (jcoords.BoundingBox(jnp.asarray(LO), jnp.asarray(HI)), tcoords.BoundingBox(LO, HI),
            jcoords.BoundingBox.from_aabb_scale(1), tcoords.BoundingBox.from_aabb_scale(1))


def _bake_both(scene, jstack, occupancy=True, res=B):  # noqa: F811
    jm, jparams, jg, tm, tg = scene
    jbox, tbox, jfield, tfield = _boxes()
    jv = jbaked.bake_volume(jm, jparams, jbox, resolution=res, operators=tuple(jstack), camera_pos=jnp.asarray(CAM),
                            occupancy=jg.occupancy if occupancy else None, chunk=CHUNK, field_aabb=jfield)
    tv = tbaked.bake_volume(tm, None, tbox, resolution=res, operators=tuple(weights.operators_from_jax(jstack, CPU)),
                            camera_pos=CAM, occupancy=tg.occupancy if occupancy else None, chunk=CHUNK,
                            field_aabb=tfield)
    return jv, tv


def _bf16_close(ours, ref):
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    err = np.abs(ours - ref)
    assert (err <= np.abs(ref) * 2.0**-7 + 1e-6).mean() >= 0.9999, (err.max(), (err > np.abs(ref) * 2.0**-7).sum())
    assert (err <= np.abs(ref) * 2.0**-5 + 1e-6).all(), err.max()


def _layouts_are_the_canonical(tv):
    for m in range(3):
        assert torch.equal(tv.fields[m], tv.canonical.permute(tbaked._layout_perm(m)))


@pytest.mark.parametrize("case", ["field", "occupancy", "duplicate", "cage_membrane"])
def test_bake_matches_jax(scene, jax_ops, case):  # noqa: F811
    stack = {"duplicate": [jax_ops["dup"]], "cage_membrane": [jax_ops["cage"], jax_ops["dup"]]}.get(case, [])
    jv, tv = _bake_both(scene, stack, occupancy=case != "field")
    _bf16_close(tv.canonical.float().numpy(), np.asarray(jv.canonical, np.float32))
    for m in range(3):
        _bf16_close(tv.fields[m].float().numpy(), np.asarray(jv.fields[m], np.float32))
    _layouts_are_the_canonical(tv)
    np.testing.assert_array_equal(tv.aabb_lo, LO)
    np.testing.assert_array_equal(tv.camera_pos, CAM)
    sigma = tv.canonical[..., 3].float()
    assert float((sigma > 1.0).float().mean()) > 0.01  # some content
    if case == "occupancy":  # the mask zeroed something the field gives
        _, bare = _bake_both(scene, [], occupancy=False)
        assert bool(((bare.canonical[..., 3].float() > 0) & (sigma == 0)).any())


def test_roi_rebake_matches_jax_and_a_full_bake(scene):  # noqa: F811
    """At 48³ (a bucket of 32 cells is the whole of a 32³ bake) with a small
    duplicate dragged 0.04 in x."""
    jm, jparams, jg, tm, tg = scene
    jbox, tbox, jfield, tfield = _boxes()
    res = 48
    old, new = _jax_dup(-0.3, half=0.06), _jax_dup(-0.26, half=0.06)
    jv, tv = _bake_both(scene, [old], res=res)
    roi = [np.minimum(*(jops.operator_roi_aabb(o)[0] for o in (old, new))),
           np.maximum(*(jops.operator_roi_aabb(o)[1] for o in (old, new)))]
    start_j, dims_j = jbaked._roi_dims(*roi, jbox, res)
    start_t, dims_t = tbaked._roi_dims(*roi, tbox, res)
    np.testing.assert_array_equal(start_t, start_j)
    assert dims_t == dims_j and dims_t != (res, res, res)
    tnew = weights.operators_from_jax([new], CPU)
    ju = jbaked.update_volume_region(jv, jm, jparams, jbox, *roi, operators=(new,), camera_pos=jnp.asarray(CAM),
                                     occupancy=jg.occupancy, field_aabb=jfield)
    canonical_before = tv.canonical
    tu = tbaked.update_volume_region(tv, tm, None, tbox, *roi, operators=tuple(tnew), camera_pos=CAM,
                                     occupancy=tg.occupancy, field_aabb=tfield)
    assert tu.canonical is canonical_before  # patched in place
    _bf16_close(tu.canonical.float().numpy(), np.asarray(ju.canonical, np.float32))
    for m in range(3):
        _bf16_close(tu.fields[m].float().numpy(), np.asarray(ju.fields[m], np.float32))
    _layouts_are_the_canonical(tu)
    full = tbaked.bake_volume(tm, None, tbox, resolution=res, operators=tuple(tnew), camera_pos=CAM,
                              occupancy=tg.occupancy, chunk=CHUNK, field_aabb=tfield)
    assert torch.equal(tu.canonical, full.canonical)  # the lattice points are the full bake's


# ---------------------------------------------------------------- the frame


def axis_view(major, sign, dist=1.5):
    """A camera looking along ``sign`` × world axis ``major``, tilted a little."""
    e = np.eye(3, dtype=np.float32)
    eye = CENTER - sign * dist * e[major] + 0.2 * e[(major + 1) % 3] - 0.1 * e[(major + 2) % 3]
    return look_at(eye, up=e[(major + 2) % 3])


VIEWS = {f"{'xyz'[m]}{'+-'[s < 0]}": axis_view(m, s) for m in range(3) for s in (1, -1)}
#: the eye inside the volume (slices behind it are masked)
VIEWS["inside"] = look_at(CENTER + np.array([0.05, -0.1, 0.03], np.float32), target=CENTER + np.array([1.0, 0.3, 0.2]))
W, H, BI = 40, 30, 48
FOCAL = np.array([W * 1.1, W * 1.1], np.float32)


@pytest.fixture(scope="module")
def jax_volume(scene, jax_ops):  # noqa: F811
    jv, _ = _bake_both(scene, [jax_ops["dup"]])
    return jv, weights.baked_from_jax(jv, CPU)


def _frames(vols, xf, focal=FOCAL, bg=(0.1, 0.2, 0.3, 0.5)):
    jv, tv = vols
    jo = jbaked.render_baked(jv, (W, H), jnp.asarray(xf), jnp.asarray(focal), base_resolution=BI, background=bg)
    to = tbaked.render_baked(tv, (W, H), xf, focal, base_resolution=BI, background=bg)
    return np.asarray(jo.rgba), np.asarray(jo.depth), to.rgba.numpy(), to.depth.numpy()


def test_baked_from_jax_is_bit_equal(jax_volume):
    jv, tv = jax_volume
    for m in range(3):
        np.testing.assert_array_equal(tv.fields[m].float().numpy(), np.asarray(jv.fields[m], np.float32))
    np.testing.assert_array_equal(tv.canonical.float().numpy(), np.asarray(jv.canonical, np.float32))
    np.testing.assert_array_equal(tv.aabb_hi, np.asarray(jv.aabb_hi))


@pytest.mark.parametrize("view", list(VIEWS))
def test_frame_matches_jax(jax_volume, view):
    fp = tbaked.frame_params(B, LO, HI, (W, H), VIEWS[view], FOCAL, None, (0, 0, 0, 0), BI)
    if view != "inside":
        assert (fp.major, fp.flip) == ("xyz".index(view[0]), view[1] == "-")
    jr, jd, tr, td = _frames(jax_volume, VIEWS[view])
    err = np.abs(tr - jr)
    assert err.max() <= 2e-2 and err.mean() <= 1e-3, (err.max(), err.mean())
    if view == "inside":
        # the base plane k = 0.5 lies behind an eye inside the volume: no
        # corner ray reaches it and the frame is the sky in both packages
        assert np.abs(jr - [0.1, 0.2, 0.3, 0.5]).max() < 1e-6
        return
    ok = jr[..., 3] > 0.9  # depth where the frame is opaque (the raster's depth / α)
    assert ok.mean() > 0.05
    assert np.abs(td - jd)[ok].max() <= 2e-2 * max(1.0, float(np.abs(jd).max()))


def corners_behind_view():
    """A wide view from below and outside the volume, looking up and
    across → (xform, focal)."""
    eye = CENTER + np.array([-0.5, 0.0, -0.3], np.float32)
    return look_at(eye, target=eye + np.array([0.5, 0.4, 0.5], np.float32)), np.array([16.0, 16.0], np.float32)


def test_frame_corners_behind_the_eye(jax_volume):
    """A wide view from below and outside the volume, looking up and
    across: one corner ray points away from the base plane, so three of
    the four span the base raster (``valid_c``)."""
    xf, focal = corners_behind_view()
    fp = tbaked.frame_params(B, LO, HI, (W, H), xf, focal, None, (0, 0, 0, 0), BI)
    cu = np.array([[0, 0], [1, 0], [0, 1], [1, 1]], np.float32) * [W, H]
    c_idx = np.concatenate([(cu - 0.5 * np.array([W, H])) / focal, np.ones((4, 1))], 1) @ xf[:, :3].T
    assert int((c_idx[:, fp.major] * (-1 if fp.flip else 1) > 0).sum()) == 3
    jr, _, tr, _ = _frames(jax_volume, xf, focal)
    err = np.abs(tr - jr)
    assert err.max() <= 2e-2 and err.mean() <= 1e-3, (err.max(), err.mean())
    assert float((jr[..., 3] > 0.9).mean()) > 0.1


# ------------------------------------------------- the kernels' arithmetic


def model_composite(field, fp):
    """Kernel H's per-texel loop in float64, in its order → [Bi, Bi, 5]."""
    f = np.asarray(field, np.float64)
    Bv, Bi = fp.B, fp.Bi
    ez, ey, ex = fp.e.astype(np.float64)
    by0, by1, bx0, bx1 = fp.box.astype(np.float64)
    ii = np.arange(Bi) + 0.5
    BX, BY = np.meshgrid(bx0 + ii * (bx1 - bx0) / Bi, by0 + ii * (by1 - by0) / Bi, indexing="ij")  # [x', y']
    dz0 = 0.5 - ez
    sec = np.sqrt((BY - ey) ** 2 + (BX - ex) ** 2 + dz0**2) / abs(dz0)
    dt = float(fp.cell_world) * sec
    ctau = np.zeros_like(sec)
    acc = np.zeros(sec.shape + (3,))
    depth = np.zeros_like(sec)

    def source(base, e, inv):
        s = (base - e) * inv + e - 0.5
        q = np.floor(s)
        return np.clip(q, 0, Bv - 2).astype(np.int64), s - q, (s >= 0) & (s <= Bv - 1)

    for k in range(Bv):
        rel = k + 0.5 - ez
        if not rel > 1e-3:
            continue
        s = dz0 / rel
        inv = 1.0 / (1e-6 if abs(s) < 1e-6 else s)
        qy, fy, vy = source(BY, ey, inv)
        qx, fx, vx = source(BX, ex, inv)
        sl = f[Bv - 1 - k if fp.flip else k]

        def lerp(a, b, t):
            return a * (1 - t[..., None]) + b * t[..., None]

        v = lerp(lerp(sl[qy, qx], sl[qy + 1, qx], fy), lerp(sl[qy, qx + 1], sl[qy + 1, qx + 1], fy), fx)
        v = np.where((vy & vx)[..., None], v, 0.0)
        tau = np.maximum(v[..., 3], 0) * dt
        c_new = ctau + tau
        w = np.exp(-(c_new - tau)) * (1 - np.exp(-tau))
        ctau = c_new
        acc += w[..., None] * v[..., :3]
        depth += w * rel * sec * float(fp.cell_world)
    return np.concatenate([acc, (1 - np.exp(-ctau))[..., None], depth[..., None]], -1)


def model_screen(raster, fp):
    """Kernel I's per-pixel arithmetic in float64 → (rgba [H, W, 4], depth)."""
    r = np.asarray(raster, np.float64)
    Bi = fp.Bi
    uu = (np.arange(fp.W) + 0.5 - fp.principal_px[0]) / float(fp.focal[0])
    vv = (np.arange(fp.H) + 0.5 - fp.principal_px[1]) / float(fp.focal[1])
    U, V = np.meshgrid(uu, vv)  # [H, W]
    rows, sc = fp.rows.astype(np.float64), fp.scale.astype(np.float64)
    d = [(rows[a, 0] * U + rows[a, 1] * V + rows[a, 2]) * sc[a] for a in range(3)]
    ez, ey, ex = fp.e.astype(np.float64)
    by0, by1, bx0, bx1 = fp.box.astype(np.float64)
    t_hit = (0.5 - ez) / np.where(np.abs(d[0]) < 1e-6, 1e-6, d[0])
    gy = (ey + t_hit * d[1] - by0) / (by1 - by0) * Bi - 0.5
    gx = (ex + t_hit * d[2] - bx0) / (bx1 - bx0) * Bi - 0.5
    ok = (t_hit > 0) & (gy > -1) & (gy < Bi) & (gx > -1) & (gx < Bi)
    y0 = np.clip(np.floor(gy), 0, Bi - 2).astype(np.int64)
    x0 = np.clip(np.floor(gx), 0, Bi - 2).astype(np.int64)
    fy = np.clip(gy - y0, 0, 1)[..., None]
    fx = np.clip(gx - x0, 0, 1)[..., None]
    out = (r[x0, y0] * (1 - fy) + r[x0, y0 + 1] * fy) * (1 - fx) + (r[x0 + 1, y0] * (1 - fy) + r[x0 + 1, y0 + 1] * fy) * fx
    alpha = np.where(ok, out[..., 3], 0.0)
    rgb = np.where(ok[..., None], out[..., :3], 0.0)
    sky = fp.sky.astype(np.float64)
    rgba = np.concatenate([rgb + (1 - alpha[..., None]) * sky[:3], (alpha + (1 - alpha) * sky[3])[..., None]], -1)
    return rgba, np.where(ok, out[..., 4] / np.maximum(out[..., 3], 1e-6), 0.0)


@pytest.mark.parametrize("view", ["x+", "z-", "inside"])
def test_float64_model_of_the_kernels_matches_the_plain_versions(jax_volume, view):
    _, tv = jax_volume
    fp = tbaked.frame_params(B, LO, HI, (W, H), VIEWS[view], FOCAL, None, (0.1, 0.2, 0.3, 0.5), BI)
    field = tv.fields[fp.major]
    raster = tbaked.shear_warp_composite_plain(field, fp)
    np.testing.assert_allclose(raster.numpy(), model_composite(field.float().numpy(), fp), rtol=0, atol=1e-5)
    rgba, depth = tbaked.shear_warp_screen_plain(raster, fp)
    m_rgba, m_depth = model_screen(raster.numpy(), fp)
    np.testing.assert_allclose(rgba.numpy(), m_rgba, rtol=0, atol=1e-5)
    np.testing.assert_allclose(depth.numpy(), m_depth, rtol=0, atol=1e-5)
    assert float(raster[..., 3].max()) > 0.5  # the slices in front of an eye inside too


@pytest.mark.parametrize("view", ["x+", "z-", "inside", "corners_behind"])
def test_composite_plan_boxes_hold_every_tap(view):
    """Kernel H's tile boxes (``composite_plan``, the host mirror of its
    block set-up): every tap of a valid texel that the plain version's
    ``_source`` gives lies in its tile's box of that slice when the box is
    staged, and no valid texel's tile skips its slice."""
    xf, focal = corners_behind_view() if view == "corners_behind" else (VIEWS[view], FOCAL)
    fp = tbaked.frame_params(B, LO, HI, (W, H), xf, focal, None, (0, 0, 0, 0), BI)
    plan = tbaked.composite_plan(fp)
    tx, ty = tbaked.COMPOSITE_TILE
    assert plan.mode.shape == (-(-BI // tx), -(-BI // ty), B)
    src = tbaked.slice_sources(fp, CPU)
    (y0, _, vy), (x0, _, vx) = src.y, src.x
    y0, x0 = y0.numpy()[:, :, None], x0.numpy()[:, None, :]  # [B, y', x']
    valid = src.front.numpy()[:, None, None] & vy.numpy()[:, :, None] & vx.numpy()[:, None, :]
    k = np.arange(B)[:, None, None]
    tile_y, tile_x = (np.arange(BI) // ty)[None, :, None], (np.arange(BI) // tx)[None, None, :]
    mode = plan.mode[tile_x, tile_y, k]
    box = plan.box[tile_x, tile_y, k]  # [B, y', x', 4]
    assert not (valid & (mode == tbaked.SKIP)).any()
    staged = valid & (mode == tbaked.STAGED)
    assert staged.sum() > 0.3 * valid.sum() > 0
    inside = (y0 >= box[..., 0]) & (y0 + 1 <= box[..., 1]) & (x0 >= box[..., 2]) & (x0 + 1 <= box[..., 3])
    assert inside[staged].all()
    rows, cols = tbaked.COMPOSITE_BOX
    fits = (plan.box[..., 1] - plan.box[..., 0] < rows) & (plan.box[..., 3] - plan.box[..., 2] < cols)
    assert fits[plan.mode == tbaked.STAGED].all() and not fits[plan.mode == tbaked.DIRECT].any()


def test_composite_plan_constants_are_the_kernels():
    src = (Path(tbaked.__file__).parent.parent / "csrc" / "baked.cu").read_text()
    const = {m[0]: int(m[1]) for m in re.findall(r"(k\w+) = (\d+)[;,]", src)}
    assert (const["kTileX"], const["kTileY"]) == tbaked.COMPOSITE_TILE
    assert (const["kBoxRows"], const["kTileX"]) == tbaked.COMPOSITE_BOX
    assert (const["kStages"], const["kMaxB"]) == (tbaked.COMPOSITE_STAGES, tbaked.COMPOSITE_MAX_B)


def test_wrappers_take_the_plain_version_on_cpu_and_check_cuda_inputs(jax_volume):
    _, tv = jax_volume
    fp = tbaked.frame_params(B, LO, HI, (W, H), VIEWS["y+"], FOCAL, with_depth=False)
    field = tv.fields[fp.major]
    before = (tbaked.shear_warp_composite_cuda.launches, tbaked.shear_warp_screen_cuda.launches)
    raster = tbaked.shear_warp_composite(field, fp)
    assert torch.equal(raster, tbaked.shear_warp_composite_plain(field, fp))
    assert float(raster[..., 4].abs().max()) == 0.0  # no depth asked for
    rgba, depth = tbaked.shear_warp_screen(raster, fp)
    assert torch.equal(rgba, tbaked.shear_warp_screen_plain(raster, fp)[0])
    assert (tbaked.shear_warp_composite_cuda.launches, tbaked.shear_warp_screen_cuda.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        tbaked.shear_warp_composite_cuda(field, fp)
    with pytest.raises(ValueError, match="CUDA"):
        tbaked.shear_warp_screen_cuda(raster, fp)


# ------------------------------------------------------ the testbed's path


def _testbed(density):
    """A port testbed with the tiny network, a four-view scene (for
    ``train``), random weights and the given density grid."""
    from nerfshop_tpu_torch.testbed import Testbed
    from test_torch_testbed_render import _dataset

    tb = Testbed(config=CFG, device="cpu", seed=0)
    ds = _dataset(n=4)
    ds.images[..., 3] = 1.0
    tb.set_training_data(ds)
    with torch.no_grad():
        tb.model.pos_encoding.table.uniform_(-1.0, 1.0, generator=torch.Generator().manual_seed(3))
        tb.model.density_mlp.weights[-1][:, 0] *= 3.0  # raw σ spread wide enough for opaque regions
        for k, v in tb.model.named_parameters():  # the EMA copy, which the bake reads
            tb.inference_params[k].copy_(v)
    tb.grid.density.copy_(torch.from_numpy(density))
    tgrid.update_bitfield(tb.grid)
    tb.interactive_bake_resolution = B
    return tb


def _dup(tx, hide=True):
    return AffineDuplicationOp.create(center=[0.5, 0.5, 0.5], half_extents=[0.12] * 3, transform_t=[tx, 0.0, 0.0],
                                      hide_original=hide, device=CPU)


def test_interactive_flags_rebake_and_full_after_train():
    """The flag sequence of ``tests/test_interactive_rebake.py``: a full
    bake, no rebake when nothing changed, an incremental one after a drag
    (equal to a forced full bake), a full one after training."""
    tb = _testbed(seeded_density())
    tb.add_edit_operator(_dup(0.18), refresh_grid=False)
    img1 = tb.render_interactive(48, 32)
    assert img1.shape == (32, 48, 4) and np.isfinite(img1).all()
    assert tb.last_bake_incremental is False and tb._baked.resolution == B
    vol, key = tb._baked, tb._baked_key
    tb.render_interactive(48, 32)
    assert tb._baked is vol and tb._baked_key == key  # nothing changed: no bake
    tb.replace_edit_operator(0, _dup(0.26), refresh_grid=False)
    img2 = tb.render_interactive(48, 32)
    assert tb._baked_key != key and tb.last_bake_incremental is True
    assert np.abs(img1 - img2).max() > 1e-3
    incr = tb._baked.canonical.clone()
    tb.bake_interactive(force_full=True)
    assert tb.last_bake_incremental is False
    assert float((incr.float() - tb._baked.canonical.float()).abs().max()) < 1e-2
    key = tb._baked_key
    tb.train(1, 1 << 13)
    tb.render_interactive(48, 32)
    assert tb._baked_key != key and tb.last_bake_incremental is False


def _ball_density(center=(0.5, 0.5, 0.5), r=0.2):
    g = (np.arange(128) + 0.5) / 128
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    d2 = (x - center[0]) ** 2 + (y - center[1]) ** 2 + (z - center[2]) ** 2
    return np.where(d2 < r * r, 400.0, 0.0).astype(np.float32)[None]


def test_f5_content_dragged_out_of_the_bake_box_rebakes_in_full():
    """A duplicate dragged past the tight bake box: its copy lands in cells
    the grid refresh marks occupied outside the box, so the port bakes in
    full (a new box) and equals a forced full bake."""
    tb = _testbed(_ball_density())
    tb.add_edit_operator(_dup(0.1, hide=False), refresh_grid=False)
    tb.render_interactive(48, 32)
    hi_before = tb._baked.aabb_hi.copy()
    assert hi_before[0] < 0.8  # a tight box around the ball
    tb.replace_edit_operator(0, _dup(0.3, hide=False), refresh_grid=False)
    # what the grid refresh through the stack marks: the copy at x + 0.3
    tb.grid.density.copy_(torch.from_numpy(np.maximum(_ball_density(), _ball_density(center=(0.8, 0.5, 0.5), r=0.12))))
    tgrid.update_bitfield(tb.grid)
    tb.grid = tb.grid
    tb.render_interactive(48, 32)
    assert tb.last_bake_incremental is False and tb._baked.aabb_hi[0] > hi_before[0]
    ours = tb._baked.canonical.clone()
    tb.bake_interactive(force_full=True)
    assert torch.equal(ours, tb._baked.canonical)
    # a drag that stays inside the box rebakes incrementally
    tb.replace_edit_operator(0, _dup(0.28, hide=False), refresh_grid=False)
    tb.render_interactive(48, 32)
    assert tb.last_bake_incremental is True


def test_rebake_reaches_what_a_newer_operator_copies_from_the_dragged_one():
    """F15: a duplicate copies the target of an older duplicate; dragging
    the older one changes the newer one's copy too, far from the dragged
    operator's box (another y). The port's rebake region takes it in (at
    64³, so that the region is not the whole grid) and equals a full
    bake."""
    balls = [_ball_density(), _ball_density(center=(0.7, 0.5, 0.5), r=0.12),
             _ball_density(center=(0.5, 0.2, 0.5), r=0.12)]
    tb = _testbed(np.maximum.reduce(balls))  # the cells a refresh through the stack marks
    tb.interactive_bake_resolution = 64

    def older(tx):
        return _dup(tx, hide=False)

    newer = AffineDuplicationOp.create(center=[0.7, 0.5, 0.5], half_extents=[0.12] * 3,
                                       transform_t=[-0.2, -0.3, 0.0], device=CPU)
    tb.add_edit_operator(older(0.2), refresh_grid=False)
    tb.add_edit_operator(newer, refresh_grid=False)
    tb.bake_interactive()
    tb.replace_edit_operator(0, older(0.22), refresh_grid=False)
    tb.bake_interactive()
    assert tb.last_bake_incremental is True
    ours = tb._baked.canonical.clone()
    tb.bake_interactive(force_full=True)
    assert torch.equal(ours, tb._baked.canonical)


@pytest.mark.xfail(strict=True, reason="F5: nerfshop_tpu/testbed.py:939-957 patches the previous bake's box without "
                                       "checking that the dragged content is still inside it")
def test_f5_jax_testbed_loses_content_dragged_out_of_the_box():
    from nerfshop_tpu import Testbed as JTestbed
    from nerfshop_tpu.ops import grid as jgrid

    tb = JTestbed(config=CFG)
    tb._grid = jgrid.update_bitfield(tb._grid._replace(density=jnp.asarray(_ball_density())))
    tb.interactive_bake_resolution = B
    tb.add_edit_operator(jops.AffineDuplicationOp.create(center=[0.5] * 3, half_extents=[0.12] * 3,
                                                         transform_t=[0.1, 0.0, 0.0]), refresh_grid=False)
    tb.bake_interactive()
    tb.replace_edit_operator(0, jops.AffineDuplicationOp.create(center=[0.5] * 3, half_extents=[0.12] * 3,
                                                                transform_t=[0.3, 0.0, 0.0]), refresh_grid=False)
    dens = np.maximum(_ball_density(), _ball_density(center=(0.8, 0.5, 0.5), r=0.12))
    tb._grid = jgrid.update_bitfield(tb._grid._replace(density=jnp.asarray(dens)))
    tb.bake_interactive()
    incremental = np.asarray(tb._baked.canonical, np.float32)
    tb.bake_interactive(force_full=True)
    assert incremental.shape == np.asarray(tb._baked.canonical).shape
    np.testing.assert_allclose(incremental, np.asarray(tb._baked.canonical, np.float32), atol=1e-2)
