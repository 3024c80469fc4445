"""The small helpers of the port's ``ops/coords.py``, ``ops/grid.py``,
``editing/mvc.py`` and ``ops/rays.py::sample_training_rays`` against the JAX
package's, on the same seeded numpy inputs: bit-equal, or within the bound
stated where a sum or a loop that XLA fuses rounds otherwise. ``sample_training_rays``' random
draws are rebuilt in the test from JAX's own key split and handed to the
port's deterministic part; the port's draw step is checked in distribution."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfshop_tpu.common import GRID_RESOLUTION
from nerfshop_tpu.editing import mvc as jmvc
from nerfshop_tpu.ops import coords as jcoords
from nerfshop_tpu.ops import grid as jgrid
from nerfshop_tpu.ops import rays as jrays
from nerfshop_tpu_torch.editing import mvc as tmvc
from nerfshop_tpu_torch.ops import coords as tcoords
from nerfshop_tpu_torch.ops import grid as tgrid
from nerfshop_tpu_torch.ops import rays as trays
from torch_one_thread import one_thread  # noqa: F401

F32 = np.float32
R = GRID_RESOLUTION


def _eq(got: torch.Tensor, ref):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _boxes():
    return (jcoords.BoundingBox.from_aabb_scale(4), tcoords.BoundingBox.from_aabb_scale(4))


def test_box_contains_and_position_direction_warps():
    rng = np.random.default_rng(0)
    pos = rng.uniform(-2.5, 3.5, (512, 3)).astype(F32)
    pos[:8] = [[-1.5] * 3, [2.5] * 3, [-1.5, 0.5, 2.5], [2.5, 2.5, -1.5000001], [0, 0, 0], [1, 1, 1], [3, 0, 0],
               [0.5, -1.6, 0.5]]  # the box's faces, corners and just outside
    jb, tb = _boxes()
    _eq(tb.contains(torch.from_numpy(pos)), jb.contains(jnp.asarray(pos)))
    unit = rng.uniform(0, 1, (512, 3)).astype(F32)
    _eq(tcoords.unwarp_position(torch.from_numpy(unit), tb), jcoords.unwarp_position(jnp.asarray(unit), jb))
    _eq(tcoords.unwarp_direction(torch.from_numpy(unit)), jcoords.unwarp_direction(jnp.asarray(unit)))


@pytest.mark.parametrize("n_cascades", [1, 3, 5, 8])
def test_dt_warps_and_cone_angle(n_cascades):
    rng = np.random.default_rng(n_cascades)
    dt = rng.uniform(0, 0.2, 1024).astype(F32)
    _eq(tcoords.warp_dt(torch.from_numpy(dt), n_cascades), jcoords.warp_dt(jnp.asarray(dt), n_cascades))
    w = rng.uniform(0, 1, 1024).astype(F32)
    _eq(tcoords.unwarp_dt(torch.from_numpy(w), n_cascades), jcoords.unwarp_dt(jnp.asarray(w), n_cascades))
    cosine = rng.uniform(0.5, 1, 1024).astype(F32)
    focal_y = rng.uniform(100, 2000, 1024).astype(F32)
    for const in (0.0, 1 / 256, 1e-3):
        _eq(tcoords.calc_cone_angle(torch.from_numpy(cosine), torch.from_numpy(focal_y), const),
            jcoords.calc_cone_angle(jnp.asarray(cosine), jnp.asarray(focal_y), const))


def _dda_inputs(seed, n=2048):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 1, (n, 3)).astype(F32)
    d = rng.normal(size=(n, 3)).astype(F32)
    d[: n // 4, 0] = 0.0  # zero components: sign 0, and the clamped inverse
    d[n // 8 : n // 4, 1] = 0.0
    d[n // 4 : n // 4 + 16, :] = [[0, 0, 1], [0, -1, 0], [1, 0, 0], [0, 0, -1]] * 4
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    inv = (1.0 / np.where(np.abs(d) < 1e-12, F32(1e-12), d)).astype(F32)
    pos[-8:] = np.floor(pos[-8:] * R) / R  # exactly on cell faces
    return pos, d, inv


@pytest.mark.parametrize("res", ["scalar", "per-element"])
def test_distance_to_next_voxel(res):
    pos, d, inv = _dda_inputs(1)
    if res == "scalar":
        r_j, r_t = R, R
    else:
        r = (R >> np.random.default_rng(2).integers(0, 5, len(pos))).astype(F32)  # a cascade's resolution each
        r_j, r_t = jnp.asarray(r), torch.from_numpy(r)
    ref = jcoords.distance_to_next_voxel(jnp.asarray(pos), jnp.asarray(d), jnp.asarray(inv), r_j)
    got = tcoords.distance_to_next_voxel(torch.from_numpy(pos), torch.from_numpy(d), torch.from_numpy(inv), r_t)
    assert (np.asarray(ref) >= 0).all() and (np.asarray(ref) > 0).any()
    _eq(got, ref)


@pytest.mark.parametrize("n_cascades", [1, 4, 8])
def test_mip_from_dt(n_cascades):
    rng = np.random.default_rng(3)
    n = 4096
    pos = (0.5 + rng.uniform(-1, 1, (n, 3)) * rng.choice([0.2, 0.5, 1, 2, 8, 64], (n, 1))).astype(F32)
    # d = dt · 256: below 1, at the powers of two and between them
    dt = (np.exp2(rng.uniform(-12, 2, n)) / (2 * R)).astype(F32)
    dt[:64] = np.exp2(np.arange(-8, 8, 0.25))[:64] / (2 * R)
    dt[64:80] = (1 - 2.0 ** -np.arange(1, 17)) / (2 * R)  # just under d = 1
    ref = np.asarray(jcoords.mip_from_dt(jnp.asarray(dt), jnp.asarray(pos), n_cascades))
    got = tcoords.mip_from_dt(torch.from_numpy(dt), torch.from_numpy(pos), n_cascades)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)
    assert len(np.unique(ref)) == n_cascades  # every cascade reached


def test_ema_update():
    rng = np.random.default_rng(4)
    dens = np.where(rng.uniform(size=(2, 8, 8, 8)) < 0.5, rng.uniform(0, 50, (2, 8, 8, 8)), 0).astype(F32)
    fresh = rng.uniform(0, 60, dens.shape).astype(F32)
    sampled = rng.uniform(size=dens.shape) < 0.3
    for decay in (0.95, 0.5):
        _eq(tgrid.ema_update(*map(torch.from_numpy, (dens, fresh, sampled)), decay),
            jgrid.ema_update(*map(jnp.asarray, (dens, fresh, sampled)), decay))
    _eq(tgrid.ema_update(*map(torch.from_numpy, (dens, fresh, sampled))),
        jgrid.ema_update(*map(jnp.asarray, (dens, fresh, sampled))))


def test_grid_lookups_on_a_grid_from_jax():
    rng = np.random.default_rng(5)
    C = 3
    jg = jgrid.OccupancyGrid.create(C)
    dens = (rng.integers(0, 40, (C, R, R, R)) * 0.25).astype(F32)
    jg = jgrid.update_bitfield(jg._replace(density=jnp.asarray(dens)))
    tg = tgrid.OccupancyGrid(*(torch.from_numpy(np.array(a)) for a in (jg.density, jg.occupancy, jg.mean_density)))
    pos = (0.5 + rng.uniform(-2.2, 2.2, (4096, 3))).astype(F32)
    mip = rng.integers(0, C, 4096).astype(np.int32)
    ref_occ = np.asarray(jgrid.occupancy_at(jg, jnp.asarray(pos), jnp.asarray(mip)))
    ref_den = np.asarray(jgrid.density_at(jg, jnp.asarray(pos), jnp.asarray(mip)))
    assert 0 < ref_occ.mean() < 1
    p, m = torch.from_numpy(pos), torch.from_numpy(mip)
    _eq(tgrid.occupancy_at(tg, p, m), ref_occ)
    _eq(tgrid.density_at(tg, p, m), ref_den)
    # the cascade of each position, as the march picks it
    m = tcoords.mip_from_pos(p, C)
    _eq(tgrid.density_at(tg, p, m), jgrid.density_at(jg, jnp.asarray(pos), jcoords.mip_from_pos(jnp.asarray(pos), C)))


def test_interpolate_with_mvc():
    rng = np.random.default_rng(6)
    cube = np.array([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)], F32)
    faces = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                      [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    pts = rng.uniform(0.05, 0.95, (64, 3)).astype(F32)
    w = np.asarray(jmvc.mvc_weights(jnp.asarray(pts), jnp.asarray(cube), jnp.asarray(faces)))
    values = rng.normal(size=(8, 27)).astype(F32)  # e.g. SH coefficients at the cage's vertices
    got = tmvc.interpolate_with_mvc(torch.from_numpy(w), torch.from_numpy(values)).numpy()
    ref = np.asarray(jmvc.interpolate_with_mvc(jnp.asarray(w), jnp.asarray(values)))
    # 8 products summed in float32 in another order: each side within
    # 8·2^-24 of Σ|terms| of the exact sum
    assert (np.abs(got - ref) <= 2 * 8 * 2.0**-24 * (np.abs(w) @ np.abs(values))).all()
    # linear precision: the cage's own positions give back the points
    moved = tmvc.interpolate_with_mvc(torch.from_numpy(w), torch.from_numpy(cube)).numpy()
    np.testing.assert_allclose(moved, pts, atol=1e-5)


# --------------------------------------------------------- sample_training_rays


def _scene(seed=7, N=5, H=12, W=20):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (N, H, W, 4)).astype(F32)
    ang = rng.uniform(0, 2 * np.pi, N)
    xforms = np.zeros((N, 3, 4), F32)
    for i, a in enumerate(ang):
        c, s = np.cos(a), np.sin(a)
        xforms[i, :, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        xforms[i, :, 3] = rng.uniform(-1, 1, 3)
    focals = rng.uniform(15, 25, (N, 2)).astype(F32)
    principals = rng.uniform(0.45, 0.55, (N, 2)).astype(F32)
    distortions = (rng.normal(size=(N, 4)) * [0.05, 0.01, 0.002, 0.002]).astype(F32)
    error_map = (rng.uniform(0, 1, (N, 4, 6)) ** 4).astype(F32)
    pmf = np.array([0.5, 0.05, 0.2, 0.05, 0.2], F32)
    return images, xforms, focals, principals, distortions, error_map, pmf


def _jax_draws(key, n, N, pmf, error_map):
    """sample_training_rays' draws, from its own split of ``key``."""
    k_img, k_pix, k_err = jax.random.split(key, 3)
    if pmf is not None:
        img_idx = jax.random.categorical(k_img, jnp.log(jnp.asarray(pmf) + 1e-12), shape=(n,))
    else:
        img_idx = jax.random.randint(k_img, (n,), 0, N)
    u = jax.random.uniform(k_pix, (n, 2))
    cells = None
    if error_map is not None:
        eh, ew = error_map.shape[1:]
        flat = jnp.asarray(error_map)[img_idx].reshape(n, eh * ew) + 1e-8
        cells = torch.from_numpy(np.asarray(jax.random.categorical(k_err, jnp.log(flat), axis=-1)).astype(np.int64))
    return torch.from_numpy(np.asarray(img_idx).astype(np.int64)), torch.from_numpy(np.asarray(u)), cells


@pytest.mark.parametrize("distortion", [False, True])
@pytest.mark.parametrize("pmf", [False, True])
@pytest.mark.parametrize("error_map", [False, True])
def test_training_rays_from_jax_draws(distortion, pmf, error_map):
    images, xforms, focals, principals, distortions, em, w = _scene()
    n, key = 777, jax.random.PRNGKey(11)
    dist = distortions if distortion else None
    em = em if error_map else None
    w = w if pmf else None
    rb, targets, img_idx = jrays.sample_training_rays(
        key, n, *map(jnp.asarray, (images, xforms, focals, principals)),
        distortions=None if dist is None else jnp.asarray(dist), image_pmf=None if w is None else jnp.asarray(w),
        error_map=None if em is None else jnp.asarray(em),
    )
    idx, u, cells = _jax_draws(key, n, len(images), w, em)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(img_idx))
    t = torch.from_numpy
    trb, ttargets, tidx = trays.training_rays_from_draws(
        idx, u, cells, t(images), t(xforms), t(focals), t(principals), None if dist is None else t(dist),
        None if em is None else em.shape[1:],
    )
    assert torch.equal(tidx, idx)
    _eq(ttargets, targets)
    _eq(trb.origins, rb.origins)
    if dist is None:
        _eq(trb.directions, rb.directions)
    else:
        # XLA compiles the undistortion loop's body as one fused kernel and
        # contracts its multiply-adds into FMAs, which torch's eager ops do
        # not: the directions within 4 ulps of 1 (2^-22)
        np.testing.assert_allclose(trb.directions.numpy(), np.asarray(rb.directions), rtol=0, atol=2.0**-22)


def test_training_ray_draws_follow_the_pmf():
    # image frequencies under a skewed pmf within 4σ over 2^16 draws; the
    # uniforms in [0, 1) and the cells inside each image's map
    images, xforms, focals, principals, _, em, w = _scene()
    n = 1 << 16
    g = torch.Generator().manual_seed(0)
    idx, u, cells = trays.draw_training_rays(n, len(images), g, "cpu", torch.from_numpy(w), torch.from_numpy(em))
    p = (w.astype(np.float64) + 1e-12) / (w.astype(np.float64) + 1e-12).sum()
    freq = np.bincount(idx.numpy(), minlength=len(w)) / n
    assert (np.abs(freq - p) <= 4 * np.sqrt(p * (1 - p) / n)).all(), (freq, p)
    assert u.shape == (n, 2) and float(u.min()) >= 0 and float(u.max()) < 1
    assert cells.dtype == torch.int64 and int(cells.min()) >= 0 and int(cells.max()) < em.shape[1] * em.shape[2]
    # without the pmf: uniform over the images; the whole call's shapes
    rb, targets, idx = trays.sample_training_rays(n, *map(torch.from_numpy, (images, xforms, focals, principals)), g)
    freq = np.bincount(idx.numpy(), minlength=len(w)) / n
    q = 1 / len(w)
    assert (np.abs(freq - q) <= 4 * np.sqrt(q * (1 - q) / n)).all(), freq
    assert rb.origins.shape == (n, 3) and targets.shape == (n, 4)
    np.testing.assert_allclose(rb.directions.norm(dim=-1).numpy(), 1.0, atol=1e-6)
