"""The port's occupancy-grid maintenance against ``nerfshop_tpu/ops/grid.py``.

``update_density_grid`` draws its slab offset and jitter inside the JAX
function; the test reproduces those draws with the same keys and hands
them to the port, so both evaluate the density at the same positions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfshop_tpu.ops import grid as jgrid
from nerfshop_tpu_torch.ops import grid as tgrid
from torch_one_thread import one_thread  # noqa: F401

R = 128


def _random_grid(seed, C):
    """Sparse densities on a grid of quarters (so the fp32 mean is exact in
    any summation order), some masked (−1) cells, no denormals."""
    rng = np.random.default_rng(seed)
    dens = np.where(
        rng.uniform(0, 1, (C, R, R, R)) < 0.02, rng.integers(1, 40, (C, R, R, R)) * 0.25, 0.0
    ).astype(np.float32)
    dens[0, :4] = -1.0  # masked (untrained) cells
    occ = rng.uniform(0, 1, (C, R, R, R)) < 0.5
    return dens, occ


def _pair(dens, occ):
    j = jgrid.OccupancyGrid(jnp.asarray(dens), jnp.asarray(occ), jnp.zeros((), jnp.float32))
    t = tgrid.OccupancyGrid(torch.from_numpy(dens.copy()), torch.from_numpy(occ.copy()), torch.zeros(()))
    return j, t


@pytest.mark.parametrize("C", [1, 2])
def test_update_bitfield_matches(C):
    # mean and occupancy exact
    j, t = _pair(*_random_grid(0, C))
    jr = jgrid.update_bitfield(j)
    tr = tgrid.update_bitfield(t)
    assert float(tr.mean_density) == float(jr.mean_density)
    assert 0 < tr.occupancy.float().mean() < 0.5
    np.testing.assert_array_equal(tr.occupancy.numpy(), np.asarray(jr.occupancy))


def _cell_constant_density(pos):
    """Density that is constant inside each cascade-0 cell (positions are
    cell centres plus a jitter in [0, 1))."""
    cell = torch.floor(pos * R).clamp(0, R - 1)
    return ((cell[:, 0] * 7 + cell[:, 1] * 13 + cell[:, 2] * 3) % 17) * 0.5


def _cell_constant_density_jax(pos):
    cell = jnp.clip(jnp.floor(pos * R), 0, R - 1)
    return ((cell[:, 0] * 7 + cell[:, 1] * 13 + cell[:, 2] * 3) % 17) * 0.5


def _smooth_density_torch(pos):
    return torch.exp(2.0 * torch.sin(6.0 * pos).sum(-1))


def _smooth_density_jax(pos):
    return jnp.exp(2.0 * jnp.sin(6.0 * pos).sum(-1))


def _jax_draws(key, C, full_refresh):
    """The (z_lo, jitter) that jgrid.update_density_grid draws from ``key``."""
    k_slab, k_jit = jax.random.split(key)
    z = R if full_refresh else R // 4
    z_lo = 0 if full_refresh else int(jax.random.randint(k_slab, (), 0, R // z)) * z
    return z_lo, np.asarray(jax.random.uniform(k_jit, (C * R * R * z, 3)))


@pytest.mark.parametrize(
    "C,full_refresh,fns",
    [
        (1, True, (_cell_constant_density_jax, _cell_constant_density)),
        (1, False, (_smooth_density_jax, _smooth_density_torch)),
        (2, False, (_smooth_density_jax, _smooth_density_torch)),
    ],
)
def test_update_density_grid_matches(C, full_refresh, fns):
    # EMA + max-splat of the same densities: exact up to the density fn's
    # own fp32 evaluation (rtol 1e-6)
    jfn, tfn = fns
    dens, occ = _random_grid(1, C)
    j, t = _pair(dens, occ)
    key = jax.random.PRNGKey(3)
    jr = jgrid.update_density_grid(j, jfn, key, C, full_refresh=full_refresh)
    z_lo, jitter = _jax_draws(key, C, full_refresh)
    tr = tgrid.update_density_grid(t, tfn, C, full_refresh, z_lo, torch.from_numpy(jitter.copy()))
    assert tr is t  # updated in place
    np.testing.assert_allclose(tr.density.numpy(), np.asarray(jr.density), rtol=1e-6, atol=0)


def test_draw_refresh_shapes():
    g = torch.Generator().manual_seed(0)
    for full in (True, False):
        z_lo, jitter = tgrid.draw_refresh(2, full, g, "cpu")
        z = R if full else R // 4
        assert jitter.shape == (2 * R * R * z, 3) and z_lo % z == 0 and 0 <= z_lo < R
        assert float(jitter.min()) >= 0 and float(jitter.max()) < 1


def test_mark_untrained_cells_matches():
    rng = np.random.default_rng(4)
    n = 4
    pos = (0.5 + rng.normal(size=(n, 3)) * 1.5).astype(np.float32)
    fwd = (0.5 - pos) / np.linalg.norm(0.5 - pos, axis=-1, keepdims=True)
    focal = np.full((n, 2), 40.0, np.float32)
    res = np.full((n, 2), 32.0, np.float32)
    j = jgrid.OccupancyGrid.create(2)
    ref = np.asarray(jgrid.mark_untrained_cells(j, *(jnp.asarray(a.astype(np.float32)) for a in (pos, fwd, focal, res))))
    ours = tgrid.mark_untrained_cells(2, *(torch.from_numpy(a.astype(np.float32)) for a in (pos, fwd, focal, res))).numpy()
    assert 0 < ref.mean() < 1
    # cells exactly on a frustum boundary may flip with the rounding of sqrt(3)
    assert (ours != ref).mean() < 1e-5
