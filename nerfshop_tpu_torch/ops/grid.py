"""Cascaded occupancy / density grid maintenance.

Counterpart of ``nerfshop_tpu/ops/grid.py``: the density grid is a
``[C, 128, 128, 128]`` EMA of network densities (every cell decays by 0.95
per update, refreshed cells take the max with their fresh density), and the
occupancy bitfield thresholds it at min(mean, 0.01 / Δmin), each coarser
cascade OR-ing in a 2× max-pool of the finer one.

The slab offset ``z_lo`` and the jitter are inputs; :func:`draw_refresh`
draws them from a ``torch.Generator``. :func:`ema_update` is JAX's EMA rule;
:func:`update_density_grid` applies it in place to the sampled slab, with
the −1 kill sentinel, and decays the rest. :func:`occupancy_at` and :func:`density_at` read
the grids at positions of given cascades.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from nerfshop_tpu_torch.common import (
    DENSITY_GRID_DECAY,
    GRID_RESOLUTION,
    MIN_CONE_STEPSIZE,
    NERF_MIN_OPTICAL_THICKNESS,
)
from nerfshop_tpu_torch.ops import coords

R = GRID_RESOLUTION
#: positions per density-network call during a refresh
CHUNK = 1 << 17


@dataclass
class OccupancyGrid:
    density: torch.Tensor  # [C, R, R, R] f32, EMA'd activated density
    occupancy: torch.Tensor  # [C, R, R, R] bool
    mean_density: torch.Tensor  # [] f32

    @property
    def n_cascades(self) -> int:
        return self.density.shape[0]

    @staticmethod
    def create(n_cascades: int, device=None) -> "OccupancyGrid":
        return OccupancyGrid(
            density=torch.zeros((n_cascades, R, R, R), dtype=torch.float32, device=device),
            occupancy=torch.ones((n_cascades, R, R, R), dtype=torch.bool, device=device),
            mean_density=torch.zeros((), dtype=torch.float32, device=device),
        )


def cell_world_positions(cell_idx: torch.Tensor, mip: torch.Tensor, jitter: torch.Tensor) -> torch.Tensor:
    """(ix, iy, iz) cells of cascade ``mip`` + jitter in [0,1)³ → warped position."""
    p = (cell_idx.to(torch.float32) + jitter) / R
    scale = torch.exp2(mip.to(torch.float32))[..., None]
    return (p - 0.5) * scale + 0.5


def ema_update(density: torch.Tensor, fresh: torch.Tensor, sampled: torch.Tensor,
               decay: float = DENSITY_GRID_DECAY) -> torch.Tensor:
    """Every cell decays by ``decay``; the ``sampled`` ones take the max
    with their ``fresh`` density (max-splat semantics) → a new grid."""
    return torch.maximum(density * decay, torch.where(sampled, fresh, torch.zeros_like(fresh)))


def slab_size(full_refresh: bool) -> int:
    return R if full_refresh else R // 4


def slab_positions(n_cascades_active: int, z_lo: int, z_size: int, jitter: torch.Tensor) -> torch.Tensor:
    """Jittered positions of every cell in the z-slab [z_lo, z_lo + z_size)
    of every active cascade, meshgrid (x, y, z) order → [C·R·R·z_size, 3]."""
    dev = jitter.device
    ix, iy, iz = torch.meshgrid(
        torch.arange(R, device=dev), torch.arange(R, device=dev), torch.arange(z_size, device=dev),
        indexing="ij",
    )
    cells_one = torch.stack([ix, iy, iz + z_lo], dim=-1).reshape(-1, 3)
    cells = cells_one.repeat(n_cascades_active, 1)
    mips = torch.arange(n_cascades_active, device=dev).repeat_interleave(R * R * z_size)
    return cell_world_positions(cells, mips, jitter)


def draw_refresh(n_cascades_active: int, full_refresh: bool, generator: torch.Generator, device):
    """(z_lo, jitter [C·R·R·z_size, 3]) for :func:`update_density_grid`."""
    z_size = slab_size(full_refresh)
    z_lo = 0
    if not full_refresh:
        z_lo = int(torch.randint(0, R // z_size, (), generator=generator, device=device)) * z_size
    jitter = torch.rand((n_cascades_active * R * R * z_size, 3), generator=generator, device=device)
    return z_lo, jitter


@torch.no_grad()
def update_density_grid(
    grid: OccupancyGrid,
    density_fn: Callable[[torch.Tensor], torch.Tensor],
    n_cascades_active: int,
    full_refresh: bool,
    z_lo: int,
    jitter: torch.Tensor,
) -> OccupancyGrid:
    """One density-grid update: evaluate ``density_fn`` (positions [N, 3] →
    activated density [N]) on the jittered cells of the slab in chunks of
    2^17, decay every cell, and max-splat the slab. Updates
    ``grid.density`` IN PLACE and returns ``grid``."""
    z_size = slab_size(full_refresh)
    pos = slab_positions(n_cascades_active, z_lo, z_size, jitter)
    sigma = torch.cat([density_fn(pos[i : i + CHUNK]) for i in range(0, pos.shape[0], CHUNK)])
    fresh = sigma.to(torch.float32).reshape(n_cascades_active, R, R, z_size)
    slab = grid.density[:n_cascades_active, :, :, z_lo : z_lo + z_size]
    # fresh < 0 is the operator-kill sentinel of the JAX grid: clear hard
    kill = fresh < 0
    new_slab = torch.where(kill, torch.zeros_like(fresh), ema_update(slab, fresh, ~kill))
    grid.density.mul_(DENSITY_GRID_DECAY)
    slab.copy_(new_slab)
    return grid


@torch.no_grad()
def update_bitfield(grid: OccupancyGrid) -> OccupancyGrid:
    """Recompute the mean density, the threshold and the cascaded bitfield
    (replaces ``grid.occupancy`` and ``grid.mean_density``)."""
    mean = torch.clamp_min(grid.density, 0.0).mean()
    thresh = torch.clamp_max(mean, NERF_MIN_OPTICAL_THICKNESS / MIN_CONE_STEPSIZE)
    occ = grid.density > thresh
    levels = [occ[0]]
    lo, hi = R // 4, R // 4 + R // 2
    for k in range(1, grid.n_cascades):
        pooled = levels[k - 1].reshape(R // 2, 2, R // 2, 2, R // 2, 2).any(dim=5).any(dim=3).any(dim=1)
        merged = occ[k].clone()
        merged[lo:hi, lo:hi, lo:hi] |= pooled
        levels.append(merged)
    grid.occupancy = torch.stack(levels)
    grid.mean_density = mean
    return grid


def occupancy_at(grid: OccupancyGrid, pos: torch.Tensor, mip: torch.Tensor) -> torch.Tensor:
    """The occupancy bit at warped positions [..., 3] of cascades ``mip`` [...]."""
    cell = coords.cascaded_grid_coords(pos, mip)
    return grid.occupancy[mip.long(), cell[..., 0], cell[..., 1], cell[..., 2]]


def density_at(grid: OccupancyGrid, pos: torch.Tensor, mip: torch.Tensor) -> torch.Tensor:
    """The grid's density at warped positions [..., 3] of cascades ``mip`` [...]."""
    cell = coords.cascaded_grid_coords(pos, mip)
    return grid.density[mip.long(), cell[..., 0], cell[..., 1], cell[..., 2]]


@torch.no_grad()
def mark_untrained_cells(
    n_cascades: int,
    cam_positions: torch.Tensor,  # [n_images, 3]
    cam_forward: torch.Tensor,  # [n_images, 3]
    focal: torch.Tensor,  # [n_images, 2]
    resolution: torch.Tensor,  # [n_images, 2]
) -> torch.Tensor:
    """[C, R, R, R] bool mask of cells seen by at least one training camera:
    the cell centre lies in some camera's field of view, expanded by the
    cell's bounding radius."""
    dev = cam_positions.device
    ix, iy, iz = torch.meshgrid(*(torch.arange(R, device=dev),) * 3, indexing="ij")
    cells = torch.stack([ix, iy, iz], dim=-1).reshape(-1, 3)
    mips = torch.arange(n_cascades, device=dev).repeat_interleave(R**3)
    centers = cell_world_positions(cells.repeat(n_cascades, 1), mips, torch.full((n_cascades * R**3, 3), 0.5, device=dev))
    radius = torch.exp2(mips.to(torch.float32)) * ((3.0**0.5) / (2 * R))
    seen = torch.zeros(centers.shape[0], dtype=torch.bool, device=dev)
    for cam_p, cam_f, f, res in zip(cam_positions, cam_forward, focal, resolution):
        v = centers - cam_p
        z = v @ cam_f
        half_tan = torch.maximum(res[0] / (2 * f[0]), res[1] / (2 * f[1]))
        lateral = torch.linalg.norm(v - z[:, None] * cam_f, dim=-1)
        seen |= (z > -radius) & (lateral <= z * half_tan * 1.2 + radius)
    return seen.reshape(n_cascades, R, R, R)
