"""Scene box, position/direction warps, the cone step size and morton order.

Counterpart of ``nerfshop_tpu/ops/coords.py``: ``BoundingBox``
(``from_aabb_scale``, ``unit``, ``contains``, ``ray_intersect``), the
position, direction and step-size warps and their inverses, the cone step
(``calc_cone_angle``, ``calc_dt``), the DDA step to the next voxel, the
cascade of a position and of a step (``mip_from_pos``, ``mip_from_dt``),
``cascaded_grid_coords`` and the morton helpers, with JAX's arithmetic in
JAX's order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nerfshop_tpu_torch.common import GRID_RESOLUTION, MAX_CONE_STEPSIZE, MIN_CONE_STEPSIZE


class BoundingBox(NamedTuple):
    min: torch.Tensor  # [3]
    max: torch.Tensor  # [3]

    @staticmethod
    def from_aabb_scale(aabb_scale: float, device=None) -> "BoundingBox":
        """Cube of side ``aabb_scale`` centred at 0.5."""
        c = torch.full((3,), 0.5, dtype=torch.float32, device=device)
        h = torch.full((3,), 0.5 * float(aabb_scale), dtype=torch.float32, device=device)
        return BoundingBox(c - h, c + h)

    @staticmethod
    def unit(device=None) -> "BoundingBox":
        """The unit cube [0,1]³."""
        return BoundingBox(torch.zeros(3, device=device), torch.ones(3, device=device))

    @property
    def diag(self) -> torch.Tensor:
        return self.max - self.min

    def relative_pos(self, pos: torch.Tensor) -> torch.Tensor:
        return (pos - self.min) / self.diag

    def contains(self, pos: torch.Tensor) -> torch.Tensor:
        """[..., 3] → [...] bool: inside the box, faces included."""
        return ((pos >= self.min) & (pos <= self.max)).all(dim=-1)

    def ray_intersect(self, origin: torch.Tensor, direction: torch.Tensor):
        """Slab test → (tmin, tmax); tmin > tmax means a miss."""
        inv = 1.0 / torch.where(direction.abs() < 1e-12, torch.full_like(direction, 1e-12), direction)
        t0 = (self.min - origin) * inv
        t1 = (self.max - origin) * inv
        tmin = torch.minimum(t0, t1).amax(dim=-1)
        tmax = torch.maximum(t0, t1).amin(dim=-1)
        return tmin, tmax


def warp_position(pos: torch.Tensor, aabb: BoundingBox) -> torch.Tensor:
    """World → [0,1]³ network-input space."""
    return aabb.relative_pos(pos)


def unwarp_position(pos: torch.Tensor, aabb: BoundingBox) -> torch.Tensor:
    """[0,1]³ network-input space → world."""
    return aabb.min + pos * aabb.diag


def warp_direction(direction: torch.Tensor) -> torch.Tensor:
    return (direction + 1.0) * 0.5


def unwarp_direction(direction: torch.Tensor) -> torch.Tensor:
    return direction * 2.0 - 1.0


def _max_stepsize(n_cascades: int) -> float:
    return MIN_CONE_STEPSIZE * (1 << (n_cascades - 1))


def warp_dt(dt: torch.Tensor, n_cascades: int) -> torch.Tensor:
    """Step size → [0, 1] between the smallest step and the largest of
    ``n_cascades`` cascades."""
    return (dt - MIN_CONE_STEPSIZE) / (_max_stepsize(n_cascades) - MIN_CONE_STEPSIZE)


def unwarp_dt(dt: torch.Tensor, n_cascades: int) -> torch.Tensor:
    return dt * (_max_stepsize(n_cascades) - MIN_CONE_STEPSIZE) + MIN_CONE_STEPSIZE


def calc_cone_angle(cosine: torch.Tensor, focal_y, cone_angle_constant: float) -> torch.Tensor:
    """The pixel-footprint cone angle, at most ``cone_angle_constant``."""
    return torch.clamp_max(cosine / focal_y, cone_angle_constant)


def calc_dt(t: torch.Tensor, cone_angle) -> torch.Tensor:
    return torch.clamp(t * cone_angle, MIN_CONE_STEPSIZE, MAX_CONE_STEPSIZE)


def distance_to_next_voxel(pos: torch.Tensor, direction: torch.Tensor, inv_dir: torch.Tensor, res) -> torch.Tensor:
    """DDA distance from ``pos`` [..., 3] in [0,1]³ to the next voxel
    boundary of a res³ grid, at least 0. ``res`` is a number or a tensor of
    one resolution an element [...] (a cascade's)."""
    per_element = isinstance(res, torch.Tensor) and res.dim() > 0
    p = res[..., None] * pos if per_element else res * pos
    bound = torch.floor(p + 0.5 + 0.5 * torch.sign(direction))
    t = ((bound - p) * inv_dir).amin(dim=-1)
    r = res if per_element else torch.as_tensor(res, dtype=pos.dtype, device=pos.device)
    return torch.clamp_min(t / r, 0.0)


def mip_from_pos(pos: torch.Tensor, n_cascades: int) -> torch.Tensor:
    """Cascade that covers ``pos`` (cascade k spans a cube of side 2^k
    centred at 0.5) → int64."""
    maxval = (pos - 0.5).abs().amax(dim=-1)
    exponent = torch.floor(torch.log2(torch.clamp_min(maxval, 1e-12))).to(torch.int64) + 2
    return torch.clamp(exponent, 0, n_cascades - 1)


def mip_from_dt(dt: torch.Tensor, pos: torch.Tensor, n_cascades: int) -> torch.Tensor:
    """The cascade of ``pos``, coarsened while the step ``dt`` is wider than
    a cell of it → int64 (the march's cell choice)."""
    mip = mip_from_pos(pos, n_cascades)
    d = dt * (2 * GRID_RESOLUTION)
    # frexp's exponent of d (for d ≥ 1): floor(log2(d)) + 1
    expo = torch.floor(torch.log2(torch.clamp_min(d, 1e-12))).to(torch.int64) + 1
    coarse = torch.clamp(torch.maximum(expo, mip), 0, n_cascades - 1)
    return torch.where(d < 1.0, mip, coarse)


def cascaded_grid_coords(pos: torch.Tensor, mip: torch.Tensor) -> torch.Tensor:
    """Positions → integer cell coords (ix, iy, iz) of cascade ``mip``,
    clamped to [0, R − 1]."""
    p = (pos - 0.5) * torch.exp2(-mip.to(pos.dtype))[..., None] + 0.5
    return torch.clamp(torch.floor(p * GRID_RESOLUTION).to(torch.int64), 0, GRID_RESOLUTION - 1)


# --- morton order (the density grid's layout in snapshots) -------------------
# The JAX code works in uint32; torch has no full uint32 arithmetic, so these
# run in int64 and mask to 32 bits where a shift could carry past them.


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.int64) & 0x000003FF
    x = (x ^ (x << 16)) & 0xFF0000FF
    x = (x ^ (x << 8)) & 0x0300F00F
    x = (x ^ (x << 4)) & 0x030C30C3
    x = (x ^ (x << 2)) & 0x09249249
    return x


def _compact1by2(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.int64) & 0x09249249
    x = (x ^ (x >> 2)) & 0x030C30C3
    x = (x ^ (x >> 4)) & 0x0300F00F
    x = (x ^ (x >> 8)) & 0xFF0000FF
    x = (x ^ (x >> 16)) & 0x000003FF
    return x


def morton3d(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Interleave the low 10 bits of x, y, z (x in bit 0) → int64 codes."""
    return (_part1by2(z) << 2) | (_part1by2(y) << 1) | _part1by2(x)


def morton3d_invert(code: torch.Tensor):
    code = code.to(torch.int64) & 0xFFFFFFFF
    return _compact1by2(code), _compact1by2(code >> 1), _compact1by2(code >> 2)


def morton_to_dense_grid(flat_mip: torch.Tensor) -> torch.Tensor:
    """[R³] morton-ordered values → dense [R, R, R] (index order x, y, z)."""
    r = GRID_RESOLUTION
    x, y, z = morton3d_invert(torch.arange(r**3, device=flat_mip.device))
    dense = torch.zeros((r, r, r), dtype=flat_mip.dtype, device=flat_mip.device)
    dense[x, y, z] = flat_mip
    return dense


def dense_grid_to_morton(dense: torch.Tensor) -> torch.Tensor:
    """Dense [R, R, R] → [R³] in morton order."""
    x, y, z = morton3d_invert(torch.arange(GRID_RESOLUTION**3, device=dense.device))
    return dense[x, y, z]
