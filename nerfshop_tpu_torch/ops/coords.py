"""Scene box, position/direction warps and the cone step size.

Counterpart of the parts of ``nerfshop_tpu/ops/coords.py`` that training
uses: ``BoundingBox`` (``from_aabb_scale``, ``ray_intersect``),
``warp_position``, ``warp_direction`` and ``calc_dt``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nerfshop_tpu.common import MAX_CONE_STEPSIZE, MIN_CONE_STEPSIZE


class BoundingBox(NamedTuple):
    min: torch.Tensor  # [3]
    max: torch.Tensor  # [3]

    @staticmethod
    def from_aabb_scale(aabb_scale: float, device=None) -> "BoundingBox":
        """Cube of side ``aabb_scale`` centred at 0.5."""
        c = torch.full((3,), 0.5, dtype=torch.float32, device=device)
        h = torch.full((3,), 0.5 * float(aabb_scale), dtype=torch.float32, device=device)
        return BoundingBox(c - h, c + h)

    @property
    def diag(self) -> torch.Tensor:
        return self.max - self.min

    def relative_pos(self, pos: torch.Tensor) -> torch.Tensor:
        return (pos - self.min) / self.diag

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


def warp_direction(direction: torch.Tensor) -> torch.Tensor:
    return (direction + 1.0) * 0.5


def calc_dt(t: torch.Tensor, cone_angle) -> torch.Tensor:
    return torch.clamp(t * cone_angle, MIN_CONE_STEPSIZE, MAX_CONE_STEPSIZE)
