"""TriangleOctree: the occupancy of a triangle mesh's surface at every
depth of an octree over [0, 1]³, on the host.

Counterpart of ``nerfshop_tpu/geometry/triangle_octree.py`` (numpy and
scipy, as there, so its levels equal JAX's bool for bool): the surface is
sampled on barycentric grids at half a cell's spacing, the cells it touches
at ``min(depth, max_dense_depth)`` (256³ at the default 8) are marked and
dilated by one cell, and each coarser level is the any-reduction of the
next. Depths past the dense pyramid read its finest level, a conservative
ancestor mask. The Takikawa encoding (``models/encodings.py``) copies the
levels it reads to the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np


def _surface_samples(vertices: np.ndarray, faces: np.ndarray, spacing: float) -> np.ndarray:
    """Points covering the mesh surface at ~``spacing`` density (barycentric
    grids per triangle; the voxelization oracle)."""
    v0 = vertices[faces[:, 0]]
    v1 = vertices[faces[:, 1]]
    v2 = vertices[faces[:, 2]]
    e1 = v1 - v0
    e2 = v2 - v0
    area2 = np.linalg.norm(np.cross(e1, e2), axis=1)
    # subdivision count per triangle from its longest edge
    longest = np.maximum(
        np.linalg.norm(e1, axis=1),
        np.maximum(np.linalg.norm(e2, axis=1), np.linalg.norm(v2 - v1, axis=1)),
    )
    out = [v0, v1, v2]
    n_sub = np.clip(np.ceil(longest / max(spacing, 1e-9)).astype(int), 1, 64)
    for n in np.unique(n_sub):
        tri = n_sub == n
        if n == 1:
            out.append((v0[tri] + v1[tri] + v2[tri]) / 3)
            continue
        a = np.linspace(0, 1, n + 1)
        bu, bv = np.meshgrid(a, a)
        keep = (bu + bv) <= 1.0 + 1e-9
        bu, bv = bu[keep], bv[keep]
        pts = (
            v0[tri][:, None, :]
            + e1[tri][:, None, :] * bu[None, :, None]
            + e2[tri][:, None, :] * bv[None, :, None]
        )
        out.append(pts.reshape(-1, 3))
    return np.concatenate(out, axis=0)


@dataclass
class TriangleOctree:
    """Per-depth dense occupancy over [0,1]³ (levels[d] has shape (2^d,)*3)."""

    depth: int
    levels: List[np.ndarray] = field(default_factory=list)
    max_dense_depth: int = 8

    @property
    def n_vertices(self) -> int:
        return int(sum(l.sum() for l in self.levels))

    @staticmethod
    def build(vertices: np.ndarray, faces: np.ndarray, depth: int, max_dense_depth: int = 8) -> "TriangleOctree":
        """Mesh (in [0,1]³) → occupancy pyramid up to ``depth``."""
        vertices = np.asarray(vertices, np.float32)
        faces = np.asarray(faces, np.int64)
        d_eff = min(depth, max_dense_depth)
        res = 1 << d_eff
        pts = _surface_samples(vertices, faces, 0.5 / res)
        cells = np.clip((pts * res).astype(np.int64), 0, res - 1)
        fine = np.zeros((res, res, res), bool)
        fine[cells[:, 0], cells[:, 1], cells[:, 2]] = True
        # dilate one cell so corner interpolation at the surface has support
        from scipy import ndimage

        fine = ndimage.binary_dilation(fine, iterations=1)

        levels: List[np.ndarray] = [None] * (d_eff + 1)
        levels[d_eff] = fine
        for d in range(d_eff - 1, -1, -1):
            r = 1 << d
            levels[d] = (
                levels[d + 1].reshape(r, 2, r, 2, r, 2).any(axis=(1, 3, 5))
            )
        return TriangleOctree(depth=depth, levels=levels, max_dense_depth=max_dense_depth)

    def occupancy_at_depth(self, d: int) -> np.ndarray:
        """Dense occupancy usable for depth ``d`` (conservative ancestor mask
        for d beyond the dense pyramid)."""
        return self.levels[min(d, len(self.levels) - 1)]

    def contains(self, points: np.ndarray, d: int) -> np.ndarray:
        occ = self.occupancy_at_depth(d)
        r = occ.shape[0]
        c = np.clip((np.asarray(points) * r).astype(np.int64), 0, r - 1)
        return occ[c[..., 0], c[..., 1], c[..., 2]]
