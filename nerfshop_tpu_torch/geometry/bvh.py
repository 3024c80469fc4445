"""Signed distance to a closed triangle mesh, on the device.

Counterpart of ``nerfshop_tpu/geometry/bvh.py``: the per-triangle arrays of
``build_bvh`` (corner, edges, face normal, angle-weighted vertex
pseudo-normals, edge pseudo-normals) and ``signed_distance`` with the same
closest-point routine and the same pseudo-normal sign rule. The JAX package
walks a BVH per point; here every point is tested against every triangle,
in chunks of points, which computes the same function and suits the cages
the editing path queries (at most ~10³ faces). The BVH traversal comes with
the SDF testbed.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

#: point × triangle pairs per chunk of :func:`signed_distance`
PAIRS_PER_CHUNK = 1 << 20


class TriangleSet(NamedTuple):
    """Per-triangle arrays on one device."""

    tri_a: torch.Tensor  # [F, 3] corner 0
    tri_ab: torch.Tensor  # [F, 3] edge vectors
    tri_ac: torch.Tensor
    tri_pseudo_v: torch.Tensor  # [F, 3, 3] per-corner (vertex) pseudo-normals
    tri_pseudo_e: torch.Tensor  # [F, 3, 3] per-edge pseudo-normals (ab, bc, ca)
    tri_n: torch.Tensor  # [F, 3] face normals


def build_triangles(vertices: np.ndarray, faces: np.ndarray, device: torch.device) -> TriangleSet:
    """The per-triangle arrays of JAX ``build_bvh`` (host numpy, then copied
    to ``device``)."""
    v = np.asarray(vertices, np.float32)
    f = np.asarray(faces, np.int64)
    tris = v[f]  # [F, 3, 3]
    fn = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    fn_unit = fn / (np.linalg.norm(fn, axis=-1, keepdims=True) + 1e-20)

    # angle-weighted vertex pseudo-normals
    vn = np.zeros_like(v)
    for k in range(3):
        e1 = v[f[:, (k + 1) % 3]] - v[f[:, k]]
        e2 = v[f[:, (k + 2) % 3]] - v[f[:, k]]
        cosang = np.einsum("ij,ij->i", e1, e2) / (np.linalg.norm(e1, axis=-1) * np.linalg.norm(e2, axis=-1) + 1e-20)
        ang = np.arccos(np.clip(cosang, -1, 1))
        np.add.at(vn, f[:, k], fn_unit * ang[:, None])
    vn /= np.linalg.norm(vn, axis=-1, keepdims=True) + 1e-20

    # edge pseudo-normals: sum of the (≤ 2) adjacent face normals
    edge_n = {}
    for ti in range(len(f)):
        for k in range(3):
            key = tuple(sorted((int(f[ti, k]), int(f[ti, (k + 1) % 3]))))
            edge_n[key] = edge_n.get(key, 0) + fn_unit[ti]
    en = np.zeros((len(f), 3, 3), np.float32)
    for ti in range(len(f)):
        for k in range(3):
            n = edge_n[tuple(sorted((int(f[ti, k]), int(f[ti, (k + 1) % 3]))))]
            en[ti, k] = n / (np.linalg.norm(n) + 1e-20)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)

    return TriangleSet(
        tri_a=t(tris[:, 0]),
        tri_ab=t(tris[:, 1] - tris[:, 0]),
        tri_ac=t(tris[:, 2] - tris[:, 0]),
        tri_pseudo_v=t(vn[f]),
        tri_pseudo_e=t(en),
        tri_n=t(fn_unit),
    )


def closest_point_tri(p, a, ab, ac):
    """Ericson closest point on a triangle, broadcast over leading dims.
    → (point, region): 0 face, 1-3 vertex a/b/c, 4-6 edge ab/bc/ca."""

    def dot(x, y):
        return (x * y).sum(-1)

    ap = p - a
    d1, d2 = dot(ab, ap), dot(ac, ap)
    bp = p - (a + ab)
    d3, d4 = dot(ab, bp), dot(ac, bp)
    cp = p - (a + ac)
    d5, d6 = dot(ab, cp), dot(ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = va + vb + vc
    denom = torch.where(denom.abs() < 1e-30, torch.full_like(denom, 1e-30), denom)
    v = vb / denom
    w = vc / denom
    pt = a + v[..., None] * ab + w[..., None] * ac

    reg_a = (d1 <= 0) & (d2 <= 0)
    reg_b = (d3 >= 0) & (d4 <= d3)
    reg_c = (d6 >= 0) & (d5 <= d6)
    reg_ab = ~reg_a & ~reg_b & (d1 * d4 - d3 * d2 <= 0) & (d1 >= 0) & (d3 <= 0)
    t_ab = d1 / torch.clamp_min(d1 - d3, 1e-30)
    reg_bc = ~reg_b & ~reg_c & (d3 * d6 - d5 * d4 <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
    t_bc = (d4 - d3) / torch.clamp_min((d4 - d3) + (d5 - d6), 1e-30)
    reg_ca = ~reg_c & ~reg_a & (d5 * d2 - d1 * d6 <= 0) & (d2 >= 0) & (d6 <= 0)
    t_ca = d2 / torch.clamp_min(d2 - d6, 1e-30)

    reg = torch.zeros(pt.shape[:-1], dtype=torch.int64, device=pt.device)
    # later cases win, in the JAX order: ca, bc, ab, c, b, a
    for mask, val, code in (
        (reg_ca, a + t_ca[..., None] * ac, 6),
        (reg_bc, a + ab + t_bc[..., None] * (ac - ab), 5),
        (reg_ab, a + t_ab[..., None] * ab, 4),
        (reg_c, (a + ac).expand_as(pt), 3),
        (reg_b, (a + ab).expand_as(pt), 2),
        (reg_a, a.expand_as(pt), 1),
    ):
        pt = torch.where(mask[..., None], val, pt)
        reg = torch.where(mask, torch.full_like(reg, code), reg)
    return pt, reg


def signed_distance(tris: TriangleSet, points: torch.Tensor) -> torch.Tensor:
    """points [N, 3] on ``tris``' device → signed distance [N] (negative
    inside): the closest triangle over all triangles (the first in index
    order on a tie), signed by the pseudo-normal of its closest feature."""
    F = tris.tri_a.shape[0]
    step = max(1, PAIRS_PER_CHUNK // max(F, 1))
    out = []
    for i in range(0, points.shape[0], step):
        p = points[i : i + step]
        pt, _ = closest_point_tri(p[:, None, :], tris.tri_a[None], tris.tri_ab[None], tris.tri_ac[None])
        d2 = ((pt - p[:, None, :]) ** 2).sum(-1)  # [P, F]
        best_d2, best = d2.min(dim=1)
        best_pt, reg = closest_point_tri(p, tris.tri_a[best], tris.tri_ab[best], tris.tri_ac[best])
        normals = torch.cat(
            [tris.tri_n[best][:, None], tris.tri_pseudo_v[best], tris.tri_pseudo_e[best]], dim=1
        )  # [P, 7, 3] in region-code order
        normal = normals[torch.arange(p.shape[0], device=p.device), reg]
        sign = torch.where(((p - best_pt) * normal).sum(-1) >= 0, 1.0, -1.0)
        out.append(sign * torch.sqrt(best_d2))
    return torch.cat(out) if out else points.new_zeros((0,))
