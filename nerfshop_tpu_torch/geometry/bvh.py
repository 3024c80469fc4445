"""Signed distance to a closed triangle mesh, on the device.

Counterpart of ``nerfshop_tpu/geometry/bvh.py``: the host build of the
triangle BVH (:func:`build_bvh`: median split over centroids, leaves of
``LEAF_SIZE`` triangles padded with a sentinel triangle, angle-weighted
vertex pseudo-normals and edge pseudo-normals) and ``signed_distance``
with the same closest-point routine and the same pseudo-normal sign rule.

:func:`signed_distance` takes either a :class:`BvhArrays` or a
:class:`TriangleSet`. On a CUDA tensor a BVH is walked by kernel G
(``csrc/bvh.cu``, one thread a point, the JAX traversal order); on a CPU
tensor, and for a bare triangle set on any device, every point is tested
against every triangle (:func:`signed_distance_plain`, G's plain version),
in chunks of points. The brute force suits the cages the editing path
queries (at most ~10³ faces, no tree to build); the SDF testbed's meshes
(~10⁵ faces) need the BVH.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Union

import numpy as np
import torch

from nerfshop_tpu_torch import kernels

LEAF_SIZE = 4
MAX_STACK = 64
_FAR = 1e8

#: point × triangle pairs per chunk of :func:`signed_distance_plain`
PAIRS_PER_CHUNK = 1 << 20


class TriangleSet(NamedTuple):
    """Per-triangle arrays on one device."""

    tri_a: torch.Tensor  # [F, 3] corner 0
    tri_ab: torch.Tensor  # [F, 3] edge vectors
    tri_ac: torch.Tensor
    tri_pseudo_v: torch.Tensor  # [F, 3, 3] per-corner (vertex) pseudo-normals
    tri_pseudo_e: torch.Tensor  # [F, 3, 3] per-edge pseudo-normals (ab, bc, ca)
    tri_n: torch.Tensor  # [F, 3] face normals


class BvhArrays(NamedTuple):
    """The BVH of JAX ``build_bvh`` on one device; the triangle arrays have
    a sentinel triangle at index F (far away, zero edges)."""

    node_min: torch.Tensor  # [Nn, 3]
    node_max: torch.Tensor  # [Nn, 3]
    node_left: torch.Tensor  # [Nn] int32 left child (right = left + 1), -1 for a leaf
    node_leaf: torch.Tensor  # [Nn] int32 leaf slot, -1 for an inner node
    leaf_tris: torch.Tensor  # [Lf, LEAF_SIZE] int32 triangle indices, padded with F
    tri_a: torch.Tensor  # [F + 1, 3]
    tri_ab: torch.Tensor  # [F + 1, 3]
    tri_ac: torch.Tensor  # [F + 1, 3]
    tri_pseudo_v: torch.Tensor  # [F + 1, 3, 3]
    tri_pseudo_e: torch.Tensor  # [F + 1, 3, 3]
    tri_n: torch.Tensor  # [F + 1, 3]

    def triangles(self) -> TriangleSet:
        """The F real triangles (views without the sentinel)."""
        return TriangleSet(*(getattr(self, k)[:-1] for k in TriangleSet._fields))


def _triangle_arrays(vertices: np.ndarray, faces: np.ndarray):
    """(tris [F, 3, 3], unit face normals [F, 3], vertex pseudo-normals at
    the corners [F, 3, 3], edge pseudo-normals [F, 3, 3]), host numpy, the
    arithmetic of JAX ``build_bvh``."""
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
    edge_unit = {key: n / (np.linalg.norm(n) + 1e-20) for key, n in edge_n.items()}
    en = np.zeros((len(f), 3, 3), np.float32)
    for ti in range(len(f)):
        for k in range(3):
            en[ti, k] = edge_unit[tuple(sorted((int(f[ti, k]), int(f[ti, (k + 1) % 3]))))]
    return tris, fn_unit, vn[f], en


def _tensor(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    return torch.as_tensor(a.astype(np.int32) if a.dtype.kind == "i" else a.astype(np.float32), device=device)


def build_triangles(vertices: np.ndarray, faces: np.ndarray, device: torch.device) -> TriangleSet:
    """The per-triangle arrays of JAX ``build_bvh`` without the tree or the
    sentinel (host numpy, then copied to ``device``)."""
    tris, fn_unit, pv, en = _triangle_arrays(vertices, faces)
    arrs = (tris[:, 0], tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0], pv, en, fn_unit)
    return TriangleSet(*(_tensor(a, device) for a in arrs))


def build_bvh_arrays(vertices: np.ndarray, faces: np.ndarray) -> dict:
    """JAX ``build_bvh``'s arrays as host numpy, by field name of
    :class:`BvhArrays`: the same median split, leaf padding and sentinel."""
    f = np.asarray(faces, np.int64)
    tris, fn_unit, pv, en = _triangle_arrays(vertices, faces)
    cent = tris.mean(1)
    tmin = tris.min(1)
    tmax = tris.max(1)

    node_min, node_max, node_left, node_leaf = [], [], [], []
    leaves = []

    def new_node():
        node_min.append(np.zeros(3, np.float32))
        node_max.append(np.zeros(3, np.float32))
        node_left.append(-1)
        node_leaf.append(-1)
        return len(node_left) - 1

    root = new_node()
    work = [(root, np.arange(len(f)))]
    while work:
        ni, idx = work.pop()
        node_min[ni] = tmin[idx].min(0)
        node_max[ni] = tmax[idx].max(0)
        if len(idx) <= LEAF_SIZE:
            slot = np.full(LEAF_SIZE, len(f), np.int64)  # sentinel pad
            slot[: len(idx)] = idx
            node_leaf[ni] = len(leaves)
            leaves.append(slot)
            continue
        axis = int(np.argmax(node_max[ni] - node_min[ni]))
        order = np.argsort(cent[idx, axis], kind="stable")
        half = len(idx) // 2
        li = new_node()
        ri = new_node()
        node_left[ni] = li
        work.append((li, idx[order[:half]]))
        work.append((ri, idx[order[half:]]))

    pad1 = np.zeros((1, 3, 3), np.float32)
    return dict(
        node_min=np.stack(node_min),
        node_max=np.stack(node_max),
        node_left=np.asarray(node_left, np.int32),
        node_leaf=np.asarray(node_leaf, np.int32),
        leaf_tris=np.stack(leaves).astype(np.int32),
        tri_a=np.concatenate([tris[:, 0], np.full((1, 3), _FAR, np.float32)]),
        tri_ab=np.concatenate([tris[:, 1] - tris[:, 0], np.zeros((1, 3), np.float32)]),
        tri_ac=np.concatenate([tris[:, 2] - tris[:, 0], np.zeros((1, 3), np.float32)]),
        tri_pseudo_v=np.concatenate([pv, pad1]),
        tri_pseudo_e=np.concatenate([en, pad1]),
        tri_n=np.concatenate([fn_unit, np.zeros((1, 3), np.float32)]),
    )


def build_bvh(vertices: np.ndarray, faces: np.ndarray, device: torch.device) -> BvhArrays:
    """Median-split build on the host, then copied to ``device``."""
    arrs = build_bvh_arrays(vertices, faces)
    return BvhArrays(**{k: _tensor(a, device) for k, a in arrs.items()})


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


def signed_distance_plain(tris: TriangleSet, points: torch.Tensor) -> torch.Tensor:
    """points [N, 3] on ``tris``' device → signed distance [N] (negative
    inside): the closest triangle over all triangles (the first in index
    order on a tie), signed by the pseudo-normal of its closest feature.
    Kernel G's plain version."""
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


@kernels.counted("launches")
def bvh_signed_distance_cuda(bvh: BvhArrays, points: torch.Tensor) -> torch.Tensor:
    """Kernel G: points [N, 3] f32 → signed distance [N] f32, one thread a
    point walking the BVH. Raises on anything but contiguous f32 points and
    a BVH on the points' CUDA device."""
    dev = points.device
    if dev.type != "cuda":
        raise ValueError(f"bvh kernel: points on {dev}, expected a CUDA device")
    N = points.shape[0]
    kernels.require(points, "points", torch.float32, (N, 3), dev)
    Nn, Fp = bvh.node_min.shape[0], bvh.tri_a.shape[0]
    for name, dtype, shape in (
        ("node_min", torch.float32, (Nn, 3)), ("node_max", torch.float32, (Nn, 3)),
        ("node_left", torch.int32, (Nn,)), ("node_leaf", torch.int32, (Nn,)),
        ("leaf_tris", torch.int32, (bvh.leaf_tris.shape[0], LEAF_SIZE)),
        ("tri_a", torch.float32, (Fp, 3)), ("tri_ab", torch.float32, (Fp, 3)), ("tri_ac", torch.float32, (Fp, 3)),
        ("tri_pseudo_v", torch.float32, (Fp, 3, 3)), ("tri_pseudo_e", torch.float32, (Fp, 3, 3)),
        ("tri_n", torch.float32, (Fp, 3)),
    ):
        kernels.require(getattr(bvh, name), name, dtype, shape, dev)
    out = torch.empty((N,), dtype=torch.float32, device=dev)
    args = kernels.BvhArgs(*(getattr(bvh, k).data_ptr() for k in BvhArrays._fields))
    err = kernels.load().nst_bvh_sdf(ctypes.byref(args), points.data_ptr(), out.data_ptr(), N, kernels.stream_ptr(dev))
    kernels.check(err, "bvh_signed_distance")
    bvh_signed_distance_cuda.launches += 1
    return out


def signed_distance(mesh: Union[BvhArrays, TriangleSet], points: torch.Tensor) -> torch.Tensor:
    """points [N, 3] → signed distance [N] (negative inside). A BVH on CUDA
    tensors launches kernel G or raises; CPU tensors, and a bare
    :class:`TriangleSet` on any device, take :func:`signed_distance_plain`."""
    if not isinstance(mesh, BvhArrays):
        return signed_distance_plain(mesh, points)
    if points.device.type == "cpu":
        return signed_distance_plain(mesh.triangles(), points)
    if points.device.type != "cuda":
        raise ValueError(f"signed_distance: unsupported device {points.device}")
    return bvh_signed_distance_cuda(mesh, points.contiguous())
