"""Signed distance to a closed triangle mesh and the nearest ray hit, on
the device.

Counterpart of ``nerfshop_tpu/geometry/bvh.py``: the host build of the
triangle BVH (:func:`build_bvh`: median split over centroids, leaves of
``LEAF_SIZE`` triangles padded with a sentinel triangle, angle-weighted
vertex pseudo-normals and edge pseudo-normals), ``signed_distance`` with
the same closest-point routine and the same pseudo-normal sign rule, and
``ray_intersect`` with the same slab test and Möller–Trumbore arithmetic.

:func:`signed_distance` takes a :class:`PackedBvh`, a :class:`BvhArrays`
or a :class:`TriangleSet`. On a CUDA tensor a BVH is walked by kernel G
(``csrc/bvh.cu``: the layout of :func:`pack_bvh`, the JAX traversal
order); a :class:`BvhArrays` is packed for that call, so a caller that
queries one mesh often keeps its :class:`PackedBvh`. On a CPU tensor, and for a bare triangle set on any
device, every point is tested against every triangle
(:func:`signed_distance_plain`, G's plain version), in chunks of points.
The brute force suits the cages the editing path queries (at most ~10³
faces, no tree to build); the SDF testbed's meshes (~10⁵ faces) need the
BVH. :func:`ray_intersect` dispatches the same way: kernel N
(``csrc/bvh.cu``, the same packed layout, so a mesh packed once serves
both kernels) or :func:`ray_intersect_plain`, every ray against every
triangle.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Union

import numpy as np
import torch

from nerfshop_tpu_torch import kernels

LEAF_SIZE = 4
#: the deepest tree kernel G walks: its stack holds one entry a level below
#: the root (a median split of F < 2^31 triangles is at most 30 deep)
MAX_DEPTH = 33
_FAR = 1e8

#: point × triangle pairs per chunk of :func:`signed_distance_plain` and
#: :func:`ray_intersect_plain`
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


class PackedBvh(NamedTuple):
    """A :class:`BvhArrays` in kernel G's layout (:func:`pack_bvh`), on its
    device."""

    nodes: torch.Tensor  # [Ni, 16] f32 a record per inner node: both children's boxes, then their links' int32 bits
    tris: torch.Tensor  # [F, 12] f32 per triangle in leaf order: a, its index's int32 bits, ab, 0, ac, 0
    depth: int  # levels of the tree (a root leaf: 1)
    bvh: BvhArrays  # what was packed: the sign's pseudo-normals, and the plain version's triangles


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


def pack_bvh(bvh: BvhArrays) -> PackedBvh:
    """Kernel G's layout of ``bvh``, built once a mesh (vectorised numpy on
    the host, a loop over levels only, then copied to ``bvh``'s device):

    - a record per inner node, in node order (the root first), holding its
      children's boxes and links: an inner child's record index, or for a
      leaf ``~((start << 2) | (count - 1))``, its range of packed triangles.
      A root leaf (F ≤ LEAF_SIZE) gets one record beside an empty box;
    - the real triangles of every leaf, in leaf order and within a leaf in
      slot order, the sentinel padding dropped.

    Raises ``ValueError`` naming kernel G on an empty mesh, on a tree deeper
    than :data:`MAX_DEPTH`, and on leaves it cannot link."""
    f32 = lambda t: t.detach().cpu().numpy().astype(np.float32)  # noqa: E731
    node_min, node_max = f32(bvh.node_min), f32(bvh.node_max)
    node_left = bvh.node_left.cpu().numpy().astype(np.int64)
    node_leaf = bvh.node_leaf.cpu().numpy().astype(np.int64)
    leaf_tris = bvh.leaf_tris.cpu().numpy().astype(np.int64)
    F = bvh.tri_a.shape[0] - 1
    if F <= 0:
        raise ValueError("kernel G: the mesh has no triangle")
    if F >= 1 << 29:
        raise ValueError(f"kernel G: {F} triangles, its leaf links take fewer than 2^29")

    inner = node_left >= 0
    depth, level = 0, np.zeros(1, np.int64)
    while level.size:
        depth += 1
        if depth > MAX_DEPTH:
            raise ValueError(f"kernel G: the BVH is deeper than {MAX_DEPTH} levels, the most its stack holds")
        kids = node_left[level[inner[level]]]
        level = np.concatenate([kids, kids + 1])

    real = leaf_tris != F
    counts = real.sum(1)
    if (real[:, 1:] & ~real[:, :-1]).any() or (counts == 0).any():
        raise ValueError("kernel G: every leaf must list its triangles before its sentinel padding")
    starts = np.cumsum(counts) - counts
    order = leaf_tris[real]  # leaf order, then slot order

    rank = np.cumsum(inner) - 1  # the record of each inner node

    def link(child):
        leaf = node_leaf[child]
        return np.where(inner[child], rank[child], ~((starts[leaf] << 2) | (counts[leaf] - 1)))

    if inner[0]:
        left = node_left[inner]
        right = left + 1
        boxes = [node_min[left], node_max[left], node_min[right], node_max[right]]
        links = [link(left), link(right)]
    else:  # a root leaf beside an empty box, which no point is nearer than
        far = np.full((1, 3), np.inf, np.float32)
        boxes = [node_min[:1], node_max[:1], far, -far]
        links = [link(np.zeros(1, np.int64)), np.full(1, ~0, np.int64)]
    nodes = np.zeros((boxes[0].shape[0], 16), np.float32)
    nodes[:, :12] = np.concatenate(boxes, 1)
    nodes.view(np.int32)[:, 12:14] = np.stack(links, 1)

    tris = np.zeros((len(order), 12), np.float32)
    tris[:, 0:3] = f32(bvh.tri_a)[order]
    tris.view(np.int32)[:, 3] = order
    tris[:, 4:7] = f32(bvh.tri_ab)[order]
    tris[:, 8:11] = f32(bvh.tri_ac)[order]

    dev = bvh.tri_a.device
    return PackedBvh(_tensor(nodes, dev), _tensor(tris, dev), depth, bvh)


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
def bvh_signed_distance_cuda(packed: PackedBvh, points: torch.Tensor) -> torch.Tensor:
    """Kernel G: points [N, 3] f32 → signed distance [N] f32, four lanes a
    point walking ``packed``. Raises on anything but a :class:`PackedBvh`
    (so a BVH is never repacked a launch), contiguous f32 points and a
    BVH on the points' CUDA device."""
    if not isinstance(packed, PackedBvh):
        raise TypeError(f"kernel G walks a PackedBvh (pack_bvh), got {type(packed).__name__}")
    dev = points.device
    if dev.type != "cuda":
        raise ValueError(f"bvh kernel: points on {dev}, expected a CUDA device")
    N = points.shape[0]
    kernels.require(points, "points", torch.float32, (N, 3), dev)
    Fp = packed.bvh.tri_a.shape[0]
    for name, t, shape in (
        ("nodes", packed.nodes, (packed.nodes.shape[0], 16)), ("tris", packed.tris, (Fp - 1, 12)),
        ("tri_pseudo_v", packed.bvh.tri_pseudo_v, (Fp, 3, 3)),
        ("tri_pseudo_e", packed.bvh.tri_pseudo_e, (Fp, 3, 3)), ("tri_n", packed.bvh.tri_n, (Fp, 3)),
    ):
        kernels.require(t, name, torch.float32, shape, dev)
    out = torch.empty((N,), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    args = kernels.BvhArgs(*(t.data_ptr() for t in (packed.nodes, packed.tris, packed.bvh.tri_pseudo_v,
                                                     packed.bvh.tri_pseudo_e, packed.bvh.tri_n)))
    err = kernels.load().nst_bvh_sdf(ctypes.byref(args), points.data_ptr(), out.data_ptr(), N, kernels.stream_ptr(dev))
    kernels.check(err, "bvh_signed_distance")
    bvh_signed_distance_cuda.launches += 1
    return out


def signed_distance(mesh: Union[PackedBvh, BvhArrays, TriangleSet], points: torch.Tensor) -> torch.Tensor:
    """points [N, 3] → signed distance [N] (negative inside). A BVH on CUDA
    tensors launches kernel G or raises; CPU tensors, and a bare
    :class:`TriangleSet` on any device, take :func:`signed_distance_plain`."""
    if isinstance(mesh, TriangleSet):
        return signed_distance_plain(mesh, points)
    if points.device.type == "cpu":
        return signed_distance_plain((mesh.bvh if isinstance(mesh, PackedBvh) else mesh).triangles(), points)
    if points.device.type != "cuda":
        raise ValueError(f"signed_distance: unsupported device {points.device}")
    packed = mesh if isinstance(mesh, PackedBvh) else pack_bvh(mesh)
    return bvh_signed_distance_cuda(packed, points.contiguous())


# ------------------------------------------------------- nearest ray hit


def _cross(a, b):
    """JAX's ``jnp.cross`` of [..., 3] vectors, component by component."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1], a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def ray_triangle_t(origins, directions, a, ab, ac) -> torch.Tensor:
    """Möller–Trumbore in JAX ``ray_intersect``'s arithmetic, broadcast over
    leading dims → the hit distance, or ``_FAR`` where the ray misses the
    triangle (barycentrics outside [0, 1], t ≤ 1e-6 or t ≥ ``_FAR``)."""
    d = torch.broadcast_to(directions, torch.broadcast_shapes(directions.shape, ab.shape))
    pvec = _cross(d, ac)
    det = (ab * pvec).sum(-1)
    inv_det = 1.0 / torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    tvec = origins - a
    u = (tvec * pvec).sum(-1) * inv_det
    qvec = _cross(tvec, ab)
    v = (d * qvec).sum(-1) * inv_det
    t = (ac * qvec).sum(-1) * inv_det
    ok = (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-6) & (t < _FAR)
    return torch.where(ok, t, torch.full_like(t, _FAR))


def ray_intersect_plain(tris: TriangleSet, origins: torch.Tensor, directions: torch.Tensor):
    """origins, directions [N, 3] on ``tris``' device → (t [N] f32, ``_FAR``
    on a miss; tri [N] int32, −1 on a miss): every triangle against a chunk
    of rays, the nearest hit, the lowest triangle index on a tie. Kernel
    N's plain version."""
    F, N, dev = tris.tri_a.shape[0], origins.shape[0], origins.device
    t_out = torch.full((N,), _FAR, dtype=torch.float32, device=dev)
    tri_out = torch.full((N,), -1, dtype=torch.int32, device=dev)
    if F == 0:
        return t_out, tri_out
    step = max(1, PAIRS_PER_CHUNK // F)
    index = torch.arange(F, device=dev)
    for i in range(0, N, step):
        t = ray_triangle_t(origins[i : i + step, None], directions[i : i + step, None], tris.tri_a[None],
                           tris.tri_ab[None], tris.tri_ac[None])  # [R, F]
        best = t.amin(dim=1)
        first = torch.where(t == best[:, None], index, F).amin(dim=1)
        hit = best < _FAR
        t_out[i : i + step] = best
        tri_out[i : i + step] = torch.where(hit, first, -1).to(torch.int32)
    return t_out, tri_out


@kernels.counted("launches")
def bvh_ray_intersect_cuda(packed: PackedBvh, origins: torch.Tensor, directions: torch.Tensor):
    """Kernel N: origins, directions [N, 3] f32 → (t [N] f32, tri [N]
    int32), the nearest hit through ``packed``. Raises on anything but a
    :class:`PackedBvh`, contiguous f32 rays and a BVH on their CUDA device."""
    if not isinstance(packed, PackedBvh):
        raise TypeError(f"kernel N walks a PackedBvh (pack_bvh), got {type(packed).__name__}")
    dev = origins.device
    if dev.type != "cuda":
        raise ValueError(f"bvh ray kernel: rays on {dev}, expected a CUDA device")
    N = origins.shape[0]
    kernels.require(origins, "origins", torch.float32, (N, 3), dev)
    kernels.require(directions, "directions", torch.float32, (N, 3), dev)
    kernels.require(packed.nodes, "nodes", torch.float32, (packed.nodes.shape[0], 16), dev)
    kernels.require(packed.tris, "tris", torch.float32, (packed.bvh.tri_a.shape[0] - 1, 12), dev)
    t = torch.empty((N,), dtype=torch.float32, device=dev)
    tri = torch.empty((N,), dtype=torch.int32, device=dev)
    if N == 0:
        return t, tri
    args = kernels.BvhArgs(*(t_.data_ptr() for t_ in (packed.nodes, packed.tris, packed.bvh.tri_pseudo_v,
                                                       packed.bvh.tri_pseudo_e, packed.bvh.tri_n)))
    err = kernels.load().nst_bvh_ray(ctypes.byref(args), origins.data_ptr(), directions.data_ptr(), t.data_ptr(),
                                     tri.data_ptr(), N, kernels.stream_ptr(dev))
    kernels.check(err, "bvh_ray_intersect")
    bvh_ray_intersect_cuda.launches += 1
    return t, tri


def ray_intersect(mesh: Union[PackedBvh, BvhArrays, TriangleSet], origins: torch.Tensor, directions: torch.Tensor):
    """Nearest hit of rays [N, 3] → (t [N], ``_FAR`` on a miss; tri [N]
    int32, −1 on a miss). A BVH on CUDA tensors launches kernel N or raises;
    CPU tensors, and a bare :class:`TriangleSet` on any device, take
    :func:`ray_intersect_plain`."""
    if isinstance(mesh, TriangleSet):
        return ray_intersect_plain(mesh, origins, directions)
    if origins.device.type == "cpu":
        return ray_intersect_plain((mesh.bvh if isinstance(mesh, PackedBvh) else mesh).triangles(), origins,
                                   directions)
    if origins.device.type != "cuda":
        raise ValueError(f"ray_intersect: unsupported device {origins.device}")
    packed = mesh if isinstance(mesh, PackedBvh) else pack_bvh(mesh)
    return bvh_ray_intersect_cuda(packed, origins.contiguous(), directions.contiguous())
