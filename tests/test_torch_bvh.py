"""Kernel G's packed layout (``nerfshop_tpu_torch/geometry/bvh.py::pack_bvh``)
and its wrapper's refusals, on the CPU.

The CUDA walk cannot run here, so a plain walk over the :class:`PackedBvh`
in the kernel's order (numpy, below) stands in for it: it must give JAX
``signed_distance``'s distances and pick the triangle that a walk over the
``BvhArrays`` in JAX's order picks. Meshes: the cube and icosphere of
``tests/test_bvh.py`` and a small bumpy icosphere."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfshop_tpu.geometry import bvh as jbvh
from nerfshop_tpu_torch.geometry import bvh as tbvh

from test_bvh import cube_mesh, icosphere
from test_torch_sdf import bumpy_icosphere

CPU = torch.device("cpu")
MESHES = {"cube": cube_mesh, "sphere": lambda: icosphere(subdiv=2), "bumpy": bumpy_icosphere}
F32 = np.float32


def _closest(p, a, ab, ac):
    """Ericson's closest point of p [3] on triangles (a, ab, ac) [T, 3] in
    float32 → (points [T, 3], regions [T]), JAX's precedence."""
    dot = lambda x, y: (x * y).sum(-1, dtype=F32)  # noqa: E731
    ap, bp, cp = p - a, p - (a + ab), p - (a + ac)
    d1, d2, d3, d4, d5, d6 = dot(ab, ap), dot(ac, ap), dot(ab, bp), dot(ac, bp), dot(ab, cp), dot(ac, cp)
    va, vb, vc = d3 * d6 - d5 * d4, d5 * d2 - d1 * d6, d1 * d4 - d3 * d2
    denom = va + vb + vc
    denom = np.where(np.abs(denom) < 1e-30, F32(1e-30), denom)
    with np.errstate(divide="ignore", invalid="ignore"):
        cands = [
            ((d1 <= 0) & (d2 <= 0), a, 1),
            ((d3 >= 0) & (d4 <= d3), a + ab, 2),
            ((d6 >= 0) & (d5 <= d6), a + ac, 3),
            ((vc <= 0) & (d1 >= 0) & (d3 <= 0), a + (d1 / np.maximum(d1 - d3, F32(1e-30)))[:, None] * ab, 4),
            ((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0),
             a + ab + ((d4 - d3) / np.maximum((d4 - d3) + (d5 - d6), F32(1e-30)))[:, None] * (ac - ab), 5),
            ((vb <= 0) & (d2 >= 0) & (d6 <= 0), a + (d2 / np.maximum(d2 - d6, F32(1e-30)))[:, None] * ac, 6),
        ]
        pt = a + (vb / denom)[:, None] * ab + (vc / denom)[:, None] * ac
    reg = np.zeros(len(a), np.int64)
    done = np.zeros(len(a), bool)
    for mask, val, code in cands:  # the first region that holds wins
        take = mask & ~done
        pt = np.where(take[:, None], val, pt)
        reg = np.where(take, code, reg)
        done |= take
    return pt.astype(F32), reg


def _box_d2(p, lo, hi):
    d = np.maximum(np.maximum(lo - p, p - hi), F32(0))
    return F32((d * d).sum(dtype=F32))


def _leaf(p, a, ab, ac, best):
    """The first strictly nearer triangle of a leaf, in slot order → its
    slot or -1, and its squared distance."""
    pt, _ = _closest(p, a, ab, ac)
    d2 = ((pt - p) ** 2).sum(-1, dtype=F32)
    j = int(np.argmin(d2))
    return (j, d2[j]) if d2[j] < best else (-1, best)


def _sign(p, bvh, tri):
    pt, reg = _closest(p, bvh["tri_a"][tri][None], bvh["tri_ab"][tri][None], bvh["tri_ac"][tri][None])
    normals = np.concatenate([bvh["tri_n"][tri][None], bvh["tri_pseudo_v"][tri], bvh["tri_pseudo_e"][tri]])
    return 1.0 if ((p - pt[0]) * normals[reg[0]]).sum() >= 0 else -1.0


def walk_packed(pk, bvh, p):
    """Kernel G's walk over the packed layout (csrc/bvh.cu; its lanes'
    nearest of a leaf, ties to the lower slot, is ``np.argmin``'s pick) →
    (signed distance, triangle index)."""
    nodes = pk.nodes.numpy()
    links = nodes.view(np.int32)[:, 12:14]
    tris = pk.tris.numpy()
    tri_idx = tris.view(np.int32)[:, 3]
    best, best_slot, stack, node = F32(1e30), -1, [], 0
    while True:
        r = nodes[node]
        dl, dr = _box_d2(p, r[0:3], r[3:6]), _box_d2(p, r[6:9], r[9:12])
        go, nxt = True, 0
        if dl < best and dr < best:
            left_first = dl <= dr
            nxt = links[node, 0] if left_first else links[node, 1]
            stack.append((links[node, 1] if left_first else links[node, 0], dr if left_first else dl))
            assert len(stack) <= tbvh.MAX_DEPTH - 1
        elif dl < best:
            nxt = links[node, 0]
        elif dr < best:
            nxt = links[node, 1]
        else:
            go = False
        while True:
            if go:
                if nxt >= 0:
                    break
                start, count = (~nxt) >> 2, ((~nxt) & 3) + 1
                t = tris[start : start + count]
                j, best = _leaf(p, t[:, 0:3], t[:, 4:7], t[:, 8:11], best)
                if j >= 0:
                    best_slot = start + j
            go = False
            while stack:
                link, d = stack.pop()
                if d < best:
                    nxt, go = link, True
                    break
            if not go:
                break
        if not go:
            break
        node = nxt
    tri = int(tri_idx[best_slot])
    return _sign(p, bvh, tri) * float(np.sqrt(best)), tri


def walk_jax_order(bvh, p):
    """JAX ``signed_distance``'s walk over the ``BvhArrays`` (a stack of
    nodes, the farther child pushed first) → the triangle it picks."""
    F = len(bvh["tri_a"]) - 1
    best, best_tri, stack = F32(1e30), -1, [0]
    while stack:
        ni = stack.pop()
        if not _box_d2(p, bvh["node_min"][ni], bvh["node_max"][ni]) < best:
            continue
        leaf = bvh["node_leaf"][ni]
        if leaf >= 0:
            tis = bvh["leaf_tris"][leaf]
            j, best = _leaf(p, bvh["tri_a"][tis], bvh["tri_ab"][tis], bvh["tri_ac"][tis], best)
            if j >= 0:
                best_tri = int(tis[j])
        else:
            li = bvh["node_left"][ni]
            dl = _box_d2(p, bvh["node_min"][li], bvh["node_max"][li])
            dr = _box_d2(p, bvh["node_min"][li + 1], bvh["node_max"][li + 1])
            stack += [li + 1, li] if dl <= dr else [li, li + 1]
    assert best_tri < F
    return best_tri


def _points(mesh, seed=0, n=100):
    """Uniform points in the inflated box, points near the surface and
    points within 1e-4 of vertices and edge midpoints (ties between
    triangles)."""
    rng = np.random.default_rng(seed)
    v, f = mesh.vertices, mesh.faces
    lo, hi = v.min(0) - 0.1, v.max(0) + 0.1
    tri = v[f[rng.integers(0, len(f), n)]]
    near = np.einsum("nk,nkd->nd", rng.dirichlet(np.ones(3), n), tri) + rng.normal(0, 0.01, (n, 3))
    feat = np.concatenate([v[rng.integers(0, len(v), n // 2)], tri[: n // 2, :2].mean(1)])
    feat += rng.uniform(-1e-4, 1e-4, feat.shape)
    return np.concatenate([rng.uniform(lo, hi, (n, 3)), near, feat]).astype(F32)


@pytest.fixture(scope="module", params=list(MESHES))
def packed(request):
    mesh = MESHES[request.param]()
    bvh = tbvh.build_bvh(mesh.vertices, mesh.faces, CPU)
    return mesh, bvh, {k: getattr(bvh, k).numpy() for k in tbvh.BvhArrays._fields}, tbvh.pack_bvh(bvh)


def test_packed_walk_matches_jax(packed):
    mesh, _, arrs, pk = packed
    pts = _points(mesh)
    ref = np.asarray(jax.jit(jbvh.signed_distance)(jbvh.build_bvh(mesh.vertices, mesh.faces), jnp.asarray(pts)))
    walked = [walk_packed(pk, arrs, p) for p in pts]
    d = np.array([w[0] for w in walked], np.float32)
    np.testing.assert_allclose(d, ref, rtol=0, atol=1e-6)
    clear = np.abs(ref) > 1e-6
    np.testing.assert_array_equal(np.sign(d[clear]), np.sign(ref[clear]))
    # the same triangle as the BvhArrays walk in JAX's order
    assert [w[1] for w in walked] == [walk_jax_order(arrs, p) for p in pts]


def test_packed_layout(packed):
    _, _, arrs, pk = packed
    F = len(arrs["tri_a"]) - 1
    nodes, tris = pk.nodes.numpy(), pk.tris.numpy()
    order = tris.view(np.int32)[:, 3]
    # every real triangle exactly once, no sentinel, its corner and edges
    np.testing.assert_array_equal(np.sort(order), np.arange(F))
    np.testing.assert_array_equal(tris[:, 0:3], arrs["tri_a"][order])
    np.testing.assert_array_equal(tris[:, 4:7], arrs["tri_ab"][order])
    np.testing.assert_array_equal(tris[:, 8:11], arrs["tri_ac"][order])
    # each record is an inner node: its children's boxes are their node
    # boxes, and its links name their records or their leaves' triangles
    inner = np.nonzero(arrs["node_left"] >= 0)[0]
    record = {int(n): r for r, n in enumerate(inner)}
    assert len(nodes) == len(inner) and record[0] == 0
    links = nodes.view(np.int32)[:, 12:14]
    seen = []
    for r, n in enumerate(inner):
        for side, child in enumerate((arrs["node_left"][n], arrs["node_left"][n] + 1)):
            np.testing.assert_array_equal(nodes[r, 6 * side : 6 * side + 3], arrs["node_min"][child])
            np.testing.assert_array_equal(nodes[r, 6 * side + 3 : 6 * side + 6], arrs["node_max"][child])
            link = links[r, side]
            if arrs["node_leaf"][child] < 0:
                assert link == record[int(child)]
            else:
                start, count = (~link) >> 2, ((~link) & 3) + 1
                slots = arrs["leaf_tris"][arrs["node_leaf"][child]]
                np.testing.assert_array_equal(order[start : start + count], slots[slots != F])
                seen.append((start, count))
    # the leaves' ranges tile the packed triangles in leaf order
    starts, counts = np.array(sorted(seen)).T
    np.testing.assert_array_equal(starts, np.cumsum(counts) - counts)
    assert counts.sum() == F
    assert 2 <= pk.depth <= tbvh.MAX_DEPTH and nodes.dtype == np.float32


@pytest.mark.parametrize("F", range(1, tbvh.LEAF_SIZE + 1))
def test_packed_root_leaf(F):
    # F ≤ LEAF_SIZE: the root is a leaf, packed beside an empty box
    mesh = cube_mesh()
    faces = mesh.faces[:F]
    bvh = tbvh.build_bvh(mesh.vertices, faces, CPU)
    pk = tbvh.pack_bvh(bvh)
    assert pk.depth == 1 and pk.nodes.shape == (1, 16) and pk.tris.shape == (F, 12)
    arrs = {k: getattr(bvh, k).numpy() for k in tbvh.BvhArrays._fields}
    pts = _points(type(mesh)(mesh.vertices, faces), n=20)
    ref = np.asarray(jbvh.signed_distance(jbvh.build_bvh(mesh.vertices, faces), jnp.asarray(pts)))
    walked = [walk_packed(pk, arrs, p) for p in pts]
    np.testing.assert_allclose([w[0] for w in walked], ref, rtol=0, atol=1e-6)
    assert [w[1] for w in walked] == [walk_jax_order(arrs, p) for p in pts]


def _bvh(node_left, node_leaf, leaf_tris, F):
    """A BvhArrays of the given tree over F zero-sized triangles."""
    n = len(node_left)
    t = lambda *s: torch.zeros(s, dtype=torch.float32)  # noqa: E731
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32))  # noqa: E731
    return tbvh.BvhArrays(t(n, 3), t(n, 3), i32(node_left), i32(node_leaf), i32(leaf_tris),
                          t(F + 1, 3), t(F + 1, 3), t(F + 1, 3), t(F + 1, 3, 3), t(F + 1, 3, 3), t(F + 1, 3))


def test_pack_bvh_refuses():
    # a chain: inner node 2j has children 2j + 1 (a leaf) and 2j + 2
    for levels, deep in ((tbvh.MAX_DEPTH, False), (tbvh.MAX_DEPTH + 1, True), (40, True)):
        n_inner = levels - 1
        node_left = [k + 1 if k % 2 == 0 and k < 2 * n_inner else -1 for k in range(2 * n_inner + 1)]
        leaves = [k for k in range(2 * n_inner + 1) if node_left[k] < 0]
        node_leaf = [leaves.index(k) if k in leaves else -1 for k in range(2 * n_inner + 1)]
        F = len(leaves)
        leaf_tris = [[i, F, F, F] for i in range(F)]
        bvh = _bvh(node_left, node_leaf, leaf_tris, F)
        if deep:
            with pytest.raises(ValueError, match=f"kernel G: the BVH is deeper than {tbvh.MAX_DEPTH}"):
                tbvh.pack_bvh(bvh)
        else:
            assert tbvh.pack_bvh(bvh).depth == levels
    with pytest.raises(ValueError, match="kernel G: the mesh has no triangle"):
        tbvh.pack_bvh(_bvh([-1], [0], [[0, 0, 0, 0]], 0))
    with pytest.raises(ValueError, match="kernel G: every leaf"):
        tbvh.pack_bvh(_bvh([-1], [0], [[1, 0, 1, 1]], 1))


def test_signed_distance_dispatch_on_cpu(packed):
    mesh, bvh, _, pk = packed
    pts = torch.from_numpy(_points(mesh, seed=1, n=30))
    # the plain version (the brute force) whatever form of the BVH
    np.testing.assert_array_equal(tbvh.signed_distance(pk, pts).numpy(), tbvh.signed_distance(bvh, pts).numpy())
    np.testing.assert_array_equal(tbvh.signed_distance(pk, pts).numpy(),
                                  tbvh.signed_distance(bvh.triangles(), pts).numpy())
    with pytest.raises(ValueError, match="CUDA device"):
        tbvh.bvh_signed_distance_cuda(pk, pts)
    # the wrapper walks a PackedBvh only: a BvhArrays is packed by
    # signed_distance (or once a mesh), never inside a launch
    with pytest.raises(TypeError, match="kernel G walks a PackedBvh"):
        tbvh.bvh_signed_distance_cuda(bvh, pts)
