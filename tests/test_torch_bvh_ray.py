"""The nearest ray hit, ``nerfshop_tpu_torch/geometry/bvh.py::ray_intersect``,
against JAX ``ray_intersect`` on the CPU.

Kernel N (``csrc/bvh.cu``) cannot run here, so two things stand in for it:
its plain version (every ray against every triangle, the lowest index on a
tie) and a numpy walk over the :class:`PackedBvh` in the kernel's order
(nearer child first, the farther pushed with its entry distance), both held
to JAX by one rule. Hit or miss is equal except on rays that graze an edge
(a barycentric margin min(u, v, 1 − u − v) under 1e-5 on some triangle,
where an FMA may flip the decision: at most 1% of the rays, counted); t is
within 1e-5·max(1, t); the triangle is JAX's up to ties (the chosen
triangle's own t, by the plain arithmetic, is JAX's t within the same
tolerance). Meshes: JAX's cube case of ``tests/test_bvh.py``, an icosphere
and a bumpy icosphere, with seeded rays from outside, from inside, missing
and axis-parallel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfshop_tpu.geometry import bvh as jbvh
from nerfshop_tpu_torch.geometry import bvh as tbvh

from test_torch_bvh import MESHES, cube_mesh
from torch_one_thread import one_thread  # noqa: F401

CPU = torch.device("cpu")
F32 = np.float32
FAR = F32(tbvh._FAR)
GRAZE = 1e-5


def _rays(seed: int, n: int = 96):
    """Seeded rays {kind: (origins [n, 3], directions [n, 3])} around the
    unit box's centre: from a sphere of radius 1.2 toward points near the
    centre, from within 0.1 of it, away from it, and along the axes (zero
    components, a few of them −1e-13, which the inverse clamps to +1e-12)."""
    rng = np.random.default_rng(seed)

    def unit(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    c = np.full(3, 0.5)
    shell = c + 1.2 * unit(rng.normal(size=(n, 3)))
    toward = unit(c + rng.uniform(-0.3, 0.3, (n, 3)) - shell)
    inside = c + 0.1 * unit(rng.normal(size=(n, 3))) * rng.uniform(0, 1, (n, 1))
    axis = np.eye(3)[rng.integers(0, 3, n)] * rng.choice([-1.0, 1.0], (n, 1))
    axis_o = c + rng.uniform(-0.35, 0.35, (n, 3)) - 0.8 * axis * rng.integers(0, 2, (n, 1))
    axis_d = axis.copy()
    axis_d[: n // 8][axis[: n // 8] == 0] = -1e-13
    sets = {
        "outside": (shell, toward),
        "inside": (inside, unit(rng.normal(size=(n, 3)))),
        "missing": (shell, unit(shell - c + rng.uniform(-0.2, 0.2, (n, 3)))),
        "axis": (axis_o, axis_d),
    }
    return {k: (o.astype(F32), d.astype(F32)) for k, (o, d) in sets.items()}


def _grazing(o, d, tri_pts) -> np.ndarray:
    """Rays whose plane hit (1e-6 < t < _FAR) on some triangle lies within
    ``GRAZE`` of its edges in barycentrics (float64)."""
    o, d = o.astype(np.float64)[:, None], d.astype(np.float64)[:, None]
    a, b, c = (tri_pts[None, :, k].astype(np.float64) for k in range(3))
    ab, ac = b - a, c - a
    pvec = np.cross(d, ac)
    det = (ab * pvec).sum(-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / det
        tvec = o - a
        u = (tvec * pvec).sum(-1) * inv
        qvec = np.cross(tvec, ab)
        v = (d * qvec).sum(-1) * inv
        t = (ac * qvec).sum(-1) * inv
        margin = np.minimum(np.minimum(u, v), 1 - u - v)
    near = (np.abs(det) > 1e-12) & (t > 1e-6) & (t < FAR) & (np.abs(margin) < GRAZE)
    return near.any(1)


def _own_t(tris: tbvh.TriangleSet, o, d, tri):
    """The plain arithmetic's t of each ray on the triangle ``tri`` it chose."""
    k = torch.as_tensor(np.maximum(tri, 0), dtype=torch.int64)
    t = tbvh.ray_triangle_t(torch.from_numpy(o), torch.from_numpy(d), tris.tri_a[k], tris.tri_ab[k], tris.tri_ac[k])
    return t.numpy()


def hold_to_jax(t, tri, t_ref, tri_ref, grazing, tris, o, d) -> int:
    """The module's rule → the number of rays whose hit or miss differs."""
    t, tri, t_ref, tri_ref = map(np.asarray, (t, tri, t_ref, tri_ref))
    hit, hit_ref = tri >= 0, tri_ref >= 0
    flips = hit != hit_ref
    assert not (flips & ~grazing).any(), np.nonzero(flips & ~grazing)
    assert flips.sum() <= max(1, 0.01 * len(t)), flips.sum()
    np.testing.assert_array_equal(t[~hit], FAR)
    np.testing.assert_array_equal(t_ref[~hit_ref], FAR)
    both = hit & hit_ref
    tol = 1e-5 * np.maximum(1.0, t_ref[both])
    assert (np.abs(t[both] - t_ref[both]) <= tol).all()
    # the triangle up to ties: the one chosen is hit at JAX's t
    assert (np.abs(_own_t(tris, o, d, tri)[both] - t_ref[both]) <= tol).all()
    return int(flips.sum())


# ----------------------------------------------------- kernel N's walk, in numpy


def _slab(o, inv, lo, hi, t_best):
    t0, t1 = (lo - o) * inv, (hi - o) * inv
    tn = F32(np.max(np.minimum(t0, t1)))
    tf = F32(np.min(np.maximum(t0, t1)))
    return bool(tf >= max(tn, F32(0)) and tn < t_best and lo[0] <= hi[0]), tn


def _tri_t(o, d, a, ab, ac, limit):
    """Möller–Trumbore of one ray and one triangle in float32, JAX's
    arithmetic; +inf unless it hits strictly before ``limit``."""
    cross = lambda x, y: np.array([x[1] * y[2] - x[2] * y[1], x[2] * y[0] - x[0] * y[2],  # noqa: E731
                                   x[0] * y[1] - x[1] * y[0]], F32)
    dot = lambda x, y: F32(x[0] * y[0] + x[1] * y[1] + x[2] * y[2])  # noqa: E731
    pvec = cross(d, ac)
    det = dot(ab, pvec)
    inv_det = F32(1) / (F32(1e-12) if abs(det) < F32(1e-12) else det)
    tvec = o - a
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, ab)
    v = dot(d, qvec) * inv_det
    t = dot(ac, qvec) * inv_det
    ok = u >= 0 and v >= 0 and u + v <= 1 and t > F32(1e-6) and t < limit
    return t if ok else F32(np.inf)


def walk_packed_ray(pk: tbvh.PackedBvh, o, d):
    """Kernel N's walk over the packed layout, one ray at a time → (t, tri)."""
    nodes = pk.nodes.numpy()
    links = nodes.view(np.int32)[:, 12:14]
    tris = pk.tris.numpy()
    tri_idx = tris.view(np.int32)[:, 3]
    inv = (F32(1) / np.where(np.abs(d) < F32(1e-12), F32(1e-12), d)).astype(F32)
    t_best, best_slot, stack, node = FAR, -1, [], 0
    while True:
        r = nodes[node]
        hl, tl = _slab(o, inv, r[0:3], r[3:6], t_best)
        hr, tr = _slab(o, inv, r[6:9], r[9:12], t_best)
        go, nxt = True, 0
        if hl and hr:
            left_first = tl <= tr
            nxt = links[node, 0] if left_first else links[node, 1]
            stack.append((links[node, 1] if left_first else links[node, 0], tr if left_first else tl))
            assert len(stack) <= tbvh.MAX_DEPTH - 1
        elif hl:
            nxt = links[node, 0]
        elif hr:
            nxt = links[node, 1]
        else:
            go = False
        while True:
            if go:
                if nxt >= 0:
                    break
                start, count = (~nxt) >> 2, ((~nxt) & 3) + 1
                for s in range(start, start + count):  # the first strictly nearer
                    t = _tri_t(o, d, tris[s, 0:3], tris[s, 4:7], tris[s, 8:11], t_best)
                    if t < t_best:
                        t_best, best_slot = t, s
            go = False
            while stack:
                link, tn = stack.pop()
                if tn < t_best:
                    nxt, go = link, True
                    break
            if not go:
                break
        if not go:
            break
        node = nxt
    return t_best, (int(tri_idx[best_slot]) if best_slot >= 0 else -1)


# ------------------------------------------------------------------------ tests


@pytest.fixture(scope="module", params=list(MESHES))
def mesh_case(request):
    mesh = MESHES[request.param]()
    bvh = tbvh.build_bvh(mesh.vertices, mesh.faces, CPU)
    jb = jbvh.build_bvh(mesh.vertices, mesh.faces)
    return request.param, mesh, bvh, tbvh.pack_bvh(bvh), jb


def _jax(jb, o, d):
    t, tri = jax.jit(jbvh.ray_intersect)(jb, jnp.asarray(o), jnp.asarray(d))
    return np.asarray(t), np.asarray(tri)


def test_jax_cube_case():
    # tests/test_bvh.py's three rays: a face's centre (on the diagonal two
    # triangles share), a miss, and from inside
    m = cube_mesh()
    bvh = tbvh.build_bvh(m.vertices, m.faces, CPU)
    o = np.array([[0.5, 0.5, -1.0], [2.0, 2.0, 2.0], [0.5, 0.5, 0.5]], F32)
    d = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0], [1.0, 0.0, 0.0]], F32)
    t_ref, tri_ref = _jax(jbvh.build_bvh(m.vertices, m.faces), o, d)
    t, tri = tbvh.ray_intersect(bvh, torch.from_numpy(o), torch.from_numpy(d))
    assert t.dtype == torch.float32 and tri.dtype == torch.int32
    np.testing.assert_allclose(t.numpy(), [1.25, FAR, 0.25], atol=1e-5)
    assert tri[1] == -1 and tri_ref[1] == -1
    # the face z = 0.25 is triangles 0 and 1; x = 0.75 is 10 and 11
    assert int(tri[0]) in (0, 1) and int(tri_ref[0]) in (0, 1) and int(tri[2]) in (10, 11)
    hold_to_jax(t, tri, t_ref, tri_ref, _grazing(o, d, m.vertices[m.faces]), bvh.triangles(), o, d)
    walked = [walk_packed_ray(tbvh.pack_bvh(bvh), a, b) for a, b in zip(o, d)]
    hold_to_jax([w[0] for w in walked], [w[1] for w in walked], t_ref, tri_ref,
                _grazing(o, d, m.vertices[m.faces]), bvh.triangles(), o, d)


@pytest.mark.parametrize("kind", ["outside", "inside", "missing", "axis"])
def test_plain_and_packed_walk_match_jax(mesh_case, kind):
    name, mesh, bvh, pk, jb = mesh_case
    o, d = _rays(seed=len(name) * 10 + len(kind))[kind]
    t_ref, tri_ref = _jax(jb, o, d)
    grazing = _grazing(o, d, mesh.vertices[mesh.faces])
    tris = bvh.triangles()
    t, tri = tbvh.ray_intersect_plain(tris, torch.from_numpy(o), torch.from_numpy(d))
    flips = hold_to_jax(t.numpy(), tri.numpy(), t_ref, tri_ref, grazing, tris, o, d)
    walked = [walk_packed_ray(pk, a, b) for a, b in zip(o, d)]
    flips += hold_to_jax([w[0] for w in walked], [w[1] for w in walked], t_ref, tri_ref, grazing, tris, o, d)
    assert flips <= max(1, 0.02 * len(o))
    hits = (tri_ref >= 0).mean()
    if kind == "inside":
        assert (tri.numpy() >= 0).all() and (tri_ref >= 0).all()  # a closed mesh around the origin
    elif kind == "missing":
        assert hits == 0
    else:
        assert hits > 0


@pytest.mark.parametrize("F", range(1, tbvh.LEAF_SIZE + 1))
def test_packed_walk_root_leaf(F):
    # F ≤ LEAF_SIZE: a root leaf beside an empty box, which no ray enters
    m = cube_mesh()
    faces = m.faces[:F]
    bvh = tbvh.build_bvh(m.vertices, faces, CPU)
    pk = tbvh.pack_bvh(bvh)
    assert pk.depth == 1
    o, d = _rays(seed=F)["outside"]
    t_ref, tri_ref = _jax(jbvh.build_bvh(m.vertices, faces), o, d)
    walked = [walk_packed_ray(pk, a, b) for a, b in zip(o, d)]
    hold_to_jax([w[0] for w in walked], [w[1] for w in walked], t_ref, tri_ref,
                _grazing(o, d, m.vertices[faces]), bvh.triangles(), o, d)
    assert (tri_ref >= 0).any()


def test_sentinel_never_hits(mesh_case):
    # JAX's leaves are padded with a degenerate triangle at _FAR (zero
    # edges): its det is 0, clamped to 1e-12, and its t is 0 ≤ 1e-6, so it
    # never hits, not even on a ray aimed at it; pack_bvh drops it
    _, _, bvh, pk, jb = mesh_case
    F = bvh.tri_a.shape[0] - 1
    assert (bvh.leaf_tris == F).any() or F % tbvh.LEAF_SIZE == 0
    rng = np.random.default_rng(0)
    o = rng.uniform(-1, 2, (256, 3)).astype(F32)
    d = (FAR - o) / np.linalg.norm(FAR - o, axis=-1, keepdims=True)
    d[128:] = rng.normal(size=(128, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(F32)
    s = torch.full((1, 3), tbvh._FAR)
    z = torch.zeros((1, 3))
    t = tbvh.ray_triangle_t(torch.from_numpy(o), torch.from_numpy(d), s, z, z)
    assert (t.numpy() == FAR).all()
    _, tri = _jax(jb, o, d)
    assert (tri != F).all()
    assert (pk.tris.numpy().view(np.int32)[:, 3] != F).all()


def test_dispatch_on_cpu(mesh_case):
    _, _, bvh, pk, _ = mesh_case
    o, d = (torch.from_numpy(a) for a in _rays(seed=3)["outside"])
    t, tri = tbvh.ray_intersect(pk, o, d)
    for mesh in (bvh, bvh.triangles()):
        t2, tri2 = tbvh.ray_intersect(mesh, o, d)
        assert torch.equal(t, t2) and torch.equal(tri, tri2)
    with pytest.raises(ValueError, match="CUDA device"):
        tbvh.bvh_ray_intersect_cuda(pk, o, d)
    with pytest.raises(TypeError, match="kernel N walks a PackedBvh"):
        tbvh.bvh_ray_intersect_cuda(bvh, o, d)
    with pytest.raises(ValueError, match="unsupported device"):
        tbvh.ray_intersect(pk, o.to("meta"), d.to("meta"))
    # no rays, and a mesh without triangles
    t0, tri0 = tbvh.ray_intersect(pk, o[:0], d[:0])
    assert t0.shape == (0,) and tri0.shape == (0,)
    empty = tbvh.TriangleSet(*(x[:0] for x in bvh.triangles()))
    t_e, tri_e = tbvh.ray_intersect(empty, o, d)
    assert (t_e == tbvh._FAR).all() and (tri_e == -1).all()
