"""Isosurface extraction (replaces the reference's GPU marching cubes,
src/marching_cubes.cu:1017 LoC, used for mesh export S7 and the editing
pipeline's fine-mesh step E7).

Design choice: **marching tetrahedra** instead of marching cubes — each
cube splits into 6 tets and each tet has only 3 distinct triangulation
topologies, so the whole extraction is a handful of vectorized numpy
gathers with no 256-entry case tables. Produces ~2× the triangles of MC for
the same grid, which is irrelevant here (meshes are decimated downstream)
and guarantees watertight, crack-free output.

Vertex welding merges shared edge-interpolated vertices so downstream code
(1-ring normals, decimation, tet meshing) sees a connected mesh.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from nerfshop_tpu_torch.geometry.mesh_io import TriMesh

# 6-tet decomposition of a cube around the 0-7 main diagonal
# (corner indices 0..7, bit k = offset along axis k)
_CUBE_TETS = np.array(
    [
        [0, 1, 3, 7],
        [0, 1, 7, 5],
        [0, 5, 7, 4],
        [0, 3, 2, 7],
        [0, 2, 6, 7],
        [0, 6, 4, 7],
    ],
    np.int64,
)

_CORNER_OFFSET = np.array(
    [[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)], np.int64
)


def _tet_triangles(inside: np.ndarray):
    """inside: [T, 4] bool → list of (edge pairs) triangles per case.

    A tet edge is identified by its two corner slots (i, j), i<j. Cases:
    1 corner inside → 1 triangle; 2 inside → quad (2 tris); 3 inside →
    1 triangle (inverted). Returns per-case triangle edge lists."""
    # static case table built programmatically over the 16 sign patterns
    cases = []
    edges = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    for mask in range(16):
        ins = [bool(mask >> k & 1) for k in range(4)]
        n_in = sum(ins)
        cross = [e for e in edges if ins[e[0]] != ins[e[1]]]
        if n_in in (0, 4):
            cases.append([])
            continue
        if n_in == 1 or n_in == 3:
            v = ins.index(True) if n_in == 1 else ins.index(False)
            tri = [e for e in cross]  # exactly 3 crossing edges around v
            a, b, c = tri
            cases.append([(a, b, c)])
        else:  # 2 inside → 4 crossing edges forming a quad
            # order the quad: edges sharing an inside corner are adjacent
            ins_idx = [k for k in range(4) if ins[k]]
            e0 = [e for e in cross if ins_idx[0] in e]
            e1 = [e for e in cross if ins_idx[1] in e]
            # quad ring: e0[0], e0[1], e1[?, matching shared outside corner]
            out0 = e0[0][0] if e0[0][1] == ins_idx[0] else e0[0][1]
            q = [e0[0], e0[1]]
            # pick the e1 edge touching out of e0[1]
            out1 = e0[1][0] if e0[1][1] == ins_idx[0] else e0[1][1]
            nxt = [e for e in e1 if out1 in e]
            other = [e for e in e1 if e is not nxt[0]]
            q = [e0[0], e0[1], nxt[0], other[0]]
            cases.append([(q[0], q[1], q[2]), (q[0], q[2], q[3])])
    return cases


_TET_CASES = _tet_triangles(None)
_EDGE_LIST = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
_EDGE_ID = {e: i for i, e in enumerate(_EDGE_LIST)}

# case → up to 2 triangles × 3 edge ids, padded with -1
_CASE_TABLE = np.full((16, 2, 3), -1, np.int64)
for ci, tris in enumerate(_TET_CASES):
    for ti, tri in enumerate(tris):
        for vi, e in enumerate(tri):
            _CASE_TABLE[ci, ti, vi] = _EDGE_ID[e]


def marching_tets(
    field: np.ndarray,  # [X, Y, Z] scalar field
    iso: float = 0.0,
    origin=(0.0, 0.0, 0.0),
    spacing=None,
) -> TriMesh:
    """Extract the iso-surface of a dense field. ``inside`` = field > iso
    (density convention; pass -sdf for SDFs)."""
    X, Y, Z = field.shape
    if spacing is None:
        spacing = (1.0 / max(X - 1, 1), 1.0 / max(Y - 1, 1), 1.0 / max(Z - 1, 1))
    spacing = np.asarray(spacing, np.float64)
    origin = np.asarray(origin, np.float64)

    # cube corner values [Cx, Cy, Cz, 8]
    def corner(o):
        return field[o[0] : o[0] + X - 1, o[1] : o[1] + Y - 1, o[2] : o[2] + Z - 1]

    vals = np.stack([corner(o) for o in _CORNER_OFFSET], -1)  # [.,.,.,8]
    inside_c = vals > iso
    # skip cubes that are entirely in/out
    any_in = inside_c.any(-1)
    all_in = inside_c.all(-1)
    active = np.argwhere(any_in & ~all_in)  # [A, 3]
    if len(active) == 0:
        return TriMesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))

    av = vals[active[:, 0], active[:, 1], active[:, 2]]  # [A, 8]

    # per-tet processing, vectorized over (active cubes × 6 tets)
    tet_corner = _CUBE_TETS  # [6, 4] corner slots
    tv = av[:, tet_corner]  # [A, 6, 4]
    t_in = tv > iso
    case = (
        t_in[..., 0].astype(np.int64)
        | t_in[..., 1].astype(np.int64) << 1
        | t_in[..., 2].astype(np.int64) << 2
        | t_in[..., 3].astype(np.int64) << 3
    )  # [A, 6]

    tris_e = _CASE_TABLE[case]  # [A, 6, 2, 3] edge ids or -1
    valid_tri = tris_e[..., 0] >= 0  # [A, 6, 2]
    a_idx, t_idx, k_idx = np.nonzero(valid_tri)
    tri_edges = tris_e[a_idx, t_idx, k_idx]  # [T, 3] edge ids

    # world-space corner positions of each contributing tet
    cube_xyz = active[a_idx]  # [T, 3]
    corner_slots = tet_corner[t_idx]  # [T, 4] cube-corner ids
    corner_xyz = cube_xyz[:, None, :] + _CORNER_OFFSET[corner_slots]  # [T, 4, 3]
    corner_pos = origin + corner_xyz * spacing
    corner_val = av[a_idx][np.arange(len(a_idx))[:, None], corner_slots]  # [T, 4]

    edge_ends = np.asarray(_EDGE_LIST, np.int64)[tri_edges]  # [T, 3, 2]
    r = np.arange(len(a_idx))[:, None, None]
    v0 = corner_val[r[..., 0], edge_ends[..., 0]]  # [T, 3]
    v1 = corner_val[r[..., 0], edge_ends[..., 1]]
    p0 = corner_pos[np.arange(len(a_idx))[:, None], edge_ends[..., 0]]  # [T, 3, 3]
    p1 = corner_pos[np.arange(len(a_idx))[:, None], edge_ends[..., 1]]
    w = (iso - v0) / np.where(np.abs(v1 - v0) < 1e-12, 1e-12, v1 - v0)
    w = np.clip(w, 0.0, 1.0)[..., None]
    verts = (p0 * (1 - w) + p1 * w).reshape(-1, 3)  # [T*3, 3]

    # weld duplicate vertices (edge interpolations are bit-identical across
    # neighboring tets/cubes sharing an edge, so exact-match welding works;
    # round defensively for float noise)
    keys = np.round(verts * 1e7).astype(np.int64)
    _, uniq_idx, inverse = np.unique(
        keys.view([("x", np.int64), ("y", np.int64), ("z", np.int64)]).reshape(-1),
        return_index=True,
        return_inverse=True,
    )
    faces = inverse.reshape(-1, 3).astype(np.int32)
    # drop degenerate triangles
    keep = (
        (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    )
    return TriMesh(verts[uniq_idx].astype(np.float32), faces[keep])


def orient_consistently(mesh: TriMesh) -> TriMesh:
    """Make face windings globally consistent (BFS over shared edges) and
    outward (positive signed volume). Required before MVC — inconsistent
    windings make the signed weight sums cancel."""
    if mesh.n_faces == 0:
        return mesh
    faces = mesh.faces.copy()
    # adjacency via shared undirected edges
    from collections import defaultdict

    edge_faces = defaultdict(list)
    for fi, (a, b, c) in enumerate(faces):
        for e in ((a, b), (b, c), (c, a)):
            edge_faces[tuple(sorted(e))].append(fi)

    def directed_edges(f):
        a, b, c = f
        return [(a, b), (b, c), (c, a)]

    visited = np.zeros(len(faces), bool)
    for seed in range(len(faces)):
        if visited[seed]:
            continue
        stack = [seed]
        visited[seed] = True
        while stack:
            fi = stack.pop()
            de = set(directed_edges(faces[fi]))
            for e in de:
                key = tuple(sorted(e))
                for nj in edge_faces[key]:
                    if nj == fi or visited[nj]:
                        continue
                    # consistent orientation: the shared edge must appear in
                    # OPPOSITE directions in the two faces
                    if e in set(directed_edges(faces[nj])):
                        faces[nj] = faces[nj][::-1]
                    visited[nj] = True
                    stack.append(nj)

    # global flip so the signed volume is positive (outward normals)
    v = mesh.vertices[faces]
    vol = np.einsum("ij,ij->i", np.cross(v[:, 1], v[:, 2]), v[:, 0]).sum()
    if vol < 0:
        faces = faces[:, ::-1]
    return TriMesh(mesh.vertices, np.ascontiguousarray(faces), mesh.colors, mesh.normals)


def orient_faces_outward(mesh: TriMesh, field_fn: Callable[[np.ndarray], np.ndarray], iso: float = 0.0, density_convention: bool = True) -> TriMesh:
    """Flip faces so normals point away from the 'inside' (field > iso)."""
    if mesh.n_faces == 0:
        return mesh
    fn = mesh.face_normals()
    cent = mesh.vertices[mesh.faces].mean(1)
    eps = 1e-3 * float(np.linalg.norm(mesh.vertices.max(0) - mesh.vertices.min(0)) + 1e-9)
    ahead = field_fn(cent + fn * eps)
    flip = (ahead > iso) if density_convention else (ahead < iso)
    faces = mesh.faces.copy()
    faces[flip] = faces[flip][:, [0, 2, 1]]
    return TriMesh(mesh.vertices, faces, mesh.colors, mesh.normals)
