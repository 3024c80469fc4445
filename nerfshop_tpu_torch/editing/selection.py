"""Selection: scribble projection, region growing, morphology, fine-mesh
extraction and the proxy cage.

Counterpart of ``nerfshop_tpu/editing/selection.py``. The projection
marches the scribble rays with the port's march and model on the grid's
device; region growing is the native host library's flood fill
(``native.py``, ``region_grow``), held to the Python BFS of the JAX package
(:meth:`RegionGrowing.grow_plain`); the rest is the same host numpy/scipy
geometry, with the cage containment test (:func:`inflate_to_bound`) on the
device.
"""

from __future__ import annotations

from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from nerfshop_tpu_torch import native
from nerfshop_tpu_torch.common import GRID_RESOLUTION
from nerfshop_tpu_torch.geometry import isosurface
from nerfshop_tpu_torch.geometry.mesh_io import TriMesh

R = GRID_RESOLUTION


# ---------------------------------------------------------------------------
# Scribble projection
# ---------------------------------------------------------------------------


@torch.no_grad()
def project_selection_rays(
    model,
    params,
    grid,
    origins,
    directions,
    aabb,
    cone_angle: float = 0.0,
    transmittance_threshold: float = 1e-1,
    k_samples: int = 128,
):
    """March scribble rays, composite density only, and return the first
    point where the transmittance drops below the threshold.

    ``params`` is a state dict of ``model`` (e.g. the EMA copy) or None.
    → (hit_mask [N], points [N, 3] world, cells [N, 4] (mip, ix, iy, iz)),
    numpy."""
    from nerfshop_tpu_torch.models.nerf_network import density_with
    from nerfshop_tpu_torch.ops import coords, march
    from nerfshop_tpu_torch.ops.gather import take_along

    dev = grid.occupancy.device
    origins = torch.as_tensor(origins, dtype=torch.float32, device=dev)
    directions = torch.as_tensor(directions, dtype=torch.float32, device=dev)
    # stratified spread over the whole occupied path, so that a camera inside
    # a large scene does not spend every sample in near free space
    samples = march.march_rays(
        origins, directions, grid.occupancy, aabb.min, aabb.max, cone_angle, k_samples=k_samples,
        use_grid_early_stop=True, selection="spread", t_start_min=0.05,
        fine_field=march.masked_density_field(grid.occupancy, grid.density).reshape(-1),
    )
    Rn, K = samples.t.shape
    pos_w, _ = march.samples_to_network_inputs(samples, origins, directions, aabb)
    sigma = density_with(model, params, pos_w.reshape(-1, 3)).reshape(Rn, K)
    tau = torch.cumsum(torch.where(samples.valid, sigma * samples.dt, torch.zeros_like(sigma)), dim=1)
    crossed = torch.exp(-tau) < transmittance_threshold
    hit = crossed.any(dim=1)
    first = torch.argmax(crossed.to(torch.int32), dim=1)
    t_hit = take_along(samples.t, first[:, None], axis=1)[:, 0]
    points = origins + t_hit[:, None] * directions
    mip = coords.mip_from_pos(points, grid.occupancy.shape[0])
    cells = torch.cat([mip[:, None], coords.cascaded_grid_coords(points, mip)], dim=-1)
    return hit.cpu().numpy(), points.cpu().numpy(), cells.cpu().numpy().astype(np.int32)


# ---------------------------------------------------------------------------
# Region growing — host BFS
# ---------------------------------------------------------------------------


@dataclass
class RegionGrowing:
    """Flood fill over one cascade of the density grid."""

    density: np.ndarray  # [C, R, R, R] host copy
    growing_level: int = 0
    density_threshold: float = 0.01
    selection: np.ndarray = None  # [R, R, R] bool at growing_level
    queue: deque = field(default_factory=deque)

    def reset(self, seed_cells: np.ndarray, level: Optional[int] = None) -> None:
        """seed_cells [N, 4] (mip, ix, iy, iz) from the projection."""
        if level is None:
            level = int(seed_cells[:, 0].max()) if len(seed_cells) else 0
        self.growing_level = level
        self.selection = np.zeros((R, R, R), bool)
        self.queue = deque()
        for m, x, y, z in seed_cells:
            c = self._to_level(int(m), (int(x), int(y), int(z)), level)
            if c is not None:
                self.queue.append(c)

    def _to_level(self, mip: int, cell, level: int):
        """Re-index a cell of cascade ``mip`` into cascade ``level``."""
        if mip == level:
            return tuple(cell)
        p = (np.asarray(cell, np.float64) + 0.5) / R
        p = (p - 0.5) * (2.0**mip) + 0.5  # world
        q = (p - 0.5) * (2.0**-level) + 0.5
        c = np.floor(q * R).astype(int)
        if (c < 0).any() or (c >= R).any():
            return None
        return tuple(c)

    def grow(self, n_steps: int = 10000) -> int:
        """Breadth-first accept-if-dense by the native library for at most
        ``n_steps`` queue pops (each cell queued once); returns the number of
        accepted cells. The queue is spent: what the steps left is dropped."""
        grown = 0
        if self.queue:
            seeds = np.asarray([(x * R + y) * R + z for (x, y, z) in self.queue], np.int32)
            sel = self.selection.astype(np.uint8)
            grown = native.region_grow(self.density[self.growing_level], sel, seeds, self.density_threshold, n_steps)
            self.selection = sel.astype(bool)
            self.queue = deque()
        self._maybe_upscale()
        return grown

    def grow_plain(self, n_steps: int = 10000) -> int:
        """The Python BFS (a cell may be queued more than once, and each pop
        is a step), the plain version of :meth:`grow`; the same region when
        the steps do not run out."""
        dens = self.density[self.growing_level]
        grown = 0
        steps = 0
        while self.queue and steps < n_steps:
            steps += 1
            x, y, z = self.queue.popleft()
            if self.selection[x, y, z] or dens[x, y, z] < self.density_threshold:
                continue
            self.selection[x, y, z] = True
            grown += 1
            for dx, dy, dz in ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)):
                nx, ny, nz = x + dx, y + dy, z + dz
                if 0 <= nx < R and 0 <= ny < R and 0 <= nz < R and not self.selection[nx, ny, nz]:
                    self.queue.append((nx, ny, nz))
        self._maybe_upscale()
        return grown

    def _maybe_upscale(self) -> None:
        # a region that touches the cascade's boundary moves one cascade out
        if self._touches_boundary() and self.growing_level + 1 < self.density.shape[0]:
            self.upscale()

    def _touches_boundary(self) -> bool:
        s = self.selection
        return bool(s[0].any() or s[-1].any() or s[:, 0].any() or s[:, -1].any() or s[:, :, 0].any() or s[:, :, -1].any())

    def upscale(self) -> None:
        """Move the selection and the queue one cascade coarser."""
        new_sel = np.zeros((R, R, R), bool)
        xs, ys, zs = np.nonzero(self.selection)
        new_sel[(xs - R // 2) // 2 + R // 2, (ys - R // 2) // 2 + R // 2, (zs - R // 2) // 2 + R // 2] = True
        self.queue = deque(
            ((x - R // 2) // 2 + R // 2, (y - R // 2) // 2 + R // 2, (z - R // 2) // 2 + R // 2)
            for (x, y, z) in self.queue
        )
        self.selection = new_sel
        self.growing_level += 1


# ---------------------------------------------------------------------------
# Morphology
# ---------------------------------------------------------------------------


def _structuring_element(size: int, sphere: bool) -> np.ndarray:
    if not sphere:
        return np.ones((size, size, size), bool)
    r = (size - 1) / 2
    g = np.arange(size) - r
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    return x**2 + y**2 + z**2 <= r**2 + 1e-6


def dilate(selection: np.ndarray, size: int = 3, sphere: bool = False) -> np.ndarray:
    from scipy import ndimage

    return ndimage.binary_dilation(selection, structure=_structuring_element(size, sphere))


def erode(selection: np.ndarray, size: int = 3, sphere: bool = False) -> np.ndarray:
    from scipy import ndimage

    return ndimage.binary_erosion(selection, structure=_structuring_element(size, sphere))


def closing(selection: np.ndarray, size: int = 3, sphere: bool = False) -> np.ndarray:
    """Dilate, then erode."""
    return erode(dilate(selection, size, sphere), size, sphere)


# ---------------------------------------------------------------------------
# Fine mesh and proxy cage
# ---------------------------------------------------------------------------


def selection_to_world_box(level: int) -> Tuple[np.ndarray, np.ndarray]:
    """World-space bounds of cascade ``level``'s grid."""
    half = 0.5 * (2.0**level)
    return np.asarray([0.5 - half] * 3), np.asarray([0.5 + half] * 3)


def extract_fine_mesh(selection: np.ndarray, level: int, smooth_iters: int = 1) -> TriMesh:
    """Binary selection voxels → surface mesh in world coordinates."""
    from scipy import ndimage

    fld = selection.astype(np.float32)
    for _ in range(smooth_iters):
        fld = ndimage.uniform_filter(fld, 3)
    lo, hi = selection_to_world_box(level)
    spacing = (hi - lo) / R
    return isosurface.marching_tets(fld, iso=0.5, origin=lo + spacing / 2, spacing=spacing)


def vertex_cluster_decimate(mesh: TriMesh, target_vertices: int = 100) -> TriMesh:
    """Uniform-grid vertex-clustering decimation."""
    if mesh.n_vertices <= target_vertices:
        return mesh
    lo = mesh.vertices.min(0) - 1e-6
    hi = mesh.vertices.max(0) + 1e-6
    # the grid resolution that lands the cluster count near the target
    res = max(2, int(round(target_vertices ** (1 / 3) * 1.2)))
    for _ in range(24):
        cell = np.clip(np.floor((mesh.vertices - lo) / (hi - lo) * res).astype(np.int64), 0, res - 1)
        key = (cell[:, 0] * res + cell[:, 1]) * res + cell[:, 2]
        uniq, inverse = np.unique(key, return_inverse=True)
        if len(uniq) <= target_vertices or res <= 2:
            break
        res -= 1
    # new vertex = cluster centroid
    nv = np.zeros((len(uniq), 3), np.float64)
    cnt = np.zeros(len(uniq), np.int64)
    np.add.at(nv, inverse, mesh.vertices)
    np.add.at(cnt, inverse, 1)
    nv = (nv / cnt[:, None]).astype(np.float32)
    faces = inverse[mesh.faces]
    keep = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    faces = faces[keep]
    # dedupe faces regardless of winding
    _, idx = np.unique(np.sort(faces, 1), axis=0, return_index=True)
    return TriMesh(nv, faces[np.sort(idx)].astype(np.int32))


def inflate_to_bound(
    cage: TriMesh, points: np.ndarray, device: torch.device, margin: float = 0.0, iters: int = 20
) -> TriMesh:
    """Push cage vertices outward along their normals until every selection
    point is inside (signed distances on ``device``)."""
    from nerfshop_tpu_torch.geometry import bvh as bvh_lib

    verts = cage.vertices.copy()
    if len(points) == 0:
        return TriMesh(verts, cage.faces)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=device)
    step = 0.02 * float(np.linalg.norm(verts.max(0) - verts.min(0)))
    for _ in range(iters):
        tris = bvh_lib.build_triangles(verts, cage.faces, device)
        worst = float(bvh_lib.signed_distance(tris, pts).max())
        if worst < -margin:
            break
        verts = verts + TriMesh(verts, cage.faces).vertex_normals() * max(worst + margin, step * 0.5)
    return TriMesh(verts.astype(np.float32), cage.faces)


def fix_proxy_mesh(mesh: TriMesh, weld_eps: float = 1e-5) -> TriMesh:
    """Repair a decimated cage into a clean closed manifold: weld close
    vertices, drop degenerate and duplicate faces, keep the two
    best-supported faces at non-manifold edges, keep the largest component
    with consistent outward winding, and fan-fill boundary loops."""
    if mesh.n_faces == 0:
        return mesh
    v = mesh.vertices.astype(np.float64)
    scale = float(np.linalg.norm(v.max(0) - v.min(0)) + 1e-12)
    keys = np.round(v / (weld_eps * scale)).astype(np.int64)
    _, uniq_idx, inverse = np.unique(keys, axis=0, return_index=True, return_inverse=True)
    v = v[uniq_idx]
    f = inverse.reshape(-1)[mesh.faces]
    keep = (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])
    f = f[keep]
    if len(f) == 0:
        return TriMesh(v.astype(np.float32), np.zeros((0, 3), np.int32))
    _, idx = np.unique(np.sort(f, 1), axis=0, return_index=True)
    f = f[np.sort(idx)]
    # non-manifold edges: support = how many of a face's other edges are
    # cleanly 2-manifold (a dangling fin loses to the surface); area breaks ties
    area = 0.5 * np.linalg.norm(np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]]), axis=-1)
    edge_faces = defaultdict(list)
    for fi, (a, b, c) in enumerate(f):
        for e in ((a, b), (b, c), (c, a)):
            edge_faces[(min(e), max(e))].append(fi)

    def support(fi, skip_edge):
        a, b, c = f[fi]
        return sum(
            1
            for e in ((a, b), (b, c), (c, a))
            if (min(e), max(e)) != skip_edge and len(edge_faces[(min(e), max(e))]) == 2
        )

    drop = set()
    for e, fis in edge_faces.items():
        if len(fis) > 2:
            drop.update(sorted(fis, key=lambda i: (-support(i, e), -area[i]))[2:])
    if drop:
        f = f[[i for i in range(len(f)) if i not in drop]]
    m = largest_component(TriMesh(v.astype(np.float32), f.astype(np.int32)))
    m = isosurface.orient_consistently(m)
    # fill boundary loops (edges with one incident face)
    edge_count = defaultdict(int)
    directed = {}
    for a, b, c in m.faces:
        for e in ((a, b), (b, c), (c, a)):
            edge_count[(min(e), max(e))] += 1
            directed[e] = True
    boundary = [e for e, n in edge_count.items() if n == 1]
    if boundary:
        # walk boundary edges against their face's direction
        nxt = {}
        for a, b in boundary:
            if (a, b) in directed:
                nxt[b] = a
            else:
                nxt[a] = b
        new_faces = []
        visited = set()
        for start in list(nxt):
            if start in visited or start not in nxt:
                continue
            loop = [start]
            visited.add(start)
            cur = nxt.get(start)
            while cur is not None and cur != start and cur not in visited:
                loop.append(cur)
                visited.add(cur)
                cur = nxt.get(cur)
            if cur == start and len(loop) >= 3:
                for i in range(1, len(loop) - 1):
                    new_faces.append([loop[0], loop[i], loop[i + 1]])
        if new_faces:
            f2 = np.concatenate([m.faces, np.asarray(new_faces, np.int32)])
            m = isosurface.orient_consistently(TriMesh(m.vertices, f2))
    return m


def _subdivide_longest_edges(mesh: TriMesh, frac: float = 0.25) -> TriMesh:
    """1 → 2 split of the longest ``frac`` of faces at their longest edge's
    midpoint, then :func:`fix_proxy_mesh` for the T-junctions."""
    v = mesh.vertices.astype(np.float64)
    f = mesh.faces
    elen = np.linalg.norm(v[f[:, [1, 2, 0]]] - v[f], axis=-1)  # [F, 3]
    k = max(1, int(len(f) * frac))
    split_set = set(np.argsort(-elen.max(-1))[:k].tolist())
    new_v = list(v)
    new_f = []
    mid_cache = {}

    def midpoint(a, b):
        key = (min(a, b), max(a, b))
        if key not in mid_cache:
            mid_cache[key] = len(new_v)
            new_v.append((v[a] + v[b]) / 2)
        return mid_cache[key]

    for fi, (a, b, c) in enumerate(f):
        if fi not in split_set:
            new_f.append([a, b, c])
            continue
        p, q, r = [(a, b, c), (b, c, a), (c, a, b)][int(np.argmax(elen[fi]))]
        mm = midpoint(p, q)
        new_f += [[p, mm, r], [mm, q, r]]
    return fix_proxy_mesh(TriMesh(np.asarray(new_v, np.float32), np.asarray(new_f, np.int32)))


def refine_cage(cage: TriMesh, points: np.ndarray, device: torch.device, iters: int = 2, margin: float = 0.0) -> TriMesh:
    """Alternately subdivide the coarsest faces and re-tighten containment."""
    for _ in range(max(0, iters)):
        cage = _subdivide_longest_edges(cage, frac=0.2)
        cage = inflate_to_bound(cage, points, device, margin=margin)
    return cage


def compute_proxy_cage(
    selection: np.ndarray,
    level: int,
    device: torch.device,
    target_vertices: int = 100,
    dilation: int = 2,
    coarse_res: int = 32,
    refine_iters: int = 0,
) -> TriMesh:
    """Selection voxels → a ~``target_vertices`` cage that bounds them:
    dilate, downsample, isosurface, decimate, repair, inflate."""
    from scipy import ndimage

    sel = ndimage.binary_dilation(selection, iterations=dilation)
    coarse = ndimage.zoom(sel.astype(np.float32), coarse_res / R, order=1)
    coarse = ndimage.gaussian_filter(coarse, 1.0)
    lo, hi = selection_to_world_box(level)
    spacing = (hi - lo) / coarse_res
    shell = isosurface.marching_tets(coarse, iso=0.3, origin=lo + spacing / 2, spacing=spacing)
    if shell.n_faces == 0:
        raise ValueError("empty selection: no cage")
    shell = largest_component(shell)
    cage = largest_component(vertex_cluster_decimate(shell, target_vertices))
    # consistent outward winding is a hard requirement of MVC
    cage = isosurface.orient_consistently(cage)

    # selection voxel centres in world space
    pts = np.stack(np.nonzero(selection), -1).astype(np.float64)
    pts = lo + (pts + 0.5) * (hi - lo) / R
    if len(pts) > 20000:
        pts = pts[np.random.default_rng(0).choice(len(pts), 20000, replace=False)]
    cage = fix_proxy_mesh(cage)
    margin = float(spacing.min()) * 0.25
    cage = inflate_to_bound(cage, pts, device, margin=margin)
    if refine_iters > 0:
        cage = refine_cage(cage, pts, device, iters=refine_iters, margin=margin)
    return cage


def box_cage(selection: np.ndarray, level: int, margin_cells: float = 2.0) -> TriMesh:
    """Axis-aligned box around the selection."""
    xs, ys, zs = np.nonzero(selection)
    if len(xs) == 0:
        raise ValueError("empty selection")
    lo_w, hi_w = selection_to_world_box(level)
    cell = (hi_w - lo_w) / R
    pmin = lo_w + (np.array([xs.min(), ys.min(), zs.min()]) - margin_cells) * cell
    pmax = lo_w + (np.array([xs.max(), ys.max(), zs.max()]) + 1 + margin_cells) * cell
    return make_box_mesh(pmin, pmax)


def make_box_mesh(pmin, pmax) -> TriMesh:
    pmin = np.asarray(pmin, np.float32)
    pmax = np.asarray(pmax, np.float32)
    corners = np.array(
        [[pmin[0], pmin[1], pmin[2]], [pmax[0], pmin[1], pmin[2]],
         [pmin[0], pmax[1], pmin[2]], [pmax[0], pmax[1], pmin[2]],
         [pmin[0], pmin[1], pmax[2]], [pmax[0], pmin[1], pmax[2]],
         [pmin[0], pmax[1], pmax[2]], [pmax[0], pmax[1], pmax[2]]], np.float32
    )
    faces = np.array(
        [[0, 2, 1], [1, 2, 3], [4, 5, 6], [5, 7, 6], [0, 1, 4], [1, 5, 4],
         [2, 6, 3], [3, 6, 7], [0, 4, 2], [2, 4, 6], [1, 3, 5], [3, 7, 5]], np.int32
    )
    return TriMesh(corners, faces)


def largest_component(mesh: TriMesh) -> TriMesh:
    """Keep the largest face-connected component."""
    if mesh.n_faces == 0:
        return mesh
    parent = np.arange(mesh.n_vertices)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for f in mesh.faces:
        a, b, c = (find(x) for x in f)
        parent[b] = a
        parent[c] = a
    roots = np.array([find(v) for v in range(mesh.n_vertices)])
    face_root = roots[mesh.faces[:, 0]]
    vals, counts = np.unique(face_root, return_counts=True)
    faces = mesh.faces[face_root == vals[np.argmax(counts)]]
    used = np.unique(faces)
    remap = np.full(mesh.n_vertices, -1, np.int64)
    remap[used] = np.arange(len(used))
    return TriMesh(mesh.vertices[used], remap[faces].astype(np.int32))
