"""Tetrahedral proxy mesh and its spatial LUT for the cage deformation.

Counterpart of ``nerfshop_tpu/editing/tet_mesh.py``: the cage interior is
tetrahedralized with scipy's Delaunay over the cage vertices, a jittered
interior grid and points just inside each face, keeping tets whose centroid
lies inside the cage (signed distance on the device, :mod:`..geometry.bvh`);
tet vertices follow the cage through MVC, per-tet rotations come from an
SVD, and a local uniform grid lists each cell's candidate tets.

The LUT is built by the port's native host library (``native.py``,
``voxelize_tets``): tet-bbox overlap refined by the four face planes with a
one-cell near-miss margin, threaded, each cell's tets ascending.
:meth:`TetMesh._voxelize_plain` is the numpy voxelizer of the JAX package
that the tests hold it to: the same per-tet plane test, with the per-cell
lists filled by one stable sort instead of Python appends.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from nerfshop_tpu_torch import native
from nerfshop_tpu_torch.editing.cage import Cage

LUT_RES_DEFAULT = 64
MAX_TETS_PER_CELL = 24


class TetLut(NamedTuple):
    """Local uniform grid → candidate tets, on one device."""

    bbox_lo: torch.Tensor  # [3] f32
    inv_cell: torch.Tensor  # [3] f32
    cells: torch.Tensor  # [res³, MT] int32 tet ids, front-packed, -1 padded
    res: int


class PackedLut(NamedTuple):
    """The LUT in packed (CSR) form, kernel E's input: cell c lists
    ``ids[offsets[c]:offsets[c + 1]]``, the non-negative entries of
    ``TetLut.cells[c]`` in the same order."""

    bbox_lo: torch.Tensor  # [3] f32
    inv_cell: torch.Tensor  # [3] f32
    offsets: torch.Tensor  # [res³ + 1] int32
    ids: torch.Tensor  # [Σ fanout] int32
    res: int
    #: bbox_lo and inv_cell as host floats (the kernel takes them by value)
    box: tuple

    @staticmethod
    def from_lut(lut: TetLut) -> "PackedLut":
        """Pack ``lut`` on its own device (one host read of the box)."""
        keep = lut.cells >= 0
        fan = keep.sum(dim=1, dtype=torch.int32)
        offsets = torch.zeros(fan.shape[0] + 1, dtype=torch.int32, device=fan.device)
        offsets[1:] = torch.cumsum(fan, 0, dtype=torch.int32)
        box = tuple(torch.cat([lut.bbox_lo, lut.inv_cell]).tolist())
        return PackedLut(lut.bbox_lo, lut.inv_cell, offsets, lut.cells[keep].contiguous(), lut.res, box)

    def nbytes(self) -> int:
        return (self.offsets.numel() + self.ids.numel()) * 4


@dataclass
class TetMesh:
    vertices_original: np.ndarray  # [T, 3]
    vertices_deformed: np.ndarray  # [T, 3]
    tets: np.ndarray  # [Nt, 4] int32
    mvc_weights: Optional[np.ndarray] = None  # [T, Vcage]
    boundary_mask: Optional[np.ndarray] = None  # [T] verts on the cage surface
    #: the cage vertex index of tet verts that are cage vertices, else -1;
    #: those follow the cage exactly
    cage_vertex_id: Optional[np.ndarray] = None
    rotations: Optional[np.ndarray] = None  # [Nt, 3, 3] original → deformed

    @property
    def n_tets(self) -> int:
        return len(self.tets)

    # ------------------------------------------------------------------ build

    @staticmethod
    def from_cage(
        cage: Cage, ideal_edge: Optional[float] = None, max_interior_points: int = 20000, *, device: torch.device
    ) -> "TetMesh":
        """Tetrahedralize the cage interior; the signed distances and the MVC
        weights are computed on ``device``."""
        from scipy.spatial import Delaunay

        from nerfshop_tpu_torch.geometry import bvh as bvh_lib

        tris = bvh_lib.build_triangles(cage.vertices_original, cage.faces, device)

        def sdf(pts):
            return bvh_lib.signed_distance(tris, torch.as_tensor(pts, device=device)).cpu().numpy()

        cv = cage.vertices_original
        lo, hi = cv.min(0), cv.max(0)
        diag = float(np.linalg.norm(hi - lo))
        if ideal_edge is None:
            ideal_edge = diag / 8.0

        # interior candidate points on a jittered grid
        ns = np.maximum(((hi - lo) / ideal_edge).astype(int) + 1, 2)
        axes = [lo[k] + (np.arange(ns[k]) + 0.5) / ns[k] * (hi[k] - lo[k]) for k in range(3)]
        gx, gy, gz = np.meshgrid(*axes, indexing="ij")
        pts = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float32)
        rng = np.random.default_rng(0)
        pts += (rng.uniform(-0.1, 0.1, pts.shape) * ideal_edge).astype(np.float32)
        interior = pts[sdf(pts) < -0.05 * ideal_edge]
        if len(interior) > max_interior_points:
            interior = interior[rng.choice(len(interior), max_interior_points, replace=False)]

        # points just inside each face (centre and edge midpoints pushed along
        # −normal), so that concave boundaries get hugging tets
        fv = cv[cage.faces]  # [F, 3, 3]
        fn = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
        fn /= np.linalg.norm(fn, axis=1, keepdims=True) + 1e-12
        push = 0.25 * ideal_edge
        face_pts = [fv.mean(1) - fn * push]
        for a, b in ((0, 1), (1, 2), (2, 0)):
            face_pts.append((fv[:, a] + fv[:, b]) / 2 - fn * push)
        face_pts = np.concatenate(face_pts).astype(np.float32)
        face_pts = face_pts[sdf(face_pts) < 0]

        all_pts = np.concatenate([cv, interior, face_pts]).astype(np.float64)
        tets = Delaunay(all_pts).simplices.astype(np.int32)

        # keep tets whose centroid is inside the cage, with a small halo
        cent = all_pts[tets].mean(1).astype(np.float32)
        tets = tets[sdf(cent) < 0.05 * ideal_edge]

        # drop degenerate tets, then orient positively
        v = all_pts[tets]
        vol = np.einsum("ij,ij->i", np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]), v[:, 3] - v[:, 0]) / 6.0
        tets = tets[np.abs(vol) > 1e-12]
        v = all_pts[tets]
        vol = np.einsum("ij,ij->i", np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]), v[:, 3] - v[:, 0])
        flip = vol < 0
        tets[flip] = tets[flip][:, [0, 1, 3, 2]]

        # keep only referenced vertices
        used = np.unique(tets)
        remap = np.full(len(all_pts), -1, np.int64)
        remap[used] = np.arange(len(used))
        verts = all_pts[used].astype(np.float32)
        tets = remap[tets].astype(np.int32)
        cage_ids = np.full(len(used), -1, np.int64)
        for ci in range(len(cv)):
            ni = remap[ci]
            if ni >= 0:
                cage_ids[ni] = ci

        tm = TetMesh(
            vertices_original=verts,
            vertices_deformed=verts.copy(),
            tets=tets,
            boundary_mask=cage_ids >= 0,
            cage_vertex_id=cage_ids,
        )
        tm.initialize_mvc(cage, device)
        return tm

    # ------------------------------------------------------- deformation flow

    def initialize_mvc(self, cage: Cage, device: torch.device, gamma: float = 1.0) -> None:
        """MVC of every tet vertex w.r.t. the cage."""
        self.mvc_weights = cage.compute_mvc(self.vertices_original, device, gamma=gamma)

    def update_deformed(self, cage: Cage) -> None:
        """Cage moved → tet vertices move by MVC (those that are cage vertices
        follow the cage exactly), rotations are recomputed."""
        if self.mvc_weights is None:
            raise RuntimeError("initialize_mvc first")
        self.vertices_deformed = cage.interpolate_deformed(self.mvc_weights).astype(np.float32)
        if self.cage_vertex_id is not None:
            on_cage = self.cage_vertex_id >= 0
            self.vertices_deformed[on_cage] = cage.vertices_deformed[self.cage_vertex_id[on_cage]]
        self.update_local_rotations()

    def update_local_rotations(self) -> None:
        """Per-tet polar rotation original → deformed (SVD of the edge-frame
        covariance)."""
        vo = self.vertices_original[self.tets]  # [Nt, 4, 3]
        vd = self.vertices_deformed[self.tets]
        eo = vo[:, 1:] - vo[:, :1]
        ed = vd[:, 1:] - vd[:, :1]
        h = np.einsum("nki,nkj->nij", eo, ed)
        u, _, vt = np.linalg.svd(h)
        det = np.linalg.det(np.einsum("nij,njk->nik", u, vt))
        u2 = u.copy()
        u2[:, :, -1] *= np.sign(det)[:, None]
        self.rotations = np.einsum("nij,njk->nik", u2, vt).transpose(0, 2, 1).astype(np.float32)

    # --------------------------------------------------------------- LUT build

    def _box(self, verts: np.ndarray, res: int):
        """(tet vertices [Nt, 4, 3], LUT box lo, inv_cell) of ``verts``."""
        tv = verts[self.tets]  # [Nt, 4, 3]
        lo = tv.min((0, 1)) - 1e-4
        hi = tv.max((0, 1)) + 1e-4
        return tv, lo, res / np.maximum(hi - lo, 1e-9)

    def _voxelize(self, verts: np.ndarray, res: int, max_t: int):
        """Conservative voxelization into a local grid by the native
        library → (bbox_lo, inv_cell, cells [res³, mt] int32, the largest
        fanout seen), mt the observed fanout capped at ``max_t``. A cell
        that lists more than ``max_t`` tets keeps its ``max_t`` lowest, as
        the numpy path does (the library keeps whichever its threads filled
        first, so it runs again at the fanout it saw)."""
        _, lo, inv_cell = self._box(verts, res)
        lo, inv_cell = lo.astype(np.float32), inv_cell.astype(np.float32)
        cells, max_seen = native.voxelize_tets(verts, self.tets, res, lo, inv_cell, max_t)
        if max_seen > max_t:
            cells, _ = native.voxelize_tets(verts, self.tets, res, lo, inv_cell, max_seen)
        mt = min(max(max_seen, 1), max_t)
        return lo, inv_cell, np.ascontiguousarray(cells[:, :mt]), max_seen

    def _voxelize_plain(self, verts: np.ndarray, res: int, max_t: int):
        """The numpy voxelizer: :meth:`_voxelize`'s result without the
        native library."""
        tv, lo, inv_cell = self._box(verts, res)
        cell_size = 1.0 / inv_cell

        # outward face planes: face f is opposite vertex f
        faces = np.array([[1, 2, 3], [0, 3, 2], [0, 1, 3], [0, 2, 1]])
        a = tv[:, faces[:, 0]]  # [Nt, 4, 3]
        n = np.cross(tv[:, faces[:, 1]] - a, tv[:, faces[:, 2]] - a)
        flip = np.einsum("nfd,nfd->nf", n, tv[:, [0, 1, 2, 3]] - a) > 0
        n = np.where(flip[..., None], -n, n)
        d = np.einsum("nfd,nfd->nf", n, a)  # inside: x·n ≤ d

        # one-cell padding keeps the tet a near-miss candidate of its neighbours
        t_lo = np.clip(((tv.min(1) - lo) * inv_cell).astype(int) - 1, 0, res - 1)
        t_hi = np.clip(((tv.max(1) - lo) * inv_cell).astype(int) + 1, 0, res - 1)
        half = cell_size * 0.5
        margin = np.linalg.norm(cell_size)
        hits = []
        for ti in range(len(self.tets)):
            x0, y0, z0 = t_lo[ti]
            x1, y1, z1 = t_hi[ti]
            xs = (np.arange(x0, x1 + 1) + 0.5) * cell_size[0] + lo[0]
            ys = (np.arange(y0, y1 + 1) + 0.5) * cell_size[1] + lo[1]
            zs = (np.arange(z0, z1 + 1) + 0.5) * cell_size[2] + lo[2]
            cx, cy, cz = np.meshgrid(xs, ys, zs, indexing="ij")
            centers = np.stack([cx, cy, cz], -1).reshape(-1, 3)
            nt, dt_ = n[ti], d[ti]
            slack = np.abs(nt) @ half + margin * np.linalg.norm(nt, axis=1)
            keep = np.all(centers @ nt.T - slack[None] <= dt_[None], axis=1)
            ix, iy, iz = np.meshgrid(
                np.arange(x0, x1 + 1), np.arange(y0, y1 + 1), np.arange(z0, z1 + 1), indexing="ij"
            )
            hits.append(((ix * res + iy) * res + iz).reshape(-1)[keep])

        flat = np.concatenate(hits) if hits else np.zeros(0, np.int64)
        owner = np.repeat(np.arange(len(self.tets), dtype=np.int32), [len(h) for h in hits])
        order = np.argsort(flat, kind="stable")  # per cell, tets stay ascending
        flat, owner = flat[order], owner[order]
        counts = np.bincount(flat, minlength=res**3)
        max_seen = int(counts.max()) if len(flat) else 0
        mt = min(max(max_seen, 1), max_t)
        rank = np.arange(len(flat)) - np.repeat(np.cumsum(counts) - counts, counts)
        cells = np.full((res**3, mt), -1, np.int32)
        ok = rank < mt
        cells[flat[ok], rank[ok]] = owner[ok]
        return lo.astype(np.float32), inv_cell.astype(np.float32), cells, max_seen

    def _voxelize_full(self, verts: np.ndarray, res: int, max_t: int, max_t_cap: int = 256):
        """Voxelize, widening the fanout until no cell truncates (up to the cap)."""
        while True:
            lo, ic, cells, max_seen = self._voxelize(verts, res, max_t)
            if max_seen <= max_t or max_t >= max_t_cap:
                if max_seen > max_t:
                    warnings.warn(f"tet LUT fanout {max_seen} exceeds cap {max_t}; some cells truncate")
                return lo, ic, cells
            max_t = min(max(max_seen, max_t * 2), max_t_cap)

    def build_luts(self, device: torch.device, res: int = LUT_RES_DEFAULT, max_t: int = MAX_TETS_PER_CELL):
        """→ (deformed LUT, original LUT) on ``device``."""

        def lut(verts):
            lo, ic, cells = self._voxelize_full(verts, res, max_t)
            return TetLut(
                torch.as_tensor(lo, device=device), torch.as_tensor(ic, device=device),
                torch.as_tensor(cells, device=device), res,
            )

        return lut(self.vertices_deformed), lut(self.vertices_original)

    # ------------------------------------------------------------------- misc

    def device_arrays(self, device: torch.device) -> dict:
        """The per-tet arrays of the warp, as tensors on ``device``."""
        vo = self.vertices_original[self.tets]  # [Nt, 4, 3]
        vd = self.vertices_deformed[self.tets]

        def inv_edges(tv):
            e = np.stack([tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0], tv[:, 3] - tv[:, 0]], -1)
            return np.linalg.inv(e + 1e-12 * np.eye(3)[None])

        rot = self.rotations
        if rot is None:
            rot = np.tile(np.eye(3, dtype=np.float32)[None], (self.n_tets, 1, 1))

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)

        return {
            "v0_def": t(vd[:, 0]),
            "inv_def": t(inv_edges(vd)),
            "v0_orig": t(vo[:, 0]),
            "inv_orig": t(inv_edges(vo)),
            "verts_orig": t(vo),
            "verts_def": t(vd),
            "rot": t(rot),
        }

    def to_json(self) -> dict:
        return {
            "vertices_original": self.vertices_original.tolist(),
            "vertices_deformed": self.vertices_deformed.tolist(),
            "tets": self.tets.tolist(),
            "mvc_weights": None if self.mvc_weights is None else self.mvc_weights.tolist(),
        }

    @staticmethod
    def from_json(d: dict) -> "TetMesh":
        tm = TetMesh(
            np.asarray(d["vertices_original"], np.float32),
            np.asarray(d["vertices_deformed"], np.float32),
            np.asarray(d["tets"], np.int32),
            mvc_weights=None if d.get("mvc_weights") is None else np.asarray(d["mvc_weights"], np.float32),
        )
        tm.update_local_rotations()
        return tm
