"""GrowingSelection: the cage-building pipeline as a state machine.

Counterpart of ``nerfshop_tpu/editing/growing_selection.py``: scribble rays
→ projected cells → grown selection → fine mesh → proxy cage → tet mesh
(+ MVC) → a :class:`~.operators.CageDeformationOp` for the operator stack.
The device work (projection, signed distances, MVC, the membrane) runs on
``device``; the LUT voxelizer, the region growing and ``vanish``'s cell
clearing run in the port's native host library (``native.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Optional

import numpy as np
import torch

from nerfshop_tpu_torch import native
from nerfshop_tpu_torch.editing import poisson
from nerfshop_tpu_torch.editing import selection as sel_lib
from nerfshop_tpu_torch.editing.cage import Cage
from nerfshop_tpu_torch.editing.operators import CageDeformationOp
from nerfshop_tpu_torch.editing.tet_mesh import TetMesh
from nerfshop_tpu_torch.geometry.mesh_io import TriMesh
from nerfshop_tpu_torch.ops import grid as grid_lib


class PipelineStage(Enum):
    ScreenSelection = 0
    Projection = 1
    RegionGrowing = 2
    SelectionMesh = 3
    ProxyMesh = 4
    TetMesh = 5


@dataclass
class GrowingSelection:
    model: object
    aabb: object  # ops.coords.BoundingBox on ``device``
    device: torch.device
    cone_angle: float = 0.0
    stage: PipelineStage = PipelineStage.ScreenSelection

    # pipeline state
    projected_cells: Optional[np.ndarray] = None  # [N, 4] (mip, ix, iy, iz)
    projected_points: Optional[np.ndarray] = None
    region: Optional[sel_lib.RegionGrowing] = None
    fine_mesh: Optional[TriMesh] = None
    proxy_cage: Optional[TriMesh] = None
    cage: Optional[Cage] = None
    tet_mesh: Optional[TetMesh] = None
    copy_mode: bool = False
    #: the Poisson membrane of the deformation it was computed for; kept
    #: across drags until recomputed or cleared, as in the JAX package
    membrane: Optional[poisson.MembraneData] = None

    # knobs
    density_threshold: float = 0.01
    transmittance_threshold: float = 1e-1
    target_cage_vertices: int = 100
    ideal_tet_edge: Optional[float] = None
    mm_size: int = 3

    def project(self, params, grid, origins, directions) -> int:
        """Scribble rays → surface cells; returns the number of hits.
        ``params`` is a state dict of the model (e.g. the EMA copy) or None."""
        hit, pts, cells = sel_lib.project_selection_rays(
            self.model, params, grid, origins, directions, self.aabb, self.cone_angle, self.transmittance_threshold,
        )
        self.projected_points = pts[hit]
        self.projected_cells = np.unique(cells[hit], axis=0)
        self.stage = PipelineStage.Projection
        return int(hit.sum())

    def grow_region(self, grid, n_steps: int = 10000) -> int:
        """Flood fill from the projected cells over the grid's density."""
        if self.projected_cells is None or not len(self.projected_cells):
            raise RuntimeError("project first")
        if self.region is None:
            self.region = sel_lib.RegionGrowing(
                density=grid.density.cpu().numpy(), density_threshold=self.density_threshold
            )
            self.region.reset(self.projected_cells)
        grown = self.region.grow(n_steps)
        self.stage = PipelineStage.RegionGrowing
        return grown

    def set_selection(self, selection: np.ndarray, level: int = 0) -> None:
        """Provide selection voxels directly instead of scribbling."""
        self.region = sel_lib.RegionGrowing(density=np.zeros((level + 1, 128, 128, 128), np.float32))
        self.region.selection = selection.astype(bool)
        self.region.growing_level = level
        self.stage = PipelineStage.RegionGrowing

    def compute_proxy(self, use_box: bool = False) -> TriMesh:
        """Closing → fine mesh → bounding cage."""
        if self.region is None or not self.region.selection.any():
            raise RuntimeError("grow a region first")
        sel = sel_lib.closing(self.region.selection, self.mm_size)
        if not sel.any():
            sel = self.region.selection
        level = self.region.growing_level
        self.fine_mesh = sel_lib.extract_fine_mesh(sel, level)
        if use_box:
            self.proxy_cage = sel_lib.box_cage(sel, level)
        else:
            self.proxy_cage = sel_lib.compute_proxy_cage(sel, level, self.device, self.target_cage_vertices)
        self.stage = PipelineStage.ProxyMesh
        return self.proxy_cage

    def extract_cage(self) -> TetMesh:
        """Tetrahedralize the proxy cage and compute its MVC weights."""
        if self.proxy_cage is None:
            raise RuntimeError("compute proxy first")
        self.cage = Cage.from_mesh(self.proxy_cage)
        self.tet_mesh = TetMesh.from_cage(self.cage, self.ideal_tet_edge, device=self.device)
        self.tet_mesh.update_deformed(self.cage)
        self.stage = PipelineStage.TetMesh
        return self.tet_mesh

    # ------------------------------------------------------------ interaction

    def _require_cage(self) -> None:
        if self.cage is None:
            raise RuntimeError("extract cage first")

    def translate_cage(self, offset, vertex_mask=None) -> None:
        self._require_cage()
        self.cage.translate(offset, vertex_mask)
        self.tet_mesh.update_deformed(self.cage)

    def transform_cage(self, matrix3x4, vertex_mask=None) -> None:
        self._require_cage()
        self.cage.transform(matrix3x4, vertex_mask)
        self.tet_mesh.update_deformed(self.cage)

    def set_cage_vertices(self, vertices: np.ndarray) -> None:
        self._require_cage()
        self.cage.vertices_deformed = np.asarray(vertices, np.float32)
        self.tet_mesh.update_deformed(self.cage)

    def select_cage_vertices(self, indices=None, box=None) -> np.ndarray:
        """Vertex group → bool mask [V]: ``indices``, and/or the vertices of
        the deformed cage inside the world box ``[[lo], [hi]]``."""
        self._require_cage()
        mask = np.zeros(self.cage.n_vertices, bool)
        if indices is not None:
            mask[np.asarray(indices, int)] = True
        if box is not None:
            b = np.asarray(box, np.float32)
            v = self.cage.vertices_deformed
            mask |= np.all((v >= b[0]) & (v <= b[1]), axis=1)
        return mask

    def transform_cage_group(self, indices=None, box=None, rotate_deg=None, scale=None, offset=None) -> None:
        """Rotate (XYZ Euler degrees), scale and translate the selected
        vertex group (all vertices when none is selected) about its centroid."""
        mask = self.select_cage_vertices(indices, box)
        if not mask.any():
            mask = np.ones(self.cage.n_vertices, bool)
        c = self.cage.vertices_deformed[mask].mean(0)
        m = np.eye(3, dtype=np.float32)
        if rotate_deg is not None:
            rx, ry, rz = np.radians(np.asarray(rotate_deg, np.float32))
            cx, sx = np.cos(rx), np.sin(rx)
            cy, sy = np.cos(ry), np.sin(ry)
            cz, sz = np.cos(rz), np.sin(rz)
            Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], np.float32)
            Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
            Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], np.float32)
            m = Rz @ Ry @ Rx
        if scale is not None:
            m = m * np.asarray(scale, np.float32)
        t = c - m @ c + (np.asarray(offset, np.float32) if offset is not None else 0.0)
        self.cage.transform(np.concatenate([m, t[:, None]], 1), vertex_mask=mask)
        self.tet_mesh.update_deformed(self.cage)

    def make_operator(self, lut_res: int = 64) -> CageDeformationOp:
        """The device operator of the current cage (rebuild after every
        manipulation), with the selection's membrane attached when it has one."""
        if self.tet_mesh is None:
            raise RuntimeError("extract cage first")
        op = CageDeformationOp.from_tet_mesh(self.tet_mesh, self.device, copy_mode=self.copy_mode, lut_res=lut_res)
        if self.membrane is not None:
            op = op._replace(membrane=self.membrane)
        return op

    def compute_membrane(self, params, generator: torch.Generator, amplitude: float = 1.0, grid=None) -> None:
        """Compute the Poisson membrane of the CURRENT deformation and keep it
        on the selection (recompute after each manipulation; amplitude 0 or
        :meth:`clear_membrane` turns it off). ``params``: a state dict of the
        model or None; the sphere directions are drawn from ``generator``."""
        if self.tet_mesh is None:
            raise RuntimeError("extract cage first")
        dirs = poisson.membrane_directions(generator, device=self.device)
        self.membrane = poisson.compute_membrane(
            self.model, params, self.cage, self.tet_mesh, self.aabb, dirs, amplitude=amplitude, grid=grid,
        )

    def clear_membrane(self) -> None:
        self.membrane = None

    def vanish(self, grid: grid_lib.OccupancyGrid) -> grid_lib.OccupancyGrid:
        """Vanish!: a new grid whose density is zero in the cells within a
        cell of each deformed tet's bounding box, in every cascade (the
        native library's cell clearing, on a host copy), with its occupancy
        rebuilt. ``grid`` is not changed."""
        if self.tet_mesh is None:
            raise RuntimeError("extract cage first")
        tm = self.tet_mesh
        density = np.ascontiguousarray(grid.density.cpu().numpy(), np.float32).copy()
        Rg = density.shape[1]
        for mip in range(density.shape[0]):
            scale = 2.0**mip
            native.clear_cells_in_tets(tm.vertices_deformed, tm.tets, Rg, 0.5 - scale / 2, scale / Rg, density[mip])
        new = grid_lib.OccupancyGrid(
            torch.as_tensor(density, device=grid.density.device), grid.occupancy.clone(), grid.mean_density.clone()
        )
        return grid_lib.update_bitfield(new)
