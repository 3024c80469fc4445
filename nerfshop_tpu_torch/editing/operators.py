"""Edit operators: the warp stack of the renderer and the grid refresh.

Counterpart of ``nerfshop_tpu/editing/operators.py``. Operators are named
tuples of tensors on one device plus pure functions, applied newest-first:

* ``map_samples(pos, dir) → (pos', dir', empty, in_target)`` warps render
  samples from deformed space back to canonical space and flags vacated
  source samples;
* ``map_positions(pos) → (pos', kill)`` is the position-only form of the
  density-grid refresh.

All positions are world space. The point-in-tet lookup is kernel E
(``csrc/tet_lookup.cu``) on a CUDA device and the per-candidate loop of the
JAX function (:func:`tet_lookup_plain`) on the CPU; the per-tet row takes
of the warp go through kernel D (:mod:`~nerfshop_tpu_torch.ops.gather`).
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from nerfshop_tpu_torch import kernels
from nerfshop_tpu_torch.editing.tet_mesh import TetLut
from nerfshop_tpu_torch.ops.gather import take_rows

# ---------------------------------------------------------------------------
# Cage deformation
# ---------------------------------------------------------------------------


class CageDeformationOp(NamedTuple):
    """Device state of one cage-deformation edit."""

    lut_def: TetLut
    lut_orig: TetLut
    v0_def: torch.Tensor  # [Nt, 3]
    inv_def: torch.Tensor  # [Nt, 3, 3]
    v0_orig: torch.Tensor
    inv_orig: torch.Tensor
    verts_orig: torch.Tensor  # [Nt, 4, 3]
    verts_def: torch.Tensor  # [Nt, 4, 3]
    rot: torch.Tensor  # [Nt, 3, 3] original → deformed rotation
    copy_mode: bool  # a copy keeps the source visible
    #: the JAX package's Poisson membrane; no operator of the port carries
    #: one (``editing/poisson.py`` is not ported), and the renderer raises
    #: on one that does
    membrane: object = None

    @staticmethod
    def from_tet_mesh(tet_mesh, device: torch.device, copy_mode: bool = False, lut_res: int = 64) -> "CageDeformationOp":
        lut_d, lut_o = tet_mesh.build_luts(device, res=lut_res)
        arrs = tet_mesh.device_arrays(device)
        return CageDeformationOp(lut_def=lut_d, lut_orig=lut_o, copy_mode=bool(copy_mode), **arrs)


#: the per-tet tensors of a CageDeformationOp
CAGE_ARRAYS = ("v0_def", "inv_def", "v0_orig", "inv_orig", "verts_orig", "verts_def", "rot")


def _threshold(eps: float, near_miss: float) -> float:
    return eps if eps > 0 else -near_miss


def _bary_rows(table: torch.Tensor, p: torch.Tensor):
    """Barycentrics of ``p`` [N, 3] in the tets of ``table`` rows [N, 12]
    ([v0 | inv_e row-major]), each product and sum rounded on its own."""
    db = p - table[:, 0:3]
    w1 = table[:, 3] * db[:, 0] + table[:, 4] * db[:, 1] + table[:, 5] * db[:, 2]
    w2 = table[:, 6] * db[:, 0] + table[:, 7] * db[:, 1] + table[:, 8] * db[:, 2]
    w3 = table[:, 9] * db[:, 0] + table[:, 10] * db[:, 1] + table[:, 11] * db[:, 2]
    return ((1.0 - w1) - w2) - w3, w1, w2, w3


def tet_lookup_plain(lut: TetLut, table: torch.Tensor, p: torch.Tensor, threshold: float):
    """Plain version of kernel E: the JAX per-candidate loop with a running
    best (strict ``>``, so the earliest candidate wins a tie). ``table``
    [Nt, 12] = [v0 | inv_e]. Column c scores only the points whose cell
    lists more than c candidates (JAX scores the rest −∞, which never wins),
    and the loop ends at the first column that no point reaches."""
    res = lut.res
    cell = torch.floor((p - lut.bbox_lo) * lut.inv_cell).to(torch.int64)
    inb = ((cell >= 0) & (cell < res)).all(dim=-1)
    cell = torch.clamp(cell, 0, res - 1)
    cand = lut.cells[(cell[:, 0] * res + cell[:, 1]) * res + cell[:, 2]]  # [N, MT]
    best = torch.full((p.shape[0],), float("-inf"), device=p.device)
    best_t = torch.zeros((p.shape[0],), dtype=torch.int32, device=p.device)
    for c in range(cand.shape[1]):
        act = torch.nonzero((cand[:, c] >= 0) & inb).squeeze(1)
        if act.numel() == 0:
            break
        tid = cand[act, c]
        w0, w1, w2, w3 = _bary_rows(table[tid.long()], p[act])
        score = torch.minimum(torch.minimum(w0, w1), torch.minimum(w2, w3))
        take = score > best[act]
        best[act] = torch.where(take, score, best[act])
        best_t[act] = torch.where(take, tid, best_t[act])
    found = best >= threshold
    bary = torch.stack(_bary_rows(table[best_t.long()], p), dim=-1)
    return found, best_t, bary


def tet_lookup_cuda(lut: TetLut, table: torch.Tensor, p: torch.Tensor, threshold: float):
    """Kernel E: one thread per point walks its own cell's candidates up to
    the first −1 → (found [N] bool, tet [N] int32, bary [N, 4] f32)."""
    dev = p.device
    if dev.type != "cuda":
        raise ValueError(f"tet lookup kernel: p on {dev}, expected a CUDA device")
    N = p.shape[0]
    n_cells = lut.res**3
    kernels.require(lut.cells, "cells", torch.int32, (n_cells, lut.cells.shape[1]), dev)
    kernels.require(lut.bbox_lo, "bbox_lo", torch.float32, (3,), dev)
    kernels.require(lut.inv_cell, "inv_cell", torch.float32, (3,), dev)
    kernels.require(table, "table", torch.float32, (table.shape[0], 12), dev)
    kernels.require(p, "p", torch.float32, (N, 3), dev)
    found = torch.empty((N,), dtype=torch.bool, device=dev)
    tet = torch.empty((N,), dtype=torch.int32, device=dev)
    bary = torch.empty((N, 4), dtype=torch.float32, device=dev)
    err = kernels.load().nst_tet_lookup(
        lut.cells.data_ptr(), lut.bbox_lo.data_ptr(), lut.inv_cell.data_ptr(), table.data_ptr(), p.data_ptr(),
        found.data_ptr(), tet.data_ptr(), bary.data_ptr(), N, lut.res, lut.cells.shape[1], float(threshold),
        kernels.stream_ptr(dev),
    )
    kernels.check(err, "tet_lookup")
    tet_lookup_cuda.launches += 1
    return found, tet, bary


#: launches of kernel E since the last reset
tet_lookup_cuda.launches = 0


def tet_lookup(lut: TetLut, v0: torch.Tensor, inv_e: torch.Tensor, p: torch.Tensor, eps: float = -1e-5, near_miss: float = 0.08):
    """p [N, 3] → (found [N], tet [N] int32, bary [N, 4]) in the given tets.

    ``eps`` is the containment margin: negative is inclusive (the warp),
    positive is strict (the emptying test). Points in no tet but within
    ``near_miss`` barycentric distance of one resolve to their best
    candidate (extrapolated barycentrics), unless ``eps`` > 0. Nothing
    found gives tet 0 and tet 0's barycentrics, as in JAX."""
    table = torch.cat([v0, inv_e.reshape(-1, 9)], dim=1)
    threshold = _threshold(eps, near_miss)
    if p.device.type == "cpu":
        return tet_lookup_plain(lut, table, p, threshold)
    return tet_lookup_cuda(lut, table.contiguous(), p.contiguous(), threshold)


def _bary_delta(vert_delta: torch.Tensor, tet: torch.Tensor, bary: torch.Tensor) -> torch.Tensor:
    """Σ_k bary_k · vert_delta[tet, k], the per-tet deltas taken as [Nt, 12]
    rows (kernel D's row take on a CUDA device)."""
    rows = take_rows(vert_delta.reshape(-1, 12).contiguous(), tet)  # [N, 12]
    return sum(bary[:, k : k + 1] * rows[:, 3 * k : 3 * k + 3] for k in range(4))


def _rotate_back(rot: torch.Tensor, tet: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """Rᵀ·dir with each tet's rotation row [Nt, 9] (kernel D's row take),
    normalized."""
    r = take_rows(rot.reshape(-1, 9).contiguous(), tet)  # [N, 9] row-major
    new_dir = torch.stack([(r[:, i::3] * direction).sum(dim=1) for i in range(3)], dim=-1)
    return new_dir / (torch.linalg.norm(new_dir, dim=-1, keepdim=True) + 1e-12)


def cage_map_samples(op: CageDeformationOp, pos: torch.Tensor, direction: torch.Tensor):
    """Backward warp of render samples: deformed-space sample → canonical
    position + rotated direction; vacated source samples are flagged empty
    (unless copy mode). The warp is in delta form, canonical = p +
    Σᵢ baryᵢ·(voᵢ − vdᵢ), which moves nothing for an identity cage."""
    in_target, tet, bary = tet_lookup(op.lut_def, op.v0_def, op.inv_def, pos)
    canonical = pos + _bary_delta(op.verts_orig - op.verts_def, tet, bary)
    new_dir = _rotate_back(op.rot, tet, direction)
    pos_out = torch.where(in_target[:, None], canonical, pos)
    dir_out = torch.where(in_target[:, None], new_dir, direction)
    # strict margin: only clearly interior source points are emptied
    in_source, _, _ = tet_lookup(op.lut_orig, op.v0_orig, op.inv_orig, pos, eps=5e-3)
    empty = in_source & ~in_target & (not op.copy_mode)
    return pos_out, dir_out, empty, in_target


def cage_map_positions(op: CageDeformationOp, pos: torch.Tensor):
    """Position-only warp for the grid refresh → (pos', kill)."""
    in_target, tet, bary = tet_lookup(op.lut_def, op.v0_def, op.inv_def, pos)
    delta = _bary_delta(op.verts_orig - op.verts_def, tet, bary)
    pos_out = torch.where(in_target[:, None], pos + delta, pos)
    in_source, _, _ = tet_lookup(op.lut_orig, op.v0_orig, op.inv_orig, pos, eps=5e-3)
    kill = in_source & ~in_target & (not op.copy_mode)
    return pos_out, kill


def cage_in_source(op: CageDeformationOp, pos: torch.Tensor) -> torch.Tensor:
    found, _, _ = tet_lookup(op.lut_orig, op.v0_orig, op.inv_orig, pos)
    return found


def cage_map_forward(op: CageDeformationOp, pos: torch.Tensor):
    """Canonical → deformed (the distiller's direction) → (pos', in_source)."""
    in_source, tet, bary = tet_lookup(op.lut_orig, op.v0_orig, op.inv_orig, pos)
    delta = _bary_delta(op.verts_def - op.verts_orig, tet, bary)
    return torch.where(in_source[:, None], pos + delta, pos), in_source


# ---------------------------------------------------------------------------
# Affine duplication
# ---------------------------------------------------------------------------


class AffineDuplicationOp(NamedTuple):
    """Box select → affine duplicate."""

    box_center: torch.Tensor  # [3] source box centre
    box_rot: torch.Tensor  # [3, 3] source box orientation (rows = axes)
    box_half: torch.Tensor  # [3] half extents
    transform_rot: torch.Tensor  # [3, 3] source → target rotation·scale
    transform_t: torch.Tensor  # [3] source → target translation
    hide_original: bool

    @staticmethod
    def create(
        center, half_extents, *, device: torch.device, rotation=None, transform_rot=None, transform_t=None,
        hide_original: bool = False,
    ) -> "AffineDuplicationOp":
        eye = np.eye(3, dtype=np.float32)

        def t(a, default):
            return torch.as_tensor(np.asarray(default if a is None else a, np.float32), device=device)

        return AffineDuplicationOp(
            box_center=t(center, None),
            box_rot=t(rotation, eye),
            box_half=t(half_extents, None),
            transform_rot=t(transform_rot, eye),
            transform_t=t(transform_t, np.zeros(3, np.float32)),
            hide_original=bool(hide_original),
        )

    def _in_box(self, p: torch.Tensor) -> torch.Tensor:
        local = (p - self.box_center) @ self.box_rot.T
        return (local.abs() <= self.box_half).all(dim=-1)

    def _inv_rot(self) -> torch.Tensor:
        # inv_ex: no singularity check, which would wait for the device
        return torch.linalg.inv_ex(self.transform_rot).inverse

    def _to_source(self, p: torch.Tensor) -> torch.Tensor:
        """Inverse affine: target-space point → source-space point."""
        return (p - self.transform_t) @ self._inv_rot().T


#: the tensors of an AffineDuplicationOp
AFFINE_ARRAYS = ("box_center", "box_rot", "box_half", "transform_rot", "transform_t")


def affine_map_samples(op: AffineDuplicationOp, pos: torch.Tensor, direction: torch.Tensor):
    src = op._to_source(pos)
    in_target = op._in_box(src)
    new_dir = direction @ op._inv_rot().T
    new_dir = new_dir / (torch.linalg.norm(new_dir, dim=-1, keepdim=True) + 1e-12)
    pos_out = torch.where(in_target[:, None], src, pos)
    dir_out = torch.where(in_target[:, None], new_dir, direction)
    empty = op._in_box(pos) & ~in_target & op.hide_original
    return pos_out, dir_out, empty, in_target


def affine_map_positions(op: AffineDuplicationOp, pos: torch.Tensor):
    src = op._to_source(pos)
    in_target = op._in_box(src)
    pos_out = torch.where(in_target[:, None], src, pos)
    kill = op._in_box(pos) & ~in_target & op.hide_original
    return pos_out, kill


# ---------------------------------------------------------------------------
# Operator stack
# ---------------------------------------------------------------------------


def apply_operator_samples(op, pos, direction):
    if isinstance(op, CageDeformationOp):
        return cage_map_samples(op, pos, direction)
    if isinstance(op, AffineDuplicationOp):
        return affine_map_samples(op, pos, direction)
    raise TypeError(type(op))


def apply_operator_positions(op, pos):
    if isinstance(op, CageDeformationOp):
        return cage_map_positions(op, pos)
    if isinstance(op, AffineDuplicationOp):
        return affine_map_positions(op, pos)
    raise TypeError(type(op))


def map_samples_through_stack(operators: List, pos: torch.Tensor, direction: torch.Tensor):
    """Apply the operators newest-first → (pos, dir, empty)."""
    empty = torch.zeros(pos.shape[0], dtype=torch.bool, device=pos.device)
    for op in reversed(operators):
        pos, direction, e, _ = apply_operator_samples(op, pos, direction)
        empty |= e
    return pos, direction, empty


def map_positions_through_stack(operators: List, pos: torch.Tensor):
    """Apply the operators newest-first → (pos, kill)."""
    kill = torch.zeros(pos.shape[0], dtype=torch.bool, device=pos.device)
    for op in reversed(operators):
        pos, k = apply_operator_positions(op, pos)
        kill |= k
    return pos, kill


def operator_roi_aabb(op) -> Tuple[np.ndarray, np.ndarray]:
    """World-space AABB of everything the operator can affect: for a cage,
    the boxes of its deformed and original LUTs; for an affine duplicate,
    the source box and its image."""
    if isinstance(op, CageDeformationOp):

        def box(lut):
            lo = lut.bbox_lo.cpu().numpy().astype(np.float32)
            return lo, lo + lut.res / lut.inv_cell.cpu().numpy().astype(np.float32)

        lo_d, hi_d = box(op.lut_def)
        lo_o, hi_o = box(op.lut_orig)
        return np.minimum(lo_d, lo_o), np.maximum(hi_d, hi_o)
    if isinstance(op, AffineDuplicationOp):
        rot = op.box_rot.cpu().numpy()
        signs = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], np.float32)
        corners = op.box_center.cpu().numpy() + (signs * op.box_half.cpu().numpy()) @ rot
        tgt = corners @ op.transform_rot.cpu().numpy().T + op.transform_t.cpu().numpy()
        both = np.concatenate([corners, tgt])
        return both.min(0), both.max(0)
    raise TypeError(type(op))
