"""Edit operators: the warp stack of the renderer and the grid refresh.

Counterpart of ``nerfshop_tpu/editing/operators.py``. Operators are named
tuples of tensors on one device plus pure functions, applied newest-first:

* ``map_samples(pos, dir) → (pos', dir', empty, in_target)`` warps render
  samples from deformed space back to canonical space and flags vacated
  source samples;
* ``map_positions(pos) → (pos', kill)`` is the position-only form of the
  density-grid refresh.

All positions are world space. On a CUDA device the cage operator runs
kernel E (``csrc/tet_lookup.cu``): the whole sample warp
(:func:`cage_map_samples`), the whole position warp
(:func:`cage_map_positions`) and the sample warp with the membrane's
residuals (:func:`cage_map_membrane`) are one launch each, and the lookups
of :func:`cage_in_source` and :func:`cage_map_forward` its ``LOOKUP``
instance. The kernel reads the operator's packed form
(:class:`PackedCage`), made once where the operator is made, and the
membrane's packed rows (``editing/poisson.py``). On the CPU the same
functions run the plain composition of the JAX function
(:func:`tet_lookup_plain` and the per-tet row takes).
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from nerfshop_tpu_torch import kernels
from nerfshop_tpu_torch.editing import poisson
from nerfshop_tpu_torch.editing.tet_mesh import PackedLut, TetLut
from nerfshop_tpu_torch.ops.gather import take_rows

# ---------------------------------------------------------------------------
# Cage deformation
# ---------------------------------------------------------------------------

#: the near-miss margin of the inclusive lookups and the strict margin of
#: the emptying test (the JAX defaults)
NEAR_MISS = 0.08
INCLUSIVE_EPS = -1e-5
STRICT_EPS = 5e-3

#: the sections of :attr:`PackedCage.records`, each [Nt, 12] f32 (48-byte
#: rows, whole float4s): the lookup rows [v0 | inv_e row-major] of the
#: deformed and of the original tets, the vertex deltas vo − vd, the
#: rotations row-major with 3 floats of padding
REC_DEF, REC_ORIG, REC_DELTA, REC_ROT = 0, 1, 2, 3


class PackedCage(NamedTuple):
    """Kernel E's form of a cage operator: both LUTs packed, and every
    tet's rows in the four sections of one tensor."""

    lut_def: PackedLut
    lut_orig: PackedLut
    records: torch.Tensor  # [4, Nt, 12] f32, sections REC_*


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
    #: an optional ``poisson.MembraneData``: per-tet-corner residuals added
    #: to the samples in the deformed region
    membrane: Optional[poisson.MembraneData] = None
    #: kernel E's packed form (:meth:`create` makes it); the CPU paths do
    #: not read it
    packed: Optional[PackedCage] = None

    @staticmethod
    def create(lut_def: TetLut, lut_orig: TetLut, copy_mode: bool, **arrays) -> "CageDeformationOp":
        """The operator of these LUTs and per-tet arrays (``CAGE_ARRAYS``),
        with its packed form."""
        op = CageDeformationOp(lut_def=lut_def, lut_orig=lut_orig, copy_mode=bool(copy_mode), **arrays)
        return op._replace(packed=pack_cage(op))

    @staticmethod
    def from_tet_mesh(tet_mesh, device: torch.device, copy_mode: bool = False, lut_res: int = 64) -> "CageDeformationOp":
        lut_d, lut_o = tet_mesh.build_luts(device, res=lut_res)
        return CageDeformationOp.create(lut_d, lut_o, copy_mode, **tet_mesh.device_arrays(device))


#: the per-tet tensors of a CageDeformationOp
CAGE_ARRAYS = ("v0_def", "inv_def", "v0_orig", "inv_orig", "verts_orig", "verts_def", "rot")


def pack_cage(op: CageDeformationOp) -> PackedCage:
    """Both LUTs in packed form and the per-tet records (see ``REC_*``)."""
    nt = op.v0_def.shape[0]
    records = torch.stack([
        _table(op.v0_def, op.inv_def), _table(op.v0_orig, op.inv_orig), (op.verts_orig - op.verts_def).reshape(nt, 12),
        torch.cat([op.rot.reshape(nt, 9), op.rot.new_zeros((nt, 3))], dim=1),
    ])
    return PackedCage(PackedLut.from_lut(op.lut_def), PackedLut.from_lut(op.lut_orig), records.contiguous())


def _table(v0: torch.Tensor, inv_e: torch.Tensor) -> torch.Tensor:
    """The lookup rows [v0 | inv_e row-major] [Nt, 12]."""
    return torch.cat([v0, inv_e.reshape(-1, 9)], dim=1)


def _threshold(eps: float, near_miss: float = NEAR_MISS) -> float:
    return eps if eps > 0 else -near_miss


def _bary_rows(table: torch.Tensor, p: torch.Tensor):
    """Barycentrics of ``p`` [N, 3] in the tets of ``table`` rows [N, 12]
    ([v0 | inv_e row-major]), each product and sum rounded on its own."""
    db = p - table[:, 0:3]
    w1 = table[:, 3] * db[:, 0] + table[:, 4] * db[:, 1] + table[:, 5] * db[:, 2]
    w2 = table[:, 6] * db[:, 0] + table[:, 7] * db[:, 1] + table[:, 8] * db[:, 2]
    w3 = table[:, 9] * db[:, 0] + table[:, 10] * db[:, 1] + table[:, 11] * db[:, 2]
    return ((1.0 - w1) - w2) - w3, w1, w2, w3


def _cells(lut, p: torch.Tensor):
    """(flat cell index clamped to the grid [N] int64, in the LUT box [N])."""
    res = lut.res
    cell = torch.floor((p - lut.bbox_lo) * lut.inv_cell).to(torch.int64)
    inb = ((cell >= 0) & (cell < res)).all(dim=-1)
    cell = torch.clamp(cell, 0, res - 1)
    return (cell[:, 0] * res + cell[:, 1]) * res + cell[:, 2], inb


def _running_best(p: torch.Tensor, table: torch.Tensor, columns, threshold: float):
    """The JAX candidate loop: ``columns`` yields (points [M] int64, their
    candidate tets [M]) per candidate position; a running best with a strict
    ``>`` (the earliest candidate wins a tie, NaN never wins) → (found,
    tet int32, bary [N, 4])."""
    best = torch.full((p.shape[0],), float("-inf"), device=p.device)
    best_t = torch.zeros((p.shape[0],), dtype=torch.int32, device=p.device)
    for act, tid in columns:
        w0, w1, w2, w3 = _bary_rows(table[tid.long()], p[act])
        score = torch.minimum(torch.minimum(w0, w1), torch.minimum(w2, w3))
        take = score > best[act]
        best[act] = torch.where(take, score, best[act])
        best_t[act] = torch.where(take, tid, best_t[act])
    found = best >= threshold
    bary = torch.stack(_bary_rows(table[best_t.long()], p), dim=-1)
    return found, best_t, bary


def tet_lookup_plain(lut: TetLut, table: torch.Tensor, p: torch.Tensor, threshold: float):
    """Plain version of kernel E's lookup over the padded LUT: the JAX
    per-candidate loop. ``table`` [Nt, 12] = [v0 | inv_e]. Column c scores
    only the points whose cell lists more than c candidates (JAX scores the
    rest −∞, which never wins), and the loop ends at the first column that
    no point reaches."""
    ci, inb = _cells(lut, p)
    cand = lut.cells[ci]  # [N, MT]

    def columns():
        for c in range(cand.shape[1]):
            act = torch.nonzero((cand[:, c] >= 0) & inb).squeeze(1)
            if act.numel() == 0:
                return
            yield act, cand[act, c]

    return _running_best(p, table, columns(), threshold)


def tet_lookup_packed_plain(lut: PackedLut, table: torch.Tensor, p: torch.Tensor, threshold: float):
    """Plain version of kernel E's lookup over the packed LUT: the same loop,
    candidate c of a point read at ``ids[offsets[cell] + c]``."""
    ci, inb = _cells(lut, p)
    start = lut.offsets[ci].long()
    fan = torch.where(inb, lut.offsets[ci + 1].long() - start, torch.zeros_like(start))

    def columns():
        c = 0
        while True:
            act = torch.nonzero(fan > c).squeeze(1)
            if act.numel() == 0:
                return
            yield act, lut.ids[start[act] + c]
            c += 1

    return _running_best(p, table, columns(), threshold)


#: the kernel's template instances (``enum Mode`` of ``csrc/tet_lookup.cu``)
LOOKUP, WARP_SAMPLES, WARP_POSITIONS, WARP_MEMBRANE = 0, 1, 2, 3


def _lut_args(lut: PackedLut, rows: torch.Tensor, threshold: float, dev: torch.device) -> kernels.LutArgs:
    kernels.require(lut.offsets, "offsets", torch.int32, (lut.res**3 + 1,), dev)
    kernels.require(lut.ids, "ids", torch.int32, (lut.ids.shape[0],), dev)
    kernels.require(rows, "rows", torch.float32, (rows.shape[0], 12), dev)
    if rows.shape[0] == 0 or not kernels.aligned16(rows):
        raise ValueError("tet lookup kernel: the rows must hold a tet and start on a 16-byte boundary")
    return kernels.LutArgs(lut.offsets.data_ptr(), lut.ids.data_ptr(), rows.data_ptr(), (ctypes.c_float * 6)(*lut.box),
                           lut.res, threshold)


def _launch(mode: int, a: kernels.LutArgs, b: Optional[kernels.LutArgs], p: torch.Tensor, name: str,
            copy_mode: bool = False, amplitude: float = 0.0, **tensors) -> None:
    """Check ``p``, then launch kernel E's ``mode`` instance on it and
    ``tensors`` (by their ``struct CageArgs`` names)."""
    dev = p.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: p on {dev}, expected a CUDA device")
    N = p.shape[0]
    kernels.require(p, "p", torch.float32, (N, 3), dev)
    args = kernels.CageArgs(a=a, b=b or kernels.LutArgs(), p=p.data_ptr(), n=N, copy_mode=int(copy_mode),
                            amplitude=amplitude, **{k: v.data_ptr() for k, v in tensors.items()})
    kernels.check(kernels.load().nst_cage(ctypes.byref(args), mode, kernels.stream_ptr(dev)), name)


@kernels.counted("launches")
def tet_lookup_cuda(lut: PackedLut, rows: torch.Tensor, p: torch.Tensor, threshold: float):
    """Kernel E, ``LOOKUP`` instance: the point-in-tet lookup of ``p`` [N, 3]
    in the packed ``lut`` over the lookup ``rows`` [Nt, 12] (a section of
    :attr:`PackedCage.records`) → (found [N] bool, tet [N] int32, bary [N, 4]
    f32), as :func:`tet_lookup_plain`."""
    dev = p.device
    N = p.shape[0]
    found = torch.empty((N,), dtype=torch.bool, device=dev)
    tet = torch.empty((N,), dtype=torch.int32, device=dev)
    bary = torch.empty((N, 4), dtype=torch.float32, device=dev)
    _launch(LOOKUP, _lut_args(lut, rows, threshold, dev), None, p, "tet_lookup", flag0=found, tet=tet, bary=bary)
    tet_lookup_cuda.launches += 1
    return found, tet, bary


def _packed(op: CageDeformationOp) -> PackedCage:
    if op.packed is None:
        raise ValueError("kernel E: the operator has no packed form (make it with CageDeformationOp.create)")
    return op.packed


def _warp_args(op: CageDeformationOp, dev: torch.device):
    """(deformed LUT, original LUT, deltas, rotations) of a warp launch."""
    pk = _packed(op)
    rec = pk.records
    kernels.require(rec, "records", torch.float32, (4, rec.shape[1], 12), dev)
    return (
        _lut_args(pk.lut_def, rec[REC_DEF], _threshold(INCLUSIVE_EPS), dev),
        _lut_args(pk.lut_orig, rec[REC_ORIG], _threshold(STRICT_EPS), dev),
        rec[REC_DELTA], rec[REC_ROT],
    )


@kernels.counted("launches")
def cage_warp_samples_cuda(op: CageDeformationOp, pos: torch.Tensor, direction: torch.Tensor):
    """Kernel E, ``WARP_SAMPLES`` instance: the whole of
    :func:`cage_map_samples` in one launch → (pos' [N, 3], dir' [N, 3],
    empty [N], in_target [N])."""
    dev = pos.device
    N = pos.shape[0]
    kernels.require(direction, "direction", torch.float32, (N, 3), dev)
    a, b, deltas, rots = _warp_args(op, dev)
    pos_out = torch.empty_like(pos)
    dir_out = torch.empty_like(direction)
    empty = torch.empty((N,), dtype=torch.bool, device=dev)
    in_target = torch.empty((N,), dtype=torch.bool, device=dev)
    _launch(WARP_SAMPLES, a, b, pos, "cage_warp_samples", copy_mode=op.copy_mode, deltas=deltas, rots=rots,
            dir=direction, pos_out=pos_out, dir_out=dir_out, flag0=empty, flag1=in_target)
    cage_warp_samples_cuda.launches += 1
    return pos_out, dir_out, empty, in_target


def _membrane(op: CageDeformationOp) -> poisson.MembraneData:
    m = op.membrane
    if not isinstance(m, poisson.MembraneData):
        raise TypeError(f"the operator's membrane is a {type(m).__name__}, expected poisson.MembraneData")
    return m


@kernels.counted("launches")
def cage_warp_membrane_cuda(op: CageDeformationOp, pos: torch.Tensor, direction: torch.Tensor,
                            acc_sigma: torch.Tensor, acc_out: torch.Tensor, acc_rgb: torch.Tensor):
    """Kernel E, ``WARP_MEMBRANE`` instance: :func:`cage_warp_samples_cuda`
    in one launch, which also ADDS the membrane's residual σ, outside σ and
    residual rgb of each in-target point into ``acc_sigma`` [N],
    ``acc_out`` [N] and ``acc_rgb`` [N, 3] → (pos', dir', empty, in_target)."""
    dev = pos.device
    N = pos.shape[0]
    kernels.require(direction, "direction", torch.float32, (N, 3), dev)
    kernels.require(acc_sigma, "acc_sigma", torch.float32, (N,), dev)
    kernels.require(acc_out, "acc_out", torch.float32, (N,), dev)
    kernels.require(acc_rgb, "acc_rgb", torch.float32, (N, 3), dev)
    a, b, deltas, rots = _warp_args(op, dev)
    m = _membrane(op)
    if m.packed is None:
        raise ValueError("kernel E: the membrane has no packed form (make it with MembraneData.create)")
    kernels.require(m.packed, "membrane", torch.float32, (deltas.shape[0], poisson.PACKED_WIDTH), dev)
    if not kernels.aligned16(m.packed):
        raise ValueError("kernel E: the membrane rows must start on a 16-byte boundary")
    pos_out = torch.empty_like(pos)
    dir_out = torch.empty_like(direction)
    empty = torch.empty((N,), dtype=torch.bool, device=dev)
    in_target = torch.empty((N,), dtype=torch.bool, device=dev)
    _launch(WARP_MEMBRANE, a, b, pos, "cage_warp_membrane", copy_mode=op.copy_mode, amplitude=m.amplitude,
            deltas=deltas, rots=rots, dir=direction, pos_out=pos_out, dir_out=dir_out, flag0=empty, flag1=in_target,
            membrane=m.packed, acc_sigma=acc_sigma, acc_out=acc_out, acc_rgb=acc_rgb)
    cage_warp_membrane_cuda.launches += 1
    return pos_out, dir_out, empty, in_target


@kernels.counted("launches")
def cage_warp_positions_cuda(op: CageDeformationOp, pos: torch.Tensor):
    """Kernel E, ``WARP_POSITIONS`` instance: the whole of
    :func:`cage_map_positions` in one launch → (pos' [N, 3], kill [N])."""
    dev = pos.device
    a, b, deltas, _ = _warp_args(op, dev)
    pos_out = torch.empty_like(pos)
    kill = torch.empty((pos.shape[0],), dtype=torch.bool, device=dev)
    _launch(WARP_POSITIONS, a, b, pos, "cage_warp_positions", copy_mode=op.copy_mode, deltas=deltas, pos_out=pos_out,
            flag0=kill)
    cage_warp_positions_cuda.launches += 1
    return pos_out, kill


def tet_lookup(lut: TetLut, v0: torch.Tensor, inv_e: torch.Tensor, p: torch.Tensor, eps: float = INCLUSIVE_EPS,
               near_miss: float = NEAR_MISS):
    """p [N, 3] → (found [N], tet [N] int32, bary [N, 4]) in the given tets.

    ``eps`` is the containment margin: negative is inclusive (the warp),
    positive is strict (the emptying test). Points in no tet but within
    ``near_miss`` barycentric distance of one resolve to their best
    candidate (extrapolated barycentrics), unless ``eps`` > 0. Nothing
    found gives tet 0 and tet 0's barycentrics, as in JAX. On a CUDA device
    this packs ``lut`` and the rows on every call before kernel E's lookup;
    the operators' own functions read the packed form they were made with."""
    table = _table(v0, inv_e)
    threshold = _threshold(eps, near_miss)
    if p.device.type == "cpu":
        return tet_lookup_plain(lut, table, p, threshold)
    return tet_lookup_cuda(PackedLut.from_lut(lut), table.contiguous(), p.contiguous(), threshold)


def _source_lookup(op: CageDeformationOp, p: torch.Tensor):
    """The inclusive lookup of ``p`` in the operator's original tets."""
    threshold = _threshold(INCLUSIVE_EPS)
    if p.device.type == "cpu":
        return tet_lookup_plain(op.lut_orig, _table(op.v0_orig, op.inv_orig), p, threshold)
    pk = _packed(op)
    return tet_lookup_cuda(pk.lut_orig, pk.records[REC_ORIG], p.contiguous(), threshold)


def _bary_delta(rows: torch.Tensor, bary: torch.Tensor) -> torch.Tensor:
    """Σ_k bary_k · delta_k for per-point delta rows [N, 12] (the four
    vertex deltas of each point's tet), summed from 0 in k order."""
    return sum(bary[:, k : k + 1] * rows[:, 3 * k : 3 * k + 3] for k in range(4))


def _rotate_back(r: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """Rᵀ·dir for per-point rotation rows [N, 9] (row-major), normalized."""
    new_dir = torch.stack([(r[:, i::3] * direction).sum(dim=1) for i in range(3)], dim=-1)
    return new_dir / (torch.linalg.norm(new_dir, dim=-1, keepdim=True) + 1e-12)


def cage_map_samples_plain(op: CageDeformationOp, pos: torch.Tensor, direction: torch.Tensor):
    """Plain version of the ``WARP_SAMPLES`` instance: the JAX composition
    (two lookups over the padded LUTs, the per-tet row takes, the
    elementwise warp), with no kernel on any device."""
    in_target, tet, bary = tet_lookup_plain(op.lut_def, _table(op.v0_def, op.inv_def), pos, _threshold(INCLUSIVE_EPS))
    t = tet.long()
    canonical = pos + _bary_delta((op.verts_orig - op.verts_def).reshape(-1, 12)[t], bary)
    new_dir = _rotate_back(op.rot.reshape(-1, 9)[t], direction)
    pos_out = torch.where(in_target[:, None], canonical, pos)
    dir_out = torch.where(in_target[:, None], new_dir, direction)
    # strict margin: only clearly interior source points are emptied
    in_source = tet_lookup_plain(op.lut_orig, _table(op.v0_orig, op.inv_orig), pos, _threshold(STRICT_EPS))[0]
    empty = in_source & ~in_target & (not op.copy_mode)
    return pos_out, dir_out, empty, in_target


def cage_map_membrane_plain(op: CageDeformationOp, pos: torch.Tensor, direction: torch.Tensor):
    """Plain version of the ``WARP_MEMBRANE`` instance: the JAX composition
    (the cage step of the full stack: the inclusive lookup over the padded
    LUT, the per-tet row takes, then ``membrane_residuals_at`` at the
    rotated direction) → (pos', dir', empty, in_target, residual σ, outside
    σ, residual rgb), with no kernel on any device."""
    in_target, tet, bary = tet_lookup_plain(op.lut_def, _table(op.v0_def, op.inv_def), pos, _threshold(INCLUSIVE_EPS))
    t = tet.long()
    canonical = pos + _bary_delta((op.verts_orig - op.verts_def).reshape(-1, 12)[t], bary)
    pos_out = torch.where(in_target[:, None], canonical, pos)
    dir_out = torch.where(in_target[:, None], _rotate_back(op.rot.reshape(-1, 9)[t], direction), direction)
    in_source = tet_lookup_plain(op.lut_orig, _table(op.v0_orig, op.inv_orig), pos, _threshold(STRICT_EPS))[0]
    empty = in_source & ~in_target & (not op.copy_mode)
    rs, ro, rc = poisson.membrane_residuals_at(_membrane(op), tet, bary, in_target, dir_out)
    return pos_out, dir_out, empty, in_target, rs, ro, rc


def cage_map_positions_plain(op: CageDeformationOp, pos: torch.Tensor):
    """Plain version of the ``WARP_POSITIONS`` instance."""
    in_target, tet, bary = tet_lookup_plain(op.lut_def, _table(op.v0_def, op.inv_def), pos, _threshold(INCLUSIVE_EPS))
    delta = _bary_delta((op.verts_orig - op.verts_def).reshape(-1, 12)[tet.long()], bary)
    pos_out = torch.where(in_target[:, None], pos + delta, pos)
    in_source = tet_lookup_plain(op.lut_orig, _table(op.v0_orig, op.inv_orig), pos, _threshold(STRICT_EPS))[0]
    kill = in_source & ~in_target & (not op.copy_mode)
    return pos_out, kill


def cage_map_samples(op: CageDeformationOp, pos: torch.Tensor, direction: torch.Tensor):
    """Backward warp of render samples: deformed-space sample → canonical
    position + rotated direction; vacated source samples are flagged empty
    (unless copy mode). The warp is in delta form, canonical = p +
    Σᵢ baryᵢ·(voᵢ − vdᵢ), which moves nothing for an identity cage. One
    launch of kernel E on a CUDA device; the plain composition on the CPU."""
    if pos.device.type == "cpu":
        return cage_map_samples_plain(op, pos, direction)
    return cage_warp_samples_cuda(op, pos.contiguous(), direction.contiguous())


def cage_map_membrane(op: CageDeformationOp, pos: torch.Tensor, direction: torch.Tensor,
                      acc_sigma: torch.Tensor, acc_out: torch.Tensor, acc_rgb: torch.Tensor):
    """:func:`cage_map_samples` of an operator with a membrane, adding the
    membrane's residual σ, outside σ and residual rgb into the accumulators
    (in place) → (pos', dir', empty, in_target). One launch of kernel E on a
    CUDA device; the plain composition and three adds on the CPU."""
    _membrane(op)
    if pos.device.type == "cpu":
        pos_out, dir_out, empty, in_target, rs, ro, rc = cage_map_membrane_plain(op, pos, direction)
        acc_sigma += rs
        acc_out += ro
        acc_rgb += rc
        return pos_out, dir_out, empty, in_target
    return cage_warp_membrane_cuda(op, pos.contiguous(), direction.contiguous(), acc_sigma, acc_out, acc_rgb)


def cage_map_positions(op: CageDeformationOp, pos: torch.Tensor):
    """Position-only warp for the grid refresh → (pos', kill)."""
    if pos.device.type == "cpu":
        return cage_map_positions_plain(op, pos)
    return cage_warp_positions_cuda(op, pos.contiguous())


def cage_in_source(op: CageDeformationOp, pos: torch.Tensor) -> torch.Tensor:
    return _source_lookup(op, pos)[0]


def cage_map_forward(op: CageDeformationOp, pos: torch.Tensor):
    """Canonical → deformed (the distiller's direction) → (pos', in_source);
    the per-tet deltas by kernel D's row take on a CUDA device."""
    in_source, tet, bary = _source_lookup(op, pos)
    delta = _bary_delta(take_rows((op.verts_def - op.verts_orig).reshape(-1, 12).contiguous(), tet), bary)
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


def map_samples_through_stack_full(operators: List, pos: torch.Tensor, direction: torch.Tensor):
    """:func:`map_samples_through_stack`, also summing the membranes'
    values newest-first into accumulators zeroed once for the stack → (pos,
    dir, empty, residual σ [N], outside σ [N], residual rgb [N, 3]). A cage
    with a membrane runs :func:`cage_map_membrane`; every other operator its
    own sample warp."""
    N = pos.shape[0]
    empty = torch.zeros(N, dtype=torch.bool, device=pos.device)
    resid_sigma = torch.zeros(N, dtype=torch.float32, device=pos.device)
    outside_sigma = torch.zeros(N, dtype=torch.float32, device=pos.device)
    resid_rgb = torch.zeros((N, 3), dtype=torch.float32, device=pos.device)
    for op in reversed(operators):
        if isinstance(op, CageDeformationOp) and op.membrane is not None:
            pos, direction, e, _ = cage_map_membrane(op, pos, direction, resid_sigma, outside_sigma, resid_rgb)
        else:
            pos, direction, e, _ = apply_operator_samples(op, pos, direction)
        empty |= e
    return pos, direction, empty, resid_sigma, outside_sigma, resid_rgb


def has_membrane(operators) -> bool:
    """Whether any operator of the stack carries a membrane."""
    return any(getattr(op, "membrane", None) is not None for op in operators)


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
