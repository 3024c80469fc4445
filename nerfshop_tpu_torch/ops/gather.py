"""Dynamic gathers of 4-byte elements: kernel D and its plain version.

Counterpart of the Pallas gather kernels of the TPU build (``take`` and
``take_along_axis`` bodies in ``scratch/probe_*.py``) and of the
``jnp.take`` / ``jnp.take_along_axis`` calls on the paths they serve: the
render march's ``take_along_axis(axis=1)`` and the edit warp's row takes of
per-tet rows. Three forms, f32 or i32, int32 or int64 indices:

* :func:`take_rows` — ``out[q, c] = table[idx[q], c]`` (the 1-D take is C = 1);
* :func:`take_along` with ``axis=1`` — ``out[q, c] = x[q, idx[q, c]]``;
* :func:`take_along` with ``axis=0`` — ``out[q, c] = x[idx[q, c], c]``.

In-range indices are the callers' precondition, as at every JAX call site;
the plain version (``torch.index_select`` / ``torch.gather``) checks the
range. On a CUDA tensor the wrappers launch kernel D (``csrc/gather.cu``) or
raise; on a CPU tensor they run the plain version. A gather is a copy, so
kernel and plain version agree bit for bit. Kernel D has no backward: a
CUDA input that autograd would record raises.

:func:`plan` is the kernel's launch plan, a pure function of the shapes,
the index type and the 16-byte alignment of the pointers: which variant,
which vector widths, which block shape and how much shared memory. It is a
``kernels.GatherPlan``, the C struct the entry point takes, by name.
"""

from __future__ import annotations

import functools

import torch

from nerfshop_tpu_torch import kernels

#: the kernel's forms (the ``form`` argument of ``nst_gather``)
FORMS = {"rows": 0, "axis1": 1, "axis0": 2}
DTYPES = (torch.float32, torch.int32)
INDEX_DTYPES = (torch.int32, torch.int64)
THREADS = 256
#: bytes of x rows one block of the staged axis-1 variant holds in shared memory
STAGE_BUDGET = 32 * 1024
#: the widest row the staged variant takes (dynamic shared memory without opt-in)
STAGE_MAX_ROW = 48 * 1024
#: rows a thread of the kernel has in flight (``kRows`` in ``csrc/gather.cu``)
ROWS_IN_FLIGHT = 4
#: the staged variant's rows per block fall until the grid holds 16 blocks
#: for each of the card's 132 SMs (two rounds of 8 blocks of 256 threads)
FILL_BLOCKS = 16 * 132


def _block(per_row: int):
    """(tx, ty): one thread per access of a row (up to 256) and as many rows
    as fill 256 threads, so a warp covers consecutive accesses of
    consecutive rows."""
    tx = max(1, min(per_row, THREADS))
    return tx, THREADS // tx


@functools.lru_cache(maxsize=1024)
def plan(
    form: str, S: int, C: int, Q: int, Cq: int, x_aligned: bool, idx_aligned: bool, idx64: bool
) -> kernels.GatherPlan:
    """Launch plan of kernel D: ``x`` [S, C], ``Q`` index rows and ``Cq``
    indices per row (form 0: Cq = C); ``*_aligned``: the pointer is a
    multiple of 16 bytes (the output, fresh from the allocator, always is)."""
    staged, ivec, rows, smem = 0, 1, 0, 0
    if form == "rows":
        xvec = 4 if C % 4 == 0 and x_aligned else 1
        tx, ty = _block(C // xvec)
        blocks = -(-Q // (ty * ROWS_IN_FLIGHT))
    elif form == "axis0":
        xvec = 1
        tx, ty = _block(C)
        blocks = -(-Q // (ty * ROWS_IN_FLIGHT))
    else:
        per16 = 2 if idx64 else 4
        ivec = per16 if idx_aligned and Cq % per16 == 0 else 1
        tx, ty = _block(Cq // ivec)
        row_bytes = 4 * C
        # staging reads the whole row once; a direct pick reads up to a
        # 32-byte sector, so staging pays when a row has a pick per 8 elements
        if row_bytes <= STAGE_MAX_ROW and C <= 8 * Cq:
            staged = 1
            xvec = 4 if C % 4 == 0 and x_aligned else 1
            rows = max(1, min(STAGE_BUDGET // row_bytes, -(-S // FILL_BLOCKS)))
            smem = rows * row_bytes
        else:
            xvec, rows = 1, ty * ROWS_IN_FLIGHT
        blocks = -(-S // rows)
    return kernels.GatherPlan(
        form=FORMS[form], idx64=idx64, S=S, C=C, Q=Q, Cq=Cq, staged=staged, xvec=xvec, ivec=ivec, rows=rows,
        tx=tx, ty=ty, blocks=max(1, blocks), smem=smem,
    )


def gather_plain(x: torch.Tensor, idx: torch.Tensor, form: str) -> torch.Tensor:
    """Plain version of every form, with range checks."""
    if form == "rows":
        return torch.index_select(x, 0, idx.reshape(-1).long()).reshape(*idx.shape, *x.shape[1:])
    return torch.gather(x, 1 if form == "axis1" else 0, idx.long())


@kernels.counted("launches")
def gather_cuda(x: torch.Tensor, idx: torch.Tensor, form: str) -> torch.Tensor:
    """Kernel D: ``x`` [S, C] (or [S] for rows) f32/i32, ``idx`` int32/int64
    ([Q] for rows, else 2-D), both contiguous on one CUDA device → the
    gathered tensor. Raises on anything out of its range."""
    dev = x.device
    if dev.type != "cuda" or idx.device != dev:
        raise ValueError(f"gather kernel: tensors on {x.device} and {idx.device}, expected one CUDA device")
    if x.dtype not in DTYPES or idx.dtype not in INDEX_DTYPES:
        raise ValueError(f"gather kernel: x {x.dtype} (f32/i32), idx {idx.dtype} (int32/int64)")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather kernel: x and idx must be contiguous")
    if x.requires_grad and torch.is_grad_enabled():
        raise ValueError("gather kernel has no backward; x requires grad")
    S = x.shape[0]
    C = x.numel() // S if S else 1
    if form == "rows":
        if idx.ndim != 1:
            raise ValueError(f"gather kernel rows: idx of shape {tuple(idx.shape)}, expected 1-D")
        Q, Cq = idx.shape[0], C
        out_shape = (Q, *x.shape[1:])
    else:
        if x.ndim != 2 or idx.ndim != 2:
            raise ValueError(f"gather kernel {form}: x {tuple(x.shape)} and idx {tuple(idx.shape)} must be 2-D")
        Q, Cq = idx.shape
        if form == "axis1" and Q != S:
            raise ValueError(f"gather kernel axis1: idx rows {Q} != x rows {S}")
        if form == "axis0" and Cq != C:
            raise ValueError(f"gather kernel axis0: idx columns {Cq} != x columns {C}")
        out_shape = (Q, Cq)
    out = torch.empty(out_shape, dtype=x.dtype, device=dev)
    if out.numel() == 0:
        return out
    xp, ip = x.data_ptr(), idx.data_ptr()
    p = plan(form, S, C, Q, Cq, xp % 16 == 0, ip % 16 == 0, idx.dtype == torch.int64)
    err = kernels.load().nst_gather(xp, ip, out.data_ptr(), p, kernels.stream_ptr(dev))
    kernels.check(err, "gather")
    gather_cuda.launches += 1
    return out


def _dispatch(x: torch.Tensor, idx: torch.Tensor, form: str) -> torch.Tensor:
    if x.device.type == "cpu":
        return gather_plain(x, idx, form)
    x = x if x.is_contiguous() else x.contiguous()
    idx = idx if idx.is_contiguous() else idx.contiguous()
    return gather_cuda(x, idx, form)


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, idx, axis=0)`` for 1-D ``idx``: [S, ...] → [Q, ...]."""
    return _dispatch(table, idx, "rows")


def take_along(x: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """``jnp.take_along_axis(x, idx, axis)`` for 2-D ``x`` and ``idx``, axis 0 or 1."""
    if axis not in (0, 1):
        raise ValueError(f"take_along: axis {axis} (0 or 1)")
    return _dispatch(x, idx, "axis1" if axis == 1 else "axis0")
