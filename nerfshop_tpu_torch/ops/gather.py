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
"""

from __future__ import annotations

import torch

from nerfshop_tpu_torch import kernels

#: the kernel's forms (the ``form`` argument of ``nst_gather``)
FORMS = {"rows": 0, "axis1": 1, "axis0": 2}
DTYPES = (torch.float32, torch.int32)
INDEX_DTYPES = (torch.int32, torch.int64)


def gather_plain(x: torch.Tensor, idx: torch.Tensor, form: str) -> torch.Tensor:
    """Plain version of every form, with range checks."""
    if form == "rows":
        return torch.index_select(x, 0, idx.reshape(-1).long()).reshape(*idx.shape, *x.shape[1:])
    return torch.gather(x, 1 if form == "axis1" else 0, idx.long())


def gather_cuda(x: torch.Tensor, idx: torch.Tensor, form: str) -> torch.Tensor:
    """Kernel D: ``x`` [S, C] (or [S] for rows) f32/i32, ``idx`` int32/int64
    ([Q] for rows, else 2-D) → the gathered tensor. Raises on anything out of
    its range."""
    dev = x.device
    if dev.type != "cuda" or idx.device != dev:
        raise ValueError(f"gather kernel: tensors on {x.device} and {idx.device}, expected one CUDA device")
    if x.dtype not in DTYPES or idx.dtype not in INDEX_DTYPES:
        raise ValueError(f"gather kernel: x {x.dtype} (f32/i32), idx {idx.dtype} (int32/int64)")
    if torch.is_grad_enabled() and x.requires_grad:
        raise ValueError("gather kernel has no backward; x requires grad")
    x2 = x.reshape(x.shape[0], -1) if x.ndim != 2 else x
    S, C = x2.shape
    if form == "rows":
        if idx.ndim != 1:
            raise ValueError(f"gather kernel rows: idx of shape {tuple(idx.shape)}, expected 1-D")
        out_shape, c_out = (idx.shape[0], *x.shape[1:]), C
    else:
        if x.ndim != 2 or idx.ndim != 2:
            raise ValueError(f"gather kernel {form}: x {tuple(x.shape)} and idx {tuple(idx.shape)} must be 2-D")
        if form == "axis1" and idx.shape[0] != S:
            raise ValueError(f"gather kernel axis1: idx rows {idx.shape[0]} != x rows {S}")
        if form == "axis0" and idx.shape[1] != C:
            raise ValueError(f"gather kernel axis0: idx columns {idx.shape[1]} != x columns {C}")
        out_shape, c_out = tuple(idx.shape), idx.shape[1]
    kernels.require(x2, "x", x.dtype, (S, C), dev)
    kernels.require(idx, "idx", idx.dtype, tuple(idx.shape), dev)
    out = torch.empty(out_shape, dtype=x.dtype, device=dev)
    err = kernels.load().nst_gather(
        x2.data_ptr(), idx.data_ptr(), out.data_ptr(), out.numel(), x2.numel(), C, c_out, FORMS[form],
        int(idx.dtype == torch.int64), kernels.stream_ptr(dev),
    )
    kernels.check(err, "gather")
    gather_cuda.launches += 1
    return out


#: launches of kernel D since the last reset
gather_cuda.launches = 0


def _dispatch(x: torch.Tensor, idx: torch.Tensor, form: str) -> torch.Tensor:
    if x.device.type == "cpu":
        return gather_plain(x, idx, form)
    return gather_cuda(x.contiguous(), idx.contiguous(), form)


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, idx, axis=0)`` for 1-D ``idx``: [S, ...] → [Q, ...]."""
    return _dispatch(table, idx, "rows")


def take_along(x: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """``jnp.take_along_axis(x, idx, axis)`` for 2-D ``x`` and ``idx``, axis 0 or 1."""
    if axis not in (0, 1):
        raise ValueError(f"take_along: axis {axis} (0 or 1)")
    return _dispatch(x, idx, "axis1" if axis == 1 else "axis0")
