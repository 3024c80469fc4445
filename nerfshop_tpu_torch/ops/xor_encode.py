"""The xor-hash corner encode (kernel K) and its backward (kernel L).

Two encodings read the hash table by corner, with tcnn's xor hash, where the
brick layout of :mod:`nerfshop_tpu_torch.ops.table_ops` reads a base slot
plus fixed shifts:

* ``GridEncoding(layout="plain")``, the counterpart of the JAX plain branch
  (``nerfshop_tpu/models/encodings.py:155-195, :380-383``): corners clamped
  to ``res − 1``, fractions not folded, dense levels indexed
  ``x + res·(y + res·z)``, hashed ones ``(x ⊕ y·P1 ⊕ z·P2) mod m``;
* ``TakikawaEncoding`` (``encodings.py:492-527``): levels at octree depths,
  positions clipped to [0, 1], every level hashed mod a size that need not
  be a power of two, features zero where the octree mask is empty.

An encoding describes its levels to both by ``xor_levels`` (a list of
:class:`Level`), ``takikawa``, ``sum_instead_of_concat`` and, for
Takikawa, the device ``mask`` (uint8, every level's occupancy cells one
after another), and keeps kernel K's launch parameters in its ``_meta``
dict. On a CUDA tensor :func:`xor_encode` launches kernel K and
:func:`xor_encode_bwd` kernel L (``csrc/xor_encode.cu``), or raise; on a
CPU tensor they run the plain versions: the gather and sum of
:func:`xor_encode_plain`, and autograd of it (an ``index_add`` into the
table). :class:`XorEncodeFunction` is the differentiable forward. Under
``create_graph`` its position gradient is recorded
(:class:`XorEncodeDxFunction`), whose backward is kernel M on the card
(:func:`xor_encode_dx_bwd`, D = 3: the counterpart of kernel J of
``ops/table_ops.py`` for these tables, what
``nerfshop_tpu/torch_interop.py:55`` takes by ``jax.grad`` of the VJP), so
the density module takes an eikonal gradient over a plain or a Takikawa
table as over the brick one. A second-order gradient into the table is
not computed and raises ``NotImplementedError``, as under J.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from nerfshop_tpu_torch import kernels
from nerfshop_tpu_torch.ops.table_ops import check_table_second_order

P1, P2 = 2654435761, 805459861
U32 = 0xFFFFFFFF


@dataclass(frozen=True)
class Level:
    """One level of an xor-indexed table. Plain: ``scale`` and ``res`` are
    the grid level's; Takikawa: both are 2^depth, and ``mask_off`` /
    ``mask_res`` place the level's occupancy cells in the encoding's mask."""

    scale: float
    res: int
    m: int
    offset: int
    dense: bool = False
    mask_off: int = 0
    mask_res: int = 0


def corner_bits(D: int) -> List[List[int]]:
    """[2^D][D]: corner c's offset on axis d is bit d of c."""
    return [[(c >> d) & 1 for d in range(D)] for c in range(1 << D)]


def level_cells(x: torch.Tensor, enc, lv: Level, takikawa: bool):
    """x [N, D] → (table rows [N, 2^D] int64, fractions [N, D] differentiable
    in x, inside [N] bool or None). Takikawa's clip is ``minimum(maximum())``,
    whose gradient splits a tie as JAX's ``clip`` does."""
    D = x.shape[1]
    bits = torch.tensor(corner_bits(D), dtype=torch.int64, device=x.device)  # [C, D]
    if takikawa:
        xc = torch.minimum(torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device)),
                           torch.ones((), dtype=x.dtype, device=x.device))
        p = xc * float(lv.res)
        p0 = torch.floor(p).to(torch.int64).clamp(0, lv.res - 1)
        frac = p - p0.to(x.dtype)
        corner = torch.minimum(p0[:, None, :] + bits[None], torch.tensor(lv.res, device=x.device))
    else:
        p = x * torch.full((), lv.scale, dtype=x.dtype, device=x.device) + 0.5
        p0f = torch.floor(p)
        frac = p - p0f
        p0 = p0f.to(torch.int64)
        corner = (p0[:, None, :] + bits[None]).clamp(0, lv.res - 1)
    if not takikawa and lv.dense:
        h = corner[..., 0] + lv.res * corner[..., 1] if D == 2 else corner[..., 0] + lv.res * (corner[..., 1] + lv.res * corner[..., 2])
    else:
        h = corner[..., 0]
        for d, prime in zip(range(1, D), (P1, P2)):
            h = h ^ ((corner[..., d] * prime) & U32)
    rows = (h & U32) % lv.m + lv.offset
    inside = None
    if takikawa:
        mr = lv.mask_res
        mc = torch.clamp((p0 * mr) // lv.res, 0, mr - 1)
        inside = enc.mask[lv.mask_off + (mc[:, 0] * mr + mc[:, 1]) * mr + mc[:, 2]].to(torch.bool)
    return rows, frac, inside


def level_corners(x: torch.Tensor, enc, lv: Level, takikawa: bool):
    """x [N, D] → (table rows [N, 2^D] int64, weights [N, 2^D] differentiable
    in x, inside [N] bool or None): :func:`level_cells` with the corners'
    products of fractions."""
    rows, frac, inside = level_cells(x, enc, lv, takikawa)
    on = torch.tensor(corner_bits(x.shape[1]), dtype=torch.bool, device=x.device)[None]  # [1, C, D]
    f = torch.where(on, frac[:, None, :], 1.0 - frac[:, None, :])
    w = f[..., 0]
    for d in range(1, x.shape[1]):
        w = w * f[..., d]
    return rows, w, inside


def frac_slopes(x: torch.Tensor, lv: Level, takikawa: bool) -> torch.Tensor:
    """d frac / d x [N, D] of :func:`level_cells`: the level's scale on the
    plain layout; on Takikawa's, the scale times JAX's derivative of
    ``clip``: 1 inside (0, 1), ½ at exactly 0 or 1, 0 outside."""
    if not takikawa:
        return torch.full_like(x, lv.scale)
    inner = torch.where((x > 0) & (x < 1), 1.0, torch.where((x == 0) | (x == 1), 0.5, 0.0))
    return inner.to(x.dtype) * lv.scale


def xor_encode_plain(table: torch.Tensor, x: torch.Tensor, enc) -> torch.Tensor:
    """Plain version of kernel K: x [N, D] → [N, L·F] (Takikawa with
    ``sum_instead_of_concat``: [N, F]), the corner rows gathered and summed
    with their weights. Differentiable in the table and x."""
    outs = []
    for lv in enc.xor_levels:
        rows, w, inside = level_corners(x, enc, lv, enc.takikawa)
        feats = table.index_select(0, rows.reshape(-1)).view(*rows.shape, table.shape[1])  # [N, C, F]
        acc = (w[:, :, None] * feats).sum(dim=1)  # [N, F]
        if inside is not None:
            acc = torch.where(inside[:, None], acc, torch.zeros((), dtype=acc.dtype, device=acc.device))
        outs.append(acc)
    if enc.sum_instead_of_concat:
        total = outs[0]
        for o in outs[1:]:
            total = total + o
        return total
    return torch.cat(outs, dim=1)


def xor_encode_bwd_plain(table: torch.Tensor, x: torch.Tensor, dout: torch.Tensor, enc, want_table: bool = True,
                         want_dx: bool = True) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Plain version of kernel L: autograd of :func:`xor_encode_plain` →
    (d table [Σm, F] or None, d x [N, D] or None)."""
    with torch.enable_grad():
        tg = table.detach().requires_grad_(want_table)
        xg = x.detach().requires_grad_(want_dx)
        out = xor_encode_plain(tg, xg, enc)
        inputs = [t for t, want in ((tg, want_table), (xg, want_dx)) if want]
        grads = list(torch.autograd.grad(out, inputs, dout.reshape(out.shape).to(out.dtype)))
    return grads.pop(0) if want_table else None, grads.pop(0) if want_dx else None


def xor_args(enc) -> kernels.XorArgs:
    """The launch parameters of kernels K and L for ``enc`` (host memory,
    built once an encoding)."""
    cached = enc._meta.get("xor_args")
    if cached is not None:
        return cached
    levels = enc.xor_levels
    if len(levels) > kernels.XOR_MAX_LEVELS:
        raise ValueError(f"kernels K and L take at most {kernels.XOR_MAX_LEVELS} levels; the encoding has {len(levels)}")
    a = kernels.XorArgs()
    for i, lv in enumerate(levels):
        a.lv[i] = kernels.XorLevel(
            lv.scale, lv.res, lv.m, lv.offset, int(lv.dense), lv.mask_off, lv.mask_res, int(lv.m & (lv.m - 1) == 0)
        )
    a.n_levels, a.D, a.F = len(levels), enc.n_input_dims, enc.n_features_per_level
    a.takikawa, a.sum = int(enc.takikawa), int(enc.sum_instead_of_concat)
    enc._meta["xor_args"] = a
    return a


def check_supported(D: int, F: int, takikawa: bool, n_levels: int) -> None:
    """Raise ``ValueError`` unless kernels K and L take this table."""
    ok = (D == 3 and F in (2, 4, 8)) if takikawa else (D in (2, 3) and F == 2)
    if not ok or not 1 <= n_levels <= kernels.XOR_MAX_LEVELS:
        kind = "the Takikawa encoding" if takikawa else "the plain grid layout"
        allowed = "n_input_dims 3, n_features_per_level 2, 4 or 8" if takikawa else "n_input_dims 3 or 2, n_features_per_level 2"
        raise ValueError(
            f"kernels K and L (xor_encode) take {kind} at {allowed} and 1..{kernels.XOR_MAX_LEVELS} levels only; "
            f"the encoding has n_input_dims {D}, n_features_per_level {F}, {n_levels} levels"
        )


def _device_inputs(table: torch.Tensor, x: torch.Tensor, enc, name: str):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{name} kernel: x on {dev}, expected a CUDA device")
    check_supported(enc.n_input_dims, enc.n_features_per_level, enc.takikawa, enc.n_levels)
    N = x.shape[0]
    kernels.require(x, "x", torch.float32, (N, enc.n_input_dims), dev)
    kernels.require(table, "table", torch.float32, (enc.table_size, enc.n_features_per_level), dev)
    if not kernels.aligned16(table):
        table = table.clone()  # rows are read as float2 / float4
    mask = enc.mask if enc.takikawa else None
    if mask is not None:
        kernels.require(mask, "mask", torch.uint8, tuple(mask.shape), dev)
    return table, mask


@kernels.counted("launches")
def xor_encode_cuda(table: torch.Tensor, x: torch.Tensor, enc) -> torch.Tensor:
    """Kernel K → [N, L·F] f32 ([N, F] with ``sum_instead_of_concat``) from
    x [N, D] f32 and the table [Σm, F] f32. Raises on a table it does not
    take (:func:`check_supported`)."""
    table, mask = _device_inputs(table, x, enc, "xor_encode")
    dev, N = x.device, x.shape[0]
    out = torch.empty((N, enc.n_output_dims), dtype=torch.float32, device=dev)
    err = kernels.load().nst_xor_encode(
        ctypes.byref(xor_args(enc)), x.data_ptr(), table.data_ptr(), None if mask is None else mask.data_ptr(),
        out.data_ptr(), N, kernels.stream_ptr(dev),
    )
    kernels.check(err, "xor_encode")
    xor_encode_cuda.launches += 1
    return out


@kernels.counted("launches")
def xor_encode_bwd_cuda(table: torch.Tensor, x: torch.Tensor, dout: torch.Tensor, enc, want_table: bool = True,
                        want_dx: bool = True):
    """Kernel L → (d table [Σm, F] f32 or None, d x [N, D] f32 or None) from
    x, the table and the output cotangent dout (shaped as K's output). The
    table gradient is a scatter by atomics: its sums run in another order
    on every call."""
    table, mask = _device_inputs(table, x, enc, "xor_encode_bwd")
    dev, N = x.device, x.shape[0]
    kernels.require(dout, "dout", torch.float32, (N, enc.n_output_dims), dev)
    if not kernels.aligned16(dout):
        dout = dout.clone()  # read as float2 / float4
    dt = torch.zeros_like(table) if want_table else None
    dx = torch.empty((N, enc.n_input_dims), dtype=torch.float32, device=dev) if want_dx else None
    err = kernels.load().nst_xor_encode_bwd(
        ctypes.byref(xor_args(enc)), x.data_ptr(), table.data_ptr(), None if mask is None else mask.data_ptr(),
        dout.data_ptr(), None if dt is None else dt.data_ptr(), None if dx is None else dx.data_ptr(), N,
        kernels.stream_ptr(dev),
    )
    kernels.check(err, "xor_encode_bwd")
    xor_encode_bwd_cuda.launches += 1
    return dt, dx


def xor_encode(table: torch.Tensor, x: torch.Tensor, enc) -> torch.Tensor:
    """K's output. CPU tensors take the plain version; CUDA tensors launch
    kernel K or raise."""
    if x.device.type == "cpu":
        return xor_encode_plain(table, x, enc)
    if x.device.type != "cuda":
        raise ValueError(f"xor_encode: unsupported device {x.device}")
    return xor_encode_cuda(table.detach().contiguous(), x.detach().contiguous(), enc)


def xor_encode_bwd(table: torch.Tensor, x: torch.Tensor, dout: torch.Tensor, enc, want_table: bool = True,
                   want_dx: bool = True):
    """(d table, d x) of Σ dout · K(table, x). CPU tensors take the plain
    version; CUDA tensors launch kernel L or raise."""
    if x.device.type == "cpu":
        return xor_encode_bwd_plain(table, x, dout, enc, want_table, want_dx)
    if x.device.type != "cuda":
        raise ValueError(f"xor_encode_bwd: unsupported device {x.device}")
    return xor_encode_bwd_cuda(
        table.detach().contiguous(), x.detach().contiguous(), dout.detach().float().contiguous(), enc, want_table, want_dx
    )


def xor_encode_dx_bwd_plain(table: torch.Tensor, x: torch.Tensor, g: torch.Tensor, v: torch.Tensor, enc):
    """Plain version of kernel M, in closed form → (dh shaped as g, d_x2
    [N, D]): the backward of L's position gradient d_x = J_enc(x)ᵀ g with
    respect to g and x, for the cotangent v [N, D] on d_x, in x's dtype.
    Per level, with w_c = Π_d f_d(c) of :func:`level_cells`' fractions and
    s_d their slopes (:func:`frac_slopes`): dh = Σ_d s_d v_d Σ_c ∂w_c/∂f_d ·
    row_c, and d_x2_j = Σ_{i≠j} s_i s_j v_i Σ_c ∂²w_c/∂f_i∂f_j ⟨g, row_c⟩
    (the interpolation is linear in each fraction; the rows and slopes are
    constant within a cell); zero where Takikawa's mask is empty."""
    dtype = x.dtype
    x, g, v, table = (t.detach().to(dtype) for t in (x, g, v, table))
    D, F = x.shape[1], enc.n_features_per_level
    bits = torch.tensor(corner_bits(D), dtype=torch.bool, device=x.device)
    sign = torch.where(bits, 1.0, -1.0).to(dtype)  # [C, D]: the sign of ∂w_c/∂f_d
    pairs = [(i, j) for i in range(D) for j in range(i + 1, D)]
    dh = []
    dx2 = torch.zeros_like(x)
    for l, lv in enumerate(enc.xor_levels):
        rows, frac, inside = level_cells(x, enc, lv, enc.takikawa)
        sl = frac_slopes(x, lv, enc.takikawa)
        if inside is not None:
            sl = sl * inside[:, None]  # an empty cell: no feature, no derivative
        r = table[rows]  # [N, C, F]
        f = torch.where(bits[None], frac[:, None, :], 1.0 - frac[:, None, :])  # [N, C, D]

        def prod_except(*axes):
            out = torch.ones_like(f[..., 0])
            for e in range(D):
                if e not in axes:
                    out = out * f[..., e]
            return out

        dw = torch.stack([sign[:, d] * prod_except(d) for d in range(D)], dim=-1)  # [N, C, D]
        jv = (dw * (sl * v)[:, None, :]).sum(-1)  # [N, C]
        dh.append((jv[..., None] * r).sum(1))
        gl = g if enc.sum_instead_of_concat else g[:, l * F:(l + 1) * F]
        gc = (r * gl[:, None, :]).sum(-1)  # [N, C]: ⟨g, row_c⟩
        for i, j in pairs:
            h = (sign[:, i] * sign[:, j] * prod_except(i, j) * gc).sum(1) * sl[:, i] * sl[:, j]
            dx2[:, i] = dx2[:, i] + v[:, j] * h
            dx2[:, j] = dx2[:, j] + v[:, i] * h
    if enc.sum_instead_of_concat:
        total = dh[0]
        for h in dh[1:]:
            total = total + h
        return total, dx2
    return torch.cat(dh, dim=1), dx2


def check_dx_bwd_supported(enc) -> None:
    """Raise ``ValueError`` unless kernel M takes ``enc``: kernels K and L's
    range at D = 3."""
    check_supported(enc.n_input_dims, enc.n_features_per_level, enc.takikawa, enc.n_levels)
    if enc.n_input_dims != 3:
        raise ValueError(f"kernel M (xor_encode_dx_bwd) takes n_input_dims 3 only; the encoding has {enc.n_input_dims}")


@kernels.counted("launches")
def xor_encode_dx_bwd_cuda(table: torch.Tensor, x: torch.Tensor, g: torch.Tensor, v: torch.Tensor, enc):
    """Kernel M → (dh shaped as g, d_x2 [N, 3]) f32 from x [N, 3], the table,
    L's output cotangent g (shaped as K's output) and the cotangent v
    [N, 3] on L's d x. Every output belongs to one sample (no atomics): the
    same bits on every call. Raises on a table it does not take
    (:func:`check_dx_bwd_supported`)."""
    check_dx_bwd_supported(enc)
    table, mask = _device_inputs(table, x, enc, "xor_encode_dx_bwd")
    dev, N = x.device, x.shape[0]
    kernels.require(g, "g", torch.float32, (N, enc.n_output_dims), dev)
    kernels.require(v, "v", torch.float32, (N, 3), dev)
    if not kernels.aligned16(g):
        g = g.clone()  # read as float2 / float4
    dh = torch.empty_like(g)
    dx2 = torch.empty((N, 3), dtype=torch.float32, device=dev)
    err = kernels.load().nst_xor_encode_dx_bwd(
        ctypes.byref(xor_args(enc)), x.data_ptr(), table.data_ptr(), None if mask is None else mask.data_ptr(),
        g.data_ptr(), v.data_ptr(), dh.data_ptr(), dx2.data_ptr(), N, kernels.stream_ptr(dev),
    )
    kernels.check(err, "xor_encode_dx_bwd")
    xor_encode_dx_bwd_cuda.launches += 1
    return dh, dx2


def xor_encode_dx_bwd_attrs(enc) -> dict:
    """Kernel M as built for ``enc``: registers a thread, static shared
    memory, local memory a thread (bytes), dynamic shared memory a block
    (bytes), blocks an SM and threads a block. Builds the kernels and needs
    a CUDA device."""
    check_dx_bwd_supported(enc)
    out = (ctypes.c_int * 6)()
    kernels.check(kernels.load().nst_xor_encode_dx_bwd_attrs(ctypes.byref(xor_args(enc)), ctypes.addressof(out)),
                  "xor_encode_dx_bwd")
    return dict(zip(("registers", "static_smem", "local_bytes", "dynamic_smem", "blocks_per_sm", "threads"), out))


def xor_encode_dx_bwd(table: torch.Tensor, x: torch.Tensor, g: torch.Tensor, v: torch.Tensor, enc):
    """(dh, d_x2) of ⟨d_x, v⟩, d_x = L's position gradient for the output
    cotangent g, with respect to g and x. CPU tensors take the plain
    version; CUDA tensors launch kernel M or raise."""
    if x.device.type == "cpu":
        return xor_encode_dx_bwd_plain(table, x, g, v, enc)
    if x.device.type != "cuda":
        raise ValueError(f"xor_encode_dx_bwd: unsupported device {x.device}")
    return xor_encode_dx_bwd_cuda(
        table.detach().contiguous(), x.detach().contiguous(), g.detach().float().contiguous(),
        v.detach().float().contiguous(), enc,
    )


class XorEncodeDxFunction(torch.autograd.Function):
    """(table, x, dout) → d_x [N, D] = J_enc(x)ᵀ dout (kernel L with the
    table gradient off on the card), differentiable in x and dout through
    :func:`xor_encode_dx_bwd` (kernel M on the card). A gradient into the
    table raises."""

    @staticmethod
    def forward(ctx, table, x, dout, enc):
        ctx.save_for_backward(table, x, dout)
        ctx.enc = enc
        return xor_encode_bwd(table, x, dout, enc, want_table=False)[1]

    @staticmethod
    def backward(ctx, v):
        check_table_second_order(ctx.needs_input_grad[0])
        table, x, dout = ctx.saved_tensors
        dh, dx2 = xor_encode_dx_bwd(table, x, dout, v, ctx.enc)
        return None, dx2 if ctx.needs_input_grad[1] else None, dh.view_as(dout) if ctx.needs_input_grad[2] else None, None


class XorEncodeFunction(torch.autograd.Function):
    """table [Σm, F], x [N, D] → K's output, differentiable in both through
    kernel L (one launch for whichever of the two gradients autograd asks
    for). Under ``create_graph`` the position gradient is recorded
    (:class:`XorEncodeDxFunction`, kernel M in its backward), unless the
    table needs a gradient too: a second-order gradient into the table is
    not computed, so that raises ``NotImplementedError``."""

    @staticmethod
    def forward(ctx, table, x, enc):
        ctx.save_for_backward(table, x)
        ctx.enc = enc
        return xor_encode(table, x, enc)

    @staticmethod
    def backward(ctx, dout):
        table, x = ctx.saved_tensors
        want_table, want_dx = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        if torch.is_grad_enabled():
            check_table_second_order(want_table)
            return None, XorEncodeDxFunction.apply(table, x, dout, ctx.enc), None
        dt, dx = xor_encode_bwd(table, x, dout, ctx.enc, want_table, want_dx)
        return dt, dx, None
