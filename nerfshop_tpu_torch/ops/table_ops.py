"""Hash-grid encode forward, its table gradient and its position gradient.

Counterpart of ``nerfshop_tpu/ops/table_ops.py::make_brick_encode``. The
forward gathers each sample's 2^D cell corners straight from the canonical
``[Σm, F]`` table at ``(base + shift_c) mod m`` (no brick tables); on a CUDA
tensor it is kernel B (``csrc/grid_encode.cu``). Only a forward that
autograd records needs the base slots and fractions (``with_fracs``); the
render and grid-refresh forwards ask for the features alone. The backward
sorts each level's ``(idx, w1, dout)`` by slot, sums each sorted run with kernel A
(:mod:`nerfshop_tpu_torch.ops.segsum`), and reduces the brick-row gradient
back onto canonical slots with one ``torch.roll`` per corner (same sign as
``jnp.roll``, ``table_ops.py:402-412``). The gradient with respect to the
positions (what JAX's autodiff takes through the custom VJP's ``d_w8``,
``table_ops.py:263-267``, and ``_brick_fracs``) is kernel F on a CUDA
tensor (``csrc/grid_encode.cu``), which recomputes the cells and fractions
from x; the backward computes each of the two gradients only when autograd
asks for it. That position gradient is itself differentiable
(:class:`GridEncodeDxFunction`): under ``create_graph`` its backward is
kernel J (the encode's JVP and the position Hessian contracted with the
output cotangent, what ``nerfshop_tpu/torch_interop.py:55`` takes by
``jax.grad`` of the VJP), so a loss on ∂out/∂x (an eikonal term) reaches
the positions and the output cotangent. A second-order gradient into the
table is not computed and raises.
"""

from __future__ import annotations

import ctypes

import torch

from nerfshop_tpu_torch import kernels
from nerfshop_tpu_torch.ops import segsum
from nerfshop_tpu_torch.ops.segsum import corner_products


def encode_from_fracs(table: torch.Tensor, idx: torch.Tensor, w1: torch.Tensor, enc) -> torch.Tensor:
    """Plain forward from base slots idx [L, N] and fracs w1 [L, N, D] →
    [N, L·F]. Differentiable in ``table`` through ordinary autograd (its
    backward is an index_add)."""
    L, N = idx.shape
    F = enc.n_features_per_level
    shifts = enc.shift_table(idx.device)
    outs = []
    for l in range(L):
        m = enc.level_sizes[l]
        rows = (idx[l].long()[:, None] + shifts[l][None, :]) % m + enc.level_offsets[l]
        feats = table[rows]  # [N, C, F]
        w8 = corner_products(w1[l])  # [N, C]
        outs.append((w8[:, :, None] * feats).sum(dim=1))
    return torch.stack(outs, dim=1).reshape(N, L * F)


def grid_encode_plain(table: torch.Tensor, x: torch.Tensor, enc, with_fracs: bool = True):
    """Plain version of kernel B → (out [N, L·F], idx [L, N] int32, w1 [L, N, D]),
    or (out, None, None) without fracs."""
    idx, w1 = enc.brick_fracs(x)
    out = encode_from_fracs(table, idx, w1, enc)
    return (out, idx, w1) if with_fracs else (out, None, None)


@kernels.counted("launches", "fracs_launches", "d2_launches")
def grid_encode_cuda(table: torch.Tensor, x: torch.Tensor, enc, with_fracs: bool = True):
    """Kernel B → (out [N, L·2], idx [L, N] int32, w1 [L, N, D]); without
    fracs it writes out only and returns (out, None, None). Takes D = 3 or
    D = 2, F = 2, and raises on anything else. ``d2_launches`` counts the
    D = 2 instance."""
    dev = x.device
    N = x.shape[0]
    L = enc.n_levels
    D = enc.n_input_dims
    if D not in (2, 3) or enc.n_features_per_level != 2:
        raise ValueError("grid_encode kernel supports D=2 or 3, F=2 only")
    kernels.require(x, "x", torch.float32, (N, D), dev)
    kernels.require(table, "table", torch.float32, (enc.table_size, 2), dev)
    meta_i, meta_f = enc.kernel_meta(dev)
    out = torch.empty((N, L * 2), dtype=torch.float32, device=dev)
    idx = w1 = None
    if with_fracs:
        idx = torch.empty((L, N), dtype=torch.int32, device=dev)
        w1 = torch.empty((L, N, D), dtype=torch.float32, device=dev)
    err = kernels.load().nst_grid_encode(
        x.data_ptr(), meta_i.data_ptr(), meta_f.data_ptr(), table.data_ptr(), out.data_ptr(),
        idx.data_ptr() if with_fracs else None, w1.data_ptr() if with_fracs else None, N, L, D,
        kernels.stream_ptr(dev),
    )
    kernels.check(err, "grid_encode")
    grid_encode_cuda.launches += 1
    grid_encode_cuda.fracs_launches += with_fracs
    grid_encode_cuda.d2_launches += D == 2
    return out, idx, w1


def grid_encode(table: torch.Tensor, x: torch.Tensor, enc, with_fracs: bool = True):
    """Encode forward → (out, idx, w1), or (out, None, None) without fracs.
    CPU tensors take the plain version; CUDA tensors launch kernel B or raise."""
    if x.device.type == "cpu":
        return grid_encode_plain(table, x, enc, with_fracs)
    if x.device.type != "cuda":
        raise ValueError(f"grid_encode: unsupported device {x.device}")
    return grid_encode_cuda(table, x, enc, with_fracs)


def grid_encode_dx_plain(table: torch.Tensor, x: torch.Tensor, dout: torch.Tensor, enc) -> torch.Tensor:
    """Plain version of kernel F: autograd of :func:`grid_encode_plain`'s
    arithmetic with respect to x → d_x [N, D]."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        out = grid_encode_plain(table.detach(), xg, enc, with_fracs=False)[0]
        (dx,) = torch.autograd.grad(out, xg, dout.reshape(out.shape).to(out.dtype))
    return dx


#: the most levels kernel F takes (``kDxMaxLevels`` of ``csrc/grid_encode.cu``:
#: its level records travel in the launch's parameters)
DX_MAX_LEVELS = 32


@kernels.counted("launches")
def grid_encode_dx_cuda(table: torch.Tensor, x: torch.Tensor, dout: torch.Tensor, enc) -> torch.Tensor:
    """Kernel F → d_x [N, 3] f32 from x [N, 3], the table [Σm, 2] and the
    output cotangent dout [N, L·2]. Takes D = 3, F = 2 and at most
    ``DX_MAX_LEVELS`` levels, and raises on anything else."""
    dev = x.device
    N = x.shape[0]
    L = enc.n_levels
    if enc.n_input_dims != 3 or enc.n_features_per_level != 2 or L > DX_MAX_LEVELS:
        raise ValueError(f"grid_encode_dx kernel supports D=3, F=2 and at most {DX_MAX_LEVELS} levels only")
    if dev.type != "cuda":
        raise ValueError(f"grid_encode_dx kernel: x on {dev}, expected a CUDA device")
    kernels.require(x, "x", torch.float32, (N, 3), dev)
    kernels.require(table, "table", torch.float32, (enc.table_size, 2), dev)
    kernels.require(dout, "dout", torch.float32, (N, L * 2), dev)
    if dout.data_ptr() % 8:
        dout = dout.clone()  # the kernel reads float2 pairs
    rec = enc.kernel_records()
    dx = torch.empty((N, 3), dtype=torch.float32, device=dev)
    err = kernels.load().nst_grid_encode_dx(
        x.data_ptr(), rec.data_ptr(), table.data_ptr(), dout.data_ptr(), dx.data_ptr(), N, L, kernels.stream_ptr(dev)
    )
    kernels.check(err, "grid_encode_dx")
    grid_encode_dx_cuda.launches += 1
    return dx


def grid_encode_dx(table: torch.Tensor, x: torch.Tensor, dout: torch.Tensor, enc) -> torch.Tensor:
    """d_x [N, D] of Σ dout · encode(table, x). CPU tensors take the plain
    version; CUDA tensors launch kernel F or raise."""
    if x.device.type == "cpu":
        return grid_encode_dx_plain(table, x, dout, enc)
    if x.device.type != "cuda":
        raise ValueError(f"grid_encode_dx: unsupported device {x.device}")
    return grid_encode_dx_cuda(table.detach().contiguous(), x.detach().contiguous(), dout.float().contiguous(), enc)


def _check_table_second_order(table_needs_grad: bool) -> None:
    """Raise when a gradient of d_x would have to reach the table."""
    if table_needs_grad:
        raise NotImplementedError(
            "a second-order gradient into the hash table is not computed (JAX's torch_interop differentiates "
            "the positions and the output cotangent only): detach the table, or pass the parameters as a "
            "state dict, before taking a create_graph gradient through the encode"
        )


def grid_encode_dx_bwd_plain(table: torch.Tensor, x: torch.Tensor, g: torch.Tensor, v: torch.Tensor, enc):
    """Plain version of kernel J, in closed form → (dh [N, L·F], d_x2 [N, D]):
    the backward of d_x = J_enc(x)ᵀ g with respect to g and x, for the
    cotangent v [N, D] on d_x. Per level, with w_c = Π_d (c_d ? w1_d :
    1 − w1_d) and sc_d = scale where the axis moves (p0_d ≠ res − 1), else 0:
    dh = Σ_d sc_d v_d Σ_c ∂w_c/∂w1_d · row_c, and d_x2_j = Σ_{i≠j} sc_i sc_j
    v_i Σ_c ∂²w_c/∂w1_i∂w1_j ⟨g, row_c⟩ (the interpolation is linear in each
    w1_d, so only mixed terms remain; the cell index has no derivative)."""
    x, g, v, table = (t.detach().float() for t in (x, g, v, table))
    N, L, D = x.shape[0], enc.n_levels, enc.n_input_dims
    F = enc.n_features_per_level
    idx, w1 = enc.brick_fracs(x)
    shifts = enc.shift_table(x.device)
    bits = torch.tensor([[(c >> d) & 1 for d in range(D)] for c in range(1 << D)], dtype=torch.bool, device=x.device)
    sign = torch.where(bits, 1.0, -1.0)  # [C, D]: the sign of ∂w_c/∂w1_d
    pairs = [(i, j) for i in range(D) for j in range(i + 1, D)]
    dh = []
    dx2 = torch.zeros_like(x)
    for l in range(L):
        m, res = enc.level_sizes[l], enc.level_res[l]
        p = x * torch.full((), enc.level_scales[l], dtype=x.dtype, device=x.device) + 0.5
        p0 = torch.floor(p).to(torch.int64).clamp(0, res - 1)
        sc = torch.where(p0 != res - 1, enc.level_scales[l], 0.0).to(x.dtype)  # [N, D]
        rows = table[(idx[l].long()[:, None] + shifts[l][None, :]) % m + enc.level_offsets[l]]  # [N, C, F]
        f = torch.where(bits[None], w1[l][:, None, :], 1.0 - w1[l][:, None, :])  # [N, C, D]

        def prod_except(*axes):
            out = torch.ones_like(f[..., 0])
            for e in range(D):
                if e not in axes:
                    out = out * f[..., e]
            return out

        dw = torch.stack([sign[:, d] * prod_except(d) for d in range(D)], dim=-1)  # [N, C, D]
        jv = (dw * (sc * v)[:, None, :]).sum(-1)  # [N, C]: Σ_d ∂w_c/∂x_d v_d
        dh.append((jv[..., None] * rows).sum(1))
        gc = (rows * g[:, None, l * F : (l + 1) * F]).sum(-1)  # [N, C]: ⟨g, row_c⟩
        for i, j in pairs:
            h = (sign[:, i] * sign[:, j] * prod_except(i, j) * gc).sum(1) * sc[:, i] * sc[:, j]
            dx2[:, i] = dx2[:, i] + v[:, j] * h
            dx2[:, j] = dx2[:, j] + v[:, i] * h
    return torch.cat(dh, dim=1), dx2


@kernels.counted("launches")
def grid_encode_dx_bwd_cuda(table: torch.Tensor, x: torch.Tensor, g: torch.Tensor, v: torch.Tensor, enc):
    """Kernel J → (dh [N, L·2], d_x2 [N, 3]) f32 from x [N, 3], the table
    [Σm, 2], kernel F's output cotangent g [N, L·2] and the cotangent v
    [N, 3] on kernel F's output. Takes D = 3, F = 2 and at most
    ``DX_MAX_LEVELS`` levels, and raises on anything else."""
    dev = x.device
    N = x.shape[0]
    L = enc.n_levels
    if enc.n_input_dims != 3 or enc.n_features_per_level != 2 or L > DX_MAX_LEVELS:
        raise ValueError(f"grid_encode_dx_bwd kernel supports D=3, F=2 and at most {DX_MAX_LEVELS} levels only")
    if dev.type != "cuda":
        raise ValueError(f"grid_encode_dx_bwd kernel: x on {dev}, expected a CUDA device")
    kernels.require(x, "x", torch.float32, (N, 3), dev)
    kernels.require(table, "table", torch.float32, (enc.table_size, 2), dev)
    kernels.require(g, "g", torch.float32, (N, L * 2), dev)
    kernels.require(v, "v", torch.float32, (N, 3), dev)
    if not kernels.aligned16(g):
        g = g.clone()  # the kernel stages g by 16-byte copies
    rec = enc.kernel_records()
    dh = torch.empty((N, L * 2), dtype=torch.float32, device=dev)
    dx2 = torch.empty((N, 3), dtype=torch.float32, device=dev)
    err = kernels.load().nst_grid_encode_dx_bwd(
        x.data_ptr(), rec.data_ptr(), table.data_ptr(), g.data_ptr(), v.data_ptr(), dh.data_ptr(), dx2.data_ptr(),
        N, L, kernels.stream_ptr(dev),
    )
    kernels.check(err, "grid_encode_dx_bwd")
    grid_encode_dx_bwd_cuda.launches += 1
    return dh, dx2


def grid_encode_dx_bwd_attrs(n_levels: int) -> dict:
    """Kernel J as built, for a launch at ``n_levels`` levels: registers a
    thread, static shared memory, local memory a thread (bytes), dynamic
    shared memory a block (bytes) and blocks an SM at it. Builds the kernels
    and needs a CUDA device."""
    out = (ctypes.c_int * 5)()
    kernels.check(kernels.load().nst_grid_encode_dx_bwd_attrs(n_levels, ctypes.addressof(out)), "grid_encode_dx_bwd")
    return dict(zip(("registers", "static_smem", "local_bytes", "dynamic_smem", "blocks_per_sm"), out))


def grid_encode_dx_bwd(table: torch.Tensor, x: torch.Tensor, g: torch.Tensor, v: torch.Tensor, enc):
    """(dh, d_x2) of ⟨grid_encode_dx(table, x, g), v⟩ with respect to g and
    x. CPU tensors take the plain version; CUDA tensors launch kernel J or
    raise."""
    if x.device.type == "cpu":
        return grid_encode_dx_bwd_plain(table, x, g, v, enc)
    if x.device.type != "cuda":
        raise ValueError(f"grid_encode_dx_bwd: unsupported device {x.device}")
    return grid_encode_dx_bwd_cuda(
        table.detach().contiguous(), x.detach().contiguous(), g.detach().float().contiguous(),
        v.detach().float().contiguous(), enc,
    )


class GridEncodeDxFunction(torch.autograd.Function):
    """(table, x, dout) → d_x [N, D] = J_enc(x)ᵀ dout (:func:`grid_encode_dx`:
    kernel F on the card), differentiable in x and dout through
    :func:`grid_encode_dx_bwd` (kernel J on the card). Outside grad mode it
    is :func:`grid_encode_dx` and records nothing."""

    @staticmethod
    def forward(ctx, table, x, dout, enc):
        ctx.save_for_backward(table, x, dout)
        ctx.enc = enc
        return grid_encode_dx(table, x, dout, enc)

    @staticmethod
    def backward(ctx, v):
        _check_table_second_order(ctx.needs_input_grad[0])
        table, x, dout = ctx.saved_tensors
        dh, dx2 = grid_encode_dx_bwd(table, x, dout, v, ctx.enc)
        return None, dx2 if ctx.needs_input_grad[1] else None, dh.view_as(dout) if ctx.needs_input_grad[2] else None, None


def fold_corners(dB: torch.Tensor, enc, level: int) -> torch.Tensor:
    """One level's brick-row gradient dB [m, 2^D·F] → its canonical [m, F]
    gradient: each corner's column block rolled back by its slot shift and
    summed (``torch.roll`` has ``jnp.roll``'s sign)."""
    F = enc.n_features_per_level
    g = dB.view(dB.shape[0], -1, F)
    acc = None
    for c, s in enumerate(enc.brick_shifts[level]):
        gc = g[:, c, :]
        gc = gc if s == 0 else torch.roll(gc, s, dims=0)
        acc = gc if acc is None else acc + gc
    return acc


def table_grad(idx: torch.Tensor, w1: torch.Tensor, dout: torch.Tensor, enc) -> torch.Tensor:
    """d_table [Σm, F] from the saved idx [L, N], w1 [L, N, D] and the output
    cotangent dout [N, L·F]: per-level sort, sorted segment sum, corner
    reduction."""
    L, N = idx.shape
    D = enc.n_input_dims
    F = enc.n_features_per_level
    dout = dout.reshape(N, L, F).transpose(0, 1).float()  # [L, N, F]
    keys_s, perm = torch.sort(idx, dim=1, stable=True)
    w1_s = torch.gather(w1, 1, perm[:, :, None].expand(L, N, D))
    dout_s = torch.gather(dout, 1, perm[:, :, None].expand(L, N, F))
    levels = []
    for l in range(L):
        m = enc.level_sizes[l]
        dB = segsum.sorted_segment_rowsum(
            keys_s[l].contiguous(), w1_s[l].contiguous(), dout_s[l].contiguous(), m
        )
        levels.append(fold_corners(dB, enc, l))
    return torch.cat(levels, dim=0)


class GridEncodeFunction(torch.autograd.Function):
    """table [Σm, F], x [N, D] in [0,1] → [N, L·F], differentiable in both.
    The forward writes the slots and fractions only when the table needs a
    gradient (the sort + kernel A + rolls of :func:`table_grad` read them),
    and keeps the table and x only when x needs one (:func:`grid_encode_dx`,
    kernel F on the card). Under ``create_graph`` that d_x is recorded
    (:class:`GridEncodeDxFunction`, kernel J in its backward), unless the
    table needs a gradient too: a second-order gradient into the table is
    not computed, so that raises ``NotImplementedError``."""

    @staticmethod
    def forward(ctx, table, x, enc):
        out, idx, w1 = grid_encode(table, x, enc, with_fracs=ctx.needs_input_grad[0])
        ctx.save_for_backward(idx, w1, *((table, x) if ctx.needs_input_grad[1] else ()))
        ctx.enc = enc
        return out

    @staticmethod
    def backward(ctx, dout):
        _check_table_second_order(ctx.needs_input_grad[0] and torch.is_grad_enabled())
        idx, w1, *table_x = ctx.saved_tensors
        d_table = table_grad(idx, w1, dout, ctx.enc) if ctx.needs_input_grad[0] else None
        d_x = GridEncodeDxFunction.apply(*table_x, dout, ctx.enc) if ctx.needs_input_grad[1] else None
        return d_table, d_x, None
