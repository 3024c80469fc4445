"""The MLP forward on the card: kernel C, the GEMM route, and their plain
version.

Counterpart of the Pallas fused MLP ``scratch/probe_arch.py:52-65``
(``mlp_kern``), which computes ``nerfshop_tpu/models/mlp.py::MLP.apply``:
operands rounded to bf16, fp32 products, each hidden activation rounded back
to bf16, the last product kept in fp32. On a CUDA tensor
:func:`fused_mlp_cuda` launches kernel C (``csrc/fused_mlp.cu``) or raises;
:func:`fused_mlp_plain` is the plain version, which the CPU and every
forward that needs a gradient run (kernel C has no backward).

An MLP outside kernel C's range (:func:`check_supported`: another hidden
width or depth, a non-ReLU activation, an output activation, more than 128
inputs or more than 16 outputs) takes :func:`gemm_mlp` instead, a chain of
cuBLAS GEMMs: JAX computes every MLP as a chain of ``dot_general``s outside
any Pallas kernel (tcnn's ``CutlassMLP`` is a GEMM chain too), so no
hand-written kernel replaces it. :func:`route` names the path an MLP's
shapes take, once, when the MLP is built.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from nerfshop_tpu_torch import kernels

#: the only hidden width kernel C takes
HIDDEN = 64
#: the widest input kernel C takes (it pads an input to whole 16-column
#: k-tiles with zeros): 80 for the Takikawa encoding at its defaults, 72
#: for Frequency's, 48 for OneBlob's, 36 for TriangleWave's
MAX_INPUT = 128
#: largest output width kernel C takes (the last layer is padded to 8 or 16)
MAX_OUTPUT = 16


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def fused_mlp_plain(
    x: torch.Tensor,
    weights: Sequence[torch.Tensor],
    act: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
    out_act: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """Plain version: operands rounded to bf16 and multiplied in fp32 (exact
    products without TF32, which the package turns off), hidden activations
    rounded back to bf16. Differentiable through autograd."""
    h = bf16_round(x)
    n = len(weights)
    for i, w in enumerate(weights):
        h = torch.matmul(h, bf16_round(w))
        if i < n - 1:
            h = bf16_round(act(h))
    return h if out_act is None else out_act(h)


def _rounds_with_bf16(name: str) -> bool:
    """True when the activation commutes with rounding to bf16
    (act(bf16(h)) = bf16(act(h))): ReLU and the identity."""
    return (name or "None").lower() in ("relu", "none")


@kernels.counted("launches")
def gemm_mlp(x: torch.Tensor, weights: Sequence[torch.Tensor], activation: str = "ReLU",
             output_activation: str = "None") -> torch.Tensor:
    """The GEMM route: x [..., n_in] f32, weights [fan_in, fan_out] f32
    (any widths and depth) → [..., n_out] f32, what
    :func:`fused_mlp_plain` computes. A hidden layer is one bf16 GEMM (cuBLAS,
    fp32 sums) whose output is rounded to bf16 once, as the plain version
    rounds each hidden activation, then the activation; where the activation
    does not commute with that rounding (not ReLU or the identity) the layer
    is an fp32 GEMM of the bf16-rounded operands, the activation in fp32,
    then the rounding, as the plain version. The last layer is an fp32 GEMM
    of the bf16-rounded operands (exact products: TF32 is off), then the
    output activation. The bf16 GEMMs sum in fp32 as JAX's do: cuBLAS's
    reduced-precision bf16 reductions are off for the call and restored
    after it. Records no gradient. On CPU tensors the same chain
    runs through PyTorch's CPU GEMMs (the tests hold it to the plain
    version there); ``launches`` counts the calls on the card."""
    from nerfshop_tpu_torch.models.mlp import activation as act_fn

    act, out_act = act_fn(activation), act_fn(output_activation)
    fast = _rounds_with_bf16(activation)
    matmul_flags = torch.backends.cuda.matmul
    reduced = matmul_flags.allow_bf16_reduced_precision_reduction
    matmul_flags.allow_bf16_reduced_precision_reduction = False
    try:
        with torch.no_grad():
            h = x.to(torch.bfloat16)
            n = len(weights)
            for i, w in enumerate(weights):
                wb = w.detach().to(torch.bfloat16)
                if i == n - 1:
                    h = torch.matmul(h.float(), wb.float())
                elif fast:
                    h = act(torch.matmul(h, wb))
                else:
                    h = act(torch.matmul(h.float(), wb.float())).to(torch.bfloat16)
            out = out_act(h)
    finally:
        matmul_flags.allow_bf16_reduced_precision_reduction = reduced
    gemm_mlp.launches += x.device.type == "cuda"
    return out


def route(n_input_dims: int, n_neurons: int, n_hidden_layers: int, n_output_dims: int, activation: str,
          output_activation: str) -> str:
    """The path a CUDA forward that records no gradient takes for this MLP:
    ``"fused"`` (kernel C) where :func:`check_supported` accepts it, else
    ``"gemm"`` (:func:`gemm_mlp`). Chosen from the shapes, never from a
    failure."""
    return "gemm" if _problems(n_input_dims, n_neurons, n_hidden_layers, n_output_dims, activation,
                               output_activation) else "fused"


def needs_grad(x: torch.Tensor, weights: Sequence[torch.Tensor]) -> bool:
    """True when autograd would record this forward: the plain version must
    run then, since kernel C has no backward."""
    return torch.is_grad_enabled() and (x.requires_grad or any(w.requires_grad for w in weights))


def _problems(n_input_dims: int, n_neurons: int, n_hidden_layers: int, n_output_dims: int, activation: str,
              output_activation: str) -> list:
    """What keeps kernel C from computing this MLP (empty: nothing)."""
    problems = []
    if (activation or "None").lower() != "relu":
        problems.append(f"activation {activation!r} (ReLU only)")
    if (output_activation or "None").lower() != "none":
        problems.append(f"output activation {output_activation!r} (None only)")
    if not 1 <= n_input_dims <= MAX_INPUT:
        problems.append(f"input width {n_input_dims} (1..{MAX_INPUT})")
    if n_neurons != HIDDEN:
        problems.append(f"hidden width {n_neurons} ({HIDDEN} only)")
    if n_hidden_layers not in (1, 2):
        problems.append(f"{n_hidden_layers} hidden layers (1 or 2)")
    if not 1 <= n_output_dims <= MAX_OUTPUT:
        problems.append(f"output width {n_output_dims} (1..{MAX_OUTPUT})")
    return problems


def check_supported(
    n_input_dims: int,
    n_neurons: int,
    n_hidden_layers: int,
    n_output_dims: int,
    activation: str,
    output_activation: str,
) -> None:
    """Raise ``ValueError`` unless kernel C computes this MLP."""
    problems = _problems(n_input_dims, n_neurons, n_hidden_layers, n_output_dims, activation, output_activation)
    if problems:
        raise ValueError("kernel C (fused_mlp) does not take this MLP: " + "; ".join(problems))


@kernels.counted("launches")
def fused_mlp_cuda(x: torch.Tensor, weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """Kernel C: x [..., n_in] f32 contiguous, weights [fan_in, fan_out] f32
    (ReLU hidden layers, no output activation) → [..., n_out] f32. Raises on
    anything out of its range."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"fused_mlp kernel: tensor on {dev}, expected a CUDA device")
    ws = [w.detach() for w in weights]
    n_in, n_out = x.shape[-1], ws[-1].shape[1]
    check_supported(n_in, ws[0].shape[1], len(ws) - 1, n_out, "ReLU", "None")
    N = x.numel() // n_in
    kernels.require(x, "x", torch.float32, tuple(x.shape), dev)
    kernels.require(ws[0], "w_in", torch.float32, (n_in, HIDDEN), dev)
    for w in ws[1:-1]:
        kernels.require(w, "w_hidden", torch.float32, (HIDDEN, HIDDEN), dev)
    kernels.require(ws[-1], "w_out", torch.float32, (HIDDEN, n_out), dev)
    out = torch.empty((*x.shape[:-1], n_out), dtype=torch.float32, device=dev)
    lib = kernels.load()
    err = lib.nst_fused_mlp(
        x.data_ptr(), ws[0].data_ptr(), ws[1].data_ptr() if len(ws) == 3 else None, ws[-1].data_ptr(),
        out.data_ptr(), N, n_in, len(ws) - 1, n_out, kernels.stream_ptr(dev),
    )
    kernels.check(err, "fused_mlp")
    fused_mlp_cuda.launches += 1
    return out
