"""Fused bias-free ReLU MLP forward: kernel C and its plain version.

Counterpart of the Pallas fused MLP ``scratch/probe_arch.py:52-65``
(``mlp_kern``), which computes ``nerfshop_tpu/models/mlp.py::MLP.apply``:
operands rounded to bf16, fp32 products, each hidden activation rounded back
to bf16, no activation after the last layer. On a CUDA tensor
:func:`fused_mlp_cuda` launches kernel C (``csrc/fused_mlp.cu``) or raises;
:func:`fused_mlp_plain` is the plain version, which the CPU and every
forward that needs a gradient run (kernel C has no backward).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from nerfshop_tpu_torch import kernels

#: the only hidden width kernel C takes
HIDDEN = 64
#: the widest input kernel C takes (it pads an input to whole 16-column
#: k-tiles with zeros)
MAX_INPUT = 64
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


def needs_grad(x: torch.Tensor, weights: Sequence[torch.Tensor]) -> bool:
    """True when autograd would record this forward: the plain version must
    run then, since kernel C has no backward."""
    return torch.is_grad_enabled() and (x.requires_grad or any(w.requires_grad for w in weights))


def check_supported(
    n_input_dims: int,
    n_neurons: int,
    n_hidden_layers: int,
    n_output_dims: int,
    activation: str,
    output_activation: str,
) -> None:
    """Raise ``ValueError`` unless kernel C computes this MLP."""
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
