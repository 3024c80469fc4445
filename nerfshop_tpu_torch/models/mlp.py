"""Bias-free MLPs with bf16 operands and fp32 results.

Counterpart of ``nerfshop_tpu/models/mlp.py``. The JAX model casts each
layer's operands to bf16, takes the product with an fp32 result, and casts
each hidden activation back to bf16. Here the operands are rounded to bf16
and the product is taken in fp32 (``torch.matmul`` on bf16 tensors would
also round the result). A product of two bf16 values is exact in fp32, so
only the summation order differs from the JAX numerics. TF32 must stay off
for that: the package sets ``torch.backends.cuda.matmul.allow_tf32 = False``
when it is imported.

:meth:`MLP.forward` picks its path by device and grad mode, never by
failure: a CPU tensor runs the plain version
(:func:`~nerfshop_tpu_torch.ops.fused_mlp.fused_mlp_plain`); a CUDA tensor
runs, when no gradient is needed (render, grid refresh), the route its
shapes chose when it was built (``MLP.route``,
:func:`~nerfshop_tpu_torch.ops.fused_mlp.route`): kernel C
(``csrc/fused_mlp.cu``) where the kernel takes the MLP, else the GEMM route
(:func:`~nerfshop_tpu_torch.ops.fused_mlp.gemm_mlp`: the 256-wide, 4-layer
``CutlassMLP`` of ``configs/nerf/tpu_flagship.json``, a sigmoid output...);
a CUDA forward that needs a gradient (training) runs the plain version under
autograd, because kernel C has no backward yet.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch
from torch import nn

from nerfshop_tpu_torch.ops import fused_mlp


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    name = (name or "None").lower()
    return {
        "relu": torch.relu,
        "leakyrelu": lambda x: torch.nn.functional.leaky_relu(x, 0.01),
        "exponential": torch.exp,
        "sigmoid": torch.sigmoid,
        "sine": torch.sin,
        "squareplus": lambda x: 0.5 * (x + torch.sqrt(x * x + 4.0)),
        "softplus": torch.nn.functional.softplus,
        "tanh": torch.tanh,
        "none": lambda x: x,
    }[name]


class MLP(nn.Module):
    """Width-uniform hidden layers, no biases; ``weights.i`` is [fan_in, fan_out]."""

    def __init__(
        self,
        n_input_dims: int,
        n_output_dims: int,
        n_neurons: int = 64,
        n_hidden_layers: int = 1,
        activation: str = "ReLU",
        output_activation: str = "None",
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.n_input_dims = n_input_dims
        self.n_output_dims = n_output_dims
        self.activation = activation
        self.output_activation = output_activation
        ws = []
        for fan_in, fan_out in self.layer_dims(n_neurons, n_hidden_layers):
            # He-uniform, matching tcnn's default for ReLU nets
            bound = (6.0 / fan_in) ** 0.5
            w = torch.empty((fan_in, fan_out), dtype=torch.float32, device=device)
            ws.append(nn.Parameter(w.uniform_(-bound, bound, generator=generator)))
        self.weights = nn.ParameterList(ws)
        #: what a CUDA forward without a gradient runs: "fused" (kernel C)
        #: or "gemm" (the GEMM route), from the shapes
        self.route = fused_mlp.route(n_input_dims, n_neurons, n_hidden_layers, n_output_dims, activation,
                                     output_activation)

    def layer_dims(self, n_neurons: int, n_hidden_layers: int) -> List[tuple]:
        dims = [self.n_input_dims] + [n_neurons] * n_hidden_layers + [self.n_output_dims]
        return list(zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ws = list(self.weights)
        if x.device.type == "cpu" or fused_mlp.needs_grad(x, ws):
            return fused_mlp.fused_mlp_plain(x, ws, activation(self.activation), activation(self.output_activation))
        if x.device.type != "cuda":
            raise ValueError(f"MLP: unsupported device {x.device}")
        if self.route == "gemm":
            return fused_mlp.gemm_mlp(x, ws, self.activation, self.output_activation)
        return fused_mlp.fused_mlp_cuda(x.contiguous(), ws)


def build_network(cfg: dict, n_input_dims: int, n_output_dims: int, device=None, generator=None) -> MLP:
    """Factory from the JSON ``network`` block (otype FullyFusedMLP/CutlassMLP)."""
    return MLP(
        n_input_dims=n_input_dims,
        n_output_dims=n_output_dims,
        n_neurons=cfg.get("n_neurons", 64),
        n_hidden_layers=cfg.get("n_hidden_layers", 1),
        activation=cfg.get("activation", "ReLU"),
        output_activation=cfg.get("output_activation", "None"),
        device=device,
        generator=generator,
    )
