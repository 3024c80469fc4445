"""Torch-facing density module (pyngp parity): the NeRF network's density
features, differentiable twice in the positions.

Counterpart of ``nerfshop_tpu/torch_interop.py``, which exposes the same
surface as the reference's ``NerfNetworkModule`` (src/python_api.cu:
``fwd_density`` / ``bwd_density`` / ``bwd_bwd_input_density`` /
``n_density_output_dims``) through numpy round trips into JAX. Here the
network is a torch module already, so tensors go in and come out on the
model's device, and the gradients are ordinary autograd:

* forward = hash encode → density MLP (kernels B and C on the card; an
  ``.ingp`` table's plain layout encodes through kernel K);
* backward = the encode's position gradient (kernel F; L on the plain
  layout) under the MLP's;
* double backward with respect to the input = the backward of that
  (kernel J, ``ops/table_ops.py::GridEncodeDxFunction``; kernel M on the
  plain layout, ``ops/xor_encode.py::XorEncodeDxFunction``) and of the
  MLP's backward (plain autograd: kernel C is forward-only, and the ReLU's
  second derivative is zero, as JAX's).

The parameters are constants, as in the JAX closure: the positions and the
output cotangent are differentiated, never the weights. ``params`` is a
state dict of the model (the EMA copy, say); without it the model's own
parameters are used, detached.

Usage::

    mod = NerfDensityModule(model)
    feats = mod(positions)                    # [N, 16], differentiable
    (g,) = torch.autograd.grad(feats[:, 0].sum(), positions, create_graph=True)
    ((g.norm(dim=-1) - 1) ** 2).mean().backward()   # reaches positions
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from nerfshop_tpu_torch.models.nerf_network import NerfNetwork, density_features_with


class DensityFns:
    """Forward, backward and double backward of the density features of
    ``model`` at ``params`` (a state dict; the model's own when None),
    tensors in and out on the model's device."""

    def __init__(self, model: NerfNetwork, params: Optional[Dict[str, torch.Tensor]] = None):
        self.model = model
        src = model.state_dict() if params is None else params
        self.params = {k: v.detach() for k, v in src.items()}

    @property
    def n_density_output_dims(self) -> int:
        return int(self.model.density_mlp.n_output_dims)

    def features(self, positions: torch.Tensor) -> torch.Tensor:
        """Warped positions [N, 3] → density features [N, F], recorded by
        autograd when the positions need a gradient."""
        return density_features_with(self.model, self.params, positions)

    @torch.no_grad()
    def fwd_density(self, positions: torch.Tensor) -> torch.Tensor:
        return self.features(positions.float())

    def bwd_density(self, positions: torch.Tensor, d_output: torch.Tensor) -> torch.Tensor:
        """Σ d_output · features with respect to the positions → [N, 3]."""
        with torch.enable_grad():
            p = positions.detach().float().requires_grad_(True)
            (g,) = torch.autograd.grad(self.features(p), p, d_output.float())
        return g

    def bwd_bwd_input_density(
        self, positions: torch.Tensor, d_output: torch.Tensor, d_dpos: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The gradients of ⟨bwd_density(positions, d_output), d_dpos⟩ with
        respect to the positions and to d_output → (d_pos2 [N, 3], d_dout
        [N, F])."""
        with torch.enable_grad():
            p = positions.detach().float().requires_grad_(True)
            do = d_output.detach().float().requires_grad_(True)
            (g,) = torch.autograd.grad(self.features(p), p, do, create_graph=True)
            d_pos2, d_dout = torch.autograd.grad(g, (p, do), d_dpos.float())
        return d_pos2, d_dout


class NerfDensityModule(nn.Module):
    """``forward(positions)`` → the density features [N, F], differentiable
    through autograd twice in the positions: a ``create_graph`` gradient
    followed by a second backward gives what
    ``fns.bwd_bwd_input_density`` gives."""

    def __init__(self, model: NerfNetwork, params: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__()
        self.fns = DensityFns(model, params)
        self.n_density_output_dims = self.fns.n_density_output_dims

    def forward(self, positions: torch.Tensor) -> torch.Tensor:
        return self.fns.features(positions)
