"""The one-network field of the Image, SDF and Volume testbeds.

The JAX package builds each of those models (``ImageModel``, ``SdfModel``,
``VolumeModel``) from the same two parts, an encoding and an MLP, with the
params pytree ``{"encoding": {"table"}, "network": {"weights"}}``; here
they share :class:`FieldModel`, whose parameter names are those paths.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from nerfshop_tpu_torch.models import encodings as enc
from nerfshop_tpu_torch.models import mlp as mlp_lib


class FieldModel(nn.Module):
    """Encoding → MLP, the one-network field of the Image, SDF and Volume
    testbeds. Its parameters are ``encoding.table`` and
    ``network.weights.i``, the JAX params pytree's paths."""

    def __init__(self, encoding: nn.Module, network: mlp_lib.MLP):
        super().__init__()
        self.encoding = encoding
        self.network = network

    @classmethod
    def build(cls, config: dict, n_input_dims: int, n_output_dims: int, device=None, generator=None, octree=None):
        """From the config's ``encoding`` and ``network`` blocks; ``octree``
        feeds a Takikawa encoding."""
        e = enc.build_encoding(
            dict(config.get("encoding", {})), n_input_dims, device=device, generator=generator, octree=octree
        )
        net = mlp_lib.build_network(dict(config.get("network", {})), e.n_output_dims, n_output_dims, device, generator)
        return cls(e, net)

    def raw(self, x: torch.Tensor) -> torch.Tensor:
        return self.network(self.encoding(x))

    def apply(self, params: Optional[Dict[str, torch.Tensor]], x: torch.Tensor):
        """The forward with ``params`` (a state dict, e.g. detached inference
        parameters) in place of the module's own; its own when None."""
        if params is None:
            return self(x)
        return torch.func.functional_call(self, params, (x,))
