"""Volume compositing as differentiable tensor ops.

Counterpart of ``nerfshop_tpu/ops/composite.py``::

    τ_i = σ_i·dt_i,  T_i = exp(−Σ_{j<i} τ_j),  α_i = 1 − exp(−τ_i),  w_i = T_i·α_i

Samples with T_i below ``min_transmittance`` get zero weight through a mask
(the reference's early-out), so autograd stops there exactly as ``jax.grad``
does. The depth gather goes through :mod:`~nerfshop_tpu_torch.ops.gather`
(kernel D on a CUDA device).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nerfshop_tpu_torch.ops.gather import take_along


class CompositeResult(NamedTuple):
    rgb: torch.Tensor  # [R, 3] composited radiance (before background)
    opacity: torch.Tensor  # [R] = 1 − T_end
    transmittance: torch.Tensor  # [R]
    depth: torch.Tensor  # [R] t of the max-weight sample
    weights: torch.Tensor  # [R, K]
    n_used: torch.Tensor  # [R] samples before the cutoff


def composite(
    sigmas: torch.Tensor,  # [R, K] activated density
    rgbs: torch.Tensor,  # [R, K, 3]
    dts: torch.Tensor,  # [R, K]
    ts: torch.Tensor,  # [R, K]
    valid: torch.Tensor,  # [R, K] bool
    min_transmittance: float = 1e-4,
) -> CompositeResult:
    zero = torch.zeros_like(dts)
    tau = torch.where(valid, sigmas * dts, zero)
    cum = torch.cumsum(tau, dim=-1)
    T_before = torch.exp(-(cum - tau))  # exclusive
    alive = T_before >= min_transmittance
    alpha = 1.0 - torch.exp(-tau)
    w = torch.where(valid & alive, T_before * alpha, zero)
    rgb = torch.einsum("rk,rkc->rc", w, rgbs)
    opacity = w.sum(dim=-1)
    depth = take_along(ts, torch.argmax(w, dim=-1, keepdim=True), axis=1)[:, 0]
    n_used = (valid & alive).sum(dim=-1).to(torch.int32)
    return CompositeResult(rgb, opacity, 1.0 - opacity, depth, w, n_used)


def composite_with_background(result: CompositeResult, background: torch.Tensor) -> torch.Tensor:
    """rgb over a [R, 3] (or [3]) background colour."""
    return result.rgb + result.transmittance[:, None] * background
