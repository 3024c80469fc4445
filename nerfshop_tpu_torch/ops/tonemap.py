"""Tonemapping and colour-space curves.

Counterpart of ``nerfshop_tpu/ops/tonemap.py``.
"""

from __future__ import annotations

import torch

from nerfshop_tpu_torch.common import TonemapCurve


def srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0.04045, ((x + 0.055) / 1.055) ** 2.4, x / 12.92)


def linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    x = torch.clamp_min(x, 0.0)
    return torch.where(x > 0.0031308, 1.055 * x ** (1.0 / 2.4) - 0.055, 12.92 * x)


def tonemap_aces(x: torch.Tensor) -> torch.Tensor:
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def _hable_partial(x):
    A, B, C, D, E, F = 0.15, 0.50, 0.20, 0.20, 0.02, 0.30
    return ((x * (A * x + C * B) + D * E) / (x * (A * x + B) + D * F)) - E / F


def tonemap_hable(x: torch.Tensor) -> torch.Tensor:
    exposure_bias = 2.0
    return torch.clamp(_hable_partial(x * exposure_bias) / _hable_partial(11.2), 0.0, 1.0)


def tonemap_reinhard(x: torch.Tensor) -> torch.Tensor:
    return x / (1.0 + x)


def apply_tonemap(x: torch.Tensor, curve: TonemapCurve = TonemapCurve.Identity) -> torch.Tensor:
    if curve == TonemapCurve.Identity:
        return x
    if curve == TonemapCurve.ACES:
        return tonemap_aces(x)
    if curve == TonemapCurve.Hable:
        return tonemap_hable(x)
    if curve == TonemapCurve.Reinhard:
        return tonemap_reinhard(x)
    raise ValueError(curve)
