"""Disney ("principled") BRDF shading for the SDF renderer.

Counterpart of ``nerfshop_tpu/ops/brdf.py``: Burley's Disney BRDF
(diffuse + subsurface approximation + GGX specular + sheen + clearcoat,
ambient mixed by metallic), elementwise over [N] hits, with the same
defaults and the same early-out to ambient at grazing or back-facing hits.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch


@dataclass
class BrdfParams:
    """Material knobs (the reference's ``Testbed::m_brdf`` defaults)."""

    metallic: float = 0.0
    subsurface: float = 0.0
    specular: float = 1.0
    roughness: float = 0.5
    sheen: float = 0.0
    clearcoat: float = 0.0
    clearcoat_gloss: float = 1.0
    basecolor: Tuple[float, float, float] = (0.8, 0.8, 0.8)
    ambientcolor: Tuple[float, float, float] = (1.0, 1.0, 1.0)


def _schlick(u):
    return torch.clamp(1.0 - u, 0.0, 1.0) ** 5


def _gtr1(ndoth, a):
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * ndoth * ndoth
    return (a2 - 1.0) / (math.pi * math.log(a2 + 1e-12) * t + 1e-12)


def _gtr2(ndoth, a):
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * ndoth * ndoth
    return a2 / (math.pi * t * t + 1e-12)


def _smith_ggx(ndotv, a):
    a2 = a * a
    b = ndotv * ndotv
    return 1.0 / (ndotv + torch.sqrt(a2 + b - a2 * b) + 1e-12)


def disney_shade(
    base_color: torch.Tensor,  # [N, 3]
    ambient_color: torch.Tensor,  # [N, 3] or [3]
    light_color: torch.Tensor,  # [N, 3] or [3]
    p: BrdfParams,
    L: torch.Tensor,  # [3] unit light direction
    V: torch.Tensor,  # [N, 3] unit view direction (surface → eye)
    N: torch.Tensor,  # [N, 3] unit normals
) -> torch.Tensor:
    """Disney BRDF · N·L · light + metallic-mixed ambient, per hit → [N, 3]."""
    ndotl = (N * L).sum(-1)
    ndotv = (N * V).sum(-1)
    H = L + V
    H = H / (torch.linalg.vector_norm(H, dim=-1, keepdim=True) + 1e-12)
    ndoth = (N * H).sum(-1)
    ldoth = (H * L).sum(-1)

    fl, fv = _schlick(ndotl), _schlick(ndotv)
    amb = ambient_color * (0.2 + (fv - 0.2) * p.metallic)[..., None] * base_color

    # specular_tint and sheen_tint are 0 at the reference's call site
    ones = torch.ones(3, dtype=N.dtype, device=N.device)
    cspec0 = ones * p.specular * 0.08 * (1.0 - p.metallic) + base_color * p.metallic

    fd90 = 0.5 + 2.0 * ldoth * ldoth * p.roughness
    fd = (1.0 + (fd90 - 1.0) * fl) * (1.0 + (fd90 - 1.0) * fv)

    fss90 = ldoth * ldoth * p.roughness
    fss = (1.0 + (fss90 - 1.0) * fl) * (1.0 + (fss90 - 1.0) * fv)
    ss = 1.25 * (fss * (1.0 / (ndotl + ndotv + 1e-12) - 0.5) + 0.5)

    a = max(0.001, p.roughness**2)
    ds = _gtr2(ndoth, a)
    fh = _schlick(ldoth)
    fs = cspec0 * (1.0 - fh[..., None]) + fh[..., None]
    gs = _smith_ggx(ndotl, a) * _smith_ggx(ndotv, a)

    fsheen = fh[..., None] * p.sheen * ones

    dr = _gtr1(ndoth, 0.1 + (0.001 - 0.1) * p.clearcoat_gloss)
    fr = 0.04 + 0.96 * fh
    gr = _smith_ggx(ndotl, 0.25) * _smith_ggx(ndotv, 0.25)
    ccs = 0.25 * p.clearcoat * gr * fr * dr

    diffuse_mix = fd * (1.0 - p.subsurface) + ss * p.subsurface
    brdf = (
        (diffuse_mix[..., None] / math.pi * base_color + fsheen) * (1.0 - p.metallic)
        + (gs * ds)[..., None] * fs
        + ccs[..., None]
    )
    lit = brdf * light_color * torch.clamp_min(ndotl, 0.0)[..., None] + amb
    front = (ndotl > 0.0) & (ndotv > 0.0)
    return torch.where(front[..., None], lit, amb)
