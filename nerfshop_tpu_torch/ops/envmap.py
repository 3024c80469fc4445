"""Environment map: a trainable lat-long background radiance.

Counterpart of ``nerfshop_tpu/ops/envmap.py`` (the reference's envmap.cuh
``read_envmap``: a bilinear lat-long lookup, wrapping in φ, clamped in θ).
The map is a parameter [H, W, 4]; rays that leave the scene composite
``T_end · envmap(dir)`` and autograd carries the gradient to the map. The
lookups are a ray's four row gathers over a 64 × 128 × 4 map, plain torch:
XLA fused the JAX version with no Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def direction_to_latlong_uv(dirs: torch.Tensor) -> torch.Tensor:
    """Unit world directions [..., 3] → lat-long UV in [0, 1]² (u from
    atan2 around the up axis, v from acos of z)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    u = torch.atan2(y, x) / (2.0 * math.pi) + 0.5
    v = torch.arccos(torch.clamp(z, -1.0, 1.0)) / math.pi
    return torch.stack([u, v], dim=-1)


def sample_envmap(envmap: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Bilinear lat-long sample: envmap [H, W, 4], unit dirs [N, 3] → [N, 4];
    φ wraps, θ clamps. Differentiable in the map (and the directions)."""
    H, W = envmap.shape[:2]
    uv = direction_to_latlong_uv(dirs)
    fu = uv[..., 0] * W - 0.5
    fv = uv[..., 1] * H - 0.5
    u0 = torch.floor(fu)
    v0 = torch.floor(fv)
    du = (fu - u0)[..., None]
    dv = (fv - v0)[..., None]
    u0i = torch.remainder(u0.to(torch.int64), W)
    u1i = torch.remainder(u0i + 1, W)
    v0i = torch.clamp(v0.to(torch.int64), 0, H - 1)
    v1i = torch.clamp(v0i + 1, 0, H - 1)
    flat = envmap.reshape(H * W, envmap.shape[-1])
    c00 = flat[v0i * W + u0i]
    c01 = flat[v0i * W + u1i]
    c10 = flat[v1i * W + u0i]
    c11 = flat[v1i * W + u1i]
    top = c00 * (1 - du) + c01 * du
    bot = c10 * (1 - du) + c11 * du
    return top * (1 - dv) + bot * dv


def create_envmap(resolution: Tuple[int, int] = (64, 128), init_value: float = 0.0, device=None) -> torch.Tensor:
    """A fresh envmap [H, W, 4] (rgb and the reference's unused alpha)."""
    H, W = resolution
    return torch.full((H, W, 4), init_value, dtype=torch.float32, device=device)


def load_envmap(path: str, device=None) -> torch.Tensor:
    """An EXR or PNG image as the envmap's start (read linear, alpha 1
    where the image has none)."""
    from nerfshop_tpu_torch.data import image_io

    img = np.asarray(image_io.read_image(path, linear=True), np.float32)
    if img.shape[-1] == 3:
        img = np.concatenate([img, np.ones_like(img[..., :1])], -1)
    return torch.as_tensor(np.ascontiguousarray(img), device=device)
