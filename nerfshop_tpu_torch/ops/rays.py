"""Camera rays for training: pinhole + Brown–Conrady distortion.

Counterpart of ``nerfshop_tpu/ops/rays.py``: ``pixel_to_ray`` with
``_apply_distortion``/``iterative_undistort``, ``rays_for_image``, the
uniform branch of ``sample_training_pixels`` and ``rays_from_pixels``
without camera parameters or rolling shutter. Random draws are inputs
(:func:`pixels_from_uniform`) or come from an explicit generator.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class RayBundle(NamedTuple):
    origins: torch.Tensor  # [..., 3]
    directions: torch.Tensor  # [..., 3] unit length


def _apply_distortion(uv: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Forward Brown–Conrady distortion of normalized camera coords;
    ``dist`` is [4] or broadcastable [..., 4]."""
    k1, k2, p1, p2 = dist[..., 0], dist[..., 1], dist[..., 2], dist[..., 3]
    x, y = uv[..., 0], uv[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * k2)
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y)
    return torch.stack([xd, yd], dim=-1)


def iterative_undistort(uv: torch.Tensor, dist: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Invert the distortion by fixed-point iteration."""
    cur = uv
    for _ in range(iters):
        cur = uv - (_apply_distortion(cur, dist) - cur)
    return cur


def pixel_to_ray(
    pixel_xy: torch.Tensor,  # [..., 2] (x = col, y = row)
    xform: torch.Tensor,  # [3, 4] or [..., 3, 4] camera-to-world
    focal: torch.Tensor,  # [2] or [..., 2]
    principal: torch.Tensor,  # [2] or [..., 2], normalized
    resolution: torch.Tensor,  # [2] (W, H)
    distortion: Optional[torch.Tensor] = None,  # [4] or [..., 4]
) -> RayBundle:
    """Ray through a pixel centre; the camera looks down +z with image y down."""
    uv = (pixel_xy + 0.5 - principal * resolution) / focal
    if distortion is not None:
        uv = iterative_undistort(uv, distortion)
    d_cam = torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)
    rot = xform[..., :, :3]
    direction = (rot * d_cam[..., None, :]).sum(dim=-1)
    origin = torch.broadcast_to(xform[..., :, 3], direction.shape)
    direction = direction / torch.linalg.norm(direction, dim=-1, keepdim=True)
    return RayBundle(origin, direction)


def rays_for_image(
    resolution: Tuple[int, int],  # (W, H)
    xform: torch.Tensor,
    focal: torch.Tensor,
    principal: torch.Tensor,
    distortion: Optional[torch.Tensor] = None,
) -> RayBundle:
    """All pixels of an image, row-major → origins/directions [H·W, 3]."""
    W, H = resolution
    dev = xform.device
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev),
        torch.arange(W, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)
    res = torch.stack([torch.full((), float(W), device=dev), torch.full((), float(H), device=dev)])
    return pixel_to_ray(pix, xform, focal, principal, res, distortion)


def pixels_from_uniform(img_idx: torch.Tensor, u: torch.Tensor, images: torch.Tensor):
    """Uniform branch of sample_training_pixels from given draws:
    img_idx [n] int, u [n, 2] in [0,1) → (img_idx, pix [n, 2] float, targets [n, 4])."""
    N, H, W = images.shape[:3]
    px = torch.floor(u[:, 0] * float(W)).clamp(0.0, W - 1.0)
    py = torch.floor(u[:, 1] * float(H)).clamp(0.0, H - 1.0)
    pix = torch.stack([px, py], dim=-1)
    ipix = pix.long()
    targets = images[img_idx.long(), ipix[:, 1], ipix[:, 0]]
    return img_idx, pix, targets


def sample_training_pixels(n_rays: int, images: torch.Tensor, generator: torch.Generator):
    """Uniform (image, pixel) pairs drawn from ``generator`` → (img_idx, pix, targets)."""
    dev = images.device
    img_idx = torch.randint(0, images.shape[0], (n_rays,), generator=generator, device=dev)
    u = torch.rand((n_rays, 2), generator=generator, device=dev)
    return pixels_from_uniform(img_idx, u, images)


def rays_from_pixels(
    img_idx: torch.Tensor,
    pix: torch.Tensor,
    xforms: torch.Tensor,  # [N, 3, 4]
    focals: torch.Tensor,  # [N, 2]
    principals: torch.Tensor,  # [N, 2]
    resolution: torch.Tensor,  # [2] (W, H)
    distortions: Optional[torch.Tensor] = None,  # [N, 4]
) -> RayBundle:
    """Rays through the given pixels of the given images."""
    i = img_idx.long()
    dist = distortions[i] if distortions is not None else None
    return pixel_to_ray(pix, xforms[i], focals[i], principals[i], resolution, dist)
