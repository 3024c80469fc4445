"""Camera rays: pinhole + Brown–Conrady distortion + depth of field, the
latlong and f-theta lenses, and training-pixel draws.

Counterpart of ``nerfshop_tpu/ops/rays.py``: ``pixel_to_ray`` with
``_apply_distortion``/``iterative_undistort``, subpixel jitter and depth of
field, ``latlong_to_dir``/``dir_to_latlong``, ``latlong_ray``,
``ftheta_ray``, ``rays_for_image``, the uniform branch of
``sample_training_pixels`` and ``rays_from_pixels`` without camera
parameters or rolling shutter. Random draws are inputs
(:func:`pixels_from_uniform`, ``subpixel_jitter``, ``dof_uv``) or come from
an explicit generator.
"""

from __future__ import annotations

import math
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


def _rotate(rot: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """rot [3, 3] or [..., 3, 3] applied to d [..., 3]."""
    return (rot * d[..., None, :]).sum(dim=-1)


def pixel_to_ray(
    pixel_xy: torch.Tensor,  # [..., 2] (x = col, y = row)
    xform: torch.Tensor,  # [3, 4] or [..., 3, 4] camera-to-world
    focal: torch.Tensor,  # [2] or [..., 2]
    principal: torch.Tensor,  # [2] or [..., 2], normalized
    resolution: torch.Tensor,  # [2] (W, H)
    distortion: Optional[torch.Tensor] = None,  # [4] or [..., 4]
    subpixel_jitter: Optional[torch.Tensor] = None,  # [..., 2] in [0, 1)
    aperture: float = 0.0,
    focus_z: float = 1.0,
    dof_uv: Optional[torch.Tensor] = None,  # [..., 2] unit-disc samples
    snap_to_center: bool = True,
) -> RayBundle:
    """Ray through a pixel; the camera looks down +z with image y down. With
    ``aperture > 0`` and ``dof_uv`` the origin moves on the lens disc and the
    ray re-aims at the focal plane ``focus_z``."""
    offset = subpixel_jitter if subpixel_jitter is not None else (0.5 if snap_to_center else 0.0)
    uv = (pixel_xy + offset - principal * resolution) / focal
    if distortion is not None:
        uv = iterative_undistort(uv, distortion)
    d_cam = torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)
    rot = xform[..., :, :3]
    direction = _rotate(rot, d_cam)
    origin = torch.broadcast_to(xform[..., :, 3], direction.shape)
    if aperture > 0.0 and dof_uv is not None:
        focus_point = origin + direction * focus_z
        lens = dof_uv * aperture
        origin = origin + rot[..., :, 0] * lens[..., :1] + rot[..., :, 1] * lens[..., 1:2]
        direction = focus_point - origin
    direction = direction / torch.linalg.norm(direction, dim=-1, keepdim=True)
    return RayBundle(origin, direction)


def latlong_to_dir(uv: torch.Tensor) -> torch.Tensor:
    """Equirectangular UV in [0,1]² → camera-local direction (v latitude,
    u longitude, u = 0.5 looking down +z)."""
    theta = (uv[..., 1] - 0.5) * math.pi
    phi = (uv[..., 0] - 0.5) * (2.0 * math.pi)
    ct = torch.cos(theta)
    return torch.stack([torch.sin(phi) * ct, torch.sin(theta), torch.cos(phi) * ct], dim=-1)


def dir_to_latlong(d: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`latlong_to_dir` → UV in [0,1]²."""
    theta = torch.arcsin(torch.clamp(d[..., 1], -1.0, 1.0))
    phi = torch.atan2(d[..., 0], d[..., 2])
    return torch.stack([phi / (2.0 * math.pi) + 0.5, theta / math.pi + 0.5], dim=-1)


def latlong_ray(
    pixel_xy: torch.Tensor,  # [..., 2]
    xform: torch.Tensor,  # [3, 4]
    resolution: torch.Tensor,  # [2] (W, H)
    subpixel_jitter: Optional[torch.Tensor] = None,
) -> RayBundle:
    """360° panorama rays."""
    offset = subpixel_jitter if subpixel_jitter is not None else 0.5
    direction = _rotate(xform[:, :3], latlong_to_dir((pixel_xy + offset) / resolution))
    return RayBundle(torch.broadcast_to(xform[:, 3], direction.shape), direction)


def ftheta_ray(
    pixel_xy: torch.Tensor,  # [..., 2]
    xform: torch.Tensor,  # [3, 4]
    principal: torch.Tensor,  # [2] normalized
    resolution: torch.Tensor,  # [2] (W, H)
    ftheta_coeffs: torch.Tensor,  # [5] polynomial p0..p4: θ(r) in radians
    subpixel_jitter: Optional[torch.Tensor] = None,
) -> RayBundle:
    """Fisheye f-theta lens: the image radius r (pixels from the principal
    point) maps to the polar angle θ = Σ pᵢ rⁱ; the azimuth is kept."""
    offset = subpixel_jitter if subpixel_jitter is not None else 0.5
    xy = pixel_xy + offset - principal * resolution
    r = torch.sqrt((xy * xy).sum(dim=-1) + 1e-12)
    c = ftheta_coeffs
    theta = c[0] + r * (c[1] + r * (c[2] + r * (c[3] + r * c[4])))
    st, ct = torch.sin(theta), torch.cos(theta)
    d_cam = torch.stack([xy[..., 0] / r * st, xy[..., 1] / r * st, ct], dim=-1)
    direction = _rotate(xform[:, :3], d_cam)
    direction = direction / torch.linalg.norm(direction, dim=-1, keepdim=True)
    return RayBundle(torch.broadcast_to(xform[:, 3], direction.shape), direction)


def rays_for_image(
    resolution: Tuple[int, int],  # (W, H)
    xform: torch.Tensor,
    focal: torch.Tensor,
    principal: torch.Tensor,
    distortion: Optional[torch.Tensor] = None,
    subpixel_jitter: Optional[torch.Tensor] = None,  # [H·W, 2]
    lens: str = "pinhole",
    ftheta_coeffs: Optional[torch.Tensor] = None,
    aperture: float = 0.0,
    focus_z: float = 1.0,
    dof_uv: Optional[torch.Tensor] = None,  # [H·W, 2]
) -> RayBundle:
    """All pixels of an image, row-major → origins/directions [H·W, 3].
    ``lens`` is 'pinhole' (with optional distortion and depth of field),
    'ftheta' (needs ``ftheta_coeffs``) or 'latlong'."""
    W, H = resolution
    dev = xform.device
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev),
        torch.arange(W, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)
    res = torch.tensor([float(W), float(H)], device=dev)
    if lens == "latlong":
        return latlong_ray(pix, xform, res, subpixel_jitter)
    if lens == "ftheta":
        if ftheta_coeffs is None:
            raise ValueError("lens='ftheta' requires ftheta_coeffs [5]")
        return ftheta_ray(pix, xform, principal, res, ftheta_coeffs, subpixel_jitter)
    return pixel_to_ray(
        pix, xform, focal, principal, res, distortion, subpixel_jitter,
        aperture=aperture, focus_z=focus_z, dof_uv=dof_uv,
    )


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
