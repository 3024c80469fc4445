"""Camera rays: pinhole + Brown–Conrady distortion + depth of field, the
latlong and f-theta lenses, and training-pixel draws.

Counterpart of ``nerfshop_tpu/ops/rays.py``: ``pixel_to_ray`` with
``_apply_distortion``/``iterative_undistort``, subpixel jitter and depth of
field, ``latlong_to_dir``/``dir_to_latlong``, ``latlong_ray``,
``ftheta_ray``, ``rays_for_image``, ``rodrigues`` / ``apply_pose_delta``,
the uniform branch of ``sample_training_pixels`` and its error-map branch
from given draws (:func:`pixels_from_error_map`), ``sample_training_rays``
split into its draws (:func:`draw_training_rays`) and the rays, targets
and images of given draws (:func:`training_rays_from_draws`), and
``rays_from_pixels`` with the learnable camera parameters (pose deltas and
the screen-space distortion map) and with rolling shutter and motion blur
(:func:`pose_lerp`, :func:`shutter_times`). Random draws are inputs
(:func:`pixels_from_uniform`, :func:`pixels_from_error_map`,
``subpixel_jitter``, ``dof_uv``, the shutter's ``shutter_xi``) or come from
an explicit generator.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

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


def rodrigues(rotvec: torch.Tensor) -> torch.Tensor:
    """[..., 3] axis-angle → [..., 3, 3] rotation matrices (the exp map),
    written on the unnormalized vector with smooth coefficient functions so
    that the gradient is finite at θ = 0, where the optimizer starts."""
    vx, vy, vz = rotvec[..., 0], rotvec[..., 1], rotvec[..., 2]
    zero = torch.zeros_like(vx)
    K = torch.stack(
        [torch.stack([zero, -vz, vy], -1), torch.stack([vz, zero, -vx], -1), torch.stack([-vy, vx, zero], -1)], -2
    )
    t2 = (rotvec * rotvec).sum(dim=-1)[..., None, None]
    small = t2 < 1e-8
    one = torch.ones_like(t2)
    t = torch.sqrt(torch.where(small, one, t2))
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)  # sin θ / θ
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / torch.where(small, one, t2))
    eye = torch.eye(3, dtype=rotvec.dtype, device=rotvec.device).expand(K.shape)
    return eye + a * K + b * (K @ K)


def apply_pose_delta(xform: torch.Tensor, rot_delta: torch.Tensor, trans_delta: torch.Tensor) -> torch.Tensor:
    """A [..., 3, 4] camera-to-world refined by an axis-angle rotation (left
    multiplied) and a translation."""
    rot = rodrigues(rot_delta) @ xform[..., :3, :3]
    t = xform[..., :3, 3] + trans_delta
    return torch.cat([rot, t[..., None]], dim=-1)


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


def error_map_cdf(error_map: torch.Tensor) -> torch.Tensor:
    """Per-image error maps [N, h, w] → one increasing sequence [N·h·w]
    (float64): image i's cells hold i + its normalized CDF over the cells'
    weights ``error_map + 1e-8`` (the probabilities of JAX's categorical
    over ``log(map + 1e-8)``). Built once a step, not once a ray."""
    N = error_map.shape[0]
    w = error_map.reshape(N, -1).double() + 1e-8
    cdf = torch.cumsum(w, dim=1)
    cdf = cdf / cdf[:, -1:]
    return (cdf + torch.arange(N, dtype=torch.float64, device=cdf.device)[:, None]).reshape(-1)


def error_map_cells(img_idx: torch.Tensor, u: torch.Tensor, cdf: torch.Tensor, n_cells: int) -> torch.Tensor:
    """Cells (row-major in the map) drawn by one uniform ``u`` [n] in [0, 1)
    a ray through the per-image CDF of :func:`error_map_cdf` → [n] int64."""
    i = img_idx.long()
    cell = torch.searchsorted(cdf, i.double() + u.double(), right=True) - i * n_cells
    return cell.clamp(0, n_cells - 1)


def pixels_from_cells(cells: torch.Tensor, jitter: torch.Tensor, map_shape: Tuple[int, int], W: int, H: int):
    """Error-map cells [n] and the cell jitter [n, 2] in [0, 1) → pixel
    coordinates [n, 2] (float), as JAX's error-map branch maps them."""
    eh, ew = map_shape
    cy = torch.div(cells, ew, rounding_mode="floor").to(torch.float32)
    cx = (cells % ew).to(torch.float32)
    px = torch.floor((cx + jitter[:, 0]) / ew * float(W)).clamp(0.0, W - 1.0)
    py = torch.floor((cy + jitter[:, 1]) / eh * float(H)).clamp(0.0, H - 1.0)
    return torch.stack([px, py], dim=-1)


def pixels_from_error_map(img_idx: torch.Tensor, u: torch.Tensor, error_map: torch.Tensor, images: torch.Tensor):
    """Error-map branch of sample_training_pixels from given draws: img_idx
    [n] int, u [n, 3] in [0, 1) (the cell's uniform, then the jitter in x
    and y), error_map [N, h, w] → (img_idx, pix [n, 2] float, targets [n, 4])."""
    N, H, W = images.shape[:3]
    eh, ew = error_map.shape[1:]
    cells = error_map_cells(img_idx, u[:, 0], error_map_cdf(error_map), eh * ew)
    pix = pixels_from_cells(cells, u[:, 1:], (eh, ew), W, H)
    ipix = pix.long()
    return img_idx, pix, images[img_idx.long(), ipix[:, 1], ipix[:, 0]]


def sample_training_pixels(n_rays: int, images: torch.Tensor, generator: torch.Generator):
    """Uniform (image, pixel) pairs drawn from ``generator`` → (img_idx, pix, targets)."""
    dev = images.device
    img_idx = torch.randint(0, images.shape[0], (n_rays,), generator=generator, device=dev)
    u = torch.rand((n_rays, 2), generator=generator, device=dev)
    return pixels_from_uniform(img_idx, u, images)


def draw_training_rays(n_rays: int, n_images: int, generator: torch.Generator, device,
                       image_pmf: Optional[torch.Tensor] = None, error_map: Optional[torch.Tensor] = None):
    """The draws of JAX's ``sample_training_rays`` from ``generator``:
    (img_idx [n] int64: uniform, or ∝ ``image_pmf`` + 1e-12; u [n, 2] in
    [0, 1): the pixel's uniforms, or with ``error_map`` [N, h, w] the jitter
    within the cell; cells [n] int64 ∝ the image's map + 1e-8, or None)."""
    if image_pmf is not None:
        cdf = torch.cumsum(image_pmf.double().to(device) + 1e-12, dim=0)
        xi = torch.rand((n_rays,), generator=generator, device=device, dtype=torch.float64)
        img_idx = torch.searchsorted(cdf / cdf[-1], xi, right=True).clamp_max(n_images - 1)
    else:
        img_idx = torch.randint(0, n_images, (n_rays,), generator=generator, device=device)
    cells = None
    if error_map is not None:
        eh, ew = error_map.shape[1:]
        xi = torch.rand((n_rays,), generator=generator, device=device)
        cells = error_map_cells(img_idx, xi, error_map_cdf(error_map), eh * ew)
    u = torch.rand((n_rays, 2), generator=generator, device=device)
    return img_idx, u, cells


def training_rays_from_draws(
    img_idx: torch.Tensor,
    u: torch.Tensor,
    cells: Optional[torch.Tensor],
    images: torch.Tensor,  # [N, H, W, 4]
    xforms: torch.Tensor,  # [N, 3, 4]
    focals: torch.Tensor,  # [N, 2]
    principals: torch.Tensor,  # [N, 2]
    distortions: Optional[torch.Tensor] = None,  # [N, 4]
    map_shape: Optional[Tuple[int, int]] = None,  # (h, w) of the error map the cells index
):
    """JAX's ``sample_training_rays`` from the draws of
    :func:`draw_training_rays`: the pixels (``floor(u · [W, H])``, or the
    error-map cells at ``map_shape`` with ``u`` as jitter), clipped to the
    image, their rgba and their rays through the pixel centres → (rays,
    targets [n, 4], img_idx)."""
    N, H, W = images.shape[:3]
    if cells is not None:
        pix = pixels_from_cells(cells, u, map_shape, W, H)
    else:
        pix = pixels_from_uniform(img_idx, u, images)[1]
    i, ipix = img_idx.long(), pix.long()
    targets = images[i, ipix[:, 1], ipix[:, 0]]
    res = torch.tensor([W, H], dtype=torch.float32, device=images.device)
    dist = distortions[i] if distortions is not None else None
    return pixel_to_ray(pix, xforms[i], focals[i], principals[i], res, dist), targets, img_idx


def sample_training_rays(n_rays: int, images: torch.Tensor, xforms: torch.Tensor, focals: torch.Tensor,
                         principals: torch.Tensor, generator: torch.Generator,
                         distortions: Optional[torch.Tensor] = None, image_pmf: Optional[torch.Tensor] = None,
                         error_map: Optional[torch.Tensor] = None):
    """Random (image, pixel) pairs → (rays [n_rays], rgba targets [n_rays,
    4], image indices): :func:`draw_training_rays`, then
    :func:`training_rays_from_draws`."""
    img_idx, u, cells = draw_training_rays(n_rays, images.shape[0], generator, images.device, image_pmf, error_map)
    map_shape = tuple(error_map.shape[1:]) if error_map is not None else None
    return training_rays_from_draws(img_idx, u, cells, images, xforms, focals, principals, distortions, map_shape)


def distortion_map_offset(dm: torch.Tensor, pix: torch.Tensor, resolution: torch.Tensor) -> torch.Tensor:
    """The learnable screen-space offset [n, 2] (in normalized image units)
    bilinearly sampled from ``dm`` [Hd, Wd, 2] at the pixels' UV, clamped at
    the edges (JAX's ``rays_from_pixels``; the reference's
    TrainableBuffer<2,2> distortion grid)."""
    Hd, Wd = dm.shape[:2]
    uv = pix / resolution
    fu = uv[:, 0] * Wd - 0.5
    fv = uv[:, 1] * Hd - 0.5
    u0 = torch.floor(fu).to(torch.int64).clamp(0, Wd - 1)
    v0 = torch.floor(fv).to(torch.int64).clamp(0, Hd - 1)
    u1 = (u0 + 1).clamp(0, Wd - 1)
    v1 = (v0 + 1).clamp(0, Hd - 1)
    du = (fu - u0).clamp(0, 1)[:, None]
    dv = (fv - v0).clamp(0, 1)[:, None]
    return (
        dm[v0, u0] * (1 - du) * (1 - dv)
        + dm[v0, u1] * du * (1 - dv)
        + dm[v1, u0] * (1 - du) * dv
        + dm[v1, u1] * du * dv
    )


def pose_lerp(xf_start: torch.Tensor, xf_end: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Per-element lerp of [..., 3, 4] camera matrices at times ``t`` [...]
    in [0, 1]: the matrix itself is lerped, not slerped, as the reference's
    rolling-shutter camera does."""
    t = t[..., None, None]
    return xf_start * (1.0 - t) + xf_end * t


def shutter_times(
    xi: torch.Tensor,  # [N] uniforms in [0, 1): the motion-blur draws
    pix: torch.Tensor,  # [N, 2] pixel coords
    resolution: torch.Tensor,  # [2] (W, H)
    rolling_shutter: torch.Tensor,  # [4] (offset, du, dv, motion-blur jitter)
) -> torch.Tensor:
    """Each ray's normalized exposure time rs.x + rs.y·u + rs.z·v + rs.w·ξ."""
    uv = pix / resolution
    rs = rolling_shutter
    return rs[0] + rs[1] * uv[..., 0] + rs[2] * uv[..., 1] + rs[3] * xi


def rays_from_pixels(
    img_idx: torch.Tensor,
    pix: torch.Tensor,
    xforms: torch.Tensor,  # [N, 3, 4]
    focals: torch.Tensor,  # [N, 2]
    principals: torch.Tensor,  # [N, 2]
    resolution: torch.Tensor,  # [2] (W, H)
    distortions: Optional[torch.Tensor] = None,  # [N, 4]
    camera_params: Optional[Dict[str, torch.Tensor]] = None,
    xforms_end: Optional[torch.Tensor] = None,  # [N, 3, 4] end-of-exposure poses
    rolling_shutter: Optional[torch.Tensor] = None,  # [4]
    shutter_xi: Optional[torch.Tensor] = None,  # [R] motion-blur uniforms
) -> RayBundle:
    """Rays through the given pixels of the given images, differentiable in
    ``camera_params``: per-image pose deltas ``rot`` and ``trans`` [N, 3]
    (applied per image, then gathered per ray) and, where it has one, the
    shared ``distortion_map`` [Hd, Wd, 2], whose offset moves the pixel
    before the ray is made. With ``xforms_end`` and ``rolling_shutter``,
    each ray's pose is lerped between its image's start and end poses at
    its :func:`shutter_times` (of the pixel before the distortion map's
    offset, and of ``shutter_xi``); the pose deltas, which act linearly on
    the matrix, move both ends alike."""
    i = img_idx.long()
    xf, xf_end = xforms, xforms_end
    shutter = xforms_end is not None and rolling_shutter is not None
    if shutter:
        if shutter_xi is None:
            raise ValueError("rolling shutter: rays_from_pixels needs the motion-blur draws shutter_xi")
        t = shutter_times(shutter_xi, pix, resolution, rolling_shutter)
    if camera_params is not None:
        xf = apply_pose_delta(xforms, camera_params["rot"], camera_params["trans"])
        if shutter:
            xf_end = apply_pose_delta(xforms_end, camera_params["rot"], camera_params["trans"])
        if "distortion_map" in camera_params:
            pix = pix + distortion_map_offset(camera_params["distortion_map"], pix, resolution) * resolution
    xf_ray = pose_lerp(xf[i], xf_end[i], t) if shutter else xf[i]
    dist = distortions[i] if distortions is not None else None
    return pixel_to_ray(pix, xf_ray, focals[i], principals[i], resolution, dist)
