"""Exact frame rendering: rays → march → field → composite, chunk by chunk.

Counterpart of the exact path of ``nerfshop_tpu/render/renderer.py``:
``RenderOptions``, ``FrameOutput``, ``_compacted_field_eval``,
``_eval_window``, ``_render_chunk`` and ``render_frame``. Each pixel chunk
runs one occupancy march with the whole sample budget (``k_samples ×
n_windows``, selection "first", the density-grid early stop), one field
evaluation (the hash-grid encode is kernel B and both MLPs are kernel C on
a CUDA device, since nothing here needs a gradient), and one composite with
the transmittance cutoff. The field sees every slot, or with
``compact_frac > 0`` only the valid ones, gathered into a fixed slab of
``compact_frac`` of the slots (JAX's budget; valid slots past it read
σ = 0 and rgb = 0). With edit operators, every slot's world position and
direction go through the stack newest-first (``editing/operators.py``)
before the field, and vacated samples get σ = 0. A stack with a Poisson
membrane also sums the membranes' residuals and blends them in
(``membrane_mode`` "target" or "additive"); "target" evaluates the density
once more, at the unwarped positions, in the chunks whose stack has a
membrane.

The march fields (the dilated coarse occupancy and the occupancy-masked
density) are built once per frame and handed to every chunk's march.

``RenderMode.Normals`` shades each slot with −∇σ / |∇σ| at its (warped)
position, the gradient taken by autograd per chunk through the encode's
position gradient (kernel F on the card) with detached parameters, so that
no table gradient is formed; as in JAX it evaluates every slot.

With an ``envmap`` (the trainable lat-long background) the shaded modes
composite it behind transparent pixels, as JAX's per-ray renderer does.
``extra_dims`` [E] (a warped light direction) goes to every sample of a
network with extra dims and is ignored by one without, as in JAX. The
tiled render paths stay with the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from nerfshop_tpu_torch.common import MIN_CONE_STEPSIZE, MIN_TRANSMITTANCE_RENDER, RenderMode
from nerfshop_tpu_torch.models.nerf_network import density_with, forward_with
from nerfshop_tpu_torch.ops import composite as comp
from nerfshop_tpu_torch.ops import coords, march
from nerfshop_tpu_torch.ops import rays as rays_lib
from nerfshop_tpu_torch.ops.envmap import sample_envmap
from nerfshop_tpu_torch.ops.gather import take_rows

NEAR_DISTANCE_RENDER = 0.05


@dataclass(frozen=True)
class RenderOptions:
    """The fields and defaults of the JAX ``RenderOptions``. ``eval_slab``
    and ``n_edit_operators`` serve the tiled path and the compiled-chunk
    cache of the JAX package, which are not ported; they are kept so that
    options move between the two packages unchanged. ``membrane_mode``:
    "target" clamps σ to min(max(σ_target, σ_src), σ_src + σ_resid), with
    σ_target the field at the unwarped position; "additive" adds σ_resid."""

    k_samples: int = 32
    n_candidates: int = 1024
    n_windows: int = 2
    cone_angle: float = 0.0
    aabb_scale: int = 1
    min_transmittance: float = MIN_TRANSMITTANCE_RENDER
    chunk: int = 1 << 13
    mode: RenderMode = RenderMode.Shade
    use_grid_early_stop: bool = True
    background: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    compact_frac: float = 0.0
    eval_slab: int = 16
    slice_z: float = 0.5
    membrane_mode: str = "target"
    n_edit_operators: int = 0
    render_aabb: Optional[Tuple[Tuple[float, float, float], Tuple[float, float, float]]] = None
    aperture: float = 0.0
    focus_z: float = 1.0


class FrameOutput(NamedTuple):
    rgba: torch.Tensor  # [H, W, 4]
    depth: torch.Tensor  # [H, W]


def _field(model, params: Optional[Dict[str, torch.Tensor]], extra: Optional[torch.Tensor] = None):
    """(warped pos [N, 3], warped dir [N, 3]) → activated (rgb [N, 3], σ [N])
    with ``params`` (a state dict, e.g. the EMA copy) or the model's own, and
    ``extra`` [E] appended to every direction."""
    if extra is None:
        return lambda p, d: forward_with(model, params, p, d)
    return lambda p, d: forward_with(model, params, p, d, extra.expand(p.shape[0], -1))


def compact_budget(n_slots: int, compact_frac: float) -> int:
    """The compaction slab's rows: ``int(n_slots · compact_frac)`` rounded
    up to a multiple of 256 (JAX's ``_eval_window``); the field sees every
    slot unless 0 < budget < n_slots."""
    budget = int(n_slots * compact_frac)
    return -(-budget // 256) * 256 if budget > 0 else 0


def _compacted_field_eval(field, pos: torch.Tensor, dirs: torch.Tensor, valid: torch.Tensor, budget: int):
    """``field(pos, dirs) → (rgb, σ)`` on the rows where ``valid`` only,
    through a fixed slab of ``budget`` rows; valid rows past the budget read
    σ = 0 and rgb = 0 (JAX's ``_compacted_field_eval``). Fixed shapes and no
    host read: ranks by a cumsum; slab slot i takes the row of rank i + 1,
    found by a binary search of the ranks (a gather, where JAX scatters
    every row into a slab with a dump row: on the card every row that is
    not kept would write that one row); the field on the slab; a gather
    back. Slots past the last valid row hold some row whose result no row
    reads."""
    ranks = torch.cumsum(valid.to(torch.int32), 0, dtype=torch.int32)  # inclusive
    ok = valid & (ranks <= budget)
    slot = torch.clamp(ranks - 1, 0, budget - 1)
    wanted = torch.arange(1, budget + 1, dtype=torch.int32, device=pos.device)
    src = torch.clamp(torch.searchsorted(ranks, wanted), max=pos.shape[0] - 1)
    rgb_c, sig_c = field(take_rows(pos.contiguous(), src), take_rows(dirs.contiguous(), src))
    zero = torch.zeros((), dtype=sig_c.dtype, device=sig_c.device)
    sigma = torch.where(ok, take_rows(sig_c.contiguous(), slot), zero)
    rgb = torch.where(ok[:, None], take_rows(rgb_c.contiguous(), slot), zero)
    return rgb, sigma


def _eval_window(field, samples: march.SampleBatch, origins, directions, opts: RenderOptions, aabb, operators=(),
                 density=None):
    """Field evaluation of every slot of one march, through the edit stack
    when there is one → (σ [R, K], rgb [R, K, 3]). ``density``: warped
    positions → σ, read by the "target" membrane blend."""
    R, K = samples.t.shape
    empty = resid = None
    if operators:
        from nerfshop_tpu_torch.editing import operators as op_lib

        pos_world = (origins[:, None, :] + samples.t[..., None] * directions[:, None, :]).reshape(-1, 3)
        dirs_world = directions[:, None, :].expand(R, K, 3).reshape(-1, 3)
        if op_lib.has_membrane(operators):
            p, dvec, empty, *resid = op_lib.map_samples_through_stack_full(list(operators), pos_world, dirs_world)
        else:
            p, dvec, empty = op_lib.map_samples_through_stack(list(operators), pos_world, dirs_world)
        pos_w = torch.clamp(coords.warp_position(p, aabb), 0.0, 1.0)
        dir_w = coords.warp_direction(dvec)
    else:
        pos_w, dir_w = march.samples_to_network_inputs(samples, origins, directions, aabb)
    flat_pos = pos_w.reshape(R * K, 3)
    flat_dir = dir_w.reshape(R * K, 3)
    budget = compact_budget(R * K, opts.compact_frac)
    if opts.mode == RenderMode.Normals:
        # JAX's autodiff of the density sum; σ from the same forward
        with torch.enable_grad():
            p = flat_pos.detach().requires_grad_(True)
            sig = density(p)
            (grad,) = torch.autograd.grad(sig.sum(), p)
        normals = -grad / (torch.linalg.vector_norm(grad, dim=-1, keepdim=True) + 1e-9)
        rgb = normals * 0.5 + 0.5
        sigma = sig.detach()
    elif opts.mode == RenderMode.Positions:
        rgb = flat_pos
        sigma = field(flat_pos, flat_dir)[1]
    elif 0 < budget < R * K:
        # after the warp, before the empty mask and the membrane blend
        rgb, sigma = _compacted_field_eval(field, flat_pos, flat_dir, samples.valid.reshape(-1), budget)
    else:
        rgb, sigma = field(flat_pos, flat_dir)
    if empty is not None:
        # vacated source samples: α = 0 at composite time
        sigma = torch.where(empty, torch.zeros_like(sigma), sigma)
    if resid is not None:
        # the outside density gates the blend and weights the colour mix; the
        # residual density bounds the σ clamp; a vacated sample stays σ = 0
        resid_sigma, resid_out, resid_rgb = resid
        on = (resid_out > 1e-9) & ~empty
        dt = samples.dt.reshape(-1)
        alpha_n = 1.0 - torch.exp(-sigma * dt)
        alpha_r = 1.0 - torch.exp(-resid_out * dt)
        den = alpha_n + alpha_r
        w_n = torch.where(den > 1e-12, alpha_n / torch.clamp_min(den, 1e-12), torch.ones_like(den))
        rgb_mix = w_n[:, None] * rgb + (1.0 - w_n)[:, None] * resid_rgb
        if opts.membrane_mode == "target":
            # σ_target: the receiving scene's own density at the unwarped position
            sigma_tgt = density(torch.clamp(coords.warp_position(pos_world, aabb), 0.0, 1.0))
            sigma_new = torch.minimum(torch.maximum(sigma_tgt, sigma), sigma + resid_sigma)
        else:
            sigma_new = sigma + resid_sigma
        sigma = torch.where(on, sigma_new, sigma)
        rgb = torch.where(on[:, None], rgb_mix, rgb)
    return sigma.reshape(R, K), rgb.reshape(R, K, 3)


def _render_chunk(field, grid, fields, origins, directions, opts: RenderOptions, bg, operators=(), density=None,
                  envmap=None):
    """One pixel chunk → (rgba [R, 4], depth [R]); with ``envmap`` the
    shaded modes composite it behind transparent pixels (alpha 1)."""
    dev = origins.device
    aabb = coords.BoundingBox.from_aabb_scale(opts.aabb_scale, device=dev)
    R = origins.shape[0]
    if opts.mode == RenderMode.Slice:
        # density on the view-aligned plane at t = slice_z, one sample per pixel
        t_s = torch.full((R,), float(opts.slice_z), device=dev)
        pw = torch.clamp(coords.warp_position(origins + t_s[:, None] * directions, aabb), 0.0, 1.0)
        rgb_sl, sig_sl = field(pw, coords.warp_direction(directions))
        a = 1.0 - torch.exp(-sig_sl * 0.01)
        return torch.cat([rgb_sl * a[:, None], a[:, None]], dim=-1), t_s
    # marching is clipped to the crop box; the field still warps by the full box
    if opts.render_aabb is not None:
        lo, hi = opts.render_aabb
        march_box = coords.BoundingBox(
            torch.tensor(lo, dtype=torch.float32, device=dev), torch.tensor(hi, dtype=torch.float32, device=dev)
        )
    else:
        march_box = aabb
    K = opts.k_samples * max(1, opts.n_windows)
    coarse, fine = fields
    samples = march.march_rays(
        origins, directions, grid.occupancy, march_box.min, march_box.max, opts.cone_angle,
        t_start_min=NEAR_DISTANCE_RENDER, k_samples=K, n_candidates=opts.n_candidates,
        use_grid_early_stop=opts.use_grid_early_stop, selection="first",
        coarse_field=coarse, fine_field=fine,
    )
    sigma, rgb_s = _eval_window(field, samples, origins, directions, opts, aabb, operators, density)
    res = comp.composite(sigma, rgb_s, samples.dt, samples.t, samples.valid, opts.min_transmittance)
    ones3 = torch.ones((1, 3), device=dev)
    if opts.mode in (RenderMode.Depth, RenderMode.Distance):
        # t is already the euclidean distance along the unit ray
        rgba = torch.cat([res.depth[:, None] * ones3, res.opacity[:, None]], dim=-1)
    elif opts.mode == RenderMode.Stepsize:
        dt0 = torch.where(samples.valid[:, 0], samples.dt[:, 0], torch.zeros_like(samples.dt[:, 0])) / MIN_CONE_STEPSIZE
        rgba = torch.cat([dt0[:, None] * ones3, torch.ones((R, 1), device=dev)], dim=-1)
    elif opts.mode == RenderMode.Cost:
        v = res.n_used.to(torch.float32) / K
        rgba = torch.cat([v[:, None] * ones3, torch.ones((R, 1), device=dev)], dim=-1)
    elif opts.mode == RenderMode.AO:
        rgba = torch.cat([res.opacity[:, None] * ones3, res.opacity[:, None]], dim=-1)
    elif envmap is not None:
        bg_ray = sample_envmap(envmap, directions)
        rgba = torch.cat([res.rgb + res.transmittance[:, None] * bg_ray[:, :3],
                          (res.opacity + res.transmittance)[:, None]], dim=-1)
    else:
        rgb_out = res.rgb + res.transmittance[:, None] * bg[:3]
        alpha = res.opacity + res.transmittance * bg[3]
        rgba = torch.cat([rgb_out, alpha[:, None]], dim=-1)
    return rgba, res.depth


def march_fields(grid) -> Tuple[torch.Tensor, torch.Tensor]:
    """The frame's march fields: (dilated coarse occupancy, occupancy-masked
    density), both flat, built once and shared by every chunk."""
    coarse = march.build_coarse_occupancy(grid.occupancy).reshape(-1)
    fine = march.masked_density_field(grid.occupancy, grid.density).reshape(-1)
    return coarse, fine


@torch.no_grad()
def render_frame(
    model,
    params: Optional[Dict[str, torch.Tensor]],
    grid,
    resolution: Tuple[int, int],  # (W, H)
    xform: torch.Tensor,  # [3, 4]
    focal: torch.Tensor,  # [2] pixels
    principal: Optional[torch.Tensor] = None,  # [2] normalized
    distortion: Optional[torch.Tensor] = None,
    opts: RenderOptions = RenderOptions(),
    subpixel_jitter: Optional[torch.Tensor] = None,  # [H·W, 2]
    operators: tuple = (),
    envmap: Optional[torch.Tensor] = None,
    lens: str = "pinhole",
    ftheta_coeffs: Optional[torch.Tensor] = None,
    dof_uv: Optional[torch.Tensor] = None,  # [H·W, 2] unit-disc lens samples
    extra_dims: Optional[torch.Tensor] = None,
) -> FrameOutput:
    """Render one frame in pixel chunks of ``opts.chunk`` rays. ``params`` is
    a state dict of ``model`` (e.g. the EMA copy) or None for the model's
    own parameters. ``lens`` is 'pinhole', 'ftheta' or 'latlong'. ``envmap``
    [h, w, 4] (the trainable lat-long background) replaces the background
    colour behind transparent pixels. ``extra_dims`` [E] goes to every
    sample of a model with ``n_extra_dims``."""
    if envmap is not None and (envmap.dim() != 3 or envmap.shape[-1] < 3):
        raise ValueError(f"envmap: expected a lat-long map [h, w, 4], got shape {tuple(envmap.shape)}")
    if extra_dims is not None and extra_dims.dim() != 1:
        raise ValueError(f"extra_dims: expected one vector [E], got shape {tuple(extra_dims.shape)}")
    if not getattr(model, "n_extra_dims", 0):
        extra_dims = None
    W, H = resolution
    dev = grid.occupancy.device
    principal = torch.tensor([0.5, 0.5], device=dev) if principal is None else principal
    bundle = rays_lib.rays_for_image(
        (W, H), xform, focal, principal, distortion, subpixel_jitter, lens=lens, ftheta_coeffs=ftheta_coeffs,
        aperture=opts.aperture, focus_z=opts.focus_z, dof_uv=dof_uv,
    )
    bg = torch.tensor(opts.background, dtype=torch.float32, device=dev)
    rgba, depth = render_rays(model, params, grid, bundle.origins, bundle.directions, opts, bg, operators, envmap,
                              extra_dims)
    return FrameOutput(rgba.reshape(H, W, 4), depth.reshape(H, W))


@torch.no_grad()
def render_rays(
    model,
    params: Optional[Dict[str, torch.Tensor]],
    grid,
    origins: torch.Tensor,  # [n, 3]
    directions: torch.Tensor,  # [n, 3]
    opts: RenderOptions,
    bg: torch.Tensor,  # [4]
    operators: tuple = (),
    envmap: Optional[torch.Tensor] = None,
    extra_dims: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rays → (rgba [n, 4], depth [n]) through :func:`_render_chunk` in
    chunks of ``opts.chunk`` rays, the last padded to a whole chunk (rays
    from the origin along +z); :func:`render_frame`'s loop, also called on
    a slice of a frame's rays (``parallel/mesh.py``). ``extra_dims`` as in
    :func:`render_frame`, for a model with extra dims."""
    dev = grid.occupancy.device
    n = origins.shape[0]
    chunk = min(opts.chunk, n)
    n_pad = (-n) % chunk
    origins = torch.cat([origins, torch.zeros((n_pad, 3), device=dev)])
    dirs = torch.cat([directions, torch.tensor([[0.0, 0.0, 1.0]], device=dev).expand(n_pad, 3)])
    if opts.mode == RenderMode.Normals:
        # the gradient is taken with respect to positions only
        params = dict(model.state_dict()) if params is None else {k: v.detach() for k, v in params.items()}
    field = _field(model, params, extra_dims)
    fields = march_fields(grid)
    rgba, depth = [], []
    for i in range(0, n + n_pad, chunk):
        rgba_c, depth_c = _render_chunk(
            field, grid, fields, origins[i : i + chunk], dirs[i : i + chunk], opts, bg, tuple(operators),
            lambda p: density_with(model, params, p), envmap,
        )
        rgba.append(rgba_c)
        depth.append(depth_c)
    return torch.cat(rgba)[:n], torch.cat(depth)[:n]
