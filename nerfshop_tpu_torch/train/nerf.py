"""NeRF training step, loss and density-grid update.

Counterpart of ``nerfshop_tpu/train/nerf.py``. The JAX ``make_grad_fn``
draws its randomness and computes the gradients in one function; here
:func:`grads_from_draws` takes every draw as an input (so it can be held to
the JAX step on the same draws) and :func:`train_step` draws them from a
``torch.Generator`` and calls it. Error map, envmap, camera/exposure
optimization, light directions and rolling shutter are not ported and
raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from nerfshop_tpu_torch.common import MIN_CONE_STEPSIZE, MIN_TRANSMITTANCE_EVAL, NERF_MIN_OPTICAL_THICKNESS
from nerfshop_tpu_torch.models import nerf_network as nn_lib
from nerfshop_tpu_torch.models.nerf_network import NerfNetwork
from nerfshop_tpu_torch.ops import composite as comp
from nerfshop_tpu_torch.ops import coords, grid as grid_lib, march, rays as rays_lib
from nerfshop_tpu_torch.train import losses as loss_lib
from nerfshop_tpu_torch.train.optim import TrainState


class DeviceDataset(NamedTuple):
    """Training data resident on one device."""

    images: torch.Tensor  # [N, H, W, 4]
    xforms: torch.Tensor  # [N, 3, 4]
    focals: torch.Tensor  # [N, 2]
    principals: torch.Tensor  # [N, 2]
    distortions: torch.Tensor  # [N, 4]

    @staticmethod
    def from_dataset(ds, device) -> "DeviceDataset":
        """From a ``data.nerf_loader.NerfDataset``."""
        rs = np.asarray(getattr(ds, "rolling_shutter", np.zeros(4)), np.float32)
        if getattr(ds, "xforms_end", None) is not None and (rs != 0).any():
            raise NotImplementedError("rolling-shutter / motion-blur training is not ported")
        if getattr(ds, "has_light_dirs", False) or getattr(ds, "n_extra_learnable_dims", 0):
            raise NotImplementedError("light dirs / extra network dims are not ported")

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        return DeviceDataset(
            images=t(ds.images),
            xforms=t(ds.xforms),
            focals=t(ds.focal_matrix()),
            principals=t(ds.principal_matrix()),
            distortions=t(ds.distortion_matrix()),
        )


@dataclass(frozen=True)
class NerfTrainConfig:
    n_rays_per_batch: int = 1 << 14
    k_samples: int = 32
    n_candidates: int = 1024
    cone_angle: float = 0.0
    near_distance: float = 0.2
    min_transmittance: float = MIN_TRANSMITTANCE_EVAL
    random_bg: bool = True
    aabb_scale: int = 1
    n_cascades: int = 1
    loss_type: str = "Huber"
    optimize_extrinsics: bool = False
    optimize_exposure: bool = False
    use_error_map: bool = False
    train_envmap: bool = False

    def __post_init__(self):
        for knob in ("optimize_extrinsics", "optimize_exposure", "use_error_map", "train_envmap"):
            if getattr(self, knob):
                raise NotImplementedError(f"{knob} is not ported")

    @staticmethod
    def for_aabb_scale(aabb_scale: int, **kw) -> "NerfTrainConfig":
        n_casc = max(1, int(math.ceil(math.log2(max(aabb_scale, 1)))) + 1)
        cone = 0.0 if aabb_scale <= 1 else 1.0 / 256.0
        return NerfTrainConfig(aabb_scale=aabb_scale, n_cascades=n_casc, cone_angle=cone, **kw)


def nerf_loss_fn(
    model: NerfNetwork,
    samples: march.SampleBatch,
    origins: torch.Tensor,
    directions: torch.Tensor,
    targets: torch.Tensor,  # [R, 4] straight alpha
    bg_color: torch.Tensor,  # [R, 3]
    aabb: coords.BoundingBox,
    loss_fn: Callable,
    min_transmittance: float,
    near_distance: float = 0.0,
    mean_grid_density: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, dict]:
    """Photometric loss over the composited rays plus the reference's output
    regularizers (HDR colour, early density floor, near-distance penalty)."""
    R, K = samples.t.shape
    pos_w, dir_w = march.samples_to_network_inputs(samples, origins, directions, aabb)
    raw_rgb, raw_sigma = model.raw_forward(pos_w.reshape(R * K, 3), dir_w.reshape(R * K, 3))
    rgb = nn_lib.rgb_activation_fn(raw_rgb, model.rgb_activation).reshape(R, K, 3)
    sigma = nn_lib.density_activation_fn(raw_sigma, model.density_activation).reshape(R, K)
    raw_sigma = raw_sigma.reshape(R, K)

    res = comp.composite(sigma, rgb, samples.dt, samples.t, samples.valid, min_transmittance)
    pred = comp.composite_with_background(res, bg_color)
    target_rgb = targets[:, :3] * targets[:, 3:4] + bg_color * (1.0 - targets[:, 3:4])
    per_ray = loss_fn(target_rgb, pred).mean(dim=-1)
    loss = per_ray.mean()

    valid_f = samples.valid.to(torch.float32)
    if model.rgb_activation == "exponential":
        loss = loss + 1e-4 * 0.5 * (torch.relu(raw_rgb.reshape(R, K, 3)).square() * valid_f[..., None]).sum() / R
    if mean_grid_density is not None:
        l1_on = (mean_grid_density * MIN_CONE_STEPSIZE < NERF_MIN_OPTICAL_THICKNESS).to(torch.float32)
        loss = loss + l1_on * 1e-4 * (torch.relu(-raw_sigma) * valid_f).sum() / R
    if near_distance > 0:
        near_mask = (samples.t < near_distance) & samples.valid & (raw_sigma > -10.0)
        loss = loss + 1e-4 * torch.where(near_mask, raw_sigma, torch.zeros_like(raw_sigma)).sum() / R

    aux = {
        "loss": loss.detach(),
        "per_ray_loss": per_ray.detach(),
        "measured_samples": samples.n.sum(),
        "mean_opacity": res.opacity.mean().detach(),
    }
    return loss, aux


def grads_from_draws(
    model: NerfNetwork,
    grid: grid_lib.OccupancyGrid,
    data: DeviceDataset,
    cfg: NerfTrainConfig,
    img_idx: torch.Tensor,  # [R] int
    pix: torch.Tensor,  # [R, 2] pixel coords (float)
    t_jitter: torch.Tensor,  # [R] in [0, 1)
    spread: torch.Tensor,  # [R, K] in [0, 1)
    bg: torch.Tensor,  # [R, 3]
) -> Tuple[Dict[str, torch.Tensor], dict]:
    """Rays → training march → network → composite + loss → gradients of
    every model parameter, from the given draws. Makes no random draws."""
    aabb = coords.BoundingBox.from_aabb_scale(cfg.aabb_scale, device=pix.device)
    N, H, W = data.images.shape[:3]
    res = torch.stack([torch.full((), float(W), device=pix.device), torch.full((), float(H), device=pix.device)])
    ipix = pix.long()
    targets = data.images[img_idx.long(), ipix[:, 1], ipix[:, 0]]
    bundle = rays_lib.rays_from_pixels(img_idx, pix, data.xforms, data.focals, data.principals, res, data.distortions)
    samples = march.march_rays_training(
        bundle.origins, bundle.directions, grid.occupancy, aabb.min, aabb.max, cfg.cone_angle,
        t_jitter, spread, t_start_min=min(0.05, cfg.near_distance),
        k_samples=cfg.k_samples, n_candidates=cfg.n_candidates,
    )
    loss, aux = nerf_loss_fn(
        model, samples, bundle.origins, bundle.directions, targets, bg, aabb,
        loss_lib.LOSSES[cfg.loss_type], cfg.min_transmittance,
        near_distance=cfg.near_distance, mean_grid_density=grid.mean_density,
    )
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    aux["sample_overflow_frac"] = (samples.n >= cfg.k_samples).to(torch.float32).mean()
    return dict(zip(names, grads)), aux


def draw_step(cfg: NerfTrainConfig, data: DeviceDataset, generator: torch.Generator):
    """The draws of one training step → (img_idx, pix, t_jitter, spread, bg)."""
    dev = data.images.device
    R, K = cfg.n_rays_per_batch, cfg.k_samples
    img_idx, pix, _ = rays_lib.sample_training_pixels(R, data.images, generator)
    t_jitter = torch.rand((R,), generator=generator, device=dev)
    spread = torch.rand((R, K), generator=generator, device=dev)
    if cfg.random_bg:
        bg = torch.rand((R, 3), generator=generator, device=dev)
    else:
        bg = torch.zeros((R, 3), device=dev)
    return img_idx, pix, t_jitter, spread, bg


def train_step(
    state: TrainState,
    grid: grid_lib.OccupancyGrid,
    data: DeviceDataset,
    cfg: NerfTrainConfig,
    generator: torch.Generator,
) -> dict:
    """One optimization step from fresh draws; returns the step's aux."""
    grads, aux = grads_from_draws(state.model, grid, data, cfg, *draw_step(cfg, data, generator))
    state.apply_gradients(grads)
    return aux


def make_density_fn(
    model: NerfNetwork, aabb: coords.BoundingBox, operators: tuple = (), params: Optional[Dict[str, torch.Tensor]] = None
):
    """World positions [N, 3] → activated density [N] (for the grid update),
    with ``params`` (a state dict such as the EMA copy) or the model's own.
    With edit operators, positions are warped through the stack
    newest-first and vacated source positions read −1, the sentinel on
    which the grid update clears a cell outright."""

    def fn(pos_world: torch.Tensor) -> torch.Tensor:
        kill = None
        if operators:
            from nerfshop_tpu_torch.editing import operators as op_lib

            pos_world, kill = op_lib.map_positions_through_stack(list(operators), pos_world)
        pos_w = torch.clamp(coords.warp_position(pos_world, aabb), 0.0, 1.0)
        sigma = nn_lib.density_with(model, params, pos_w)
        if kill is not None:
            sigma = torch.where(kill, torch.full_like(sigma, -1.0), sigma)
        return sigma

    return fn


@torch.no_grad()
def update_grid(
    model: NerfNetwork,
    grid: grid_lib.OccupancyGrid,
    cfg: NerfTrainConfig,
    generator: torch.Generator,
    full_refresh: bool,
    trained_mask: Optional[torch.Tensor] = None,
    operators: tuple = (),
    params: Optional[Dict[str, torch.Tensor]] = None,
) -> grid_lib.OccupancyGrid:
    """Density refresh + EMA + bitfield rebuild (every 16 training steps, and
    after every change to the edit stack). Cells outside every training
    camera's view (``trained_mask`` False) are set to density −1 and so
    never become occupied. ``operators`` and ``params`` go to
    :func:`make_density_fn`."""
    dev = grid.density.device
    aabb = coords.BoundingBox.from_aabb_scale(cfg.aabb_scale, device=dev)
    z_lo, jitter = grid_lib.draw_refresh(cfg.n_cascades, full_refresh, generator, dev)
    grid_lib.update_density_grid(
        grid, make_density_fn(model, aabb, operators, params), cfg.n_cascades, full_refresh, z_lo, jitter
    )
    if trained_mask is not None:
        grid.density.masked_fill_(~trained_mask, -1.0)
    return grid_lib.update_bitfield(grid)
