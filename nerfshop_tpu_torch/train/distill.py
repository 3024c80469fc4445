"""Distillation: bake the edit stack into a standalone NeRF.

Counterpart of ``nerfshop_tpu/train/distill.py``: teacher–student field
distillation. The teacher is the trained network seen through the edit
operator stack (what the edited renderer shows: the warp, the emptied
source and the membrane's residuals); the student is a network of the same
shape queried at the unwarped positions, trained to match the teacher's σ
and rgb per sample, the teacher's composited colour per ray, and the
photographs on rays that cross no edit.

As ``train/nerf.py`` splits the training step, :func:`distill_grads_from_draws`
takes every draw as an input and :func:`draw_distill_step` makes them from a
``torch.Generator``. The teacher's values are computed without a gradient.
The student evaluates its marched samples and its free and edit-region
samples in two forwards, as JAX does: one forward of both sets gives the
same values, but the MLP weights' gradients, taken with bf16 operands, then
round once instead of per set, 2.1-2.9e-3 relative (L2) from JAX's against
1e-5 with two (measured on the CPU parity test).
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from nerfshop_tpu_torch.editing import operators as op_lib
from nerfshop_tpu_torch.models.nerf_network import density_with, forward_with
from nerfshop_tpu_torch.ops import composite as comp
from nerfshop_tpu_torch.ops import coords, march
from nerfshop_tpu_torch.ops import rays as rays_lib
from nerfshop_tpu_torch.train import nerf as nerf_train
from nerfshop_tpu_torch.train import optim


@dataclass(frozen=True)
class DistillConfig:
    n_rays_per_batch: int = 1 << 13
    k_samples: int = 32
    cone_angle: float = 0.0
    aabb_scale: int = 1
    near_distance: float = 0.05
    field_loss_weight: float = 1.0
    pixel_loss_weight: float = 1.0
    #: weight of the photo loss on rays that cross no edit region
    gt_loss_weight: float = 1.0
    min_transmittance: float = 1e-4
    #: uniform field samples over the scene box per step: the marched samples
    #: cover only the edited grid's occupied cells, and any unsupervised
    #: region would re-occupy the student's own grid as ghosts or haze
    n_free_samples: int = 16384
    #: samples drawn uniformly in each operator's source and target boxes:
    #: the vacated source is empty in the edited grid, so no marched ray
    #: supervises it
    n_edit_samples: int = 1 << 15


@torch.no_grad()
def teacher_field(model, params, operators: tuple, pos_world: torch.Tensor, dir_world: torch.Tensor, aabb):
    """The edited scene's field at deformed-space points: the warp through
    the stack, the trained network (``params``: its state dict, or None for
    its own), the emptied source and the membrane blend → (rgb, σ,
    touched): ``touched`` marks the samples whose value the stack changed
    (warped, emptied or membrane-corrected)."""
    p, dvec, empty, rs, ro, rc = op_lib.map_samples_through_stack_full(list(operators), pos_world, dir_world)
    pos_w = torch.clamp(coords.warp_position(p, aabb), 0.0, 1.0)
    rgb, sigma = forward_with(model, params, pos_w, coords.warp_direction(dvec))
    sigma = torch.where(empty, torch.zeros_like(sigma), sigma)
    # the emptied source comes before the membrane blend
    on = (ro > 1e-9) & ~empty
    if op_lib.has_membrane(operators):
        # σ clamped between the receiving scene's own value and src +
        # residual; the colour weight is the σ ratio (the α ratio's dt → 0
        # limit). Without a membrane `on` is all False and nothing changes.
        sigma_tgt = density_with(model, params, torch.clamp(coords.warp_position(pos_world, aabb), 0.0, 1.0))
        sigma_new = torch.minimum(torch.maximum(sigma_tgt, sigma), sigma + rs)
        den = sigma + ro
        w_n = torch.where(den > 1e-9, sigma / torch.clamp_min(den, 1e-9), torch.ones_like(den))
        rgb_mix = w_n[:, None] * rgb + (1.0 - w_n)[:, None] * rc
        sigma = torch.where(on, sigma_new, sigma)
        rgb = torch.where(on[:, None], rgb_mix, rgb)
    touched = empty | (torch.linalg.norm(p - pos_world, dim=-1) > 1e-6) | on
    return rgb, sigma, touched


_CORNERS = [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]


def _edit_region_bounds(operators: tuple, margin: float = 0.05):
    """Per operator, the world-space (lo, hi) boxes of the volume it
    affects: the source region (vacated cells) and the target region (where
    the moved content lives), each padded by ``margin`` of its size."""
    bounds = []

    def add(pts):
        lo, hi = pts.amin(dim=0), pts.amax(dim=0)
        pad = margin * (hi - lo) + 1e-4
        bounds.append((lo - pad, hi + pad))

    for op in operators:
        if isinstance(op, op_lib.CageDeformationOp):
            for verts in (op.verts_orig, op.verts_def):
                add(verts.reshape(-1, 3))
        elif isinstance(op, op_lib.AffineDuplicationOp):
            corners = torch.tensor(_CORNERS, dtype=torch.float32, device=op.box_half.device) * op.box_half
            src = corners @ op.box_rot + op.box_center  # box_rot rows = axes
            add(src)
            add(src @ op.transform_rot.T + op.transform_t)
    return bounds


class DistillDraws(NamedTuple):
    """The random draws of one distillation step."""

    img_idx: torch.Tensor  # [R] int
    pix: torch.Tensor  # [R, 2] pixel coords (float)
    t_jitter: torch.Tensor  # [R] in [0, 1)
    spread: torch.Tensor  # [R, K] in [0, 1)
    free_u: torch.Tensor  # [n_free, 3] in [0, 1): free samples over the scene box
    edit_u: torch.Tensor  # [n_regions, per, 3] in [0, 1): samples in the edit regions
    edit_normals: torch.Tensor  # [n_regions·per, 3] standard normals: their directions


def distill_grads_from_draws(
    model, teacher_params: Dict[str, torch.Tensor], operators: tuple, grid, data: nerf_train.DeviceDataset,
    cfg: DistillConfig, draws: DistillDraws,
) -> Tuple[Dict[str, torch.Tensor], dict]:
    """Rays → training march → teacher (no gradient) and student fields →
    field, pixel and photo losses → the gradients of every parameter of the
    student ``model``, from the given draws. ``grid`` is the EDITED
    occupancy grid (refreshed through the stack), so rays sample where the
    edited scene has content. Makes no random draws."""
    dev = draws.pix.device
    aabb = coords.BoundingBox.from_aabb_scale(cfg.aabb_scale, device=dev)
    operators = tuple(operators)
    H, W = data.images.shape[1:3]
    res = torch.tensor([float(W), float(H)], device=dev)
    ipix = draws.pix.long()
    targets = data.images[draws.img_idx.long(), ipix[:, 1], ipix[:, 0]]
    bundle = rays_lib.rays_from_pixels(draws.img_idx, draws.pix, data.xforms, data.focals, data.principals, res,
                                       data.distortions)
    samples = march.march_rays_training(
        bundle.origins, bundle.directions, grid.occupancy, aabb.min, aabb.max, cfg.cone_angle,
        draws.t_jitter, draws.spread, t_start_min=cfg.near_distance, k_samples=cfg.k_samples,
    )
    R, K = samples.t.shape
    pos_world = (bundle.origins[:, None, :] + samples.t[..., None] * bundle.directions[:, None, :]).reshape(-1, 3)
    dir_world = bundle.directions[:, None, :].expand(R, K, 3).reshape(-1, 3)
    t_rgb, t_sigma, touched = teacher_field(model, teacher_params, operators, pos_world, dir_world, aabb)
    # rays whose samples the stack leaves alone still match the photographs
    ray_clean = ~(touched.reshape(R, K) & samples.valid).any(dim=1)
    vmask = samples.valid.reshape(-1)

    # free samples over the box and dense samples in each edit region
    pos_free = aabb.min + draws.free_u * (aabb.max - aabb.min)
    dir_free = torch.tensor([[0.0, 0.0, 1.0]], device=dev).expand(pos_free.shape[0], 3)
    regions = _edit_region_bounds(operators)
    if regions and cfg.n_edit_samples > 0:
        pos_edit = torch.cat([lo + draws.edit_u[i] * (hi - lo) for i, (lo, hi) in enumerate(regions)])
        dir_edit = draws.edit_normals / (torch.linalg.norm(draws.edit_normals, dim=-1, keepdim=True) + 1e-9)
        pos_free = torch.cat([pos_free, pos_edit])
        dir_free = torch.cat([dir_free, dir_edit])
    nf = pos_free.shape[0]
    f_rgb, f_sigma, _ = teacher_field(model, teacher_params, operators, pos_free, dir_free, aabb)

    # the student: the marched samples, then the free ones (two forwards)
    s_rgb, s_sigma = model(torch.clamp(coords.warp_position(pos_world, aabb), 0.0, 1.0), coords.warp_direction(dir_world))
    zero = torch.zeros((), device=dev)
    # field matching in log-density space
    d_sig = torch.log1p(s_sigma) - torch.log1p(t_sigma)
    field = torch.where(vmask, d_sig.square(), zero).mean() + torch.where(
        vmask[:, None], (s_rgb - t_rgb).square(), zero).mean()
    # a linear push to 0 wherever the teacher is empty (the vacated source
    # and free space), where the log term's gradient vanishes
    empty_here = vmask & (t_sigma <= 1e-3)
    field = field + 4.0 * torch.where(empty_here, torch.log1p(s_sigma), zero).mean()
    if nf > 0:
        sf_rgb, sf_sigma = model(torch.clamp(coords.warp_position(pos_free, aabb), 0.0, 1.0),
                                 coords.warp_direction(dir_free))
        df = torch.log1p(sf_sigma) - torch.log1p(f_sigma)
        field = field + df.square().mean() + (sf_rgb - f_rgb).square().mean() + 4.0 * torch.where(
            f_sigma <= 1e-3, torch.log1p(sf_sigma), zero).mean()
    # pixel composite matching
    s_res = comp.composite(s_sigma.reshape(R, K), s_rgb.reshape(R, K, 3), samples.dt, samples.t, samples.valid,
                           cfg.min_transmittance)
    t_res = comp.composite(t_sigma.reshape(R, K), t_rgb.reshape(R, K, 3), samples.dt, samples.t, samples.valid,
                           cfg.min_transmittance)
    pix = (s_res.rgb - t_res.rgb).square().mean()
    # the photo loss on edit-free rays, over the photo's own alpha
    gt_rgb = targets[:, :3] * targets[:, 3:4]
    gt_err = (s_res.rgb - gt_rgb).square().mean(dim=-1)
    gt = torch.where(ray_clean, gt_err, zero).sum() / torch.clamp_min(ray_clean.float().sum(), 1.0)
    loss = cfg.field_loss_weight * field + cfg.pixel_loss_weight * pix + cfg.gt_loss_weight * gt

    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    aux = {"loss": loss.detach(), "field_loss": field.detach(), "pixel_loss": pix.detach(), "gt_loss": gt.detach()}
    return dict(zip(names, grads)), aux


def draw_distill_step(cfg: DistillConfig, data: nerf_train.DeviceDataset, generator: torch.Generator,
                      n_regions: int = 0) -> DistillDraws:
    """The draws of one distillation step; ``n_regions``: the number of edit
    regions (:func:`_edit_region_bounds`), over which ``n_edit_samples``
    are split evenly (rounded up)."""
    dev = data.images.device
    R, K = cfg.n_rays_per_batch, cfg.k_samples
    img_idx, pix, _ = rays_lib.sample_training_pixels(R, data.images, generator)
    t_jitter = torch.rand((R,), generator=generator, device=dev)
    spread = torch.rand((R, K), generator=generator, device=dev)
    free_u = torch.rand((cfg.n_free_samples, 3), generator=generator, device=dev)
    per = -(-cfg.n_edit_samples // n_regions) if n_regions and cfg.n_edit_samples > 0 else 0
    edit_u = torch.rand((n_regions if per else 0, per, 3), generator=generator, device=dev)
    edit_normals = torch.randn((edit_u.shape[0] * per, 3), generator=generator, device=dev)
    return DistillDraws(img_idx, pix, t_jitter, spread, free_u, edit_u, edit_normals)


def distill_step(state: optim.TrainState, teacher_params, operators: tuple, grid, data: nerf_train.DeviceDataset,
                 cfg: DistillConfig, generator: torch.Generator) -> dict:
    """One optimization step of the student from fresh draws → the step's aux."""
    draws = draw_distill_step(cfg, data, generator, len(_edit_region_bounds(tuple(operators))))
    grads, aux = distill_grads_from_draws(state.model, teacher_params, operators, grid, data, cfg, draws)
    state.apply_gradients(grads)
    return aux


@torch.no_grad()
def _reinit(model, generator: torch.Generator) -> None:
    """Fresh parameters: the hash table in ±1e-4, the MLP weights
    He-uniform by their fan-in (the networks' own initialization)."""
    for name, p in model.named_parameters():
        bound = 1e-4 if name.endswith("table") else math.sqrt(6.0 / p.shape[0])
        p.uniform_(-bound, bound, generator=generator)


def distill(
    model,
    teacher_params: Dict[str, torch.Tensor],
    operators: tuple,
    data: nerf_train.DeviceDataset,
    grid_edited,
    generator: torch.Generator,
    n_steps: int = 2000,
    cfg: DistillConfig = DistillConfig(),
    optimizer_cfg: Optional[dict] = None,
    warm_start: bool = True,
) -> optim.TrainState:
    """Distill the edited scene into a student of ``model``'s shape → its
    TrainState (``state.model`` is the student; ``model`` is not changed).

    ``warm_start`` (the default) starts the student from the teacher, so it
    has only the edit to learn; otherwise from fresh parameters drawn from
    ``generator``. Raises ``ValueError`` before the first step when the
    cascade count that ``cfg.aabb_scale`` implies differs from the edited
    grid's (a config of another scene scale mis-warps the student, which
    reaches NaN only later), and ``RuntimeError`` with the step number on a
    non-finite loss, checked every 128 steps and at the last."""
    n_casc = grid_edited.occupancy.shape[0]
    implied = nerf_train.NerfTrainConfig.for_aabb_scale(cfg.aabb_scale).n_cascades
    if implied != n_casc:
        raise ValueError(
            f"DistillConfig.aabb_scale {cfg.aabb_scale} implies {implied} cascades, the edited grid has {n_casc}: "
            "pass the trained scene's aabb_scale and cone_angle"
        )
    spec = optim.build_optimizer(
        optimizer_cfg or {"otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9, "beta2": 0.99, "epsilon": 1e-15}
    )
    student = copy.deepcopy(model)
    teacher_params = {k: v.detach() for k, v in teacher_params.items()}
    if warm_start:
        student.load_state_dict(teacher_params)
    else:
        _reinit(student, generator)
    state = optim.TrainState(student, spec)
    for i in range(n_steps):
        aux = distill_step(state, teacher_params, operators, grid_edited, data, cfg, generator)
        if (i & 127) == 0 or i == n_steps - 1:
            loss = float(aux["loss"])
            if not (loss == loss and abs(loss) < 1e30):
                raise RuntimeError(
                    f"distillation diverged at step {i}: loss={loss} (check that DistillConfig.aabb_scale and "
                    "cone_angle match the trained scene)"
                )
    return state
