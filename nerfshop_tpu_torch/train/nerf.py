"""NeRF training step, training loop, loss and density-grid update.

Counterpart of ``nerfshop_tpu/train/nerf.py``. The JAX ``make_grad_fn``
draws its randomness and computes the gradients in one function; here
:func:`grads_from_draws` takes every draw as an input (so it can be held to
the JAX step on the same draws) and :func:`draw_step` draws them from a
``torch.Generator``. :func:`make_train_loop`, the counterpart of JAX's
``lax.scan`` of steps, runs a chunk of steps from draws made beforehand:
captured once into a CUDA graph and replayed on a CUDA device, eagerly on
the CPU. The training options of JAX's ``make_grad_fn`` are here: pose and
distortion-map optimization (``optimize_extrinsics``: the position
gradient reaches per-image pose deltas and the screen-space map through
the differentiable rays; kernel F on the card), per-image exposure
(``optimize_exposure``), the trainable envmap background
(``train_envmap``) and error-map importance sampling (``use_error_map``).
The camera and envmap leaves are parameters of the ``TrainState`` beside
the model's (``train/optim.py``), and the error map is state of the loop,
updated in place after each step. A captured scene's rolling shutter and
motion blur (``transform_matrix_end`` and ``rolling_shutter``: each ray's
pose lerped at its shutter time, from one more uniform draw a ray) and its
per-image light directions (the warped ``light_dir`` appended to the dir
encoding's input) train as in JAX.
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from nerfshop_tpu_torch import kernels
from nerfshop_tpu_torch.common import MIN_CONE_STEPSIZE, MIN_TRANSMITTANCE_EVAL, NERF_MIN_OPTICAL_THICKNESS
from nerfshop_tpu_torch.models import nerf_network as nn_lib
from nerfshop_tpu_torch.models.nerf_network import NerfNetwork
from nerfshop_tpu_torch.ops import composite as comp
from nerfshop_tpu_torch.ops import coords, envmap as envmap_lib, grid as grid_lib, march, rays as rays_lib
from nerfshop_tpu_torch.train import losses as loss_lib
from nerfshop_tpu_torch.train.optim import TrainState


class DeviceDataset(NamedTuple):
    """Training data resident on one device."""

    images: torch.Tensor  # [N, H, W, 4]
    xforms: torch.Tensor  # [N, 3, 4]
    focals: torch.Tensor  # [N, 2]
    principals: torch.Tensor  # [N, 2]
    distortions: torch.Tensor  # [N, 4]
    #: per-image sharpness normalized to mean 1 (weights the error-map deposit)
    sharpness: Optional[torch.Tensor] = None  # [N]
    #: end-of-exposure poses and the shutter vector (offset, du, dv,
    #: motion-blur jitter), when the scene has both and the vector is not 0
    xforms_end: Optional[torch.Tensor] = None  # [N, 3, 4]
    rolling_shutter: Optional[torch.Tensor] = None  # [4]
    #: per-image light directions, when every frame has one
    light_dirs: Optional[torch.Tensor] = None  # [N, 3]

    @staticmethod
    def from_dataset(ds, device) -> "DeviceDataset":
        """From a ``data.nerf_loader.NerfDataset``."""

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        sharp = None
        if getattr(ds, "sharpness", None) is not None:
            s = np.asarray(ds.sharpness, np.float32)
            sharp = t(s / max(float(s.mean()), 1e-9))
        xf_end = getattr(ds, "xforms_end", None)
        rs = np.asarray(getattr(ds, "rolling_shutter", np.zeros(4)), np.float32)
        shutter = xf_end is not None and bool((rs != 0).any())
        ld = getattr(ds, "light_dirs", None) if getattr(ds, "has_light_dirs", False) else None
        return DeviceDataset(
            images=t(ds.images),
            xforms=t(ds.xforms),
            focals=t(ds.focal_matrix()),
            principals=t(ds.principal_matrix()),
            distortions=t(ds.distortion_matrix()),
            sharpness=sharp,
            xforms_end=t(xf_end) if shutter else None,
            rolling_shutter=t(rs) if shutter else None,
            light_dirs=t(ld) if ld is not None else None,
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
    #: per-image pose refinement; with a ``camera.distortion_map`` leaf, the
    #: screen-space distortion map too (it rides the differentiable rays)
    optimize_extrinsics: bool = False
    #: per-image log exposure scaling the targets
    optimize_exposure: bool = False
    #: error-map importance sampling of the training pixels
    use_error_map: bool = False
    error_map_resolution: int = 32
    error_map_decay: float = 0.97
    #: the trainable envmap (an ``envmap`` leaf) as the rays' background
    train_envmap: bool = False

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
    extra: Optional[torch.Tensor] = None,  # [R, E] per-ray extra dims
) -> Tuple[torch.Tensor, dict]:
    """Photometric loss over the composited rays plus the reference's output
    regularizers (HDR colour, early density floor, near-distance penalty).
    ``extra`` goes to every sample of its ray."""
    R, K = samples.t.shape
    pos_w, dir_w = march.samples_to_network_inputs(samples, origins, directions, aabb)
    extra_flat = None
    if extra is not None:
        extra_flat = extra[:, None, :].expand(R, K, extra.shape[-1]).reshape(R * K, extra.shape[-1])
    raw_rgb, raw_sigma = model.raw_forward(pos_w.reshape(R * K, 3), dir_w.reshape(R * K, 3), extra_flat)
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


def create_camera_params(
    n_images: int, distortion_map: bool = False, dmap_resolution: int = 32, device=None
) -> Dict[str, torch.Tensor]:
    """Learnable per-image pose and exposure refinements, and optionally the
    shared screen-space distortion grid, as the ``camera.*`` leaves of a
    ``TrainState`` (JAX's ``params["camera"]``), all zero."""
    p = {
        "camera.rot": torch.zeros((n_images, 3), device=device),
        "camera.trans": torch.zeros((n_images, 3), device=device),
        "camera.log_exposure": torch.zeros((n_images,), device=device),
    }
    if distortion_map:
        p["camera.distortion_map"] = torch.zeros((dmap_resolution, dmap_resolution, 2), device=device)
    return p


def create_error_map(n_images: int, resolution: int = 32, device=None) -> torch.Tensor:
    return torch.ones((n_images, resolution, resolution), dtype=torch.float32, device=device)


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
    extra: Optional[Dict[str, torch.Tensor]] = None,
    shutter_xi: Optional[torch.Tensor] = None,  # [R] in [0, 1)
) -> Tuple[Dict[str, torch.Tensor], dict]:
    """Rays → training march → network → composite + loss → gradients of
    every model parameter and of every ``extra`` leaf (``camera.*``,
    ``envmap``: a ``TrainState``'s ``extra``), from the given draws. Makes
    no random draws. With ``cfg.optimize_extrinsics`` the march takes the
    rays with the gradient stopped and the network's positions come from
    the same rays built differentiably (JAX's ``bundle0`` and ``bundle``);
    a leaf the loss does not reach gets a zero gradient, as in JAX. With
    the data's rolling shutter, ``shutter_xi`` is each ray's motion-blur
    draw; with its light dirs and a network of extra dims, each ray's
    image's warped light dir is the network's extra input."""
    extra = extra or {}
    aabb = coords.BoundingBox.from_aabb_scale(cfg.aabb_scale, device=pix.device)
    N, H, W = data.images.shape[:3]
    res = torch.stack([torch.full((), float(W), device=pix.device), torch.full((), float(H), device=pix.device)])
    ipix = pix.long()
    targets = data.images[img_idx.long(), ipix[:, 1], ipix[:, 0]]
    cam = {k[len("camera."):]: v for k, v in extra.items() if k.startswith("camera.")}

    def rays(camera_params=None):
        return rays_lib.rays_from_pixels(
            img_idx, pix, data.xforms, data.focals, data.principals, res, data.distortions, camera_params,
            data.xforms_end, data.rolling_shutter, shutter_xi,
        )

    if cfg.optimize_extrinsics and cam:
        with torch.no_grad():
            bundle0 = rays(cam)
        bundle = rays(cam)
    else:
        bundle0 = bundle = rays()
    samples = march.march_rays_training(
        bundle0.origins, bundle0.directions, grid.occupancy, aabb.min, aabb.max, cfg.cone_angle,
        t_jitter, spread, t_start_min=min(0.05, cfg.near_distance),
        k_samples=cfg.k_samples, n_candidates=cfg.n_candidates,
    )
    if cfg.train_envmap and "envmap" in extra:
        bg = envmap_lib.sample_envmap(extra["envmap"], bundle.directions)[:, :3]
    if cfg.optimize_exposure and cam:
        scale = torch.exp(cam["log_exposure"][img_idx.long()])[:, None]
        targets = torch.cat([targets[:, :3] * scale, targets[:, 3:]], dim=-1)
    light = None
    if data.light_dirs is not None and model.n_extra_dims:
        light = coords.warp_direction(data.light_dirs[img_idx.long()])
    loss, aux = nerf_loss_fn(
        model, samples, bundle.origins, bundle.directions, targets, bg, aabb,
        loss_lib.LOSSES[cfg.loss_type], cfg.min_transmittance,
        near_distance=cfg.near_distance, mean_grid_density=grid.mean_density, extra=light,
    )
    names, params = zip(*model.named_parameters(), *extra.items())
    grads = torch.autograd.grad(loss, params, allow_unused=bool(extra))
    # contiguous: a slice's gradient (the pose delta's translation) comes back as a
    # strided view, which the fused Adam refuses
    grads = [torch.zeros_like(p) if g is None else g.contiguous() for p, g in zip(params, grads)]
    aux["sample_overflow_frac"] = (samples.n >= cfg.k_samples).to(torch.float32).mean()
    return dict(zip(names, grads)), aux


def error_map_deposit(error_map_shape, img_idx, pix, per_ray_loss, images_shape, sharpness=None) -> torch.Tensor:
    """The step's deposit alone: each ray's loss (times its image's
    sharpness) summed into its pixel's cell of its image's map."""
    N, H, W = images_shape[:3]
    eh, ew = error_map_shape[1:]
    ex = torch.clamp((pix[:, 0] / W * ew).to(torch.int64), 0, ew - 1)
    ey = torch.clamp((pix[:, 1] / H * eh).to(torch.int64), 0, eh - 1)
    if sharpness is not None:
        per_ray_loss = per_ray_loss * sharpness[img_idx.long()]
    out = torch.zeros(tuple(error_map_shape), dtype=torch.float32, device=pix.device)
    return out.index_put_((img_idx.long(), ey, ex), per_ray_loss.float(), accumulate=True)


def update_error_map(error_map, img_idx, pix, per_ray_loss, images_shape, decay: float = 0.97, sharpness=None):
    """The decayed map plus the step's deposit (a new tensor)."""
    return error_map * decay + error_map_deposit(error_map.shape, img_idx, pix, per_ray_loss, images_shape, sharpness)


def draw_step(cfg: NerfTrainConfig, data: DeviceDataset, generator: torch.Generator):
    """The draws of one training step → (img_idx, pix, t_jitter, spread, bg),
    and with the data's rolling shutter a sixth, each ray's motion-blur
    uniform [R]. With the error map, ``pix`` is not a pixel yet but three
    uniforms a ray [R, 3] (the cell's, then the jitter in the cell), which
    the step maps through the map of its own time (:func:`pixels_of_step`)."""
    dev = data.images.device
    R, K = cfg.n_rays_per_batch, cfg.k_samples
    img_idx = torch.randint(0, data.images.shape[0], (R,), generator=generator, device=dev)
    if cfg.use_error_map:
        pix = torch.rand((R, 3), generator=generator, device=dev)
    else:
        pix = rays_lib.pixels_from_uniform(img_idx, torch.rand((R, 2), generator=generator, device=dev), data.images)[1]
    t_jitter = torch.rand((R,), generator=generator, device=dev)
    spread = torch.rand((R, K), generator=generator, device=dev)
    if cfg.random_bg:
        bg = torch.rand((R, 3), generator=generator, device=dev)
    else:
        bg = torch.zeros((R, 3), device=dev)
    if data.xforms_end is not None:
        return img_idx, pix, t_jitter, spread, bg, torch.rand((R,), generator=generator, device=dev)
    return img_idx, pix, t_jitter, spread, bg


def pixels_of_step(cfg: NerfTrainConfig, data: DeviceDataset, img_idx, pix_draw, error_map=None) -> torch.Tensor:
    """A step's pixels [R, 2] from its ``pix`` draw: the draw itself, or
    with the error map its three uniforms a ray through the per-image CDF
    of ``error_map`` (built once a step)."""
    if not cfg.use_error_map:
        return pix_draw
    return rays_lib.pixels_from_error_map(img_idx, pix_draw, error_map, data.images)[1]


#: the per-step values a training loop returns, in the order of its buffer
LOOP_OUTPUTS = ("loss", "measured_samples", "sample_overflow_frac", "mean_opacity")


class TrainLoop:
    """``n_steps`` training steps of ``state`` as one callable (the
    counterpart of JAX's ``make_train_loop``); see :func:`make_train_loop`.

    The steps read fixed buffers: the draws of every step, the grid's
    occupancy and mean density, and the learning rate of every step, which
    :meth:`run` fills before the steps run, and they write each step's
    outputs into a fourth. So a captured graph, which replays fixed
    addresses, reads the grid and the schedule of the call and never a
    stale one. A capture warms the step up once on a side stream (lazy
    initialization, cuBLAS's workspace) and puts the state back, then
    records the ``n_steps`` steps; the kernels' launch counters
    (:func:`nerfshop_tpu_torch.kernels.launch_counts`) are advanced by the
    graph's launches at every replay and not by the capture. With
    ``cfg.use_error_map`` the steps read and update ``error_map`` [N, h, w]
    in place (the caller's tensor, kept across loops)."""

    def __init__(self, state: TrainState, grid: grid_lib.OccupancyGrid, data: DeviceDataset, cfg: NerfTrainConfig,
                 n_steps: int, captured: bool, error_map: Optional[torch.Tensor] = None):
        dev = data.images.device
        R, K = cfg.n_rays_per_batch, cfg.k_samples
        self.state, self.data, self.cfg, self.n_steps, self.captured = state, data, cfg, n_steps, captured
        if cfg.use_error_map and error_map is None:
            raise ValueError("use_error_map: the loop needs the error map it updates")
        self.error_map = error_map if cfg.use_error_map else None

        def buf(*shape, dtype=torch.float32):
            return torch.zeros((n_steps, *shape), dtype=dtype, device=dev)

        #: (img_idx, pix, t_jitter, spread, bg[, shutter_xi]) of every step,
        #: stacked (``pix`` [R, 3] with the error map: :func:`draw_step`)
        self.draws = (buf(R, dtype=torch.int64), buf(R, 3 if cfg.use_error_map else 2), buf(R), buf(R, K), buf(R, 3))
        if data.xforms_end is not None:
            self.draws += (buf(R),)
        # the steps read only the occupancy and the mean density
        self.grid = grid_lib.OccupancyGrid(None, grid.occupancy.clone(), grid.mean_density.clone())
        self.lr = buf()
        self.outputs = buf(len(LOOP_OUTPUTS))
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        #: the counters' advance at one replay (:func:`kernels.launch_counts` keys)
        self.graph_launches: dict = {}
        self.replays = 0

    def draw(self, generator: torch.Generator) -> tuple:
        """Draw every step's inputs from ``generator`` in the order the
        eager steps draw them (:func:`draw_step`) into the draw buffers →
        the buffers."""
        for i in range(self.n_steps):
            for b, d in zip(self.draws, draw_step(self.cfg, self.data, generator)):
                b[i].copy_(d)
        return self.draws

    def __call__(self, grid: grid_lib.OccupancyGrid, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """Draw from ``generator``, then run the steps on ``grid``."""
        return self.run(grid, self.draw(generator))

    def run(self, grid: grid_lib.OccupancyGrid, draws: tuple) -> Dict[str, torch.Tensor]:
        """Run the steps from stacked ``draws`` (``[n_steps, ...]`` each, in
        :func:`draw_step`'s order) on ``grid`` → the per-step outputs
        ``[n_steps]`` by :data:`LOOP_OUTPUTS` name. Advances ``state.step``
        by ``n_steps``; the schedule's learning rate changes per step."""
        for b, d in zip(self.draws, draws):
            if d is not b:
                b.copy_(d)
        self.grid.occupancy.copy_(grid.occupancy)
        self.grid.mean_density.copy_(grid.mean_density)
        lrs = [self.state.spec.schedule(self.state.step + i) for i in range(self.n_steps)]
        self.lr.copy_(torch.tensor(lrs, dtype=torch.float32), non_blocking=True)
        if self.captured:
            if self.graph is None:
                self._capture()
            self.graph.replay()
            kernels.add_launches(self.graph_launches)
            self.replays += 1
        else:
            for i in range(self.n_steps):
                self._step(i)
        self.state.step += self.n_steps
        out = self.outputs.clone()
        return {name: out[:, j] for j, name in enumerate(LOOP_OUTPUTS)}

    def _step(self, i: int) -> None:
        img_idx, pix_draw, t_jitter, spread, bg, *shutter = (d[i] for d in self.draws)
        pix = pixels_of_step(self.cfg, self.data, img_idx, pix_draw, self.error_map)
        grads, aux = grads_from_draws(
            self.state.model, self.grid, self.data, self.cfg, img_idx, pix, t_jitter, spread, bg,
            extra=self.state.extra, shutter_xi=shutter[0] if shutter else None,
        )
        self.state.update(grads, self.lr[i])
        if self.error_map is not None:
            self.error_map.copy_(update_error_map(
                self.error_map, img_idx, pix, aux["per_ray_loss"], self.data.images.shape, self.cfg.error_map_decay,
                self.data.sharpness,
            ))
        aux["measured_samples"] = aux["measured_samples"].to(torch.float32)
        self.outputs[i].copy_(torch.stack([aux[name] for name in LOOP_OUTPUTS]))

    def _capture(self) -> None:
        state = self.state
        side = torch.cuda.Stream(device=self.data.images.device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side), warnings.catch_warnings():
            # the warm-up is the one uncaptured step of a capturable Adam
            warnings.filterwarnings("ignore", message=".*capturable=True.*")
            written = state.tensors() + ([self.error_map] if self.error_map is not None else [])
            saved = [t.clone() for t in written]
            self._step(0)
            for t, s in zip(written, saved):
                t.copy_(s)
            del saved
        torch.cuda.current_stream().wait_stream(side)
        before = kernels.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for i in range(self.n_steps):
                self._step(i)
        after = kernels.launch_counts()
        self.graph_launches = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
        kernels.add_launches(self.graph_launches, times=-1)  # recording launches nothing
        self.graph = graph


def make_train_loop(
    state: TrainState,
    grid: grid_lib.OccupancyGrid,
    data: DeviceDataset,
    cfg: NerfTrainConfig,
    n_steps: int,
    captured: Optional[bool] = None,
    error_map: Optional[torch.Tensor] = None,
) -> TrainLoop:
    """``n_steps`` optimization steps as one callable, ``loop(grid,
    generator)`` → per-step ``loss``, ``measured_samples``,
    ``sample_overflow_frac`` and ``mean_opacity`` ``[n_steps]`` (JAX's
    ``_ys``); ``loop.run(grid, draws)`` takes the stacked draws instead.
    Each step is the draws, :func:`grads_from_draws` and Adam + EMA
    (``state.update``) at the schedule's rate for its step.

    On a CUDA device the steps are captured into one CUDA graph at the first
    call and replayed; a failed capture raises. On the CPU they run
    eagerly. ``captured=False`` asks for the eager steps on a CUDA device
    (to hold the graph to them); ``captured=True`` on the CPU raises.
    ``grid``'s shapes fix the loop's grid buffers; every call copies the
    grid it is given into them. ``error_map`` is the map that a loop with
    ``cfg.use_error_map`` samples from and updates in place."""
    dev = data.images.device
    if captured is None:
        captured = dev.type == "cuda"
    if captured and dev.type != "cuda":
        raise ValueError(f"a captured training loop needs a CUDA device; the data are on {dev}")
    return TrainLoop(state, grid, data, cfg, n_steps, captured, error_map)


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
