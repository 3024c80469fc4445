"""Multi-GPU scale-out over ``torch.distributed``: data-parallel training and
pixel-sharded rendering.

Counterpart of ``nerfshop_tpu/parallel/mesh.py``, with its names, in
PyTorch's idiom: one process a rank, the model and state replicated on
each, collectives through the process group that the caller initialised
with ``torch.distributed.init_process_group`` (NCCL across cards, gloo on
the CPU, or for ranks that share one card: NCCL refuses two ranks on one
device). :func:`make_mesh` reads that group; nothing here initialises one.

* **Data-parallel training** (:func:`make_parallel_train_step`):
  ``cfg.n_rays_per_batch`` is the global batch; each rank runs
  ``train/nerf.py::grads_from_draws`` on its ``n_rays_per_batch / world``
  rays, drawn from a generator seeded by (seed, rank)
  (:func:`rank_generator`, the counterpart of JAX's ``fold_in(rng,
  axis_index)``) or given explicitly. The gradients and the float aux go
  to every rank in one flat bucket, one ``all_reduce`` a step, divided by
  the world size (JAX's ``pmean``); the per-ray aux is dropped. Every rank
  then applies the same Adam + EMA step, so the replicated state stays bit
  for bit the same on every rank. With the error map each rank deposits
  its rays' losses, the deposits ride in the same bucket summed (``psum``),
  and the decay applies once: the same new map on every rank.
* **The occupancy grid** is not part of the step, as in JAX. The caller
  keeps it replicated by refreshing it on every rank with the same draws
  (``nerf.update_grid`` with a generator seeded alike on every rank): the
  refresh reads only the replicated weights and those draws, so every rank
  computes the same grid. :func:`replicate` broadcasts a grid (or a state)
  from rank 0 where the ranks' copies may differ (after a load on one).
* **Pixel-sharded rendering** (:func:`render_frame_sharded`): the frame's
  rays padded to a multiple of the world size, each rank renders its
  contiguous slice with ``render/renderer.py::render_rays`` (the chunk
  loop of ``render_frame``), and every rank returns the whole frame: each
  writes its slice into a zero-filled frame and one ``all_reduce`` sums
  them, on either backend (gloo takes CUDA tensors in ``all_reduce`` and
  ``broadcast`` only).

The step runs eagerly; the captured 16-step loop (``nerf.TrainLoop``) stays
single-process.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from nerfshop_tpu_torch.ops import grid as grid_lib
from nerfshop_tpu_torch.ops import rays as rays_lib
from nerfshop_tpu_torch.render import renderer as renderer_lib
from nerfshop_tpu_torch.train import nerf as nerf_train
from nerfshop_tpu_torch.train import optim


class Mesh(NamedTuple):
    """The ranks of one process group: the group (None: the default one),
    its size, this process's rank in it, and this rank's device."""

    group: Optional[dist.ProcessGroup]
    world: int
    rank: int
    device: torch.device


def make_mesh(device=None, group: Optional[dist.ProcessGroup] = None) -> Mesh:
    """This rank's view of ``group`` (the default group when None), which the
    caller initialised. ``device`` defaults to the rank's card,
    ``cuda:(rank mod the card count)``, and raises without CUDA."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: no process group; call torch.distributed.init_process_group first (NCCL across cards, "
            "gloo on the CPU)"
        )
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device found; pass device='cpu' to run the ranks on the CPU")
        device = torch.device("cuda", rank % torch.cuda.device_count())
    return Mesh(group, world, rank, torch.device(device))


def rank_generator(mesh: Mesh, seed: int, rank: Optional[int] = None) -> torch.Generator:
    """A generator on the mesh's device for the draws of ``rank`` (this
    rank's when None), seeded by (seed, rank): every rank draws its own
    rays, and any rank can remake another's draws."""
    rank = mesh.rank if rank is None else rank
    g = torch.Generator(device=mesh.device)
    g.manual_seed(int(np.random.SeedSequence([seed, rank]).generate_state(1, np.uint64)[0]))
    return g


class ParallelTrainStep:
    """One data-parallel training step; see :func:`make_parallel_train_step`."""

    def __init__(self, spec: optim.OptimizerSpec, cfg: nerf_train.NerfTrainConfig, mesh: Mesh):
        if cfg.n_rays_per_batch % mesh.world:
            raise ValueError(f"n_rays_per_batch {cfg.n_rays_per_batch} not divisible by mesh size {mesh.world}")
        self.spec, self.cfg, self.mesh = spec, cfg, mesh
        #: the rank's share of the batch
        self.local_cfg = dataclasses.replace(cfg, n_rays_per_batch=cfg.n_rays_per_batch // mesh.world)

    def draw(self, data: nerf_train.DeviceDataset, generator: torch.Generator,
             error_map: Optional[torch.Tensor] = None) -> tuple:
        """The rank's draws of one step (``nerf.draw_step`` at its share),
        with its pixels [R, 2] (through ``error_map`` when the config uses
        one)."""
        img_idx, pix, *rest = nerf_train.draw_step(self.local_cfg, data, generator)
        return (img_idx, nerf_train.pixels_of_step(self.local_cfg, data, img_idx, pix, error_map), *rest)

    def grads(self, state: optim.TrainState, grid: grid_lib.OccupancyGrid, data: nerf_train.DeviceDataset,
              draws: tuple, error_map: Optional[torch.Tensor] = None):
        """The reduced gradients of one step from this rank's ``draws`` →
        (grads by parameter name, float aux, the new error map or None).
        ``draws`` are :meth:`draw`'s: ``nerf.draw_step``'s order, with
        pixels [R, 2]."""
        cfg, mesh = self.local_cfg, self.mesh
        img_idx, pix, t_jitter, spread, bg, *shutter = draws
        grads, aux = nerf_train.grads_from_draws(
            state.model, grid, data, cfg, img_idx, pix, t_jitter, spread, bg, extra=state.extra,
            shutter_xi=shutter[0] if shutter else None,
        )
        names = [name for name, _ in state.named]
        # the per-ray loss is rank-local bookkeeping, never reduced (JAX also
        # drops its pixel picks, which the port's aux does not carry)
        keys = sorted(k for k in aux if k != "per_ray_loss")
        parts = [grads[k].reshape(-1) for k in names] + [torch.stack([aux[k].float() for k in keys])]
        if cfg.use_error_map:
            parts.append(nerf_train.error_map_deposit(
                error_map.shape, img_idx, pix, aux["per_ray_loss"], data.images.shape, data.sharpness,
            ).reshape(-1))
        bucket = torch.cat(parts)
        n_mean = bucket.shape[0] - (error_map.numel() if cfg.use_error_map else 0)
        dist.all_reduce(bucket, group=mesh.group)
        bucket[:n_mean].div_(mesh.world)
        out, off = {}, 0
        for k in names:
            n = grads[k].numel()
            out[k] = bucket[off:off + n].view_as(grads[k])
            off += n
        mean_aux = dict(zip(keys, bucket[off:off + len(keys)]))
        new_em = None
        if cfg.use_error_map:
            new_em = error_map * cfg.error_map_decay + bucket[n_mean:].view_as(error_map)
        return out, mean_aux, new_em

    def __call__(self, state: optim.TrainState, grid: grid_lib.OccupancyGrid, data: nerf_train.DeviceDataset,
                 draws: Optional[tuple] = None, generator: Optional[torch.Generator] = None,
                 error_map: Optional[torch.Tensor] = None):
        """One step on ``state`` in place from ``draws`` (or drawn from
        ``generator``) → the mean float aux, and with ``cfg.use_error_map``
        (aux, the new error map)."""
        if draws is None:
            draws = self.draw(data, generator, error_map)
        grads, aux, new_em = self.grads(state, grid, data, draws, error_map)
        state.apply_gradients(grads)
        return (aux, new_em) if self.cfg.use_error_map else aux


def make_parallel_train_step(model, spec: optim.OptimizerSpec, cfg: nerf_train.NerfTrainConfig,
                             mesh: Mesh) -> ParallelTrainStep:
    """``step(state, grid, data, draws=None, generator=None[, error_map=])`` →
    aux (and the new error map with ``cfg.use_error_map``): the rays shard
    over the ranks, the gradients are averaged over them, and every rank
    applies the same update to its replica of ``state`` (a
    ``train/optim.py::TrainState`` of ``model``). ``cfg.n_rays_per_batch``
    is the GLOBAL batch; raises ``ValueError`` when the world size does not
    divide it. ``model`` is unused (the state carries it): the parameter
    stays so that the signature is JAX's."""
    del model
    return ParallelTrainStep(spec, cfg, mesh)


def make_sharded_render(model, mesh: Mesh, opts: Optional[renderer_lib.RenderOptions] = None):
    """→ fn(params, grid, origins [R, 3], dirs [R, 3], bg [4]) → (rgba [R, 4],
    depth [R]) on every rank: each rank renders its slice of the rays
    (:func:`shard_rays`; R must be a multiple of the world size, pad
    upstream) with the replicated model and grid, then the slices are
    summed into every rank's copy of the whole."""
    opts = opts or renderer_lib.RenderOptions()

    def fn(params, grid, origins, dirs, bg):
        o, d = shard_rays(mesh, origins, dirs)
        rgba, depth = renderer_lib.render_rays(model, params, grid, o, d, opts, bg)
        n = o.shape[0]
        whole = torch.zeros((origins.shape[0], 5), dtype=torch.float32, device=origins.device)
        whole[mesh.rank * n:(mesh.rank + 1) * n] = torch.cat([rgba, depth[:, None]], dim=1)
        dist.all_reduce(whole, group=mesh.group)
        return whole[:, :4], whole[:, 4]

    return fn


def render_frame_sharded(model, params, grid, mesh: Mesh, resolution: Tuple[int, int], xform, focal, principal=None,
                         opts: Optional[renderer_lib.RenderOptions] = None, bg=None):
    """Whole-frame pixel-sharded render (the caller of
    :func:`make_sharded_render`) → (rgba [H, W, 4], depth [H, W]) on every
    rank. ``bg`` [4] defaults to zeros, as in JAX."""
    W, H = resolution
    dev = grid.occupancy.device
    principal = torch.tensor([0.5, 0.5], device=dev) if principal is None else principal
    bg = torch.zeros(4, device=dev) if bg is None else torch.as_tensor(bg, dtype=torch.float32, device=dev)
    bundle = rays_lib.rays_for_image((W, H), xform, focal, principal)
    n = W * H
    n_pad = (-n) % mesh.world
    origins = torch.cat([bundle.origins, torch.zeros((n_pad, 3), device=dev)])
    dirs = torch.cat([bundle.directions, torch.tensor([[0.0, 0.0, 1.0]], device=dev).expand(n_pad, 3)])
    rgba, depth = make_sharded_render(model, mesh, opts)(params, grid, origins, dirs, bg)
    return rgba[:n].reshape(H, W, 4), depth[:n].reshape(H, W)


def shard_rays(mesh: Mesh, *arrays: torch.Tensor) -> tuple:
    """This rank's contiguous slice of each ray-major array (the leading
    dimension a multiple of the world size)."""
    out = []
    for a in arrays:
        if a.shape[0] % mesh.world:
            raise ValueError(f"shard_rays: {a.shape[0]} rows are not divisible by mesh size {mesh.world}")
        n = a.shape[0] // mesh.world
        out.append(a[mesh.rank * n:(mesh.rank + 1) * n])
    return tuple(out)


def replicate(mesh: Mesh, obj):
    """Broadcast ``obj`` from rank 0 to every rank, in place, and return it:
    a ``TrainState`` (parameters, Adam's state, the EMA, the learning rate
    and the step count) or an ``OccupancyGrid``."""
    if isinstance(obj, optim.TrainState):
        tensors = obj.tensors()
    elif isinstance(obj, grid_lib.OccupancyGrid):
        # gloo has no bool: the occupancy travels as its bytes
        tensors = [obj.density, obj.occupancy.view(torch.uint8), obj.mean_density]
    else:
        raise TypeError(f"replicate: a TrainState or an OccupancyGrid, not {type(obj).__name__}")
    for t in tensors:
        dist.broadcast(t, 0, group=mesh.group)
    if isinstance(obj, optim.TrainState):
        step = torch.tensor([obj.step], dtype=torch.int64, device=mesh.device)
        dist.broadcast(step, 0, group=mesh.group)
        obj.step = int(step)
    return obj

