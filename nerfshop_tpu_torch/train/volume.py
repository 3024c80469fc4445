"""Volume testbed: neural volume (albedo + density) fitting and rendering.

Counterpart of ``nerfshop_tpu/train/volume.py``: a dense [N³] ground-truth
density grid; training draws 2^16 uniform positions a step, supervises the
density with the config's loss against the trilinear ground truth and the
albedo on occupied points; rendering is Woodcock delta tracking against the
majorant, then a 24-point transmittance toward a fixed light and single
scatter shading.

The tracker evaluates only the rays still alive: every ``CHECK_EVERY``
iterations it gathers their indices (one host sync) and stops when none is
left. Each iteration's two uniforms are drawn for every ray and indexed by
ray id, so the result is the function JAX's masked ``while_loop`` over all
rays computes. Every random draw comes from the testbed's
``torch.Generator``; the sampling functions also take their draws as
tensors, which is how the tests hand them JAX's.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from nerfshop_tpu_torch.models.field import FieldModel
from nerfshop_tpu_torch.ops import coords
from nerfshop_tpu_torch.ops import tonemap as tm
from nerfshop_tpu_torch.train import losses as loss_lib
from nerfshop_tpu_torch.train import optim

#: iterations of the delta tracker between two gathers of its alive rays
CHECK_EVERY = 8
#: rays a chunk of the shadow transmittance (24 field points each)
SHADOW_CHUNK = 1 << 16
N_SHADOW = 24


def synthetic_smoke(res: int = 96, seed: int = 0) -> np.ndarray:
    """A wispy test volume in [0,1]³ (no NanoVDB asset needed); bit-equal to
    the JAX package's."""
    rng = np.random.default_rng(seed)
    g = (np.arange(res) + 0.5) / res
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    d = np.zeros((res, res, res), np.float32)
    for _ in range(6):
        c = rng.uniform(0.25, 0.75, 3)
        r = rng.uniform(0.08, 0.2)
        amp = rng.uniform(2.0, 8.0)
        d += amp * np.exp(-((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2) / r**2).astype(np.float32)
    # swirl modulation
    d *= (0.6 + 0.4 * np.sin(9 * x + 5 * y) * np.cos(7 * z)).astype(np.float32)
    return np.clip(d, 0.0, None)


class VolumeModel(FieldModel):
    @classmethod
    def from_config(cls, config: dict, device=None, generator=None) -> "VolumeModel":
        return cls.build(config, 3, 4, device, generator)

    def forward(self, pos: torch.Tensor):
        """pos in [0,1]³ → (albedo [N, 3] (sigmoid), density [N] (exp))."""
        h = self.raw(pos)
        return torch.sigmoid(h[..., :3]), torch.exp(torch.clamp(h[..., 3], -15, 15))


class VolumeTestbed:
    gt_albedo = (0.85, 0.85, 0.85)

    def __init__(self, model: VolumeModel, spec: optim.OptimizerSpec, loss_fn, device, generator: torch.Generator):
        self.model = model
        self.spec = spec
        self.state = optim.TrainState(model, spec)
        self.loss_fn = loss_fn
        self.device = torch.device(device)
        self.generator = generator
        self.gt_density: Optional[torch.Tensor] = None  # [N, N, N]
        self.majorant = 1.0
        self.step = 0

    @staticmethod
    def create(config: dict, volume, device, generator: torch.Generator) -> "VolumeTestbed":
        model = VolumeModel.from_config(config, device, generator)
        spec = optim.build_optimizer(dict(config.get("optimizer", {"otype": "Adam", "learning_rate": 1e-2})))
        loss_fn = loss_lib.build_loss(dict(config.get("loss", {"otype": "L2"})))
        tb = VolumeTestbed(model, spec, loss_fn, device, generator)
        if volume is not None:
            tb.set_volume(volume)
        return tb

    def set_volume(self, volume: np.ndarray) -> None:
        self.gt_density = torch.as_tensor(np.asarray(volume, np.float32), device=self.device)
        self.majorant = float(volume.max()) * 1.001

    def _gt_at(self, pos: torch.Tensor) -> torch.Tensor:
        """Trilinear ground-truth density at [N, 3] points in [0,1]³."""
        g = self.gt_density
        n = g.shape[0]
        p = torch.clamp(pos, 0, 1) * n - 0.5
        p0 = torch.floor(p)
        f = p - p0
        i0 = torch.clamp(p0.to(torch.int64), 0, n - 1)
        i1 = torch.clamp(i0 + 1, 0, n - 1)
        c = 0.0
        for dx, wx in ((i0[:, 0], 1 - f[:, 0]), (i1[:, 0], f[:, 0])):
            for dy, wy in ((i0[:, 1], 1 - f[:, 1]), (i1[:, 1], f[:, 1])):
                for dz, wz in ((i0[:, 2], 1 - f[:, 2]), (i1[:, 2], f[:, 2])):
                    c = c + wx * wy * wz * g[dx, dy, dz]
        return c

    # ------------------------------------------------------------- training

    def draw_batch(self, n: int) -> torch.Tensor:
        """One step's positions [2·(n // 2), 3]: two uniform halves, as JAX."""
        g, dev = self.generator, self.device
        return torch.cat([torch.rand((n // 2, 3), generator=g, device=dev) for _ in range(2)])

    def train_step(self, pos: torch.Tensor) -> torch.Tensor:
        """One optimizer step at the positions ``pos`` → the loss (0-d, no
        host sync)."""
        target_d = self._gt_at(pos)
        albedo_gt = torch.tensor(self.gt_albedo, device=pos.device)
        names, params = zip(*self.model.named_parameters())
        with torch.enable_grad():
            albedo, density = self.model(pos)
            l_d = self.loss_fn(target_d, density).mean()
            occupied = (target_d > 1e-3)[:, None]
            l_a = torch.where(occupied, torch.square(albedo - albedo_gt), torch.zeros_like(albedo)).mean()
            loss = l_d + l_a
            grads = torch.autograd.grad(loss, params)
        self.state.apply_gradients(dict(zip(names, grads)))
        self.step += 1
        return loss.detach()

    def train(self, n_steps: int, batch_size: int = 1 << 16) -> float:
        if self.gt_density is None:
            raise RuntimeError("set a volume first")
        batch_size = min(batch_size, 1 << 16)
        loss = torch.zeros(())
        for _ in range(n_steps):
            loss = self.train_step(self.draw_batch(batch_size))
        return float(loss)

    # ------------------------------------------------------------- rendering

    def _density_at(self, params, p: torch.Tensor, use_gt: bool) -> torch.Tensor:
        return self._gt_at(p) if use_gt else self.model.apply(params, p)[1]

    def _albedo_at(self, params, p: torch.Tensor, use_gt: bool) -> torch.Tensor:
        if use_gt:
            return torch.tensor(self.gt_albedo, device=p.device).expand(p.shape[0], 3)
        return self.model.apply(params, p)[0]

    @torch.no_grad()
    def _delta_track(
        self,
        params,
        origins: torch.Tensor,
        dirs: torch.Tensor,
        light_dir=(0.57, 0.57, 0.57),
        max_iters: int = 512,
        use_gt: bool = False,
        draws: Optional[Callable[[int], Tuple[torch.Tensor, torch.Tensor]]] = None,
    ):
        """Woodcock tracking through the network's (or the ground truth's)
        density, then single scatter toward the light with the
        transmittance of 24 fixed points → (rgb [R, 3], hit [R]).
        ``draws(i)`` gives iteration i's two uniforms for every ray ([R]
        each); without it they come from the generator."""
        R = origins.shape[0]
        dev = origins.device
        maj = self.majorant
        box = coords.BoundingBox.unit(dev)
        tmin, tmax = box.ray_intersect(origins, dirs)
        t = torch.clamp_min(tmin, 0.0)
        alive = t < tmax
        hit = torch.zeros(R, dtype=torch.bool, device=dev)
        hit_pos = torch.zeros((R, 3), device=dev)
        if draws is None:
            g = self.generator

            def draws(i):
                return torch.rand((R,), generator=g, device=dev), torch.rand((R,), generator=g, device=dev)

        active = torch.nonzero(alive).squeeze(1)
        it = 0
        while it < max_iters and active.numel():
            for _ in range(min(CHECK_EVERY, max_iters - it)):
                u, u2 = draws(it)
                it += 1
                a_alive, ta = alive[active], t[active]
                t_new = ta - torch.log(torch.clamp_min(u[active], 1e-12)) / maj
                pos = origins[active] + t_new[:, None] * dirs[active]
                inside = t_new < tmax[active]
                d = self._density_at(params, torch.clamp(pos, 0, 1), use_gt)
                real = u2[active] < d / maj  # a real collision, not a null one
                newly = a_alive & inside & real
                hit[active] = hit[active] | newly
                hit_pos[active] = torch.where(newly[:, None], pos, hit_pos[active])
                a_alive = a_alive & inside & ~real
                alive[active] = a_alive
                t[active] = torch.where(a_alive, t_new, ta)
            active = active[alive[active]]

        # single scatter: albedo · transmittance to the light at 24 fixed points
        ld = torch.tensor(light_dir, dtype=torch.float32, device=dev)
        ld = ld / torch.linalg.vector_norm(ld)
        ts = (torch.arange(N_SHADOW, device=dev, dtype=torch.float32) + 0.5) / N_SHADOW
        rgb = torch.zeros((R, 3), device=dev)
        hit_idx = torch.nonzero(hit).squeeze(1)
        for i in range(0, hit_idx.numel(), SHADOW_CHUNK):
            idx = hit_idx[i : i + SHADOW_CHUNK]
            hp = hit_pos[idx]
            _, t_exit = box.ray_intersect(hp, ld.expand_as(hp))
            seg = torch.clamp_min(t_exit, 0.0)
            pts = hp[:, None, :] + (ts[None, :, None] * seg[:, None, None]) * ld
            dens = self._density_at(params, torch.clamp(pts.reshape(-1, 3), 0, 1), use_gt).reshape(-1, N_SHADOW)
            trans = torch.exp(-(dens.sum(1) * seg / N_SHADOW))
            rgb[idx] = self._albedo_at(params, torch.clamp(hp, 0, 1), use_gt) * trans[:, None]
        return rgb, hit

    def render(
        self, width: int, height: int, camera_matrix, focal, linear: bool = False, spp: int = 4, use_gt: bool = False,
    ) -> torch.Tensor:
        """spp delta-tracked passes averaged → [H, W, 4] on the testbed's
        device (rgb sRGB-encoded unless ``linear``, alpha the hit share)."""
        from nerfshop_tpu_torch.ops import rays as rays_lib

        dev = self.device

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        params = self.state.inference_params
        bundle = rays_lib.rays_for_image((width, height), t(camera_matrix), t(focal), t([0.5, 0.5]))
        acc = torch.zeros((width * height, 3), device=dev)
        hits = torch.zeros(width * height, device=dev)
        for _ in range(spp):
            rgb, hit = self._delta_track(params, bundle.origins, bundle.directions, use_gt=use_gt)
            acc = acc + rgb
            hits = hits + hit.float()
        rgb = (acc / spp).reshape(height, width, 3)
        if not linear:
            rgb = tm.linear_to_srgb(rgb)
        return torch.cat([rgb, (hits / spp).reshape(height, width, 1)], -1)
