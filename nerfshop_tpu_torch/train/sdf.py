"""SDF testbed: a triangle mesh → a neural signed-distance field.

Counterpart of ``nerfshop_tpu/train/sdf.py``:

* the mesh is normalised into the unit cube (0.9 of it, centred), with its
  BVH (``geometry/bvh.py``) and its area CDF;
* training samples the reference's mix: 4/8 on the surface (target 0),
  3/8 on the surface plus logistic noise, 1/8 uniform in the slightly
  inflated box, the last 4/8 with ground truth from the BVH (kernel G on
  the card, over the BVH packed once a mesh); the step runs under
  autograd (kernel B with fracs, the plain MLP, kernel A in the table
  backward);
* rendering sphere-traces a fixed 50 iterations over every ray with the
  dead ones masked (JAX's ``while_loop(any(alive))`` computes the same,
  since a dead ray never moves, and the loop needs no host sync), shades
  with autodiff normals (kernel F and the plain MLP's autograd, detached
  parameters) or finite differences, soft shadows from a second sphere
  trace toward the sun, the Disney BRDF and an optional floor plane;
* IoU on uniform points: the network's sign against the BVH's.

Every random draw comes from the testbed's ``torch.Generator``; the
sampling functions also take their draws as tensors, which is how the
tests hand them JAX's.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from nerfshop_tpu_torch.geometry import bvh as bvh_lib
from nerfshop_tpu_torch.models.field import FieldModel
from nerfshop_tpu_torch.ops import coords
from nerfshop_tpu_torch.ops import tonemap as tm
from nerfshop_tpu_torch.ops.brdf import BrdfParams, disney_shade
from nerfshop_tpu_torch.train import losses as loss_lib
from nerfshop_tpu_torch.train import optim

#: rays a chunk of :meth:`SdfTestbed.render`
RENDER_CHUNK = 1 << 20


class SdfModel(FieldModel):
    @classmethod
    def from_config(cls, config: dict, device=None, generator=None) -> "SdfModel":
        """A HashGrid (or other ported grid) field; the Takikawa encoding of
        the JAX package (over a triangle octree) is not ported and raises
        ``NotImplementedError`` naming it."""
        return cls.build(config, 3, 1, device, generator)

    def forward(self, pos: torch.Tensor) -> torch.Tensor:
        """pos in [0,1]³ → signed distance [N]."""
        return self.raw(pos)[..., 0]


class SdfTestbed:
    zero_offset = 0.0029296875  # a small inflation of the uniform samples' box
    surface_offset_scale = 1.0
    bounding_radius = math.sqrt(3.0) / 2

    def __init__(self, model: SdfModel, spec: optim.OptimizerSpec, loss_fn, device, generator: torch.Generator):
        self.model = model
        self.spec = spec
        self.state = optim.TrainState(model, spec)
        self.loss_fn = loss_fn
        self.device = torch.device(device)
        self.generator = generator
        #: the mesh's BVH in kernel G's layout (its BvhArrays in ``.bvh``)
        self.packed_bvh: Optional[bvh_lib.PackedBvh] = None
        self.tri_cdf: Optional[torch.Tensor] = None
        self.tri_v: Optional[torch.Tensor] = None  # [F, 3, 3] in the unit box
        self.step = 0
        #: shading knobs (the reference's m_brdf, m_sun_dir,
        #: m_sdf.shadow_sharpness, analytic_normals, fd_normals_epsilon and
        #: m_floor_enable)
        self.brdf = BrdfParams()
        self.sun_dir = (0.577, 0.577, 0.577)
        self.shadow_sharpness = 2048.0
        self.render_shadows = True
        self.analytic_normals = True
        self.fd_normals_epsilon = 1e-3
        self.floor_enable = False

    @staticmethod
    def create(config: dict, mesh, device, generator: torch.Generator) -> "SdfTestbed":
        spec = optim.build_optimizer(dict(config.get("optimizer", {"otype": "Adam", "learning_rate": 1e-2})))
        loss_fn = loss_lib.build_loss(dict(config.get("loss", {"otype": "Mape"})))
        model = SdfModel.from_config(config, device, generator)
        tb = SdfTestbed(model, spec, loss_fn, device, generator)
        if mesh is not None:
            tb.set_mesh(mesh)
        return tb

    def set_mesh(self, mesh) -> None:
        """Normalise the mesh into the unit cube (0.9 of its side, centred)
        and build the BVH (and kernel G's packed form of it) and the area
        CDF."""
        v = np.asarray(mesh.vertices, np.float32)
        lo, hi = v.min(0), v.max(0)
        scale = 0.9 / max(float((hi - lo).max()), 1e-9)
        v = (v - (lo + hi) / 2) * scale + 0.5
        faces = np.asarray(mesh.faces, np.int32)
        self.mesh_vertices, self.mesh_faces = v, faces
        self.packed_bvh = bvh_lib.pack_bvh(bvh_lib.build_bvh(v, faces, self.device))
        tris = v[faces]
        area = 0.5 * np.linalg.norm(np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]), axis=-1)
        cdf = np.cumsum(area)
        self.tri_cdf = torch.as_tensor((cdf / cdf[-1]).astype(np.float32), device=self.device)
        self.tri_v = torch.as_tensor(tris, device=self.device)

    # ------------------------------------------------------------- training

    @staticmethod
    def batch_sizes(n: int):
        """(exact-surface, offset, uniform) sample counts of a batch of n."""
        base = n // 8
        return 4 * base, 3 * base, n - 7 * base

    def draw_batch(self, n: int):
        """The draws of one batch of n from the generator: (u [ns], b [ns, 2],
        uu [no, 3], uniform points [nu, 3]), ns = exact + offset."""
        n_exact, n_offset, n_uniform = self.batch_sizes(n)
        g, dev = self.generator, self.device
        u = torch.rand((n_exact + n_offset,), generator=g, device=dev)
        b = torch.rand((n_exact + n_offset, 2), generator=g, device=dev)
        uu = torch.rand((n_offset, 3), generator=g, device=dev)
        uni = torch.rand((n_uniform, 3), generator=g, device=dev) * (1 + 2 * self.zero_offset) - self.zero_offset
        return u, b, uu, uni

    def _sample_batch(self, n: int, draws: Optional[Sequence[torch.Tensor]] = None):
        """→ (positions [n, 3], target distances [n]) with the 4/3/1 mix,
        from ``draws`` (:meth:`draw_batch`'s form) or fresh ones."""
        n_exact, n_offset, n_uniform = self.batch_sizes(n)
        u, b, uu, uni = draws if draws is not None else self.draw_batch(n)

        # surface samples: a triangle by area, uniform barycentrics in it
        ti = torch.searchsorted(self.tri_cdf, u)
        tri = self.tri_v[torch.clamp(ti, 0, self.tri_v.shape[0] - 1)]
        s = torch.sqrt(b[:, :1])
        bary = torch.cat([1 - s, s * (1 - b[:, 1:]), s * b[:, 1:]], -1)
        surf = torch.einsum("nk,nkd->nd", bary, tri)

        # logistic perturbation of the offset group
        std = self.bounding_radius / 1024.0 * self.surface_offset_scale
        uu = torch.clamp(uu, 1e-6, 1 - 1e-6)
        offset_pts = surf[n_exact:] + std * torch.log(uu / (1 - uu))

        pos = torch.cat([surf[:n_exact], offset_pts, uni])
        d_rest = bvh_lib.signed_distance(self.packed_bvh, pos[n_exact:].contiguous())
        target = torch.cat([torch.zeros(n_exact, device=pos.device), d_rest])
        return pos, target

    def train_step(self, pos: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """One optimizer step on (pos, target) → the loss (0-d, no host sync)."""
        names, params = zip(*self.model.named_parameters())
        with torch.enable_grad():
            loss = self.loss_fn(target, self.model(pos)).mean()
            grads = torch.autograd.grad(loss, params)
        self.state.apply_gradients(dict(zip(names, grads)))
        self.step += 1
        return loss.detach()

    def train(self, n_steps: int, batch_size: int = 1 << 16) -> float:
        if self.packed_bvh is None:
            raise RuntimeError("load a mesh first")
        batch_size = min(batch_size, 1 << 16)
        loss = torch.zeros(())
        for _ in range(n_steps):
            loss = self.train_step(*self._sample_batch(batch_size))
        return float(loss)

    # ------------------------------------------------------------ rendering

    def _field(self, params, pos: torch.Tensor) -> torch.Tensor:
        return self.model.apply(params, torch.clamp(pos, 0, 1))

    @torch.no_grad()
    def _sphere_trace(self, params, origins, dirs, n_iters: int = 50, eps: float = 5e-4):
        """Sphere tracing in [0,1]³, n_iters steps of every ray with the
        dead ones masked → (t, pos, hit)."""
        tmin, tmax = coords.BoundingBox.unit(origins.device).ray_intersect(origins, dirs)
        t = torch.clamp_min(tmin, 0.0)
        alive = t < tmax
        hit_box = alive.clone()
        for _ in range(n_iters):
            d = self._field(params, origins + t[:, None] * dirs)
            t_new = t + d
            alive = alive & ~(d.abs() < eps) & ~(t_new > tmax)
            t = torch.where(alive, t_new, t)
        pos = origins + t[:, None] * dirs
        d_final = self._field(params, pos)
        hit = hit_box & (d_final.abs() < eps * 20) & (t < tmax)
        return t, pos, hit

    def _normals(self, params, pos: torch.Tensor) -> torch.Tensor:
        """Unit surface normals: the autodiff gradient of the field at the
        clamped position (kernel F on the card; the parameters detached, so
        no table gradient) or central differences of ``fd_normals_epsilon``."""
        params = {k: v.detach() for k, v in (params or dict(self.model.named_parameters())).items()}
        if self.analytic_normals:
            with torch.enable_grad():
                p = torch.clamp(pos, 0, 1).detach().requires_grad_(True)
                (g,) = torch.autograd.grad(self.model.apply(params, p).sum(), p)
        else:
            e = self.fd_normals_epsilon
            with torch.no_grad():
                g = torch.stack(
                    [
                        self._field(params, pos + off * e) - self._field(params, pos - off * e)
                        for off in torch.eye(3, device=pos.device)
                    ],
                    -1,
                )
        return g / (torch.linalg.vector_norm(g, dim=-1, keepdim=True) + 1e-9)

    @torch.no_grad()
    def _shadow_trace(self, params, origins, dirs, k: float, n_iters: int = 40):
        """Sphere-trace toward the light keeping the soft visibility
        min(k·d/t) (the reference's shadow tracer, sharpness k)."""
        _, tmax = coords.BoundingBox.unit(origins.device).ray_intersect(origins, dirs)
        t = torch.full(origins.shape[:1], 2e-3, device=origins.device)
        vis = torch.ones(origins.shape[:1], device=origins.device)
        for _ in range(n_iters):
            d = torch.clamp_min(self._field(params, origins + t[:, None] * dirs), 0.0)
            vis = torch.minimum(vis, k * d / torch.clamp_min(t, 1e-4))
            t = torch.minimum(t + torch.clamp_min(d, 1e-3), tmax)
        return torch.clamp(vis, 0.0, 1.0)

    def _sun(self, device) -> torch.Tensor:
        sun = np.asarray(self.sun_dir, np.float32)
        return torch.as_tensor(sun / (np.linalg.norm(sun) + 1e-12), device=device)

    def trace(self, params, o: torch.Tensor, d: torch.Tensor):
        """Shade rays (o, d) [R, 3] → (linear rgb [R, 3], hit [R], t [R])."""
        dev = o.device
        t, pos, hit = self._sphere_trace(params, o, d)
        if self.floor_enable:  # an analytic floor plane: the closer hit wins, or fills a miss
            floor_y = 0.05
            t_floor = (floor_y - o[:, 1]) / torch.where(d[:, 1].abs() < 1e-9, torch.full_like(t, 1e-9), d[:, 1])
            floor_hit = (t_floor > 0) & (torch.where(hit, t, torch.full_like(t, math.inf)) > t_floor)
            t = torch.where(floor_hit, t_floor, t)
            pos = torch.where(floor_hit[:, None], o + t[:, None] * d, pos)
            hit = hit | floor_hit
        else:
            floor_hit = torch.zeros_like(hit)
        n = self._normals(params, pos)
        n = torch.where(floor_hit[:, None], torch.tensor([0.0, 1.0, 0.0], device=dev), n)
        sun = self._sun(dev)
        if self.render_shadows:
            vis = self._shadow_trace(params, pos + n * 3e-3, sun.expand_as(pos), self.shadow_sharpness)
        else:
            vis = torch.ones(pos.shape[:1], device=dev)
        base = torch.where(
            floor_hit[:, None], torch.tensor([0.6, 0.6, 0.6], device=dev),
            torch.tensor(self.brdf.basecolor, dtype=torch.float32, device=dev).expand_as(pos),
        )
        with torch.no_grad():
            rgb = disney_shade(
                base, torch.tensor(self.brdf.ambientcolor, dtype=torch.float32, device=dev) * 0.25,
                torch.ones(3, device=dev) * vis[:, None], self.brdf, sun, -d, n,
            )
        rgb = torch.where(hit[:, None], rgb, torch.zeros_like(rgb))
        return rgb, hit, t

    def render(self, width: int, height: int, camera_matrix, focal, linear: bool = False) -> torch.Tensor:
        """Sphere-traced Disney-BRDF shading with a sun light, soft shadows
        and the optional floor → [H, W, 4] on the testbed's device (rgb sRGB-
        encoded unless ``linear``, alpha the hit mask), in chunks of
        ``RENDER_CHUNK`` rays."""
        from nerfshop_tpu_torch.ops import rays as rays_lib

        dev = self.device
        params = self.state.inference_params

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        bundle = rays_lib.rays_for_image((width, height), t(camera_matrix), t(focal), t([0.5, 0.5]))
        rgbs, hits = [], []
        for i in range(0, width * height, RENDER_CHUNK):
            rgb, hit, _ = self.trace(params, bundle.origins[i : i + RENDER_CHUNK], bundle.directions[i : i + RENDER_CHUNK])
            rgbs.append(rgb)
            hits.append(hit)
        rgb = torch.cat(rgbs).reshape(height, width, 3)
        if not linear:
            rgb = tm.linear_to_srgb(rgb)
        return torch.cat([rgb, torch.cat(hits).reshape(height, width, 1).float()], -1)

    # -------------------------------------------------------------- metrics

    @torch.no_grad()
    def calculate_iou(self, n_samples: int = 128**3, points: Optional[torch.Tensor] = None) -> float:
        """Intersection over union of the inside sets (the network's sign
        against the BVH's) on min(n_samples, 2^18) uniform points, or on
        ``points``."""
        if points is None:
            n = min(n_samples, 1 << 18)
            points = torch.rand((n, 3), generator=self.generator, device=self.device)
        gt_inside = bvh_lib.signed_distance(self.packed_bvh, points) < 0
        pred_inside = self.model.apply(self.state.inference_params, points) < 0
        inter = int((gt_inside & pred_inside).sum())
        union = int((gt_inside | pred_inside).sum())
        return inter / max(float(union), 1.0)
