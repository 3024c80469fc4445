"""Testbed — the user-facing facade, NeRF part.

Counterpart of the NeRF half of ``nerfshop_tpu/testbed.py``: construct with
a config, load a scene (``load_training_data``, or ``set_training_data``
with an in-memory ``NerfDataset``), ``train`` (chunks of up to 16 steps
through ``train/nerf.py::make_train_loop``, one captured CUDA graph per
chunk length on a CUDA device; a grid refresh every 16 steps, full during
the first 256, the degenerate-training guards and the adaptive (rays, K)
bucket), the camera API, ``render`` / ``render_dynamic``
/ ``frame`` through the exact renderer, ``save_snapshot`` /
``load_snapshot`` in the native format, and the edit API (``begin_cage_edit``
→ a ``GrowingSelection``; ``add_edit_operator`` and its siblings, which
refresh the density grid through the operator stack; ``save_edits`` /
``load_edits``). ``render`` always takes the exact path, through the edit
stack: the tiled path is not ported, and ``exact=False`` raises. The other
testbed modes are not ported yet.

Without a ``device`` the testbed takes ``cuda:0`` and raises when CUDA is
absent; the CPU runs only when asked for by name (``device="cpu"``).
"""

from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from nerfshop_tpu_torch.common import DEFAULT_BATCH_SIZE, DEFAULT_STEPS_PER_FRAME, RenderMode, TestbedMode, TonemapCurve
from nerfshop_tpu_torch.config import ConfigDict, default_nerf_config, load_network_config
from nerfshop_tpu_torch.device import default_device
from nerfshop_tpu_torch.models.nerf_network import check_kernel_range


def upsample_bilinear(img: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """[h, w, C] → [height, width, C] on ``img``'s device, bilinear with
    half-pixel centres and clamped edges (what ``jax.image.resize(...,
    "linear")`` does when it enlarges)."""
    x = torch.nn.functional.interpolate(img.permute(2, 0, 1)[None], size=(height, width), mode="bilinear", align_corners=False)
    return x[0].permute(1, 2, 0).contiguous()


class _Namespace:
    def __init__(self, **kw):
        self.__dict__.update(kw)


@dataclass
class TrainingStats:
    step: int = 0
    loss: float = 0.0
    measured_batch_size: int = 0
    #: Σ of valid samples over every step trained so far
    measured_samples_total: int = 0
    training_prep_ms: float = 0.0
    training_ms: float = 0.0
    frame_ms: float = 0.0
    #: sample slots the field evaluated in the last render (all passes)
    render_samples: int = 0
    #: training steps run by replaying a captured CUDA graph, and the replays
    captured_steps: int = 0
    graph_replays: int = 0
    #: kernel launches of one replay of the newest captured training graph,
    #: by "wrapper.counter" (``nerfshop_tpu_torch.kernels.launch_counts``)
    graph_launches: dict = field(default_factory=dict)


class Testbed:
    def __init__(
        self,
        mode: TestbedMode | str = TestbedMode.Nerf,
        scene: Optional[str] = None,
        config: Optional[str | dict] = None,
        device: Optional[str | torch.device] = None,
        seed: Optional[int] = None,
    ):
        self.mode = TestbedMode(mode) if isinstance(mode, str) else mode
        if self.mode != TestbedMode.Nerf:
            raise NotImplementedError(f"testbed mode {self.mode} is not ported")
        self.device = torch.device(device) if device is not None else default_device()
        network_config = None
        if config is not None:
            network_config = load_network_config(config) if isinstance(config, (str, Path)) else ConfigDict(config)
            check_kernel_range(network_config, self.device)  # before anything is allocated
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(time.time()) % (1 << 31) if seed is None else seed)
        self.shall_train = False
        self.render_mode = RenderMode.Shade
        self.tonemap_curve = TonemapCurve.Identity
        self.exposure = 0.0
        self.background_color = np.array([0.0, 0.0, 0.0, 0.0], np.float32)
        self.dynamic_res = True
        self.dynamic_res_target_fps = 20.0
        #: last frame() render, [H, W, 4]
        self.frame_buffer: Optional[np.ndarray] = None
        #: depth of field: lens aperture (0 = pinhole) and focus distance;
        #: autofocus takes the focus from the previous frame's depth
        self.dof = 0.0
        self.focus_z = 1.0
        self.autofocus = False
        self.autofocus_target = np.array([0.5, 0.5], np.float32)  # screen uv
        #: principal point
        self.screen_center = np.array([0.5, 0.5], np.float32)
        #: optional world-space render crop box (lo, hi)
        self.render_aabb = None
        self.nerf = _Namespace(
            training=_Namespace(
                n_images_for_training=0,
                random_bg_color=True,
                near_distance=0.2,
                optimize_extrinsics=False,
                optimize_exposure=False,
                optimize_distortion=False,
                train_envmap=False,
                use_error_map=False,
            ),
            render_min_transmittance=1e-2,
            cone_angle_constant=0.0,
        )
        self.stats = TrainingStats()
        self.loss_history: list = []
        self._network_config: ConfigDict = default_nerf_config()
        self._dataset = None
        self._device_data = None
        self._model = None
        self._state = None
        self._grid = None
        self._train_cfg = None
        self._trained_mask = None
        self._step_ready = False
        #: training loops by (rays, K, chunk) of the current network and bucket
        self._loops: dict = {}
        self._last_depth: Optional[np.ndarray] = None
        self._edit_operators: list = []
        #: dynamic-resolution factor in [1/8, 1]
        self._dyn_res_factor = 1.0
        self._view_distance = 1.5
        self.set_look_at(center=(0.5, 0.5, 0.5), eye=(0.5, -1.5, 0.5))
        self.fov_deg = 50.0
        if network_config is not None:
            self._network_config = network_config
            self._reset_network()
        if scene is not None:
            self.load_training_data(scene)

    # ------------------------------------------------------------------- data

    def load_training_data(self, path: str, downscale: int = 1) -> None:
        from nerfshop_tpu_torch.data import nerf_loader

        path = Path(path)
        json_path = path if path.suffix == ".json" else path / "transforms.json"
        self.set_training_data(nerf_loader.load_nerf(json_path, downscale=downscale))

    def set_training_data(self, ds) -> None:
        """Use an in-memory ``data.nerf_loader.NerfDataset``."""
        if getattr(ds, "envmap_path", None):
            raise NotImplementedError("envmap training is not ported")
        self._dataset = ds
        self.nerf.training.n_images_for_training = ds.n_images
        self._reset_network()

    # ----------------------------------------------------------------- network

    def _reset_network(self) -> None:
        from nerfshop_tpu_torch.models.nerf_network import build_nerf_network
        from nerfshop_tpu_torch.ops import grid as grid_lib
        from nerfshop_tpu_torch.train import nerf as nerf_train
        from nerfshop_tpu_torch.train import optim

        cfg = self._network_config
        ds = self._dataset
        aabb_scale = ds.aabb_scale if ds is not None else 1
        self._model = build_nerf_network(
            cfg, aabb_scale=aabb_scale, is_hdr=bool(ds is not None and ds.is_hdr),
            device=self.device, generator=self.generator,
        )
        self._state = optim.TrainState(self._model, optim.build_optimizer(dict(cfg.get("optimizer", {}))))
        t = self.nerf.training
        self._train_cfg = nerf_train.NerfTrainConfig.for_aabb_scale(
            aabb_scale,
            loss_type=cfg.get("loss", {}).get("otype", "Huber"),
            near_distance=t.near_distance,
            random_bg=bool(t.random_bg_color),
            train_envmap=bool(t.train_envmap),
            optimize_extrinsics=bool(t.optimize_extrinsics or t.optimize_distortion),
            optimize_exposure=bool(t.optimize_exposure),
            use_error_map=bool(t.use_error_map),
        )
        self.nerf.cone_angle_constant = self._train_cfg.cone_angle
        self._grid = grid_lib.OccupancyGrid.create(self._train_cfg.n_cascades, device=self.device)
        self._device_data = (
            nerf_train.DeviceDataset.from_dataset(ds, self.device) if ds is not None and ds.intrinsics else None
        )
        self._step_ready = False
        self._loops = {}
        self.stats = TrainingStats()

    @property
    def model(self):
        return self._model

    @property
    def grid(self):
        return self._grid

    @property
    def inference_params(self):
        return self._state.inference_params

    @property
    def train_config(self):
        return self._train_cfg

    @property
    def trained_mask(self) -> Optional[torch.Tensor]:
        """[C, R, R, R] bool cells seen by some training camera, or None."""
        return self._trained_mask

    # ---------------------------------------------------------------- training

    def train(self, n_steps: int = DEFAULT_STEPS_PER_FRAME, batch_size: int = DEFAULT_BATCH_SIZE) -> float:
        """n_steps of optimization; returns the last loss."""
        from nerfshop_tpu_torch.train import nerf as nerf_train

        if self._dataset is None:
            raise RuntimeError("load_training_data first")
        t_start = time.perf_counter()
        if not self._step_ready:
            self._batch_slots = max(1 << 13, batch_size)
            self._k_bucket = self._train_cfg.k_samples
            self._build_step_fn(self._batch_slots // self._k_bucket, self._k_bucket)

        loss = float(self.stats.loss)
        remaining = n_steps
        overflow_sum, n_chunks = 0.0, 0
        while remaining > 0:
            step = self.stats.step
            if step % 16 == 0:
                t0 = time.perf_counter()
                nerf_train.update_grid(
                    self._model, self._grid, self._train_cfg, self.generator,
                    full_refresh=step < 256, trained_mask=self._trained_mask,
                )
                self.stats.training_prep_ms = (time.perf_counter() - t0) * 1e3
            chunk = min(remaining, 16 - step % 16)
            loop = self._get_loop(chunk)
            out = loop(self._grid, self.generator)
            if loop.captured:
                self.stats.captured_steps += chunk
                self.stats.graph_replays += 1
                self.stats.graph_launches = {f"{fn.__name__}.{name}": n for (fn, name), n in loop.graph_launches.items()}
            # one host pull per chunk: losses, sample counts, overflow
            ys = torch.stack([out["loss"], out["measured_samples"], out["sample_overflow_frac"]], 1).cpu().numpy()
            self.stats.step += chunk
            remaining -= chunk
            loss = float(ys[-1, 0])
            measured = int(ys[-1, 1])
            self.stats.measured_samples_total += int(ys[:, 1].sum())
            overflow_sum += float(ys[:, 2].mean())
            n_chunks += 1
            for i, lv in enumerate(ys[:, 0]):
                self.loss_history.append((self.stats.step - chunk + 1 + i, float(lv)))
            if measured == 0:
                self.shall_train = False
                raise RuntimeError(
                    "training generated 0 samples (empty occupancy along every ray) — aborting; "
                    "check the scene scale/aabb_scale"
                )
            if not math.isfinite(loss):
                self.shall_train = False
                raise RuntimeError(f"non-finite training loss at step {self.stats.step}")
            self.stats.loss = loss
            self.stats.measured_batch_size = measured
        del self.loss_history[:-512]
        # adaptive (rays, K) bucket: most rays filling K → fewer, longer rays
        overflow = overflow_sum / max(n_chunks, 1)
        if n_chunks and overflow > 0.6 and self._k_bucket < 1024:
            self._k_bucket *= 2
            self._build_step_fn(max(64, self._batch_slots // self._k_bucket), self._k_bucket)
        elif n_chunks and overflow < 0.08 and self._k_bucket > 32:
            self._k_bucket //= 2
            self._build_step_fn(max(64, self._batch_slots // self._k_bucket), self._k_bucket)
        self.stats.training_ms = (time.perf_counter() - t_start) * 1e3
        return loss

    def _get_loop(self, chunk: int):
        """The ``chunk``-step training loop of the current bucket
        (``train/nerf.py::make_train_loop``: captured on a CUDA device,
        eager on the CPU), made at first use. The cache goes with the
        network (``_reset_network``, so also ``set_training_data`` and
        ``load_snapshot``) and with the bucket (``_build_step_fn``)."""
        from nerfshop_tpu_torch.train import nerf as nerf_train

        key = (self._train_cfg.n_rays_per_batch, self._train_cfg.k_samples, chunk)
        loop = self._loops.get(key)
        if loop is None:
            loop = nerf_train.make_train_loop(self._state, self._grid, self._device_data, self._train_cfg, chunk)
            self._loops[key] = loop
        return loop

    def _build_step_fn(self, n_rays: int, k_samples: Optional[int] = None) -> None:
        """Set the (rays, K) bucket and the untrained-cell mask; drops the
        training loops of the previous bucket."""
        from nerfshop_tpu_torch.ops import grid as grid_lib
        from nerfshop_tpu_torch.train import nerf as nerf_train

        self._train_cfg = nerf_train.NerfTrainConfig(
            **{**self._train_cfg.__dict__, "n_rays_per_batch": n_rays, "k_samples": k_samples or self._train_cfg.k_samples}
        )
        ds = self._dataset
        usable = (
            ds is not None
            and ds.xforms is not None
            and len(ds.xforms) > 1
            and len(ds.intrinsics) == len(ds.xforms)
            and np.abs(np.asarray(ds.distortion_matrix())).max() <= 1e-8
        )
        self._trained_mask = None
        self._loops = {}
        if usable:
            xf = np.asarray(ds.xforms, np.float32)
            res_hw = np.asarray([[im.shape[1], im.shape[0]] for im in ds.images], np.float32)

            def t(a):
                return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=self.device)

            self._trained_mask = grid_lib.mark_untrained_cells(
                self._train_cfg.n_cascades, t(xf[:, :, 3]), t(xf[:, :, 2]), t(ds.focal_matrix()), t(res_hw)
            )
        self._step_ready = True

    # --------------------------------------------------------------- rendering

    #: frame() renders into ``self.frame_buffer`` at this (W, H) when a model
    #: is loaded; None trains only
    frame_resolution: Optional[Tuple[int, int]] = (320, 180)

    def frame(self) -> bool:
        """One headless frame: 16 training steps when ``shall_train``, then a
        dynamic-resolution render into ``self.frame_buffer``."""
        t0 = time.perf_counter()
        if self.shall_train:
            self.train(DEFAULT_STEPS_PER_FRAME, DEFAULT_BATCH_SIZE)
        if self.frame_resolution is not None and self._model is not None:
            w, h = self.frame_resolution
            self.frame_buffer = self.render_dynamic(w, h, spp=1)
        self.stats.frame_ms = (time.perf_counter() - t0) * 1e3
        return True

    def set_train(self, value: bool) -> None:
        self.shall_train = value

    def set_look_at(self, center=(0.5, 0.5, 0.5), eye=(0.5, -1.5, 0.5), up=(0.0, 0.0, 1.0)) -> None:
        center = np.asarray(center, np.float32)
        eye = np.asarray(eye, np.float32)
        fwd = center - eye
        fwd = fwd / (np.linalg.norm(fwd) + 1e-12)
        right = np.cross(fwd, np.asarray(up, np.float32))
        right /= np.linalg.norm(right) + 1e-12
        down = np.cross(fwd, right)
        self.camera_matrix = np.concatenate([np.stack([right, down, fwd], 1), eye[:, None]], axis=1).astype(np.float32)

    def set_nerf_camera_matrix(self, nerf_matrix: np.ndarray) -> None:
        """Set the view from a nerf-convention (transforms.json) matrix."""
        from nerfshop_tpu_torch.data.nerf_loader import nerf_matrix_to_ngp

        ds = self._dataset
        scale = ds.scale if ds else 0.33
        offset = ds.offset if ds else np.array([0.5, 0.5, 0.5], np.float32)
        self.camera_matrix = nerf_matrix_to_ngp(np.asarray(nerf_matrix, np.float32), scale, offset)

    def _focal_for(self, width: int, height: int) -> np.ndarray:
        f = 0.5 * height / math.tan(0.5 * math.radians(self.fov_deg))
        return np.array([f, f], np.float32)

    @property
    def fov(self) -> float:
        """Vertical field of view in degrees."""
        return self.fov_deg

    @fov.setter
    def fov(self, deg: float) -> None:
        self.fov_deg = float(deg)

    @property
    def view_dir(self) -> np.ndarray:
        return self.camera_matrix[:, 2].copy()

    @view_dir.setter
    def view_dir(self, d) -> None:
        # rotate the camera about its look-at point to face the new direction
        at = self.look_at
        d = np.asarray(d, np.float32)
        d = d / (np.linalg.norm(d) + 1e-12)
        self.set_look_at(center=at, eye=at - d * self.view_distance, up=-self.camera_matrix[:, 1])

    @property
    def up_dir(self) -> np.ndarray:
        return -self.camera_matrix[:, 1].copy()

    @property
    def view_distance(self) -> float:
        """Distance from the camera to its orbit point."""
        return self._view_distance

    @view_distance.setter
    def view_distance(self, s: float) -> None:
        self._view_distance = float(s)

    @property
    def look_at(self) -> np.ndarray:
        """Orbit point: ``view_distance`` along the view axis."""
        return self.camera_matrix[:, 3] + self.camera_matrix[:, 2] * self.view_distance

    @look_at.setter
    def look_at(self, p) -> None:
        self.camera_matrix = self.camera_matrix.copy()
        self.camera_matrix[:, 3] = np.asarray(p, np.float32) - self.camera_matrix[:, 2] * self.view_distance

    def translate_camera(self, delta) -> None:
        """Move the camera in its local frame (right/down/forward axes)."""
        self.camera_matrix = self.camera_matrix.copy()
        self.camera_matrix[:, 3] += self.camera_matrix[:, :3] @ np.asarray(delta, np.float32)

    def set_camera_to_training_view(self, i: int) -> None:
        """Adopt training view ``i``'s extrinsics and field of view."""
        if self._dataset is None:
            raise RuntimeError("no training data")
        self.camera_matrix = np.asarray(self._dataset.xforms[i], np.float32).copy()
        intr = self._dataset.intrinsics[i]
        self.fov_deg = float(np.degrees(2.0 * np.arctan(0.5 * float(intr.resolution[1]) / float(intr.focal[1]))))

    def first_training_view(self) -> None:
        self.set_camera_to_training_view(0)

    def render(self, width: int, height: int, *args, **kw) -> np.ndarray:
        """→ [H, W, 4] float32 numpy frame: :meth:`_render_image` (which
        lists the options), copied to the host."""
        return self._render_image(width, height, *args, **kw).cpu().numpy()

    def _render_image(
        self,
        width: int,
        height: int,
        spp: int = 1,
        linear: bool = False,
        camera_matrix: Optional[np.ndarray] = None,
        focal: Optional[np.ndarray] = None,
        principal: Optional[np.ndarray] = None,
        min_transmittance: Optional[float] = None,
        distortion: Optional[np.ndarray] = None,
        lens: str = "pinhole",
        ftheta_coeffs: Optional[np.ndarray] = None,
        exact: Optional[bool] = None,
    ) -> torch.Tensor:
        """→ [H, W, 4] float32 on the testbed's device, sRGB-encoded unless
        ``linear``, through the exact renderer. ``lens`` is 'pinhole',
        'ftheta' (5 polynomial coefficients) or 'latlong'. ``exact`` None or
        True; False asks for the tiled path, which is not ported, and
        raises."""
        from nerfshop_tpu_torch.ops import sampling
        from nerfshop_tpu_torch.ops import tonemap as tm
        from nerfshop_tpu_torch.render import renderer
        from nerfshop_tpu_torch.render.buffer import RenderBuffer

        if exact is False:
            raise NotImplementedError("the tiled render path is not ported; render(exact=True)")
        if self._model is None:
            raise RuntimeError("no network: pass a config or load training data or a snapshot first")
        dev = self.device

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        cam = camera_matrix if camera_matrix is not None else self.camera_matrix
        focal = focal if focal is not None else self._focal_for(width, height)
        principal = principal if principal is not None else self.screen_center
        focus = self.focus_z
        if self.autofocus and self._last_depth is not None:
            # focus at the previous frame's depth under the autofocus target
            d = self._last_depth
            ty = int(np.clip(self.autofocus_target[1] * d.shape[0], 0, d.shape[0] - 1))
            tx = int(np.clip(self.autofocus_target[0] * d.shape[1], 0, d.shape[1] - 1))
            v = float(d[ty, tx])
            if np.isfinite(v) and v > 1e-3:
                focus = self.focus_z = v
        opts = self._render_options(min_transmittance, focus)
        dist = t(distortion) if distortion is not None and np.any(np.asarray(distortion)) else None
        ftheta = t(ftheta_coeffs) if ftheta_coeffs is not None else None
        buf = RenderBuffer((width, height), device=dev)
        buf.clear()
        chunk = min(opts.chunk, width * height)
        n_rays = -(-(width * height) // chunk) * chunk
        per_ray = 1 if opts.mode == RenderMode.Slice else opts.k_samples * opts.n_windows
        self.stats.render_samples = spp * n_rays * per_ray
        for s in range(spp):
            jitter = None
            if spp > 1:
                jitter = t(sampling.spp_jitter(s, width * height, seed=self.stats.step))
            dof_uv = None
            if self.dof > 0.0:
                u = torch.rand((width * height, 2), generator=self.generator, device=dev)
                r = torch.sqrt(u[:, 0:1])
                th = 2.0 * math.pi * u[:, 1:2]
                dof_uv = torch.cat([r * torch.cos(th), r * torch.sin(th)], dim=-1)
            out = renderer.render_frame(
                self._model, self.inference_params, self._grid, (width, height), t(cam), t(focal), t(principal),
                distortion=dist, opts=opts, subpixel_jitter=jitter, lens=lens, ftheta_coeffs=ftheta, dof_uv=dof_uv,
                operators=tuple(self._edit_operators),
            )
            buf.accumulate(out.rgba, out.depth)
        self._last_depth = out.depth.cpu().numpy()

        srgb_space_model = self._dataset is not None and self._dataset.color_space == "srgb"
        img = buf.tonemapped(
            exposure=self.exposure,
            curve=self.tonemap_curve,
            output_srgb=not linear,
            input_is_srgb_space=srgb_space_model and not linear,
        )
        if linear and srgb_space_model:
            # the model predicts sRGB-space radiance; convert for linear output
            img = torch.cat([tm.srgb_to_linear(img[..., :3]), img[..., 3:]], dim=-1)
        return img

    def _render_options(self, min_transmittance: Optional[float] = None, focus_z: Optional[float] = None):
        """The exact renderer's options for the testbed's state and grid."""
        from nerfshop_tpu_torch.render import renderer

        occ_frac = float(self._grid.occupancy.float().mean())
        # the sample budget follows the grid: a dense grid needs a deep
        # first-K budget to reach content, a sparse one a short one
        k_render = 64 if occ_frac < 0.15 else 256
        crop = None
        if self.render_aabb is not None:
            lo, hi = self.render_aabb
            crop = (tuple(float(v) for v in lo), tuple(float(v) for v in hi))
        # chunk × K_total ≤ 2^22 sample rows
        chunk = max(512, min(1 << 13, (1 << 22) // (2 * k_render)))
        return renderer.RenderOptions(
            k_samples=k_render,
            n_windows=2,
            chunk=chunk,
            use_grid_early_stop=occ_frac < 0.15,
            cone_angle=self._train_cfg.cone_angle,
            aabb_scale=self._train_cfg.aabb_scale,
            min_transmittance=min_transmittance or self.nerf.render_min_transmittance,
            mode=self.render_mode,
            background=tuple(float(v) for v in np.asarray(self.background_color, np.float32)),
            render_aabb=crop,
            aperture=float(self.dof),
            focus_z=float(self.focus_z if focus_z is None else focus_z),
        )

    def render_dynamic(self, width: int, height: int, **kw) -> np.ndarray:
        """Render at a dynamically scaled resolution and upsample bilinearly:
        the factor follows sqrt(target frame time / measured), clamped to
        [1/8, 1], with ±20% hysteresis. Honours ``dynamic_res`` and
        ``dynamic_res_target_fps``. The upsample runs on the testbed's
        device; the frame is copied to the host once, at the end."""
        f = self._dyn_res_factor if self.dynamic_res else 1.0
        w = max(32, int(width * f) // 8 * 8)
        h = max(32, int(height * f) // 8 * 8)
        t0 = time.perf_counter()
        img = self._render_image(w, h, **kw)
        if img.is_cuda:
            torch.cuda.synchronize(img.device)
        dt = time.perf_counter() - t0
        if self.dynamic_res:
            target = 1.0 / max(self.dynamic_res_target_fps, 1e-3)
            suggested = f * math.sqrt(target / max(dt, 1e-6))
            if suggested < f * 0.8 or suggested > f * 1.2:
                self._dyn_res_factor = float(np.clip(suggested, 1.0 / 8.0, 1.0))
        if (w, h) != (width, height):
            img = upsample_bilinear(img, width, height)
        return img.cpu().numpy()

    # ---------------------------------------------------------------- editing

    def add_edit_operator(self, op, refresh_grid: bool = True) -> None:
        """Add an operator and refresh the density grid through the stack, so
        that the march reaches the deformed target region."""
        self._edit_operators.append(op)
        if refresh_grid and self._grid is not None and self._state is not None:
            self.refresh_grid_for_edits()

    def replace_edit_operator(self, idx: int, op, refresh_grid: bool = True) -> None:
        """Swap an applied operator in place (a drag of an applied cage) and
        refresh the grid."""
        self._edit_operators[idx] = op
        if refresh_grid and self._grid is not None and self._state is not None:
            self.refresh_grid_for_edits()

    def remove_edit_operator(self, idx: int) -> None:
        self._edit_operators.pop(idx)
        if self._grid is not None and self._state is not None:
            self.refresh_grid_for_edits()

    def refresh_grid_for_edits(self) -> None:
        """Full density-grid re-estimate through the operator stack, from the
        EMA parameters; vacated cells clear on the −1 sentinel."""
        from nerfshop_tpu_torch.train import nerf as nerf_train

        nerf_train.update_grid(
            self._model, self._grid, self._train_cfg, self.generator, full_refresh=True,
            operators=tuple(self._edit_operators), params=self.inference_params,
        )

    @property
    def edit_operators(self) -> list:
        return list(self._edit_operators)

    def begin_cage_edit(self):
        """Start a cage-deformation edit → a ``GrowingSelection`` bound to
        this testbed's model, scene box and device."""
        from nerfshop_tpu_torch.editing.growing_selection import GrowingSelection
        from nerfshop_tpu_torch.ops import coords

        if self._model is None:
            raise RuntimeError("no network: pass a config or load training data or a snapshot first")
        return GrowingSelection(
            model=self._model,
            aabb=coords.BoundingBox.from_aabb_scale(self._train_cfg.aabb_scale, device=self.device),
            device=self.device,
            cone_angle=self._train_cfg.cone_angle,
        )

    def clean_empty_space(self, n_iters: int = 1) -> None:
        """Partial density-grid re-estimates through the operator stack."""
        from nerfshop_tpu_torch.train import nerf as nerf_train

        for _ in range(n_iters):
            nerf_train.update_grid(
                self._model, self._grid, self._train_cfg, self.generator, full_refresh=False,
                operators=tuple(self._edit_operators), params=self.inference_params,
            )

    def save_edits(self, path: str) -> None:
        """Write the operator list (edits JSON v1, readable by both packages)."""
        from nerfshop_tpu_torch.editing import serialization

        serialization.save_edits(path, self._edit_operators, {"mode": self.mode.value})

    def load_edits(self, path: str) -> None:
        """Replace the operator list by an edits file's and refresh the grid
        through it."""
        from nerfshop_tpu_torch.editing import serialization

        self._edit_operators = serialization.load_edits(path, self.device)
        if self._edit_operators and self._model is not None and self._grid is not None and self._state is not None:
            self.refresh_grid_for_edits()

    # --------------------------------------------------------------- snapshots

    def save_snapshot(self, path: str) -> None:
        """Native snapshot (see :mod:`nerfshop_tpu_torch.io.snapshot`): params,
        EMA copy, density grid, dataset metadata and step."""
        from nerfshop_tpu_torch.io import snapshot as snap_lib

        if self._state is None:
            raise RuntimeError("no network to save")
        metadata = None
        ds = self._dataset
        if ds is not None:
            metadata = {
                "aabb_scale": int(ds.aabb_scale),
                "scale": float(ds.scale),
                "offset": np.asarray(ds.offset).tolist(),
                "n_images": int(ds.n_images),
                "color_space": ds.color_space,
                "xforms": np.asarray(ds.xforms).tolist(),
            }
        snap_lib.save_snapshot(
            path,
            params=dict(self._model.named_parameters()),
            network_config=json.loads(json.dumps(dict(self._network_config))),
            mode=self.mode.value,
            ema_params=self._state.ema,
            density_grid=self._grid.density,
            metadata=metadata,
            step=self.stats.step,
        )

    def load_snapshot(self, path: str) -> None:
        """Load a native snapshot: network config, params, the EMA copy (the
        params where the snapshot has none), the density grid with its
        bitfield recomputed, and the step. A snapshot without a dataset gets
        a metadata-only dataset so that it renders."""
        from nerfshop_tpu_torch.io import snapshot as snap_lib
        from nerfshop_tpu_torch.ops import grid as grid_lib

        snap = snap_lib.load_snapshot(path)
        mode = TestbedMode(snap.get("mode", "nerf"))
        if mode != TestbedMode.Nerf:
            raise NotImplementedError(f"snapshot of mode {mode} is not ported")
        check_kernel_range(snap["network_config"], self.device)  # before the testbed changes
        self._network_config = ConfigDict(snap["network_config"])
        meta = snap.get("nerf")
        if meta and self._dataset is None:
            from nerfshop_tpu_torch.data.nerf_loader import NerfDataset

            self._dataset = NerfDataset(
                images=np.zeros((meta["n_images"], 2, 2, 4), np.float32),
                xforms=np.asarray(meta["xforms"], np.float32),
                intrinsics=[],
                paths=[],
                scale=meta.get("scale", 0.33),
                offset=np.asarray(meta.get("offset", [0.5, 0.5, 0.5]), np.float32),
                aabb_scale=meta.get("aabb_scale", 1),
                color_space=meta.get("color_space", "srgb"),
            )
        self._reset_network()
        params = snap_lib.restore_params(dict(self._model.named_parameters()), snap, "params")
        with torch.no_grad():
            for name, p in self._model.named_parameters():
                p.copy_(params[name])
            if self._state.ema is not None:
                ema = snap_lib.restore_params(self._state.ema, snap, "ema_params") if "ema_params" in snap else params
                for name, e in self._state.ema.items():
                    e.copy_(ema[name])
        dg = snap.get("density_grid")
        if dg is not None and dg.shape[0] == self._grid.n_cascades:
            self._grid.density = torch.tensor(dg, device=self.device)
            grid_lib.update_bitfield(self._grid)
        self._state.step = int(snap.get("step", 0))
        self.stats.step = int(snap.get("step", 0))
