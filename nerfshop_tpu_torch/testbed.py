"""Testbed — the user-facing facade.

Counterpart of ``nerfshop_tpu/testbed.py``, in its four modes. NeRF mode:
construct with
a config, load a scene (``load_training_data``, or ``set_training_data``
with an in-memory ``NerfDataset``), ``train`` (chunks of up to 16 steps
through ``train/nerf.py::make_train_loop``, one captured CUDA graph per
chunk length on a CUDA device; a grid refresh every 16 steps, full during
the first 256, the degenerate-training guards and the adaptive (rays, K)
bucket, set after every chunk, whose first K at more than one cascade
spreads over the whole march ladder; the ``nerf.training`` knobs
``optimize_extrinsics``, ``optimize_distortion`` (through the extrinsics
path), ``optimize_exposure``,
``use_error_map`` and ``train_envmap``, and a scene's envmap, which the
renders composite behind transparent pixels; a captured scene's rolling
shutter, motion blur and light dirs, with ``nerf.light_dir`` for the
renders), the camera API with the training views' extrinsics
(``get_camera_extrinsics`` / ``set_camera_extrinsics``), ``training_step``,
``n_params``, ``level_stats``, ``reload_network_from_file`` /
``reload_network_from_json``, a ``torch.profiler`` trace
(``start_profiler`` / ``stop_profiler``), ``render`` / ``render_dynamic``
/ ``frame`` through the exact renderer, ``save_snapshot`` /
``load_snapshot`` in the native format, and the edit API (``begin_cage_edit``
→ a ``GrowingSelection``; ``add_edit_operator`` and its siblings, which
refresh the density grid through the operator stack; ``save_edits`` /
``load_edits``), and the outputs: ``screenshot`` (PNG, JPEG or EXR),
``load_camera_path``, the density grid, the marching-tets mesh with
vertex colours, its refinement and export, and density slices. ``render``
always takes the exact path, through the edit stack: the tiled path is not
ported, and ``exact=False`` raises. The baked interactive preview
(``bake_interactive``, ``render_interactive``; ``render/baked.py``) bakes
the edited field into a dense grid and rebakes only the region a changed
operator touches; what changed is told by version counters (the network's,
the grid's, and one per operator slot), never by ``id()``.

The Image, SDF and Volume modes (``train/image.py``, ``train/sdf.py``,
``train/volume.py``) load an image, a mesh or a density volume
(``load_training_data``), ``train``, ``render`` and ``screenshot`` the
current camera, and save and load snapshots of their one network; the SDF
mode has the ``sdf`` namespace (``brdf``, ``sun_dir``, the shading knobs)
and ``calculate_iou``, the Image mode ``compute_image_mse``. The NeRF-only
methods (edits, the density grid, meshes) raise in those modes. A loaded
snapshot keeps its weights in every mode (the JAX package loses them in the
SDF and Volume modes: ``ROADMAP.md`` Queue 3, F13).

Without a ``device`` the testbed takes ``cuda:0`` and raises when CUDA is
absent; the CPU runs only when asked for by name (``device="cpu"``).
"""

from __future__ import annotations

import itertools
import json
import math
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from nerfshop_tpu_torch.common import DEFAULT_BATCH_SIZE, DEFAULT_STEPS_PER_FRAME, RenderMode, TestbedMode, TonemapCurve
from nerfshop_tpu_torch.config import (
    ConfigDict, default_image_config, default_nerf_config, default_sdf_config, default_volume_config,
    load_network_config,
)
from nerfshop_tpu_torch.device import default_device
from nerfshop_tpu_torch.models.encodings import encoding_shape
from nerfshop_tpu_torch.models.nerf_network import check_kernel_range


def upsample_bilinear(img: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """[h, w, C] → [height, width, C] on ``img``'s device, bilinear with
    half-pixel centres and clamped edges (what ``jax.image.resize(...,
    "linear")`` does when it enlarges)."""
    x = torch.nn.functional.interpolate(img.permute(2, 0, 1)[None], size=(height, width), mode="bilinear", align_corners=False)
    return x[0].permute(1, 2, 0).contiguous()


DEFAULT_CONFIGS = {
    TestbedMode.Nerf: default_nerf_config,
    TestbedMode.Image: default_image_config,
    TestbedMode.Sdf: default_sdf_config,
    TestbedMode.Volume: default_volume_config,
}


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
        self.device = torch.device(device) if device is not None else default_device()
        network_config = None
        if config is not None:
            network_config = load_network_config(config) if isinstance(config, (str, Path)) else ConfigDict(config)
            check_kernel_range(network_config, self.device, self.mode)  # before anything is allocated
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
            #: the light direction renders give a network built with a
            #: scene's light dirs (its extra dims)
            light_dir=np.array([0.0, 0.0, 1.0], np.float32),
        )
        self.stats = TrainingStats()
        #: the newest ``torch.profiler`` trace of :meth:`start_profiler` /
        #: :meth:`stop_profiler`, and where it goes
        self.profiler = None
        self._profiler_dir: Optional[str] = None
        self.loss_history: list = []
        self._network_config: ConfigDict = DEFAULT_CONFIGS[self.mode]()
        self._dataset = None
        #: the other modes' data and models (None in NeRF mode)
        self._image_target: Optional[np.ndarray] = None
        self._image_dev: Optional[torch.Tensor] = None
        self._image_model = None
        self._sdf_mesh = None
        self._sdf = None
        self._volume_grid: Optional[np.ndarray] = None
        self._volume = None
        self._device_data = None
        self._model = None
        self._state = None
        self._grid = None
        self._train_cfg = None
        self._trained_mask = None
        #: the error map a training loop with ``use_error_map`` samples and updates
        self._error_map = None
        self._step_ready = False
        #: training loops by (rays, K, chunk) of the current network and bucket
        self._loops: dict = {}
        self._last_depth: Optional[np.ndarray] = None
        self._edit_operators: list = []
        #: versions of what a bake reads: the network's parameters, the
        #: density grid, and each slot of the operator stack (a fresh number
        #: from ``_versions`` whenever the slot's operator is set)
        self._versions = itertools.count(1)
        self._params_version = 0
        self._grid_version = 0
        self._op_versions: list = []
        #: the baked preview: side of its grid, the bake and what it was made of
        self.interactive_bake_resolution = 256
        self.last_bake_incremental = False
        self._baked = None
        self._baked_key = None
        self._baked_ops: list = []
        #: the keyframed path of ``load_camera_path``
        self.camera_path = None
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
        """A NeRF scene (a directory or its transforms.json), an image (Image
        mode, read linear), a mesh (SDF mode) or a density volume (Volume
        mode: .npy, .npz, .raw + .json, .nvdb); ``downscale`` is NeRF's."""
        path = Path(path)
        if self.mode == TestbedMode.Nerf:
            from nerfshop_tpu_torch.data import nerf_loader

            json_path = path if path.suffix == ".json" else path / "transforms.json"
            self.set_training_data(nerf_loader.load_nerf(json_path, downscale=downscale))
            return
        if self.mode == TestbedMode.Image:
            from nerfshop_tpu_torch.data import image_io

            self._image_target = image_io.read_image(path, linear=True)[..., :3]
        elif self.mode == TestbedMode.Sdf:
            from nerfshop_tpu_torch.geometry import mesh_io

            self._sdf_mesh = mesh_io.load_mesh(path)
        else:
            from nerfshop_tpu_torch.data import volume_io

            self._volume_grid = volume_io.load_volume(path)
        self._reset_network()

    def set_training_data(self, ds) -> None:
        """Use an in-memory ``data.nerf_loader.NerfDataset``."""
        self._dataset = ds
        self.nerf.training.n_images_for_training = ds.n_images
        self._reset_network()

    # ----------------------------------------------------------------- network

    def reload_network_from_file(self, path: str = "") -> None:
        """A fresh network (and optimizer, grid and step) from the config at
        ``path``, or from the current config when ``path`` is empty (the
        reference's distillation resets the network so)."""
        if path:
            cfg = load_network_config(path)
            check_kernel_range(cfg, self.device, self.mode)
            self._network_config = cfg
        self._reset_network()

    def reload_network_from_json(self, cfg: dict) -> None:
        """A fresh network (and optimizer, grid and step) from the config ``cfg``."""
        cfg = ConfigDict(cfg)
        check_kernel_range(cfg, self.device, self.mode)
        self._network_config = cfg
        self._reset_network()

    def _n_extra_dims(self) -> int:
        """The network's extra input dims for the loaded scene: 3 with light
        dirs, else its ``n_extra_learnable_dims``. The JAX package feeds the
        learnable dims nothing (``ROADMAP.md`` Queue 3, F17): they reach no
        network input under a plain SH dir encoding, and where the dir
        encoding would read them (the default ``Composite``) JAX's step
        fails on the rgb MLP's width, so the port raises ``ValueError``
        naming F17."""
        ds = self._dataset
        if ds is None:
            return 0
        if getattr(ds, "has_light_dirs", False):
            return 3
        n = int(getattr(ds, "n_extra_learnable_dims", 0) or 0)
        dir_cfg = self._network_config.get("dir_encoding")
        if n and dir_cfg and encoding_shape(dict(dir_cfg), 3 + n)[0] != encoding_shape(dict(dir_cfg), 3)[0]:
            raise ValueError(
                f"n_extra_learnable_dims {n}: the dir encoding would read {n} extra inputs that training feeds "
                "nothing (F17: the JAX package builds them into the network but never feeds them, and its step "
                "fails on the rgb MLP's width); use a plain SphericalHarmonics dir encoding, which reads the direction only"
            )
        return n

    def _reset_network(self) -> None:
        if self.mode != TestbedMode.Nerf:
            self._reset_field()
            return
        from nerfshop_tpu_torch.models.nerf_network import build_nerf_network
        from nerfshop_tpu_torch.ops import grid as grid_lib
        from nerfshop_tpu_torch.train import nerf as nerf_train
        from nerfshop_tpu_torch.train import optim

        cfg = self._network_config
        ds = self._dataset
        aabb_scale = ds.aabb_scale if ds is not None else 1
        self._model = build_nerf_network(
            cfg, aabb_scale=aabb_scale, is_hdr=bool(ds is not None and ds.is_hdr),
            device=self.device, generator=self.generator, n_extra_dims=self._n_extra_dims(),
        )
        t = self.nerf.training
        # the trainable envmap: the scene's envmap image, or a fresh one when
        # the knob is set; the camera leaves when any camera knob is set
        extra = {}
        envmap_path = getattr(ds, "envmap_path", None) if ds is not None else None
        train_envmap = bool(envmap_path) or bool(t.train_envmap)
        if train_envmap:
            from nerfshop_tpu_torch.ops import envmap as envmap_lib

            extra["envmap"] = (
                envmap_lib.load_envmap(envmap_path, self.device) if envmap_path else envmap_lib.create_envmap(device=self.device)
            )
        self._train_cfg = nerf_train.NerfTrainConfig.for_aabb_scale(
            aabb_scale,
            loss_type=cfg.get("loss", {}).get("otype", "Huber"),
            near_distance=t.near_distance,
            random_bg=bool(t.random_bg_color),
            train_envmap=train_envmap,
            # the distortion map rides the differentiable rays, so it turns on the camera path too
            optimize_extrinsics=bool(t.optimize_extrinsics or t.optimize_distortion),
            optimize_exposure=bool(t.optimize_exposure),
            use_error_map=bool(t.use_error_map),
        )
        if (self._train_cfg.optimize_extrinsics or self._train_cfg.optimize_exposure) and ds is not None:
            extra.update(nerf_train.create_camera_params(
                ds.n_images, distortion_map=bool(t.optimize_distortion), device=self.device
            ))
        self._state = optim.TrainState(self._model, optim.build_optimizer(dict(cfg.get("optimizer", {}))), extra)
        self._error_map = None
        self.nerf.cone_angle_constant = self._train_cfg.cone_angle
        self._grid = grid_lib.OccupancyGrid.create(self._train_cfg.n_cascades, device=self.device)
        self._device_data = (
            nerf_train.DeviceDataset.from_dataset(ds, self.device) if ds is not None and ds.intrinsics else None
        )
        self._step_ready = False
        self._loops = {}
        self.stats = TrainingStats()
        self._params_version = next(self._versions)
        self._grid_version = next(self._versions)

    def _reset_field(self) -> None:
        """A fresh network (and its optimizer) for the Image, SDF or Volume
        mode, from the config, the generator and the loaded data."""
        from nerfshop_tpu_torch.train import image as image_mod
        from nerfshop_tpu_torch.train import optim
        from nerfshop_tpu_torch.train import sdf as sdf_train
        from nerfshop_tpu_torch.train import volume as volume_train

        cfg, dev, g = self._network_config, self.device, self.generator
        if self.mode == TestbedMode.Image:
            self._image_model = image_mod.ImageModel.from_config(cfg, dev, g)
            self._state = optim.TrainState(self._image_model, optim.build_optimizer(dict(cfg.get("optimizer", {}))))
            self._image_dev = None
        elif self.mode == TestbedMode.Sdf:
            if self._sdf_mesh is None and sdf_train.SdfModel.needs_mesh(cfg):
                # the field waits for load_training_data, as it does on a
                # testbed made without a config (JAX's create raises here)
                self._sdf = self._state = None
            else:
                self._sdf = sdf_train.SdfTestbed.create(cfg, self._sdf_mesh, dev, g)
                self._state = self._sdf.state
        else:
            self._volume = volume_train.VolumeTestbed.create(cfg, self._volume_grid, dev, g)
            self._state = self._volume.state
        self.stats = TrainingStats()

    @property
    def model(self):
        """The mode's network: the NeRF network, or the Image, SDF or
        Volume mode's field (None before one is built)."""
        if self.mode == TestbedMode.Nerf or self._state is None:
            return self._model
        return self._state.model

    @property
    def grid(self):
        return self._grid

    @grid.setter
    def grid(self, grid) -> None:
        """Replace the density grid (e.g. by ``GrowingSelection.vanish``'s)."""
        self._grid = grid
        self._grid_version = next(self._versions)

    @property
    def inference_params(self):
        return self._state.inference_params

    @property
    def train_config(self):
        return self._train_cfg

    @property
    def training_step(self) -> int:
        """Training steps taken since the network was (re)built or loaded."""
        return self.stats.step

    def n_params(self) -> int:
        """Trainable parameters: the network's and the training leaves'
        (``camera.*``, ``envmap``), as JAX counts its ``params`` tree."""
        return sum(p.numel() for p in self._state.params)

    def level_stats(self) -> list:
        """Per-level magnitudes of the hash table (the live parameters):
        level, resolution, size, hashed, mean and max |entry|, and the share
        of entries with |entry| > 1e-6."""
        self._require_nerf("level_stats")
        enc = self._model.pos_encoding
        table = enc.table.detach()
        out = []
        for level in range(enc.n_levels):
            seg = table[enc.level_offsets[level]: enc.level_offsets[level + 1]].abs()
            out.append({
                "level": level,
                "resolution": enc.level_res[level],
                "size": enc.level_sizes[level],
                "hashed": not enc.level_dense[level],
                "mean_abs": float(seg.mean()),
                "max_abs": float(seg.max()),
                "frac_nonzero": float((seg > 1e-6).float().mean()),
            })
        return out

    def start_profiler(self, logdir: Optional[str] = None) -> None:
        """Start a ``torch.profiler`` trace of the host and, on a CUDA
        device, the card, to be written under ``logdir`` (default
        ``nerfshop_trace`` in the temporary directory) by :meth:`stop_profiler`."""
        from torch.profiler import ProfilerActivity, profile

        if self.profiler is not None and self._profiler_dir is not None:
            raise RuntimeError("a profiler trace is already running: stop_profiler first")
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        self._profiler_dir = logdir or str(Path(tempfile.gettempdir()) / "nerfshop_trace")
        self.profiler = profile(activities=activities)
        self.profiler.start()

    def stop_profiler(self) -> str:
        """Stop the trace, write it as a Chrome trace (JSON) under the
        directory :meth:`start_profiler` took → its path. ``self.profiler``
        keeps the profile (``key_averages()``)."""
        if self.profiler is None or self._profiler_dir is None:
            raise RuntimeError("no profiler trace is running: start_profiler first")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.profiler.stop()
        out = Path(self._profiler_dir)
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{time.perf_counter_ns()}.json"
        self.profiler.export_chrome_trace(str(path))
        self._profiler_dir = None
        return str(path)

    @property
    def trained_mask(self) -> Optional[torch.Tensor]:
        """[C, R, R, R] bool cells seen by some training camera, or None."""
        return self._trained_mask

    # ---------------------------------------------------------------- training

    def train(self, n_steps: int = DEFAULT_STEPS_PER_FRAME, batch_size: int = DEFAULT_BATCH_SIZE) -> float:
        """n_steps of optimization; returns the last loss."""
        from nerfshop_tpu_torch.train import nerf as nerf_train

        if self.mode != TestbedMode.Nerf:
            return self._train_field(n_steps, batch_size)
        if self._dataset is None:
            raise RuntimeError("load_training_data first")
        t_start = time.perf_counter()
        if not self._step_ready:
            self._batch_slots = max(1 << 13, batch_size)
            self._build_step_fn(self._first_bucket())
            if self._train_cfg.use_error_map:
                self._error_map = nerf_train.create_error_map(
                    self._dataset.n_images, self._train_cfg.error_map_resolution, device=self.device
                )

        loss = float(self.stats.loss)
        remaining = n_steps
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
            for i, lv in enumerate(ys[:, 0]):
                self.loss_history.append((self.stats.step - chunk + 1 + i, float(lv)))
            # adaptive (rays, K) bucket after every chunk: most rays filling K
            # → fewer, longer rays; few → more, shorter ones
            overflow = float(ys[:, 2].mean())
            if overflow > 0.6 and self._k_bucket < 1024:
                self._set_bucket(self._k_bucket * 2)
            elif overflow < 0.08 and self._k_bucket > 32:
                self._set_bucket(self._k_bucket // 2)
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
        self._params_version = next(self._versions)
        self._grid_version = next(self._versions)
        self.stats.training_ms = (time.perf_counter() - t_start) * 1e3
        return loss

    def _train_field(self, n_steps: int, batch_size: int) -> float:
        """n_steps of the Image, SDF or Volume mode (batches of at most
        2^18, 2^16 and 2^16); the loss is read back once, at the end."""
        from nerfshop_tpu_torch.train import image as image_mod
        from nerfshop_tpu_torch.train import losses

        t_start = time.perf_counter()
        if self.mode == TestbedMode.Image:
            if self._image_target is None:
                raise RuntimeError("load_training_data first")
            if self._image_dev is None:
                self._image_dev = torch.as_tensor(np.ascontiguousarray(self._image_target, np.float32), device=self.device)
            loss_fn = losses.build_loss(dict(self._network_config.get("loss", {"otype": "L2"})))
            bs = min(batch_size, 1 << 18)
            loss = None
            for _ in range(n_steps):
                xy = torch.rand((bs, 2), generator=self.generator, device=self.device)
                loss = image_mod.train_step(self._image_model, self._state, loss_fn, self._image_dev, xy)
                self.stats.step += 1
            loss = float(loss) if loss is not None else float(self.stats.loss)
        else:
            sub = self._sdf if self.mode == TestbedMode.Sdf else self._volume
            loss = sub.train(n_steps, batch_size)
            self.stats.step = sub.step
        if not math.isfinite(loss):
            self.shall_train = False
            raise RuntimeError(f"non-finite training loss at step {self.stats.step}")
        self.stats.loss = loss
        self.loss_history.append((self.stats.step, loss))
        del self.loss_history[:-512]
        self._params_version = next(self._versions)
        self.stats.training_ms = (time.perf_counter() - t_start) * 1e3
        return loss

    def _get_loop(self, chunk: int):
        """The ``chunk``-step training loop of the current bucket
        (``train/nerf.py::make_train_loop``: captured on a CUDA device,
        eager on the CPU), made at first use. The cache goes with the
        network (``_reset_network``, so also ``set_training_data`` and
        ``load_snapshot``) and with the bucket (``_set_bucket``)."""
        from nerfshop_tpu_torch.train import nerf as nerf_train

        key = (self._train_cfg.n_rays_per_batch, self._train_cfg.k_samples, chunk)
        loop = self._loops.get(key)
        if loop is None:
            loop = nerf_train.make_train_loop(
                self._state, self._grid, self._device_data, self._train_cfg, chunk, error_map=self._error_map
            )
            self._loops[key] = loop
        return loop

    def _first_bucket(self) -> int:
        """K of the first bucket, whose chunk marches the untrained grid with
        every cell occupied. One cascade: the config's K. More: the least K
        whose spread, at most ``march.SPREAD_STRIDE_CAP`` candidates a
        sample, covers the whole candidate ladder; a shorter K reaches only
        its first half (at ``aabb_scale`` 4, 1.3 units from the camera) and
        training fits each view with fog in front of its camera."""
        from nerfshop_tpu_torch.ops import march

        cfg = self._train_cfg
        if cfg.n_cascades == 1:
            return cfg.k_samples
        return max(cfg.k_samples, int(cfg.n_candidates // march.SPREAD_STRIDE_CAP))

    def _set_bucket(self, k_samples: int) -> None:
        """Set the (rays, K) bucket, K samples a ray over the batch's slots;
        drops the training loops of the previous bucket."""
        from nerfshop_tpu_torch.train import nerf as nerf_train

        self._k_bucket = k_samples
        self._train_cfg = nerf_train.NerfTrainConfig(
            **{**self._train_cfg.__dict__, "n_rays_per_batch": max(64, self._batch_slots // k_samples),
               "k_samples": k_samples}
        )
        self._loops = {}

    def _build_step_fn(self, k_samples: int) -> None:
        """Set the first (rays, K) bucket and the untrained-cell mask."""
        from nerfshop_tpu_torch.ops import grid as grid_lib

        self._set_bucket(k_samples)
        ds = self._dataset
        usable = (
            ds is not None
            and ds.xforms is not None
            and len(ds.xforms) > 1
            and len(ds.intrinsics) == len(ds.xforms)
            and np.abs(np.asarray(ds.distortion_matrix())).max() <= 1e-8
        )
        self._trained_mask = None
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
        if self.frame_resolution is not None and self.model is not None:
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

    def get_camera_extrinsics(self, i: int, convention: str = "nerf") -> np.ndarray:
        """Training view ``i``'s pose [3, 4] with its optimized deltas (the
        ``camera.rot`` / ``camera.trans`` leaves, where training has them),
        in nerf (transforms.json) or ngp convention."""
        from nerfshop_tpu_torch.data.nerf_loader import ngp_matrix_to_nerf
        from nerfshop_tpu_torch.ops import rays as rays_lib

        if self._dataset is None:
            raise RuntimeError("no training data")
        xf = np.asarray(self._dataset.xforms[i], np.float32)
        extra = self._state.extra if self._state is not None else {}
        if "camera.rot" in extra:
            with torch.no_grad():
                xf = rays_lib.apply_pose_delta(
                    torch.as_tensor(xf, device=self.device), extra["camera.rot"][i], extra["camera.trans"][i]
                ).cpu().numpy()
        if convention == "ngp":
            return xf
        return ngp_matrix_to_nerf(xf, self._dataset.scale, self._dataset.offset)

    def set_camera_extrinsics(self, i: int, mat: np.ndarray, convention: str = "nerf") -> None:
        """Overwrite training view ``i``'s pose, given in nerf or ngp
        convention, on the host and in the device data; the device copy is
        written in place, so training loops captured before see it."""
        from nerfshop_tpu_torch.data.nerf_loader import nerf_matrix_to_ngp

        if self._dataset is None:
            raise RuntimeError("no training data")
        xf = np.asarray(mat, np.float32)
        if convention == "nerf":
            xf = nerf_matrix_to_ngp(xf, self._dataset.scale, self._dataset.offset)
        self._dataset.xforms[i] = xf[:3, :4]
        if self._device_data is not None:
            self._device_data.xforms[i].copy_(torch.as_tensor(np.ascontiguousarray(xf[:3, :4]), device=self.device))

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

        if self.mode != TestbedMode.Nerf:
            return self._render_field(width, height, linear, camera_matrix, focal)
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
                operators=tuple(self._edit_operators), envmap=self._state.inference_extra.get("envmap"),
                extra_dims=self._render_extra_dims(),
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

    def _render_extra_dims(self) -> Optional[torch.Tensor]:
        """The warped, normalized ``nerf.light_dir`` [3] as the renders' extra
        dims, for a network built with extra dims; else None."""
        if self._model is None or not self._model.n_extra_dims:
            return None
        from nerfshop_tpu_torch.ops import coords

        ld = np.asarray(self.nerf.light_dir, np.float32)
        ld = ld / max(float(np.linalg.norm(ld)), 1e-9)
        return coords.warp_direction(torch.as_tensor(ld, device=self.device))

    def _render_field(self, width: int, height: int, linear: bool, camera_matrix, focal) -> torch.Tensor:
        """The Image mode's field at every pixel centre (alpha 1), the SDF
        mode's sphere-traced frame or the Volume mode's delta-tracked frame
        (spp 4, as in JAX, whatever ``spp`` is asked) → [H, W, 4] on the
        device."""
        from nerfshop_tpu_torch.ops import tonemap as tm
        from nerfshop_tpu_torch.train import image as image_mod

        if self._state is None:
            raise RuntimeError("no network: pass a config or load training data or a snapshot first")
        if self.mode == TestbedMode.Image:
            img = image_mod.render_full_image(self._image_model, self.inference_params, (height, width))
            rgb = img if linear else torch.clamp(tm.linear_to_srgb(img), 0, 1)
            return torch.cat([rgb, torch.ones((height, width, 1), device=rgb.device)], -1)
        cam = camera_matrix if camera_matrix is not None else self.camera_matrix
        focal = focal if focal is not None else self._focal_for(width, height)
        sub = self._sdf if self.mode == TestbedMode.Sdf else self._volume
        return sub.render(width, height, cam, focal, linear)

    # --------------------------------------------------------- other modes

    @property
    def sdf(self):
        """The SDF mode's testbed (the reference's ``testbed.sdf``): the
        shading knobs ``analytic_normals``, ``fd_normals_epsilon``,
        ``shadow_sharpness``, ``render_shadows``, ``floor_enable``, ``brdf``
        and ``sun_dir`` live on it."""
        if self._sdf is None:
            raise RuntimeError("SDF mode not initialized")
        return self._sdf

    @property
    def brdf(self):
        return self.sdf.brdf

    @property
    def sun_dir(self) -> np.ndarray:
        return np.asarray(self.sdf.sun_dir, np.float32)

    @sun_dir.setter
    def sun_dir(self, d) -> None:
        self.sdf.sun_dir = tuple(np.asarray(d, np.float32).tolist())

    def calculate_iou(self, n_samples: int = 128**3, scale_existing_results_factor: float = 0.0) -> float:
        """SDF mode: IoU of the network's inside set against the mesh's on
        min(n_samples, 2^18) uniform points."""
        if self.mode != TestbedMode.Sdf:
            raise RuntimeError(f"calculate_iou needs the SDF mode, not {self.mode.value}")
        return self.sdf.calculate_iou(n_samples)

    def compute_image_mse(self, quantize: bool = False) -> float:
        """Image mode: MSE of the field rendered at the target's resolution
        against the target (linear)."""
        from nerfshop_tpu_torch.train import image as image_mod

        if self.mode != TestbedMode.Image or self._image_target is None:
            raise RuntimeError("compute_image_mse needs the Image mode with an image loaded")
        H, W = self._image_target.shape[:2]
        pred = image_mod.render_full_image(self._image_model, self.inference_params, (H, W))
        target = torch.as_tensor(np.ascontiguousarray(self._image_target, np.float32), device=self.device)
        return float(image_mod.compute_image_mse(pred, target, quantize))

    def _render_options(self, min_transmittance: Optional[float] = None, focus_z: Optional[float] = None):
        """The exact renderer's options for the testbed's state and grid."""
        from nerfshop_tpu_torch.render import renderer

        occ_frac = float(self._grid.occupancy.float().mean())
        # the sample budget follows the grid: a dense grid needs a deep
        # first-K budget to reach content, a sparse one a short one and the
        # grid's early stop. Past one cascade the deep budget and no early
        # stop: a ray from a camera inside the box crosses more occupied
        # cells before its content, and a coarse cell's largest density
        # overstates the optical depth of a ray that grazes its content
        sparse = occ_frac < 0.15 and self._train_cfg.n_cascades == 1
        k_render = 64 if sparse else 256
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
            use_grid_early_stop=sparse,
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

    # ------------------------------------------------------ the baked preview

    def bake_interactive(self, resolution: Optional[int] = None, force_full: bool = False) -> None:
        """Bake the current (edited) field for :meth:`render_interactive`.

        Incremental when only operators changed since the previous bake (a
        drag replaces one): the region the changed operators can touch, and
        every newer operator that maps points into it (the JAX package stops
        at the changed ones, ``ROADMAP.md`` Queue 3 F15), is re-evaluated and
        patched into the previous bake, shaded toward the previous bake's
        eye. A full bake, over a tight cubic box around the
        occupied content and shaded toward the current camera, when the
        network changed (training, a snapshot), the stack changed in length
        or kind, only the grid changed, the region would cover half the scene
        box, the occupied content has left the previous bake's box (the JAX
        package patches on and loses what left it, ``ROADMAP.md`` Queue 3
        F5), or ``force_full``."""
        from nerfshop_tpu_torch.ops import coords
        from nerfshop_tpu_torch.render import baked as baked_lib

        self._require_nerf("bake_interactive")
        if self._model is None:
            raise RuntimeError("no network: pass a config or load training data or a snapshot first")
        if resolution is None:
            resolution = self.interactive_bake_resolution
        aabb = coords.BoundingBox.from_aabb_scale(self._train_cfg.aabb_scale, device=self.device)
        ops = list(self._edit_operators)
        occ = self._grid.occupancy if self._grid is not None else None
        roi = None if force_full else self._incremental_bake_roi(resolution, ops, aabb)
        prev = self._baked
        if roi is not None:
            self._baked = baked_lib.update_volume_region(
                prev, self._model, self.inference_params, coords.BoundingBox(prev.aabb_lo, prev.aabb_hi), roi[0], roi[1],
                operators=tuple(ops), camera_pos=prev.camera_pos, occupancy=occ, field_aabb=aabb,
            )
        else:
            self._baked = None  # the old bake's memory goes before the new one is made
            self._baked = baked_lib.bake_volume(
                self._model, self.inference_params, self._tight_bake_box(aabb, resolution), resolution=resolution,
                operators=tuple(ops), camera_pos=np.asarray(self.camera_matrix)[:, 3], occupancy=occ, field_aabb=aabb,
            )
        self._baked_key = self._interactive_key()
        self._baked_ops = ops
        self.last_bake_incremental = roi is not None

    def _occupied_box(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """World (lo, hi) float32 of the occupied cells of the density grid
        (union over cascades; occupancy axes are [C, x, y, z]), or None when
        there is no grid or no occupied cell. One read from the device."""
        if self._grid is None:
            return None
        occ = self._grid.occupancy
        C, R = occ.shape[0], occ.shape[1]
        per_axis = torch.stack([occ.any(3).any(2), occ.any(3).any(1), occ.any(2).any(1)], 1).cpu().numpy()  # [C, 3, R]
        lo_w = np.full(3, np.inf, np.float32)
        hi_w = np.full(3, -np.inf, np.float32)
        for c in range(C):
            if not per_axis[c].any(1).all():
                continue
            idx = [np.nonzero(per_axis[c, a])[0] for a in range(3)]
            # cascade-local cell [i/R, (i+1)/R) → world (q − 0.5)·2^c + 0.5
            q_lo = np.asarray([i[0] for i in idx], np.float32) / R
            q_hi = (np.asarray([i[-1] for i in idx], np.float32) + 1.0) / R
            lo_w = np.minimum(lo_w, (q_lo - 0.5) * (1 << c) + 0.5)
            hi_w = np.maximum(hi_w, (q_hi - 0.5) * (1 << c) + 0.5)
        if not np.all(np.isfinite(lo_w)) or np.any(hi_w <= lo_w):
            return None
        return lo_w, hi_w

    def _tight_bake_box(self, aabb, resolution: int):
        """The bake's box: a cube around the occupied content with a margin of
        two bake cells, inside the training box (the frame assumes isotropic
        cells), as host float32 arrays; the training box when nothing is
        occupied."""
        from nerfshop_tpu_torch.ops import coords

        alo = aabb.min.cpu().numpy().astype(np.float32)
        ahi = aabb.max.cpu().numpy().astype(np.float32)
        content = self._occupied_box()
        if content is None:
            return coords.BoundingBox(alo, ahi)
        lo_w, hi_w = content
        ext = float((hi_w - lo_w).max())
        margin = 2.0 * ext / resolution
        ext = min(ext + 2 * margin, float((ahi - alo).min()))
        center = (lo_w + hi_w) / 2
        lo_box = np.clip(center - ext / 2, alo, ahi)
        hi_box = np.minimum(lo_box + ext, ahi)
        lo_box = hi_box - ext
        return coords.BoundingBox(lo_box.astype(np.float32), hi_box.astype(np.float32))

    def _incremental_bake_roi(self, resolution: int, ops: list, aabb):
        """World (lo, hi) to rebake incrementally, or None for a full bake."""
        from nerfshop_tpu_torch.editing import operators as op_lib

        prev = self._baked
        old_key = self._baked_key
        if prev is None or prev.canonical is None or prev.resolution != resolution or old_key is None:
            return None
        params_v, _, new_v = self._interactive_key()
        old_params_v, _, old_v = old_key
        old_ops = self._baked_ops
        if params_v != old_params_v or len(old_ops) != len(ops) or any(
            type(a) is not type(b) for a, b in zip(old_ops, ops)
        ):
            return None
        changed = [i for i, (va, vb) in enumerate(zip(old_v, new_v)) if va != vb]
        if not changed:  # the grid alone changed (a vanish, a clean-up): rebake all
            return None
        lo = np.full(3, np.inf, np.float32)
        hi = np.full(3, -np.inf, np.float32)
        # the changed operators' regions, then every newer operator (applied
        # before them) whose region meets the box: it maps points into it, so
        # they change too (the JAX package stops at the changed operators,
        # ROADMAP.md Queue 3, F15)
        for j in range(changed[0], len(ops)):
            for op in (old_ops[j], ops[j]):
                l, h = op_lib.operator_roi_aabb(op)
                if j in changed or (np.all(l <= hi) and np.all(h >= lo)):
                    lo = np.minimum(lo, l)
                    hi = np.maximum(hi, h)
        alo = aabb.min.cpu().numpy().astype(np.float32)
        ahi = aabb.max.cpu().numpy().astype(np.float32)
        if float(np.prod(np.clip(hi - lo, 0.0, None)) / max(np.prod(ahi - alo), 1e-12)) >= 0.5:
            return None  # most of the box: a full bake costs the same and reshades
        content = self._occupied_box()
        if content is not None and (
            np.any(np.maximum(content[0], alo) < prev.aabb_lo) or np.any(np.minimum(content[1], ahi) > prev.aabb_hi)
        ):
            return None  # F5: occupied cells outside the previous bake's box would be lost
        return lo, hi

    def _interactive_key(self) -> tuple:
        """(network version, grid version, each operator slot's version): what
        a bake was made of."""
        return self._params_version, self._grid_version, tuple(self._slot_versions())

    def render_interactive(
        self,
        width: int,
        height: int,
        camera_matrix: Optional[np.ndarray] = None,
        focal: Optional[np.ndarray] = None,
        base_resolution: int = 384,
        rebake: bool = False,
    ) -> np.ndarray:
        """A frame of the baked preview → [H, W, 4] float32 numpy (the field's
        colours, view-dependent shading frozen at bake time, no tonemap), from
        a ``base_resolution``² raster. Bakes first when nothing is baked, the
        network, grid or operators changed since, or ``rebake``."""
        from nerfshop_tpu_torch.render import baked as baked_lib

        if rebake or self._baked is None or self._baked_key != self._interactive_key():
            self.bake_interactive()
        cam = camera_matrix if camera_matrix is not None else self.camera_matrix
        focal = focal if focal is not None else self._focal_for(width, height)
        out = baked_lib.render_baked(
            self._baked, (width, height), np.asarray(cam, np.float32), np.asarray(focal, np.float32),
            background=tuple(np.asarray(self.background_color, np.float32)), base_resolution=base_resolution,
            with_depth=False,
        )
        return out.rgba.cpu().numpy()

    def load_camera_path(self, path: str) -> None:
        """Load a keyframed camera path (JSON, ``render/camera_path.py``)."""
        from nerfshop_tpu_torch.render.camera_path import CameraPath

        self.camera_path = CameraPath.load(path)

    def screenshot(self, path: str, width: int = 1920, height: int = 1080, spp: int = 8) -> np.ndarray:
        """Render exactly (linear for an ``.exr`` path, sRGB otherwise) and
        write the frame to ``path`` → the [H, W, 4] frame."""
        from nerfshop_tpu_torch.data import image_io

        img = self.render(width, height, spp=spp, linear=str(path).endswith(".exr"), exact=True)
        image_io.write_image(path, img, linear_input=False)
        return img

    # ---------------------------------------------------------------- editing

    def add_edit_operator(self, op, refresh_grid: bool = True) -> None:
        """Add an operator and refresh the density grid through the stack, so
        that the march reaches the deformed target region."""
        versions = self._slot_versions()
        self._edit_operators.append(op)
        versions.append(next(self._versions))
        if refresh_grid and self._grid is not None and self._state is not None:
            self.refresh_grid_for_edits()

    def replace_edit_operator(self, idx: int, op, refresh_grid: bool = True) -> None:
        """Swap an applied operator in place (a drag of an applied cage) and
        refresh the grid."""
        versions = self._slot_versions()
        self._edit_operators[idx] = op
        versions[idx] = next(self._versions)
        if refresh_grid and self._grid is not None and self._state is not None:
            self.refresh_grid_for_edits()

    def remove_edit_operator(self, idx: int) -> None:
        versions = self._slot_versions()
        self._edit_operators.pop(idx)
        versions.pop(idx)
        if self._grid is not None and self._state is not None:
            self.refresh_grid_for_edits()

    def clear_edit_operators(self) -> None:
        """Remove every operator and refresh the grid."""
        self._edit_operators = []
        self._op_versions = []
        if self._grid is not None and self._state is not None:
            self.refresh_grid_for_edits()

    def _slot_versions(self) -> list:
        """The version of each slot of the operator stack. A stack that was
        set without the edit API (its length no longer matches) gets fresh
        versions in every slot."""
        if len(self._op_versions) != len(self._edit_operators):
            self._op_versions = [next(self._versions) for _ in self._edit_operators]
        return self._op_versions

    def refresh_grid_for_edits(self) -> None:
        """Full density-grid re-estimate through the operator stack, from the
        EMA parameters; vacated cells clear on the −1 sentinel."""
        from nerfshop_tpu_torch.train import nerf as nerf_train

        nerf_train.update_grid(
            self._model, self._grid, self._train_cfg, self.generator, full_refresh=True,
            operators=tuple(self._edit_operators), params=self.inference_params,
        )
        self._grid_version = next(self._versions)

    @property
    def edit_operators(self) -> list:
        return list(self._edit_operators)

    def begin_cage_edit(self):
        """Start a cage-deformation edit → a ``GrowingSelection`` bound to
        this testbed's model, scene box and device."""
        from nerfshop_tpu_torch.editing.growing_selection import GrowingSelection
        from nerfshop_tpu_torch.ops import coords

        self._require_nerf("begin_cage_edit")
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
        self._grid_version = next(self._versions)

    def save_edits(self, path: str) -> None:
        """Write the operator list (edits JSON v1, readable by both packages)."""
        from nerfshop_tpu_torch.editing import serialization

        serialization.save_edits(path, self._edit_operators, {"mode": self.mode.value})

    def load_edits(self, path: str) -> None:
        """Replace the operator list by an edits file's and refresh the grid
        through it."""
        from nerfshop_tpu_torch.editing import serialization

        self._edit_operators = serialization.load_edits(path, self.device)
        self._op_versions = [next(self._versions) for _ in self._edit_operators]
        if self._edit_operators and self._model is not None and self._grid is not None and self._state is not None:
            self.refresh_grid_for_edits()

    # ---------------------------------------------------------------- meshing

    def _require_nerf(self, what: str) -> None:
        """Raise unless the testbed is in NeRF mode (the JAX package asserts
        it for the edits, the density grid and the meshes)."""
        if self.mode != TestbedMode.Nerf:
            raise RuntimeError(f"{what} needs the NeRF mode, not {self.mode.value}")

    def _density_fn(self):
        """World positions → σ with the EMA parameters (which need no
        gradient): differentiable in the positions only."""
        from nerfshop_tpu_torch.models.nerf_network import density_with
        from nerfshop_tpu_torch.ops import coords

        self._require_nerf("the density field")
        if self._model is None:
            raise RuntimeError("no network: pass a config or load training data or a snapshot first")
        full = coords.BoundingBox.from_aabb_scale(self._train_cfg.aabb_scale, device=self.device)
        params = {k: v.detach() for k, v in self.inference_params.items()}
        return lambda pos: density_with(self._model, params, torch.clamp(coords.warp_position(pos, full), 0.0, 1.0))

    @torch.no_grad()
    def get_density_on_grid(self, resolution: int = 256, aabb=None) -> np.ndarray:
        """σ at the cell centres of a ``resolution``³ grid over ``aabb`` (a
        ``coords.BoundingBox``; the unit cube when None) → [res, res, res]
        float32, x-major; chunks of 2^18 positions through kernels B and C."""
        from nerfshop_tpu_torch.ops import coords

        dev = self.device
        if aabb is None:
            aabb = coords.BoundingBox(torch.zeros(3, device=dev), torch.ones(3, device=dev))
        g = (torch.arange(resolution, dtype=torch.float32, device=dev) + 0.5) / resolution
        xs, ys, zs = torch.meshgrid(g, g, g, indexing="ij")
        pos = aabb.min.to(dev) + torch.stack([xs, ys, zs], -1).reshape(-1, 3) * aabb.diag.to(dev)
        density = self._density_fn()
        chunk = 1 << 18
        out = torch.cat([density(pos[i:i + chunk]) for i in range(0, pos.shape[0], chunk)])
        return out.reshape(resolution, resolution, resolution).cpu().numpy()

    def compute_marching_cubes_mesh(self, resolution: int = 256, density_threshold: float = 2.5):
        """The density field's iso-surface (marching tets over
        :meth:`get_density_on_grid`, consistently oriented) with vertex
        colours from the radiance field, looking along the inward normal."""
        from nerfshop_tpu_torch.geometry import isosurface
        from nerfshop_tpu_torch.models.nerf_network import forward_with
        from nerfshop_tpu_torch.ops import coords

        field = self.get_density_on_grid(resolution)
        mesh = isosurface.marching_tets(
            field, iso=density_threshold, origin=(0.5 / resolution,) * 3, spacing=(1.0 / resolution,) * 3,
        )
        mesh = isosurface.orient_consistently(mesh)
        if mesh.n_vertices:
            dev = self.device
            full = coords.BoundingBox.from_aabb_scale(self._train_cfg.aabb_scale, device=dev)
            normals = torch.as_tensor(mesh.vertex_normals(), dtype=torch.float32, device=dev)
            verts = torch.as_tensor(mesh.vertices, dtype=torch.float32, device=dev)
            with torch.no_grad():
                pos_w = torch.clamp(coords.warp_position(verts, full), 0.0, 1.0)
                rgb, _ = forward_with(self._model, self.inference_params, pos_w, (-normals + 1.0) * 0.5)
            mesh.colors = np.clip(rgb.cpu().numpy(), 0, 1)
        return mesh

    def compute_and_save_marching_cubes_mesh(
        self, filename: str, resolution: int = 256, density_threshold: float = 2.5,
        optimize_steps: int = 0, unwrap: bool = False,
    ) -> None:
        """Extract, optionally refine (``optimize_steps``), and write the mesh
        (.obj or .ply; ``unwrap`` adds the quad-atlas UVs and a debug texture
        to an .obj)."""
        from nerfshop_tpu_torch.geometry import mesh_io

        mesh = self.compute_marching_cubes_mesh(resolution, density_threshold)
        if optimize_steps > 0:
            mesh = self.optimise_mesh(mesh, n_steps=optimize_steps, thresh=density_threshold)
        mesh_io.save_mesh(filename, mesh, unwrap=unwrap)

    def optimise_mesh(self, mesh, n_steps: int = 100, thresh: float = 2.5, density_amount: float = 0.001,
                      smooth_amount: float = 4.0, inflate_amount: float = 0.0):
        """Refine the mesh's vertices against the density iso-surface on the
        testbed's device (``geometry/mesh_opt.py``)."""
        from nerfshop_tpu_torch.geometry import mesh_opt

        return mesh_opt.optimize_mesh(
            self._density_fn(), mesh, n_steps=n_steps, thresh=thresh, density_amount=density_amount,
            smooth_amount=smooth_amount, inflate_amount=inflate_amount, device=self.device,
        )

    def compute_and_save_png_slices(self, filename: str, resolution: int = 128, density_threshold: float = 2.5) -> None:
        """Write the density grid as a sheet of z-slice tiles, σ / (2 ·
        threshold) clipped to [0, 1]."""
        from nerfshop_tpu_torch.data import image_io

        field = self.get_density_on_grid(resolution)
        occ = np.clip(field / max(density_threshold * 2.0, 1e-6), 0, 1)
        n = int(np.ceil(np.sqrt(resolution)))
        sheet = np.zeros((n * resolution, n * resolution), np.float32)
        for z in range(resolution):
            r, c = divmod(z, n)
            sheet[r * resolution:(r + 1) * resolution, c * resolution:(c + 1) * resolution] = occ[:, :, z]
        image_io.write_image(filename, np.repeat(sheet[..., None], 3, axis=-1))

    # --------------------------------------------------------------- snapshots

    def save_snapshot(self, path: str, interop: str = "convert") -> None:
        """Native snapshot (see :mod:`nerfshop_tpu_torch.io.snapshot`): params
        with the training state's ``camera.*`` and ``envmap`` leaves, their
        EMA copy, density grid, dataset metadata and step. A path ending in
        ``.ingp`` or ``.msgpack`` writes the NeRF's inference parameters,
        grid, step and loss in that format (:mod:`nerfshop_tpu_torch.io.ingp`),
        a brick table re-baked into the plain layout unless ``interop`` is
        ``"warn"`` (written as it is) or ``"strict"`` (refused)."""
        from nerfshop_tpu_torch.io import snapshot as snap_lib

        if self._state is None:
            raise RuntimeError("no network to save")
        if str(path).endswith((".ingp", ".msgpack")):
            from nerfshop_tpu_torch.io import ingp as ingp_lib

            self._require_nerf(".ingp/.msgpack snapshots")
            ingp_lib.export_ingp(
                path, self._network_config, self._model, self._state.inference_params,
                density_grid=self._grid.density if self._grid is not None else None,
                aabb_scale=self._dataset.aabb_scale if self._dataset is not None else 1,
                training_step=self.stats.step, loss=self.stats.loss, interop=interop,
            )
            return
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
        state = self._state
        snap_lib.save_snapshot(
            path,
            params=dict(self.model.named_parameters(), **state.extra),
            network_config=json.loads(json.dumps(dict(self._network_config))),
            mode=self.mode.value,
            ema_params=None if state.ema is None else dict(state.ema, **state.extra_ema),
            density_grid=self._grid.density if self.mode == TestbedMode.Nerf else None,
            metadata=metadata,
            step=self.stats.step,
        )

    def load_snapshot(self, path: str) -> None:
        """Load a native snapshot: network config, params, the EMA copy (the
        params where the snapshot has none), the density grid with its
        bitfield recomputed, and the step (an ``.ingp`` / ``.msgpack`` path:
        :meth:`_load_ingp`). A snapshot without a dataset gets
        a metadata-only dataset so that it renders. The training state's
        ``camera.*`` and ``envmap`` leaves, which the ``nerf.training`` knobs
        and the scene decide as for training, are restored with the network
        (live and EMA, in place); as in the JAX package, a leaf the snapshot
        lacks raises ``KeyError`` and a snapshot leaf the state lacks is
        ignored."""
        from nerfshop_tpu_torch.io import snapshot as snap_lib
        from nerfshop_tpu_torch.ops import grid as grid_lib

        if str(path).endswith((".ingp", ".msgpack")):
            self._load_ingp(path)
            return
        snap = snap_lib.load_snapshot(path)
        mode = TestbedMode(snap.get("mode", "nerf"))
        check_kernel_range(snap["network_config"], self.device, mode)  # before the testbed changes
        self.mode = mode
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
        # in place: the mode's own testbed (SDF, Volume) and a training loop
        # captured later train and render these very tensors; every leaf is
        # read before any is written
        state = self._state
        live = dict(self.model.named_parameters(), **state.extra)
        params = snap_lib.restore_params(live, snap, "params")
        ema_live = None if state.ema is None else dict(state.ema, **state.extra_ema)
        ema = params
        if ema_live is not None and "ema_params" in snap:
            ema = snap_lib.restore_params(ema_live, snap, "ema_params")
        with torch.no_grad():
            for name, p in live.items():
                p.copy_(params[name])
            for name, e in (ema_live or {}).items():
                e.copy_(ema[name])
        dg = snap.get("density_grid")
        if dg is not None and self._grid is not None and dg.shape[0] == self._grid.n_cascades:
            self._grid.density = torch.tensor(dg, device=self.device)
            grid_lib.update_bitfield(self._grid)
        step = int(snap.get("step", 0))
        self._state.step = self.stats.step = step
        for sub in (self._sdf, self._volume):
            if sub is not None:
                sub.step = step
        self._params_version = next(self._versions)
        self._grid_version = next(self._versions)

    def _load_ingp(self, path: str) -> None:
        """An ``.ingp`` / ``.msgpack`` snapshot, as the JAX ``load_snapshot``
        reads one: the config without its ``snapshot`` (a grid encoding's
        layout ``plain`` unless the file names one), a dataset of metadata
        alone when none is loaded, a fresh network with the file's
        parameters (live and EMA), its density grid's cascades and their
        bitfield, and its step."""
        from nerfshop_tpu_torch.data.nerf_loader import NerfDataset
        from nerfshop_tpu_torch.io import ingp as ingp_lib
        from nerfshop_tpu_torch.models.encodings import GRID_OTYPES
        from nerfshop_tpu_torch.ops import grid as grid_lib

        self._require_nerf(".ingp/.msgpack snapshots")
        cfg = ingp_lib.load_ingp(path)
        snap = cfg.get("snapshot", {})
        network_config = ConfigDict({k: v for k, v in cfg.items() if k != "snapshot"})
        if network_config.get("encoding", {}).get("otype", "HashGrid") in GRID_OTYPES:
            network_config["encoding"].setdefault("layout", "plain")
        check_kernel_range(network_config, self.device, self.mode)  # before the testbed changes
        self._network_config = network_config
        if self._dataset is None and "aabb_scale" in snap.get("nerf", {}):
            self._dataset = NerfDataset(
                images=np.zeros((1, 2, 2, 4), np.float32), xforms=np.eye(4, dtype=np.float32)[None, :3],
                intrinsics=[], paths=[], aabb_scale=int(snap["nerf"]["aabb_scale"]),
            )
        self._reset_network()
        live = dict(self._model.named_parameters())
        out = ingp_lib.import_ingp(path, live)
        with torch.no_grad():
            for name, p in live.items():
                p.copy_(out["params"][name])
            for name, e in (self._state.ema or {}).items():
                e.copy_(out["params"][name])
        dg = out["density_grid"]
        if dg is not None and self._grid is not None and dg.shape[0] <= self._grid.n_cascades:
            self._grid.density[: dg.shape[0]] = torch.as_tensor(dg, device=self.device)
            grid_lib.update_bitfield(self._grid)
        self._state.step = self.stats.step = out["training_step"]
        self._params_version = next(self._versions)
        self._grid_version = next(self._versions)
