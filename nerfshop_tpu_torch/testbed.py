"""Testbed — the user-facing facade, NeRF training part.

Counterpart of the NeRF half of ``nerfshop_tpu/testbed.py``: construct with
a config, load a scene (``load_training_data``, or ``set_training_data``
with an in-memory ``NerfDataset``), and ``train``: a grid refresh every 16
steps (full refresh during the first 256), the degenerate-training guards,
and the adaptive (rays, K) bucket. Rendering, snapshots, editing and the
other testbed modes are not ported yet.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from nerfshop_tpu.common import DEFAULT_BATCH_SIZE, DEFAULT_STEPS_PER_FRAME, TestbedMode
from nerfshop_tpu.config import ConfigDict, default_nerf_config, load_network_config


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
        self.device = torch.device(device or ("cuda" if torch.cuda.is_available() else "cpu"))
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(time.time()) % (1 << 31) if seed is None else seed)
        self.shall_train = False
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
        if config is not None:
            if isinstance(config, (str, Path)):
                self._network_config = load_network_config(config)
            else:
                self._network_config = ConfigDict(config)
            self._reset_network()
        if scene is not None:
            self.load_training_data(scene)

    # ------------------------------------------------------------------- data

    def load_training_data(self, path: str, downscale: int = 1) -> None:
        from nerfshop_tpu.data import nerf_loader

        path = Path(path)
        json_path = path if path.suffix == ".json" else path / "transforms.json"
        self.set_training_data(nerf_loader.load_nerf(json_path, downscale=downscale))

    def set_training_data(self, ds) -> None:
        """Use an in-memory ``nerfshop_tpu.data.nerf_loader.NerfDataset``."""
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
            auxs = [
                nerf_train.train_step(self._state, self._grid, self._device_data, self._train_cfg, self.generator)
                for _ in range(chunk)
            ]
            # one host pull per chunk: losses, sample counts, overflow
            ys = torch.stack(
                [torch.stack([a["loss"], a["measured_samples"].float(), a["sample_overflow_frac"]]) for a in auxs]
            ).cpu().numpy()
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

    def _build_step_fn(self, n_rays: int, k_samples: Optional[int] = None) -> None:
        """Set the (rays, K) bucket and the untrained-cell mask."""
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
        if usable:
            xf = np.asarray(ds.xforms, np.float32)
            res_hw = np.asarray([[im.shape[1], im.shape[0]] for im in ds.images], np.float32)

            def t(a):
                return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=self.device)

            self._trained_mask = grid_lib.mark_untrained_cells(
                self._train_cfg.n_cascades, t(xf[:, :, 3]), t(xf[:, :, 2]), t(ds.focal_matrix()), t(res_hw)
            )
        self._step_ready = True
