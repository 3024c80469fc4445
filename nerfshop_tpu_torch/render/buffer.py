"""Progressive render buffer: spp accumulation, exposure, tonemap, sRGB.

Counterpart of ``RenderBuffer`` in ``nerfshop_tpu/render/buffer.py``. The
ground-truth overlay is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from nerfshop_tpu_torch.common import TonemapCurve
from nerfshop_tpu_torch.device import default_device
from nerfshop_tpu_torch.ops import tonemap as tm


@dataclass
class RenderBuffer:
    resolution: Tuple[int, int]  # (W, H)
    #: None takes ``cuda:0`` and raises without CUDA, as ``Testbed`` does;
    #: CPU code passes ``device="cpu"``
    device: Optional[torch.device] = None
    accumulate_rgba: Optional[torch.Tensor] = None  # [H, W, 4] linear accum
    depth: Optional[torch.Tensor] = None  # [H, W]
    spp: int = 0

    def __post_init__(self) -> None:
        self.device = torch.device(self.device) if self.device is not None else default_device()

    def clear(self) -> None:
        W, H = self.resolution
        self.accumulate_rgba = torch.zeros((H, W, 4), dtype=torch.float32, device=self.device)
        self.depth = torch.zeros((H, W), dtype=torch.float32, device=self.device)
        self.spp = 0

    def resize(self, resolution: Tuple[int, int]) -> None:
        if resolution != self.resolution:
            self.resolution = resolution
            self.clear()

    def accumulate(self, frame_rgba: torch.Tensor, depth: Optional[torch.Tensor] = None) -> None:
        """Running mean over the first 256 samples per pixel, EMA beyond."""
        if self.accumulate_rgba is None:
            self.clear()
        n = self.spp
        w_new = 1.0 / (n + 1) if n < 256 else 1.0 / 256
        self.accumulate_rgba = self.accumulate_rgba * (1.0 - w_new) + frame_rgba * w_new
        if depth is not None:
            self.depth = self.depth * (1.0 - w_new) + depth * w_new
        self.spp = n + 1

    def tonemapped(
        self,
        exposure: float = 0.0,
        curve: TonemapCurve = TonemapCurve.Identity,
        output_srgb: bool = True,
        input_is_srgb_space: bool = False,
    ) -> torch.Tensor:
        """→ display-ready [H, W, 4]. ``input_is_srgb_space``: LDR-trained
        NeRFs already predict sRGB-space radiance; skip the transfer curve."""
        img = self.accumulate_rgba
        rgb = img[..., :3] * (2.0**exposure)
        if not input_is_srgb_space:
            rgb = tm.apply_tonemap(rgb, curve)
            if output_srgb:
                rgb = tm.linear_to_srgb(rgb)
        rgb = torch.clamp(rgb, 0.0, 1.0)
        return torch.cat([rgb, torch.clamp(img[..., 3:], 0.0, 1.0)], dim=-1)
