"""Low-discrepancy subpixel jitter for spp accumulation.

A copy of ``nerfshop_tpu/ops/sampling.py`` (numpy only, so the bits are the
same): a Halton(2,3) point per sample index, decorrelated per pixel by a
Cranley-Patterson rotation from an integer hash of the pixel id.
"""

from __future__ import annotations

import numpy as np


def halton(index: int, base: int) -> float:
    """Radical inverse of ``index+1`` in ``base`` (scalar, host-side)."""
    f, r = 1.0, 0.0
    i = index + 1
    while i > 0:
        f /= base
        r += f * (i % base)
        i //= base
    return r


def _pixel_hash01(n: int, seed: int = 0) -> np.ndarray:
    """Per-pixel scramble offsets in [0,1)² via a Wang-style integer hash."""
    x = np.arange(n, dtype=np.uint32) + np.uint32(seed * 2654435761 % (1 << 32))
    x ^= x >> np.uint32(16)
    x = (x * np.uint32(0x7FEB352D)) & np.uint32(0xFFFFFFFF)
    x ^= x >> np.uint32(15)
    x = (x * np.uint32(0x846CA68B)) & np.uint32(0xFFFFFFFF)
    x ^= x >> np.uint32(16)
    u = x.astype(np.float64) / 2**32
    y = (x * np.uint32(2654435761)) & np.uint32(0xFFFFFFFF)
    v = y.astype(np.float64) / 2**32
    return np.stack([u, v], axis=-1).astype(np.float32)


def spp_jitter(sample_index: int, n_pixels: int, seed: int = 0) -> np.ndarray:
    """→ [n_pixels, 2] subpixel offsets in [0,1) for accumulation pass
    ``sample_index`` (Halton(2,3) + per-pixel Cranley-Patterson rotation)."""
    h = np.asarray([halton(sample_index, 2), halton(sample_index, 3)], np.float32)
    return (h[None, :] + _pixel_hash01(n_pixels, seed)) % 1.0
