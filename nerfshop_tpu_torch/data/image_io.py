"""Image I/O + color-space helpers.

Covers the reference's stb/tinyexr surface (src/tinyexr_wrapper.cu,
common_device.cuh srgb helpers, scripts/common.py:read_image/write_image):
LDR formats via PIL, HDR via the bundled minimal EXR codec.

Convention (matches scripts/common.py): ``read_image`` returns float32
linear-light RGB(A) in [0,1]-ish; LDR files are sRGB-decoded, and alpha is
kept straight (un-premultiplied) like the reference loader's output.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from nerfshop_tpu_torch.data import exr


def srgb_to_linear(img: np.ndarray) -> np.ndarray:
    limit = 0.04045
    return np.where(img > limit, ((img + 0.055) / 1.055) ** 2.4, img / 12.92)


def linear_to_srgb(img: np.ndarray) -> np.ndarray:
    limit = 0.0031308
    img = np.clip(img, 0.0, None)
    return np.where(img > limit, 1.055 * img ** (1.0 / 2.4) - 0.055, 12.92 * img)


def read_image(path: str | Path, linear: bool = True) -> np.ndarray:
    """[H, W, C] float32. EXR is already linear; LDR is sRGB-decoded when
    ``linear`` (alpha channel is never gamma-transformed)."""
    path = Path(path)
    if path.suffix.lower() == ".exr":
        return exr.read_exr_rgba(str(path)).astype(np.float32)
    if path.suffix.lower() == ".bin":
        # reference's raw binary format (nerf_loader.cu): H,W int32 then fp16
        with open(path, "rb") as f:
            h, w = np.frombuffer(f.read(8), np.int32)
            data = np.frombuffer(f.read(), np.float16).reshape(h, w, 4)
        return data.astype(np.float32)
    from PIL import Image

    img = np.asarray(Image.open(path)).astype(np.float32) / 255.0
    if img.ndim == 2:
        img = img[..., None]
    if linear:
        if img.shape[-1] >= 3:
            img = np.concatenate([srgb_to_linear(img[..., :3]), img[..., 3:]], axis=-1)
        else:
            img = srgb_to_linear(img)
    return img


def write_image(path: str | Path, img: np.ndarray, linear_input: bool = True) -> None:
    """EXR: stored as-is (linear). LDR: sRGB-encoded + quantized."""
    path = Path(path)
    img = np.asarray(img, np.float32)
    if path.suffix.lower() == ".exr":
        names = "RGBA"[: img.shape[-1]] if img.ndim == 3 else "Y"
        chans = {n: img[..., i] for i, n in enumerate(names)} if img.ndim == 3 else {"Y": img}
        exr.write_exr(str(path), chans)
        return
    from PIL import Image

    if linear_input and img.shape[-1] >= 3:
        img = np.concatenate([linear_to_srgb(img[..., :3]), img[..., 3:]], axis=-1)
    data = (np.clip(img, 0, 1) * 255.0 + 0.5).astype(np.uint8)
    if data.shape[-1] == 1:
        data = data[..., 0]
    Image.fromarray(data).save(path)
