"""Image I/O + color-space helpers.

Covers the reference's stb/tinyexr surface (src/tinyexr_wrapper.cu,
common_device.cuh srgb helpers, scripts/common.py:read_image/write_image):
PNG through the package's own codec (:func:`read_png`, :func:`write_png`:
``zlib`` and the native row unfiltering of ``csrc/image_ops.cpp``; no PIL),
HDR via the bundled minimal EXR codec. JPEG and interlaced PNGs raise
``NotImplementedError``.

Convention (matches scripts/common.py): ``read_image`` returns float32
linear-light RGB(A) in [0,1]-ish; LDR files are sRGB-decoded, and alpha is
kept straight (un-premultiplied) like the reference loader's output.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from nerfshop_tpu_torch.data import exr

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: PNG colour type → channels: gray, RGB, gray + alpha, RGBA (palette not taken)
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_CHANNELS_PNG = {c: t for t, c in _PNG_CHANNELS.items()}


def read_png(path: str | Path) -> np.ndarray:
    """Decode a non-interlaced 8- or 16-bit gray, gray + alpha, RGB or RGBA
    PNG → the array PIL's ``np.asarray(Image.open(path))`` gives: uint8
    [H, W, C] at 8 bits (2-D for gray); at 16 bits gray the 16-bit values
    (uint16, 2-D), and the other colour types their high bytes (uint8), gray
    + alpha widened to RGBA, as PIL decodes them. Other PNGs raise
    ``NotImplementedError``."""
    from nerfshop_tpu_torch import native

    data = Path(path).read_bytes()
    if data[:3] == b"\xff\xd8\xff":
        raise NotImplementedError(f"{path}: JPEG decoding is not supported (PNG, EXR and .bin only)")
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    width, height, depth, ctype, _, _, interlace = header
    if interlace:
        raise NotImplementedError(f"{path}: interlaced (Adam7) PNG is not supported")
    if ctype not in _PNG_CHANNELS or depth not in (8, 16):
        raise NotImplementedError(f"{path}: PNG colour type {ctype} at {depth} bits is not supported "
                                  "(8- or 16-bit gray, gray+alpha, RGB, RGBA only)")
    channels = _PNG_CHANNELS[ctype]
    bpp = channels * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = native.png_unfilter(raw, height, width * bpp, bpp)
    if depth == 8:
        img = rows.reshape(height, width, channels)
    else:
        img = rows.view(">u2").reshape(height, width, channels)
        if channels == 1:
            img = img.astype(np.uint16)
        else:
            img = (img >> 8).astype(np.uint8)
            if channels == 2:
                img = img[..., [0, 0, 0, 1]]
    return img[..., 0] if channels == 1 else img


def write_png(path: str | Path, data: np.ndarray) -> None:
    """Write uint8 [H, W] or [H, W, C] (C = 1-4) as an 8-bit PNG, filter
    None on every row, deflated with ``zlib``."""
    data = np.asarray(data)
    if data.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {data.dtype}")
    if data.ndim == 2:
        data = data[..., None]
    height, width, channels = data.shape
    if channels not in _CHANNELS_PNG:
        raise ValueError(f"write_png takes 1-4 channels, got {channels}")
    rows = np.zeros((height, 1 + width * channels), np.uint8)
    rows[:, 1:] = data.reshape(height, width * channels)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    header = struct.pack(">IIBBBBB", width, height, 8, _CHANNELS_PNG[channels], 0, 0, 0)
    Path(path).write_bytes(
        PNG_SIGNATURE + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b"")
    )


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
    if path.suffix.lower() in (".jpg", ".jpeg"):
        raise NotImplementedError(f"{path}: JPEG decoding is not supported (PNG, EXR and .bin only)")
    img = read_png(path).astype(np.float32) / 255.0
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
    if path.suffix.lower() != ".png":
        raise NotImplementedError(f"{path}: {path.suffix or 'no suffix'} images are not written (PNG and EXR only)")
    if linear_input and img.shape[-1] >= 3:
        img = np.concatenate([linear_to_srgb(img[..., :3]), img[..., 3:]], axis=-1)
    data = (np.clip(img, 0, 1) * 255.0 + 0.5).astype(np.uint8)
    if data.shape[-1] == 1:
        data = data[..., 0]
    write_png(path, data)
