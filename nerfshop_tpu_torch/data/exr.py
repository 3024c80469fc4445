"""Minimal OpenEXR 2.0 scanline reader/writer (pure Python + numpy).

Replaces the reference's tinyexr wrapper (src/tinyexr_wrapper.cu) for the
subset the framework needs: single-part scanline images, HALF/FLOAT/UINT
channels, NONE/ZIPS/ZIP compression. Enough to read data/image/albert.exr
and to round-trip our own HDR outputs.

Format reference: the public OpenEXR file layout specification.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

_MAGIC = 0x01312F76
_PIXEL_DTYPES = {0: np.dtype("<u4"), 1: np.dtype("<f2"), 2: np.dtype("<f4")}
_PIXEL_CODES = {np.dtype("<u4"): 0, np.dtype("<f2"): 1, np.dtype("<f4"): 2}
_COMPRESSION_LINES = {0: 1, 1: 1, 2: 1, 3: 16}  # NONE, RLE, ZIPS, ZIP


def _read_cstr(buf: bytes, off: int) -> Tuple[str, int]:
    end = buf.index(b"\x00", off)
    return buf[off:end].decode("latin1"), end + 1


def _reconstruct_zip(data: bytes) -> bytes:
    """EXR zip post-process: delta-decode then de-interleave halves.

    Delta decode: out[0] = raw[0]; out[i] = out[i-1] + raw[i] - 128 (mod 256),
    vectorized as a cumulative sum.
    """
    raw = np.frombuffer(data, np.uint8).astype(np.int64)
    out = (np.cumsum(raw - 128) + 128) % 256
    out = out.astype(np.uint8)
    # de-interleave: first ceil(n/2) bytes are even positions
    n = len(out)
    half = (n + 1) // 2
    result = np.empty(n, np.uint8)
    result[0::2] = out[:half]
    result[1::2] = out[half:]
    return result.tobytes()


def _deconstruct_zip(data: bytes) -> bytes:
    """Inverse of _reconstruct_zip (for writing)."""
    arr = np.frombuffer(data, np.uint8)
    n = len(arr)
    half = (n + 1) // 2
    inter = np.concatenate([arr[0::2], arr[1::2]])
    delta = np.empty(n, np.int64)
    delta[0] = inter[0]
    delta[1:] = inter[1:].astype(np.int64) - inter[:-1].astype(np.int64) + 128
    return (delta % 256).astype(np.uint8).tobytes()


def read_exr(path: str) -> Dict[str, np.ndarray]:
    """Returns {channel_name: [H, W] float32 array}."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<iI", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise NotImplementedError("tiled EXR not supported")
    off = 8

    channels: List[Tuple[str, np.dtype]] = []
    compression = 0
    data_window = (0, 0, 0, 0)
    line_order = 0
    while True:
        name, off = _read_cstr(buf, off)
        if not name:
            break
        attr_type, off = _read_cstr(buf, off)
        (size,) = struct.unpack_from("<i", buf, off)
        off += 4
        val = buf[off : off + size]
        off += size
        if name == "channels":
            coff = 0
            while val[coff] != 0:
                cname, coff = _read_cstr(val, coff)
                ptype, _plinear, _x, _y = struct.unpack_from("<iiii", val, coff + 4 - 4)
                coff += 16
                channels.append((cname, _PIXEL_DTYPES[ptype]))
        elif name == "compression":
            compression = val[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<iiii", val)
        elif name == "lineOrder":
            line_order = val[0]

    if compression not in _COMPRESSION_LINES:
        raise NotImplementedError(f"EXR compression {compression} not supported (NONE/RLE/ZIPS/ZIP only)")
    if compression == 1:
        raise NotImplementedError("RLE compression not supported")

    xmin, ymin, xmax, ymax = data_window
    W, H = xmax - xmin + 1, ymax - ymin + 1
    lines_per_block = _COMPRESSION_LINES[compression]
    n_blocks = -(-H // lines_per_block)

    offsets = struct.unpack_from(f"<{n_blocks}q", buf, off)
    bytes_per_line = sum(W * dt.itemsize for _, dt in channels)

    out = {cname: np.empty((H, W), np.float32) for cname, _ in channels}
    for bi, boff in enumerate(offsets):
        y, size = struct.unpack_from("<ii", buf, boff)
        data = buf[boff + 8 : boff + 8 + size]
        y0 = y - ymin
        n_lines = min(lines_per_block, H - y0)
        expected = bytes_per_line * n_lines
        if compression in (2, 3) and size < expected:
            data = _reconstruct_zip(zlib.decompress(data))
        pos = 0
        for li in range(n_lines):
            for cname, dt in channels:
                nbytes = W * dt.itemsize
                line = np.frombuffer(data, dt, count=W, offset=pos)
                out[cname][y0 + li] = line.astype(np.float32)
                pos += nbytes
    if line_order == 1:  # DECREASING_Y
        out = {k: v[::-1] for k, v in out.items()}
    return out


def read_exr_rgba(path: str) -> np.ndarray:
    """[H, W, C] float32, channels in R,G,B(,A) order."""
    chans = read_exr(path)
    order = [c for c in ("R", "G", "B", "A") if c in chans]
    if not order:  # luminance or arbitrary: stack whatever is there
        order = sorted(chans)
    return np.stack([chans[c] for c in order], axis=-1)


def write_exr(path: str, channels: Dict[str, np.ndarray], pixel_type: str = "half") -> None:
    """Write a ZIP-compressed scanline EXR."""
    names = sorted(channels)
    H, W = channels[names[0]].shape
    dt = np.dtype("<f2") if pixel_type == "half" else np.dtype("<f4")

    chlist = b""
    for n in names:
        chlist += n.encode("latin1") + b"\x00" + struct.pack("<iiii", _PIXEL_CODES[dt], 0, 1, 1)
    chlist += b"\x00"

    def attr(name, typ, val):
        return name.encode() + b"\x00" + typ.encode() + b"\x00" + struct.pack("<i", len(val)) + val

    header = struct.pack("<iI", _MAGIC, 2)
    header += attr("channels", "chlist", chlist)
    header += attr("compression", "compression", b"\x03")  # ZIP
    header += attr("dataWindow", "box2i", struct.pack("<iiii", 0, 0, W - 1, H - 1))
    header += attr("displayWindow", "box2i", struct.pack("<iiii", 0, 0, W - 1, H - 1))
    header += attr("lineOrder", "lineOrder", b"\x00")
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"

    n_blocks = -(-H // 16)
    blocks = []
    for bi in range(n_blocks):
        y0, y1 = bi * 16, min(bi * 16 + 16, H)
        raw = b"".join(
            channels[n][y].astype(dt).tobytes() for y in range(y0, y1) for n in names
        )
        comp = zlib.compress(_deconstruct_zip(raw))
        if len(comp) >= len(raw):
            comp = raw
        blocks.append(struct.pack("<ii", y0, len(comp)) + comp)

    table_start = len(header) + 8 * n_blocks
    offsets, pos = [], table_start
    for b in blocks:
        offsets.append(pos)
        pos += len(b)
    with open(path, "wb") as f:
        f.write(header)
        f.write(struct.pack(f"<{n_blocks}q", *offsets))
        for b in blocks:
            f.write(b)
