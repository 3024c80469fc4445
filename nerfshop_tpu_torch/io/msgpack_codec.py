"""The subset of MessagePack that a snapshot holds, in pure Python.

``packb`` writes what ``msgpack.packb(obj, use_bin_type=True)`` writes for
nil, bool, int (every width, signed and unsigned), float (as float64), str,
bytes (as bin), list/tuple (as array) and dict (as map, in insertion
order): the smallest format for each value, byte for byte. ``unpackb``
reads those formats and float32 back, as ``msgpack.unpackb(raw=False,
strict_map_key=False)`` does: str as ``str``, bin as ``bytes``, arrays as
lists. The package itself stays out of the port's imports, and the card
machine has none.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        n = len(data)
        if n < 32:
            out.append(bytes([0xA0 | n]))
        elif n < 1 << 8:
            out.append(struct.pack(">BB", 0xD9, n))
        elif n < 1 << 16:
            out.append(struct.pack(">BH", 0xDA, n))
        else:
            out.append(struct.pack(">BI", 0xDB, n))
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        n = len(data)
        if n < 1 << 8:
            out.append(struct.pack(">BB", 0xC4, n))
        elif n < 1 << 16:
            out.append(struct.pack(">BH", 0xC5, n))
        else:
            out.append(struct.pack(">BI", 0xC6, n))
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        _header(len(obj), 0x90, 0xDC, out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _header(len(obj), 0x80, 0xDE, out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__!r} object")


def _header(n: int, fix: int, wide: int, out: List[bytes]) -> None:
    """Array (fix 0x90, wide 0xdc) or map (0x80, 0xde) header of n entries."""
    if n < 16:
        out.append(bytes([fix | n]))
    elif n < 1 << 16:
        out.append(struct.pack(">BH", wide, n))
    else:
        out.append(struct.pack(">BI", wide + 1, n))


def _pack_int(v: int, out: List[bytes]) -> None:
    if 0 <= v < 128:
        out.append(bytes([v]))
    elif -32 <= v < 0:
        out.append(struct.pack(">b", v))
    elif v >= 0:
        for code, fmt, bound in ((0xCC, ">BB", 1 << 8), (0xCD, ">BH", 1 << 16), (0xCE, ">BI", 1 << 32), (0xCF, ">BQ", 1 << 64)):
            if v < bound:
                out.append(struct.pack(fmt, code, v))
                return
        raise OverflowError("int too big to pack")
    else:
        for code, fmt, bound in ((0xD0, ">Bb", 1 << 7), (0xD1, ">Bh", 1 << 15), (0xD2, ">Bi", 1 << 31), (0xD3, ">Bq", 1 << 63)):
            if v >= -bound:
                out.append(struct.pack(fmt, code, v))
                return
        raise OverflowError("int too small to pack")


def packb(obj: Any) -> bytes:
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


# format byte → (struct format of the value, its size) for fixed-size scalars
_SCALARS = {
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
# format byte → (kind, size of its length field)
_SIZED = {
    0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
    0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
    0xDC: ("array", 2), 0xDD: ("array", 4), 0xDE: ("map", 2), 0xDF: ("map", 4),
}
_LEN = {1: ">B", 2: ">H", 4: ">I"}


def _unpack(buf: memoryview, pos: int) -> Tuple[Any, int]:
    b = buf[pos]
    pos += 1
    if b < 0x80:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8F:
        return _unpack_map(buf, pos, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _unpack_array(buf, pos, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        n = b & 0x1F
        return str(buf[pos : pos + n], "utf-8"), pos + n
    if b == 0xC0:
        return None, pos
    if b == 0xC2:
        return False, pos
    if b == 0xC3:
        return True, pos
    if b in _SCALARS:
        fmt, size = _SCALARS[b]
        return struct.unpack_from(fmt, buf, pos)[0], pos + size
    if b in _SIZED:
        kind, size = _SIZED[b]
        n = struct.unpack_from(_LEN[size], buf, pos)[0]
        pos += size
        if kind == "bin":
            return bytes(buf[pos : pos + n]), pos + n
        if kind == "str":
            return str(buf[pos : pos + n], "utf-8"), pos + n
        if kind == "array":
            return _unpack_array(buf, pos, n)
        return _unpack_map(buf, pos, n)
    raise ValueError(f"unsupported MessagePack format byte 0x{b:02x} at offset {pos - 1}")


def _unpack_array(buf: memoryview, pos: int, n: int) -> Tuple[list, int]:
    out = []
    for _ in range(n):
        v, pos = _unpack(buf, pos)
        out.append(v)
    return out, pos


def _unpack_map(buf: memoryview, pos: int, n: int) -> Tuple[dict, int]:
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        v, pos = _unpack(buf, pos)
        out[k] = v
    return out, pos


def unpackb(data: bytes) -> Any:
    buf = memoryview(data)
    obj, pos = _unpack(buf, 0)
    if pos != len(buf):
        raise ValueError(f"{len(buf) - pos} extra bytes after the MessagePack object")
    return obj
