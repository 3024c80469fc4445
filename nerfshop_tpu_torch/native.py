"""Build and bind the port's native host library (``csrc/host_ops.cpp``).

The source is compiled with ``g++`` on first use into
``build/nerfshop_tpu_torch/`` at the root of the checkout, keyed by a hash
of the source and flags: each build writes a file of its own in a
temporary directory there and renames it into place, so processes that
build at once (test workers) never load a half-written library. Then it is
loaded with ``ctypes``. A build that fails raises; nothing falls back to
the numpy paths, which stay only as the plain versions the tests hold the
library to (``TetMesh._voxelize_plain``, ``RegionGrowing.grow_plain``).

Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "host_ops.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "nerfshop_tpu_torch"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib = None


def library_path(source: Path = SOURCE) -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(source.read_bytes())
    return BUILD_DIR / f"libhost_ops_{h.hexdigest()[:16]}.so"


def build(source: Path = SOURCE, compiler: str = "g++") -> Path:
    """Compile ``source`` unless a library of the same hash exists; raises
    ``RuntimeError`` when the compiler fails or is missing."""
    so = library_path(source)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = os.path.join(tmp, so.name)
        try:
            proc = subprocess.run([compiler, *GXX_FLAGS, str(source), "-o", out], capture_output=True, text=True,
                                  timeout=300)
        except OSError as e:
            raise RuntimeError(f"the native host library cannot be built: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {source.name} ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(out, so)
    return so


def get_lib() -> ctypes.CDLL:
    """The bound library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            i64, i32, f32 = ctypes.c_int64, ctypes.c_int, ctypes.c_float
            lib.voxelize_tets.restype = i32
            lib.voxelize_tets.argtypes = [f32p, i32p, i64, i32, f32p, f32p, i32, i32p]
            lib.region_grow.restype = i64
            lib.region_grow.argtypes = [f32p, u8p, i32, i32p, i64, f32, i64]
            lib.clear_cells_in_tets.restype = None
            lib.clear_cells_in_tets.argtypes = [f32p, i32p, i64, i32, f32, f32, f32p]
            _lib = lib
        return _lib


def voxelize_tets(verts: np.ndarray, tets: np.ndarray, res: int, bbox_lo: np.ndarray, inv_cell: np.ndarray,
                  max_t: int):
    """The tets' conservative voxelization, refined by their face planes →
    (cells [res³, max_t] int32, ascending ids, −1 padded; the largest
    fanout seen, which may exceed ``max_t``)."""
    cells = np.full((res**3, max_t), -1, np.int32)
    max_seen = get_lib().voxelize_tets(
        np.ascontiguousarray(verts, np.float32), np.ascontiguousarray(tets, np.int32), len(tets), res,
        np.ascontiguousarray(bbox_lo, np.float32), np.ascontiguousarray(inv_cell, np.float32), max_t, cells,
    )
    return cells, int(max_seen)


def region_grow(density: np.ndarray, selection: np.ndarray, seeds: np.ndarray, threshold: float,
                max_steps: int) -> int:
    """Breadth-first flood fill over one cascade ``density`` [res, res, res],
    6-connected, accepting cells of density ≥ ``threshold``, from the flat
    cell indices ``seeds``, for at most ``max_steps`` queue pops; grows
    ``selection`` (uint8 [res, res, res], C-contiguous) in place → the
    number of cells accepted."""
    if selection.dtype != np.uint8 or not selection.flags.c_contiguous:
        raise ValueError("region_grow: selection must be a C-contiguous uint8 array")
    res = density.shape[0]
    return int(get_lib().region_grow(
        np.ascontiguousarray(density, np.float32).reshape(-1), selection.reshape(-1), res,
        np.ascontiguousarray(seeds, np.int32), len(seeds), float(threshold), int(max_steps),
    ))


def clear_cells_in_tets(verts: np.ndarray, tets: np.ndarray, res: int, world_lo: float, cell_w: float,
                        density: np.ndarray) -> None:
    """Zero, in place, the cells of one cascade ``density`` [res, res, res]
    (float32, C-contiguous) within a cell of each tet's bounding box; the
    cascade starts at ``world_lo`` with cells ``cell_w`` wide."""
    if density.dtype != np.float32 or not density.flags.c_contiguous:
        raise ValueError("clear_cells_in_tets: density must be a C-contiguous float32 array")
    get_lib().clear_cells_in_tets(
        np.ascontiguousarray(verts, np.float32), np.ascontiguousarray(tets, np.int32), len(tets), res,
        float(world_lo), float(cell_w), density.reshape(-1),
    )
