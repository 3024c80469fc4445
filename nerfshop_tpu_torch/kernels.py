"""Build and bind the hand-written CUDA kernels of ``csrc/``.

The sources are compiled on first use with ``nvcc`` (one process per
source, in parallel) and linked into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds), placed in
``build/nerfshop_tpu_torch/`` at the root of the checkout and keyed by a
hash of the sources and flags, then loaded with ``ctypes``. The same
pattern as the JAX package's ``native`` host library.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises when that is not 0. Nothing is
imported or built at module import time, so CPU-only installs can import the
package; a build failure raises, it never falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (
    "segsum.cu", "grid_encode.cu", "fused_mlp.cu", "gather.cu", "tet_lookup.cu", "bvh.cu", "baked.cu", "xor_encode.cu",
)
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "nerfshop_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_lib = None

#: the kernel wrappers and the names of their launch counters
_COUNTED: List[Tuple[Callable, Tuple[str, ...]]] = []


class GatherPlan(ctypes.Structure):
    """The launch of one call of kernel D, field for field ``struct
    GatherPlan`` of ``csrc/gather.cu`` (made by ``ops/gather.py::plan``)."""

    _fields_ = [
        (name, ctypes.c_longlong)
        for name in ("form", "idx64", "S", "C", "Q", "Cq", "staged", "xvec", "ivec", "rows", "tx", "ty", "blocks", "smem")
    ]


class LutArgs(ctypes.Structure):
    """One LUT of a launch of kernel E, field for field ``struct LutArgs`` of
    ``csrc/tet_lookup.cu`` (filled by ``editing/operators.py``)."""

    _fields_ = [
        ("offsets", ctypes.c_void_p), ("ids", ctypes.c_void_p), ("rows", ctypes.c_void_p),
        ("box", ctypes.c_float * 6), ("res", ctypes.c_int), ("threshold", ctypes.c_float),
    ]


class CageArgs(ctypes.Structure):
    """The arguments of one launch of kernel E, field for field ``struct
    CageArgs`` of ``csrc/tet_lookup.cu``."""

    _fields_ = [
        ("a", LutArgs), ("b", LutArgs),
        *((name, ctypes.c_void_p) for name in
          ("deltas", "rots", "p", "dir", "pos_out", "dir_out", "flag0", "flag1", "tet", "bary")),
        ("n", ctypes.c_longlong), ("copy_mode", ctypes.c_int),
        *((name, ctypes.c_void_p) for name in ("membrane", "acc_sigma", "acc_out", "acc_rgb")),
        ("amplitude", ctypes.c_float),
    ]


class BvhArgs(ctypes.Structure):
    """The BVH of one launch of kernel G, field for field ``struct BvhArgs``
    of ``csrc/bvh.cu``: the arrays of ``geometry/bvh.py::PackedBvh`` and the
    pseudo-normals of its ``BvhArrays``."""

    _fields_ = [
        (name, ctypes.c_void_p) for name in ("nodes", "tris", "tri_pseudo_v", "tri_pseudo_e", "tri_n")
    ]


class FrameArgs(ctypes.Structure):
    """One baked frame's camera and raster, field for field ``struct
    FrameArgs`` of ``csrc/baked.cu`` (filled from
    ``render/baked.py::FrameParams``)."""

    _fields_ = [
        ("e", ctypes.c_float * 3), ("box", ctypes.c_float * 4), ("cell_world", ctypes.c_float),
        ("rows", ctypes.c_float * 9), ("scale", ctypes.c_float * 3), ("focal", ctypes.c_float * 2),
        ("principal_px", ctypes.c_float * 2), ("sky", ctypes.c_float * 4),
        *((name, ctypes.c_int) for name in ("B", "Bi", "W", "H", "flip", "with_depth")),
    ]


class XorLevel(ctypes.Structure):
    """One level of kernels K and L, field for field ``struct XorLevel`` of
    ``csrc/xor_encode.cu`` (filled by ``ops/xor_encode.py::xor_args``)."""

    _fields_ = [
        ("scale", ctypes.c_float), ("res", ctypes.c_int), ("m", ctypes.c_uint), ("offset", ctypes.c_int),
        ("dense", ctypes.c_int), ("mask_off", ctypes.c_int), ("mask_res", ctypes.c_int), ("pow2", ctypes.c_int),
    ]


#: the most levels kernels K and L take (``kMaxLevels`` of ``csrc/xor_encode.cu``)
XOR_MAX_LEVELS = 32


class XorArgs(ctypes.Structure):
    """The levels and shape of one launch of kernel K or L, field for field
    ``struct XorArgs`` of ``csrc/xor_encode.cu``."""

    _fields_ = [("lv", XorLevel * XOR_MAX_LEVELS)] + [
        (name, ctypes.c_int) for name in ("n_levels", "D", "F", "takikawa", "sum")
    ]


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libnerfshop_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library of the same hash exists: one
    ``nvcc -c`` per source, all started together, then one link."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, Path(s).stem + ".o") for s in SOURCES]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", o],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for s, o in zip(SOURCES, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        for s, p, log in zip(SOURCES, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s} ({p.returncode}):\n{log}")
        lib = os.path.join(tmp, so.name)
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(lib, so)
    return so


def load() -> ctypes.CDLL:
    """The bound library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.nst_segsum.argtypes = [p, p, p, p, p, i, i, i, i, p]
        lib.nst_segsum.restype = i
        lib.nst_grid_encode.argtypes = [p, p, p, p, p, p, p, i, i, i, p]
        lib.nst_grid_encode.restype = i
        lib.nst_grid_encode_dx.argtypes = [p, p, p, p, p, i, i, p]
        lib.nst_grid_encode_dx.restype = i
        lib.nst_grid_encode_dx_bwd.argtypes = [p, p, p, p, p, p, p, i, i, p]
        lib.nst_grid_encode_dx_bwd.restype = i
        lib.nst_grid_encode_dx_bwd_attrs.argtypes = [i, p]
        lib.nst_grid_encode_dx_bwd_attrs.restype = i
        lib.nst_grid_encode_tile.argtypes = [i]
        lib.nst_grid_encode_tile.restype = i
        lib.nst_fused_mlp.argtypes = [p, p, p, p, p, i, i, i, i, p]
        lib.nst_fused_mlp.restype = i
        lib.nst_gather.argtypes = [p, p, p, ctypes.POINTER(GatherPlan), p]
        lib.nst_gather.restype = i
        lib.nst_cage.argtypes = [ctypes.POINTER(CageArgs), i, p]
        lib.nst_cage.restype = i
        lib.nst_bvh_sdf.argtypes = [ctypes.POINTER(BvhArgs), p, p, i, p]
        lib.nst_bvh_sdf.restype = i
        lib.nst_shear_composite.argtypes = [ctypes.POINTER(FrameArgs), p, p, p]
        lib.nst_shear_composite.restype = i
        lib.nst_shear_composite_paths.argtypes = [ctypes.POINTER(FrameArgs), p, p, p, p]
        lib.nst_shear_composite_paths.restype = i
        lib.nst_shear_screen.argtypes = [ctypes.POINTER(FrameArgs), p, p, p, p]
        lib.nst_shear_screen.restype = i
        lib.nst_xor_encode.argtypes = [ctypes.POINTER(XorArgs), p, p, p, p, i, p]
        lib.nst_xor_encode.restype = i
        lib.nst_xor_encode_bwd.argtypes = [ctypes.POINTER(XorArgs), p, p, p, p, p, p, i, p]
        lib.nst_xor_encode_bwd.restype = i
        lib.nst_xor_vector_atomics.argtypes = []
        lib.nst_xor_vector_atomics.restype = i
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def stream_ptr(device: torch.device) -> int:
    """The raw handle of PyTorch's current stream on ``device`` (a CUDA
    tensor's device, which always carries its index)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def aligned16(*tensors: torch.Tensor) -> bool:
    """Every tensor's data starts on a 16-byte boundary (a contiguous view
    with a storage offset may not), so the kernels may use 16-byte accesses."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple, device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on ``device``."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def counted(*names: str):
    """Decorator of a kernel wrapper: give it the integer counters ``names``
    (``launches``, and for kernel B ``fracs_launches``), 0 to begin with,
    which the wrapper advances where it launches its kernel. They count
    Python calls; :func:`launch_counts` and :func:`add_launches` let a
    replayed CUDA graph count the launches it captured."""

    def deco(fn):
        for name in names:
            setattr(fn, name, 0)
        _COUNTED.append((fn, names))
        return fn

    return deco


def launch_counts() -> Dict[Tuple[Callable, str], int]:
    """Every counter of every wrapper that :func:`counted` decorated."""
    return {(fn, name): getattr(fn, name) for fn, names in _COUNTED for name in names}


def add_launches(delta: Dict[Tuple[Callable, str], int], times: int = 1) -> None:
    """Advance the counters by ``times`` × ``delta`` (a difference of two
    :func:`launch_counts`)."""
    for (fn, name), d in delta.items():
        setattr(fn, name, getattr(fn, name) + times * d)
