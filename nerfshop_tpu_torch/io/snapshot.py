"""Snapshot save/load in the JAX package's native format (schema v2).

Counterpart of ``nerfshop_tpu/io/snapshot.py``: ``NSTZ`` + zlib around a
MessagePack map of

* ``version`` (2), ``generator``, ``mode``, ``network_config`` (JSON tree);
* ``params`` and ``ema_params``: every leaf flattened under its JAX path
  (``/pos_encoding/table``, ``/density_mlp/weights/0``, …) as
  ``{dtype, shape, data}``, with a NeRF's training leaves outside the
  network where it has them (``/camera/rot``, ``/camera/trans``,
  ``/camera/log_exposure``, ``/camera/distortion_map``, ``/envmap``);
* ``density_grid``: ``{n_cascades, layout: "morton_f32", data}``, each
  cascade in morton order, float32 (float16 snapshots are read too);
* ``nerf``: dataset metadata, so a snapshot renders without the dataset;
* ``step``.

The port writes no ``opt_state``: its Adam state (``torch.optim.Adam``)
has another layout than optax's, and the JAX loader ignores ``opt_state``
anyway, so a snapshot resumes with fresh moments in either package.
Snapshots of schema v1 (the paired table layout, not ported) raise
``NotImplementedError``. The ``.ingp``/``.msgpack`` formats are
``io/ingp.py``'s; ``Testbed.save_snapshot`` and ``load_snapshot`` choose
by the file's extension.
"""

from __future__ import annotations

import zlib
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from nerfshop_tpu_torch.common import GRID_VOLUME
from nerfshop_tpu_torch import weights
from nerfshop_tpu_torch.io import msgpack_codec
from nerfshop_tpu_torch.ops import coords

SNAPSHOT_VERSION = 2


def _pack_arrays(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    return {k: {"dtype": str(v.dtype), "shape": list(v.shape), "data": v.tobytes()} for k, v in flat.items()}


def _unpack_arrays(packed: Dict[str, Any]) -> Dict[str, np.ndarray]:
    return {
        k: np.frombuffer(v["data"], dtype=np.dtype(v["dtype"])).reshape(v["shape"]) for k, v in packed.items()
    }


def save_snapshot(
    path: str | Path,
    params: Dict[str, torch.Tensor],
    network_config: dict,
    mode: str = "nerf",
    ema_params: Optional[Dict[str, torch.Tensor]] = None,
    density_grid: Optional[torch.Tensor] = None,  # [C, R, R, R]
    metadata: Optional[dict] = None,
    step: int = 0,
) -> None:
    """``params``/``ema_params`` are state dicts of the port's network."""
    snap: Dict[str, Any] = {
        "version": SNAPSHOT_VERSION,
        "generator": "nerfshop_tpu_torch",
        "mode": mode,
        "network_config": network_config,
        "step": int(step),
        "params": _pack_arrays(weights.flat_from_state(params)),
    }
    if ema_params is not None:
        snap["ema_params"] = _pack_arrays(weights.flat_from_state(ema_params))
    if density_grid is not None:
        # f32: the occupancy threshold is the grid's mean, and f16 would move
        # cells that sit at it across the threshold
        dense = density_grid.detach().to("cpu", torch.float32)
        morton = torch.stack([coords.dense_grid_to_morton(dense[c]) for c in range(dense.shape[0])])
        snap["density_grid"] = {
            "n_cascades": int(dense.shape[0]),
            "layout": "morton_f32",
            "data": morton.numpy().tobytes(),
        }
    if metadata is not None:
        snap["nerf"] = metadata
    Path(path).write_bytes(b"NSTZ" + zlib.compress(msgpack_codec.packb(snap), 6))


def load_snapshot(path: str | Path) -> Dict[str, Any]:
    """→ the snapshot map with ``params``/``ema_params`` as {path: array}
    and ``density_grid`` as a dense float32 [C, R, R, R] array. Reads the
    uncompressed files that the JAX package writes with ``compress=False``
    too."""
    blob = Path(path).read_bytes()
    if blob[:4] == b"NSTZ":
        blob = zlib.decompress(blob[4:])
    snap = msgpack_codec.unpackb(blob)
    version = snap.get("version", 0)
    if version > SNAPSHOT_VERSION:
        raise ValueError(f"snapshot version {version} too new")
    if version < 2:
        raise NotImplementedError(f"snapshot version {version} (paired table layout) is not ported")
    snap["params"] = _unpack_arrays(snap["params"])
    if "ema_params" in snap:
        snap["ema_params"] = _unpack_arrays(snap["ema_params"])
    if "density_grid" in snap:
        dg = snap["density_grid"]
        C = dg["n_cascades"]
        dtype = np.float32 if dg.get("layout") == "morton_f32" else np.float16
        flat = np.frombuffer(dg["data"], dtype).reshape(C, GRID_VOLUME)
        # older f16 snapshots cast unclamped densities → ±inf entries
        flat = np.nan_to_num(flat.astype(np.float32), posinf=65000.0, neginf=0.0)
        snap["density_grid"] = np.stack(
            [coords.morton_to_dense_grid(torch.from_numpy(flat[c])).numpy() for c in range(C)]
        )
    return snap


def restore_params(template: Dict[str, torch.Tensor], snap: Dict[str, Any], key: str = "params"):
    """The snapshot's flat ``key`` arrays as a state dict shaped like ``template``."""
    return weights.state_from_flat(snap[key], template)
