"""Edits I/O: the operator list as JSON, version 1.

Counterpart of ``nerfshop_tpu/editing/serialization.py``, in the same
layout (the device state of each operator, arrays as base64 with dtype and
shape), so that an edits file moves between the two packages both ways.

Version 1 has no field for a cage's Poisson membrane. The JAX package's
``save_edits`` writes such an operator without it, so the reloaded edit
renders without its seam correction; the port's ``save_edits`` refuses the
operator instead (ROADMAP Queue 3, F10).
"""

from __future__ import annotations

import base64
import json
from pathlib import Path
from typing import List

import numpy as np
import torch

from nerfshop_tpu_torch.editing.operators import AFFINE_ARRAYS, CAGE_ARRAYS, AffineDuplicationOp, CageDeformationOp
from nerfshop_tpu_torch.editing.tet_mesh import TetLut


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _enc(a, dtype) -> dict:
    a = _np(a).astype(dtype)
    return {"dtype": str(a.dtype), "shape": list(a.shape), "b64": base64.b64encode(a.tobytes()).decode()}


def _dec(d) -> np.ndarray:
    return np.frombuffer(base64.b64decode(d["b64"]), np.dtype(d["dtype"])).reshape(d["shape"])


def save_edits(path: str | Path, operators: List, metadata: dict | None = None) -> None:
    """Write the operators; raises ``ValueError`` on a cage that carries a
    membrane, which version 1 cannot hold (clear it or drop the operator)."""
    ops_json = []
    for i, op in enumerate(operators):
        if isinstance(op, CageDeformationOp):
            if op.membrane is not None:
                raise ValueError(
                    f"save_edits: operator {i} carries a Poisson membrane, which the edits file (version 1) cannot "
                    "hold; saving it without would reload an edit that renders without its seam correction"
                )

            def lut(lt):
                return {
                    "bbox_lo": _enc(lt.bbox_lo, np.float32), "inv_cell": _enc(lt.inv_cell, np.float32),
                    "cells": _enc(lt.cells, np.int32), "res": lt.res,
                }

            d = {"type": "cage_deformation", "copy_mode": bool(op.copy_mode), "lut_def": lut(op.lut_def),
                 "lut_orig": lut(op.lut_orig)}
            d.update({k: _enc(getattr(op, k), np.float32) for k in CAGE_ARRAYS})
            ops_json.append(d)
        elif isinstance(op, AffineDuplicationOp):
            d = {"type": "affine_duplication"}
            d.update({k: _np(getattr(op, k)).tolist() for k in AFFINE_ARRAYS})
            d["hide_original"] = bool(op.hide_original)
            ops_json.append(d)
        else:
            raise TypeError(f"unserializable operator {type(op)}")
    Path(path).write_text(json.dumps({"version": 1, "metadata": metadata or {}, "operators": ops_json}))


def load_edits(path: str | Path, device: torch.device) -> List:
    """The operators of an edits file, with their tensors on ``device``."""

    def t(a, dtype=None):
        return torch.as_tensor(np.array(a, dtype=dtype), device=device)

    ops = []
    for d in json.loads(Path(path).read_text())["operators"]:
        if d["type"] == "cage_deformation":

            def lut(ld):
                return TetLut(t(_dec(ld["bbox_lo"])), t(_dec(ld["inv_cell"])), t(_dec(ld["cells"])), int(ld["res"]))

            ops.append(
                CageDeformationOp.create(
                    lut(d["lut_def"]), lut(d["lut_orig"]), bool(d["copy_mode"]), **{k: t(_dec(d[k])) for k in CAGE_ARRAYS}
                )
            )
        elif d["type"] == "affine_duplication":
            ops.append(
                AffineDuplicationOp(
                    **{k: t(d[k], np.float32) for k in AFFINE_ARRAYS}, hide_original=bool(d["hide_original"])
                )
            )
        else:
            raise ValueError(f"unknown operator type {d['type']!r}")
    return ops
