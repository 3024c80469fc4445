"""Move NeRF weights between the JAX params pytree and the port.

The JAX ``NerfNetwork.init`` pytree, converted to numpy, has the leaves
``pos_encoding/table``, ``density_mlp/weights/i`` and ``rgb_mlp/weights/i``
(the flat paths of ``nerfshop_tpu/io/snapshot.py``). The port's
``NerfNetwork`` names the same tensors ``pos_encoding.table``,
``density_mlp.weights.i`` and ``rgb_mlp.weights.i``, so
``model.load_state_dict(params_from_jax(tree))`` loads them slot for slot.
The training leaves outside the network, JAX's ``camera`` (``rot``,
``trans``, ``log_exposure``, ``distortion_map``) and ``envmap``, come
across as ``camera.rot`` … and ``envmap`` (a ``TrainState``'s ``extra``).
The Image, SDF and Volume models (JAX ``ImageModel``, ``SdfModel``,
``VolumeModel``) have the leaves ``encoding/table`` and
``network/weights/i``; :func:`field_params_from_jax` and
:func:`field_params_to_jax` carry them into the port's ``FieldModel``
(``models/field.py``) and back.

A snapshot stores the same leaves flat under ``/``-joined paths
(``/pos_encoding/table``, ``/density_mlp/weights/0``, …);
:func:`flat_from_state` and :func:`state_from_flat` move the parameters or
their EMA copy between that form and a state dict.

:func:`operators_from_jax` and :func:`operators_to_jax` move edit
operators between the two packages, and :func:`baked_from_jax` a baked
volume from the JAX package to the port.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_MLPS = ("density_mlp", "rgb_mlp")


def params_from_jax(tree: dict, device=None) -> Dict[str, torch.Tensor]:
    """JAX params pytree (numpy leaves) → the port's state dict."""

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    out = {"pos_encoding.table": t(tree["pos_encoding"]["table"])}
    for mlp in _MLPS:
        for i, w in enumerate(tree[mlp]["weights"]):
            out[f"{mlp}.weights.{i}"] = t(w)
    for k, a in tree.get("camera", {}).items():
        out[f"camera.{k}"] = t(a)
    if "envmap" in tree:
        out["envmap"] = t(tree["envmap"])
    return out


def params_to_jax(state: Dict[str, torch.Tensor]) -> dict:
    """The port's state dict (with any ``camera.*`` and ``envmap`` leaves) →
    JAX params pytree with numpy leaves (without ``dir_encoding``, which has
    no trainable leaves)."""

    def np_of(t):
        return t.detach().cpu().numpy().astype(np.float32)

    tree = {"pos_encoding": {"table": np_of(state["pos_encoding.table"])}}
    for mlp in _MLPS:
        n = sum(1 for k in state if k.startswith(f"{mlp}.weights."))
        tree[mlp] = {"weights": [np_of(state[f"{mlp}.weights.{i}"]) for i in range(n)]}
    camera = {k[len("camera."):]: np_of(v) for k, v in state.items() if k.startswith("camera.")}
    if camera:
        tree["camera"] = camera
    if "envmap" in state:
        tree["envmap"] = np_of(state["envmap"])
    return tree


def field_params_from_jax(tree: dict, device=None) -> Dict[str, torch.Tensor]:
    """A JAX Image / SDF / Volume params pytree (numpy leaves) → the port's
    ``FieldModel`` state dict."""

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    out = {"encoding.table": t(tree["encoding"]["table"])}
    for i, w in enumerate(tree["network"]["weights"]):
        out[f"network.weights.{i}"] = t(w)
    return out


def field_params_to_jax(state: Dict[str, torch.Tensor]) -> dict:
    """The port's ``FieldModel`` state dict → a JAX params pytree with numpy
    leaves."""

    def np_of(t):
        return t.detach().cpu().numpy().astype(np.float32)

    n = sum(1 for k in state if k.startswith("network.weights."))
    return {
        "encoding": {"table": np_of(state["encoding.table"])},
        "network": {"weights": [np_of(state[f"network.weights.{i}"]) for i in range(n)]},
    }


_LUT_ARRAYS = ("bbox_lo", "inv_cell", "cells")


def operators_from_jax(ops, device: torch.device) -> list:
    """JAX edit operators (``CageDeformationOp`` / ``AffineDuplicationOp``
    named tuples, read by their field names; any array type numpy takes) →
    the port's operators on ``device``. A cage's Poisson membrane (the JAX
    ``MembraneData``, read by its field names) comes across with its
    packed form."""
    from nerfshop_tpu_torch.editing.operators import AFFINE_ARRAYS, CAGE_ARRAYS, AffineDuplicationOp, CageDeformationOp
    from nerfshop_tpu_torch.editing.tet_mesh import TetLut

    def t(a):
        return torch.as_tensor(np.array(a), device=device)

    out = []
    for op in ops:
        if hasattr(op, "lut_def"):

            def lut(lt):
                return TetLut(*(t(getattr(lt, k)) for k in _LUT_ARRAYS), int(lt.res))

            cage = CageDeformationOp.create(
                lut(op.lut_def), lut(op.lut_orig), bool(np.asarray(op.copy_mode)),
                **{k: t(getattr(op, k)) for k in CAGE_ARRAYS},
            )
            m = getattr(op, "membrane", None)
            if m is not None:
                cage = cage._replace(membrane=membrane_from_jax(m, device))
            out.append(cage)
        elif hasattr(op, "box_center"):
            out.append(
                AffineDuplicationOp(
                    **{k: t(getattr(op, k)) for k in AFFINE_ARRAYS},
                    hide_original=bool(np.asarray(op.hide_original)),
                )
            )
        else:
            raise TypeError(f"not an edit operator: {type(op)}")
    return out


_MEMBRANE_ARRAYS = ("density", "outside_density", "sh")


def membrane_from_jax(m, device: torch.device):
    """A JAX ``MembraneData`` (read by its field names) → the port's, with
    its packed form, on ``device``."""
    from nerfshop_tpu_torch.editing.poisson import MembraneData

    missing = [k for k in (*_MEMBRANE_ARRAYS, "amplitude") if not hasattr(m, k)]
    if missing:
        raise TypeError(f"not a MembraneData: {type(m).__name__} lacks {missing}")
    arrs = (torch.as_tensor(np.array(getattr(m, k), np.float32), device=device) for k in _MEMBRANE_ARRAYS)
    return MembraneData.create(*arrs, float(np.asarray(m.amplitude)))


def operators_to_jax(ops) -> list:
    """The port's operators → one dict per operator with the JAX named
    tuple's type name under ``"type"`` and its fields as numpy arrays (the
    LUTs as dicts of ``bbox_lo``, ``inv_cell``, ``cells``, ``res``; a
    cage's membrane, when it has one, as a dict of ``density``,
    ``outside_density``, ``sh``, ``amplitude``), ready for ``CageDeformationOp(**fields)`` /
    ``AffineDuplicationOp(**fields)`` once the arrays are moved to JAX."""
    from nerfshop_tpu_torch.editing.operators import AFFINE_ARRAYS, CAGE_ARRAYS, AffineDuplicationOp, CageDeformationOp

    def np_of(a):
        return a.detach().cpu().numpy()

    out = []
    for op in ops:
        if isinstance(op, CageDeformationOp):
            d = {"type": "CageDeformationOp", "copy_mode": np.asarray(op.copy_mode)}
            for k in ("lut_def", "lut_orig"):
                lt = getattr(op, k)
                d[k] = {**{a: np_of(getattr(lt, a)) for a in _LUT_ARRAYS}, "res": lt.res}
            d.update({k: np_of(getattr(op, k)) for k in CAGE_ARRAYS})
            m = op.membrane
            if m is not None:
                d["membrane"] = {**{k: np_of(getattr(m, k)) for k in _MEMBRANE_ARRAYS}, "amplitude": np.float32(m.amplitude)}
        elif isinstance(op, AffineDuplicationOp):
            d = {"type": "AffineDuplicationOp", "hide_original": np.asarray(op.hide_original)}
            d.update({k: np_of(getattr(op, k)) for k in AFFINE_ARRAYS})
        else:
            raise TypeError(f"not an edit operator: {type(op)}")
        out.append(d)
    return out


def _bf16_from(a, device) -> torch.Tensor:
    """An array of bfloat16 values (numpy's 2-byte bfloat16, as a JAX array
    converts, or any float array) → a bf16 tensor on ``device``."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.itemsize == 2 and a.dtype.kind not in "fiu":  # bfloat16: the bits as they are
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.as_tensor(np.asarray(a, np.float32), device=device).to(torch.bfloat16)


def baked_from_jax(vol, device):
    """A JAX ``BakedVolume`` (read by its field names; any array type numpy
    takes) → the port's ``render.baked.BakedVolume`` with its tensors on
    ``device``: the three layouts and the canonical volume bit for bit, the
    box and the shading eye as host float32 arrays."""
    from nerfshop_tpu_torch.render.baked import BakedVolume

    canonical = None if getattr(vol, "canonical", None) is None else _bf16_from(vol.canonical, device)
    cam = getattr(vol, "camera_pos", None)
    return BakedVolume(
        tuple(_bf16_from(f, device) for f in vol.fields),
        np.asarray(vol.aabb_lo, np.float32).reshape(3).copy(),
        np.asarray(vol.aabb_hi, np.float32).reshape(3).copy(),
        None if cam is None else np.asarray(cam, np.float32).reshape(3).copy(),
        canonical,
    )


def snapshot_path(name: str) -> str:
    """State-dict name → flat snapshot path (``a.b.0`` → ``/a/b/0``)."""
    return "/" + name.replace(".", "/")


def flat_from_state(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """State dict (parameters or their EMA copy) → {snapshot path: float32 array}."""
    return {snapshot_path(k): v.detach().cpu().numpy().astype(np.float32) for k, v in state.items()}


def state_from_flat(
    flat: Dict[str, np.ndarray], template: Dict[str, torch.Tensor]
) -> Dict[str, torch.Tensor]:
    """{snapshot path: array} → a state dict with the names, shapes, dtypes
    and devices of ``template``; raises ``KeyError`` on a missing leaf and
    ``ValueError`` on a shape that differs."""
    out = {}
    for k, t in template.items():
        a = np.asarray(flat[snapshot_path(k)])
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"{k}: snapshot shape {tuple(a.shape)}, model shape {tuple(t.shape)}")
        out[k] = torch.tensor(a, dtype=t.dtype, device=t.device)
    return out
