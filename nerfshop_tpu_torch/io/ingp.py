"""`.ingp` / `.msgpack` snapshots, the Instant-NGP / NeRFshop format.

Counterpart of ``nerfshop_tpu/io/ingp.py``, byte for byte: with the same
parameters and grid the files equal the JAX package's. A file is the
MessagePack encoding (``io/msgpack_codec.py``) of the network-config JSON
tree with a ``snapshot`` key added; ``.ingp`` wraps it in zlib. The
snapshot holds ``version`` (1), ``params_type`` (``"__half"``),
``n_params``, ``params_binary``, ``training_step``, ``loss``, ``nerf``
(``aabb_scale`` and the reference's batch counters) and, with a grid,
``density_grid_size`` (128) and ``density_grid_binary``: every cascade in
morton order, fp16, clamped to ±65000.

``params_binary`` is tcnn's blob, fp16: the density MLP, then the rgb MLP,
each layer row-major [out padded to 16, in], then the hash table [Σm, F].
tcnn reads its table in the ``plain`` layout (an xor hash, levels aligned
to 8), so a brick table is re-baked on export unless ``interop`` says
otherwise: dense levels are copied, hashed levels fitted by Adam through
kernels K and L to the brick encode (kernel B) on uniform points
(:func:`rebake_plain_table`).
"""

from __future__ import annotations

import json
import warnings
import zlib
from typing import Dict, Optional

import numpy as np
import torch

from nerfshop_tpu_torch.io import msgpack_codec
from nerfshop_tpu_torch.ops import coords

SNAPSHOT_FORMAT_VERSION = 1
GRID_SIZE = 128
#: the re-bake's Adam steps and uniform points a step (JAX's)
REBAKE_STEPS = 300
REBAKE_BATCH = 1 << 14
_MLPS = ("density_mlp", "rgb_mlp")


def morton_perm(res: int = GRID_SIZE) -> np.ndarray:
    """p with p[morton index] = row-major index (x slowest) of a res³ grid."""
    x, y, z = coords.morton3d_invert(torch.arange(res**3))
    return ((x * res + y) * res + z).numpy()


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def _mlp_weights(params: Dict[str, torch.Tensor], mlp: str):
    n = sum(1 for k in params if k.startswith(f"{mlp}.weights."))
    return [params[f"{mlp}.weights.{i}"] for i in range(n)]


def pack_params(params: Dict[str, torch.Tensor]) -> np.ndarray:
    """A NeRF state dict → the tcnn-ordered fp16 blob."""
    parts = []
    for mlp in _MLPS:
        for w in _mlp_weights(params, mlp):
            w = w.detach().cpu().numpy().astype(np.float32)
            m = np.zeros((_pad16(w.shape[1]), w.shape[0]), np.float32)
            m[: w.shape[1]] = w.T
            parts.append(m.reshape(-1))
    parts.append(params["pos_encoding.table"].detach().cpu().numpy().astype(np.float32).reshape(-1))
    return np.concatenate(parts).astype(np.float16)


def unpack_params(blob: np.ndarray, template: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The blob → a state dict shaped like ``template`` (its MLP weights and
    table; float32 on the template's devices)."""
    blob = np.asarray(blob, np.float32)
    out, off = {}, 0
    for mlp in _MLPS:
        for i, w in enumerate(_mlp_weights(template, mlp)):
            fan_in, fan_out = w.shape
            n = _pad16(fan_out) * fan_in
            m = blob[off: off + n].reshape(_pad16(fan_out), fan_in)
            out[f"{mlp}.weights.{i}"] = torch.tensor(np.ascontiguousarray(m[:fan_out].T), device=w.device)
            off += n
    t = template["pos_encoding.table"]
    out["pos_encoding.table"] = torch.tensor(blob[off: off + t.numel()].reshape(tuple(t.shape)), device=t.device)
    return out


def rebake_plain_table(enc_b, table: torch.Tensor, n_steps: Optional[int] = None, batch: Optional[int] = None,
                       lr: float = 5e-2, generator: Optional[torch.Generator] = None):
    """A brick grid encoding's table → the same field in the plain layout.

    Dense levels index alike in both layouts and are copied. Hashed levels
    cannot be converted (the additive and xor hashes collide differently),
    so their plain table is the least-squares fit of the brick encode's
    output on ``batch`` (:data:`REBAKE_BATCH`) uniform points a step, drawn
    from ``generator`` (seeded 0 on the table's device when None):
    ``torch.optim.Adam`` at ``lr`` for ``n_steps`` (:data:`REBAKE_STEPS`) steps, the target from kernel B without fracs,
    the fit through kernels K and L. The encoding is linear in its table,
    so the fit is convex. → (plain encoding, plain table [Σm, F], the last
    step's MSE)."""
    from nerfshop_tpu_torch.models.encodings import GridEncoding
    from nerfshop_tpu_torch.ops import table_ops, xor_encode

    n_steps = REBAKE_STEPS if n_steps is None else n_steps
    batch = REBAKE_BATCH if batch is None else batch
    dev = table.device
    enc_p = GridEncoding(
        n_input_dims=enc_b.n_input_dims, n_levels=enc_b.n_levels, n_features_per_level=enc_b.n_features_per_level,
        log2_hashmap_size=enc_b.log2_hashmap_size, base_resolution=enc_b.base_resolution,
        per_level_scale=enc_b.per_level_scale, hash_type=enc_b.hash_type, layout="plain", device=dev,
    )
    tb = table.detach().float()
    tp = torch.zeros((enc_p.table_size, enc_p.n_features_per_level), dtype=torch.float32, device=dev)
    any_hash = False
    for l in range(enc_b.n_levels):
        if enc_b.level_dense[l] and enc_p.level_dense[l]:
            n = min(enc_b.level_sizes[l], enc_p.level_sizes[l], enc_b.level_res[l] ** enc_b.n_input_dims)
            tp[enc_p.level_offsets[l]: enc_p.level_offsets[l] + n] = tb[enc_b.level_offsets[l]: enc_b.level_offsets[l] + n]
        else:
            any_hash = True
    mse = 0.0
    if any_hash and n_steps > 0:
        if generator is None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(0)
        p = tp.clone().requires_grad_(True)
        opt = torch.optim.Adam([p], lr=lr)
        loss = None
        for _ in range(n_steps):
            x = torch.rand((batch, enc_b.n_input_dims), generator=generator, device=dev)
            with torch.no_grad():
                tgt = table_ops.grid_encode(tb, x, enc_b, with_fracs=False)[0]
            loss = torch.mean((xor_encode.XorEncodeFunction.apply(p, x, enc_p) - tgt) ** 2)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
        mse = float(loss.detach())
        tp = p.detach()
    return enc_p, tp, mse


def export_ingp(
    path: str,
    network_config: dict,
    model,
    params: Dict[str, torch.Tensor],
    density_grid=None,  # [C, R, R, R]
    aabb_scale: int = 1,
    training_step: int = 0,
    loss: float = 0.0,
    compress: bool = True,
    interop: str = "convert",  # "convert" | "warn" | "strict"
    generator: Optional[torch.Generator] = None,
) -> None:
    """Write a NeRF (``model``, a ``NerfNetwork``; ``params``, its state dict,
    e.g. the EMA copy) as ``path``. A brick table is re-baked into the plain
    layout (``interop="convert"``, with a warning that gives the fit's
    MSE), written as it is with the layout recorded and a warning that tcnn
    readers cannot read it (``"warn"``), or refused with ``ValueError``
    (``"strict"``); ``generator`` draws the re-bake's points."""
    cfg = json.loads(json.dumps(dict(network_config)))
    layout = getattr(getattr(model, "pos_encoding", None), "layout", None)
    if layout is not None and isinstance(cfg.get("encoding"), dict):
        if layout != "plain" and interop == "strict":
            raise ValueError(
                f".ingp export with table layout {layout!r} is not readable by "
                "tcnn/CUDA readers; use interop='convert' (re-bake) or 'warn'."
            )
        if layout != "plain" and interop == "convert":
            _, table_p, mse = rebake_plain_table(model.pos_encoding, params["pos_encoding.table"], generator=generator)
            params = {**params, "pos_encoding.table": table_p}
            cfg["encoding"]["layout"] = "plain"
            layout = "plain"
            if mse > 0:
                warnings.warn(
                    f"{path}: hash levels re-baked to tcnn plain order with "
                    f"least-squares fit MSE {mse:.3e} (dense levels exact); "
                    "pass interop='warn' to keep the native layout lossless"
                )
        else:
            cfg["encoding"]["layout"] = layout
        if layout != "plain":
            warnings.warn(
                f".ingp export uses table layout {layout!r}: readable by "
                "nerfshop_tpu (layout recorded in the config) but NOT by "
                "CUDA Instant-NGP/NeRFshop readers, which assume tcnn "
                "xor-hash indexing. Use interop='convert' for "
                "cross-ecosystem interop.",
                stacklevel=2,
            )
    blob = pack_params(params)
    snapshot = {
        "version": SNAPSHOT_FORMAT_VERSION,
        "params_type": "__half",
        "n_params": int(blob.size),
        "params_binary": blob.tobytes(),
        "training_step": int(training_step),
        "loss": float(loss),
        "nerf": {
            "aabb_scale": int(aabb_scale),
            "rgb": {
                "rays_per_batch": 4096,
                "measured_batch_size": 1 << 18,
                "measured_batch_size_before_compaction": 1 << 18,
            },
        },
    }
    if density_grid is not None:
        dense = np.asarray(torch.as_tensor(density_grid).detach().cpu(), np.float32)
        morton = dense.reshape(dense.shape[0], -1)[:, morton_perm(GRID_SIZE)]
        snapshot["density_grid_size"] = GRID_SIZE
        # clamped before the f16 cast: an exp-activated σ can pass fp16's range
        snapshot["density_grid_binary"] = np.clip(morton, -65000.0, 65000.0).astype(np.float16).tobytes()
    cfg["snapshot"] = snapshot
    raw = msgpack_codec.packb(cfg)
    if str(path).endswith(".ingp") and compress:
        raw = zlib.compress(raw)
    with open(path, "wb") as fh:
        fh.write(raw)


def load_ingp(path: str) -> dict:
    """→ the decoded config tree with its ``snapshot``; a zlib header is
    unwrapped first."""
    with open(path, "rb") as fh:
        raw = fh.read()
    if raw[:1] == b"\x78":
        raw = zlib.decompress(raw)
    return msgpack_codec.unpackb(raw)


def import_ingp(path: str, template: Dict[str, torch.Tensor]) -> dict:
    """Read ``path`` into the shapes of ``template`` (a NeRF state dict) →
    {"params": state dict, "density_grid": [C, R, R, R] float32 or None,
    "training_step", "loss", "aabb_scale", "config"}."""
    cfg = load_ingp(path)
    snap = cfg.get("snapshot")
    if snap is None:
        raise ValueError(f"{path} contains no snapshot")
    params = unpack_params(np.frombuffer(snap["params_binary"], np.float16), template)
    density_grid = None
    if "density_grid_binary" in snap:
        res = int(snap.get("density_grid_size", GRID_SIZE))
        dg = np.frombuffer(snap["density_grid_binary"], np.float16).astype(np.float32)
        C = dg.size // res**3
        rm = np.empty((C, res**3), np.float32)
        rm[:, morton_perm(res)] = dg.reshape(C, -1)
        density_grid = rm.reshape(C, res, res, res)
    return {
        "params": params,
        "density_grid": density_grid,
        "training_step": int(snap.get("training_step", 0)),
        "loss": float(snap.get("loss", 0.0)),
        "aabb_scale": int(snap.get("nerf", {}).get("aabb_scale", 1)),
        "config": cfg,
    }
