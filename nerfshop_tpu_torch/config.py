"""JSON network-config tree.

Feature parity with the reference config system
(src/testbed.cu:152-210 ``load_network_config``):

* ``//``-comment-tolerant JSON (the reference uses nlohmann-json with
  comments stripped; configs/image/base.json contains ``//`` lines),
* ``"parent": "other.json"`` inheritance — child keys override parent keys,
  resolved relative to the child file,
* dict merging is recursive for nested objects.

Configs are plain nested dicts wrapped in :class:`ConfigDict` for attribute
access; they stay pure-Python (never traced by JAX).
"""

from __future__ import annotations

import copy
import json
import re
from pathlib import Path
from typing import Any, Mapping

_COMMENT_RE = re.compile(r'("(?:\\.|[^"\\])*")|//[^\n]*')


def _strip_json_comments(text: str) -> str:
    """Remove ``//`` line comments outside of string literals."""
    return _COMMENT_RE.sub(lambda m: m.group(1) or "", text)


def loads_tolerant(text: str) -> Any:
    return json.loads(_strip_json_comments(text))


def _deep_merge(base: dict, override: Mapping) -> dict:
    out = copy.deepcopy(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, Mapping):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


class ConfigDict(dict):
    """dict with attribute access and safe ``.get``-style defaults."""

    def __getattr__(self, name: str) -> Any:
        try:
            v = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        return ConfigDict(v) if isinstance(v, dict) and not isinstance(v, ConfigDict) else v

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def get_path(self, path: str, default: Any = None) -> Any:
        """``cfg.get_path("optimizer.nested.learning_rate", 1e-2)``."""
        node: Any = self
        for part in path.split("."):
            if not isinstance(node, Mapping) or part not in node:
                return default
            node = node[part]
        return node


def load_network_config(path: str | Path) -> ConfigDict:
    """Load a network config file, resolving ``parent`` inheritance chains."""
    path = Path(path)
    data = loads_tolerant(path.read_text())
    if not isinstance(data, dict):
        raise ValueError(f"network config {path} must be a JSON object")
    seen = {path.resolve()}
    while "parent" in data:
        parent_path = (path.parent / data.pop("parent")).resolve()
        if parent_path in seen:
            raise ValueError(f"config parent cycle at {parent_path}")
        seen.add(parent_path)
        parent = loads_tolerant(parent_path.read_text())
        data = _deep_merge(parent, data)
        path = parent_path
    return ConfigDict(data)


def default_nerf_config() -> ConfigDict:
    """The built-in NeRF config (semantics of configs/nerf/base.json)."""
    return ConfigDict(
        {
            "loss": {"otype": "Huber"},
            "optimizer": {
                "otype": "Ema",
                "decay": 0.95,
                "nested": {
                    "otype": "ExponentialDecay",
                    "decay_start": 20000,
                    "decay_interval": 10000,
                    "decay_base": 0.33,
                    "nested": {
                        "otype": "Adam",
                        "learning_rate": 1e-2,
                        "beta1": 0.9,
                        "beta2": 0.99,
                        "epsilon": 1e-15,
                        "l2_reg": 1e-6,
                    },
                },
            },
            "encoding": {
                "otype": "HashGrid",
                "n_levels": 16,
                "n_features_per_level": 2,
                "log2_hashmap_size": 19,
                "base_resolution": 16,
            },
            "network": {
                "otype": "FullyFusedMLP",
                "activation": "ReLU",
                "output_activation": "None",
                "n_neurons": 64,
                "n_hidden_layers": 1,
            },
            "dir_encoding": {
                "otype": "Composite",
                "nested": [
                    {"n_dims_to_encode": 3, "otype": "SphericalHarmonics", "degree": 4},
                    {"otype": "Identity"},
                ],
            },
            "rgb_network": {
                "otype": "FullyFusedMLP",
                "activation": "ReLU",
                "output_activation": "None",
                "n_neurons": 64,
                "n_hidden_layers": 2,
            },
        }
    )


def fast_nerf_config() -> ConfigDict:
    """TPU-tuned hash-grid config: reference semantics, half the levels.

    The field eval is ~100% hash-table row-gathers on v5e (MLP/SH ride
    free — scratch/probe_field_rate.py), and the gather cost is per LEVEL:
    L16 F2 pays 16 row-fetches/sample. Halving the levels (same 2^19
    table, same per-level-scale law → levels still ladder 16→2048·aabb)
    doubles field-eval and ~1.65×'s the fox train rate at a measured
    −0.3 dB on fox (27.30 vs 27.57 dB at 2080 steps, 5-view ¼-res
    protocol — scratch/probe_fox_f4l8.py). Width/packing/bf16 variants all
    measured worse (probe_narrow_gather.py: [m,16] brick rows are the
    gather-optimal form; F=4/F=8 rows gather SLOWER per row).

    Reference parity stays with ``default_nerf_config`` (tcnn base.json
    L=16); this is the throughput default for bench/serving.
    """
    cfg = default_nerf_config()
    cfg["encoding"]["n_levels"] = 8
    return cfg


def tpu_flagship_nerf_config() -> ConfigDict:
    """The TPU-first flagship NeRF config: a gather-free field.

    Measured on one v5e chip, XLA executes random row-gathers at ~10⁸/s
    regardless of table size (they lower to sequential DMA descriptors), so
    a tcnn-parity hash encoding caps the field at ~3M samples/s while the
    MXU sits idle. This config replaces the hash table with frequency
    features + a wide MLP — pure matmul work — and runs at 40-65M
    samples/s on the same chip (see bench.py). Use the default hash config
    (``default_nerf_config``) when tcnn checkpoint parity matters more than
    throughput.
    """
    cfg = default_nerf_config()
    cfg["encoding"] = {"otype": "Frequency", "n_frequencies": 10}
    cfg["network"] = {
        "otype": "CutlassMLP",
        "activation": "ReLU",
        "output_activation": "None",
        "n_neurons": 256,
        "n_hidden_layers": 4,
    }
    cfg["optimizer"]["nested"]["nested"]["learning_rate"] = 5e-3
    return cfg


def default_image_config() -> ConfigDict:
    return ConfigDict(
        {
            "loss": {"otype": "L2"},
            "optimizer": {
                "otype": "ExponentialDecay",
                "decay_start": 20000,
                "decay_interval": 10000,
                "decay_base": 0.33,
                "nested": {
                    "otype": "Adam",
                    "learning_rate": 1e-2,
                    "beta1": 0.9,
                    "beta2": 0.99,
                    "epsilon": 1e-15,
                    "l2_reg": 1e-6,
                },
            },
            "encoding": {
                "otype": "HashGrid",
                "n_levels": 16,
                "n_features_per_level": 2,
                "log2_hashmap_size": 24,
                "base_resolution": 16,
            },
            "network": {
                "otype": "FullyFusedMLP",
                "activation": "ReLU",
                "output_activation": "None",
                "n_neurons": 64,
                "n_hidden_layers": 2,
            },
        }
    )


def default_sdf_config() -> ConfigDict:
    cfg = default_image_config()
    cfg["loss"] = {"otype": "Mape"}
    cfg["encoding"]["log2_hashmap_size"] = 19
    return cfg


def default_volume_config() -> ConfigDict:
    cfg = default_image_config()
    cfg["loss"] = {"otype": "L2"}
    cfg["encoding"]["log2_hashmap_size"] = 19
    return cfg
