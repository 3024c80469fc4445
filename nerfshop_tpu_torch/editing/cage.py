"""Cage: the closed coarse triangle mesh that drives a deformation.

Counterpart of ``nerfshop_tpu/editing/cage.py``. Host numpy state; the MVC
weights are computed on the given device (:mod:`.mvc`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from nerfshop_tpu_torch.editing import mvc as mvc_lib
from nerfshop_tpu_torch.geometry.mesh_io import TriMesh


@dataclass
class Cage:
    vertices_original: np.ndarray  # [V, 3]
    vertices_deformed: np.ndarray  # [V, 3]
    faces: np.ndarray  # [F, 3]

    @staticmethod
    def from_mesh(mesh: TriMesh) -> "Cage":
        v = np.asarray(mesh.vertices, np.float32)
        return Cage(v.copy(), v.copy(), np.asarray(mesh.faces, np.int32))

    @property
    def n_vertices(self) -> int:
        return len(self.vertices_original)

    def reset(self) -> None:
        self.vertices_deformed = self.vertices_original.copy()

    def translate(self, offset, vertex_mask: Optional[np.ndarray] = None) -> None:
        if vertex_mask is None:
            self.vertices_deformed = self.vertices_deformed + np.asarray(offset, np.float32)
        else:
            self.vertices_deformed[vertex_mask] += np.asarray(offset, np.float32)

    def transform(self, matrix3x4: np.ndarray, vertex_mask: Optional[np.ndarray] = None) -> None:
        m = np.asarray(matrix3x4, np.float32)
        v = self.vertices_deformed if vertex_mask is None else self.vertices_deformed[vertex_mask]
        out = v @ m[:, :3].T + m[:, 3]
        if vertex_mask is None:
            self.vertices_deformed = out
        else:
            self.vertices_deformed[vertex_mask] = out

    def compute_mvc(self, points: np.ndarray, device: torch.device, gamma: float = 1.0) -> np.ndarray:
        """MVC weights [P, V] of ``points`` w.r.t. the original cage,
        computed on ``device``."""

        def t(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

        w = mvc_lib.mvc_gamma_weights(
            t(points, torch.float32), t(self.vertices_original, torch.float32), t(self.faces, torch.int64), gamma=gamma
        )
        return w.cpu().numpy()

    def interpolate_deformed(self, weights: np.ndarray) -> np.ndarray:
        """weights [P, V] → deformed positions [P, 3]."""
        return np.asarray(weights, np.float32) @ self.vertices_deformed

    def to_json(self) -> dict:
        return {
            "vertices_original": self.vertices_original.tolist(),
            "vertices_deformed": self.vertices_deformed.tolist(),
            "faces": self.faces.tolist(),
        }

    @staticmethod
    def from_json(d: dict) -> "Cage":
        return Cage(
            np.asarray(d["vertices_original"], np.float32),
            np.asarray(d["vertices_deformed"], np.float32),
            np.asarray(d["faces"], np.int32),
        )
