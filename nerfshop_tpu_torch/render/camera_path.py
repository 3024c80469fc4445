"""Camera paths: keyframed fly-throughs (reference: camera_path.h:30-92,
src/camera_path.cu — spline keyframes of {orientation quaternion, position,
fov, depth-of-field}, JSON save/load, video rendering driver).

Interpolation: spherical-linear rotations + Catmull-Rom positions (the
reference uses the same cubic-through-keyframes feel).

The port's own copy of ``nerfshop_tpu/render/camera_path.py`` (host numpy);
``render_video_frames`` drives the port's ``Testbed.render``."""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import List

import numpy as np


def mat_to_quat(m: np.ndarray) -> np.ndarray:
    """[3,3] rotation → quaternion (w, x, y, z)."""
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 1e-12)) * 2
    q = np.zeros(4)
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    return q


def quat_to_mat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:
        q = q0 + t * (q1 - q0)
        return q / np.linalg.norm(q)
    th = np.arccos(np.clip(d, -1, 1))
    return (np.sin((1 - t) * th) * q0 + np.sin(t * th) * q1) / np.sin(th)


def catmull_rom(p0, p1, p2, p3, t: float) -> np.ndarray:
    t2, t3 = t * t, t * t * t
    return 0.5 * (
        (2 * p1) + (-p0 + p2) * t + (2 * p0 - 5 * p1 + 4 * p2 - p3) * t2 + (-p0 + 3 * p1 - 3 * p2 + p3) * t3
    )


@dataclass
class Keyframe:
    quat: np.ndarray  # [4] (w,x,y,z)
    position: np.ndarray  # [3]
    fov_deg: float = 50.0
    aperture: float = 0.0
    timestamp: float = 0.0

    @staticmethod
    def from_camera_matrix(m: np.ndarray, fov_deg: float = 50.0, aperture: float = 0.0) -> "Keyframe":
        m = np.asarray(m, np.float64)
        return Keyframe(mat_to_quat(m[:3, :3]), m[:3, 3].copy(), fov_deg, aperture)

    def camera_matrix(self) -> np.ndarray:
        return np.concatenate([quat_to_mat(self.quat), self.position[:, None]], 1).astype(np.float32)


@dataclass
class CameraPath:
    keyframes: List[Keyframe] = field(default_factory=list)
    loop: bool = False

    def add_camera(self, camera_matrix: np.ndarray, fov_deg: float = 50.0, aperture: float = 0.0) -> None:
        self.keyframes.append(Keyframe.from_camera_matrix(camera_matrix, fov_deg, aperture))

    def eval(self, u: float) -> Keyframe:
        """u ∈ [0,1] along the whole path → interpolated keyframe."""
        kf = self.keyframes
        n = len(kf)
        assert n >= 1
        if n == 1:
            return kf[0]
        segs = n if self.loop else n - 1
        s = np.clip(u, 0.0, 1.0) * segs
        i = min(int(s), segs - 1)
        t = s - i

        def at(j):
            return kf[j % n] if self.loop else kf[int(np.clip(j, 0, n - 1))]

        k0, k1, k2, k3 = at(i - 1), at(i), at(i + 1), at(i + 2)
        pos = catmull_rom(k0.position, k1.position, k2.position, k3.position, t)
        quat = slerp(k1.quat, k2.quat, t)
        fov = (1 - t) * k1.fov_deg + t * k2.fov_deg
        ap = (1 - t) * k1.aperture + t * k2.aperture
        return Keyframe(quat, pos, fov, ap)

    def save(self, path: str | Path) -> None:
        Path(path).write_text(
            json.dumps(
                {
                    "loop": self.loop,
                    "path": [
                        {
                            "R": k.quat.tolist(),
                            "T": k.position.tolist(),
                            "fov": k.fov_deg,
                            "aperture_size": k.aperture,
                        }
                        for k in self.keyframes
                    ],
                }
            )
        )

    @staticmethod
    def load(path: str | Path) -> "CameraPath":
        d = json.loads(Path(path).read_text())
        cp = CameraPath(loop=d.get("loop", False))
        for k in d.get("path", []):
            cp.keyframes.append(
                Keyframe(
                    np.asarray(k["R"], np.float64),
                    np.asarray(k["T"], np.float64),
                    k.get("fov", 50.0),
                    k.get("aperture_size", 0.0),
                )
            )
        return cp


def render_video_frames(testbed, path: CameraPath, n_frames: int, width: int, height: int, spp: int = 4):
    """Yield rendered frames along the path (the run.py --video driver)."""
    for i in range(n_frames):
        kf = path.eval(i / max(n_frames - 1, 1))
        testbed.fov_deg = kf.fov_deg
        yield testbed.render(width, height, spp=spp, camera_matrix=kf.camera_matrix())
