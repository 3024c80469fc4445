"""NeRF dataset ingestion (transforms.json).

Feature parity with the reference loader (src/nerf_loader.cu:164-727,
include/neural-graphics-primitives/nerf_loader.h:38-132):

* multi-json merge (train/val/test lists),
* intrinsics: camera_angle_x/y or fl_x/fl_y, principal point cx/cy,
  distortion k1/k2/p1/p2, per-frame overrides,
* scene placement: ``scale`` (default 0.33), ``offset`` (default (.5,.5,.5)),
  ``aabb_scale`` (power of two, 1..128 here),
* nerf→ngp convention change (nerf_loader.h:74-92): negate cols 1,2 of the
  camera-to-world matrix, scale+offset the translation, cycle rows xyz←yzx,
* images decoded to float32 linear RGBA with straight alpha; pixels with
  negative alpha denote masked regions (we track a mask instead),
* per-image sharpness score (variance of Laplacian) for auto-view selection,
* rolling shutter / light-dir / depth extras are parsed but optional.

Host-side, numpy only — images land in one big [N, H, W, 4] array the
training pipeline uploads to device once (or shards across hosts).
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from nerfshop_tpu_torch.config import loads_tolerant
from nerfshop_tpu_torch.data import image_io


@dataclass
class CameraIntrinsics:
    focal: np.ndarray  # [2] fl_x, fl_y in pixels
    principal: np.ndarray  # [2] cx, cy normalized to [0,1]
    distortion: np.ndarray  # [4] k1 k2 p1 p2
    resolution: np.ndarray  # [2] W, H


@dataclass
class NerfDataset:
    images: np.ndarray  # [N, H, W, 4] float32, native color space, straight alpha
    xforms: np.ndarray  # [N, 3, 4] camera-to-world, ngp convention
    intrinsics: List[CameraIntrinsics]
    paths: List[str]
    scale: float = 0.33
    offset: np.ndarray = field(default_factory=lambda: np.array([0.5, 0.5, 0.5], np.float32))
    aabb_scale: int = 1
    from_mitsuba: bool = False
    is_hdr: bool = False
    sharpness: Optional[np.ndarray] = None
    n_extra_learnable_dims: int = 0
    has_light_dirs: bool = False
    light_dirs: Optional[np.ndarray] = None
    rolling_shutter: np.ndarray = field(default_factory=lambda: np.zeros(4, np.float32))
    #: end-of-exposure poses for rolling shutter / motion blur, same shape as
    #: ``xforms`` (per-frame ``transform_matrix_end`` in transforms.json);
    #: None when no frame supplies one
    xforms_end: Optional[np.ndarray] = None
    envmap_path: Optional[str] = None
    #: "srgb" for LDR sources (training happens in sRGB space, matching the
    #: reference's linear_colors=false default, testbed.h:582), "linear" for HDR
    color_space: str = "srgb"

    @property
    def n_images(self) -> int:
        return self.images.shape[0]

    @property
    def resolution(self) -> np.ndarray:
        return np.array([self.images.shape[2], self.images.shape[1]], np.int32)

    def focal_matrix(self) -> np.ndarray:
        return np.stack([c.focal for c in self.intrinsics]).astype(np.float32)

    def principal_matrix(self) -> np.ndarray:
        return np.stack([c.principal for c in self.intrinsics]).astype(np.float32)

    def distortion_matrix(self) -> np.ndarray:
        return np.stack([c.distortion for c in self.intrinsics]).astype(np.float32)


def nerf_matrix_to_ngp(mat: np.ndarray, scale: float, offset: np.ndarray, from_mitsuba: bool = False) -> np.ndarray:
    """[3,4] or [4,4] nerf camera-to-world → [3,4] ngp convention."""
    m = np.array(mat, np.float32)[:3, :4].copy()
    m[:, 1] *= -1
    m[:, 2] *= -1
    m[:, 3] = m[:, 3] * scale + offset
    if from_mitsuba:
        m[:, 0] *= -1
        m[:, 2] *= -1
    else:
        m = m[[1, 2, 0], :]  # cycle rows xyz ← yzx
    return m


def ngp_matrix_to_nerf(m: np.ndarray, scale: float, offset: np.ndarray, from_mitsuba: bool = False) -> np.ndarray:
    m = np.array(m, np.float32)[:3, :4].copy()
    if from_mitsuba:
        m[:, 0] *= -1
        m[:, 2] *= -1
    else:
        m = m[[2, 0, 1], :]  # inverse cycle
    m[:, 1] *= -1
    m[:, 2] *= -1
    m[:, 3] = (m[:, 3] - offset) / scale
    return m


def _intrinsics_from_json(j: dict, frame: dict, W: int, H: int, downscale: int = 1) -> CameraIntrinsics:
    def get(key, default=None):
        return frame.get(key, j.get(key, default))

    # explicit pixel-unit intrinsics from the json are in ORIGINAL pixels;
    # W/H here are post-downscale
    ds = float(downscale)
    if get("fl_x") is not None:
        fl_x = float(get("fl_x")) / ds
    elif get("camera_angle_x") is not None:
        fl_x = 0.5 * W / math.tan(0.5 * float(get("camera_angle_x")))
    else:
        fl_x = 0.5 * W  # 90° fallback
    if get("fl_y") is not None:
        fl_y = float(get("fl_y")) / ds
    elif get("camera_angle_y") is not None:
        fl_y = 0.5 * H / math.tan(0.5 * float(get("camera_angle_y")))
    else:
        fl_y = fl_x
    cx = (float(get("cx")) / ds / W) if get("cx") is not None else 0.5
    cy = (float(get("cy")) / ds / H) if get("cy") is not None else 0.5
    dist = np.array(
        [float(get("k1", 0.0)), float(get("k2", 0.0)), float(get("p1", 0.0)), float(get("p2", 0.0))],
        np.float32,
    )
    return CameraIntrinsics(
        focal=np.array([fl_x, fl_y], np.float32),
        principal=np.array([cx, cy], np.float32),
        distortion=dist,
        resolution=np.array([W, H], np.int32),
    )


def compute_sharpness(img: np.ndarray) -> float:
    """Variance-of-Laplacian sharpness (reference uses the same heuristic)."""
    gray = img[..., :3].mean(-1)
    lap = (
        -4 * gray[1:-1, 1:-1]
        + gray[:-2, 1:-1]
        + gray[2:, 1:-1]
        + gray[1:-1, :-2]
        + gray[1:-1, 2:]
    )
    return float(lap.var() * 1e4)


def load_nerf(
    json_paths: str | Path | Sequence[str | Path],
    sharpen_amount: float = 0.0,
    downscale: int = 1,
    max_images: Optional[int] = None,
    load_images: bool = True,
) -> NerfDataset:
    """Load one or more transforms.json files into a NerfDataset."""
    if isinstance(json_paths, (str, Path)):
        json_paths = [json_paths]
    json_paths = [Path(p) for p in json_paths]

    merged_frames: List[tuple] = []  # (json_dict, base_dir, frame_dict)
    top: dict = {}
    for jp in json_paths:
        j = loads_tolerant(jp.read_text())
        if not top:
            top = j
        for f in j.get("frames", []):
            merged_frames.append((j, jp.parent, f))

    if max_images is not None:
        merged_frames = merged_frames[:max_images]
    if not merged_frames:
        raise ValueError(f"no frames found in {json_paths}")

    scale = float(top.get("scale", 0.33))
    offset = np.asarray(top.get("offset", [0.5, 0.5, 0.5]), np.float32)
    aabb_scale = int(top.get("aabb_scale", 1))
    from_mitsuba = bool(top.get("from_mitsuba", False))
    n_extra = int(top.get("n_extra_learnable_dims", 0))

    def resolve_path(base: Path, fp: str) -> Optional[Path]:
        p = base / fp
        if p.exists():
            return p
        for ext in (".png", ".jpg", ".jpeg", ".exr", ".bin"):
            q = p.with_suffix(ext)
            if q.exists():
                return q
        return None

    def load_frame(item):
        j, base, f = item
        p = resolve_path(base, f["file_path"])
        if p is None and not load_images:
            p = base / f["file_path"]  # poses-only: path need not exist
        if p is None:
            return None
        if not load_images:
            # poses/intrinsics only (converter tooling, camera paths)
            W = int(f.get("w", j.get("w", 2)) or 2)
            H = int(f.get("h", j.get("h", 2)) or 2)
            img = np.zeros((2, 2, 4), np.float32)
            intr = _intrinsics_from_json(j, f, W, H)
            xform = nerf_matrix_to_ngp(
                np.asarray(f["transform_matrix"], np.float32), scale, offset, from_mitsuba
            )
            xf_end = f.get("transform_matrix_end")
            if xf_end is not None:
                xf_end = nerf_matrix_to_ngp(np.asarray(xf_end, np.float32), scale, offset, from_mitsuba)
            return img, xform, intr, str(p), f.get("sharpness"), False, f.get("light_dir"), xf_end
        # keep the file's native color space: LDR stays sRGB (the reference
        # trains directly in sRGB, linear_colors=false), EXR stays linear
        img = image_io.read_image(p, linear=False)
        if img.shape[-1] == 3:
            img = np.concatenate([img, np.ones_like(img[..., :1])], -1)
        elif img.shape[-1] == 1:
            img = np.concatenate([np.repeat(img, 3, -1), np.ones_like(img)], -1)
        if downscale > 1:
            img = img[::downscale, ::downscale]
        H, W = img.shape[:2]
        intr = _intrinsics_from_json(j, f, W, H, downscale)
        xform = nerf_matrix_to_ngp(np.asarray(f["transform_matrix"], np.float32), scale, offset, from_mitsuba)
        sharp = f.get("sharpness", None)
        is_hdr = p.suffix.lower() in (".exr", ".bin")
        light_dir = f.get("light_dir")
        xf_end = f.get("transform_matrix_end")
        if xf_end is not None:
            xf_end = nerf_matrix_to_ngp(np.asarray(xf_end, np.float32), scale, offset, from_mitsuba)
        return img.astype(np.float32), xform, intr, str(p), sharp, is_hdr, light_dir, xf_end

    with cf.ThreadPoolExecutor(max_workers=16) as pool:
        results = [r for r in pool.map(load_frame, merged_frames) if r is not None]
    if not results:
        raise ValueError("no images could be loaded")

    # pad to common resolution? reference requires uniform per-load; enforce it
    shapes = {r[0].shape for r in results}
    if len(shapes) > 1:
        Hmax = max(s[0] for s in shapes)
        Wmax = max(s[1] for s in shapes)
        padded = []
        for img, *rest in results:
            out = np.zeros((Hmax, Wmax, 4), np.float32)
            out[: img.shape[0], : img.shape[1]] = img
            padded.append((out, *rest))
        results = padded

    images = np.stack([r[0] for r in results])
    xforms = np.stack([r[1] for r in results])
    intr = [r[2] for r in results]
    paths = [r[3] for r in results]
    sharpness = np.array(
        [r[4] if r[4] is not None else compute_sharpness(r[0]) for r in results], np.float32
    )
    is_hdr = any(r[5] for r in results)
    light_dirs = None
    has_light_dirs = all(r[6] is not None for r in results) and len(results) > 0 and results[0][6] is not None
    if has_light_dirs:
        light_dirs = np.stack([np.asarray(r[6], np.float32) for r in results])
    # end-of-exposure poses: frames without one default to their start pose
    xforms_end = None
    if any(r[7] is not None for r in results):
        xforms_end = np.stack(
            [r[7] if r[7] is not None else r[1] for r in results]
        ).astype(np.float32)

    return NerfDataset(
        images=images,
        xforms=xforms,
        intrinsics=intr,
        paths=paths,
        scale=scale,
        offset=offset,
        aabb_scale=aabb_scale,
        from_mitsuba=from_mitsuba,
        is_hdr=is_hdr,
        sharpness=sharpness,
        n_extra_learnable_dims=n_extra,
        has_light_dirs=has_light_dirs,
        light_dirs=light_dirs,
        rolling_shutter=np.asarray(top.get("rolling_shutter", [0, 0, 0, 0]), np.float32),
        xforms_end=xforms_end,
        envmap_path=top.get("envmap"),
        color_space="linear" if is_hdr else "srgb",
    )
