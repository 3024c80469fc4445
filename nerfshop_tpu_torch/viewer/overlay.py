"""Debug-draw overlays for the web viewer.

Counterpart of ``nerfshop_tpu/viewer/overlay.py``, which has no JAX in it;
the port keeps its own copy. The reference draws GL helper geometry over
the frame: training-camera frusta, the unit-cube wireframe, and the editing
cage and selection points. Here world-space segments and points are
projected through the current pinhole camera and rasterized into the
rendered RGBA frame on the host: a few hundred segments, so numpy line
drawing is enough.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np


def _project(points: np.ndarray, camera: np.ndarray, focal: np.ndarray,
             wh: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """World points [N,3] → (pixel xy [N,2], z>0 mask). Camera is the ngp
    [3,4] cam-to-world with columns right/down/forward."""
    W, H = wh
    rel = points - camera[:, 3]
    cam_pts = rel @ camera[:, :3]  # world→camera (orthonormal columns)
    z = cam_pts[:, 2]
    ok = z > 1e-6
    zs = np.where(ok, z, 1.0)
    x = cam_pts[:, 0] / zs * focal[0] + 0.5 * W
    y = cam_pts[:, 1] / zs * focal[1] + 0.5 * H
    return np.stack([x, y], -1), ok


def draw_segments(
    img: np.ndarray,  # [H, W, 4] float32, modified in place
    segments: np.ndarray,  # [S, 2, 3] world-space endpoints
    camera: np.ndarray,  # [3, 4]
    focal: np.ndarray,  # [2]
    color=(1.0, 0.2, 0.2, 1.0),
) -> np.ndarray:
    H, W = img.shape[:2]
    if len(segments) == 0:
        return img
    p, ok = _project(segments.reshape(-1, 3), camera, focal, (W, H))
    p = p.reshape(-1, 2, 2)
    ok = ok.reshape(-1, 2).all(-1)
    col = np.asarray(color, np.float32)
    for (a, b) in p[ok]:
        n = int(max(abs(b[0] - a[0]), abs(b[1] - a[1]))) + 1
        n = min(n, 4 * max(W, H))  # clamp runaway off-screen segments
        t = np.linspace(0.0, 1.0, n)
        xs = np.round(a[0] + (b[0] - a[0]) * t).astype(np.int64)
        ys = np.round(a[1] + (b[1] - a[1]) * t).astype(np.int64)
        keep = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
        img[ys[keep], xs[keep]] = col
    return img


def draw_points(
    img: np.ndarray,
    points: np.ndarray,  # [N, 3]
    camera: np.ndarray,
    focal: np.ndarray,
    color=(0.2, 1.0, 0.2, 1.0),
    radius: int = 1,
) -> np.ndarray:
    H, W = img.shape[:2]
    if len(points) == 0:
        return img
    p, ok = _project(np.asarray(points, np.float32), camera, focal, (W, H))
    col = np.asarray(color, np.float32)
    for (x, y) in p[ok]:
        xi, yi = int(round(x)), int(round(y))
        x0, x1 = max(xi - radius, 0), min(xi + radius + 1, W)
        y0, y1 = max(yi - radius, 0), min(yi + radius + 1, H)
        if x0 < x1 and y0 < y1:
            img[y0:y1, x0:x1] = col
    return img


def unit_cube_segments(lo=(0.0, 0.0, 0.0), hi=(1.0, 1.0, 1.0)) -> np.ndarray:
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    c = np.array([[lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]],
                  [lo[0], hi[1], lo[2]], [hi[0], hi[1], lo[2]],
                  [lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]],
                  [lo[0], hi[1], hi[2]], [hi[0], hi[1], hi[2]]], np.float32)
    e = [(0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7),
         (0, 4), (1, 5), (2, 6), (3, 7)]
    return np.stack([c[list(p)] for p in e])


def camera_frustum_segments(xform: np.ndarray, focal_ratio: float = 1.2,
                            size: float = 0.05) -> np.ndarray:
    """Wireframe pyramid for one training camera ([3,4] ngp pose)."""
    o = xform[:, 3]
    r, d, f = xform[:, 0], xform[:, 1], xform[:, 2]
    half = size / focal_ratio
    corners = [o + (f * size + sx * r * half + sy * d * half)
               for sx in (-1, 1) for sy in (-1, 1)]
    segs = []
    for cpt in corners:
        segs.append(np.stack([o, cpt]))
    order = [0, 1, 3, 2, 0]
    for i in range(4):
        segs.append(np.stack([corners[order[i]], corners[order[i + 1]]]))
    return np.stack(segs).astype(np.float32)


def mesh_segments(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Unique wireframe edges of a triangle mesh (cage debug draw)."""
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    e = np.unique(np.sort(e, 1), axis=0)
    return vertices[e].astype(np.float32)


def apply_overlays(
    img: np.ndarray,
    testbed,
    camera: np.ndarray,
    focal: np.ndarray,
    visualize_cameras: bool = False,
    visualize_unit_cube: bool = False,
    visualize_cage: bool = False,
) -> np.ndarray:
    """Draw the requested debug layers over a rendered frame."""
    img = np.ascontiguousarray(img, np.float32)
    if visualize_unit_cube:
        draw_segments(img, unit_cube_segments(), camera, focal, (0.4, 0.6, 1.0, 1.0))
    if visualize_cameras and getattr(testbed, "_dataset", None) is not None:
        for xf in np.asarray(testbed._dataset.xforms):
            draw_segments(img, camera_frustum_segments(xf), camera, focal, (1.0, 0.8, 0.2, 1.0))
    if visualize_cage:
        gs = getattr(testbed, "_growing_selection", None) or getattr(testbed, "_gs", None)
        cage = getattr(gs, "cage", None) if gs is not None else None
        if cage is not None and getattr(cage, "n_vertices", 0):
            # deformed cage in red, original in dim red
            draw_segments(img, mesh_segments(cage.vertices_original, cage.faces),
                          camera, focal, (0.5, 0.15, 0.15, 1.0))
            draw_segments(img, mesh_segments(cage.vertices_deformed, cage.faces),
                          camera, focal, (1.0, 0.2, 0.2, 1.0))
        elif gs is not None and getattr(gs, "proxy_cage", None) is not None:
            pc = gs.proxy_cage
            draw_segments(img, mesh_segments(pc.vertices, pc.faces), camera, focal,
                          (1.0, 0.5, 0.2, 1.0))
        pts = getattr(gs, "projected_points", None) if gs is not None else None
        if pts is not None and len(pts):
            draw_points(img, np.asarray(pts), camera, focal)
    return img
