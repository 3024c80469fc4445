"""Mesh refinement against the density field.

Counterpart of ``nerfshop_tpu/geometry/mesh_opt.py``: marching-tets
vertices are a trainable buffer, stepped with Adam so that each vertex

* lands on the target iso-surface (density term: ½·(σ(v) − thresh)²),
* stays smooth (½·|v − mean(1-ring)|², the Laplacian term),
* optionally inflates along the outward normal (a constant force).

The vertices stay on the testbed's device for all steps. The density term's
gradient is autograd through ``density_fn``, whose hash-grid encode takes
its position gradient from kernel F on the card; the 1-ring mean is a
gather over a fixed-fanout neighbour table, the vertex normals an
``index_add_``, and Adam the JAX module's hand update with its constants.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from nerfshop_tpu_torch.geometry.mesh_io import TriMesh


def build_neighbor_table(faces: np.ndarray, n_vertices: int) -> Tuple[np.ndarray, np.ndarray]:
    """Undirected 1-ring adjacency as a fixed-fanout table → (neighbors
    [V, D] int32, each row's neighbours ascending and padded with the
    vertex's own index; counts [V] float32, at least 1). The same sets as
    JAX's table, which lists them in set order; vectorized."""
    f = np.asarray(faces, np.int64).reshape(-1, 3)
    src = np.concatenate([f[:, 0], f[:, 1], f[:, 1], f[:, 2], f[:, 2], f[:, 0]])
    dst = np.concatenate([f[:, 1], f[:, 0], f[:, 2], f[:, 1], f[:, 0], f[:, 2]])
    pairs = np.unique(src * n_vertices + dst)
    a, b = pairs // n_vertices, pairs % n_vertices
    deg = np.bincount(a, minlength=n_vertices)
    width = max(int(deg.max()) if deg.size else 0, 1)
    nbr = np.repeat(np.arange(n_vertices, dtype=np.int32)[:, None], width, axis=1)
    start = np.concatenate([[0], np.cumsum(deg)[:-1]])
    nbr[a, np.arange(len(a)) - start[a]] = b
    cnt = np.maximum(deg, 1).astype(np.float32)
    return nbr, cnt


def vertex_normals(v: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted vertex normals [V, 3] of ``v`` [V, 3] and ``faces`` [F, 3] int64."""
    fn = torch.linalg.cross(v[faces[:, 1]] - v[faces[:, 0]], v[faces[:, 2]] - v[faces[:, 0]])
    n = torch.zeros_like(v)
    for k in range(3):
        n.index_add_(0, faces[:, k], fn)
    return n / (torch.linalg.vector_norm(n, dim=-1, keepdim=True) + 1e-20)


def optimize_mesh(
    density_fn: Callable[[torch.Tensor], torch.Tensor],  # [N, 3] world → σ [N]
    mesh: TriMesh,
    n_steps: int = 100,
    thresh: float = 2.5,
    density_amount: float = 0.001,
    smooth_amount: float = 4.0,
    inflate_amount: float = 0.0,
    learning_rate: float = 1e-4,
    device=None,
) -> TriMesh:
    """Refine ``mesh``'s vertices in place against the density iso-surface,
    on ``device`` (the CPU when None), with JAX's defaults and Adam
    constants. ``density_fn`` must be differentiable in its positions."""
    if mesh.n_vertices == 0 or n_steps <= 0:
        return mesh
    dev = torch.device(device) if device is not None else torch.device("cpu")
    nbr_np, cnt_np = build_neighbor_table(mesh.faces, mesh.n_vertices)
    nbr = torch.as_tensor(nbr_np, dtype=torch.int64, device=dev)
    cnt = torch.as_tensor(cnt_np, device=dev)
    pad_mask = (nbr != torch.arange(mesh.n_vertices, device=dev)[:, None]).to(torch.float32)
    faces = torch.as_tensor(np.asarray(mesh.faces), dtype=torch.int64, device=dev)

    def loss(v):
        sig = density_fn(v)
        l_density = 0.5 * torch.mean((sig - thresh) ** 2) * density_amount
        ring = torch.sum(v[nbr] * pad_mask[..., None], dim=1) / cnt[:, None]
        l_smooth = 0.5 * torch.mean(torch.sum((v - ring) ** 2, dim=-1)) * smooth_amount
        return l_density + l_smooth

    v = torch.as_tensor(np.asarray(mesh.vertices, np.float32), device=dev)
    m = torch.zeros_like(v)
    s = torch.zeros_like(v)
    for t in range(1, n_steps + 1):
        with torch.enable_grad():
            vg = v.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(loss(vg), vg)
        with torch.no_grad():
            if inflate_amount:
                g = g - vertex_normals(v, faces) * inflate_amount
            m = 0.9 * m + 0.1 * g
            s = 0.99 * s + 0.01 * g * g
            mh = m / (1.0 - 0.9**t)
            sh = s / (1.0 - 0.99**t)
            v = v - learning_rate * mh / (torch.sqrt(sh) + 1e-8)
    mesh.vertices = v.cpu().numpy().astype(np.float32)
    return mesh
