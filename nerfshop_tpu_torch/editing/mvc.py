"""Mean value coordinates for closed triangle meshes (Ju, Schaefer, Warren
2005), the interpolation core of the cage deformation.

Counterpart of ``nerfshop_tpu/editing/mvc.py``: batched ``[P, F]`` math on
the device of the inputs, with the same sign-preserving division (a concave
cage sees some triangles back-facing), the same on-triangle and on-vertex
cases and the same γ-sharpened variant, and the interpolation of cage
attributes by the weights.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-10


def mvc_weights(points: torch.Tensor, cage_v: torch.Tensor, cage_f: torch.Tensor) -> torch.Tensor:
    """points [P, 3], cage_v [V, 3], cage_f [F, 3] (one device) → weights
    [P, V], normalized (partition of unity, linear precision inside)."""
    P, V = points.shape[0], cage_v.shape[0]
    tri = cage_f.long()
    d = cage_v[None, :, :] - points[:, None, :]  # [P, V, 3]
    r = torch.linalg.norm(d, dim=-1)  # [P, V]
    r_safe = torch.clamp_min(r, _EPS)
    u = d / r_safe[..., None]

    u0, u1, u2 = u[:, tri[:, 0]], u[:, tri[:, 1]], u[:, tri[:, 2]]  # [P, F, 3]
    r0, r1, r2 = r_safe[:, tri[:, 0]], r_safe[:, tri[:, 1]], r_safe[:, tri[:, 2]]

    # edge lengths on the unit sphere → arc angles
    def arc(a, b):
        return 2.0 * torch.arcsin(torch.clamp(torch.linalg.norm(a - b, dim=-1) / 2, 0.0, 1.0))

    th0, th1, th2 = arc(u1, u2), arc(u2, u0), arc(u0, u1)
    h = (th0 + th1 + th2) / 2
    sin_h = torch.sin(h)

    def cos_term(tha, thb, thc):
        c = 2 * sin_h * torch.sin(h - tha) / torch.clamp_min(torch.sin(thb) * torch.sin(thc), _EPS) - 1
        return torch.clamp(c, -1.0, 1.0)

    c0, c1, c2 = cos_term(th0, th1, th2), cos_term(th1, th2, th0), cos_term(th2, th0, th1)

    det = (u0 * torch.linalg.cross(u1, u2, dim=-1)).sum(-1)
    sgn = torch.sign(det)
    s0 = sgn * torch.sqrt(torch.clamp_min(1 - c0 * c0, 0.0))
    s1 = sgn * torch.sqrt(torch.clamp_min(1 - c1 * c1, 0.0))
    s2 = sgn * torch.sqrt(torch.clamp_min(1 - c2 * c2, 0.0))

    # x in the triangle's plane but outside the triangle → contribution 0
    coplanar_out = (s0.abs() <= 1e-6) | (s1.abs() <= 1e-6) | (s2.abs() <= 1e-6)

    def safe_div(num, den):
        # sign-preserving: s_i is negative for back-facing triangles, and a
        # denominator clamped to +eps would lose MVC's linear precision there
        mag = torch.clamp_min(den.abs(), _EPS)
        return num / torch.where(den < 0, -mag, mag)

    w0 = safe_div(th0 - c1 * th2 - c2 * th1, r0 * torch.sin(th1) * s2)
    w1 = safe_div(th1 - c2 * th0 - c0 * th2, r1 * torch.sin(th2) * s0)
    w2 = safe_div(th2 - c0 * th1 - c1 * th0, r2 * torch.sin(th0) * s1)

    # x on the triangle → barycentric interpolation of that triangle alone
    on_tri = (math.pi - h) < 1e-5
    b0 = torch.sin(th0) * r1 * r2
    b1 = torch.sin(th1) * r2 * r0
    b2 = torch.sin(th2) * r0 * r1
    zero = torch.zeros((), dtype=points.dtype, device=points.device)
    any_on = on_tri.any(dim=1, keepdim=True)
    w0 = torch.where(on_tri, b0, torch.where(any_on, zero, torch.where(coplanar_out, zero, w0)))
    w1 = torch.where(on_tri, b1, torch.where(any_on, zero, torch.where(coplanar_out, zero, w1)))
    w2 = torch.where(on_tri, b2, torch.where(any_on, zero, torch.where(coplanar_out, zero, w2)))

    # per-vertex sums over triangle corners
    weights = torch.zeros((P, V), dtype=points.dtype, device=points.device)
    weights.index_add_(1, tri[:, 0], w0)
    weights.index_add_(1, tri[:, 1], w1)
    weights.index_add_(1, tri[:, 2], w2)

    # x on a cage vertex → weight δ
    on_vertex = r < 1e-7
    weights = torch.where(on_vertex.any(dim=1, keepdim=True), on_vertex.to(points.dtype), weights)
    total = weights.sum(dim=1, keepdim=True)
    return weights / torch.where(total.abs() < _EPS, torch.ones_like(total), total)


def mvc_gamma_weights(points, cage_v, cage_f, gamma: float = 1.0) -> torch.Tensor:
    """γ-sharpened MVC: sign(w)·|w|^γ, renormalized (γ > 1 localizes the
    interpolation near the closest cage vertices)."""
    w = mvc_weights(points, cage_v, cage_f)
    if gamma == 1.0:
        return w
    wg = torch.sign(w) * w.abs() ** gamma
    total = wg.sum(dim=1, keepdim=True)
    return wg / torch.where(total.abs() < _EPS, torch.ones_like(total), total)


def interpolate_with_mvc(weights: torch.Tensor, cage_values: torch.Tensor) -> torch.Tensor:
    """[P, V] weights × [V, D] cage attributes (positions, SH, …) → [P, D]."""
    return weights @ cage_values
