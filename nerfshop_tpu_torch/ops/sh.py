"""Real spherical harmonics of degree 2 (9 coefficients): the basis, its
evaluation, the Monte-Carlo projection and stratified sphere directions.

Counterpart of ``nerfshop_tpu/ops/sh.py``, used by the membrane correction
(``editing/poisson.py``). An SH9 colour field is [..., 9, C].
"""

from __future__ import annotations

import math

import torch

# normalization constants of the real SH basis l ≤ 2
_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, 1.0925484305920792, 0.31539156525252005, 1.0925484305920792, 0.5462742152960396)


def sh9_basis(direction: torch.Tensor) -> torch.Tensor:
    """Unit directions [..., 3] → basis values [..., 9]."""
    x, y, z = direction[..., 0], direction[..., 1], direction[..., 2]
    return torch.stack(
        [
            torch.full_like(x, _C0),
            -_C1 * y,
            _C1 * z,
            -_C1 * x,
            _C2[0] * x * y,
            -_C2[1] * y * z,
            _C2[2] * (3.0 * z * z - 1.0),
            -_C2[3] * x * z,
            _C2[4] * (x * x - y * y),
        ],
        dim=-1,
    )


def evaluate_sh9(coeffs: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """coeffs [..., 9, C], direction [..., 3] → [..., C]."""
    return torch.einsum("...k,...kc->...c", sh9_basis(direction), coeffs)


def project_sh9(directions: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Monte-Carlo projection of values [..., N, C] taken at directions
    [N, 3] (uniform on the sphere) → coefficients [..., 9, C]:
    ⟨f, Y_k⟩ ≈ 4π/N Σ f(ω_i) Y_k(ω_i)."""
    n = directions.shape[0]
    return (4.0 * math.pi / n) * torch.einsum("nk,...nc->...kc", sh9_basis(directions), values)


def stratified_sphere_directions_from(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Stratified directions on S² from two [n_theta, n_phi] arrays of
    uniforms in [0, 1) → [n_theta·n_phi, 3]: cell (i, j) of the (z, φ)
    stratification takes the point (i + u_ij) / n_theta, (j + v_ij) / n_phi."""
    n_theta, n_phi = u.shape
    uu = (torch.arange(n_theta, device=u.device, dtype=u.dtype)[:, None] + u) / n_theta
    vv = (torch.arange(n_phi, device=v.device, dtype=v.dtype)[None, :] + v) / n_phi
    z = 1.0 - 2.0 * uu.reshape(-1)
    phi = 2.0 * math.pi * vv.reshape(-1)
    s = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    return torch.stack([s * torch.cos(phi), s * torch.sin(phi), z], dim=-1)


def stratified_sphere_directions(
    generator: torch.Generator, n_theta: int = 10, n_phi: int = 10, device=None
) -> torch.Tensor:
    """Stratified uniform directions on S² (a 10×10 stratification for the
    membrane's boundary sampling), drawn from ``generator`` on ``device``
    (the generator's own device when None)."""
    dev = generator.device if device is None else device
    u = torch.rand((n_theta, n_phi), generator=generator, device=dev)
    v = torch.rand((n_theta, n_phi), generator=generator, device=dev)
    return stratified_sphere_directions_from(u, v)
