"""Membrane (Poisson) seam correction for cage edits.

Counterpart of ``nerfshop_tpu/editing/poisson.py``. The field's rgb and σ
are sampled over a sphere of directions at every cage vertex: at its
original position (the content being moved, ``inside``) and at its
deformed position (the scene around the new location, ``outside``).
Radiance is projected to SH9 per vertex, the values go to the tet vertices
by γ-sharpened MVC, and at render time each in-target sample gets the
barycentric interpolation of its tet's corners:

* per tet vertex: sh = Σⱼ γMVCⱼ·α_outⱼ·(SH_outⱼ − min(α_inⱼ/α_outⱼ, 1)·SH_inⱼ)
  / (Σⱼ γMVCⱼ·α_outⱼ + 1e−6), with α = 1 − exp(−σ·Δmin); the outside
  density Σⱼ γMVCⱼ·σ_outⱼ; the residual density max(Σⱼ γMVCⱼ·(σ_outⱼ −
  σ_inⱼ), 0);
* per sample: the outside density (× amplitude) gates the blend and weights
  the colour mix, the residual density (× amplitude) bounds the σ clamp,
  and the colour is eval_sh9(sh, dir′) (``render/renderer.py``).

The draws are inputs: :func:`sample_boundary_at` and
:func:`compute_membrane` take their sphere directions, which
:func:`membrane_directions` draws from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from nerfshop_tpu_torch.common import MIN_CONE_STEPSIZE
from nerfshop_tpu_torch.editing import mvc as mvc_lib
from nerfshop_tpu_torch.models.nerf_network import forward_with
from nerfshop_tpu_torch.ops import coords, march
from nerfshop_tpu_torch.ops import sh as sh_lib

#: floats of a packed membrane row: ρ₀..₃, o₀..₃, the 27 (coefficient,
#: channel) pairs × 4 corners, 4 of padding (30 float4s)
PACKED_WIDTH = 120


class MembraneData(NamedTuple):
    """Per-tet-corner membrane values that the render warp reads."""

    density: torch.Tensor  # [Nt, 4] residual density max(σ_out − σ_in, 0)
    outside_density: torch.Tensor  # [Nt, 4] receiving-scene density σ_out
    sh: torch.Tensor  # [Nt, 4, 9, 3] α-weighted SH correction
    amplitude: float  # the user's slider
    #: kernel E's form (:func:`pack_membrane`), [Nt, 120] f32; it lives on
    #: the membrane, not on the operator, because an operator takes its
    #: membrane by ``_replace``, which rebuilds nothing
    packed: Optional[torch.Tensor] = None

    @staticmethod
    def create(density, outside_density, sh, amplitude: float) -> "MembraneData":
        """The membrane of these arrays (one device), with its packed form."""
        m = MembraneData(density, outside_density, sh, float(amplitude))
        return m._replace(packed=pack_membrane(m))


def pack_membrane(m: MembraneData) -> torch.Tensor:
    """[Nt, 120] f32 rows: ρ₀..₃, o₀..₃, then for each of the 27 (SH
    coefficient j, channel c) pairs, in the order j·3 + c, the 4 corners'
    values, then 4 zeros."""
    nt = m.density.shape[0]
    sh = m.sh.reshape(nt, 4, 27).transpose(1, 2).reshape(nt, 108)
    return torch.cat([m.density, m.outside_density, sh, m.density.new_zeros((nt, 4))], dim=1).float().contiguous()


def membrane_directions(generator: torch.Generator, n_dirs: int = 100, device=None):
    """(inside, outside) sphere directions of :func:`compute_membrane`, each
    a 10 × (n_dirs // 10) stratification drawn from ``generator``."""
    return tuple(
        sh_lib.stratified_sphere_directions(generator, 10, max(n_dirs // 10, 1), device) for _ in range(2)
    )


@torch.no_grad()
def sample_boundary_at(model, params, centers: torch.Tensor, aabb, dirs: torch.Tensor, radius: float = 0.0):
    """Query the field around each centre [V, 3] (world) over the directions
    ``dirs`` [D, 3] → (SH9 radiance [V, 9, 3], mean density [V]).
    ``params`` is a state dict of ``model`` or None for its own."""
    V, D = centers.shape[0], dirs.shape[0]
    pos = centers[:, None, :] + radius * dirs[None, :, :]  # [V, D, 3]
    pos_w = torch.clamp(coords.warp_position(pos.reshape(-1, 3), aabb), 0.0, 1.0)
    dir_w = coords.warp_direction(dirs.repeat(V, 1))
    rgb, sigma = forward_with(model, params, pos_w, dir_w)
    return sh_lib.project_sh9(dirs, rgb.reshape(V, D, 3)), sigma.reshape(V, D).mean(dim=1)


def _occupied_at(grid, pos: torch.Tensor) -> torch.Tensor:
    """World positions [N, 3] → bool occupancy at the finest covering
    cascade (through the march's cell index)."""
    n = pos.shape[0]
    z = pos.new_zeros((n, 1))
    flat = march._candidate_cells(pos, torch.zeros_like(pos), z, z, grid.occupancy.shape[0])
    return grid.occupancy.reshape(-1)[flat[:, 0]]


@torch.no_grad()
def compute_membrane(
    model,
    params,
    cage,
    tet_mesh,
    aabb,
    directions: Tuple[torch.Tensor, torch.Tensor],
    gamma: float = 4.0,
    amplitude: float = 1.0,
    grid=None,
) -> MembraneData:
    """The membrane of the current cage deformation, on the device of
    ``aabb``. ``directions``: the (inside, outside) sphere directions.
    ``grid``: an OccupancyGrid; where it is empty at a cage vertex, that
    vertex's inside density is 0, so stray fog does not fake a content
    boundary."""
    dev = aabb.min.device

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    cv_orig, cv_def = t(cage.vertices_original), t(cage.vertices_deformed)
    dirs_in, dirs_out = (d.to(dev) for d in directions)
    sh_in, dens_in = sample_boundary_at(model, params, cv_orig, aabb, dirs_in)
    sh_out, dens_out = sample_boundary_at(model, params, cv_def, aabb, dirs_out)
    if grid is not None:
        dens_in = torch.where(_occupied_at(grid, cv_orig), dens_in, torch.zeros_like(dens_in))

    # per cage vertex, the outside takes the lead: the inside term is
    # scaled by min(α_in / α_out, 1)
    a_out = 1.0 - torch.exp(-dens_out * MIN_CONE_STEPSIZE)
    a_in = 1.0 - torch.exp(-dens_in * MIN_CONE_STEPSIZE)
    w_inside = torch.clamp_max(a_in / torch.clamp_min(a_out, 1e-9), 1.0)
    sh_diff = sh_out - w_inside[:, None, None] * sh_in  # [V, 9, 3]

    # γ-MVC of the cage-vertex values onto the tet vertices
    w = mvc_lib.mvc_gamma_weights(t(tet_mesh.vertices_original), cv_orig, t(cage.faces, torch.int64), gamma=gamma)
    denom = w @ a_out + 1e-6  # [T]
    sh_tet = torch.einsum("tv,v,vkc->tkc", w, a_out, sh_diff) / denom[:, None, None]
    out_d_v = w @ dens_out
    resid_d_v = torch.clamp_min(w @ (dens_out - dens_in), 0.0)

    tets = t(tet_mesh.tets, torch.int64)
    return MembraneData.create(resid_d_v[tets], out_d_v[tets], sh_tet[tets], amplitude)


def membrane_residuals_at(
    membrane: MembraneData,
    tet: torch.Tensor,  # [N] containing tet ids
    bary: torch.Tensor,  # [N, 4]
    in_target: torch.Tensor,  # [N] bool
    direction: torch.Tensor,  # [N, 3] warped view directions (canonical space)
):
    """→ (residual σ [N], outside σ [N], residual rgb [N, 3]) of each sample
    in the deformed region, zero elsewhere; both densities × amplitude.
    The plain form (per-tet row takes and sums), on any device."""
    t = tet.long()
    resid_sigma = (bary * membrane.density[t]).sum(dim=1)
    outside_sigma = (bary * membrane.outside_density[t]).sum(dim=1)
    msh = membrane.sh.reshape(membrane.sh.shape[0], 4, 27)
    sh27 = sum(bary[:, k : k + 1] * msh[:, k, :][t] for k in range(4))
    basis = sh_lib.sh9_basis(direction)  # [N, 9]
    resid_rgb = torch.stack([(basis * sh27[:, c::3]).sum(dim=1) for c in range(3)], dim=-1)
    amp = membrane.amplitude
    z = torch.zeros_like(resid_sigma)
    return (
        torch.where(in_target, resid_sigma * amp, z),
        torch.where(in_target, outside_sigma * amp, z),
        torch.where(in_target[:, None], resid_rgb, torch.zeros_like(resid_rgb)),
    )
