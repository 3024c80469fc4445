"""Occupancy-guided ray marching on fixed [R, K] sample slabs.

Counterpart of ``nerfshop_tpu/ops/march.py``: the closed-form step ladder,
the two-stage (coarse 16³ → fine 128³ per cascade) march, rank-based
compaction with ``selection="first"`` (render) and ``"spread"`` (training:
K stratified picks over all occupied candidates, dt scaled by the stride),
the density-grid early stop on precomputed march fields, and the mapping
of samples to network inputs. Sorts run on unique int32 keys (as in JAX),
so ``torch.sort`` yields the same order as ``lax.sort``. The
``take_along_axis`` gathers go through :mod:`~nerfshop_tpu_torch.ops.gather`
(kernel D on a CUDA device). The options that only the windowed
and tiled renderers read (``t_start``, ``n_segments``, ``with_aux`` →
``MarchAux``, ``tau_field``, ``global_t0``, ``intersect_margin``) are not
ported, nor is ``density_grid``: the exact renderer hands the march its
density as ``fine_field``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from nerfshop_tpu_torch.common import GRID_RESOLUTION, MAX_CONE_STEPSIZE, MIN_CONE_STEPSIZE
from nerfshop_tpu_torch.ops import coords
from nerfshop_tpu_torch.ops.coords import BoundingBox
from nerfshop_tpu_torch.ops.gather import take_along

#: coarse-segment length in fine ladder steps
COARSE_STRIDE = 8
#: per-cascade coarse occupancy resolution
COARSE_RES = 16
#: the training spread's largest stride, in occupied candidates a sample
SPREAD_STRIDE_CAP = 4.0


class SampleBatch(NamedTuple):
    t: torch.Tensor  # [R, K] ray parameter at sample start
    dt: torch.Tensor  # [R, K]
    valid: torch.Tensor  # [R, K] bool
    n: torch.Tensor  # [R] int32 number of valid samples


def step_ladder(t0: torch.Tensor, m: torch.Tensor, cone_angle: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed form of the sequential t += clamp(t·cone, dt_min, dt_max)
    recurrence: t0 [R], step indices m [M] or [R, M] → (T, dt) [R, M].

    With cone 0 the thresholds t_a, t_b, m1 and m2 are inf and untaken
    branches hold NaN; every select below keeps them out of T and dt."""
    dev = t0.device
    cone = torch.full((), float(cone_angle), dtype=torch.float32, device=dev)
    eps = 1e-12
    inf = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    t_a = torch.where(cone > 0, MIN_CONE_STEPSIZE / torch.clamp_min(cone, eps), inf)
    t_b = torch.where(cone > 0, MAX_CONE_STEPSIZE / torch.clamp_min(cone, eps), inf)

    m = m.to(torch.float32)
    m = m[None, :] if m.ndim == 1 else m
    t0 = t0[:, None]

    m1 = torch.ceil(torch.clamp_min(t_a - t0, 0.0) / MIN_CONE_STEPSIZE)
    t1 = t0 + m1 * MIN_CONE_STEPSIZE
    g = 1.0 + cone
    logg = torch.log(torch.clamp_min(g, 1.0 + eps))
    m2 = torch.where(
        torch.isfinite(t_b),
        torch.ceil(torch.clamp_min(torch.log(torch.clamp_min(t_b, eps) / torch.clamp_min(t1, eps)), 0.0) / logg),
        inf,
    )
    t2 = t1 * torch.exp(logg * m2)

    T_lin = t0 + m * MIN_CONE_STEPSIZE
    T_geo = t1 * torch.exp(logg * torch.clamp_min(m - m1, 0.0))
    T_max = torch.where(torch.isfinite(t2), t2 + torch.clamp_min(m - m1 - m2, 0.0) * MAX_CONE_STEPSIZE, T_geo)
    T = torch.where(m <= m1, T_lin, torch.where(m <= m1 + m2, T_geo, T_max))
    return T, coords.calc_dt(T, cone)


def _candidate_cells(origins, directions, T, dt, n_cascades: int, resolution: Optional[int] = None):
    """Ladder positions → flat cascaded-grid indices [R, M] (the cascade of
    ``coords.mip_from_dt``: the position's, coarsened by the step width)."""
    pos = origins[:, None, :] + T[..., None] * directions[:, None, :]
    mip = coords.mip_from_dt(dt, pos, n_cascades)
    mip_scale = torch.exp2(-mip.to(torch.float32))
    Ro = GRID_RESOLUTION if resolution is None else resolution

    def cell_of(p):
        q = (p - 0.5) * mip_scale + 0.5
        return torch.clamp(torch.floor(q * Ro).to(torch.int64), 0, Ro - 1)

    ix, iy, iz = (cell_of(pos[..., k]) for k in range(3))
    return ((mip * Ro + ix) * Ro + iy) * Ro + iz


def build_coarse_occupancy(occupancy: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    """[C, 128, 128, 128] bool → dilated coarse chain [C, 16, 16, 16] f32
    (> 0 = some fine cell occupied nearby): 8³ max-pool, finer cascades OR'd
    into the centre octant of the next coarser one, then a 3³ dilation."""
    C, Rg = occupancy.shape[0], occupancy.shape[1]
    s = Rg // COARSE_RES
    g = COARSE_RES
    d = occupancy.reshape(C, g, s, g, s, g, s).any(dim=6).any(dim=4).any(dim=2)
    if C > 1:
        lo, hi = g // 4, g // 4 + g // 2
        levels = [d[0]]
        for k in range(1, C):
            pooled = levels[k - 1].reshape(g // 2, 2, g // 2, 2, g // 2, 2).any(dim=5).any(dim=3).any(dim=1)
            lvl = d[k].clone()
            lvl[lo:hi, lo:hi, lo:hi] |= pooled
            levels.append(lvl)
        d = torch.stack(levels)
    for axis in (1, 2, 3):
        acc = d
        for sh in range(1, dilation + 1):
            acc = acc | torch.roll(d, sh, axis) | torch.roll(d, -sh, axis)
        d = acc
    return d.to(torch.float32)


def masked_density_field(occupancy: torch.Tensor, density: Optional[torch.Tensor]) -> torch.Tensor:
    """One gatherable field: > 0 iff the cell is occupied."""
    if density is None:
        return occupancy.to(torch.float32)
    return torch.where(occupancy, torch.clamp_min(density, 1e-30), torch.zeros_like(density))


def _sorted_first(keys: torch.Tensor, payloads, take: int):
    """Sort rows of unique ``keys`` ascending carrying ``payloads``; keep the
    first ``take`` columns."""
    ks, perm = torch.sort(keys, dim=1)
    out = [ks[:, :take]]
    for p in payloads:
        out.append(take_along(p, perm, axis=1)[:, :take])
    return tuple(out)


def march_rays(
    origins: torch.Tensor,  # [R, 3] world
    directions: torch.Tensor,  # [R, 3] unit
    occupancy: torch.Tensor,  # [C, 128, 128, 128] bool
    aabb_lo: torch.Tensor,
    aabb_hi: torch.Tensor,
    cone_angle: float,
    t_jitter: Optional[torch.Tensor] = None,  # [R] in [0, 1)
    t_start_min: float = 0.0,
    k_samples: int = 32,
    n_candidates: int = 1024,
    use_grid_early_stop: bool = False,
    grid_stop_tau: float = 8.0,
    selection: str = "first",
    spread_rng: Optional[torch.Tensor] = None,  # [R, K] in [0, 1)
    spread_stride_cap: float = SPREAD_STRIDE_CAP,
    coarse_field: Optional[torch.Tensor] = None,  # flat build_coarse_occupancy
    fine_field: Optional[torch.Tensor] = None,  # flat masked_density_field
) -> SampleBatch:
    """Two-stage occupancy march → SampleBatch of [R, K] slabs.

    ``coarse_field``/``fine_field`` replace the fields built from
    ``occupancy`` (a renderer builds them once per frame instead of once
    per chunk, the fine one holding the occupancy-masked density);
    ``occupancy`` still gives the cascade count. With
    ``use_grid_early_stop`` and a ``fine_field``, samples past an optical
    depth of ``grid_stop_tau`` of the grid's density proxy are dropped."""
    if selection not in ("first", "spread"):
        raise ValueError(selection)
    dev = origins.device
    R = origins.shape[0]
    K = k_samples
    Q = COARSE_STRIDE
    M = -(-n_candidates // Q) * Q
    M1 = M // Q
    n_cascades = occupancy.shape[0]
    S = max(K, 32) if selection == "spread" else max(K // 2, 16)
    S = min(S, M1)
    J = S * Q

    coarse = coarse_field if coarse_field is not None else build_coarse_occupancy(occupancy).reshape(-1)
    dens_field = fine_field if fine_field is not None else masked_density_field(occupancy, None).reshape(-1)

    aabb = BoundingBox(aabb_lo, aabb_hi)
    tmin, tmax = aabb.ray_intersect(origins, directions)
    tmin = torch.clamp_min(tmin, t_start_min)
    hit = tmin < tmax
    t0 = torch.where(hit, tmin, tmax)
    if t_jitter is not None:
        t0 = t0 + coords.calc_dt(t0, cone_angle) * t_jitter

    # stage 1: segment endpoints against the dilated coarse field
    m_end = torch.arange(M1 + 1, dtype=torch.int64, device=dev) * Q
    T_end, dt_end = step_ladder(t0, m_end, cone_angle)
    cflat = _candidate_cells(origins, directions, T_end, dt_end, n_cascades, resolution=COARSE_RES)
    probe = coarse[cflat] > 0
    seg_inside = T_end[:, :-1] < tmax[:, None]
    seg_occ = (probe[:, :-1] | probe[:, 1:]) & seg_inside

    seg_ids = torch.arange(M1, dtype=torch.int32, device=dev)[None, :].expand(R, M1)
    seg_keys = torch.where(seg_occ, seg_ids, seg_ids + M1)
    (seg_sorted,) = _sorted_first(seg_keys, (), M1)
    n_seg = seg_occ.sum(dim=1)

    if selection == "spread":
        stride_s = torch.clamp(n_seg.to(torch.float32) / S, 1.0, spread_stride_cap)
        u_s = spread_rng[:, 0:1] if spread_rng is not None else 0.5
        ar_s = torch.arange(S, dtype=torch.float32, device=dev)[None, :]
        js_raw = ((ar_s + u_s) * stride_s[:, None]).to(torch.int64)
        js = torch.minimum(js_raw, torch.clamp_min(n_seg, 1)[:, None] - 1)
        sel_keys = take_along(seg_sorted, js, axis=1)
        pick_ok = js_raw < n_seg[:, None]
        seg_valid = (sel_keys < M1) & pick_ok
    else:
        stride_s = torch.ones((R,), dtype=torch.float32, device=dev)
        sel_keys = seg_sorted[:, :S]
        seg_valid = sel_keys < M1
    seg_m = torch.where(seg_valid, sel_keys, sel_keys - M1)

    # stage 2: fine ladder inside the surviving segments
    m_f = (seg_m[:, :, None] * Q + torch.arange(Q, dtype=torch.int64, device=dev)[None, None, :]).reshape(R, J)
    T_f, dt_f = step_ladder(t0, m_f, cone_angle)
    inside_f = (T_f < tmax[:, None]) & torch.repeat_interleave(seg_valid, Q, dim=1)
    fflat = _candidate_cells(origins, directions, T_f, dt_f, n_cascades)
    dens = torch.where(inside_f, dens_field[fflat], torch.zeros_like(T_f))
    occ_f = dens > 0

    if use_grid_early_stop and fine_field is not None:
        tau_step = torch.where(occ_f, dens * dt_f, torch.zeros_like(dens))
        keep = (torch.cumsum(tau_step, dim=1) - dens * dt_f) < grid_stop_tau  # exclusive cumsum
        occ_f = occ_f & keep

    nocc = occ_f.sum(dim=1)
    fine_ids = torch.arange(J, dtype=torch.int32, device=dev)[None, :].expand(R, J)
    fine_keys = torch.where(occ_f, fine_ids, fine_ids + J)
    _, t_sorted = _sorted_first(fine_keys, (T_f,), J)
    dt_sorted = coords.calc_dt(t_sorted, cone_angle)

    if selection == "spread":
        stride_f = torch.clamp(nocc.to(torch.float32) / K, 1.0, spread_stride_cap)
        ks = torch.arange(K, dtype=torch.float32, device=dev)[None, :]
        u = spread_rng if spread_rng is not None else torch.full((R, K), 0.5, device=dev)
        jk = ((ks + u) * stride_f[:, None]).to(torch.int64)
        jk = torch.minimum(jk, torch.clamp_min(nocc, 1)[:, None] - 1)
        out_t = take_along(t_sorted, jk, axis=1)
        out_dt = take_along(dt_sorted, jk, axis=1) * torch.clamp(stride_s * stride_f, 1.0, spread_stride_cap)[:, None]
    else:
        out_t = t_sorted[:, :K]
        out_dt = dt_sorted[:, :K]
    n = torch.where(hit, torch.clamp_max(nocc, K), torch.zeros_like(nocc)).to(torch.int32)
    valid = torch.arange(K, device=dev)[None, :] < n[:, None]
    zero = torch.zeros_like(out_t)
    return SampleBatch(t=torch.where(valid, out_t, zero), dt=torch.where(valid, out_dt, zero), valid=valid, n=n)


def march_rays_training(
    origins,
    directions,
    occupancy,
    aabb_lo,
    aabb_hi,
    cone_angle: float,
    t_jitter: Optional[torch.Tensor],
    spread: Optional[torch.Tensor],
    t_start_min: float = 0.0,
    k_samples: int = 32,
    n_candidates: int = 1024,
) -> SampleBatch:
    """Training sampler: jittered start (``t_jitter`` [R]) and stratified
    spread selection (``spread`` [R, K])."""
    return march_rays(
        origins, directions, occupancy, aabb_lo, aabb_hi, cone_angle,
        t_jitter=t_jitter, t_start_min=t_start_min, k_samples=k_samples,
        n_candidates=n_candidates, selection="spread", spread_rng=spread,
    )


def samples_to_network_inputs(samples: SampleBatch, origins, directions, aabb: BoundingBox):
    """→ (warped positions [R, K, 3], warped directions [R, K, 3])."""
    pos = origins[:, None, :] + samples.t[..., None] * directions[:, None, :]
    pos_w = torch.clamp(coords.warp_position(pos, aabb), 0.0, 1.0)
    dir_w = coords.warp_direction(directions)[:, None, :].expand_as(pos_w)
    return pos_w, dir_w
