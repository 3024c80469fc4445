"""The baked interactive preview: bake the (edited) field into a dense grid
once, then render every frame by shear-warp.

Counterpart of ``nerfshop_tpu/render/baked.py``:

1. **Bake** (:func:`bake_volume`): σ and view-baked rgb on a B³ lattice over
   a box (the testbed passes a tight box around the occupied content), each
   lattice point sent through the operator stack like a render sample (the
   cage warp is kernel E), then the field (kernel B without fracs, kernel C
   twice), the empty mask, the membrane's "target" blend and the occupancy
   mask. Stored as one canonical ``[z, y, x, 4]`` bf16 volume and three
   pre-permuted layouts, one per view-major axis.
2. **Incremental rebake** (:func:`update_volume_region`): re-evaluate only a
   world box (the union of what the changed operators can touch, bucketed
   to multiples of 32 cells) and patch it into the canonical volume and the
   three layouts in place.
3. **Frame** (:func:`render_baked`): the camera math on the host in numpy
   (:func:`frame_params`), then two launches on the card: kernel H
   (:func:`shear_warp_composite`) resamples every slice along the view-major
   axis onto a base plane through the eye and composites front to back into
   a ``Bi × Bi`` raster; kernel I (:func:`shear_warp_screen`) warps that
   raster to the screen bilinearly and blends the sky.

Each kernel has a plain PyTorch version that mirrors ``_frame_impl`` step by
step; the wrappers take it only for CPU tensors and launch the kernel (or
raise) on CUDA tensors. The plain versions interpolate in float32 from the
bf16 taps; JAX rounds the fractions, each lerp and the packed raster to bf16,
so the two packages agree within that rounding. Every division the kernels
make is also a true division here (a tensor divisor on the same device: a
CUDA division by a Python number multiplies by its reciprocal).

Unlike JAX's, the caches of this module are keyed by nothing: PyTorch runs
eagerly, so nothing is compiled per model.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from nerfshop_tpu_torch import kernels
from nerfshop_tpu_torch.models.nerf_network import density_with, forward_with
from nerfshop_tpu_torch.ops import coords, march
from nerfshop_tpu_torch.render.renderer import FrameOutput

#: view-major world axis → the transpose putting it first as k, the other
#: two as (y, x); channels stay last. Array axis a of the canonical volume
#: holds world axis 2 − a.
_AXIS_PERMS = {0: (0, 1, 2), 1: (1, 0, 2), 2: (2, 0, 1)}
#: lattice points a bake evaluates at once (whole z-slices)
CHUNK = 1 << 18


def _layout_perm(major: int) -> Tuple[int, int, int, int]:
    """The ``permute`` of the canonical [z, y, x, 4] volume into the layout
    of ``major`` (k, y, x, 4)."""
    p = _AXIS_PERMS[major]
    return (2 - p[0], 2 - p[1], 2 - p[2], 3)


class BakedVolume(NamedTuple):
    """A dense bake. ``fields[m]`` is the (rgb, σ) volume [B, B, B, 4] bf16
    laid out so that world axis ``m`` is the slice axis (k, y, x): kernel H
    then reads each slice's rows along their contiguous axis.
    ``canonical`` is the same volume as [z, y, x, 4] (for the incremental
    rebake). The box and the shading eye are host arrays (float32 [3]), so
    that a frame needs no device read."""

    fields: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    aabb_lo: np.ndarray
    aabb_hi: np.ndarray
    camera_pos: Optional[np.ndarray] = None
    canonical: Optional[torch.Tensor] = None

    @property
    def resolution(self) -> int:
        return self.fields[0].shape[0]

    @staticmethod
    def from_packed(canonical: torch.Tensor, aabb_lo, aabb_hi, camera_pos=None) -> "BakedVolume":
        """From the canonical [z, y, x, 4] bf16 volume: the three layouts are
        copies of it (4 × B³ × 8 bytes in all)."""
        fields = tuple(canonical.permute(_layout_perm(m)).contiguous() for m in range(3))
        cam = None if camera_pos is None else _host3(camera_pos)
        return BakedVolume(fields, _host3(aabb_lo), _host3(aabb_hi), cam, canonical)


def _host3(v) -> np.ndarray:
    """A 3-vector (tensor, array or sequence) → float32 host array [3]."""
    return np.array(v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v, np.float32).reshape(3)


def _host_box(box) -> Tuple[np.ndarray, np.ndarray]:
    """A ``coords.BoundingBox`` of tensors or arrays → float32 host (lo, hi)."""
    return _host3(box.min), _host3(box.max)


def _lattice(lo: torch.Tensor, hi: torch.Tensor, kz, ky, kx, B: int) -> torch.Tensor:
    """World positions [Z·Y·X, 3] of the lattice cells with array indices
    kz × ky × kx (float32 index vectors) of a B³ bake over [lo, hi]."""
    zz, yy, xx = torch.meshgrid((kz + 0.5) / B, (ky + 0.5) / B, (kx + 0.5) / B, indexing="ij")
    d = hi - lo
    return torch.stack([lo[0] + xx * d[0], lo[1] + yy * d[1], lo[2] + zz * d[2]], -1).reshape(-1, 3)


def occupancy_at(occupancy: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """{0, 1} float32 [N]: the occupancy bit of the finest cascade cell
    covering each world position (the march's cell choice at T = 0)."""
    zeros = torch.zeros((pos.shape[0], 1), dtype=torch.float32, device=pos.device)
    flat = march._candidate_cells(pos, torch.zeros_like(pos), zeros, zeros, occupancy.shape[0])
    return occupancy.reshape(-1)[flat[:, 0]].to(torch.float32)


def _eval_points(model, params, pos, cam, operators, field_box, occupancy):
    """World lattice positions [N, 3] → (rgb [N, 3], σ [N]) as the bake
    stores them (``_get_bake_fn.eval_rows`` of the JAX package)."""
    if cam is not None:
        d = pos - cam
        dirs = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-9)
    else:
        dirs = torch.tensor([0.0, 0.0, 1.0], device=pos.device).expand(pos.shape[0], 3)
    pos0 = pos
    empty = resid = None
    if operators:
        from nerfshop_tpu_torch.editing import operators as op_lib

        if op_lib.has_membrane(operators):
            pos, dirs, empty, *resid = op_lib.map_samples_through_stack_full(list(operators), pos, dirs)
        else:
            pos, dirs, empty = op_lib.map_samples_through_stack(list(operators), pos, dirs)
    # the network's box, not the lattice's
    pw = torch.clamp(coords.warp_position(pos, field_box), 0.0, 1.0)
    rgb, sigma = forward_with(model, params, pw, coords.warp_direction(dirs))
    if empty is not None:
        sigma = torch.where(empty, torch.zeros_like(sigma), sigma)
    if resid is not None:
        # the "target" membrane blend; the σ-ratio is the dt → 0 limit of the
        # renderer's α-ratio; a vacated point stays σ = 0. Without a membrane
        # the blend changes nothing (JAX runs it anyway), so it is skipped.
        resid_sigma, resid_out, resid_rgb = resid
        on = (resid_out > 1e-9) & ~empty
        sigma_tgt = density_with(model, params, torch.clamp(coords.warp_position(pos0, field_box), 0.0, 1.0))
        sigma_new = torch.minimum(torch.maximum(sigma_tgt, sigma), sigma + resid_sigma)
        den = sigma + resid_out
        w_n = torch.where(den > 1e-9, sigma / torch.clamp_min(den, 1e-9), torch.ones_like(den))
        rgb_mix = w_n[:, None] * rgb + (1.0 - w_n)[:, None] * resid_rgb
        sigma = torch.where(on, sigma_new, sigma)
        rgb = torch.clamp_min(torch.where(on[:, None], rgb_mix, rgb), 0.0)
    if occupancy is not None:
        sigma = sigma * occupancy_at(occupancy, pos0)
    return rgb, sigma


def _device_boxes(aabb, field_aabb, device):
    lo, hi = _host_box(aabb)
    flo, fhi = _host_box(field_aabb if field_aabb is not None else aabb)

    def t(a):
        return torch.as_tensor(a, device=device)

    return lo, hi, t(lo), t(hi), coords.BoundingBox(t(flo), t(fhi))


@torch.no_grad()
def bake_volume(
    model,
    params,
    aabb: coords.BoundingBox,
    resolution: int = 256,
    operators: tuple = (),
    camera_pos=None,
    occupancy: Optional[torch.Tensor] = None,
    chunk: int = CHUNK,
    field_aabb: Optional[coords.BoundingBox] = None,
) -> BakedVolume:
    """Evaluate the field on a ``resolution``³ lattice over ``aabb`` (σ and
    rgb shaded toward ``camera_pos``, or along +z without one), the edits
    applied, in chunks of ``chunk // B²`` z-slices. ``occupancy`` ([C, 128,
    128, 128] bool): σ is zeroed outside occupied cells. ``field_aabb``: the
    box the network warps positions by (the training box) when ``aabb`` is a
    tight content box. ``params``: a state dict of ``model`` (e.g. the EMA
    copy) or None. Runs on the model's device."""
    B = resolution
    dev = next(model.parameters()).device
    lo, hi, lo_t, hi_t, field_box = _device_boxes(aabb, field_aabb, dev)
    cam_host = None if camera_pos is None else _host3(camera_pos)
    canonical = torch.empty((B, B, B, 4), dtype=torch.bfloat16, device=dev)
    _fill(canonical, (0, 0, 0), B, model, params, lo_t, hi_t, cam_host, operators, field_box, occupancy, chunk)
    return BakedVolume.from_packed(canonical, lo, hi, cam_host)


def _fill(out, start_zyx, B, model, params, lo_t, hi_t, cam_host, operators, field_box, occupancy, chunk):
    """Evaluate the lattice cells ``start_zyx`` + [0, Z) × [0, Y) × [0, X) of
    a B³ bake into ``out`` [Z, Y, X, 4] bf16, whole z-slices at a time, at
    most ``chunk`` points a call of the field."""
    Z, Y, X = out.shape[:3]
    dev = out.device
    cam = None if cam_host is None else torch.as_tensor(cam_host, device=dev)

    def idx(s, n):
        return s + torch.arange(n, dtype=torch.float32, device=dev)

    sz, sy, sx = start_zyx
    rows = max(1, min(Z, chunk // (Y * X)))
    for z0 in range(0, Z, rows):
        z1 = min(Z, z0 + rows)
        pos = _lattice(lo_t, hi_t, idx(sz + z0, z1 - z0), idx(sy, Y), idx(sx, X), B)
        rgb, sigma = _eval_points(model, params, pos, cam, tuple(operators), field_box, occupancy)
        out[z0:z1, ..., :3] = rgb.reshape(z1 - z0, Y, X, 3).to(torch.bfloat16)
        out[z0:z1, ..., 3] = sigma.reshape(z1 - z0, Y, X).to(torch.bfloat16)


def _roi_dims(roi_lo, roi_hi, aabb: coords.BoundingBox, B: int, pad_cells: int = 2):
    """World ROI box → (start index [3] in world (x, y, z) order, dims (Z,
    Y, X)). Each extent is padded by ``pad_cells``, rounded up to a multiple
    of 32 cells (at least 32, at most B), and the starts are clamped so that
    the box fits in the grid: the cells JAX's ``_roi_dims`` re-evaluates."""
    lo, hi = _host_box(aabb)
    scale = B / (hi - lo)
    i0 = np.floor((np.asarray(roi_lo) - lo) * scale).astype(np.int64) - pad_cells
    i1 = np.ceil((np.asarray(roi_hi) - lo) * scale).astype(np.int64) + pad_cells
    i0 = np.clip(i0, 0, B)
    i1 = np.clip(i1, 0, B)
    dims = [min(B, max(32, -(-max(1, int(i1[a] - i0[a])) // 32) * 32)) for a in range(3)]
    start = np.maximum(np.minimum(i0, B - np.asarray(dims)), 0)
    return start, (dims[2], dims[1], dims[0])


@torch.no_grad()
def update_volume_region(
    prev: BakedVolume,
    model,
    params,
    aabb: coords.BoundingBox,
    roi_lo,
    roi_hi,
    operators: tuple = (),
    camera_pos=None,
    occupancy: Optional[torch.Tensor] = None,
    field_aabb: Optional[coords.BoundingBox] = None,
) -> BakedVolume:
    """Incremental rebake: re-evaluate the field only in the world box
    [roi_lo, roi_hi] (bucketed by :func:`_roi_dims` over ``aabb``, the
    previous bake's box) and write the patch into ``prev``'s canonical volume
    and, transposed, into its three layouts, IN PLACE (no copy of the
    volume is made; ``prev`` shares the result's tensors). ``camera_pos``:
    the shading eye of the patch (the testbed passes the previous bake's);
    as in JAX, without one the patch is shaded along +z and the result keeps
    the previous bake's eye."""
    if prev.canonical is None:
        raise ValueError("the previous bake has no canonical volume")
    B = prev.resolution
    start, (Z, Y, X) = _roi_dims(roi_lo, roi_hi, aabb, B)
    start_zyx = tuple(int(v) for v in start[::-1])
    sz, sy, sx = start_zyx
    dev = prev.canonical.device
    _, _, lo_t, hi_t, field_box = _device_boxes(aabb, field_aabb, dev)
    cam_host = None if camera_pos is None else _host3(camera_pos)
    patch = torch.empty((Z, Y, X, 4), dtype=torch.bfloat16, device=dev)
    _fill(patch, start_zyx, B, model, params, lo_t, hi_t, cam_host, operators, field_box, occupancy, CHUNK)
    prev.canonical[sz:sz + Z, sy:sy + Y, sx:sx + X] = patch
    for m, f in enumerate(prev.fields):
        perm = _layout_perm(m)
        s = [start_zyx[a] for a in perm[:3]]
        n = [(Z, Y, X)[a] for a in perm[:3]]
        f[s[0]:s[0] + n[0], s[1]:s[1] + n[1], s[2]:s[2] + n[2]] = patch.permute(perm)
    return prev if cam_host is None else prev._replace(camera_pos=cam_host)


# ---------------------------------------------------------------------------
# The frame
# ---------------------------------------------------------------------------


class FrameParams(NamedTuple):
    """Everything a baked frame's two kernels read, computed on the host
    from the camera and the bake's box (float32 numpy values). ``e``: the eye
    in (k, y, x) index coordinates of the view-major layout, after the flip;
    ``box``: the base raster's extent (by0, by1, bx0, bx1) on the base
    plane k = 0.5; ``rows``: the camera-to-world rows of the world axes
    (k, y, x); ``scale``: world → index scale of those axes, negated for k
    when the view looks down the major axis (``flip``)."""

    B: int
    Bi: int
    W: int
    H: int
    major: int
    flip: bool
    with_depth: bool
    e: np.ndarray  # [3]
    box: np.ndarray  # [4]
    cell_world: np.float32
    rows: np.ndarray  # [3, 3]
    scale: np.ndarray  # [3]
    focal: np.ndarray  # [2]
    principal_px: np.ndarray  # [2] principal point · (W, H)
    sky: np.ndarray  # [4]


def frame_params(
    B: int,
    aabb_lo,
    aabb_hi,
    resolution: Tuple[int, int],
    xform,
    focal,
    principal=None,
    background=(0.0, 0.0, 0.0, 0.0),
    base_resolution: int = 512,
    with_depth: bool = True,
) -> FrameParams:
    """The camera math of JAX's ``render_baked`` / ``_frame_impl`` up to the
    per-pixel work, in float32 numpy: the view-major axis and its flip, the
    eye in index space, and the base raster's box through the four corner
    rays (clamped to the projection hull of the volume)."""
    f32 = np.float32
    W, H = resolution
    xform = np.asarray(xform, f32).reshape(3, 4)
    focal = np.asarray(focal, f32).reshape(2)
    principal = np.asarray([0.5, 0.5] if principal is None else principal, f32).reshape(2)
    sky = np.asarray(background, f32).reshape(4)
    lo = np.asarray(aabb_lo, f32).reshape(3)
    hi = np.asarray(aabb_hi, f32).reshape(3)
    fwd = xform[:, 2]
    major = int(np.argmax(np.abs(fwd)))
    flip = bool(fwd[major] < 0)
    p = list(_AXIS_PERMS[major])

    scale = f32(B) / (hi - lo)
    e_idx = (xform[:, 3] - lo) * scale
    wh = np.asarray([W, H], f32)
    cu = np.asarray([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]], f32)
    cc = (cu * wh - principal * wh) / focal
    c_cam = np.concatenate([cc, np.ones((4, 1), f32)], -1)
    c_idx = (c_cam @ xform[:, :3].T) * scale
    e = e_idx[p].copy()
    c = c_idx[:, p].copy()
    if flip:
        e[0] = f32(B) - e[0]
        c[:, 0] = -c[:, 0]
    cell_world = f32((hi[0] - lo[0]) / f32(B))  # a cubic box

    z0 = f32(0.5)
    ez, ey, ex = e
    tz = (z0 - ez) / np.where(np.abs(c[:, 0]) < f32(1e-6), f32(1e-6), c[:, 0])
    hit_y = ey + tz * c[:, 1]
    hit_x = ex + tz * c[:, 2]
    valid = tz > 0
    big = f32(4 * B)
    by0 = np.min(np.where(valid, hit_y, big))
    by1 = np.max(np.where(valid, hit_y, -big))
    bx0 = np.min(np.where(valid, hit_x, big))
    bx1 = np.max(np.where(valid, hit_x, -big))
    # content's projection through the eye onto k = 0.5 lies within hull(eye, [0, B])
    ylo, yhi = min(ey, f32(0.0)), max(ey, f32(B))
    xlo, xhi = min(ex, f32(0.0)), max(ex, f32(B))
    by0, by1 = np.clip(by0, ylo, yhi), np.clip(by1, ylo, yhi)
    bx0, bx1 = np.clip(bx0, xlo, xhi), np.clip(bx1, xlo, xhi)
    by1 = max(by1, f32(by0 + f32(1e-3)))
    bx1 = max(bx1, f32(bx0 + f32(1e-3)))

    sc = scale[p].copy()
    if flip:
        sc[0] = -sc[0]
    return FrameParams(
        B=B, Bi=base_resolution, W=W, H=H, major=major, flip=flip, with_depth=with_depth,
        e=e.astype(f32), box=np.asarray([by0, by1, bx0, bx1], f32), cell_world=cell_world,
        rows=np.ascontiguousarray(xform[p, :3]), scale=sc.astype(f32), focal=focal,
        principal_px=(principal * wh).astype(f32), sky=sky,
    )


def _scalar(v, dev) -> torch.Tensor:
    """A 0-d float32 tensor on ``dev`` (a divisor there divides exactly)."""
    return torch.tensor(float(v), dtype=torch.float32, device=dev)


def _bilerp(a, b, f):
    return a * (1.0 - f) + b * f


def _source(base: torch.Tensor, e_ax: float, inv_s: torch.Tensor, B: int):
    """Per-slice source coordinate of each base texel → (q0 [B, Bi] int64 in
    [0, B − 2], fraction from the unclamped floor, valid)."""
    src = (base[None, :] - e_ax) * inv_s[:, None] + e_ax - 0.5
    q0 = torch.floor(src)
    frac = src - q0
    q0i = torch.clamp(q0, 0.0, float(B - 2)).to(torch.int64)
    valid = (src >= 0.0) & (src <= float(B - 1))
    return q0i, frac, valid


#: kernel H's tile (x' × y' texels, a thread each), the largest footprint of
#: a tile in a slice (rows × columns of layout cells) that it stages in
#: shared memory, and its box buffers: ``kTileX`` × ``kTileY``, ``kBoxRows``
#: × ``kTileX`` and ``kStages`` of ``csrc/baked.cu`` (a buffer is two
#: columns wider, as its copy starts on an even column)
COMPOSITE_TILE = (16, 8)
COMPOSITE_BOX = (10, 16)
COMPOSITE_STAGES = 4
#: the largest B kernel H takes (``kMaxB``: a cell's index fits 31 bits)
COMPOSITE_MAX_B = 1024
#: what kernel H does with a slice of a tile: skip it (behind the eye, or no
#: texel of the tile meets it), stage its box in shared memory, or read its
#: taps from the layout directly (the footprint is larger than
#: ``COMPOSITE_BOX``, or B is odd or below the buffer's width: the copies
#: move 16-byte pairs of cells from even columns)
SKIP, STAGED, DIRECT = 0, 1, 2


def composite_smem(B: int) -> int:
    """Kernel H's dynamic shared memory a block: the box buffers (8 bytes a
    cell), the y-lerped footprint columns of the tile's rows (16 bytes
    each), 16 bytes of scan sums, then each slice's list entry (16 bytes)
    and terms (8 bytes)."""
    rows, cols = COMPOSITE_BOX
    return COMPOSITE_STAGES * rows * (cols + 2) * 8 + COMPOSITE_TILE[1] * cols * 16 + 16 + B * 24


class CompositePlan(NamedTuple):
    """Kernel H's per-tile, per-slice work (:func:`composite_plan`). Tile
    (tx, ty) holds the texels x' in [tx, tx + 1) · ``COMPOSITE_TILE[0]``
    and y' in [ty, ty + 1) · ``COMPOSITE_TILE[1]``; slice k is the
    front-to-back index (before the flip)."""

    mode: np.ndarray  # [tiles x', tiles y', B] int8: SKIP, STAGED or DIRECT
    box: np.ndarray  # [tiles x', tiles y', B, 4] int32: the taps' first and last row (y), first and last column (x)

    def counts(self) -> dict:
        """Tile-slices of each mode."""
        return {name: int((self.mode == m).sum()) for name, m in (("skipped", SKIP), ("staged", STAGED),
                                                                   ("direct", DIRECT))}


def composite_plan(fp: FrameParams) -> CompositePlan:
    """The host mirror of kernel H's block set-up: for each tile and slice,
    the box of layout cells its texels' taps can read. A texel's source
    coordinate is monotone in its base coordinate (every rounded step is),
    so the tile's first and last texel of each axis bound the others'; the
    float32 steps are the kernel's, so the boxes are the kernel's. A slice
    is skipped when it is behind the eye or the edges' source range misses
    [0, B − 1] on an axis (then no texel of the tile meets it)."""
    f32 = np.float32
    B, Bi = fp.B, fp.Bi
    by0, by1, bx0, bx1 = (f32(v) for v in fp.box)
    ez, ey, ex = (f32(v) for v in fp.e)
    rel = (np.arange(B, dtype=f32) + f32(0.5)) - ez
    front = rel > f32(1e-3)
    with np.errstate(divide="ignore", invalid="ignore"):
        s = (f32(0.5) - ez) / rel
        s = np.where(np.abs(s) < f32(1e-6), f32(1e-6), s)
        inv_s = np.where(front, f32(1.0) / s, f32(0.0)).astype(f32)

    def axis(b0, b1, e, T):
        first = np.arange(0, Bi, T)
        edges = np.stack([first, np.minimum(first + T, Bi) - 1], -1).astype(f32)  # [tiles, 2]: first, last texel
        base = b0 + (edges + f32(0.5)) * (b1 - b0) / f32(Bi)
        src = ((base[None] - e) * inv_s[:, None, None] + e) - f32(0.5)  # [B, tiles, 2]
        meets = (src.max(-1) >= 0) & (src.min(-1) <= f32(B - 1))
        q0 = np.clip(np.floor(src), 0, B - 2).astype(np.int32)
        return meets, q0.min(-1), q0.max(-1) + 1

    my, y_lo, y_hi = axis(by0, by1, ey, COMPOSITE_TILE[1])
    mx, x_lo, x_hi = axis(bx0, bx1, ex, COMPOSITE_TILE[0])
    meets = front[:, None, None] & my[:, None, :] & mx[:, :, None]  # [B, tiles x', tiles y']
    ylo, yhi = np.broadcast_to(y_lo[:, None, :], meets.shape), np.broadcast_to(y_hi[:, None, :], meets.shape)
    xlo, xhi = np.broadcast_to(x_lo[:, :, None], meets.shape), np.broadcast_to(x_hi[:, :, None], meets.shape)
    fits = (yhi - ylo + 1 <= COMPOSITE_BOX[0]) & (xhi - xlo + 1 <= COMPOSITE_BOX[1]) & (B % 2 == 0) & (
        B >= COMPOSITE_BOX[1] + 2)
    mode = np.where(meets, np.where(fits, STAGED, DIRECT), SKIP).astype(np.int8)
    box = np.stack([ylo, yhi, xlo, xhi], -1)
    return CompositePlan(np.ascontiguousarray(mode.transpose(1, 2, 0)),
                         np.ascontiguousarray(box.transpose(1, 2, 0, 3)).astype(np.int32))


class SliceSources(NamedTuple):
    """What the plain kernel H computes before it reads the layout: each
    slice's distance from the eye in slices (``rel`` [B]) and whether it is
    in front of it, each base texel's ray obliquity (``sec`` [y', x']), and
    the per-slice source row and column of every base texel (``y``, ``x``:
    the :func:`_source` triples, [B, Bi])."""

    rel: torch.Tensor
    front: torch.Tensor
    sec: torch.Tensor
    y: tuple
    x: tuple


def slice_sources(fp: FrameParams, dev) -> SliceSources:
    """:class:`SliceSources` of a frame on ``dev``, as
    :func:`shear_warp_composite_plain` computes them."""
    B, Bi = fp.B, fp.Bi
    f32 = torch.float32
    ez, ey, ex = (float(v) for v in fp.e)
    by0, by1, bx0, bx1 = (float(v) for v in fp.box)
    ii = torch.arange(Bi, dtype=f32, device=dev) + 0.5
    bi = _scalar(Bi, dev)
    base_y = by0 + ii * float(np.float32(by1) - np.float32(by0)) / bi
    base_x = bx0 + ii * float(np.float32(bx1) - np.float32(bx0)) / bi

    dz0 = float(np.float32(0.5) - np.float32(ez))
    dby = base_y[:, None] - ey
    dbx = base_x[None, :] - ex
    sec = torch.sqrt(dby * dby + dbx * dbx + dz0 * dz0) / _scalar(abs(dz0), dev)  # [y', x']

    rel = torch.arange(B, dtype=f32, device=dev) + 0.5 - ez
    front = rel > 1e-3
    s_all = _scalar(dz0, dev) / rel
    inv_s = torch.where(front, _scalar(1.0, dev) / torch.where(s_all.abs() < 1e-6, 1e-6, s_all), 0.0)
    return SliceSources(rel, front, sec, _source(base_y, ey, inv_s, B), _source(base_x, ex, inv_s, B))


def shear_warp_composite_plain(field: torch.Tensor, fp: FrameParams) -> torch.Tensor:
    """Plain version of kernel H: slice resample (y, then x) and the front-to-
    back composite of ``field`` (the layout of ``fp.major``, [B, B, B, 4]
    bf16) → the base raster [Bi (x'), Bi (y'), 5] float32 (rgb, 1 − T,
    depth), step for step as ``_frame_impl`` :492-564."""
    dev = field.device
    B, Bi = fp.B, fp.Bi
    f32 = torch.float32
    src = slice_sources(fp, dev)
    rel, front, sec = src.rel, src.front, src.sec
    (y0i, fy, vy), (x0i, fx, vx) = src.y, src.x
    dt_map = (float(fp.cell_world) * sec).T  # [x', y']

    # pass 1 resamples y: rows (k, y) of [x, c]; a flipped view reads the
    # slices from the back
    flat1 = field.reshape(B * B, B * 4)
    karr = torch.arange(B, device=dev)
    if fp.flip:
        karr = B - 1 - karr
    rows_a = (karr[:, None] * B + y0i).reshape(-1)
    ra0 = flat1.index_select(0, rows_a).to(f32)
    ra1 = flat1.index_select(0, rows_a + 1).to(f32)
    out1 = torch.where(vy.reshape(-1, 1), _bilerp(ra0, ra1, fy.reshape(-1, 1)), 0.0)
    out1 = out1.reshape(B, Bi, B, 4).transpose(1, 2).reshape(B * B, Bi * 4)  # rows (k, x) of [y', c]
    # pass 2 resamples x
    rows_b = (torch.arange(B, device=dev)[:, None] * B + x0i).reshape(-1)
    rb0 = out1.index_select(0, rows_b)
    rb1 = out1.index_select(0, rows_b + 1)
    r2 = torch.where(vx.reshape(-1, 1), _bilerp(rb0, rb1, fx.reshape(-1, 1)), 0.0).reshape(B, Bi, Bi, 4)

    # composite over slices: the exponential of the running optical depth
    tau = torch.relu(r2[..., 3]) * dt_map[None] * front[:, None, None].to(f32)
    ctau = torch.cumsum(tau, 0)
    wgt = torch.exp(-(ctau - tau)) * (1.0 - torch.exp(-tau))
    acc = torch.sum(wgt[..., None] * r2[..., :3], 0)
    T = torch.exp(-ctau[-1])
    if fp.with_depth:
        tk = rel[:, None, None] * sec.T[None] * float(fp.cell_world)
        depth_acc = torch.sum(wgt * tk, 0)
    else:
        depth_acc = torch.zeros((Bi, Bi), dtype=f32, device=dev)
    return torch.cat([acc, (1.0 - T)[..., None], depth_acc[..., None]], -1)


def shear_warp_screen_plain(raster: torch.Tensor, fp: FrameParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel I: each pixel's ray meets the base plane, the
    raster is sampled bilinearly there (clamped taps), depth = acc / α, and
    the sky is blended in → (rgba [H, W, 4], depth [H, W]), as
    ``_frame_impl`` :566-600 with the ray math of ``render_baked`` :649-674."""
    dev = raster.device
    f32 = torch.float32
    W, H, Bi = fp.W, fp.H, fp.Bi
    uu = (torch.arange(W, dtype=f32, device=dev) + 0.5 - float(fp.principal_px[0])) / _scalar(fp.focal[0], dev)
    vv = (torch.arange(H, dtype=f32, device=dev) + 0.5 - float(fp.principal_px[1])) / _scalar(fp.focal[1], dev)
    r, s = fp.rows, fp.scale
    d = [(float(r[a, 0]) * uu[None, :] + float(r[a, 1]) * vv[:, None] + float(r[a, 2])) * float(s[a]) for a in range(3)]
    ez, ey, ex = (float(v) for v in fp.e)
    by0, by1, bx0, bx1 = (float(v) for v in fp.box)
    dz0 = _scalar(np.float32(0.5) - np.float32(ez), dev)
    t_hit = dz0 / torch.where(d[0].abs() < 1e-6, 1e-6, d[0])
    hy = ey + t_hit * d[1]
    hx = ex + t_hit * d[2]
    gy = (hy - by0) / _scalar(np.float32(by1) - np.float32(by0), dev) * float(Bi) - 0.5
    gx = (hx - bx0) / _scalar(np.float32(bx1) - np.float32(bx0), dev) * float(Bi) - 0.5
    ok = (t_hit > 0) & (gy > -1.0) & (gy < Bi) & (gx > -1.0) & (gx < Bi)
    y0 = torch.clamp(torch.floor(gy), 0.0, float(Bi - 2))
    x0 = torch.clamp(torch.floor(gx), 0.0, float(Bi - 2))
    fy = torch.clamp(gy - y0, 0.0, 1.0)[..., None]
    fx = torch.clamp(gx - x0, 0.0, 1.0)[..., None]
    y0, x0 = y0.to(torch.int64), x0.to(torch.int64)
    left = _bilerp(raster[x0, y0], raster[x0, y0 + 1], fy)  # the x0 column, lerped in y
    right = _bilerp(raster[x0 + 1, y0], raster[x0 + 1, y0 + 1], fy)
    out = _bilerp(left, right, fx)
    depth = out[..., 4] / torch.clamp_min(out[..., 3], 1e-6)
    rgb = torch.where(ok[..., None], out[..., :3], 0.0)
    alpha = torch.where(ok, out[..., 3], 0.0)
    sky = torch.as_tensor(fp.sky, device=dev)
    rgba = torch.cat([rgb + (1.0 - alpha[..., None]) * sky[:3], (alpha + (1.0 - alpha) * sky[3])[..., None]], -1)
    return rgba, torch.where(ok, depth, 0.0)


def _frame_args(fp: FrameParams) -> kernels.FrameArgs:
    def arr(n, v):
        return (ctypes.c_float * n)(*(float(x) for x in np.asarray(v, np.float32).reshape(-1)))

    return kernels.FrameArgs(
        e=arr(3, fp.e), box=arr(4, fp.box), cell_world=float(fp.cell_world), rows=arr(9, fp.rows),
        scale=arr(3, fp.scale), focal=arr(2, fp.focal), principal_px=arr(2, fp.principal_px), sky=arr(4, fp.sky),
        B=fp.B, Bi=fp.Bi, W=fp.W, H=fp.H, flip=int(fp.flip), with_depth=int(fp.with_depth),
    )


def _check_frame(fp: FrameParams, name: str) -> None:
    if fp.B < 2 or fp.Bi < 2:
        raise ValueError(f"{name}: B = {fp.B} and Bi = {fp.Bi} must be at least 2")


@kernels.counted("launches")
def shear_warp_composite_cuda(field: torch.Tensor, fp: FrameParams, paths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel H (``csrc/baked.cu``): :func:`shear_warp_composite_plain` in one
    launch, a block a tile of texels looping over the slices its tile meets
    front to back (:func:`composite_plan`). ``paths``: an int32 [3] CUDA
    tensor to which the launch adds its tile-slices skipped, staged and
    read directly."""
    dev = field.device
    if dev.type != "cuda":
        raise ValueError(f"shear_warp_composite: field on {dev}, expected a CUDA device")
    _check_frame(fp, "shear_warp_composite")
    if fp.B > COMPOSITE_MAX_B:
        raise ValueError(f"shear_warp_composite: B = {fp.B} is above kernel H's {COMPOSITE_MAX_B}")
    kernels.require(field, "field", torch.bfloat16, (fp.B, fp.B, fp.B, 4), dev)
    if field.data_ptr() % 16:  # the staging copies move 16-byte pairs of cells
        raise ValueError("shear_warp_composite: the field must start on a 16-byte boundary")
    raster = torch.empty((fp.Bi, fp.Bi, 5), dtype=torch.float32, device=dev)
    args = _frame_args(fp)
    lib = kernels.load()
    if paths is None:
        err = lib.nst_shear_composite(ctypes.byref(args), field.data_ptr(), raster.data_ptr(), kernels.stream_ptr(dev))
    else:
        kernels.require(paths, "paths", torch.int32, (3,), dev)
        err = lib.nst_shear_composite_paths(ctypes.byref(args), field.data_ptr(), raster.data_ptr(), paths.data_ptr(),
                                            kernels.stream_ptr(dev))
    kernels.check(err, "shear_warp_composite")
    shear_warp_composite_cuda.launches += 1
    return raster


@kernels.counted("launches")
def shear_warp_screen_cuda(raster: torch.Tensor, fp: FrameParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel I (``csrc/baked.cu``): :func:`shear_warp_screen_plain` in one
    launch, one thread per pixel."""
    dev = raster.device
    if dev.type != "cuda":
        raise ValueError(f"shear_warp_screen: raster on {dev}, expected a CUDA device")
    _check_frame(fp, "shear_warp_screen")
    kernels.require(raster, "raster", torch.float32, (fp.Bi, fp.Bi, 5), dev)
    rgba = torch.empty((fp.H, fp.W, 4), dtype=torch.float32, device=dev)
    depth = torch.empty((fp.H, fp.W), dtype=torch.float32, device=dev)
    if fp.W * fp.H == 0:
        return rgba, depth
    args = _frame_args(fp)
    err = kernels.load().nst_shear_screen(ctypes.byref(args), raster.data_ptr(), rgba.data_ptr(), depth.data_ptr(),
                                          kernels.stream_ptr(dev))
    kernels.check(err, "shear_warp_screen")
    shear_warp_screen_cuda.launches += 1
    return rgba, depth


def shear_warp_composite(field: torch.Tensor, fp: FrameParams) -> torch.Tensor:
    """Kernel H on a CUDA tensor, its plain version on a CPU tensor."""
    if field.device.type == "cpu":
        return shear_warp_composite_plain(field, fp)
    return shear_warp_composite_cuda(field, fp)


def shear_warp_screen(raster: torch.Tensor, fp: FrameParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel I on a CUDA tensor, its plain version on a CPU tensor."""
    if raster.device.type == "cpu":
        return shear_warp_screen_plain(raster, fp)
    return shear_warp_screen_cuda(raster, fp)


@torch.no_grad()
def render_baked(
    vol: BakedVolume,
    resolution: Tuple[int, int],  # (W, H)
    xform,  # [3, 4] camera-to-world
    focal,  # [2] pixels
    principal=None,
    background: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0),
    base_resolution: int = 512,
    with_depth: bool = True,
) -> FrameOutput:
    """One frame from a baked volume: the camera math on the host, then
    kernel H on the layout of the view-major axis and kernel I (two
    launches). JAX's ``slice_group``, which its frame does not read, is
    not taken."""
    fp = frame_params(vol.resolution, vol.aabb_lo, vol.aabb_hi, resolution, xform, focal, principal, background,
                      base_resolution, with_depth)
    raster = shear_warp_composite(vol.fields[fp.major], fp)
    rgba, depth = shear_warp_screen(raster, fp)
    return FrameOutput(rgba, depth)
