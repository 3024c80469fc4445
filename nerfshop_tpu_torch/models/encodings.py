"""Input encodings: the hash grid (brick layout), SH, Identity, Composite.

Counterpart of ``nerfshop_tpu/models/encodings.py``. ``GridEncoding`` keeps
the JAX level metadata exactly (scales, resolutions, dense flags, sizes
rounded up to a multiple of 128, offsets, corner shifts), so a JAX table
loads slot for slot. Only the brick layout is ported: the additive hash
places every cell corner at a fixed slot shift from the cell's base slot.
Other encoding otypes raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from nerfshop_tpu_torch.ops import fused_mlp, table_ops

_HASH_PRIMES = (1, 2654435761, 805459861)


class GridEncoding(nn.Module):
    """Multi-resolution hash / dense grid; ``table`` [Σm, F] is its parameter."""

    def __init__(
        self,
        n_input_dims: int = 3,
        n_levels: int = 16,
        n_features_per_level: int = 2,
        log2_hashmap_size: int = 19,
        base_resolution: int = 16,
        per_level_scale: float = 2.0,
        hash_type: str = "hash",
        layout: str = "brick",
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if n_input_dims not in (2, 3):
            raise ValueError("grid encoding supports 2D/3D")
        if layout != "brick":
            raise NotImplementedError(f"grid layout {layout!r} is not ported (brick only)")
        self.n_input_dims = n_input_dims
        self.n_levels = n_levels
        self.n_features_per_level = n_features_per_level
        self.log2_hashmap_size = log2_hashmap_size
        self.base_resolution = base_resolution
        self.per_level_scale = per_level_scale
        self.hash_type = hash_type
        T = 1 << log2_hashmap_size
        self.level_scales: List[float] = []
        self.level_res: List[int] = []
        self.level_sizes: List[int] = []
        self.level_dense: List[bool] = []
        self.level_offsets: List[int] = [0]
        for l in range(n_levels):
            scale = 2.0 ** (l * math.log2(per_level_scale)) * base_resolution - 1.0
            res = int(math.ceil(scale)) + 1
            dense_size = res**n_input_dims
            if hash_type == "dense":
                dense, size = True, dense_size
            else:
                dense = dense_size <= T
                size = dense_size if dense else T
            size = -(-size // 128) * 128
            self.level_scales.append(scale)
            self.level_res.append(res)
            self.level_sizes.append(size)
            self.level_dense.append(dense)
            self.level_offsets.append(self.level_offsets[-1] + size)
        self.table_size = self.level_offsets[-1]
        D = n_input_dims
        self.brick_shifts: List[List[int]] = []
        for l in range(n_levels):
            m, res = self.level_sizes[l], self.level_res[l]
            if self.level_dense[l]:
                strides = [1, res, res * res][:D]
            else:
                strides = [1] + [_HASH_PRIMES[d] % m for d in range(1, D)]
            self.brick_shifts.append(
                [sum(((c >> d) & 1) * strides[d] for d in range(D)) % m for c in range(1 << D)]
            )
        table = torch.empty((self.table_size, n_features_per_level), dtype=torch.float32, device=device)
        table.uniform_(-1e-4, 1e-4, generator=generator)
        self.table = nn.Parameter(table)
        self._meta: Dict[object, object] = {}

    @property
    def n_output_dims(self) -> int:
        return self.n_levels * self.n_features_per_level

    def kernel_meta(self, device: torch.device):
        """(meta_i [L, 12] int32: res, m, offset, dense, 8 shifts (the
        last 4 are 0 at D = 2); meta_f [L] f32 scales) on ``device``, for
        kernels B and F."""
        if device not in self._meta:
            rows = [
                [self.level_res[l], self.level_sizes[l], self.level_offsets[l], int(self.level_dense[l])]
                + list(self.brick_shifts[l]) + [0] * (8 - len(self.brick_shifts[l]))
                for l in range(self.n_levels)
            ]
            self._meta[device] = (
                torch.tensor(rows, dtype=torch.int32, device=device),
                torch.tensor(self.level_scales, dtype=torch.float32, device=device),
            )
        return self._meta[device]

    def shift_table(self, device: torch.device) -> torch.Tensor:
        """Corner slot shifts [L, 2^D] int64 on ``device``."""
        key = ("shifts", device)
        if key not in self._meta:
            self._meta[key] = torch.tensor(self.brick_shifts, dtype=torch.int64, device=device)
        return self._meta[key]

    def brick_fracs(self, x: torch.Tensor):
        """x [N, D] → (base slot idx [L, N] int32, folded lerp fracs [L, N, D]).

        The boundary clamp is folded into the fracs: where p0_d == res−1 the
        +1 corner would alias p0_d, so that axis's weight collapses onto the
        base corner. Hash arithmetic runs in int64 and is masked with m−1;
        m is a power of two, so the uint32 wraparound of the JAX code does
        not change the low bits."""
        D = self.n_input_dims
        idxs, fracs = [], []
        for l in range(self.n_levels):
            res, m = self.level_res[l], self.level_sizes[l]
            scale = torch.full((), self.level_scales[l], dtype=x.dtype, device=x.device)
            p = x * scale + 0.5
            p0f = torch.floor(p)
            frac = p - p0f
            p0 = p0f.to(torch.int64).clamp(0, res - 1)
            w1 = torch.where(p0 == res - 1, torch.zeros_like(frac), frac)
            if self.level_dense[l]:
                if D == 3:
                    base = p0[:, 0] + res * (p0[:, 1] + res * p0[:, 2])
                else:
                    base = p0[:, 0] + res * p0[:, 1]
            else:
                base = p0[:, 0]
                for d in range(1, D):
                    base = base + p0[:, d] * _HASH_PRIMES[d]
                base = base & (m - 1)
            idxs.append(base.to(torch.int32))
            fracs.append(w1)
        return torch.stack(idxs), torch.stack(fracs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, D] in [0,1] → [N, L·F]. A forward that autograd records
        goes through ``GridEncodeFunction``, which keeps the slots and
        fractions for the backward; any other encodes without them."""
        x = x.contiguous()
        if fused_mlp.needs_grad(x, (self.table,)):
            return table_ops.GridEncodeFunction.apply(self.table, x, self)
        return table_ops.grid_encode(self.table, x, self, with_fracs=False)[0]


class SphericalHarmonicsEncoding(nn.Module):
    """Input in [0,1]³ (warped direction) → degree² coefficients (degree ≤ 4)."""

    def __init__(self, n_input_dims: int = 3, degree: int = 4):
        super().__init__()
        if degree > 4:
            raise NotImplementedError("SH degree > 4")
        self.n_input_dims = n_input_dims
        self.degree = degree

    @property
    def n_output_dims(self) -> int:
        return self.degree**2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = x * 2.0 - 1.0
        xx, yy, zz = d[..., 0], d[..., 1], d[..., 2]
        x2, y2, z2 = xx * xx, yy * yy, zz * zz
        out = [torch.full_like(xx, 0.28209479177387814)]
        if self.degree >= 2:
            out += [-0.48860251190291987 * yy, 0.48860251190291987 * zz, -0.48860251190291987 * xx]
        if self.degree >= 3:
            xy, yz, xz = xx * yy, yy * zz, xx * zz
            out += [
                1.0925484305920792 * xy,
                -1.0925484305920792 * yz,
                0.94617469575755997 * z2 - 0.31539156525251999,
                -1.0925484305920792 * xz,
                0.54627421529603959 * (x2 - y2),
            ]
        if self.degree >= 4:
            out += [
                0.59004358992664352 * yy * (-3.0 * x2 + y2),
                2.8906114426405538 * xx * yy * zz,
                0.45704579946446572 * yy * (1.0 - 5.0 * z2),
                0.3731763325901154 * zz * (5.0 * z2 - 3.0),
                0.45704579946446572 * xx * (1.0 - 5.0 * z2),
                1.4453057213202769 * zz * (x2 - y2),
                0.59004358992664352 * xx * (-x2 + 3.0 * y2),
            ]
        return torch.stack(out, dim=-1)


class IdentityEncoding(nn.Module):
    def __init__(self, n_input_dims: int = 3, scale: float = 1.0, offset: float = 0.0):
        super().__init__()
        self.n_input_dims = n_input_dims
        self.scale = scale
        self.offset = offset

    @property
    def n_output_dims(self) -> int:
        return self.n_input_dims

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale + self.offset


class CompositeEncoding(nn.Module):
    def __init__(self, nested: Sequence[nn.Module]):
        super().__init__()
        self.nested = nn.ModuleList(nested)

    @property
    def n_input_dims(self) -> int:
        return sum(e.n_input_dims for e in self.nested)

    @property
    def n_output_dims(self) -> int:
        return sum(e.n_output_dims for e in self.nested)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs, start = [], 0
        for e in self.nested:
            outs.append(e(x[..., start : start + e.n_input_dims]))
            start += e.n_input_dims
        return torch.cat(outs, dim=-1)


GRID_OTYPES = ("HashGrid", "DenseGrid", "TiledGrid", "Grid")


def encoding_shape(cfg: dict, n_input_dims: int):
    """(output width, [(n_input_dims, n_features_per_level) of each grid
    level set]) of the encoding :func:`build_encoding` builds from ``cfg``,
    read from the config alone: nothing is built or allocated."""
    otype = cfg.get("otype", "HashGrid")
    if otype in GRID_OTYPES:
        F = cfg.get("n_features_per_level", 2)
        return cfg.get("n_levels", 16) * F, [(n_input_dims, F)]
    if otype == "SphericalHarmonics":
        return cfg.get("degree", 4) ** 2, []
    if otype == "Identity":
        return n_input_dims, []
    if otype == "Composite":
        remaining, width, grids = n_input_dims, 0, []
        for nc in cfg.get("nested", []):
            nd = nc.get("n_dims_to_encode")
            nd = min(remaining if nd is None else nd, remaining)
            if nd <= 0:
                continue
            w, g = encoding_shape(nc, nd)
            width, grids, remaining = width + w, grids + g, remaining - nd
        return width, grids
    raise NotImplementedError(f"encoding otype {otype!r} is not ported")


def build_encoding(
    cfg: dict,
    n_input_dims: int,
    per_level_scale: Optional[float] = None,
    device=None,
    generator: Optional[torch.Generator] = None,
) -> nn.Module:
    """Factory from the JSON config block (same keys as the JAX factory)."""
    otype = cfg.get("otype", "HashGrid")
    if otype in GRID_OTYPES:
        return GridEncoding(
            n_input_dims=n_input_dims,
            n_levels=cfg.get("n_levels", 16),
            n_features_per_level=cfg.get("n_features_per_level", 2),
            log2_hashmap_size=cfg.get("log2_hashmap_size", 19),
            base_resolution=cfg.get("base_resolution", 16),
            per_level_scale=per_level_scale or cfg.get("per_level_scale", 2.0),
            hash_type="dense" if otype == "DenseGrid" else "hash",
            layout=cfg.get("layout", "brick"),
            device=device,
            generator=generator,
        )
    if otype == "SphericalHarmonics":
        return SphericalHarmonicsEncoding(n_input_dims=3, degree=cfg.get("degree", 4))
    if otype == "Identity":
        return IdentityEncoding(n_input_dims=n_input_dims, scale=cfg.get("scale", 1.0), offset=cfg.get("offset", 0.0))
    if otype == "Composite":
        remaining = n_input_dims
        nested = []
        for nc in cfg.get("nested", []):
            nd = nc.get("n_dims_to_encode")
            nd = min(remaining if nd is None else nd, remaining)
            if nd <= 0:
                continue
            nested.append(build_encoding(nc, nd, per_level_scale, device, generator))
            remaining -= nd
        return CompositeEncoding(nested)
    raise NotImplementedError(f"encoding otype {otype!r} is not ported")
