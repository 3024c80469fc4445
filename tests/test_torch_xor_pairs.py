"""What kernels K and L (``nerfshop_tpu_torch/csrc/xor_encode.cu``) rely on
to read and add an x-neighbour pair of corners in one 16-byte access,
checked on the port's ``level_corners`` and on JAX's ``_corner_indices``:

* on a power-of-two hashed level, at an even p0.x below res − 1, the x + 1
  corner's row is the x corner's row xor 1 (its slot xor 1 in a level whose
  offset is even);
* at p0.x = res − 1 (the plain layout's clamp) both x corners are one row;
* on a dense level, below the clamp, the x + 1 corner is the next row;
* level offsets are multiples of 8 in both packages;
* a dense level's local index is below res^D, so the modulo JAX takes there
  is the identity and the kernels skip it.

The levels are the default NeRF config's plain layout, the Image config's
2-D one (at a 2^16 table) and the Takikawa encoding's defaults."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfshop_tpu.config import default_image_config, default_nerf_config
from nerfshop_tpu.models import encodings as jenc
from nerfshop_tpu.models import nerf_network as jnet
from nerfshop_tpu_torch.models import encodings as tenc
from nerfshop_tpu_torch.models import nerf_network as tnet
from nerfshop_tpu_torch.ops import xor_encode

from torch_one_thread import one_thread  # noqa: F401


class _FullOctree:
    """An octree stand-in whose occupancy is one full cell at every depth:
    the Takikawa encoding's levels without a mesh."""

    levels = [None]

    @staticmethod
    def occupancy_at_depth(depth):
        return np.ones((1, 1, 1), bool)


def _encodings(kind):
    """(the port's encoding, JAX's or None) of ``kind``: the default NeRF
    config's plain grid (its automatic per_level_scale), the Image config's
    2-D plain grid at a 2^16 table (its dense and hashed levels, a table
    the CPU can hold), the Takikawa defaults."""
    if kind == "takikawa":
        return tenc.TakikawaEncoding(_FullOctree(), device="cpu"), None
    if kind == "nerf":
        cfg = default_nerf_config()
        cfg["encoding"] = {**cfg["encoding"], "layout": "plain"}
        return tnet.build_nerf_network(cfg, device="cpu").pos_encoding, jnet.build_nerf_network(cfg).pos_encoding
    cfg = {**default_image_config()["encoding"], "layout": "plain", "log2_hashmap_size": 16}
    return tenc.build_encoding(cfg, 2, device="cpu"), jenc.build_encoding(cfg, 2)


KINDS = ("nerf", "image", "takikawa")


def _points_at(lv, px, takikawa, n, seed, D):
    """n seeded points whose cell on axis 0 at level ``lv`` is ``px``
    (p0.x = px), the other axes uniform in [0, 1)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, D))
    frac = rng.uniform(0.05, 0.95, n)
    x[:, 0] = (px + frac) / lv.scale if takikawa else (px + frac - 0.5) / lv.scale
    return x.astype(np.float32)


def _p0x(x, lv, takikawa):
    xt = torch.from_numpy(x[:, 0])
    if takikawa:
        return torch.floor(xt.clamp(0, 1) * float(lv.res)).long().clamp(0, lv.res - 1)
    return torch.floor(xt * torch.tensor(lv.scale, dtype=torch.float32) + 0.5).long()


def _rows(enc, lv, x):
    rows, _, _ = xor_encode.level_corners(torch.from_numpy(x), enc, lv, enc.takikawa)
    return rows


@pytest.mark.parametrize("kind", KINDS)
def test_power_of_two_hashed_pair_is_xor_one(kind):
    enc, je = _encodings(kind)
    D = enc.n_input_dims
    hashed = [l for l, lv in enumerate(enc.xor_levels) if not lv.dense and lv.m & (lv.m - 1) == 0]
    assert hashed, "no power-of-two hashed level"
    for l in hashed:
        lv = enc.xor_levels[l]
        assert lv.offset % 2 == 0
        rng = np.random.default_rng(l)
        px = 2 * rng.integers(0, (lv.res - 1) // 2, 64)  # even and below res - 1
        x = np.concatenate([_points_at(lv, int(p), enc.takikawa, 1, 100 * l + i, D) for i, p in enumerate(px)])
        p0x = _p0x(x, lv, enc.takikawa)
        assert bool((p0x % 2 == 0).all()) and bool((p0x < lv.res - 1).all())
        rows = _rows(enc, lv, x)
        low, high = rows[:, 0::2], rows[:, 1::2]  # corner 2j and 2j + 1: the same y, z; x and x + 1
        # the two rows are one aligned 16-byte span of 8-byte rows, in either order
        assert torch.equal(high, low ^ 1), f"level {l}"
        assert torch.equal(high - lv.offset, (low - lv.offset) ^ 1), f"level {l}"
        if je is not None:
            idx, _ = je._corner_indices(jnp.asarray(x))
            idx = np.asarray(idx)[:, l]
            np.testing.assert_array_equal(idx[:, 1::2], idx[:, 0::2] ^ 1)
            np.testing.assert_array_equal(idx, rows.numpy())


@pytest.mark.parametrize("kind", ("nerf", "image"))
def test_clamped_x_corners_share_a_row(kind):
    enc, je = _encodings(kind)
    D = enc.n_input_dims
    for l, lv in enumerate(enc.xor_levels):
        x = _points_at(lv, lv.res - 1, False, 32, l, D)
        assert bool((_p0x(x, lv, False) == lv.res - 1).all())
        rows = _rows(enc, lv, x)
        assert torch.equal(rows[:, 1::2], rows[:, 0::2]), f"level {l}"
        idx = np.asarray(je._corner_indices(jnp.asarray(x))[0])[:, l]
        np.testing.assert_array_equal(idx[:, 1::2], idx[:, 0::2])


@pytest.mark.parametrize("kind", ("nerf", "image"))
def test_dense_pair_is_the_next_row(kind):
    enc, je = _encodings(kind)
    D = enc.n_input_dims
    dense = [l for l, lv in enumerate(enc.xor_levels) if lv.dense]
    assert dense
    for l in dense:
        lv = enc.xor_levels[l]
        rng = np.random.default_rng(l)
        px = rng.integers(0, lv.res - 1, 48)  # even and odd, below the clamp
        x = np.concatenate([_points_at(lv, int(p), False, 1, 100 * l + i, D) for i, p in enumerate(px)])
        assert bool((_p0x(x, lv, False) < lv.res - 1).all())
        rows = _rows(enc, lv, x)
        assert torch.equal(rows[:, 1::2], rows[:, 0::2] + 1), f"level {l}"
        idx = np.asarray(je._corner_indices(jnp.asarray(x))[0])[:, l]
        np.testing.assert_array_equal(idx[:, 1::2], idx[:, 0::2] + 1)


@pytest.mark.parametrize("kind", KINDS)
def test_level_offsets_are_multiples_of_8(kind):
    enc, je = _encodings(kind)
    offsets = [lv.offset for lv in enc.xor_levels]
    assert all(o % 8 == 0 for o in offsets), offsets
    if kind == "takikawa":
        je = jenc.TakikawaEncoding(octree=None)  # the sizes need no octree
        assert je.level_sizes[:3] == [4920, 35944, 274632]
    assert offsets == list(je.level_offsets[:-1])
    assert all(o % 8 == 0 for o in je.level_offsets)


@pytest.mark.parametrize("kind", ("nerf", "image"))
def test_dense_local_index_is_below_res_pow_d(kind):
    enc, je = _encodings(kind)
    D = enc.n_input_dims
    rng = np.random.default_rng(5)
    faces = rng.uniform(0, 1, (2 * D * 16, D))
    for d in range(D):
        faces[32 * d:32 * d + 16, d], faces[32 * d + 16:32 * d + 32, d] = 0.0, 1.0
    x = np.concatenate([rng.uniform(0, 1, (400, D)), rng.uniform(-0.2, 1.2, (200, D)), faces]).astype(np.float32)
    idx = np.asarray(je._corner_indices(jnp.asarray(x))[0])
    for l, lv in enumerate(enc.xor_levels):
        if not lv.dense:
            continue
        assert lv.res**D <= lv.m
        local = idx[:, l] - je.level_offsets[l]
        assert local.min() >= 0 and local.max() < lv.res**D, f"level {l}"
        np.testing.assert_array_equal(_rows(enc, lv, x).numpy() - lv.offset, local)
