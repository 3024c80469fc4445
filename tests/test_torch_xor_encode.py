"""Kernels K and L's plain versions (``nerfshop_tpu_torch/ops/xor_encode.py``)
against the JAX package: the plain grid layout (``GridEncoding(layout=
"plain")``, D = 3 and 2) and the Takikawa encoding (F = 2 and 8, both
``sum_instead_of_concat`` settings, levels whose size is not a power of two
and levels deeper than the octree's dense pyramid), forward, table gradient
and position gradient against ``apply``, ``jax.grad`` and ``jax.vjp``, with
points on cell faces, at exactly 0 and 1 and outside the box. On the CPU the
wrappers run the plain versions; the CUDA kernels are held to them on the
card by ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfshop_tpu.geometry.triangle_octree import TriangleOctree as JOctree
from nerfshop_tpu.models import encodings as jenc
from nerfshop_tpu_torch.geometry.triangle_octree import TriangleOctree as TOctree
from nerfshop_tpu_torch.models import encodings as tenc
from nerfshop_tpu_torch.ops import xor_encode

from test_bvh import icosphere
from torch_one_thread import one_thread  # noqa: F401

#: forward and gradients: float32 sums in another order than XLA's
ATOL = 2e-6


def _face_points(scales, D, rng):
    """Points whose p = x·scale + 0.5 is an integer on one axis (a cell
    face) for each level, plus 0 and 1 on every axis."""
    pts = []
    for s in scales:
        k = rng.integers(0, int(s) + 1, (6, D))
        x = rng.uniform(0, 1, (6, D))
        axis = rng.integers(0, D, 6)
        x[np.arange(6), axis] = (k[np.arange(6), axis] - 0.5) / s
        pts.append(x)
    corners = np.array([[(c >> d) & 1 for d in range(D)] for c in range(1 << D)], np.float64)
    return np.concatenate(pts + [corners])


def _points(D, scales, seed):
    rng = np.random.default_rng(seed)
    uni = rng.uniform(0, 1, (200, D))
    outside = rng.uniform(-0.15, 1.15, (60, D))
    mixed = rng.uniform(0, 1, (20, D))
    mixed[:10, 0], mixed[10:, -1] = 0.0, 1.0
    return np.concatenate([uni, outside, mixed, _face_points(scales, D, rng)]).astype(np.float32)


def _vjp(jfn, params, x, dout):
    out, vjp = jax.vjp(jfn, params, jnp.asarray(x))
    g_params, g_x = vjp(jnp.asarray(dout))
    return np.asarray(out), g_params, np.asarray(g_x)


def _port_grads(enc, x, dout):
    xt = torch.from_numpy(x).requires_grad_(True)
    out = enc(xt)
    out.backward(torch.from_numpy(dout))
    return out.detach().numpy(), enc.table.grad.numpy(), xt.grad.numpy()


@pytest.mark.parametrize("D,log2_T", [(3, 10), (2, 8)])
def test_plain_layout_against_jax(D, log2_T):
    kw = dict(n_input_dims=D, n_levels=4, n_features_per_level=2, log2_hashmap_size=log2_T, base_resolution=4,
              per_level_scale=2.3)
    je = jenc.GridEncoding(layout="plain", **kw)
    te = tenc.GridEncoding(layout="plain", device="cpu", **kw)
    for name in ("level_scales", "level_res", "level_sizes", "level_dense", "level_offsets", "table_size"):
        assert getattr(te, name) == getattr(je, name), name
    assert any(je.level_dense) and not all(je.level_dense)  # dense and hashed levels both
    assert all(m % 8 == 0 or d for m, d in zip(je.level_sizes, je.level_dense))
    rng = np.random.default_rng(11)
    table = rng.uniform(-1, 1, (je.table_size, 2)).astype(np.float32)
    x = _points(D, je.level_scales, seed=3)
    dout = rng.normal(size=(x.shape[0], je.n_output_dims)).astype(np.float32)
    ref, g_params, g_x = _vjp(lambda p, xx: je.apply(p, xx), {"table": jnp.asarray(table)}, x, dout)
    with torch.no_grad():
        te.table.copy_(torch.from_numpy(table))
        plain = xor_encode.xor_encode_plain(te.table, torch.from_numpy(x), te).numpy()
    np.testing.assert_allclose(plain, ref, rtol=0, atol=ATOL)
    out, d_table, d_x = _port_grads(te, x, dout)
    np.testing.assert_array_equal(out, plain)
    np.testing.assert_allclose(d_table, np.asarray(g_params["table"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(d_x, g_x, rtol=1e-5, atol=1e-3)
    # the slots: the plain version's rows are JAX's gather indices
    idx, _ = je._corner_indices(jnp.asarray(x))
    for l, lv in enumerate(te.xor_levels):
        rows, _, _ = xor_encode.level_corners(torch.from_numpy(x), te, lv, False)
        np.testing.assert_array_equal(rows.numpy(), np.asarray(idx)[:, l])


def test_plain_layout_raises_in_the_brick_helpers():
    te = tenc.GridEncoding(n_levels=2, log2_hashmap_size=8, layout="plain", device="cpu")
    for call in (lambda: te.kernel_meta(torch.device("cpu")), te.kernel_records,
                 lambda: te.shift_table(torch.device("cpu")), lambda: te.brick_fracs(torch.zeros((1, 3)))):
        with pytest.raises(ValueError, match="plain"):
            call()


def _mesh():
    m = icosphere(subdiv=2)
    v = 0.5 + (m.vertices - 0.5) * 0.7
    return v.astype(np.float32), np.asarray(m.faces, np.int64)


@pytest.fixture(scope="module")
def octrees():
    v, f = _mesh()
    # dense pyramid to depth 4: depth 5 reads depth 4's mask
    return JOctree.build(v, f, 5, max_dense_depth=4), TOctree.build(v, f, 5, max_dense_depth=4)


@pytest.mark.parametrize("F,summed", [(2, False), (8, False), (8, True), (2, True)])
def test_takikawa_against_jax(octrees, F, summed):
    jo, to = octrees
    kw = dict(n_levels=4, starting_level=2, n_features_per_level=F, log2_hashmap_size=13, sum_instead_of_concat=summed)
    je = jenc.TakikawaEncoding(octree=jo, **kw)
    te = tenc.TakikawaEncoding(to, device="cpu", **kw)
    assert te.level_sizes == je.level_sizes and te.level_offsets[-1] == je.table_size
    assert any(m & (m - 1) for m in je.level_sizes)  # a level whose modulo is a real %
    assert te.xor_levels[3].mask_res == 16 and te.xor_levels[3].mask_off == te.xor_levels[2].mask_off
    rng = np.random.default_rng(5)
    table = rng.uniform(-1, 1, (je.table_size, F)).astype(np.float32)
    x = _points(3, [float(1 << d) - 0.5 for d in range(2, 6)], seed=9)
    x = np.concatenate([x, np.array([[0.5, 0.5, 0.5], [1.0, 1.0, 1.0], [0.0, 0.5, 1.0]], np.float32)])
    dout = rng.normal(size=(x.shape[0], je.n_output_dims)).astype(np.float32)
    ref, g_params, g_x = _vjp(lambda p, xx: je.apply(p, xx), {"table": jnp.asarray(table)}, x, dout)
    assert (ref == 0).all(axis=1).any() and not (ref == 0).all()  # points outside the octree too
    with torch.no_grad():
        te.table.copy_(torch.from_numpy(table))
    out, d_table, d_x = _port_grads(te, x, dout)
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL * F)
    np.testing.assert_allclose(d_table, np.asarray(g_params["table"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(d_x, g_x, rtol=1e-5, atol=1e-3)


def test_takikawa_clip_ties_as_jax(octrees):
    # the derivative of clip at exactly 0 and 1 is 1/2 in JAX (a tie of
    # max/min), 0 outside [0, 1]: the plain version's minimum(maximum())
    jo, to = octrees
    je = jenc.TakikawaEncoding(octree=jo, n_levels=2, starting_level=2, n_features_per_level=2, log2_hashmap_size=9)
    te = tenc.TakikawaEncoding(to, n_levels=2, starting_level=2, n_features_per_level=2, log2_hashmap_size=9, device="cpu")
    table = np.random.default_rng(2).uniform(-1, 1, (je.table_size, 2)).astype(np.float32)
    x = np.array([[0.0, 0.5, 0.5], [1.0, 0.5, 0.5], [1.2, 0.5, 0.5], [-0.3, 0.5, 0.5], [0.5, 0.5, 0.5]], np.float32)
    dout = np.ones((5, 4), np.float32)
    _, _, g_x = _vjp(lambda p, xx: je.apply(p, xx), {"table": jnp.asarray(table)}, x, dout)
    _, dx = xor_encode.xor_encode_bwd_plain(torch.from_numpy(table), torch.from_numpy(x), torch.from_numpy(dout), te)
    np.testing.assert_allclose(dx.numpy(), g_x, rtol=1e-6, atol=1e-6)
    assert (dx.numpy()[2:4, 0] == 0).all()


def test_bwd_plain_asks_for_what_it_is_asked(octrees):
    _, to = octrees
    te = tenc.TakikawaEncoding(to, n_levels=3, starting_level=2, n_features_per_level=4, log2_hashmap_size=9, device="cpu")
    x = torch.rand((64, 3), generator=torch.Generator().manual_seed(0))
    dout = torch.randn((64, te.n_output_dims), generator=torch.Generator().manual_seed(1))
    dt, dx = xor_encode.xor_encode_bwd(te.table, x, dout, te, want_table=True, want_dx=False)
    assert dx is None and dt.shape == te.table.shape
    dt2, dx2 = xor_encode.xor_encode_bwd(te.table, x, dout, te, want_table=False, want_dx=True)
    assert dt2 is None and dx2.shape == x.shape
    # the table gradient is an index_add of w · dout into every corner's row
    ref = torch.zeros_like(te.table)
    for l, lv in enumerate(te.xor_levels):
        rows, w, inside = xor_encode.level_corners(x, te, lv, True)
        vals = (w * inside[:, None])[:, :, None] * dout[:, None, l * 4:(l + 1) * 4]
        ref.index_add_(0, rows.reshape(-1), vals.reshape(-1, 4))
    torch.testing.assert_close(dt, ref, rtol=0, atol=1e-6)


def test_second_order_raises(octrees):
    # a create_graph gradient into the table raises (the table is the
    # encoding's parameter here); with the table detached, one into x is
    # recorded and its backward is kernel M's plain version
    _, to = octrees
    te = tenc.TakikawaEncoding(to, n_levels=2, starting_level=2, n_features_per_level=2, log2_hashmap_size=9, device="cpu")
    x = torch.rand((8, 3), generator=torch.Generator().manual_seed(0)).requires_grad_(True)
    out = te(x).sum()
    with pytest.raises(NotImplementedError, match="second-order gradient into the hash table"):
        torch.autograd.grad(out, x, create_graph=True)
    out = xor_encode.XorEncodeFunction.apply(te.table.detach(), x, te)
    (dx,) = torch.autograd.grad(out.sum(), x, create_graph=True)
    assert dx.requires_grad
    (dx2,) = torch.autograd.grad((dx * dx).sum(), x)
    _, ref = xor_encode.xor_encode_dx_bwd_plain(te.table, x, torch.ones_like(out), 2 * dx.detach(), te)
    assert float(ref.abs().max()) > 0
    torch.testing.assert_close(dx2, ref, rtol=0, atol=1e-6 * float(ref.abs().max()))


@pytest.mark.parametrize("D,F,takikawa,L,ok", [
    (3, 2, False, 16, True), (2, 2, False, 8, True), (3, 4, False, 16, False), (3, 8, True, 10, True),
    (3, 4, True, 10, True), (3, 3, True, 10, False), (2, 2, True, 4, False), (3, 2, False, 33, False),
])
def test_kernel_range(D, F, takikawa, L, ok):
    if ok:
        xor_encode.check_supported(D, F, takikawa, L)
    else:
        with pytest.raises(ValueError, match="kernels K and L"):
            xor_encode.check_supported(D, F, takikawa, L)
