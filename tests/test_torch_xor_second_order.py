"""The second order through the xor-hashed tables: kernel M's plain version
(``nerfshop_tpu_torch/ops/xor_encode.py::xor_encode_dx_bwd_plain``, a closed
form) and ``XorEncodeDxFunction`` against the JAX package. The port's
density module over a plain-layout NeRF (``GridEncoding(layout="plain")``:
4 levels, 2^12 rows, the first level dense) against JAX's
``DensityFns.bwd_bwd_input_density``, weights carried from JAX; the
Takikawa encoding's ``create_graph`` double backward against ``jax.grad``
of its VJP; the closed form against autograd's double backward of
``xor_encode_plain`` at the edges (every level's top cell, the dense level,
cell faces, exactly 0 and 1, outside the box, empty mask cells).

Tolerances: the density module's double backward within 2e-3 of the
reference's norm (relative L2), the bound of
``tests/test_torch_density_module.py``: both packages round the MLP's
operands and cotangents to bf16, and a value on a rounding boundary can
round the other way under another summation order. Takikawa's second
order within 1e-5 of max |·| of JAX's (float32, the same terms in another
order). The closed form within 1e-9 of max |·| of autograd in float64 (the
same cells; only the order of the sums differs) and within 1e-5 in
float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfshop_tpu import torch_interop as jinterop
from nerfshop_tpu.models import encodings as jenc
from nerfshop_tpu.models import mlp as jmlp
from nerfshop_tpu.models import nerf_network as jnn
from nerfshop_tpu_torch import torch_interop as tinterop
from nerfshop_tpu_torch import weights
from nerfshop_tpu_torch.models import encodings as tenc
from nerfshop_tpu_torch.models import mlp as tmlp
from nerfshop_tpu_torch.models import nerf_network as tnn
from nerfshop_tpu_torch.ops import xor_encode
from test_torch_xor_encode import _points, octrees  # noqa: F401
from torch_one_thread import one_thread  # noqa: F401

GRID = dict(n_input_dims=3, n_levels=4, n_features_per_level=2, log2_hashmap_size=12, base_resolution=12,
            per_level_scale=1.5)
N = 64
REL = 2e-3


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _top_cells(enc):
    """Per level, points in its top cell on one axis and on all three (the
    clamped corners read one row), and on a cell face."""
    pts = []
    for lv in enc.xor_levels:
        u = min((lv.res - 0.75) / lv.scale, 1.0)
        face = (lv.res // 2 - 0.5) / lv.scale
        pts += [[u, 0.3, 0.6], [0.2, u, 0.7], [0.4, 0.55, u], [u, u, u], [face, 0.35, 0.65]]
    return np.asarray(pts, np.float32)


@pytest.fixture(scope="module")
def plain_pair():
    """(JAX DensityFns, port NerfDensityModule, inputs) over the tiny NeRF
    with a plain-layout grid, its table scaled to O(0.1) features so that
    the encode's derivatives carry the MLP's."""
    jm = jnn.NerfNetwork(
        pos_encoding=jenc.GridEncoding(layout="plain", **GRID),
        dir_encoding=jenc.SphericalHarmonicsEncoding(degree=4),
        density_mlp=jmlp.MLP(n_input_dims=8, n_output_dims=16, n_neurons=16, n_hidden_layers=1),
        rgb_mlp=jmlp.MLP(n_input_dims=32, n_output_dims=3, n_neurons=16, n_hidden_layers=1),
    )
    assert jm.pos_encoding.level_dense == [True, False, False, False]
    jp = jm.init(jax.random.PRNGKey(0))
    jp["pos_encoding"]["table"] = jp["pos_encoding"]["table"] * 1e3
    tm = tnn.NerfNetwork(
        pos_encoding=tenc.GridEncoding(layout="plain", device="cpu", **GRID),
        dir_encoding=tenc.SphericalHarmonicsEncoding(degree=4),
        density_mlp=tmlp.MLP(8, 16, n_neurons=16, n_hidden_layers=1),
        rgb_mlp=tmlp.MLP(32, 3, n_neurons=16, n_hidden_layers=1),
    )
    tm.load_state_dict(weights.params_from_jax(jax.tree.map(np.asarray, jp)))
    rng = np.random.default_rng(3)
    pos = np.concatenate([rng.uniform(0.05, 0.95, (N, 3)).astype(np.float32), _top_cells(tm.pos_encoding)])
    d_out = rng.normal(size=(pos.shape[0], 16)).astype(np.float32)
    d_dpos = rng.normal(size=(pos.shape[0], 3)).astype(np.float32)
    return jinterop.DensityFns(jm, jp), tinterop.NerfDensityModule(tm), (pos, d_out, d_dpos)


def test_plain_layout_density_bwd_bwd_matches_jax(plain_pair):
    jf, mod, (pos, d_out, d_dpos) = plain_pair
    ref_pos2, ref_dout = jf.bwd_bwd_input_density(pos, d_out, d_dpos)
    d_pos2, d_dout = mod.fns.bwd_bwd_input_density(*(torch.from_numpy(a) for a in (pos, d_out, d_dpos)))
    assert np.abs(ref_pos2).max() > 1.0 and np.abs(ref_dout).max() > 1.0
    assert _rel(d_pos2.numpy(), ref_pos2) < REL, _rel(d_pos2.numpy(), ref_pos2)
    assert _rel(d_dout.numpy(), ref_dout) < REL, _rel(d_dout.numpy(), ref_dout)


def test_plain_layout_module_eikonal_double_backward(plain_pair):
    # the module's create_graph gradient, then a second backward: what
    # bwd_bwd_input_density gives, bit for bit, and JAX's
    jf, mod, (pos, d_out, d_dpos) = plain_pair
    p = torch.from_numpy(pos).requires_grad_(True)
    do = torch.from_numpy(d_out).requires_grad_(True)
    (g,) = torch.autograd.grad(mod(p), p, do, create_graph=True)
    assert g.requires_grad
    (g * torch.from_numpy(d_dpos)).sum().backward()
    own_pos2, own_dout = mod.fns.bwd_bwd_input_density(*(torch.from_numpy(a) for a in (pos, d_out, d_dpos)))
    assert torch.equal(p.grad, own_pos2) and torch.equal(do.grad, own_dout)
    ref_pos2, _ = jf.bwd_bwd_input_density(pos, d_out, d_dpos)
    assert _rel(p.grad.numpy(), ref_pos2) < REL
    # an eikonal-style loss reaches the positions
    q = torch.from_numpy(pos).requires_grad_(True)
    (grad,) = torch.autograd.grad(mod(q)[:, 0].sum(), q, create_graph=True)
    ((grad.norm(dim=-1) - 1.0) ** 2).mean().backward()
    assert bool(torch.isfinite(q.grad).all()) and float(q.grad.abs().max()) > 0


@pytest.mark.parametrize("F,summed", [(2, False), (8, False), (8, True), (4, False)])
def test_takikawa_second_order_matches_jax(octrees, F, summed):  # noqa: F811
    jo, to = octrees
    kw = dict(n_levels=4, starting_level=2, n_features_per_level=F, log2_hashmap_size=13, sum_instead_of_concat=summed)
    je = jenc.TakikawaEncoding(octree=jo, **kw)
    te = tenc.TakikawaEncoding(to, device="cpu", **kw)
    rng = np.random.default_rng(7)
    table = rng.uniform(-1, 1, (je.table_size, F)).astype(np.float32)
    x = _points(3, [float(1 << d) - 0.5 for d in range(2, 6)], seed=9)
    x = np.concatenate([x, np.array([[0.5, 0.5, 0.5], [1.0, 1.0, 1.0], [0.0, 0.5, 1.0]], np.float32)])
    g = rng.normal(size=(x.shape[0], je.n_output_dims)).astype(np.float32)
    v = rng.normal(size=(x.shape[0], 3)).astype(np.float32)

    def dx_dot(xx, gg):
        _, vjp = jax.vjp(lambda y: je.apply({"table": jnp.asarray(table)}, y), xx)
        return jnp.sum(vjp(gg)[0] * v)

    ref_x2, ref_h = (np.asarray(a) for a in jax.grad(dx_dot, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(g)))
    xt = torch.from_numpy(x).requires_grad_(True)
    gt = torch.from_numpy(g).requires_grad_(True)
    out = xor_encode.XorEncodeFunction.apply(torch.from_numpy(table), xt, te)
    (dx,) = torch.autograd.grad(out, xt, gt, create_graph=True)
    d_x2, dh = torch.autograd.grad(dx, (xt, gt), torch.from_numpy(v))
    assert np.abs(ref_x2).max() > 1.0 and np.abs(ref_h).max() > 1.0
    # points in empty cells: no feature, so no second order either
    empty = (ref_h == 0).all(axis=1)
    assert empty.any() and not empty.all()
    np.testing.assert_allclose(dh.numpy(), ref_h, rtol=0, atol=1e-5 * np.abs(ref_h).max())
    np.testing.assert_allclose(d_x2.numpy(), ref_x2, rtol=0, atol=1e-5 * np.abs(ref_x2).max())
    assert (d_x2.numpy()[empty] == 0).all()


def _plain_encoding(n_levels=GRID["n_levels"]):
    enc = tenc.GridEncoding(layout="plain", device="cpu", **{**GRID, "n_levels": n_levels})
    with torch.no_grad():
        enc.table.uniform_(-1.0, 1.0, generator=torch.Generator().manual_seed(0))
    return enc


def _closed_form_against_autograd(enc, x, dtype, tol):
    rng = np.random.default_rng(1)
    g = torch.from_numpy(rng.normal(size=(x.shape[0], enc.n_output_dims))).to(dtype)
    v = torch.from_numpy(rng.normal(size=(x.shape[0], 3))).to(dtype)
    x, table = x.to(dtype), enc.table.detach().to(dtype)
    dh, dx2 = xor_encode.xor_encode_dx_bwd_plain(table, x, g, v, enc)
    assert dh.dtype == dx2.dtype == dtype
    xg, gg = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
    (dx,) = torch.autograd.grad(xor_encode.xor_encode_plain(table, xg, enc), xg, gg, create_graph=True)
    ref_x2, ref_h = torch.autograd.grad(dx, (xg, gg), v)
    assert float(ref_x2.abs().max()) > 1.0 and float(ref_h.abs().max()) > 1.0
    assert float((dh - ref_h).abs().max()) <= tol * float(ref_h.abs().max())
    assert float((dx2 - ref_x2).abs().max()) <= tol * float(ref_x2.abs().max())
    return dh, dx2


@pytest.mark.parametrize("n_levels", [4, 15])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9), (torch.float32, 1e-5)])
def test_kernel_m_plain_layout_closed_form_at_the_edges(dtype, tol, n_levels):
    # 15 levels: dense and hashed levels, and on the card the second lane of
    # a sample runs one level fewer than the first
    enc = _plain_encoding(n_levels)
    x = torch.from_numpy(np.concatenate([_points(3, enc.level_scales, seed=4), _top_cells(enc)]))
    dh, dx2 = _closed_form_against_autograd(enc, x, dtype, tol)
    # at exactly 1 every axis sits in the top cell of each level whose
    # position floor(scale + 1/2) reaches res - 1: the two clamped corners
    # read one row, so that level's terms cancel
    top = (x == 1.0).all(dim=1)
    levels = [l for l, lv in enumerate(enc.xor_levels) if np.floor(np.float32(lv.scale) + np.float32(0.5)) >= lv.res - 1]
    cols = [2 * l + q for l in levels for q in (0, 1)]
    assert top.any() and len(levels) >= n_levels // 2
    assert float(dh[top][:, cols].abs().max()) <= 1e-6 * float(dh.abs().max())


@pytest.mark.parametrize("F,summed", [(2, False), (8, True), (4, False), (2, True)])
def test_kernel_m_takikawa_closed_form_at_the_edges(octrees, F, summed):  # noqa: F811
    _, to = octrees
    te = tenc.TakikawaEncoding(to, n_levels=4, starting_level=2, n_features_per_level=F, log2_hashmap_size=13,
                               sum_instead_of_concat=summed, device="cpu")
    with torch.no_grad():
        te.table.uniform_(-1.0, 1.0, generator=torch.Generator().manual_seed(2))
    x = _points(3, [float(1 << d) - 0.5 for d in range(2, 6)], seed=5)
    x = torch.from_numpy(np.concatenate([x, np.array([[0.0, 0.5, 0.5], [1.0, 0.5, 0.5], [0.5, 1.0, 0.0]], np.float32)]))
    for dtype, tol in ((torch.float64, 1e-9), (torch.float32, 1e-5)):
        _closed_form_against_autograd(te, x, dtype, tol)


def test_kernel_m_wrapper_range_and_cpu_dispatch():
    enc = _plain_encoding()
    x = torch.rand((16, 3), generator=torch.Generator().manual_seed(3))
    g, v = torch.randn((16, 8)), torch.randn((16, 3))
    got = xor_encode.xor_encode_dx_bwd(enc.table, x, g, v, enc)
    ref = xor_encode.xor_encode_dx_bwd_plain(enc.table, x, g, v, enc)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    enc2 = tenc.GridEncoding(n_input_dims=2, n_levels=2, log2_hashmap_size=8, layout="plain", device="cpu")
    with pytest.raises(ValueError, match="kernel M"):
        xor_encode.check_dx_bwd_supported(enc2)
    # a CUDA tensor never takes the plain version: without a card it raises
    with pytest.raises(ValueError, match="CUDA device"):
        xor_encode.xor_encode_dx_bwd_cuda(enc.table.detach(), x, g, v, enc)
