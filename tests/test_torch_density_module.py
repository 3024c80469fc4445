"""The port's density module (``nerfshop_tpu_torch/torch_interop.py``)
against the JAX package's ``DensityFns`` (``nerfshop_tpu/torch_interop.py``)
at the tiny model of ``tests/test_torch_interop.py`` (4 levels, 2^10 rows,
16-wide MLPs), weights carried from JAX; and kernel J's plain version
(``ops/table_ops.py::grid_encode_dx_bwd_plain``, a closed form) against
autograd of the plain encode.

Tolerances: the forward within 1e-5 of max |features|; the backward and
the double backward within 2e-3 of the reference's norm (relative L2). Both
packages round the MLP's operands and cotangents to bf16, but a value on a
rounding boundary can round the other way under another summation order.
Kernel J's closed form within 1e-5 of max |·| of autograd (float32, the
same terms in another order)."""

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
from nerfshop_tpu_torch.ops import table_ops
from torch_one_thread import one_thread  # noqa: F401

GRID = dict(n_input_dims=3, n_levels=4, n_features_per_level=2, log2_hashmap_size=10, base_resolution=4,
            per_level_scale=1.5)
N = 48
REL = 2e-3


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def pair():
    """(JAX DensityFns, port NerfDensityModule, port model, inputs): the
    tiny model with its table scaled to O(0.1) features so that the
    encode's derivatives carry the MLP's."""
    jm = jnn.NerfNetwork(
        pos_encoding=jenc.GridEncoding(**GRID),
        dir_encoding=jenc.SphericalHarmonicsEncoding(degree=4),
        density_mlp=jmlp.MLP(n_input_dims=8, n_output_dims=16, n_neurons=16, n_hidden_layers=1),
        rgb_mlp=jmlp.MLP(n_input_dims=32, n_output_dims=3, n_neurons=16, n_hidden_layers=1),
    )
    jp = jm.init(jax.random.PRNGKey(0))
    jp["pos_encoding"]["table"] = jp["pos_encoding"]["table"] * 1e3
    tm = tnn.NerfNetwork(
        pos_encoding=tenc.GridEncoding(**GRID),
        dir_encoding=tenc.SphericalHarmonicsEncoding(degree=4),
        density_mlp=tmlp.MLP(8, 16, n_neurons=16, n_hidden_layers=1),
        rgb_mlp=tmlp.MLP(32, 3, n_neurons=16, n_hidden_layers=1),
    )
    tm.load_state_dict(weights.params_from_jax(jax.tree.map(np.asarray, jp)))
    rng = np.random.default_rng(3)
    pos = rng.uniform(0.05, 0.95, (N, 3)).astype(np.float32)
    d_out = rng.normal(size=(N, 16)).astype(np.float32)
    d_dpos = rng.normal(size=(N, 3)).astype(np.float32)
    return jinterop.DensityFns(jm, jp), tinterop.NerfDensityModule(tm), tm, (pos, d_out, d_dpos)


def test_fwd_bwd_match_jax(pair):
    jf, mod, _, (pos, d_out, _) = pair
    ref = jf.fwd_density(pos)
    out = mod.fns.fwd_density(torch.from_numpy(pos)).numpy()
    assert out.shape == (N, mod.n_density_output_dims) == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    g_ref = jf.bwd_density(pos, d_out)
    g = mod.fns.bwd_density(torch.from_numpy(pos), torch.from_numpy(d_out)).numpy()
    assert np.abs(g_ref).max() > 1.0 and _rel(g, g_ref) < REL


def test_bwd_bwd_input_matches_jax(pair):
    jf, mod, _, (pos, d_out, d_dpos) = pair
    ref_pos2, ref_dout = jf.bwd_bwd_input_density(pos, d_out, d_dpos)
    d_pos2, d_dout = mod.fns.bwd_bwd_input_density(*(torch.from_numpy(a) for a in (pos, d_out, d_dpos)))
    assert np.abs(ref_pos2).max() > 1.0 and np.abs(ref_dout).max() > 1.0
    assert _rel(d_pos2.numpy(), ref_pos2) < REL, _rel(d_pos2.numpy(), ref_pos2)
    assert _rel(d_dout.numpy(), ref_dout) < REL, _rel(d_dout.numpy(), ref_dout)


def test_module_double_backward_matches_bwd_bwd(pair):
    # the module's create_graph gradient, then a second backward, against
    # JAX's bwd_bwd_input_density (and bit-equal to the port's own)
    jf, mod, _, (pos, d_out, d_dpos) = pair
    p = torch.from_numpy(pos).requires_grad_(True)
    do = torch.from_numpy(d_out).requires_grad_(True)
    (g,) = torch.autograd.grad(mod(p), p, do, create_graph=True)
    assert g.requires_grad
    (g * torch.from_numpy(d_dpos)).sum().backward()
    ref_pos2, ref_dout = jf.bwd_bwd_input_density(pos, d_out, d_dpos)
    assert _rel(p.grad.numpy(), ref_pos2) < REL and _rel(do.grad.numpy(), ref_dout) < REL
    own_pos2, own_dout = mod.fns.bwd_bwd_input_density(*(torch.from_numpy(a) for a in (pos, d_out, d_dpos)))
    assert torch.equal(p.grad, own_pos2) and torch.equal(do.grad, own_dout)


def _encoding(seed=0):
    enc = tenc.GridEncoding(**GRID)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        enc.table.uniform_(-1.0, 1.0, generator=g)
    return enc


def _hard_points(enc, seed=0, n=96):
    """Uniform points in [-0.1, 1.1]³ (outside the unit cube too), the
    cube's corners, x = 1 on one axis and on all three (the clamp), and per
    level points in its last cell."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32)
    x[:5] = [[0, 0, 0], [1, 1, 1], [1, 0.3, 0.6], [0.2, 1, 0.7], [0.4, 0.5, 1]]
    edge = []
    for scale, res in zip(enc.level_scales, enc.level_res):
        u = min((res - 0.75) / scale, 1.0)
        edge += [[u, 0.3, 0.6], [0.2, u, 0.7], [u, u, u]]
    return torch.from_numpy(np.concatenate([x, np.asarray(edge, np.float32)]))


def test_kernel_j_plain_matches_autograd():
    enc = _encoding()
    x = _hard_points(enc)
    rng = np.random.default_rng(1)
    g = torch.from_numpy(rng.normal(size=(x.shape[0], 8)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(x.shape[0], 3)).astype(np.float32))
    dh, dx2 = table_ops.grid_encode_dx_bwd_plain(enc.table, x, g, v, enc)
    xg, gg = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
    out = table_ops.grid_encode_plain(enc.table.detach(), xg, enc, with_fracs=False)[0]
    (dx,) = torch.autograd.grad(out, xg, gg, create_graph=True)
    ref_x2, ref_h = torch.autograd.grad(dx, (xg, gg), v)
    assert float(ref_x2.abs().max()) > 1.0 and float(ref_h.abs().max()) > 1.0
    assert float((dx2 - ref_x2).abs().max()) <= 1e-5 * float(ref_x2.abs().max())
    assert float((dh - ref_h).abs().max()) <= 1e-5 * float(ref_h.abs().max())
    # the clamped axis (x = 1 at the coarsest level is in its last cell) has no derivative there
    assert float(dx2[1].abs().max()) < float(ref_x2.abs().max())


def test_grid_encode_function_second_order():
    # d_x under create_graph is recorded (GridEncodeDxFunction) and its
    # backward is kernel J's plain version
    enc = _encoding(1)
    x = _hard_points(enc, 2)
    rng = np.random.default_rng(4)
    g = torch.from_numpy(rng.normal(size=(x.shape[0], 8)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(x.shape[0], 3)).astype(np.float32))
    table = enc.table.detach()
    xg, gg = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
    (dx,) = torch.autograd.grad(table_ops.GridEncodeFunction.apply(table, xg, enc), xg, gg, create_graph=True)
    assert type(dx.grad_fn).__name__ == "GridEncodeDxFunctionBackward"
    np.testing.assert_array_equal(dx.detach().numpy(), table_ops.grid_encode_dx_plain(table, x, g, enc).numpy())
    d_x2, dh = torch.autograd.grad(dx, (xg, gg), v)
    ref_h, ref_x2 = table_ops.grid_encode_dx_bwd_plain(table, x, g, v, enc)
    assert torch.equal(d_x2, ref_x2) and torch.equal(dh, ref_h)


def test_first_order_backward_records_no_graph():
    enc = _encoding(2)
    x = _hard_points(enc, 3).requires_grad_(True)
    out = enc(x)  # the table is a parameter: GridEncodeFunction with both gradients
    d_table, d_x = torch.autograd.grad(out, (enc.table, x), torch.ones_like(out))
    assert d_x.grad_fn is None and not d_x.requires_grad and d_table.grad_fn is None


def test_table_second_order_raises():
    enc = _encoding(3)
    x = _hard_points(enc, 4).requires_grad_(True)
    out = enc(x)
    with pytest.raises(NotImplementedError, match="second-order gradient into the hash table"):
        torch.autograd.grad(out, x, torch.ones_like(out), create_graph=True)
    # the same request straight to kernel F's function
    xd = x.detach().requires_grad_(True)
    dout = torch.ones_like(out)
    dx = table_ops.GridEncodeDxFunction.apply(enc.table, xd, dout, enc)
    with pytest.raises(NotImplementedError, match="second-order gradient into the hash table"):
        dx.sum().backward()


def test_kernel_j_wrapper_refuses():
    # the CUDA route refuses a CPU tensor and shapes outside its range
    enc = _encoding()
    x = torch.rand(8, 3)
    g, v = torch.zeros(8, 8), torch.zeros(8, 3)
    with pytest.raises(ValueError, match="expected a CUDA device"):
        table_ops.grid_encode_dx_bwd_cuda(enc.table.detach(), x, g, v, enc)
    enc2 = tenc.GridEncoding(n_input_dims=2, n_levels=2, log2_hashmap_size=8)
    with pytest.raises(ValueError, match="D=3, F=2"):
        table_ops.grid_encode_dx_bwd_cuda(enc2.table.detach(), torch.rand(8, 2), torch.zeros(8, 4), torch.zeros(8, 2), enc2)
