"""The port's encodings against ``nerfshop_tpu/models/encodings.py`` on the
same inputs and the same table."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfshop_tpu.models import encodings as jenc
from nerfshop_tpu_torch.models import encodings as tenc
from nerfshop_tpu_torch.ops import table_ops

# (L, log2 T, base res, per-level scale): all-dense levels, and mostly hashed ones
CONFIGS = {
    "dense": dict(n_levels=3, log2_hashmap_size=14, base_resolution=4, per_level_scale=1.5),
    "hash": dict(n_levels=4, log2_hashmap_size=12, base_resolution=8, per_level_scale=2.2),
}


def _pair(name, seed=0):
    kw = dict(n_input_dims=3, n_features_per_level=2, **CONFIGS[name])
    je = jenc.GridEncoding(**kw)
    te = tenc.GridEncoding(**kw)
    table = np.asarray(je.init(jax.random.PRNGKey(seed))["table"]) * 1e3  # O(0.1) features
    with torch.no_grad():
        te.table.copy_(torch.from_numpy(table))
    return je, te, table


def _points(seed, n=512):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    x[:8] = [[0, 0, 0], [1, 1, 1], [1, 0, 0.5], [0.5, 1, 0], [0.999999, 0.5, 1], [0, 1, 1], [0.25, 0.5, 0.75], [1, 1, 0]]
    return x


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_level_metadata_matches(name):
    je, te, _ = _pair(name)
    assert te.level_sizes == je.level_sizes
    assert te.level_offsets == je.level_offsets
    assert te.level_res == je.level_res
    assert te.level_dense == je.level_dense
    assert te.level_scales == je.level_scales
    assert te.brick_shifts == je._brick_shifts
    assert te.table_size == je.table_size
    assert all(m % 128 == 0 for m in te.level_sizes)
    if name == "dense":
        assert all(te.level_dense)
    else:
        assert any(te.level_dense) and not all(te.level_dense)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_brick_fracs_match(name):
    # slots exact; fracs within 1e-6
    je, te, _ = _pair(name)
    x = _points(1)
    ji, jw = je._brick_fracs(jnp.asarray(x))
    ti, tw = te.brick_fracs(torch.from_numpy(x))
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)


#: (config, with_fracs): the ids of the with-fracs cases are the configs'
FORWARD_CASES = [pytest.param(n, True, id=n) for n in sorted(CONFIGS)] + [
    pytest.param(n, False, id=f"{n}-without_fracs") for n in sorted(CONFIGS)
]


@pytest.mark.parametrize("name,with_fracs", FORWARD_CASES)
def test_forward_matches_apply(name, with_fracs):
    # fp32, other summation order over the corners: atol 1e-6; the two modes
    # and the module's own (fracs-free, no gradient) forward bit-equal
    je, te, table = _pair(name)
    x = _points(2)
    ref = np.asarray(je.apply({"table": jnp.asarray(table)}, jnp.asarray(x)))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        ours, idx, w1 = table_ops.grid_encode(te.table, xt, te, with_fracs=with_fracs)
        other = table_ops.grid_encode(te.table, xt, te, with_fracs=not with_fracs)[0]
        module = te(xt)
    assert (idx is not None, w1 is not None) == (with_fracs, with_fracs)
    if with_fracs:
        assert idx.shape == (te.n_levels, x.shape[0]) and w1.shape == (te.n_levels, x.shape[0], 3)
    assert torch.equal(ours, other) and torch.equal(ours, module)
    assert ours.shape == ref.shape == (x.shape[0], te.n_output_dims)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-6)


def _spy_fracs(monkeypatch):
    """Record the ``with_fracs`` of every call of the plain encode."""
    seen = []
    plain = table_ops.grid_encode_plain

    def spy(table, x, enc, with_fracs=True):
        seen.append(with_fracs)
        return plain(table, x, enc, with_fracs)

    monkeypatch.setattr(table_ops, "grid_encode_plain", spy)
    return seen


def _tiny_network():
    from nerfshop_tpu_torch.models import nerf_network as tnn

    cfg = {
        "encoding": {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
                     "log2_hashmap_size": 12, "base_resolution": 8, "per_level_scale": 1.5},
        "network": {"n_neurons": 16, "n_hidden_layers": 1},
        "dir_encoding": {"otype": "SphericalHarmonics", "degree": 4},
        "rgb_network": {"n_neurons": 16, "n_hidden_layers": 1},
    }
    return tnn, tnn.build_nerf_network(cfg, aabb_scale=1, generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("case", ["no_grad", "frozen table", "ema density_with", "ema density_with no_grad"])
def test_forward_without_gradient_skips_fracs(monkeypatch, case):
    # where autograd records nothing the encode writes no slots or fracs
    x = torch.from_numpy(_points(6))
    if case.startswith("ema"):
        tnn, model = _tiny_network()
        ema = {k: v.clone() for k, v in model.state_dict().items()}  # as the trainer keeps it
        assert not any(v.requires_grad for v in ema.values())
        ref = tnn.density_with(model, None, x).detach()
        seen = _spy_fracs(monkeypatch)
        if case.endswith("no_grad"):
            with torch.no_grad():
                sigma = tnn.density_with(model, ema, x)
        else:
            sigma = tnn.density_with(model, ema, x)
        assert not sigma.requires_grad
        torch.testing.assert_close(sigma, ref, rtol=0, atol=0)
    else:
        _, te, _ = _pair("hash")
        seen = _spy_fracs(monkeypatch)
        if case == "no_grad":
            with torch.no_grad():
                out = te(x)
        else:
            te.table.requires_grad_(False)
            out = te(x)
        assert out.grad_fn is None
    assert seen == [False]


def test_forward_with_gradient_keeps_fracs(monkeypatch):
    # a recorded forward goes through GridEncodeFunction and saves idx / w1
    _, te, _ = _pair("hash")
    x = torch.from_numpy(_points(7))
    seen = _spy_fracs(monkeypatch)
    out = te(x)
    assert seen == [True]
    assert type(out.grad_fn).__name__ == "GridEncodeFunctionBackward"
    idx, w1 = out.grad_fn.saved_tensors
    ti, tw = te.brick_fracs(x)
    assert torch.equal(idx, ti) and torch.equal(w1, tw)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_table_grad_matches_jax_grad(name):
    # sorted segment sums vs XLA's scatter-add: 1e-5 of the largest entry
    je, te, table = _pair(name)
    x = _points(3)
    ct = np.random.default_rng(4).standard_normal((x.shape[0], te.n_output_dims)).astype(np.float32)

    def f(t):
        return jnp.sum(je.apply({"table": t}, jnp.asarray(x)) * ct)

    ref = np.asarray(jax.grad(f)(jnp.asarray(table)))
    out = te(torch.from_numpy(x))
    (ours,) = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), [te.table])
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    # and against autograd of the plain forward (index_add backward)
    t = te.table.detach().clone().requires_grad_(True)
    plain, _, _ = table_ops.grid_encode_plain(t, torch.from_numpy(x), te)
    (g_plain,) = torch.autograd.grad((plain * torch.from_numpy(ct)).sum(), [t])
    np.testing.assert_allclose(ours.numpy(), g_plain.numpy(), rtol=0, atol=1e-5 * np.abs(ref).max())


def test_position_grad_raises():
    _, te, _ = _pair("hash")
    x = torch.from_numpy(_points(5)).requires_grad_(True)
    with pytest.raises(NotImplementedError):
        te(x)


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_spherical_harmonics_match(degree):
    x = np.random.default_rng(6).uniform(0, 1, (300, 3)).astype(np.float32)
    ref = np.asarray(jenc.SphericalHarmonicsEncoding(degree=degree).apply((), jnp.asarray(x)))
    ours = tenc.SphericalHarmonicsEncoding(degree=degree)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


def test_composite_matches():
    cfg = {
        "otype": "Composite",
        "nested": [
            {"n_dims_to_encode": 3, "otype": "SphericalHarmonics", "degree": 4},
            {"otype": "Identity", "scale": 2.0, "offset": -0.5},
        ],
    }
    x = np.random.default_rng(7).uniform(0, 1, (200, 5)).astype(np.float32)
    je = jenc.build_encoding(cfg, 5)
    te = tenc.build_encoding(cfg, 5)
    assert te.n_output_dims == je.n_output_dims == 18
    ref = np.asarray(je.apply(je.init(jax.random.PRNGKey(0)), jnp.asarray(x)))
    np.testing.assert_allclose(te(torch.from_numpy(x)).numpy(), ref, rtol=0, atol=1e-6)


def test_unported_otypes_raise():
    with pytest.raises(NotImplementedError):
        tenc.build_encoding({"otype": "Frequency"}, 3)
    with pytest.raises(NotImplementedError):
        tenc.build_encoding({"otype": "HashGrid", "layout": "plain"}, 3)
