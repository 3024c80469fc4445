"""The elementwise encodings of the port (``nerfshop_tpu_torch/models/
encodings.py``: Frequency, TriangleWave, OneBlob) against the JAX package's
on the same numpy inputs, alone and inside ``Composite``, with their
gradients; a NeRF with a Frequency position encoding against JAX's
``raw_forward``, and the port's training step on it; F2 as a strict xfail on
JAX's step, which calls ``precompute`` on any position encoding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfshop_tpu.config import default_nerf_config as jdefault_config
from nerfshop_tpu.models import encodings as jenc
from nerfshop_tpu.models.nerf_network import build_nerf_network as jbuild
from nerfshop_tpu_torch import weights
from nerfshop_tpu_torch.models import encodings as tenc
from nerfshop_tpu_torch.models.nerf_network import build_nerf_network as tbuild, check_kernel_range
from nerfshop_tpu_torch.testbed import Testbed

from test_torch_ingp import _dataset
from torch_one_thread import one_thread  # noqa: F401

#: sin/cos of the same float32 angles (up to 2^11·π) in two libms
ATOL = 2e-6

CFGS = [
    {"otype": "Frequency"},
    {"otype": "Frequency", "n_frequencies": 5},
    {"otype": "TriangleWave"},
    {"otype": "TriangleWave", "n_frequencies": 7},
    {"otype": "OneBlob"},
    {"otype": "OneBlob", "n_bins": 5},
    {"otype": "Composite", "nested": [{"otype": "OneBlob", "n_dims_to_encode": 2, "n_bins": 8},
                                      {"otype": "Frequency", "n_dims_to_encode": 1, "n_frequencies": 4},
                                      {"otype": "TriangleWave"}]},
]


@pytest.mark.parametrize("cfg", CFGS, ids=lambda c: c["otype"] + str(len(c)))
def test_elementwise_encodings_match(cfg):
    n_in = 5 if cfg["otype"] == "Composite" else 3
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.uniform(0, 1, (300, n_in)), rng.uniform(-0.2, 1.2, (50, n_in)),
                        np.array([[0.0] * n_in, [1.0] * n_in, [0.5] * n_in])]).astype(np.float32)
    je = jenc.build_encoding(cfg, n_in)
    te = tenc.build_encoding(cfg, n_in, device="cpu")
    width, sets = tenc.encoding_shape(cfg, n_in)
    assert te.n_output_dims == je.n_output_dims == width and sets == []
    params = je.init(jax.random.PRNGKey(0))
    ref = np.asarray(je.apply(params, jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = te(xt)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=ATOL)
    dout = rng.normal(size=ref.shape).astype(np.float32)
    (gx,) = jax.grad(lambda xx: jnp.sum(je.apply(params, xx) * dout))(jnp.asarray(x)),
    out.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-4, atol=2e-2)


@pytest.mark.parametrize("otype,width", [("Frequency", 72), ("TriangleWave", 36), ("OneBlob", 48)])
def test_kernel_range_takes_the_elementwise_encodings(otype, width):
    # the SDF mode's MLP from each default width through kernel C
    cfg = {"encoding": {"otype": otype}, "network": {"n_neurons": 64, "n_hidden_layers": 2}}
    assert tenc.encoding_shape(cfg["encoding"], 3)[0] == width
    check_kernel_range(cfg, torch.device("cuda"), "sdf")
    wide = {"encoding": {"otype": "Frequency", "n_frequencies": 22}, "network": cfg["network"]}  # 132 inputs
    with pytest.raises(ValueError, match="kernel C.*input width 132"):
        check_kernel_range(wide, torch.device("cuda"), "sdf")


def _frequency_nerf_config():
    cfg = jdefault_config()
    cfg["encoding"] = {"otype": "Frequency", "n_frequencies": 6}
    return dict(cfg)


def test_nerf_with_a_frequency_encoding_matches_raw_forward():
    cfg = _frequency_nerf_config()
    jm = jbuild(cfg, aabb_scale=1)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(2)))
    tm = tbuild(cfg, aabb_scale=1, device="cpu")
    tm.load_state_dict(weights.params_from_jax(params), strict=False)
    rng = np.random.default_rng(4)
    pos = rng.uniform(0, 1, (256, 3)).astype(np.float32)
    d = rng.uniform(0, 1, (256, 3)).astype(np.float32)
    jrgb, jsigma = jm.raw_forward(params, jnp.asarray(pos), jnp.asarray(d))
    with torch.no_grad():
        rgb, sigma = tm.raw_forward(torch.from_numpy(pos), torch.from_numpy(d))
    np.testing.assert_allclose(sigma.numpy(), np.asarray(jsigma), rtol=0, atol=1e-4)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), rtol=0, atol=1e-4)


def test_port_trains_a_nerf_with_a_frequency_encoding():
    # F2 handled in the port: its step has no precompute
    tb = Testbed(device="cpu", config=_frequency_nerf_config(), seed=0)
    tb.set_training_data(_dataset())
    w0 = tb.model.density_mlp.weights[0].detach().clone()
    loss = tb.train(2, 1 << 12)
    assert np.isfinite(loss) and tb.stats.step == 2
    assert not torch.equal(w0, tb.model.density_mlp.weights[0].detach())


@pytest.mark.xfail(strict=True, reason=(
    "F2 (reference fault): JAX's NeRF step calls model.precompute_raw_inputs (nerfshop_tpu/train/nerf.py:280), "
    "which calls pos_encoding.precompute (nerfshop_tpu/models/nerf_network.py:136), defined on GridEncoding alone"))
def test_jax_step_takes_a_frequency_encoding():
    cfg = _frequency_nerf_config()
    jm = jbuild(cfg, aabb_scale=1)
    params = jm.init(jax.random.PRNGKey(2))
    pos = jnp.full((8, 3), 0.5)
    jm.precompute_raw_inputs(params, pos, pos)
