"""``configs/nerf/tpu_flagship.json`` against the JAX package on the CPU, at
its real widths: Frequency(10) over the position (60 features), a 256-wide
density MLP of 4 hidden layers (60 → 256 → 256 → 256 → 256 → 16), the
64-wide rgb MLP of ``base.json``; the network forward on a few thousand
samples and one training step (loss, gradients, the Adam + EMA update).
Then the GEMM route (``ops/fused_mlp.gemm_mlp``, which a CUDA forward
without a gradient runs for every MLP kernel C does not take) on CPU
tensors against the plain version, and the route each shipped config's
MLPs take: kernel C for every MLP of the default, fast, SDF, Image and
Volume configs, the GEMM route for the flagship's density MLP alone.

Tolerances: through the MLPs both packages round the operands and each
hidden activation to bf16, so a value on a rounding boundary can round the
other way under another summation order: 2e-3 relative L2 for the forward,
as the default config's tests. The gradients go back through the density
MLP's five layers, each of which rounds its cotangent to bf16 in both
packages (two or three layers in the default config), and each layer's
re-roundings add to the last: 5e-3 relative L2 a leaf (the first layer's
weights read 2.4e-3 on the CPU). The GEMM route against the plain version: the same
roundings in another summation order, 1e-3 relative L2 and 99% of the
outputs within 1e-5 relative (a re-rounded hidden value moves its row by
about 2^-8 of that value's share)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfshop_tpu_torch import config as tconfig
from nerfshop_tpu_torch import weights
from nerfshop_tpu_torch.config import load_network_config
from nerfshop_tpu_torch.models import mlp as tmlp
from nerfshop_tpu_torch.models.nerf_network import build_nerf_network
from nerfshop_tpu_torch.ops import fused_mlp
from test_torch_hash_fast import check_adam_step, step_grads
from test_torch_kernel_range import field_mlp
from test_torch_train_step import _models, _rel
from torch_one_thread import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
REL = 2e-3
#: the gradients' bound through the density MLP's five bf16 layers
REL_GRAD = 5e-3


def _flagship():
    return load_network_config(ROOT / "configs/nerf/tpu_flagship.json")


def test_flagship_widths_and_routes():
    cfg = _flagship()
    tm = build_nerf_network(cfg, device=torch.device("cpu"))
    dims = [tuple(w.shape) for w in tm.density_mlp.weights]
    assert dims == [(60, 256), (256, 256), (256, 256), (256, 256), (256, 16)]
    assert [tuple(w.shape) for w in tm.rgb_mlp.weights] == [(32, 64), (64, 64), (64, 3)]
    assert (tm.density_mlp.route, tm.rgb_mlp.route) == ("gemm", "fused")


def test_flagship_network_forward_matches():
    # 4096 positions and directions: within 2e-3 relative L2 (bf16 numerics)
    jm, jp, tm = _models(_flagship(), seed=5)
    x = np.random.default_rng(6).uniform(0, 1, (4096, 3)).astype(np.float32)
    d = np.random.default_rng(7).uniform(0, 1, (4096, 3)).astype(np.float32)
    jrgb, jsig = jm(jp, jnp.asarray(x), jnp.asarray(d))
    with torch.no_grad():
        trgb, tsig = tm(torch.from_numpy(x), torch.from_numpy(d))
    assert _rel(trgb.numpy(), jrgb) < REL and _rel(tsig.numpy(), jsig) < REL
    # the density features alone, the GEMM route's input and output widths
    jf = jm.density_features(jp, jnp.asarray(x))
    with torch.no_grad():
        tf = tm.density_features(torch.from_numpy(x))
    assert tf.shape == (4096, 16) and _rel(tf.numpy(), jf) < REL


def test_flagship_training_step_matches():
    # one step's loss (1e-4 relative) and gradients (every leaf within
    # REL_GRAD relative L2) from the same draws, then each package's Adam +
    # EMA update from its own gradients (lr 5e-3)
    cfg = _flagship()
    assert cfg["optimizer"]["nested"]["nested"]["learning_rate"] == 5e-3
    jm, jp, tm, jl, jg, tl, grads = step_grads(cfg)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    jgrads = weights.params_from_jax(jax.tree.map(np.asarray, jg))
    assert set(jgrads) == set(grads)
    for name, g in grads.items():
        assert float(g.abs().max()) > 0 and _rel(g.numpy(), jgrads[name].numpy()) < REL_GRAD, name
    check_adam_step(cfg, jp, jg, tm, grads)


def _weights(dims, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(((rng.uniform(size=(a, b)) * 2 - 1) * (6.0 / a) ** 0.5).astype(np.float32))
            for a, b in zip(dims[:-1], dims[1:])]


@pytest.mark.parametrize("dims,act,out_act", [
    ((60, 256, 256, 256, 256, 16), "ReLU", "None"),  # the flagship's density MLP
    ((32, 128, 128, 3), "ReLU", "Sigmoid"),
    ((140, 64, 64, 4), "Sigmoid", "None"),  # an activation that does not commute with the bf16 rounding
    ((32, 64, 16), "ReLU", "None"),  # a shape kernel C takes: the route computes it too
])
def test_gemm_route_matches_plain(dims, act, out_act):
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2048, dims[0])).astype(np.float32))
    ws = _weights(dims, 2)
    before = fused_mlp.gemm_mlp.launches
    out = fused_mlp.gemm_mlp(x, ws, act, out_act)
    assert fused_mlp.gemm_mlp.launches == before  # counted on the card only
    ref = fused_mlp.fused_mlp_plain(x, ws, tmlp.activation(act), tmlp.activation(out_act))
    assert out.shape == ref.shape == (2048, dims[-1]) and out.dtype == torch.float32 and not out.requires_grad
    within = float(((out - ref).abs() <= 1e-6 + 1e-5 * ref.abs()).float().mean())
    assert _rel(out.numpy(), ref.numpy()) < 1e-3 and within >= 0.99, (_rel(out.numpy(), ref.numpy()), within)
    # a transposed hidden layer or layers in another order give another MLP
    for bad in ([ws[0], ws[1].T.contiguous(), *ws[2:]], [ws[0], *reversed(ws[1:-1]), ws[-1]]):
        if all(a.shape == b.shape for a, b in zip(bad, ws)) and any(not torch.equal(a, b) for a, b in zip(bad, ws)):
            assert _rel(fused_mlp.gemm_mlp(x, bad, act, out_act).numpy(), ref.numpy()) > 1e-2


def test_mlp_forward_takes_its_route_on_the_card_only():
    # on CPU tensors the module runs the plain version whatever its route;
    # the route is fixed when the MLP is built
    m = tmlp.MLP(60, 16, n_neurons=256, n_hidden_layers=4)
    assert m.route == "gemm"
    x = torch.rand(64, 60)
    with torch.no_grad():
        np.testing.assert_array_equal(m(x).numpy(), fused_mlp.fused_mlp_plain(x, list(m.weights)).numpy())
    assert tmlp.MLP(32, 16).route == "fused"


@pytest.mark.parametrize("name", ["default", "fast", "base.json", "sdf", "image", "volume"])
def test_shipped_configs_take_kernel_c(name):
    # every MLP of these configs, as built, takes kernel C: the GEMM route's
    # counter stays 0 on their paths on the card (chip_smoke.py checks it)
    if name in ("default", "fast", "base.json"):
        if name == "base.json":
            cfg = load_network_config(ROOT / "configs/nerf/base.json")
        else:
            cfg = getattr(tconfig, f"{name}_nerf_config")()
        model = build_nerf_network(cfg, device=torch.device("cpu"))
        mlps = [model.density_mlp, model.rgb_mlp]
    else:
        mlps = [field_mlp(cfg, name) for cfg in (load_network_config(ROOT / "configs" / name / "base.json"),
                                                  getattr(tconfig, f"default_{name}_config")())]
    assert [m.route for m in mlps] == ["fused"] * len(mlps)
