"""Kernel C's plain version and dispatch (``nerfshop_tpu_torch/ops/fused_mlp.py``,
``models/mlp.py``) against ``nerfshop_tpu/models/mlp.py::MLP.apply``, the
function the Pallas fused MLP of ``scratch/probe_arch.py:52-55`` computes.
The CUDA kernel itself runs only on the card (``chip_smoke.py`` [mlp])."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfshop_tpu.models import mlp as jmlp
from nerfshop_tpu_torch.models import mlp as tmlp
from nerfshop_tpu_torch.ops import fused_mlp
from torch_one_thread import one_thread  # noqa: F401

SHAPES = {"density": (32, 64, 1, 16), "rgb": (32, 64, 2, 3)}


def _inputs(n_in, n_neurons, n_hidden, n_out, seed=0, N=4096):
    rng = np.random.default_rng(seed)
    dims = [n_in] + [n_neurons] * n_hidden + [n_out]
    ws = [rng.uniform(-1, 1, (a, b)).astype(np.float32) * np.sqrt(6.0 / a) for a, b in zip(dims[:-1], dims[1:])]
    x = rng.standard_normal((N, n_in)).astype(np.float32)
    return x, ws


def assert_bf16_close(ours: np.ndarray, ref: np.ndarray) -> None:
    """99.9% of outputs within 1e-6 + 1e-5·|ref|, all within 1e-2·max|ref|.
    The bf16 operands and the rounding points are the same, but the fp32
    sums run in another order, and where an fp32 hidden value lies within an
    ulp of a bf16 rounding tie the two round it to neighbouring bf16 values
    (a step of 2^-8 relative) on a few samples."""
    err = np.abs(ours - ref)
    assert (err <= 1e-6 + 1e-5 * np.abs(ref)).mean() >= 0.999
    assert err.max() <= 1e-2 * np.abs(ref).max()


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_matches_jax_apply(shape):
    n_in, n_neurons, n_hidden, n_out = SHAPES[shape]
    x, ws = _inputs(n_in, n_neurons, n_hidden, n_out)
    jm = jmlp.MLP(n_in, n_out, n_neurons, n_hidden)
    ref = np.asarray(jm.apply({"weights": [jnp.asarray(w) for w in ws]}, jnp.asarray(x)))
    ours = fused_mlp.fused_mlp_plain(torch.from_numpy(x), [torch.from_numpy(w) for w in ws])
    assert_bf16_close(ours.numpy(), ref)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_module_forward_on_cpu_is_plain(shape):
    n_in, n_neurons, n_hidden, n_out = SHAPES[shape]
    x, ws = _inputs(n_in, n_neurons, n_hidden, n_out, seed=1)
    m = tmlp.MLP(n_in, n_out, n_neurons, n_hidden)
    with torch.no_grad():
        for p, w in zip(m.weights, ws):
            p.copy_(torch.from_numpy(w))
    before = fused_mlp.fused_mlp_cuda.launches
    with torch.no_grad():
        out = m(torch.from_numpy(x))
    assert fused_mlp.fused_mlp_cuda.launches == before
    ref = fused_mlp.fused_mlp_plain(torch.from_numpy(x), [torch.from_numpy(w) for w in ws])
    assert torch.equal(out, ref)


def test_grad_forward_keeps_autograd():
    # the training forward needs a gradient: the plain version under autograd,
    # whose weight gradient matches jax.grad of MLP.apply within 1e-5
    n_in, n_neurons, n_hidden, n_out = SHAPES["rgb"]
    x, ws = _inputs(n_in, n_neurons, n_hidden, n_out, seed=2, N=512)
    ct = np.random.default_rng(3).standard_normal((512, n_out)).astype(np.float32)
    m = tmlp.MLP(n_in, n_out, n_neurons, n_hidden)
    with torch.no_grad():
        for p, w in zip(m.weights, ws):
            p.copy_(torch.from_numpy(w))
    xt = torch.from_numpy(x)
    assert fused_mlp.needs_grad(xt, list(m.weights))
    (m(xt) * torch.from_numpy(ct)).sum().backward()
    jm = jmlp.MLP(n_in, n_out, n_neurons, n_hidden)
    grads = jax.grad(lambda p: jnp.sum(jm.apply(p, jnp.asarray(x)) * ct))({"weights": [jnp.asarray(w) for w in ws]})
    for p, g in zip(m.weights, grads["weights"]):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), rtol=0, atol=1e-5 * max(1.0, float(np.abs(g).max())))


def test_needs_grad_rules():
    w = [torch.zeros(32, 64, requires_grad=True), torch.zeros(64, 16, requires_grad=True)]
    x = torch.zeros(4, 32)
    assert fused_mlp.needs_grad(x, w)
    with torch.no_grad():
        assert not fused_mlp.needs_grad(x, w)
    frozen = [t.detach() for t in w]
    assert not fused_mlp.needs_grad(x, frozen)
    assert fused_mlp.needs_grad(x.requires_grad_(True), frozen)


@pytest.mark.parametrize(
    "dims,ok",
    [
        ((32, 64, 1, 16, "ReLU", "None"), True),
        ((32, 64, 2, 3, "ReLU", "None"), True),
        ((16, 64, 2, 1, "relu", "none"), True),
        ((64, 64, 1, 16, "ReLU", "None"), True),
        ((24, 64, 1, 16, "ReLU", "None"), True),  # zero-padded to two k-tiles in the kernel
        ((35, 64, 2, 3, "ReLU", "None"), True),  # the rgb MLP of a scene with light dirs
        ((0, 64, 1, 16, "ReLU", "None"), False),
        ((129, 64, 1, 16, "ReLU", "None"), False),
        ((32, 128, 1, 16, "ReLU", "None"), False),  # hidden width
        ((32, 64, 3, 16, "ReLU", "None"), False),  # depth
        ((32, 64, 1, 17, "ReLU", "None"), False),  # output width
        ((32, 64, 1, 16, "Sigmoid", "None"), False),
        ((32, 64, 1, 16, "ReLU", "Exponential"), False),
        ((80, 64, 2, 1, "ReLU", "None"), True),  # the Takikawa encoding at its defaults, five k-tiles
        ((128, 64, 1, 16, "ReLU", "None"), True),
    ],
)
def test_check_supported(dims, ok):
    if ok:
        fused_mlp.check_supported(*dims)
    else:
        with pytest.raises(ValueError):
            fused_mlp.check_supported(*dims)


def test_cuda_wrapper_rejects_cpu_tensors():
    x, ws = _inputs(32, 64, 1, 16, N=8)
    with pytest.raises(ValueError):
        fused_mlp.fused_mlp_cuda(torch.from_numpy(x), [torch.from_numpy(w) for w in ws])
