"""The port's sorted segment row-sum (plain path) against the Pallas kernel
of ``nerfshop_tpu/ops/pallas_segsum.py`` (interpret mode on CPU) and a dense
``np.add.at`` oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfshop_tpu.ops import pallas_segsum
from nerfshop_tpu_torch.ops import segsum


def _case(seed, m, N, D=3, F=2):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, m, N).astype(np.int32)
    w1 = rng.uniform(0, 1, (N, D)).astype(np.float32)
    dout = rng.standard_normal((N, F)).astype(np.float32)
    order = np.argsort(idx, kind="stable")
    return idx[order], w1[order], dout[order]


def _oracle(key, w1, dout, m):
    D, F = w1.shape[1], dout.shape[1]
    w8 = np.ones((key.shape[0], 1 << D), np.float64)
    for c in range(1 << D):
        for d in range(D):
            w8[:, c] *= w1[:, d] if (c >> d) & 1 else 1.0 - w1[:, d]
    ct = (w8[:, :, None] * dout[:, None, :].astype(np.float64)).reshape(key.shape[0], -1)
    ref = np.zeros((m, ct.shape[1]), np.float64)
    np.add.at(ref, key, ct)
    return ref


@pytest.mark.parametrize("m,N", [(1024, 2048), (128 * 3, 1024)])
def test_plain_matches_pallas_interpret(m, N):
    # the TPU kernel's bf16 hi+lo split is exact only to ~2^-16: rtol 3e-3, atol 2e-5
    key, w1, dout = _case(0, m, N)
    ours = segsum.sorted_segment_rowsum(torch.from_numpy(key), torch.from_numpy(w1), torch.from_numpy(dout), m)
    pallas = pallas_segsum.sorted_segment_rowsum(jnp.asarray(key), jnp.asarray(w1), jnp.asarray(dout), m, interpret=True)
    assert tuple(ours.shape) == tuple(pallas.shape) == (m, 16)
    np.testing.assert_allclose(ours.numpy(), np.asarray(pallas), rtol=3e-3, atol=2e-5)


@pytest.mark.parametrize("seed,m,N", [(1, 4096, 8192), (2, 256, 4096), (3, 1 << 15, 512)])
def test_plain_matches_dense_oracle(seed, m, N):
    # fp32 sums in another order than the float64 oracle: atol 1e-6
    key, w1, dout = _case(seed, m, N)
    ours = segsum.sorted_segment_rowsum(torch.from_numpy(key), torch.from_numpy(w1), torch.from_numpy(dout), m)
    np.testing.assert_allclose(ours.numpy(), _oracle(key, w1, dout, m), rtol=0, atol=1e-6)
    # rows that no sample hits are exactly zero
    empty = np.setdiff1d(np.arange(m), key)
    assert not ours.numpy()[empty].any()


def test_cpu_tensors_never_launch_the_kernel():
    key, w1, dout = _case(4, 512, 1024)
    before = segsum.sorted_segment_rowsum_cuda.launches
    segsum.sorted_segment_rowsum(torch.from_numpy(key), torch.from_numpy(w1), torch.from_numpy(dout), 512)
    assert segsum.sorted_segment_rowsum_cuda.launches == before


def test_corner_products_order():
    w1 = torch.tensor([[0.25, 0.5, 0.75]])
    w8 = segsum.corner_products(w1)[0].tolist()
    expect = [
        (0.75 if not c & 1 else 0.25) * (0.5) * (0.25 if not c & 4 else 0.75) for c in range(8)
    ]
    np.testing.assert_allclose(w8, expect, rtol=0, atol=1e-7)
