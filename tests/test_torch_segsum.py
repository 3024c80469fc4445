"""The port's sorted segment row-sum (plain path) against the Pallas kernel
of ``nerfshop_tpu/ops/pallas_segsum.py`` (interpret mode on CPU) and a dense
``np.add.at`` oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfshop_tpu.ops import pallas_segsum
from nerfshop_tpu_torch.ops import segsum
from torch_one_thread import one_thread  # noqa: F401


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
    ct = (w8[:, :, None] * dout[:, None, :].astype(np.float64)).reshape(key.shape[0], (1 << D) * F)
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


# ------------------------------------------------- the edges of kernel A's tiles

TILE = segsum.TILE


def _runs(lengths, m, seed):
    """Sorted keys with runs of the given lengths on distinct slots of [0, m)."""
    rng = np.random.default_rng(seed)
    slots = np.sort(rng.choice(m, len(lengths), replace=False))
    return np.repeat(slots, lengths).astype(np.int32)


def _edge_keys(name, seed=7):
    rng = np.random.default_rng(seed)
    if name == "tile-edges":  # runs ending exactly on tile edges, one over two tiles
        return _runs([TILE, 2 * TILE, TILE - 1, 1, TILE, 3 * TILE + 5, TILE - 5], 4096, seed), 4096
    if name == "one-run-spans-all":
        return np.full(4 * TILE + 3, 77, np.int32), 1024
    if name == "n1":
        return np.array([5], np.int32), 1024
    if name == "n0":
        return np.zeros(0, np.int32), 256
    if name == "n-not-multiple-of-tile":
        return np.sort(rng.integers(0, 2048, 3 * TILE + 37)).astype(np.int32), 2048
    if name == "keys-0-and-m-1-m-lt-n":
        key = rng.integers(0, 384, 4096)
        key[0], key[-1] = 0, 383
        return np.sort(key).astype(np.int32), 384
    if name == "spread-under-pile":  # a few keys spread below a masked pile: tiles owning long stretches
        key = np.concatenate([rng.integers(0, 8191, 300), np.full(3000, 8191)])
        return np.sort(key).astype(np.int32), 8192
    assert name == "skewed"
    key = rng.integers(0, 4096, 8192)
    key[: 8192 * 4 // 5] = 1234
    return np.sort(key).astype(np.int32), 4096


EDGES = [
    "tile-edges", "one-run-spans-all", "n1", "n0", "n-not-multiple-of-tile", "keys-0-and-m-1-m-lt-n", "skewed",
    "spread-under-pile",
]


@pytest.mark.parametrize("name", EDGES)
def test_plain_matches_pallas_and_oracle_at_tile_edges(name):
    # |plain − ref| ≤ 1e-5 · Σ|terms| of the row (the float64 oracle's Σ|w8 ⊗ dout|),
    # against the float64 oracle and against the Pallas kernel in interpret
    # mode (whose bf16 hi+lo split is exact to ~4e-6 of each term); rows no
    # sample hits are exactly zero in all three
    key, m = _edge_keys(name)
    rng = np.random.default_rng(11)
    N = key.shape[0]
    w1 = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    dout = rng.standard_normal((N, 2)).astype(np.float32)
    ours = segsum.sorted_segment_rowsum(torch.from_numpy(key), torch.from_numpy(w1), torch.from_numpy(dout), m).numpy()
    absum = _oracle(key, w1, np.abs(dout), m)
    tol = 1e-5 * absum
    assert ours.shape == (m, 16)
    assert (np.abs(ours - _oracle(key, w1, dout, m)) <= tol).all()
    # the Pallas kernel takes N % 128 == 0: pad with samples of zero
    # cotangent on the last key, which add exactly 0
    pad = -N % 128
    pk = np.concatenate([key, np.full(pad, key[-1] if N else 0, np.int32)])
    pw = np.concatenate([w1, np.zeros((pad, 3), np.float32)])
    pd = np.concatenate([dout, np.zeros((pad, 2), np.float32)])
    pallas = np.asarray(
        pallas_segsum.sorted_segment_rowsum(jnp.asarray(pk), jnp.asarray(pw), jnp.asarray(pd), m, interpret=True)
    )
    assert (np.abs(ours - pallas) <= tol).all()
    empty = np.setdiff1d(np.arange(m), key)
    assert not ours[empty].any() and not pallas[empty].any()


def test_kernel_wrapper_raises_on_cpu_tensors():
    # the wrapper launches on CUDA tensors or raises; the dispatcher sends
    # CPU tensors to the plain version
    key, w1, dout = _case(5, 256, 512)
    with pytest.raises(ValueError):
        segsum.sorted_segment_rowsum_cuda(torch.from_numpy(key), torch.from_numpy(w1), torch.from_numpy(dout), 256)


def test_alignment_picks_the_scalar_loads_for_offset_views():
    # a contiguous view at a 4-byte storage offset is not 16-byte aligned:
    # kernel A then reads its samples 4 bytes at a time
    from nerfshop_tpu_torch import kernels

    key = torch.arange(9, dtype=torch.int32)
    w1 = torch.zeros(9 * 3)
    assert kernels.aligned16(key[:8], w1.view(9, 3))
    view = key[1:]
    assert view.is_contiguous() and not kernels.aligned16(view)
    assert not kernels.aligned16(key[:8], w1[3:].view(8, 3))
