"""Kernel D's plain version (``nerfshop_tpu_torch/ops/gather.py``) against
``jnp.take`` / ``jnp.take_along_axis`` and against the Pallas gather bodies
of ``scratch/probe_*.py`` run with ``interpret=True``, in every form of the
TPU kernel table at reduced shapes, f32 and i32: a gather is a copy, so
every comparison is bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from nerfshop_tpu_torch.ops import gather

# (probe row, form, x shape, idx shape, index range) at reduced shapes
FORMS = [
    ("3-ax1-blocked", "axis1", (256, 128), (256, 128), 128),
    ("4-take-1d", "rows", (4096,), (1024,), 4096),
    ("5-row-take", "rows", (512, 128), (128,), 512),
    ("6-ax1-lane", "axis1", (64, 512), (64, 128), 512),
    ("7-ax0-same", "axis0", (256, 128), (256, 128), 256),
    ("8-ax1-wide", "axis1", (64, 512), (64, 512), 512),
    ("9-ax0-many", "axis0", (64, 128), (512, 128), 64),
    ("12-ax0-q-ne-s", "axis0", (128, 128), (256, 128), 128),
    ("13-ax0-sweep", "axis0", (1024, 128), (1024, 128), 1024),
    ("edit-rows-12", "rows", (300, 12), (2048,), 300),
]


def _inputs(x_shape, idx_shape, hi, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "f32":
        x = rng.normal(size=x_shape).astype(np.float32)
        x.reshape(-1)[:4] = [np.inf, -0.0, np.nan, 1e-42]  # special values copy through bit for bit
    else:
        x = rng.integers(-(2**31), 2**31 - 1, size=x_shape, dtype=np.int64).astype(np.int32)
    return x, rng.integers(0, hi, size=idx_shape).astype(np.int32)


def _jax_ref(x, idx, form):
    if form == "rows":
        return np.asarray(jnp.take(jnp.asarray(x), jnp.asarray(idx), axis=0))
    return np.asarray(jnp.take_along_axis(jnp.asarray(x), jnp.asarray(idx), axis=1 if form == "axis1" else 0))


def _pallas_ref(x, idx, form):
    if form == "rows":
        def body(t_ref, i_ref, o_ref):
            o_ref[:] = jnp.take(t_ref[:], i_ref[:], axis=0)

        shape = (idx.shape[0], *x.shape[1:])
    else:
        axis = 1 if form == "axis1" else 0

        def body(x_ref, i_ref, o_ref):
            o_ref[:] = jnp.take_along_axis(x_ref[:], i_ref[:], axis=axis)

        shape = idx.shape
    out = pl.pallas_call(body, out_shape=jax.ShapeDtypeStruct(shape, x.dtype), interpret=True)(x, idx)
    return np.asarray(out)


def _ours(x, idx, form, idx_dtype=torch.int32):
    xt, it = torch.from_numpy(x), torch.from_numpy(idx).to(idx_dtype)
    if form == "rows":
        return gather.take_rows(xt, it).numpy()
    return gather.take_along(xt, it, axis=1 if form == "axis1" else 0).numpy()


def _bits(a):
    return a.view(np.uint32)


@pytest.mark.parametrize("dtype", ["f32", "i32"])
@pytest.mark.parametrize("name,form,x_shape,idx_shape,hi", FORMS, ids=[f[0] for f in FORMS])
def test_plain_gather_matches_jax_bit_for_bit(name, form, x_shape, idx_shape, hi, dtype):
    x, idx = _inputs(x_shape, idx_shape, hi, dtype)
    ours = _ours(x, idx, form)
    ref = _jax_ref(x, idx, form)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    np.testing.assert_array_equal(_bits(ours), _bits(ref))
    # int64 indices (the march's sort permutations) give the same bits
    np.testing.assert_array_equal(_bits(_ours(x, idx, form, torch.int64)), _bits(ref))


@pytest.mark.parametrize("name,form,x_shape,idx_shape,hi", FORMS[:9], ids=[f[0] for f in FORMS[:9]])
def test_plain_gather_matches_pallas_interpret(name, form, x_shape, idx_shape, hi):
    x, idx = _inputs(x_shape, idx_shape, hi, "f32", seed=1)
    np.testing.assert_array_equal(_bits(_ours(x, idx, form)), _bits(_pallas_ref(x, idx, form)))


def test_plain_gather_checks_the_range():
    x = torch.zeros(8, 4)
    with pytest.raises((IndexError, RuntimeError)):
        gather.take_rows(x, torch.tensor([8], dtype=torch.int32))
    with pytest.raises((IndexError, RuntimeError)):
        gather.take_along(x, torch.full((8, 2), 4, dtype=torch.int32), axis=1)


def test_kernel_wrapper_refuses_what_it_cannot_take():
    # the kernel's wrapper takes CUDA tensors only; the dispatchers send CPU
    # tensors to the plain version
    with pytest.raises(ValueError):
        gather.gather_cuda(torch.zeros(8, 4), torch.zeros(3, dtype=torch.int32), "rows")
    with pytest.raises(ValueError):
        gather.take_along(torch.zeros(8, 4), torch.zeros(8, 2, dtype=torch.int32), axis=2)
    before = gather.gather_cuda.launches
    gather.take_rows(torch.zeros(8, 4), torch.zeros(3, dtype=torch.int32))
    assert gather.gather_cuda.launches == before  # the CPU path launches nothing
