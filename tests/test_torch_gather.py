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


# ----------------------------------------- the edges of kernel D's launch plan

EDGE_CASES = [
    # (name, form, x shape, idx shape, index range, index dtype)
    ("rows-c12-i32", "rows", (300, 12), (2048,), 300, torch.int32),
    ("rows-c12-i64", "rows", (300, 12), (2048,), 300, torch.int64),
    ("rows-c9-i32", "rows", (300, 9), (2048,), 300, torch.int32),
    ("rows-c9-i64", "rows", (300, 9), (2048,), 300, torch.int64),
    ("rows-c1-i32", "rows", (300, 1), (2048,), 300, torch.int32),
    ("rows-c1-i64", "rows", (300, 1), (2048,), 300, torch.int64),
    ("ax1-wider-than-the-stage", "axis1", (4, 16384), (4, 16384), 16384, torch.int32),
    ("ax1-one-pick-per-row", "axis1", (64, 128), (64, 1), 128, torch.int64),
    ("ax1-odd-columns", "axis1", (32, 130), (32, 130), 130, torch.int64),
]


def _offset_view(t):
    """A contiguous copy of ``t`` at a 4-byte storage offset."""
    flat = t.reshape(-1)
    return torch.cat([flat[:1], flat])[1:].view(t.shape)


@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "4-byte-offset-view"])
@pytest.mark.parametrize("name,form,x_shape,idx_shape,hi,idx_dtype", EDGE_CASES, ids=[c[0] for c in EDGE_CASES])
def test_plain_gather_matches_jax_at_the_plan_edges(name, form, x_shape, idx_shape, hi, idx_dtype, offset):
    # bit-equal, with x and idx as contiguous views at a storage offset too
    x, idx = _inputs(x_shape, idx_shape, hi, "f32", seed=2)
    xt, it = torch.from_numpy(x), torch.from_numpy(idx).to(idx_dtype)
    if offset:
        xt, it = _offset_view(xt), _offset_view(it)
        assert xt.is_contiguous() and xt.storage_offset() == 1 and it.storage_offset() == 1
    ours = gather.take_rows(xt, it) if form == "rows" else gather.take_along(xt, it, axis=1)
    ref = _jax_ref(x, idx, form)
    assert tuple(ours.shape) == ref.shape
    np.testing.assert_array_equal(_bits(ours.numpy()), _bits(ref))


def test_plan_takes_4_byte_accesses_for_offset_views():
    # the plan reads the alignment from the pointers: a 4-byte-offset view of
    # x stages 4 bytes at a time, of idx reads one index at a time
    from nerfshop_tpu_torch import kernels

    x = torch.zeros(1 + 64 * 128)
    aligned, view = x[:-1].view(64, 128), x[1:].view(64, 128)
    assert kernels.aligned16(aligned) and not kernels.aligned16(view)
    p = gather.plan("axis1", 64, 128, 64, 128, kernels.aligned16(aligned), True, False)
    assert p.staged and p.xvec == 4 and p.ivec == 4
    p = gather.plan("axis1", 64, 128, 64, 128, kernels.aligned16(view), False, False)
    assert p.staged and p.xvec == 1 and p.ivec == 1
    assert gather.plan("rows", 4096, 128, 1024, 128, False, True, False).xvec == 1
    assert gather.plan("rows", 4096, 128, 1024, 128, True, True, False).xvec == 4


def test_plan_sends_wide_and_sparse_rows_to_the_direct_variant():
    # a row wider than 48 KB cannot be staged; a row read at fewer than one
    # pick per 8 elements is cheaper to read directly
    wide = gather.plan("axis1", 4, 16384, 4, 16384, True, True, False)
    assert not wide.staged and wide.smem == 0
    sparse = gather.plan("axis1", 8192, 128, 8192, 1, True, True, True)
    assert not sparse.staged and sparse.ivec == 1
    march = gather.plan("axis1", 8192, 512, 8192, 512, True, True, True)
    assert march.staged and march.ivec == 2 and march.smem == march.rows * 512 * 4 <= gather.STAGE_BUDGET
    assert march.tx * march.ty <= gather.THREADS and march.blocks * march.rows >= 8192


@pytest.mark.parametrize("C,xvec,tx", [(12, 4, 3), (9, 1, 9), (1, 1, 1), (128, 4, 32)])
def test_plan_row_take_vector_width(C, xvec, tx):
    # whole rows by 16 bytes only when C % 4 == 0; one thread per access of
    # a row, so a warp writes consecutive bytes of out
    p = gather.plan("rows", 5239, C, 1 << 20, C, True, True, False)
    assert (p.xvec, p.tx) == (xvec, tx) and p.tx * p.ty <= gather.THREADS
    assert p.blocks * p.ty * gather.ROWS_IN_FLIGHT >= 1 << 20
    fields = [getattr(p, name) for name, _ in p._fields_]
    assert fields == [0, 0, 5239, C, 1 << 20, C, 0, xvec, 1, 0, p.tx, p.ty, p.blocks, 0]


def test_plan_struct_matches_the_kernel_source():
    # the plan crosses into C as one struct: kernels.GatherPlan and struct
    # GatherPlan of csrc/gather.cu name the same 64-bit fields in one order
    import ctypes
    import re
    from pathlib import Path

    from nerfshop_tpu_torch import kernels

    src = (Path(kernels.__file__).parent / "csrc" / "gather.cu").read_text()
    body = re.search(r"struct GatherPlan \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    c_fields = [f.strip() for decl in body.split(";") if decl.strip() for f in decl.replace("long long", "").split(",")]
    assert c_fields == [name for name, _ in kernels.GatherPlan._fields_]
    assert all(t is ctypes.c_longlong for _, t in kernels.GatherPlan._fields_)


def test_plan_index_vectors_need_divisible_rows():
    # 4 int32 or 2 int64 indices per 16-byte load only where they stay in one row
    assert gather.plan("axis1", 64, 128, 64, 128, True, True, False).ivec == 4
    assert gather.plan("axis1", 64, 128, 64, 130, True, True, False).ivec == 1
    assert gather.plan("axis1", 64, 128, 64, 130, True, True, True).ivec == 2
    assert gather.plan("axis1", 64, 128, 64, 129, True, True, True).ivec == 1
