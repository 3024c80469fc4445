"""The port's package boundary: no JAX and no module of the JAX package
anywhere in it, weights that move between the two packages, and wrappers
that keep CPU tensors on the plain path."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from nerfshop_tpu.config import default_nerf_config
from nerfshop_tpu.models import nerf_network as jnn
from nerfshop_tpu_torch import kernels, weights
from nerfshop_tpu_torch.models import nerf_network as tnn
from torch_one_thread import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "nerfshop_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__") for p in PKG.rglob("*.py")
)


def test_import_leaves_jax_out():
    # a subprocess: this test process already imported jax through conftest
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'msgpack', 'PIL', 'nerfshop_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT).as_posix() for p in PKG.rglob("*.py")))
def test_no_jax_import_in_source(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            # PIL and msgpack too, also where imported inside a function: the
            # card has neither (P5 was a lazy PIL import)
            assert n.split(".")[0] not in ("jax", "jaxlib", "optax", "flax", "msgpack", "PIL", "nerfshop_tpu"), (path, n)


@pytest.mark.parametrize("script", ["chip_smoke.py", "profile_render.py", "time_bvh.py"])
def test_card_scripts_leave_jax_out(script):
    # the on-card scripts may use only what the port itself may use: no
    # module of the JAX package, not even a host module without JAX
    tree = ast.parse((ROOT / script).read_text())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            for n in [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module or ""]:
                assert n.split(".")[0] not in ("jax", "jaxlib", "optax", "flax", "msgpack", "PIL", "nerfshop_tpu"), (script, n)


def test_profile_busy_time_is_interval_union():
    sys.path.insert(0, str(ROOT))
    try:
        import profile_render
    finally:
        sys.path.remove(str(ROOT))
    # µs intervals: [0, 20) ∪ [30, 40) → 30 µs, nested and touching intervals merged
    assert profile_render.busy_ms([(30, 40), (0, 10), (5, 20), (35, 36), (20, 20)]) == pytest.approx(0.03)
    assert profile_render.busy_ms([]) == 0.0


def test_time_bvh_reads_the_walks_ptxas_lines():
    sys.path.insert(0, str(ROOT))
    try:
        import time_bvh
    finally:
        sys.path.remove(str(ROOT))
    log = "\n".join([
        "ptxas info    : 0 bytes gmem",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114bvh_sdf_kernelE7BvhArgsPKfPfi' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_114bvh_sdf_kernelE7BvhArgsPKfPfi",
        "    256 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, used 0 barriers, 256 bytes cumulative stack size",
    ])
    # the walk's lines only: its stack frame and spills, then its registers
    assert time_bvh.ptxas_lines(log) == [
        "256 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "Used 40 registers, used 0 barriers, 256 bytes cumulative stack size",
    ]


def test_profile_render_reads_the_xor_kernels_ptxas_lines():
    sys.path.insert(0, str(ROOT))
    try:
        import profile_render
    finally:
        sys.path.remove(str(ROOT))
    # the anonymous namespace's name holds the file's name: the kernel is the
    # name after its length, and the template arguments follow it
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN44_INTERNAL_xor_encode_cu_280f1ca621xor_encode_bwd_kernelILi3ELi8ELb1EEEv"
        "7XorArgsPKfS3_PKhS3_PfS6_x' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN44_INTERNAL_xor_encode_cu_280f1ca621xor_encode_bwd_kernel",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 64 registers, used 0 barriers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123xor_encode_level_kernelILi8EEEv7XorArgsPKfS3_PKhPfx' "
        "for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_123xor_encode_level_kernelILi8EEEv7XorArgsPKfS3_PKhPfx",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 47 registers, used 0 barriers",
    ])
    assert profile_render.xor_entry_lines(log) == [
        ("xor_encode_bwd_kernel<3,8,1>",
         ["0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads", "Used 64 registers, used 0 barriers"]),
        ("xor_encode_level_kernel<8>",
         ["0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads", "Used 47 registers, used 0 barriers"]),
    ]


@pytest.mark.parametrize("log2_t", [12, 14])
def test_params_round_trip(log2_t):
    cfg = default_nerf_config()
    cfg["encoding"]["log2_hashmap_size"] = log2_t
    jm = jnn.build_nerf_network(cfg)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    state = weights.params_from_jax(tree)
    tm = tnn.build_nerf_network(cfg)
    assert set(state) == set(tm.state_dict())
    tm.load_state_dict(state)
    back = weights.params_to_jax(tm.state_dict())
    np.testing.assert_array_equal(back["pos_encoding"]["table"], tree["pos_encoding"]["table"])
    for mlp in ("density_mlp", "rgb_mlp"):
        assert len(back[mlp]["weights"]) == len(tree[mlp]["weights"])
        for a, b in zip(back[mlp]["weights"], tree[mlp]["weights"]):
            np.testing.assert_array_equal(a, b)


def test_default_config_widths():
    tm = tnn.build_nerf_network(default_nerf_config())
    enc = tm.pos_encoding
    assert enc.n_levels == 16 and enc.n_features_per_level == 2
    assert max(enc.level_sizes) == 1 << 19 and enc.level_res[0] == 16
    assert [tuple(w.shape) for w in tm.density_mlp.weights] == [(32, 64), (64, 16)]
    assert [tuple(w.shape) for w in tm.rgb_mlp.weights] == [(32, 64), (64, 64), (64, 3)]
    assert tm.dir_encoding.n_output_dims == 16


def test_kernel_sources_and_build_key():
    for name in kernels.SOURCES:
        src = (kernels.CSRC / name).read_text()
        assert 'extern "C" int nst_' in src and "cudaGetLastError" in src
    so = kernels.library_path()
    assert so.parent == kernels.BUILD_DIR and so.name.startswith("libnerfshop_kernels_")
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS


def test_require_rejects_bad_tensors():
    dev = torch.device("cpu")
    kernels.require(torch.zeros(4, 3), "x", torch.float32, (4, 3), dev)
    with pytest.raises(ValueError):
        kernels.require(torch.zeros(4, 3, dtype=torch.float64), "x", torch.float32, (4, 3), dev)
    with pytest.raises(ValueError):
        kernels.require(torch.zeros(4, 2), "x", torch.float32, (4, 3), dev)
    with pytest.raises(ValueError):
        kernels.require(torch.zeros(3, 4).t(), "x", torch.float32, (4, 3), dev)


def test_version_is_the_jax_packages():
    import nerfshop_tpu
    import nerfshop_tpu_torch
    from nerfshop_tpu_torch import version

    assert nerfshop_tpu_torch.__version__ == version.__version__ == nerfshop_tpu.__version__ == "0.1.0"
    assert "__version__" in nerfshop_tpu_torch.__all__
