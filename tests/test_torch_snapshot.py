"""Snapshots across the two packages: the port's MessagePack codec against the
``msgpack`` package, the morton helpers against ``nerfshop_tpu/ops/coords.py``,
and ``save_snapshot``/``load_snapshot`` from JAX to the port, from the port
to JAX, and from the port to itself."""

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from nerfshop_tpu.ops import coords as jcoords
from nerfshop_tpu.ops import grid as jgrid
from nerfshop_tpu.testbed import Testbed as JTestbed
from nerfshop_tpu_torch import weights
from nerfshop_tpu_torch.io import msgpack_codec, snapshot as tsnap
from nerfshop_tpu_torch.ops import coords as tcoords
from nerfshop_tpu_torch.ops import grid as tgrid
from nerfshop_tpu_torch.testbed import Testbed as TTestbed

CFG = {
    "loss": {"otype": "Huber"},
    "optimizer": {"otype": "Ema", "decay": 0.95, "nested": {"otype": "Adam", "learning_rate": 1e-2}},
    "encoding": {"otype": "HashGrid", "n_levels": 3, "n_features_per_level": 2,
                 "log2_hashmap_size": 12, "base_resolution": 8, "per_level_scale": 1.5},
    "network": {"n_neurons": 64, "n_hidden_layers": 1},
    "dir_encoding": {"otype": "SphericalHarmonics", "degree": 4},
    "rgb_network": {"n_neurons": 64, "n_hidden_layers": 2},
}
W, H = 24, 16


# ------------------------------------------------------------------ codec


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    arr = rng.standard_normal((5, 3)).astype(np.float32)
    return {
        "version": 2,
        "generator": "x" * 40,
        "mode": "nerf",
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63, 2**64 - 1,
                 -1, -32, -33, -128, -129, -32768, -32769, -(2**31), -(2**31) - 1, -(2**63)],
        "floats": [0.0, -1.5, 1e300, float(np.float32(0.1)), float("inf")],
        "flags": [True, False, None],
        "strings": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 40000],
        "bins": [b"", b"\x00" * 255, b"\x01" * 256, b"\x02" * 70000, arr.tobytes()],
        "long_list": list(range(20)),
        "big_map": {f"k{i}": i for i in range(17)},
        "params": {"/pos_encoding/table": {"dtype": "float32", "shape": [5, 3], "data": arr.tobytes()}},
        "nested": {"a": [[1, 2], {"b": [None]}], "empty": {}, "tuple": (1, 2.5)},
        1: "int key",
    }


def test_codec_bytes_equal_msgpack():
    tree = _tree()
    assert msgpack_codec.packb(tree) == msgpack.packb(tree, use_bin_type=True)


def test_codec_unpacks_msgpack():
    tree = _tree(1)
    blob = msgpack.packb(tree, use_bin_type=True)
    ours = msgpack_codec.unpackb(blob)
    assert ours == msgpack.unpackb(blob, raw=False, strict_map_key=False)
    # float32 and the 32-bit containers, which packb never writes
    f32 = b"\xca" + np.array(0.25, ">f4").tobytes()
    assert msgpack_codec.unpackb(f32) == 0.25
    big = msgpack.packb(list(range(70000)), use_bin_type=True)
    assert msgpack_codec.unpackb(big) == list(range(70000))
    with pytest.raises(ValueError):
        msgpack_codec.unpackb(blob + b"\x00")


def test_codec_rejects_unknown_types():
    with pytest.raises(TypeError):
        msgpack_codec.packb({"a": object()})


# ----------------------------------------------------------------- morton


def test_morton_helpers_match():
    rng = np.random.default_rng(2)
    xyz = rng.integers(0, 1024, (3, 4096)).astype(np.int32)
    j = np.asarray(jcoords.morton3d(*(jnp.asarray(v) for v in xyz)))
    t = tcoords.morton3d(*(torch.from_numpy(v) for v in xyz)).numpy()
    np.testing.assert_array_equal(t, j.astype(np.int64))
    codes = rng.integers(0, 2**30, 4096).astype(np.uint32)
    for a, b in zip(tcoords.morton3d_invert(torch.from_numpy(codes.astype(np.int64))),
                    jcoords.morton3d_invert(jnp.asarray(codes))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(np.int64))
    dense = rng.standard_normal((128, 128, 128)).astype(np.float32)
    jm = np.asarray(jcoords.dense_grid_to_morton(jnp.asarray(dense)))
    tm = tcoords.dense_grid_to_morton(torch.from_numpy(dense)).numpy()
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tcoords.morton_to_dense_grid(torch.from_numpy(tm)).numpy(), dense)
    np.testing.assert_array_equal(np.asarray(jcoords.morton_to_dense_grid(jnp.asarray(jm))), dense)


# -------------------------------------------------------------- snapshots


def _seeded_jax_testbed(seed=0):
    tb = JTestbed(config=CFG)
    rng = np.random.default_rng(seed)

    def draw(p, lo):
        return jax.tree.map(lambda a: jnp.asarray(rng.uniform(lo, 1.0, np.shape(a)).astype(np.float32) * (1.0 if a.ndim == 2 and a.shape[1] == 2 else np.sqrt(6.0 / a.shape[0]))), p)

    params = draw(tb._state.params, -1.0)
    ema = draw(tb._state.params, -1.0)
    tb._state = tb._state._replace(params=params, ema_params=ema)
    dens = (rng.uniform(0, 1, (1, 128, 128, 128)) ** 32 * 50).astype(np.float32)
    c = (np.arange(128) + 0.5) / 128 - 0.5
    # a dense ball lifts the mean above 0.01/Δmin, so both packages threshold
    # at that constant and not at their own fp32 sums of the grid
    dens[0] += np.where(c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None, :] ** 2 < 0.2**2, 400.0, 0.0)
    tb._grid = jgrid.update_bitfield(tb._grid._replace(density=jnp.asarray(dens)))
    tb.stats.step = 123
    assert float(tb._grid.occupancy.mean()) < 0.15 and float(tb._grid.mean_density) > 6.0
    return tb


def _assert_frames_close(ours, ref):
    # rgba within 1e-4 (linear output, bf16 MLP rounding points equal)
    assert ours.shape == ref.shape == (H, W, 4) and np.isfinite(ours).all()
    assert ref[..., 3].max() > 0.1
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)


def test_jax_snapshot_loads_in_port(tmp_path):
    jtb = _seeded_jax_testbed()
    path = tmp_path / "jax.msgpack.zst"
    jtb.save_snapshot(str(path))
    ttb = TTestbed(device="cpu")
    ttb.load_snapshot(str(path))
    # the grid and bitfield arrive as saved
    np.testing.assert_array_equal(ttb.grid.density.numpy(), np.asarray(jtb._grid.density))
    np.testing.assert_array_equal(ttb.grid.occupancy.numpy(), np.asarray(jtb._grid.occupancy))
    assert ttb.stats.step == 123
    jema = weights.params_from_jax(jax.tree.map(np.asarray, jtb._state.ema_params))
    for k, v in ttb.inference_params.items():
        np.testing.assert_array_equal(v.numpy(), jema[k].numpy())
    _assert_frames_close(ttb.render(W, H, linear=True), jtb.render(W, H, linear=True, exact=True))


def test_port_snapshot_loads_in_jax(tmp_path):
    src = _seeded_jax_testbed(1)
    path = tmp_path / "a.snap"
    src.save_snapshot(str(path))
    ttb = TTestbed(device="cpu")
    ttb.load_snapshot(str(path))
    with torch.no_grad():  # move the port's copy away from the JAX one
        for v in ttb.inference_params.values():
            v.mul_(0.9)
    back = tmp_path / "b.snap"
    ttb.save_snapshot(str(back))
    jtb = JTestbed()
    jtb.load_snapshot(str(back))
    np.testing.assert_array_equal(np.asarray(jtb._grid.occupancy), ttb.grid.occupancy.numpy())
    _assert_frames_close(ttb.render(W, H, linear=True), jtb.render(W, H, linear=True, exact=True))


def test_port_round_trip_is_bit_exact(tmp_path):
    src = _seeded_jax_testbed(2)
    path = tmp_path / "a.snap"
    src.save_snapshot(str(path))
    a = TTestbed(device="cpu")
    a.load_snapshot(str(path))
    with torch.no_grad():
        a.model.density_mlp.weights[0].add_(0.01)  # params ≠ EMA copy
    a.grid.density.mul_(1.5)
    tgrid.update_bitfield(a.grid)
    a.stats.step = 77
    path2 = tmp_path / "b.snap"
    a.save_snapshot(str(path2))
    b = TTestbed(device="cpu")
    b.load_snapshot(str(path2))
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    for k, v in a.inference_params.items():
        assert torch.equal(v, b.inference_params[k]), k
    assert torch.equal(a.grid.density, b.grid.density) and b.stats.step == 77
    assert np.array_equal(a.render(W, H), b.render(W, H))
    snap = tsnap.load_snapshot(path2)
    assert "opt_state" not in snap and snap["version"] == 2 and snap["generator"] == "nerfshop_tpu_torch"


@pytest.mark.parametrize("compress", [False, True])
def test_jax_io_snapshot_reads_in_port(tmp_path, compress):
    # nerfshop_tpu.io.snapshot.save_snapshot, NSTZ-wrapped or bare: arrays bit-equal
    from nerfshop_tpu.io import snapshot as jsnap

    rng = np.random.default_rng(5)
    params = {"pos_encoding": {"table": rng.standard_normal((64, 2)).astype(np.float32)},
              "density_mlp": {"weights": [rng.standard_normal((32, 64)).astype(np.float32)]}}
    dens = rng.uniform(0, 1, (1, 128, 128, 128)).astype(np.float32)
    path = tmp_path / "j.snap"
    jsnap.save_snapshot(path, params, CFG, density_grid=dens, step=9, compress=compress)
    assert (path.read_bytes()[:4] == b"NSTZ") == compress
    snap = tsnap.load_snapshot(path)
    np.testing.assert_array_equal(snap["params"]["/pos_encoding/table"], params["pos_encoding"]["table"])
    np.testing.assert_array_equal(snap["params"]["/density_mlp/weights/0"], params["density_mlp"]["weights"][0])
    np.testing.assert_array_equal(snap["density_grid"], dens)
    assert snap["step"] == 9 and snap["network_config"] == CFG


@pytest.mark.parametrize("name", ["a.ingp", "a.msgpack"])
def test_ingp_formats_raise(tmp_path, name):
    tb = TTestbed(device="cpu", config=CFG)
    with pytest.raises(NotImplementedError):
        tb.save_snapshot(str(tmp_path / name))
    with pytest.raises(NotImplementedError):
        tb.load_snapshot(str(tmp_path / name))


def test_snapshot_without_ema_fills_ema_from_params(tmp_path):
    tb = TTestbed(device="cpu", config=CFG, seed=3)
    path = tmp_path / "noema.snap"
    tsnap.save_snapshot(path, dict(tb.model.named_parameters()), CFG, density_grid=tb.grid.density)
    other = TTestbed(device="cpu", seed=4)
    other.load_snapshot(str(path))
    for k, v in other.inference_params.items():
        assert torch.equal(v, tb.model.state_dict()[k]), k
