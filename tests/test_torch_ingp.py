"""`.ingp` / `.msgpack` snapshots in the port (``nerfshop_tpu_torch/io/ingp.py``)
against the JAX package's ``io/ingp.py``: files byte-equal for the same
parameters and grid, each package reading the other's files to the same
tensors, the re-bake into the plain layout (dense levels copied, hashed
levels fitted within JAX's bound, ``tests/test_ingp.py:138``), the
``Testbed`` round trip within JAX's bound (``tests/test_ingp.py:99``), and
``interop="strict"`` refusing a brick table."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfshop_tpu.config import default_nerf_config as jdefault_config
from nerfshop_tpu.io import ingp as jingp
from nerfshop_tpu.models.nerf_network import build_nerf_network as jbuild
from nerfshop_tpu.testbed import Testbed as JTestbed
from nerfshop_tpu_torch import weights
from nerfshop_tpu_torch.io import ingp as tingp
from nerfshop_tpu_torch.io import msgpack_codec
from nerfshop_tpu_torch.models.nerf_network import build_nerf_network as tbuild
from nerfshop_tpu_torch.ops import xor_encode
from nerfshop_tpu_torch.testbed import Testbed as TTestbed

from nerfshop_tpu.data.nerf_loader import NerfDataset as JNerfDataset
from test_torch_snapshot import H, W, _seeded_jax_testbed
from torch_one_thread import one_thread  # noqa: F401


@pytest.fixture(autouse=True)
def small_rebake(monkeypatch):
    # the re-bake's 300 Adam steps at 2^11 points rather than 2^14: the CPU
    # runs the plain versions of kernels B, K and L
    monkeypatch.setattr(tingp, "REBAKE_BATCH", 1 << 11)


def _source_testbed(seed):
    """The seeded JAX testbed of ``test_torch_snapshot.py`` with the dataset
    of metadata alone that an ``.ingp`` load makes (the dataset decides the
    render's context), so that the frames compare."""
    src = _seeded_jax_testbed(seed)
    src._dataset = JNerfDataset(images=np.zeros((1, 2, 2, 4), np.float32), xforms=np.eye(4, dtype=np.float32)[None, :3],
                                intrinsics=[], paths=[], aabb_scale=1)
    return src


def _small_config(n_levels=4, log2=12):
    cfg = jdefault_config()
    cfg["encoding"]["n_levels"] = n_levels
    cfg["encoding"]["log2_hashmap_size"] = log2
    return dict(cfg)


def _models(cfg, aabb_scale=2, seed=0):
    jm = jbuild(cfg, aabb_scale=aabb_scale)
    params = jm.init(jax.random.PRNGKey(seed))
    params = jax.tree.map(np.asarray, params)
    tm = tbuild(cfg, aabb_scale=aabb_scale, device="cpu")
    state = weights.params_from_jax(params)
    tm.load_state_dict(state, strict=False)
    return jm, params, tm, state


def _grid(C=1, seed=0):
    g = np.random.default_rng(seed).uniform(0, 3, (C, 128, 128, 128)).astype(np.float32)
    g[0, 0, 0, :4] = [7e4, -7e4, 1e5, 0.5]  # past fp16's range: clamped at ±65000
    return g


@pytest.mark.parametrize("name", ["snap.ingp", "snap.msgpack"])
def test_files_byte_equal_to_jax(tmp_path, name):
    cfg = _small_config()
    jm, params, tm, state = _models(cfg)
    grid = _grid()
    kw = dict(density_grid=grid, aabb_scale=2, training_step=777, loss=0.0123, interop="warn")
    with pytest.warns(UserWarning, match="brick"):
        jingp.export_ingp(tmp_path / f"j_{name}", cfg, jm, params, **kw)
    with pytest.warns(UserWarning, match="brick"):
        tingp.export_ingp(str(tmp_path / f"t_{name}"), cfg, tm, state, **kw)
    a, b = (tmp_path / f"j_{name}").read_bytes(), (tmp_path / f"t_{name}").read_bytes()
    assert a == b
    assert (a[:1] == b"\x78") == name.endswith(".ingp")


def test_each_package_reads_the_others_file(tmp_path):
    cfg = _small_config(3, 11)
    jm, params, tm, state = _models(cfg, seed=1)
    grid = _grid(2, seed=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jingp.export_ingp(tmp_path / "j.ingp", cfg, jm, params, density_grid=grid, training_step=5, interop="warn")
        with torch.no_grad():
            for v in state.values():
                v.mul_(0.5)
        tingp.export_ingp(str(tmp_path / "t.msgpack"), cfg, tm, state, density_grid=grid[:1], loss=0.5, interop="warn")
    template = dict(tm.named_parameters())
    for path, step in (("j.ingp", 5), ("t.msgpack", 0)):
        ours = tingp.import_ingp(str(tmp_path / path), template)
        ref = jingp.import_ingp(tmp_path / path, jm, params)
        ref_state = weights.params_from_jax(jax.tree.map(np.asarray, ref["params"]))
        for k, v in ours["params"].items():
            np.testing.assert_array_equal(v.numpy(), ref_state[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(ours["density_grid"], ref["density_grid"])
        assert ours["training_step"] == ref["training_step"] == step
        assert ours["loss"] == ref["loss"] and ours["config"] == ref["config"]
    # the port's file holds the halved params to fp16
    back = tingp.import_ingp(str(tmp_path / "t.msgpack"), template)["params"]
    np.testing.assert_allclose(back["pos_encoding.table"].numpy(), state["pos_encoding.table"].numpy(), atol=1e-4, rtol=1e-2)


def _rebake_setup():
    cfg = _small_config(4, 9)
    cfg["encoding"]["base_resolution"] = 4
    cfg["encoding"]["per_level_scale"] = 2.0
    jm, params, tm, state = _models(cfg, aabb_scale=1, seed=3)
    table = np.random.default_rng(4).normal(size=state["pos_encoding.table"].shape).astype(np.float32) * 0.1
    state["pos_encoding.table"] = torch.from_numpy(table)
    with torch.no_grad():
        tm.pos_encoding.table.copy_(state["pos_encoding.table"])
    return cfg, tm, state


def test_rebake_copies_dense_levels():
    _, tm, state = _rebake_setup()
    enc_b = tm.pos_encoding
    assert any(enc_b.level_dense) and not all(enc_b.level_dense)
    enc_p, tp, mse = tingp.rebake_plain_table(enc_b, state["pos_encoding.table"], n_steps=0)
    assert mse == 0.0 and enc_p.layout == "plain"
    for l in range(enc_b.n_levels):
        seg = tp[enc_p.level_offsets[l]: enc_p.level_offsets[l + 1]]
        if enc_b.level_dense[l]:
            n = enc_b.level_res[l] ** 3
            assert torch.equal(seg[:n], state["pos_encoding.table"][enc_b.level_offsets[l]: enc_b.level_offsets[l] + n])
        else:
            assert not seg.any()


def test_rebake_convert_fits_as_jax_does(tmp_path):
    # JAX's test config and table scale (tests/test_ingp.py:138); both
    # packages fit the same table at 2^11 points a step (REBAKE_BATCH
    # above). The fit's floor is the plain table's hash collisions: JAX's
    # mean error is ~0.020 there (0.0197 at its own 2^14 points), so the port
    # is held to JAX's error on the same table (chip_smoke.py [ingp] prints
    # the full-size fit's on the card)
    cfg, tm, state = _rebake_setup()
    path = tmp_path / "conv.ingp"
    with pytest.warns(UserWarning, match="least-squares fit MSE"):
        tingp.export_ingp(str(path), cfg, tm, state)  # interop="convert"
    loaded = tingp.load_ingp(str(path))
    assert loaded["encoding"]["layout"] == "plain"
    tp_model = tbuild(loaded, aabb_scale=1, device="cpu")
    assert tp_model.pos_encoding.layout == "plain"
    out = tingp.unpack_params(np.frombuffer(loaded["snapshot"]["params_binary"], np.float16), dict(tp_model.named_parameters()))
    x = np.random.default_rng(5).uniform(0, 1, (512, 3)).astype(np.float32)
    with torch.no_grad():
        y_brick = tm.pos_encoding(torch.from_numpy(x)).numpy()
        y_plain = xor_encode.xor_encode_plain(out["pos_encoding.table"], torch.from_numpy(x), tp_model.pos_encoding).numpy()
    err = float(np.abs(y_plain - y_brick).mean())
    # JAX's reader builds the same plain model from the file and reads the same field
    jm_p = jbuild(loaded, aabb_scale=1)
    jout = jingp.unpack_params(jm_p, np.frombuffer(loaded["snapshot"]["params_binary"], np.float16), jm_p.init(jax.random.PRNGKey(0)))
    np.testing.assert_allclose(y_plain, np.asarray(jm_p.pos_encoding.apply(jout["pos_encoding"], jnp.asarray(x))), rtol=0, atol=1e-6)
    # JAX's re-bake of the same table
    jm = jbuild(cfg, aabb_scale=1)
    jparams = jm.init(jax.random.PRNGKey(0))
    jparams["pos_encoding"]["table"] = jnp.asarray(state["pos_encoding.table"].numpy())
    enc_j, tj, _ = jingp.rebake_plain_table(jm, jparams, batch=tingp.REBAKE_BATCH)
    y_j = np.asarray(enc_j.apply({"table": tj.astype(jnp.float16).astype(jnp.float32)}, jnp.asarray(x)))
    err_j = float(np.abs(y_j - y_brick).mean())
    assert err <= err_j + 2e-3 and err < 0.025, (err, err_j)


def test_strict_refuses_a_brick_table(tmp_path):
    cfg = _small_config(2, 10)
    _, _, tm, state = _models(cfg)
    with pytest.raises(ValueError, match="not readable by tcnn"):
        tingp.export_ingp(str(tmp_path / "x.ingp"), cfg, tm, state, interop="strict")
    assert not (tmp_path / "x.ingp").exists()


@pytest.mark.parametrize("interop", ["warn", "convert"])
def test_testbed_round_trip_renders_within_jax_bound(tmp_path, interop):
    src = _source_testbed(3)
    src.save_snapshot(str(tmp_path / "a.snap"))
    a = TTestbed(device="cpu", seed=0)
    a.load_snapshot(str(tmp_path / "a.snap"))
    before = a.render(W, H)
    path = str(tmp_path / "a.ingp")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        a.save_snapshot(path, interop=interop)
    b = TTestbed(device="cpu", seed=1)
    b.load_snapshot(path)
    assert b.stats.step == a.stats.step == 123
    assert b.model.pos_encoding.layout == ("plain" if interop == "convert" else "brick")
    after = b.render(W, H)
    assert np.isfinite(after).all() and before[..., 3].max() > 0.1
    assert float(np.abs(after - before).mean()) < 0.02
    # JAX's Testbed reads the port's file and renders it alike
    j = JTestbed()
    j.load_snapshot(path)
    assert j.stats.step == 123
    ref = j.render(W, H, exact=True)
    assert float(np.abs(after - ref).mean()) < 0.02


def test_testbed_reads_a_file_without_layout_as_plain_and_trains_it(tmp_path):
    # JAX's .ingp (the brick table, layout recorded) loads as it is
    src = _source_testbed(4)
    path = str(tmp_path / "j.ingp")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        src.save_snapshot(path, interop="warn")
    t = TTestbed(device="cpu")
    t.load_snapshot(path)
    assert t.model.pos_encoding.layout == "brick"
    ref = src.render(W, H, exact=True)
    assert float(np.abs(t.render(W, H) - ref).mean()) < 0.02
    # a tcnn file names no layout: its table is read as the plain one
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t.save_snapshot(str(tmp_path / "p.ingp"))  # re-baked
    cfg = tingp.load_ingp(str(tmp_path / "p.ingp"))
    del cfg["encoding"]["layout"]
    (tmp_path / "tcnn.msgpack").write_bytes(msgpack_codec.packb(cfg))
    p = TTestbed(device="cpu", seed=2)
    p.set_training_data(_dataset())
    p.load_snapshot(str(tmp_path / "tcnn.msgpack"))
    assert p.model.pos_encoding.layout == "plain" and p._dataset.n_images == 3
    before = p.model.pos_encoding.table.detach().clone()
    loss = p.train(2, 1 << 12)
    assert np.isfinite(loss) and p.stats.step == 123 + 2
    assert not torch.equal(before, p.model.pos_encoding.table.detach())  # the table trained through L
    with pytest.raises(ValueError, match="contains no snapshot"):
        del cfg["snapshot"]
        (tmp_path / "empty.msgpack").write_bytes(msgpack_codec.packb(cfg))
        tingp.import_ingp(str(tmp_path / "empty.msgpack"), dict(p.model.named_parameters()))


def _dataset(n=3, res=16):
    from nerfshop_tpu_torch.data.nerf_loader import CameraIntrinsics, NerfDataset

    rng = np.random.default_rng(0)
    xf = np.stack([np.concatenate([np.eye(3), [[0.5], [0.5 - 0.1 * i], [-0.8]]], 1) for i in range(n)]).astype(np.float32)
    intr = [CameraIntrinsics(np.array([20.0, 20.0], np.float32), np.array([0.5, 0.5], np.float32),
                             np.zeros(4, np.float32), np.array([res, res], np.int32)) for _ in range(n)]
    return NerfDataset(images=rng.uniform(0, 1, (n, res, res, 4)).astype(np.float32), xforms=xf, intrinsics=intr,
                       paths=[""] * n, aabb_scale=1)
