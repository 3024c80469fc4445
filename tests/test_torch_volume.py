"""The port's Volume testbed (``nerfshop_tpu_torch/train/volume.py``) and its
copy of ``data/volume_io.py`` against the JAX package on the same numpy
volumes, weights and draws, on the CPU; the Testbed and the CLI in Volume
mode."""

import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfshop_tpu import Testbed as JTestbed
from nerfshop_tpu.data import volume_io as jvolume_io
from nerfshop_tpu.train import volume as jvolume
from nerfshop_tpu_torch import run as trun
from nerfshop_tpu_torch import weights
from nerfshop_tpu_torch.data import volume_io as tvolume_io
from nerfshop_tpu_torch.ops import rays as trays
from nerfshop_tpu_torch.testbed import Testbed
from nerfshop_tpu_torch.train import volume as tvolume

from test_volume import _write_test_nvdb
from torch_one_thread import one_thread  # noqa: F401

CPU = torch.device("cpu")
#: configs/volume/base.json cut to 5 levels of at most 2^11 (the 64-wide,
#: 2-hidden-layer MLP kept); Adam's epsilon 1e-8 for the reason given in
#: tests/test_torch_sdf.py
CONFIG = {
    "loss": {"otype": "L2"},
    "optimizer": {"otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9, "beta2": 0.99, "epsilon": 1e-8,
                  "l2_reg": 1e-6},
    "encoding": {"otype": "HashGrid", "n_levels": 5, "n_features_per_level": 2, "log2_hashmap_size": 11,
                 "base_resolution": 8, "per_level_scale": 1.6},
    "network": {"otype": "FullyFusedMLP", "n_neurons": 64, "n_hidden_layers": 2},
}
CAM = np.array([[1, 0, 0, 0.5], [0, -1, 0, 0.5], [0, 0, 1, -1.2]], np.float32)
FOCAL = np.array([28.0, 28.0], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _write_all_formats(tmp_path, vol):
    np.save(tmp_path / "v.npy", vol)
    np.savez(tmp_path / "named.npz", other=np.zeros(2), density=vol)
    np.savez(tmp_path / "first.npz", vol)
    vol.astype(np.float16).tofile(tmp_path / "v.raw")
    (tmp_path / "v.json").write_text(json.dumps({"dims": list(vol.shape), "dtype": "float16"}))
    rng = np.random.default_rng(0)
    dense = np.zeros((24, 16, 16), np.float32)
    dense[2:10, 3:11, 4:12] = rng.uniform(0.1, 2.0, (8, 8, 8)).astype(np.float32)
    dense[16:24, 8:16, 0:8] = rng.uniform(0.1, 1.0, (8, 8, 8)).astype(np.float32)
    _write_test_nvdb(tmp_path / "leaves.nvdb", dense)
    tiles = [(8, 8, 16, 0.7), (16, 8, 16, 0.3), (8, 120, 120, 1.5)]
    _write_test_nvdb(tmp_path / "tiles.nvdb", np.zeros((8, 8, 8), np.float32), tiles=tiles,
                     index_bbox=((8, 8, 16), (23, 127, 127)))
    return ["v.npy", "named.npz", "first.npz", "v.raw", "leaves.nvdb", "tiles.nvdb"]


def test_volume_io_every_format_matches(tmp_path):
    vol = tvolume.synthetic_smoke(12)
    for name in _write_all_formats(tmp_path, vol):
        ours, ref = tvolume_io.load_volume(tmp_path / name), jvolume_io.load_volume(tmp_path / name)
        assert ours.dtype == np.float32 and ours.ndim == 3
        np.testing.assert_array_equal(ours, ref, err_msg=name)
    np.testing.assert_array_equal(tvolume_io.load_volume(tmp_path / "v.npy"), vol)
    (tmp_path / "x.vdb").write_bytes(b"\x20\x42\x44\x56" + b"\0" * 64)
    with pytest.raises(NotImplementedError, match="OpenVDB"):
        tvolume_io.load_volume(tmp_path / "x.vdb")
    (tmp_path / "c.nvdb").write_bytes(struct.pack("<QIHH", 0x304244566F6E614E, 0, 1, 1) + b"\x00" * 176)
    with pytest.raises(NotImplementedError):
        tvolume_io.load_volume(tmp_path / "c.nvdb")
    with pytest.raises(ValueError, match="unsupported"):
        tvolume_io.load_volume(tmp_path / "v.json")


@pytest.mark.parametrize("res,seed", [(16, 0), (33, 4)])
def test_synthetic_smoke_bit_equal(res, seed):
    ours, ref = tvolume.synthetic_smoke(res, seed), jvolume.synthetic_smoke(res, seed)
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


def _pair(vol, seed=0, scale=1e3):
    """A JAX VolumeTestbed and the port's with its weights (the table scaled
    so that the features are O(0.1))."""
    jtb = jvolume.VolumeTestbed.create(CONFIG, vol, jax.random.PRNGKey(seed))
    params = jax.tree.map(np.asarray, jtb.state.params)
    params["encoding"]["table"] = params["encoding"]["table"] * scale
    jtb.state = jtb.state._replace(params=jax.tree.map(jnp.asarray, params))
    ttb = tvolume.VolumeTestbed.create(CONFIG, vol, CPU, torch.Generator().manual_seed(seed))
    ttb.model.load_state_dict(weights.field_params_from_jax(params))
    return jtb, ttb


@pytest.fixture(scope="module")
def pair():
    return _pair(tvolume.synthetic_smoke(24))


def test_gt_at_and_model_match(pair):
    # trilinear ground truth within 1e-5 relative; the field within 1e-5
    jtb, ttb = pair
    assert ttb.majorant == jtb.majorant
    pos = np.random.default_rng(1).uniform(-0.1, 1.1, (3000, 3)).astype(np.float32)
    ref = np.asarray(jtb._gt_at(jnp.asarray(pos)))
    np.testing.assert_allclose(ttb._gt_at(_t(pos)).numpy(), ref, rtol=1e-5, atol=1e-6)
    ja, jd = jtb.model.apply(jtb.state.params, jnp.clip(jnp.asarray(pos), 0, 1))
    with torch.no_grad():
        ta, td = ttb.model(torch.clamp(_t(pos), 0, 1))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=1e-5)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)


def test_train_step_matches():
    # one step from the same weights and JAX's draws (volume.py:133-137): the
    # loss within 1e-5 relative, the params within 1e-4
    jtb, ttb = _pair(tvolume.synthetic_smoke(24), seed=1)
    B = 2048
    k = jax.random.split(jtb.rng)[1]
    k1, k2 = jax.random.split(k)
    pos = np.concatenate([np.asarray(jax.random.uniform(k1, (B // 2, 3))), np.asarray(jax.random.uniform(k2, (B // 2, 3)))])
    jloss = jtb.train(1, batch_size=B)
    loss = float(ttb.train_step(_t(pos)))
    assert loss == pytest.approx(jloss, rel=1e-5)
    ref = weights.field_params_from_jax(jax.tree.map(np.asarray, jtb.state.params))
    for name, p in ttb.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=0, atol=1e-4, err_msg=name)


def _jax_draws(rng, R):
    """Iteration i's two uniforms of JAX's tracker (volume.py:185-205),
    made in order from its key."""
    key = [rng]

    def draws(i):
        key[0], k1, k2 = jax.random.split(key[0], 3)
        return _t(np.asarray(jax.random.uniform(k1, (R,)))), _t(np.asarray(jax.random.uniform(k2, (R,))))

    return draws


@pytest.mark.parametrize("use_gt", [False, True], ids=["network", "ground truth"])
def test_delta_track_matches(pair, use_gt):
    # JAX's draws for every ray, the port tracking only the alive ones: the
    # hits equal, rgb within 1e-4
    jtb, ttb = pair
    b = trays.rays_for_image((24, 24), _t(CAM), _t(FOCAL), _t(np.array([0.5, 0.5], np.float32)))
    rng = jax.random.PRNGKey(9)
    track = jax.jit(lambda p, o, d, r: jtb._delta_track(p, o, d, r, use_gt=use_gt))
    jrgb, jhit = track(jtb.state.params, jnp.asarray(b.origins.numpy()), jnp.asarray(b.directions.numpy()), rng)
    rgb, hit = ttb._delta_track(ttb.state.inference_params, b.origins, b.directions, use_gt=use_gt,
                                draws=_jax_draws(rng, 576))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), rtol=0, atol=1e-4)
    assert 0.05 < hit.float().mean() < 0.95


def test_render_is_the_mean_of_spp_tracks(pair):
    jtb, ttb = pair
    img = ttb.render(12, 10, CAM, FOCAL, spp=2, linear=True).numpy()
    assert img.shape == (10, 12, 4) and np.isfinite(img).all()
    assert set(np.unique(img[..., 3])) <= {0.0, 0.5, 1.0}


def test_testbed_volume_mode_round_trip(tmp_path, capsys):
    np.save(tmp_path / "smoke.npy", tvolume.synthetic_smoke(16))
    tb = Testbed("volume", config=CONFIG, device="cpu", seed=0)
    tb.load_training_data(str(tmp_path / "smoke.npy"))
    l0 = tb.train(1, 2048)
    l1 = tb.train(10, 2048)
    assert np.isfinite(l1) and l1 < l0 and tb.stats.step == 11
    img = tb.render(12, 10)
    assert img.shape == (10, 12, 4) and np.isfinite(img).all()
    tb.save_snapshot(str(tmp_path / "v.snap"))
    again = Testbed(device="cpu", seed=4)
    again.load_snapshot(str(tmp_path / "v.snap"))
    assert again.mode.value == "volume" and again.stats.step == 11
    for (k, a), b in zip(again.model.named_parameters(), tb.model.parameters()):  # F13: the loaded weights
        assert torch.equal(a, b), k
    again.load_training_data(str(tmp_path / "smoke.npy"))
    again.load_snapshot(str(tmp_path / "v.snap"))
    assert again._volume.gt_density is not None
    # the CLI: --mode volume on the .npy, then from its snapshot
    out = trun.main(["--mode", "volume", "--scene", str(tmp_path / "smoke.npy"), "--network", _cfg_file(tmp_path),
                     "--n_steps", "3", "--batch_size", "1024", "--save_snapshot", str(tmp_path / "cli.snap"),
                     "--screenshot_dir", str(tmp_path / "shots"), "--width", "12", "--height", "10", "--device", "cpu"])
    assert out.mode.value == "volume" and out.stats.step == 3
    assert any(line.startswith("  step      3") for line in capsys.readouterr().out.splitlines())
    again = trun.main(["--mode", "volume", "--load_snapshot", str(tmp_path / "cli.snap"), "--n_steps", "0",
                       "--device", "cpu"])
    for (k, a), b in zip(again.model.named_parameters(), out.model.parameters()):
        assert torch.equal(a, b), k


def _cfg_file(tmp_path):
    (tmp_path / "net.json").write_text(json.dumps(CONFIG))
    return str(tmp_path / "net.json")


@pytest.mark.xfail(strict=True, reason=(
    "F13 (reference fault): JAX load_snapshot restores params into Testbed._state, but "
    "_reset_network built a fresh VolumeTestbed (nerfshop_tpu/testbed.py:297) whose render reads its "
    "own state (nerfshop_tpu/train/volume.py:229), and train copies that state back "
    "(nerfshop_tpu/testbed.py:415); the loaded weights are lost"))
def test_jax_volume_load_snapshot_keeps_weights(tmp_path):
    # what render and train read after load_snapshot: the VolumeTestbed's state
    cfg = {**CONFIG, "encoding": {**CONFIG["encoding"], "n_levels": 3, "log2_hashmap_size": 9}}
    src = JTestbed("volume", config=cfg)
    src.save_snapshot(str(tmp_path / "j.snap"))
    dst = JTestbed("volume", config=cfg)
    dst.load_snapshot(str(tmp_path / "j.snap"))
    for a, b in zip(jax.tree.leaves(dst._volume.state.params), jax.tree.leaves(src._state.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
