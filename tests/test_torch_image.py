"""The port's Image testbed (``nerfshop_tpu_torch/train/image.py``, kernels
B and A at D = 2 in their plain versions) against
``nerfshop_tpu/train/image.py`` on the same numpy image, weights and draws,
on the CPU; the Testbed and the CLI in Image mode."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfshop_tpu.models import encodings as jenc
from nerfshop_tpu.train import image as jimage
from nerfshop_tpu.train import losses as jlosses
from nerfshop_tpu.train import optim as joptim
from nerfshop_tpu_torch import run as trun
from nerfshop_tpu_torch import weights
from nerfshop_tpu_torch.data import image_io as tio
from nerfshop_tpu_torch.models import encodings as tenc
from nerfshop_tpu_torch.ops import table_ops
from nerfshop_tpu_torch.testbed import Testbed
from nerfshop_tpu_torch.train import image as timage
from nerfshop_tpu_torch.train import losses as tlosses
from nerfshop_tpu_torch.train import optim as toptim
from torch_one_thread import one_thread  # noqa: F401

#: configs/image/base.json cut to 6 levels of at most 2^12 (dense levels
#: and hashed ones; the 64-wide, 2-hidden-layer MLP kept). Adam's epsilon
#: is 1e-8, not the config's 1e-15: at 1e-15 the first step moves every
#: parameter by ±lr whatever its gradient, so one whose gradient is ~1e-12
#: (its sign set by the summation order) moves by 2·lr between the packages
CONFIG = {
    "loss": {"otype": "L2"},
    "optimizer": {"otype": "ExponentialDecay", "decay_start": 20000, "decay_interval": 10000, "decay_base": 0.33,
                  "nested": {"otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9, "beta2": 0.99, "epsilon": 1e-8,
                             "l2_reg": 1e-6}},
    "encoding": {"otype": "HashGrid", "n_levels": 6, "n_features_per_level": 2, "log2_hashmap_size": 12,
                 "base_resolution": 8, "per_level_scale": 1.8},
    "network": {"otype": "FullyFusedMLP", "n_neurons": 64, "n_hidden_layers": 2},
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _image(H=40, W=48, seed=0):
    """Sinusoids, a checkerboard and a disc: detail at every scale."""
    y, x = np.mgrid[0:H, 0:W] / np.array([H, W], np.float64)[:, None, None]
    disc = ((x - 0.6) ** 2 + (y - 0.4) ** 2 < 0.05).astype(np.float64)
    check = ((x * 6).astype(int) + (y * 5).astype(int)) % 2
    img = np.stack([0.5 + 0.4 * np.sin(11 * x) * np.cos(7 * y), 0.3 + 0.5 * check, 0.2 + 0.7 * disc], -1)
    return (img + np.random.default_rng(seed).normal(0, 0.02, img.shape)).astype(np.float32)


def _pair(seed=0):
    jm = jimage.ImageModel.from_config(CONFIG)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = timage.ImageModel.from_config(CONFIG)
    tm.load_state_dict(weights.field_params_from_jax(jax.tree.map(np.asarray, jp)))
    return jm, jp, tm


def test_image_model_shapes_and_levels():
    jm, jp, tm = _pair()
    e = tm.encoding
    assert e.n_input_dims == 2 and e.level_sizes == jm.encoding.level_sizes
    assert any(e.level_dense) and not all(e.level_dense)
    assert [tuple(w.shape) for w in tm.network.weights] == [(12, 64), (64, 64), (64, 3)]
    assert weights.field_params_to_jax(dict(tm.named_parameters()))["encoding"]["table"].shape == jp["encoding"]["table"].shape


def test_sample_image_bilinear_matches():
    # exact at pixel centres, within 1e-6 elsewhere, edges clamped
    img = _image()
    xy = np.random.default_rng(1).uniform(0, 1, (3000, 2)).astype(np.float32)
    xy[:4] = [[0, 0], [1, 1], [0.5 / 48, 0.5 / 40], [1, 0]]
    ref = np.asarray(jimage.sample_image_bilinear(jnp.asarray(img), jnp.asarray(xy)))
    ours = timage.sample_image_bilinear(_t(img), _t(xy)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
    assert ours[2] == pytest.approx(img[0, 0])


def test_image_model_apply_matches():
    # bf16 MLP operands rounded at the same points: within 1e-5
    jm, jp, tm = _pair()
    with torch.no_grad():
        tm.encoding.table.mul_(1e3)  # features of O(0.1)
    jp = weights.field_params_to_jax(dict(tm.named_parameters()))
    xy = np.random.default_rng(2).uniform(0, 1, (2000, 2)).astype(np.float32)
    ref = np.asarray(jm.apply(jax.tree.map(jnp.asarray, jp), jnp.asarray(xy)))
    with torch.no_grad():
        ours = tm(_t(xy)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def test_table_grad_at_d2_matches_jax():
    # the 2-D grid's table gradient (sort, kernel A's plain version at 8-float
    # rows, the corner fold) vs jax.grad of the JAX encoding: 1e-5 of the
    # largest entry
    je = jenc.build_encoding(CONFIG["encoding"], 2)
    te = tenc.build_encoding(CONFIG["encoding"], 2)
    table = np.asarray(je.init(jax.random.PRNGKey(3))["table"]) * 1e3
    with torch.no_grad():
        te.table.copy_(_t(table))
    x = np.random.default_rng(4).uniform(0, 1, (1500, 2)).astype(np.float32)
    x[:3] = [[0, 0], [1, 1], [1, 0]]
    ct = np.random.default_rng(5).standard_normal((1500, te.n_output_dims)).astype(np.float32)
    ref = np.asarray(jax.jit(jax.grad(lambda t: jnp.sum(je.apply({"table": t}, jnp.asarray(x)) * ct)))(jnp.asarray(table)))
    out = te(_t(x))
    (ours,) = torch.autograd.grad((out * _t(ct)).sum(), [te.table])
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    idx, w1 = te.brick_fracs(_t(x))
    assert w1.shape == (te.n_levels, 1500, 2)
    np.testing.assert_allclose(table_ops.table_grad(idx, w1, _t(ct), te).numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_train_step_matches():
    # one step from the same weights and JAX's draws: the loss within 1e-5
    # relative, the params within 1e-4
    jm, jp, tm = _pair(seed=1)
    img = _image()
    spec = joptim.build_optimizer(CONFIG["optimizer"])
    jstate = joptim.create_train_state(jp, spec)
    B = 2048
    step = jimage.make_train_step(jm, spec, jlosses.build_loss(CONFIG["loss"]), batch_size=B)
    rng = jax.random.PRNGKey(7)
    xy = np.asarray(jax.random.uniform(rng, (B, 2)))  # image.py:66-67
    jstate, jloss = step(jstate, jnp.asarray(img), rng)
    tstate = toptim.TrainState(tm, toptim.build_optimizer(CONFIG["optimizer"]))
    loss = timage.train_step(tm, tstate, tlosses.build_loss(CONFIG["loss"]), _t(img), _t(xy))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    ref = weights.field_params_from_jax(jax.tree.map(np.asarray, jstate.params))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=0, atol=1e-4, err_msg=name)


def test_render_full_image_and_mse_match():
    jm, jp, tm = _pair(seed=2)
    with torch.no_grad():
        tm.encoding.table.mul_(1e3)
    jp = jax.tree.map(jnp.asarray, weights.field_params_to_jax(dict(tm.named_parameters())))
    ref = np.asarray(jimage.render_full_image(jm, jp, (20, 24), chunk=128))
    ours = timage.render_full_image(tm, None, (20, 24), chunk=128).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    target = _image(20, 24)
    for q in (False, True):
        jm_mse = float(jimage.compute_image_mse(jnp.asarray(ref), jnp.asarray(target), q))
        tm_mse = float(timage.compute_image_mse(_t(ours), _t(target), q))
        assert tm_mse == pytest.approx(jm_mse, rel=1e-4)


def test_testbed_image_mode_round_trip(tmp_path):
    img = _image()
    tio.write_image(tmp_path / "target.png", img, linear_input=True)
    tb = Testbed("image", config=CONFIG, device="cpu", seed=0)
    tb.load_training_data(str(tmp_path / "target.png"))
    np.testing.assert_allclose(tb._image_target, tio.read_image(tmp_path / "target.png", linear=True)[..., :3])
    m0 = tb.compute_image_mse()
    loss = tb.train(20, 4096)
    m1 = tb.compute_image_mse()
    assert np.isfinite(loss) and m1 < m0 and tb.stats.step == 20
    frame = tb.render(24, 20)
    assert frame.shape == (20, 24, 4) and (frame[..., 3] == 1).all() and frame[..., :3].max() <= 1
    tb.save_snapshot(str(tmp_path / "i.snap"))
    again = Testbed(device="cpu", seed=3)
    again.load_snapshot(str(tmp_path / "i.snap"))
    assert again.mode.value == "image" and again.stats.step == 20
    np.testing.assert_array_equal(again.render(24, 20), frame)
    with pytest.raises(RuntimeError, match="NeRF mode"):
        tb.begin_cage_edit()


def test_cli_image_mode(tmp_path, capsys):
    tio.write_image(tmp_path / "target.png", _image(), linear_input=True)
    (tmp_path / "net.json").write_text(json.dumps(CONFIG))
    tb = trun.main(["--scene", str(tmp_path / "target.png"), "--network", str(tmp_path / "net.json"), "--n_steps", "4",
                    "--batch_size", "2048", "--screenshot_dir", str(tmp_path / "shots"), "--width", "24",
                    "--height", "20", "--save_snapshot", str(tmp_path / "i.snap"), "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert tb.mode.value == "image" and tb.stats.step == 4
    result = json.loads(lines[-1])
    assert result["image_psnr"] == pytest.approx(-10 * np.log10(result["image_mse"]))
    assert result["image_mse"] == pytest.approx(tb.compute_image_mse())
    assert tio.read_image(tmp_path / "shots" / "screenshot.png", linear=False).shape == (20, 24, 4)
    with pytest.raises(RuntimeError, match="NeRF mode"):
        trun.main(["--mode", "image", "--load_snapshot", str(tmp_path / "i.snap"), "--save_mesh",
                   str(tmp_path / "m.obj"), "--device", "cpu"])
