"""The port's render facade (``nerfshop_tpu_torch/testbed.py``,
``render/buffer.py``, ``ops/tonemap.py``) against ``nerfshop_tpu/testbed.py``
and its helpers on the same calls, weights and grid."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfshop_tpu.common import TonemapCurve
from nerfshop_tpu.data.nerf_loader import CameraIntrinsics, NerfDataset
from nerfshop_tpu.ops import grid as jgrid
from nerfshop_tpu.ops import tonemap as jtm
from nerfshop_tpu.render import buffer as jbuffer
from nerfshop_tpu.testbed import Testbed as JTestbed
from nerfshop_tpu_torch import common as tcommon
from nerfshop_tpu_torch import testbed as ttestbed
from nerfshop_tpu_torch import weights
from nerfshop_tpu_torch.ops import grid as tgrid
from nerfshop_tpu_torch.ops import tonemap as ttm
from nerfshop_tpu_torch.render import buffer as tbuffer
from torch_one_thread import one_thread  # noqa: F401

CFG = {
    "loss": {"otype": "Huber"},
    "optimizer": {"otype": "Adam", "learning_rate": 1e-2},
    "encoding": {"otype": "HashGrid", "n_levels": 2, "n_features_per_level": 2,
                 "log2_hashmap_size": 12, "base_resolution": 8, "per_level_scale": 1.5},
    "network": {"n_neurons": 64, "n_hidden_layers": 1},
    "dir_encoding": {"otype": "SphericalHarmonics", "degree": 4},
    "rgb_network": {"n_neurons": 64, "n_hidden_layers": 2},
}
CURVES = list(TonemapCurve)


# ------------------------------------------------------ tonemap and buffer


@pytest.mark.parametrize("curve", CURVES, ids=[c.value for c in CURVES])
def test_tonemap_matches(curve):
    # within 1e-6 (pow/exp differ by ulps between XLA and torch)
    x = np.random.default_rng(0).uniform(-0.2, 4.0, (64, 3)).astype(np.float32)
    ref = np.asarray(jtm.apply_tonemap(jnp.asarray(x), curve))
    tcurve = tcommon.TonemapCurve(curve.value)
    np.testing.assert_allclose(ttm.apply_tonemap(torch.from_numpy(x), tcurve).numpy(), ref, rtol=0, atol=1e-6)
    for jf, tf in ((jtm.linear_to_srgb, ttm.linear_to_srgb), (jtm.srgb_to_linear, ttm.srgb_to_linear)):
        np.testing.assert_allclose(tf(torch.from_numpy(x)).numpy(), np.asarray(jf(jnp.asarray(x))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("curve", [TonemapCurve.Identity, TonemapCurve.ACES])
def test_render_buffer_matches(curve):
    rng = np.random.default_rng(1)
    frames = rng.uniform(0, 2, (5, 6, 7, 4)).astype(np.float32)
    depths = rng.uniform(0, 3, (5, 6, 7)).astype(np.float32)
    jb, tb = jbuffer.RenderBuffer((7, 6)), tbuffer.RenderBuffer((7, 6), device="cpu")
    jb.clear()
    tb.clear()
    for f, d in zip(frames, depths):
        jb.accumulate(jnp.asarray(f), jnp.asarray(d))
        tb.accumulate(torch.from_numpy(f), torch.from_numpy(d))
    assert tb.spp == jb.spp == 5
    np.testing.assert_allclose(tb.accumulate_rgba.numpy(), np.asarray(jb.accumulate_rgba), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tb.depth.numpy(), np.asarray(jb.depth), rtol=0, atol=1e-6)
    tcurve = tcommon.TonemapCurve(curve.value)
    for kw in (dict(exposure=0.5, curve=curve), dict(output_srgb=False, curve=curve), dict(input_is_srgb_space=True)):
        tkw = {**kw, "curve": tcurve} if "curve" in kw else kw
        np.testing.assert_allclose(tb.tonemapped(**tkw).numpy(), np.asarray(jb.tonemapped(**kw)), rtol=0, atol=1e-6)
    tb.resize((3, 2))
    assert tb.spp == 0 and tuple(tb.accumulate_rgba.shape) == (2, 3, 4)


# -------------------------------------------------------------- camera API


def _dataset(n=3, res=16):
    xf = np.stack([np.concatenate([np.eye(3), [[0.5], [0.5 - 0.1 * i], [-0.8]]], 1) for i in range(n)]).astype(np.float32)
    intr = [CameraIntrinsics(np.array([20.0 + i, 21.0 + i], np.float32), np.array([0.5, 0.5], np.float32),
                             np.zeros(4, np.float32), np.array([res, res + 2], np.int32)) for i in range(n)]
    images = np.zeros((n, res + 2, res, 4), np.float32)
    return NerfDataset(images=images, xforms=xf, intrinsics=intr, paths=[""] * n, aabb_scale=1)


def test_camera_api_matches():
    # the same calls on both facades give the same camera, within 1e-6
    jt, tt = JTestbed(), ttestbed.Testbed(device="cpu")
    jt._dataset = tt._dataset = _dataset()

    def same():
        np.testing.assert_allclose(tt.camera_matrix, jt.camera_matrix, rtol=0, atol=1e-6)
        for name in ("view_dir", "up_dir", "look_at"):
            np.testing.assert_allclose(getattr(tt, name), getattr(jt, name), rtol=0, atol=1e-6)
        assert tt.fov == pytest.approx(jt.fov) and tt.view_distance == pytest.approx(jt.view_distance)
        np.testing.assert_allclose(tt._focal_for(40, 30), jt._focal_for(40, 30), rtol=1e-6)

    same()
    steps = [
        lambda t: t.set_look_at(center=(0.4, 0.6, 0.5), eye=(1.5, -0.5, 0.9)),
        lambda t: setattr(t, "fov", 35.0),
        lambda t: setattr(t, "view_distance", 2.5),
        lambda t: setattr(t, "view_dir", (0.3, 0.8, -0.2)),
        lambda t: setattr(t, "look_at", (0.45, 0.5, 0.55)),
        lambda t: t.translate_camera((0.1, -0.2, 0.3)),
        lambda t: t.set_camera_to_training_view(2),
        lambda t: t.first_training_view(),
        lambda t: t.set_nerf_camera_matrix(np.concatenate([np.eye(3), [[0.2], [0.1], [2.0]]], 1)),
    ]
    for step in steps:
        step(jt)
        step(tt)
        same()


# ------------------------------------------------------- render facade


def _testbeds(seed=0):
    """A JAX and a port testbed with the same seeded weights and grid."""
    jt = JTestbed(config=CFG)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.array, jt._state.params)
    tree["pos_encoding"]["table"] = rng.uniform(-1, 1, tree["pos_encoding"]["table"].shape).astype(np.float32)
    jt._state = jt._state._replace(params=jax.tree.map(jnp.asarray, tree))
    c = (np.arange(128) + 0.5) / 128 - 0.5
    ball = c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None, :] ** 2 < 0.25**2
    dens = np.where(ball, 300.0, 0.0)[None].astype(np.float32)
    jt._grid = jgrid.update_bitfield(jt._grid._replace(density=jnp.asarray(dens)))
    tt = ttestbed.Testbed(device="cpu", config=CFG, seed=seed)
    tt.model.load_state_dict(weights.params_from_jax(tree))
    tt.grid.density = torch.from_numpy(dens)
    tgrid.update_bitfield(tt.grid)
    for t in (jt, tt):
        t.set_look_at(eye=(1.4, -0.6, 0.8))
        t.fov = 45.0
    return jt, tt


def test_render_matches_jax_testbed():
    # Testbed.render (exact) through tonemap and sRGB, rgba within 1e-4
    jt, tt = _testbeds()
    for t in (jt, tt):
        t.background_color = np.array([0.2, 0.1, 0.0, 1.0], np.float32)
        t.exposure = 0.3
    ref = jt.render(24, 16, linear=True, exact=True)
    ours = tt.render(24, 16, linear=True)
    assert ours.shape == (16, 24, 4) and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)
    with pytest.raises(NotImplementedError):
        tt.render(24, 16, exact=False)


@pytest.mark.parametrize("factor", [None, 0.5])
def test_render_dynamic_matches(factor):
    # dynamic_res off: the render itself; a forced factor renders at the
    # reduced size and upsamples (rgba within 1e-4, the render's own bound)
    jt, tt = _testbeds(1)
    for t in (jt, tt):
        t.dynamic_res = factor is not None
        t._dyn_res_factor = factor or 1.0
    ref = jt.render_dynamic(80, 48, linear=True, exact=True)
    ours = tt.render_dynamic(80, 48, linear=True)
    assert ours.shape == (48, 80, 4)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)


def test_upsample_matches_jax_resize():
    # the upsample alone against jax.image.resize(..., "linear"): within 1e-5
    img = np.random.default_rng(2).uniform(0, 1, (32, 40, 4)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(img), (48, 80, 4), "linear"))
    np.testing.assert_allclose(ttestbed.upsample_bilinear(torch.from_numpy(img), 80, 48).numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("train", [False, True])
def test_frame_renders(train, monkeypatch):
    # shape and finiteness only: the JAX frame renders through its tiled path
    monkeypatch.setattr(ttestbed, "DEFAULT_BATCH_SIZE", 1 << 13)
    _, tt = _testbeds(2)
    tt.frame_resolution = (40, 32)
    tt.dynamic_res = False
    if train:
        ds = _dataset(n=4)
        ds.images[..., 3] = 1.0
        tt.set_training_data(ds)
        tt.set_train(True)
    assert tt.frame()
    assert tt.frame_buffer.shape == (32, 40, 4) and np.isfinite(tt.frame_buffer).all()
    assert tt.stats.step == (16 if train else 0) and tt.stats.frame_ms > 0


def test_default_device_is_cuda_or_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is cuda:0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttestbed.Testbed()
    assert ttestbed.Testbed(device="cpu").device == torch.device("cpu")


def test_render_buffer_device_is_cuda_or_raises():
    # a RenderBuffer without a device never accumulates on the host silently
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is cuda:0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbuffer.RenderBuffer((7, 6))
    buf = tbuffer.RenderBuffer((7, 6), device="cpu")
    buf.clear()
    assert buf.device == torch.device("cpu") and buf.accumulate_rgba.device == torch.device("cpu")
