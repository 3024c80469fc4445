"""The port's envmap (``nerfshop_tpu_torch/ops/envmap.py``) against
``nerfshop_tpu/ops/envmap.py``: UV at the poles and the equator, the
bilinear lookup with its φ wrap and θ clamp, the gradient with respect to
the map; the pure-background training case of ``tests/test_envmap.py`` on
the port; and an 8 × 6 render of an empty scene with the envmap against
JAX's renderer.

Tolerances: UV and samples within 1e-6 (float32, the same formulas), the
map's gradient within 1e-5 (the same four weights a ray, summed in
another order), the frame within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfshop_tpu.ops import envmap as jenvmap
from nerfshop_tpu_torch.ops import envmap as tenvmap


@pytest.fixture(autouse=True)
def one_thread():
    """Each test on one intra-op thread: the suite runs several worker
    processes on a few cores, where torch's thread pool spends its time
    waiting at barriers on the many small ops of a training step."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dirs(n=512, seed=0):
    """Unit directions: random ones, the poles, the equator's axes, and
    directions just either side of the φ seam (atan2's branch cut at −x)."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d[:8] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
             [-1, 1e-4, 0.2], [-1, -1e-4, -0.2]]
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def test_latlong_uv_matches_jax():
    d = _dirs()
    uv = tenvmap.direction_to_latlong_uv(torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(uv, np.asarray(jenvmap.direction_to_latlong_uv(jnp.asarray(d))), rtol=0, atol=1e-6)
    assert abs(uv[0, 1]) < 1e-6 and abs(uv[1, 1] - 1.0) < 1e-6  # +z the top row, −z the bottom
    assert abs(uv[2, 1] - 0.5) < 1e-6 and abs(uv[2, 0] - 0.5) < 1e-6  # +x on the equator, the centre column


def test_sample_and_gradient_match_jax():
    rng = np.random.default_rng(1)
    em = rng.uniform(0, 1, (8, 16, 4)).astype(np.float32)
    d = _dirs(seed=2)
    w = rng.normal(size=(d.shape[0], 4)).astype(np.float32)
    ref_v = np.asarray(jenvmap.sample_envmap(jnp.asarray(em), jnp.asarray(d)))
    ref_g = np.asarray(jax.grad(lambda m: jnp.sum(jenvmap.sample_envmap(m, jnp.asarray(d)) * w))(jnp.asarray(em)))
    tm = torch.from_numpy(em).requires_grad_(True)
    out = tenvmap.sample_envmap(tm, torch.from_numpy(d))
    np.testing.assert_allclose(out.detach().numpy(), ref_v, rtol=0, atol=1e-6)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tm.grad.numpy(), ref_g, rtol=0, atol=1e-5)
    # the seam: just left of u = 0 blends column 0 with column W − 1 (wrap);
    # at a pole the row index clamps and its weight stays: +z (fv = −0.5)
    # reads rows 0 and 1 half each, as JAX does
    em2 = np.zeros((4, 8, 4), np.float32)
    em2[2, 0] = em2[2, 7] = 1.0
    seam = np.asarray([[np.cos(np.pi - 0.01), np.sin(np.pi - 0.01), 0.0]], np.float32)
    assert float(tenvmap.sample_envmap(torch.from_numpy(em2), torch.from_numpy(seam))[0, 0]) > 0.3
    em3 = np.zeros((4, 8, 4), np.float32)
    em3[0], em3[1] = 2.0, 4.0
    top = tenvmap.sample_envmap(torch.from_numpy(em3), torch.tensor([[0.0, 0.0, 1.0]]))
    np.testing.assert_allclose(top.numpy(), 3.0, rtol=0, atol=1e-6)


def test_create_envmap():
    em = tenvmap.create_envmap((6, 12), 0.25)
    ref = np.asarray(jenvmap.create_envmap((6, 12), 0.25))
    np.testing.assert_array_equal(em.numpy(), ref)


def _tiny_model(seed=0):
    """The two-level model of ``tests/test_envmap.py`` in both packages,
    the port's weights carried from JAX."""
    from nerfshop_tpu.models import encodings as jenc, mlp as jmlp, nerf_network as jnn
    from nerfshop_tpu_torch import weights
    from nerfshop_tpu_torch.models import encodings as tenc, mlp as tmlp, nerf_network as tnn

    grid = dict(n_input_dims=3, n_levels=2, n_features_per_level=2, log2_hashmap_size=10, base_resolution=8,
                per_level_scale=1.5)
    jm = jnn.NerfNetwork(
        pos_encoding=jenc.GridEncoding(**grid), dir_encoding=jenc.SphericalHarmonicsEncoding(degree=2),
        density_mlp=jmlp.MLP(n_input_dims=4, n_output_dims=16, n_neurons=16, n_hidden_layers=1),
        rgb_mlp=jmlp.MLP(n_input_dims=20, n_output_dims=3, n_neurons=16, n_hidden_layers=1),
    )
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = tnn.NerfNetwork(
        pos_encoding=tenc.GridEncoding(**grid), dir_encoding=tenc.SphericalHarmonicsEncoding(degree=2),
        density_mlp=tmlp.MLP(4, 16, n_neurons=16, n_hidden_layers=1),
        rgb_mlp=tmlp.MLP(20, 3, n_neurons=16, n_hidden_layers=1),
    )
    tm.load_state_dict(weights.params_from_jax(jax.tree.map(np.asarray, jp)))
    return jm, jp, tm


def test_envmap_background_trains():
    """``tests/test_envmap.py``'s case on the port: an empty scene whose
    every target pixel is opaque green; the rays leave the scene, so the
    prediction is the envmap and the envmap must learn green (40 steps of
    512 rays, Adam at 5e-2, L2, no random background; JAX's test takes 60)."""
    from nerfshop_tpu_torch.ops import grid as tgrid
    from nerfshop_tpu_torch.train import nerf as tnerf, optim as toptim

    _, _, tm = _tiny_model()
    cfg = tnerf.NerfTrainConfig(n_rays_per_batch=512, k_samples=8, aabb_scale=1, n_cascades=1,
                                train_envmap=True, random_bg=False, loss_type="L2")
    state = toptim.TrainState(tm, toptim.build_optimizer({"otype": "Adam", "learning_rate": 5e-2}),
                              {"envmap": tenvmap.create_envmap((8, 16))})
    grid = tgrid.OccupancyGrid.create(1, device="cpu")
    grid.occupancy.zero_()
    imgs = np.zeros((2, 16, 16, 4), np.float32)
    imgs[..., 1] = 0.8
    imgs[..., 3] = 1.0
    data = tnerf.DeviceDataset(
        images=torch.from_numpy(imgs),
        xforms=torch.from_numpy(np.tile(np.eye(4, dtype=np.float32)[:3][None], (2, 1, 1))),
        focals=torch.full((2, 2), 16.0), principals=torch.full((2, 2), 0.5), distortions=torch.zeros((2, 4)),
    )
    loop = tnerf.make_train_loop(state, grid, data, cfg, 40)
    ys = loop(grid, torch.Generator().manual_seed(1))
    em = state.extra["envmap"].detach().numpy()
    assert (em[..., 1] > 0.4).any(), em[..., 1].max()
    assert float(ys["loss"][-1]) < 0.05
    assert float(ys["measured_samples"].sum()) == 0  # every ray left the empty scene


def test_render_empty_scene_with_envmap_matches_jax():
    from nerfshop_tpu.ops import grid as jgrid
    from nerfshop_tpu.render import renderer as jrenderer
    from nerfshop_tpu_torch.ops import grid as tgrid
    from nerfshop_tpu_torch.render import renderer as trenderer

    jm, jp, tm = _tiny_model(1)
    em = np.random.default_rng(3).uniform(0, 1, (8, 16, 4)).astype(np.float32)
    xf = np.asarray([[1.0, 0, 0, 0.5], [0, 1.0, 0, 0.5], [0, 0, 1.0, -0.6]], np.float32)
    jg = jgrid.OccupancyGrid.create(1)
    jg = jg._replace(occupancy=jnp.zeros_like(jg.occupancy))
    kw = dict(k_samples=8, n_candidates=64, n_windows=1, chunk=16)
    ref = jrenderer.render_frame(jm, jp, jg, (8, 6), jnp.asarray(xf), jnp.asarray([8.0, 8.0]),
                                 opts=jrenderer.RenderOptions(**kw), envmap=jnp.asarray(em))
    tg = tgrid.OccupancyGrid.create(1, device="cpu")
    tg.occupancy.zero_()
    out = trenderer.render_frame(tm, None, tg, (8, 6), torch.from_numpy(xf), torch.tensor([8.0, 8.0]),
                                 opts=trenderer.RenderOptions(**kw), envmap=torch.from_numpy(em))
    assert out.rgba.shape == (6, 8, 4)
    np.testing.assert_allclose(out.rgba.numpy(), np.asarray(ref.rgba), rtol=0, atol=1e-5)
    assert float(out.rgba[..., 3].min()) > 0.99 and float(out.rgba[..., :3].std()) > 0.01
