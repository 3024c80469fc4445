"""A captured scene's options in the port (``ops/rays.py``,
``train/nerf.py``, ``models/nerf_network.py``, ``render/renderer.py``)
against ``nerfshop_tpu``: the rolling-shutter pose lerp and shutter times,
the rays with end-of-exposure poses, one training step's gradients with
rolling shutter, motion blur and light dirs against JAX's ``make_grad_fn``
on the draws it makes from its key (at a plain SH dir encoding and at the
shipped default's ``Composite``: SH on 3 dims and Identity on the 3 light
dims), the exact frame with extra dims, F17 on JAX, and
``n_extra_learnable_dims``.

Tolerances: rays, lerps and shutter times within 1e-6 (float32, the same
formulas; the port applies the pose deltas per image before the lerp, which
is linear in the matrix); the step's loss within 1e-4 relative and every
gradient within 2e-3 relative L2 norm, the bound of
``tests/test_torch_train_step.py`` (both sides round the MLPs' operands to
bf16 at the same points); frames within 1e-4, as
``tests/test_torch_render.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfshop_tpu.models import nerf_network as jnn
from nerfshop_tpu.ops import grid as jgrid, rays as jrays
from nerfshop_tpu.render import renderer as jrender
from nerfshop_tpu.train import nerf as jnerf
from nerfshop_tpu_torch import testbed as ttestbed, weights
from nerfshop_tpu_torch.models import nerf_network as tnn
from nerfshop_tpu_torch.ops import grid as tgrid, rays as trays
from nerfshop_tpu_torch.render import renderer as trender
from nerfshop_tpu_torch.train import nerf as tnerf
from test_torch_camera_opt import _camera_leaves
from test_torch_render import look_at, seeded_density
from test_torch_train_loop import _ball_grid
from test_torch_train_step import TINY, _rel, sphere_dataset
from torch_one_thread import one_thread  # noqa: F401

R, K = 64, 16
SHUTTER = np.asarray([0.1, 0.3, 0.4, 0.2], np.float32)
COMPOSITE = dict(TINY, dir_encoding={"otype": "Composite", "nested": [
    {"otype": "SphericalHarmonics", "degree": 4, "n_dims_to_encode": 3},
    {"otype": "Identity", "n_dims_to_encode": 3},
]})
DIR_CONFIGS = {"sh": TINY, "composite": COMPOSITE}


def captured_dataset(n=3, res=16, seed=9):
    """The sphere scene with end-of-exposure poses moved by a small
    translation and a rotation, a rolling shutter with row, column and
    motion-blur terms, and a unit light dir a view."""
    ds = sphere_dataset(n, res)
    rng = np.random.default_rng(seed)
    end = torch.from_numpy(ds.xforms)
    end = trays.apply_pose_delta(end, torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32) * 0.03),
                                 torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32) * 0.02))
    ds.xforms_end = end.numpy()
    ds.rolling_shutter = SHUTTER.copy()
    ld = rng.normal(size=(n, 3)).astype(np.float32)
    ds.light_dirs = ld / np.linalg.norm(ld, axis=1, keepdims=True)
    ds.has_light_dirs = True
    return ds


def test_pose_lerp_and_shutter_times_match_jax():
    rng = np.random.default_rng(0)
    a, b = (rng.normal(size=(R, 3, 4)).astype(np.float32) for _ in range(2))
    t = rng.uniform(0, 1, R).astype(np.float32)
    np.testing.assert_allclose(trays.pose_lerp(*map(torch.from_numpy, (a, b, t))).numpy(),
                               np.asarray(jrays.pose_lerp(*map(jnp.asarray, (a, b, t)))), rtol=0, atol=1e-6)
    key = jax.random.PRNGKey(3)
    pix = np.floor(rng.uniform(0, 1, (R, 2)) * [24, 16]).astype(np.float32)
    res = np.asarray([24.0, 16.0], np.float32)
    ref = jrays.shutter_times(key, jnp.asarray(pix), jnp.asarray(res), jnp.asarray(SHUTTER))
    xi = torch.from_numpy(np.array(jax.random.uniform(key, (R,))))  # the draw shutter_times makes
    got = trays.shutter_times(xi, torch.from_numpy(pix), torch.from_numpy(res), torch.from_numpy(SHUTTER))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


@pytest.mark.parametrize("with_camera", [False, True], ids=["plain", "camera-leaves"])
def test_rays_from_pixels_with_shutter_match_jax(with_camera):
    ds = captured_dataset()
    jd = jnerf.DeviceDataset.from_dataset(ds)
    td = tnerf.DeviceDataset.from_dataset(ds, "cpu")
    assert jd.xforms_end is not None and td.xforms_end is not None
    rng = np.random.default_rng(4)
    img_idx = rng.integers(0, 3, R).astype(np.int32)
    pix = np.floor(rng.uniform(0, 1, (R, 2)) * 16).astype(np.float32)
    res = np.asarray([16.0, 16.0], np.float32)
    key = jax.random.PRNGKey(5)
    cam = _camera_leaves(3) if with_camera else None
    jb = jrays.rays_from_pixels(jnp.asarray(img_idx), jnp.asarray(pix), jd.xforms, jd.focals, jd.principals,
                                jnp.asarray(res), jd.distortions, None if cam is None else
                                {k: jnp.asarray(v) for k, v in cam.items()},
                                xforms_end=jd.xforms_end, rolling_shutter=jd.rolling_shutter, rng=key)
    xi = torch.from_numpy(np.array(jax.random.uniform(key, (R,))))
    tb = trays.rays_from_pixels(torch.from_numpy(img_idx), torch.from_numpy(pix), td.xforms, td.focals,
                                td.principals, torch.from_numpy(res), td.distortions,
                                None if cam is None else {k: torch.from_numpy(v) for k, v in cam.items()},
                                td.xforms_end, td.rolling_shutter, xi)
    np.testing.assert_allclose(tb.origins.numpy(), np.asarray(jb.origins), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tb.directions.numpy(), np.asarray(jb.directions), rtol=0, atol=1e-6)
    still = trays.rays_from_pixels(torch.from_numpy(img_idx), torch.from_numpy(pix), td.xforms, td.focals,
                                   td.principals, torch.from_numpy(res), td.distortions)
    assert float((tb.origins - still.origins).abs().max()) > 1e-3  # the shutter moved the rays
    with pytest.raises(ValueError, match="shutter_xi"):
        trays.rays_from_pixels(torch.from_numpy(img_idx), torch.from_numpy(pix), td.xforms, td.focals,
                               td.principals, torch.from_numpy(res), td.distortions, None, td.xforms_end,
                               td.rolling_shutter)


def _models(cfg, n_extra, seed=0):
    jm = jnn.build_nerf_network(cfg, aabb_scale=1, n_extra_dims=n_extra)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = tnn.build_nerf_network(cfg, aabb_scale=1, n_extra_dims=n_extra)
    tm.load_state_dict(weights.params_from_jax(jax.tree.map(np.asarray, jp)))
    return jm, jp, tm


@pytest.mark.parametrize("dirs,aabb_scale", [("sh", 1), ("composite", 1), ("composite", 4)],
                         ids=["sh", "composite", "composite-aabb4"])
def test_step_gradients_with_shutter_and_light_dirs_match_make_grad_fn(dirs, aabb_scale):
    # aabb_scale 4: three cascades (a seeded occupancy of 30% in each), cone
    # steps of 1/256 and the cameras inside the scene box, as in a capture
    ds = captured_dataset()
    ds.aabb_scale = aabb_scale
    jm, jp, tm = _models(DIR_CONFIGS[dirs], 3)
    assert tm.n_extra_dims == 3 and tm.rgb_mlp.weights[0].shape[0] == (35 if dirs == "composite" else 32)
    jcfg = jnerf.NerfTrainConfig.for_aabb_scale(aabb_scale, n_rays_per_batch=R, k_samples=K, n_candidates=256,
                                                near_distance=0.05)
    occ = _ball_grid()[1] if aabb_scale == 1 else np.random.default_rng(3).uniform(0, 1, (3, 128, 128, 128)) < 0.3
    jg = jgrid.OccupancyGrid.create(jcfg.n_cascades)._replace(occupancy=jnp.asarray(occ),
                                                               mean_density=jnp.asarray(0.0))
    key = jax.random.PRNGKey(7)
    jgrads, jaux = jax.jit(jnerf.make_grad_fn(jm, jcfg))(jp, jg, jnerf.DeviceDataset.from_dataset(ds), key)
    # the draws make_grad_fn makes from its key (train/nerf.py, rays.py, march.py)
    k_rays, k_march, k_bg, k_shutter = jax.random.split(key, 4)
    k_img, k_pix, _ = jax.random.split(k_rays, 3)
    k1, k2 = jax.random.split(k_march)
    draws = (jax.random.randint(k_img, (R,), 0, 3), jnp.clip(jnp.floor(jax.random.uniform(k_pix, (R, 2)) * 16.0), 0, 15),
             jax.random.uniform(k1, (R,)), jax.random.uniform(k2, (R, K)), jax.random.uniform(k_bg, (R, 3)))
    assert np.array_equal(np.asarray(jaux["img_idx"]), np.asarray(draws[0]))
    xi = torch.from_numpy(np.array(jax.random.uniform(k_shutter, (R,))))
    grid = tgrid.OccupancyGrid(torch.zeros(occ.shape), torch.from_numpy(occ), torch.tensor(0.0))
    data = tnerf.DeviceDataset.from_dataset(ds, "cpu")
    assert data.light_dirs is not None and data.rolling_shutter is not None
    cfg = tnerf.NerfTrainConfig(**{k: getattr(jcfg, k) for k in tnerf.NerfTrainConfig.__dataclass_fields__})
    grads, aux = tnerf.grads_from_draws(tm, grid, data, cfg, *(torch.from_numpy(np.array(d)) for d in draws),
                                        shutter_xi=xi)
    assert int(aux["measured_samples"]) == int(jaux["measured_samples"]) > R
    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=1e-4)
    jflat = weights.params_from_jax(jax.tree.map(np.asarray, jgrads))
    assert set(jflat) == set(grads)
    for name, g in grads.items():
        assert float(g.abs().max()) > 0, name
        assert _rel(g.numpy(), jflat[name].numpy()) < 2e-3, (name, _rel(g.numpy(), jflat[name].numpy()))
    # the step without the shutter draw is refused, not silently still
    with pytest.raises(ValueError, match="shutter_xi"):
        tnerf.grads_from_draws(tm, grid, data, cfg, *(torch.from_numpy(np.array(d)) for d in draws))


def test_draws_and_loop_carry_the_shutter_draw():
    # the shutter adds one uniform a ray to each step's draws and to the
    # loop's buffers; the CPU loop runs its steps from them
    ds = captured_dataset()
    data = tnerf.DeviceDataset.from_dataset(ds, "cpu")
    cfg = tnerf.NerfTrainConfig(n_rays_per_batch=R, k_samples=K, n_candidates=256, near_distance=0.05)
    g = torch.Generator().manual_seed(0)
    draws = tnerf.draw_step(cfg, data, g)
    assert len(draws) == 6 and draws[5].shape == (R,)
    assert len(tnerf.draw_step(cfg, tnerf.DeviceDataset.from_dataset(sphere_dataset(3, 16), "cpu"), g)) == 5
    from nerfshop_tpu_torch.train import optim as toptim
    from test_torch_train_loop import _optimizer_cfg

    tm = _models(TINY, 3)[2]
    loop = tnerf.make_train_loop(toptim.TrainState(tm, toptim.build_optimizer(_optimizer_cfg())), _ball_grid()[0],
                                 data, cfg, 2)
    assert len(loop.draws) == 6
    ys = loop(_ball_grid()[0], g)
    assert np.isfinite(ys["loss"].numpy()).all()


@pytest.fixture(scope="module")
def extra_scene():
    """(JAX model, params, grid, port model, grid) with 3 extra dims at the
    Composite dir config, seeded weights and the seeded density of
    ``tests/test_torch_render.py``."""
    cfg = dict(COMPOSITE, encoding={**TINY["encoding"], "n_levels": 3})
    jm = jnn.build_nerf_network(cfg, n_extra_dims=3)
    tree = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    tree["pos_encoding"]["table"] = rng.uniform(-1, 1, tree["pos_encoding"]["table"].shape).astype(np.float32)
    tree["density_mlp"]["weights"][-1][:, 0] *= 3.0
    tree["rgb_mlp"]["weights"][0][-3:] *= 20.0  # the light dims weigh on the colour
    tm = tnn.build_nerf_network(cfg, n_extra_dims=3)
    tm.load_state_dict(weights.params_from_jax(tree))
    dens = seeded_density()
    jg = jgrid.update_bitfield(jgrid.OccupancyGrid.create(1)._replace(density=jnp.asarray(dens)))
    occ = np.asarray(jg.occupancy)
    tg = tgrid.OccupancyGrid(torch.from_numpy(dens), torch.from_numpy(occ.copy()), torch.tensor(float(jg.mean_density)))
    return jm, jax.tree.map(jnp.asarray, tree), jg, tm, tg


def _frames(scene, extra, W=24, H=16):
    jm, jp, jg, tm, tg = scene
    xf = look_at(np.array([0.5, 0.5, 0.5], np.float32) + np.array([1.1, -0.9, 0.4], np.float32))
    base = dict(k_samples=16, n_windows=2, n_candidates=512, chunk=128)
    f = np.asarray([20.0, 20.0], np.float32)
    ref = jrender.render_frame(jm, jp, jg, (W, H), jnp.asarray(xf), jnp.asarray(f),
                               opts=jrender.RenderOptions(**base), extra_dims=jnp.asarray(extra))
    ours = trender.render_frame(tm, None, tg, (W, H), torch.from_numpy(xf), torch.from_numpy(f),
                                opts=trender.RenderOptions(**base), extra_dims=torch.from_numpy(extra))
    return np.asarray(ref.rgba), ours.rgba.numpy()


def test_render_frame_with_extra_dims_matches_jax(extra_scene):
    a = np.asarray([0.9, 0.2, 0.5], np.float32)
    b = np.asarray([0.1, 0.7, 0.3], np.float32)
    ja, ta = _frames(extra_scene, a)
    jb, tb = _frames(extra_scene, b)
    np.testing.assert_allclose(ta, ja, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-4)
    assert np.abs(ta - tb).max() > 1e-2  # the light dims reach the colour


@pytest.mark.xfail(strict=True, reason="F17 (ROADMAP.md Queue 3): at a plain SphericalHarmonics dir encoding, "
                   "JAX's build_encoding builds SH at 3 dims (nerfshop_tpu/models/encodings.py:652-653), so the "
                   "light dir reaches no network input and a different light_dir gives the same frame (the "
                   "shipped default's Composite carries it: test_render_frame_with_extra_dims_matches_jax)")
def test_f17_light_dir_changes_the_frame_on_jax():
    jm = jnn.build_nerf_network(TINY, n_extra_dims=3)
    tree = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(0)))
    tree["pos_encoding"]["table"] = np.random.default_rng(1).uniform(
        -1, 1, tree["pos_encoding"]["table"].shape).astype(np.float32)
    jg = jgrid.update_bitfield(jgrid.OccupancyGrid.create(1)._replace(density=jnp.asarray(seeded_density())))
    xf = jnp.asarray(look_at(np.array([1.6, -0.4, 0.9], np.float32)))
    opts = jrender.RenderOptions(k_samples=16, n_windows=2, n_candidates=512, chunk=128)
    frames = [np.asarray(jrender.render_frame(jm, jax.tree.map(jnp.asarray, tree), jg, (12, 8), xf,
                                              jnp.asarray([12.0, 12.0]), opts=opts,
                                              extra_dims=jnp.asarray(e, jnp.float32)).rgba)
              for e in ([0.9, 0.2, 0.5], [0.1, 0.7, 0.3])]
    assert np.abs(frames[0] - frames[1]).max() > 1e-3


def test_n_extra_learnable_dims_follow_jax_or_name_f17():
    # JAX builds the network with the learnable dims and feeds them nothing:
    # at a plain SH dir encoding it runs (SH reads the direction only) and
    # the port computes the same field; where the dir encoding would read
    # them (the shipped default's Composite) JAX's forward fails on the rgb
    # MLP's width and the port's Testbed refuses the scene, naming F17
    rng = np.random.default_rng(2)
    pos = rng.uniform(0, 1, (32, 3)).astype(np.float32)
    d = rng.uniform(0, 1, (32, 3)).astype(np.float32)
    jm, jp, tm = _models(TINY, 2)
    ref = jax.jit(jm.raw_forward)(jp, jnp.asarray(pos), jnp.asarray(d))
    got = tm.raw_forward(torch.from_numpy(pos), torch.from_numpy(d))
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(ref[0]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[1].detach().numpy(), np.asarray(ref[1]), rtol=0, atol=1e-4)
    ds = sphere_dataset(3, 16)
    ds.n_extra_learnable_dims = 2
    tb = ttestbed.Testbed(config=TINY, device="cpu", seed=0)
    tb.set_training_data(ds)
    assert tb.model.n_extra_dims == 2 and tb.model.dir_encoding.n_output_dims == 16
    composite = dict(COMPOSITE, dir_encoding={"otype": "Composite", "nested": [
        {"otype": "SphericalHarmonics", "degree": 4, "n_dims_to_encode": 3}, {"otype": "Identity"}]})
    jm2 = jnn.build_nerf_network(composite, n_extra_dims=2)
    with pytest.raises(TypeError):
        jax.jit(jm2.raw_forward)(jm2.init(jax.random.PRNGKey(0)), jnp.asarray(pos), jnp.asarray(d))
    with pytest.raises(ValueError, match="F17"):
        tb.reload_network_from_json(composite)
