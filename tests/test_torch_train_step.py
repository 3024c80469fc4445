"""One training step of the port against ``nerfshop_tpu/train/nerf.py`` on
the same weights and draws, the optimizer against optax, and the port's
Testbed end to end on the CPU."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfshop_tpu.config import default_nerf_config
from nerfshop_tpu.data.nerf_loader import CameraIntrinsics, NerfDataset
from nerfshop_tpu.models import nerf_network as jnn
from nerfshop_tpu.ops import coords as jcoords, grid as jgrid, march as jmarch, rays as jrays
from nerfshop_tpu.train import losses as jlosses, nerf as jnerf, optim as joptim
from nerfshop_tpu_torch import weights
from nerfshop_tpu_torch.models import nerf_network as tnn
from nerfshop_tpu_torch.ops import grid as tgrid, rays as trays
from nerfshop_tpu_torch import testbed as ttestbed
from nerfshop_tpu_torch.train import nerf as tnerf, optim as toptim

TINY = {
    "loss": {"otype": "Huber"},
    "optimizer": {"otype": "Adam", "learning_rate": 1e-2},
    "encoding": {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
                 "log2_hashmap_size": 12, "base_resolution": 8, "per_level_scale": 1.5},
    "network": {"n_neurons": 16, "n_hidden_layers": 1},
    "dir_encoding": {"otype": "SphericalHarmonics", "degree": 4},
    "rgb_network": {"n_neurons": 16, "n_hidden_layers": 1},
}
CENTER = np.array([0.5, 0.5, 0.5], np.float32)


def look_at(eye, target=CENTER, up=(0.0, 0.0, 1.0)):
    eye = np.asarray(eye, np.float32)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float32))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    return np.concatenate([np.stack([right, down, fwd], 1), eye[:, None]], 1).astype(np.float32)


def sphere_rgba(o, d, radius=0.22):
    oc = o - CENTER
    b = np.sum(oc * d, -1)
    c = np.sum(oc * oc, -1) - radius**2
    disc = b * b - c
    t = -b - np.sqrt(np.maximum(disc, 0))
    hit = (disc > 0) & (t > 0)
    p = o + t[:, None] * d
    rgba = np.zeros((o.shape[0], 4), np.float32)
    rgba[hit, :3] = np.clip((p - CENTER) / (2 * radius) + 0.5, 0, 1)[hit]
    rgba[hit, 3] = 1.0
    return rgba


def sphere_dataset(n_views, res, seed=0):
    """The analytic opaque-sphere scene of tests/test_nerf_train_e2e.py as a NerfDataset."""
    rng = np.random.default_rng(seed)
    focal = np.array([res * 1.1, res * 1.1], np.float32)
    principal = np.array([0.5, 0.5], np.float32)
    images, xforms = [], []
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views
        eye = CENTER + np.array([np.cos(ang), np.sin(ang), rng.uniform(-0.3, 0.8)], np.float32) * 1.3
        xf = look_at(eye)
        b = trays.rays_for_image((res, res), torch.from_numpy(xf), torch.from_numpy(focal), torch.from_numpy(principal))
        images.append(sphere_rgba(b.origins.numpy(), b.directions.numpy()).reshape(res, res, 4))
        xforms.append(xf)
    intr = [CameraIntrinsics(focal, principal, np.zeros(4, np.float32), np.array([res, res], np.int32)) for _ in range(n_views)]
    return NerfDataset(images=np.stack(images), xforms=np.stack(xforms), intrinsics=intr, paths=[""] * n_views, aabb_scale=1)


def _models(cfg, seed=0):
    jm = jnn.build_nerf_network(cfg, aabb_scale=1)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = tnn.build_nerf_network(cfg, aabb_scale=1)
    tm.load_state_dict(weights.params_from_jax(jax.tree.map(np.asarray, jp)))
    return jm, jp, tm


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / max(np.linalg.norm(np.asarray(b)), 1e-30))


@pytest.mark.parametrize("mean_density,random_occ", [(0.0, True), (50.0, False)])
def test_grads_from_draws_match_jax(mean_density, random_occ):
    # loss within 1e-4 relative; every grad within 2e-3 (relative L2 norm):
    # both sides round MLP operands and cotangents to bf16 at the same
    # points, but an fp32 value that sits on a bf16 rounding boundary can
    # round the other way under another summation order
    ds = sphere_dataset(3, 16)
    jm, jp, tm = _models(TINY)
    R, K = 64, 16
    cfg = tnerf.NerfTrainConfig(n_rays_per_batch=R, k_samples=K, n_candidates=256, near_distance=0.05)
    rng = np.random.default_rng(1)
    img_idx = rng.integers(0, 3, R).astype(np.int32)
    pix = np.floor(rng.uniform(0, 1, (R, 2)) * 16).astype(np.float32)
    t_jitter = rng.uniform(0, 1, R).astype(np.float32)
    spread = rng.uniform(0, 1, (R, K)).astype(np.float32)
    bg = rng.uniform(0, 1, (R, 3)).astype(np.float32)
    occ = np.ones((1, 128, 128, 128), bool)
    if random_occ:
        ijk = (np.indices((128,) * 3).transpose(1, 2, 3, 0) + 0.5) / 128
        occ[0] = np.linalg.norm(ijk - 0.5, axis=-1) < 0.3 + rng.uniform(-0.05, 0.05, (128,) * 3)

    # JAX side: rays_from_pixels → march_rays(spread) → nerf_loss_fn
    dev = jnerf.DeviceDataset.from_dataset(ds)
    res = jnp.asarray([16.0, 16.0])
    bundle = jrays.rays_from_pixels(jnp.asarray(img_idx), jnp.asarray(pix), dev.xforms, dev.focals, dev.principals, res, dev.distortions)
    aabb = jcoords.BoundingBox.from_aabb_scale(1)
    samples = jmarch.march_rays(
        bundle.origins, bundle.directions, jnp.asarray(occ), aabb.min, aabb.max, jnp.asarray(0.0),
        t_jitter=jnp.asarray(t_jitter), t_start_min=0.05, k_samples=K, n_candidates=256,
        selection="spread", spread_rng=jnp.asarray(spread),
    )
    targets = dev.images[img_idx, pix[:, 1].astype(int), pix[:, 0].astype(int)]
    (jl, jaux), jg = jax.value_and_grad(jnerf.nerf_loss_fn, has_aux=True)(
        jp, jm, samples, bundle.origins, bundle.directions, targets, jnp.asarray(bg), aabb,
        jlosses.huber, cfg.min_transmittance, near_distance=0.05,
        mean_grid_density=jnp.asarray(mean_density, jnp.float32),
    )
    assert int(jaux["measured_samples"]) > R

    tdata = tnerf.DeviceDataset.from_dataset(ds, "cpu")
    grid = tgrid.OccupancyGrid(torch.zeros(1, 128, 128, 128), torch.from_numpy(occ), torch.tensor(mean_density))
    grads, aux = tnerf.grads_from_draws(
        tm, grid, tdata, cfg, torch.from_numpy(img_idx), torch.from_numpy(pix),
        torch.from_numpy(t_jitter), torch.from_numpy(spread), torch.from_numpy(bg),
    )
    assert int(aux["measured_samples"]) == int(jaux["measured_samples"])
    np.testing.assert_allclose(float(aux["loss"]), float(jl), rtol=1e-4)
    jflat = weights.params_from_jax(jax.tree.map(np.asarray, jg))
    assert set(jflat) == set(grads)
    for name, g in grads.items():
        assert float(g.abs().max()) > 0, name
        assert _rel(g.numpy(), jflat[name].numpy()) < 2e-3, name


def test_adam_ema_matches_optax():
    # two Adam + EMA updates (coupled L2, eps 1e-15, EMA 0.95): within 1e-5
    cfg = default_nerf_config()
    rng = np.random.default_rng(2)
    _, jp, tm = _models(TINY, seed=3)
    spec = joptim.build_optimizer(dict(cfg["optimizer"]))
    jstate = joptim.create_train_state(jp, spec)
    tstate = toptim.TrainState(tm, toptim.build_optimizer(dict(cfg["optimizer"])))
    for _ in range(2):
        gtree = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32) * 1e-2), jstate.params)
        jstate = joptim.apply_gradients(jstate, gtree, spec)
        tstate.apply_gradients(weights.params_from_jax(jax.tree.map(np.asarray, gtree)))
    jparams = weights.params_from_jax(jax.tree.map(np.asarray, jstate.params))
    jema = weights.params_from_jax(jax.tree.map(np.asarray, jstate.ema_params))
    assert tstate.step == 2
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jparams[name].numpy(), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(tstate.ema[name].numpy(), jema[name].numpy(), rtol=1e-5, atol=1e-7)


def test_schedule_matches():
    cfg = dict(default_nerf_config()["optimizer"])
    adam, sched, _ = joptim._unwrap(cfg)
    jf = joptim.make_schedule(adam, sched)
    tf = toptim.build_optimizer(cfg).schedule
    for step in (0, 19999, 20000, 29999, 30000, 55000):
        np.testing.assert_allclose(tf(step), float(jf(step)), rtol=1e-6)


def test_network_forward_matches():
    # full default widths (L=16, 2^19 table is too big here: 2^14), bf16 numerics: 2e-3
    cfg = default_nerf_config()
    cfg["encoding"]["log2_hashmap_size"] = 14
    jm, jp, tm = _models(cfg, seed=5)
    x = np.random.default_rng(6).uniform(0, 1, (256, 3)).astype(np.float32)
    d = np.random.default_rng(7).uniform(0, 1, (256, 3)).astype(np.float32)
    jrgb, jsig = jm(jp, jnp.asarray(x), jnp.asarray(d))
    with torch.no_grad():
        trgb, tsig = tm(torch.from_numpy(x), torch.from_numpy(d))
    assert _rel(trgb.numpy(), jrgb) < 2e-3 and _rel(tsig.numpy(), jsig) < 2e-3


def _write_tiny_scene(tmp_path, n=3, res=12):
    from PIL import Image

    rng = np.random.default_rng(0)
    (tmp_path / "images").mkdir()
    frames = []
    for i in range(n):
        img = (rng.uniform(0, 1, (res, res, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(tmp_path / "images" / f"{i}.png")
        xf = np.eye(4)
        xf[:3, 3] = [0, 0, 1.2]
        frames.append({"file_path": f"images/{i}.png", "transform_matrix": xf.tolist()})
    (tmp_path / "transforms.json").write_text(json.dumps({"camera_angle_x": 0.9, "aabb_scale": 1, "frames": frames}))
    return tmp_path / "transforms.json"


def test_testbed_trains_from_disk(tmp_path):
    tb = ttestbed.Testbed("nerf", config=TINY, device="cpu", seed=0)
    tb.load_training_data(str(_write_tiny_scene(tmp_path)))
    loss = tb.train(n_steps=2, batch_size=1024)
    assert np.isfinite(loss)
    assert tb.stats.step == 2
    assert tb.stats.measured_samples_total > 0
    assert len(tb.loss_history) == 2


def test_testbed_loss_falls_on_sphere():
    # statistical: the mean of the last 10 losses of 60 steps is well below the first
    tb = ttestbed.Testbed("nerf", config=TINY, device="cpu", seed=1)
    tb.set_training_data(sphere_dataset(8, 24))
    tb.train(n_steps=60, batch_size=1 << 13)
    losses = [lv for _, lv in tb.loss_history]
    assert len(losses) == 60 and np.isfinite(losses).all()
    assert np.mean(losses[-10:]) < 0.6 * losses[0], (losses[0], np.mean(losses[-10:]))
    assert tb.grid.occupancy.float().mean() < 1.0  # the grid refresh ran
