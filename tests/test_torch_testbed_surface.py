"""The rest of the port's ``Testbed`` surface (``nerfshop_tpu_torch/testbed.py``)
against ``nerfshop_tpu/testbed.py``'s methods on the same data and weights:
the training views' extrinsics with optimized deltas in both conventions,
``n_params`` and ``level_stats`` (the weights carried by
``nerfshop_tpu_torch/weights.py``), ``training_step``, the network reloads
and the profiler trace, all on the CPU.

Tolerances: poses within 1e-6 (float32; the same formulas, the exp map's
products in another order); ``level_stats``' magnitudes within 1e-6
relative (float32 means over the same entries in another order); counts,
shapes and sizes exactly."""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfshop_tpu.testbed import Testbed as JTestbed
from nerfshop_tpu_torch import testbed as ttestbed, weights
from test_torch_camera_opt import _camera_leaves
from test_torch_train_step import sphere_dataset
from torch_one_thread import one_thread  # noqa: F401

CFG = {
    "loss": {"otype": "Huber"},
    "optimizer": {"otype": "Adam", "learning_rate": 1e-2},
    "encoding": {"otype": "HashGrid", "n_levels": 4, "n_features_per_level": 2,
                 "log2_hashmap_size": 12, "base_resolution": 8, "per_level_scale": 1.5},
    "network": {"n_neurons": 16, "n_hidden_layers": 1},
    "dir_encoding": {"otype": "SphericalHarmonics", "degree": 4},
    "rgb_network": {"n_neurons": 16, "n_hidden_layers": 1},
}
#: a config of other shapes, for the reloads
CFG2 = dict(CFG, encoding={**CFG["encoding"], "n_levels": 3, "log2_hashmap_size": 10},
            network={"n_neurons": 32, "n_hidden_layers": 2})


def _testbeds(extrinsics=True):
    """A JAX and a port testbed on copies of one sphere dataset, with camera
    leaves (optimize_extrinsics) where asked, the port's network and camera
    leaves carried from JAX's, the camera deltas nonzero."""
    ds = sphere_dataset(3, 16)
    jt = JTestbed(config=CFG)
    tt = ttestbed.Testbed(config=CFG, device="cpu", seed=0)
    jt.nerf.training.optimize_extrinsics = tt.nerf.training.optimize_extrinsics = extrinsics
    jt._dataset = copy.deepcopy(ds)
    jt._reset_network()
    tt.set_training_data(copy.deepcopy(ds))
    tree = jax.tree.map(np.array, jt._state.params)
    if extrinsics:
        tree["camera"] = {k: v for k, v in _camera_leaves(3).items() if k != "distortion_map"}
        jt._state = jt._state._replace(params=jax.tree.map(jnp.asarray, tree))
    flat = weights.params_from_jax(tree)
    with torch.no_grad():
        for name, p in list(tt.model.named_parameters()) + list(tt._state.extra.items()):
            p.copy_(flat[name])
    return jt, tt


def _perturbed(mat, seed=4):
    rng = np.random.default_rng(seed)
    m = np.array(mat, np.float32)
    m[:3, 3] += rng.normal(size=3).astype(np.float32) * 0.1
    return m


@pytest.mark.parametrize("convention", ["nerf", "ngp"])
def test_camera_extrinsics_match_jax(convention):
    jt, tt = _testbeds()
    for i in range(3):
        ref = jt.get_camera_extrinsics(i, convention)
        np.testing.assert_allclose(tt.get_camera_extrinsics(i, convention), ref, rtol=0, atol=1e-6)
    # the deltas count: without them the pose differs
    raw = tt._dataset.xforms[1] if convention == "ngp" else None
    if raw is not None:
        assert np.abs(tt.get_camera_extrinsics(1, "ngp") - raw).max() > 1e-3
    # set → both hosts, the device data written in place, and get again
    dev_xforms = tt._device_data.xforms
    new = _perturbed(jt.get_camera_extrinsics(1, convention))
    jt.set_camera_extrinsics(1, new, convention)
    tt.set_camera_extrinsics(1, new, convention)
    np.testing.assert_allclose(tt._dataset.xforms, jt._dataset.xforms, rtol=0, atol=1e-6)
    assert tt._device_data.xforms is dev_xforms
    np.testing.assert_allclose(dev_xforms.numpy(), np.asarray(jt._device_data.xforms), rtol=0, atol=1e-6)
    for i in range(3):
        np.testing.assert_allclose(tt.get_camera_extrinsics(i, convention), jt.get_camera_extrinsics(i, convention),
                                   rtol=0, atol=1e-6)


def test_camera_extrinsics_round_trip_without_deltas():
    # with no camera leaves get returns what set stored: the ngp pose
    # exactly, the nerf pose within float32 rounding of the scale and offset
    _, tt = _testbeds(extrinsics=False)
    assert "camera.rot" not in tt._state.extra
    m = _perturbed(tt.get_camera_extrinsics(2, "ngp"))
    tt.set_camera_extrinsics(2, m, "ngp")
    np.testing.assert_array_equal(tt.get_camera_extrinsics(2, "ngp"), m)
    n = _perturbed(tt.get_camera_extrinsics(0, "nerf"), seed=5)
    tt.set_camera_extrinsics(0, n, "nerf")
    np.testing.assert_allclose(tt.get_camera_extrinsics(0, "nerf"), n, rtol=0, atol=1e-6)
    with pytest.raises(RuntimeError, match="no training data"):
        ttestbed.Testbed(config=CFG, device="cpu").get_camera_extrinsics(0)


def test_n_params_and_level_stats_match_jax():
    jt, tt = _testbeds()
    assert tt.n_params() == jt.n_params()
    ref, got = jt.level_stats(), tt.level_stats()
    assert len(got) == len(ref) == 4
    for r, g in zip(ref, got):
        for key in ("level", "resolution", "size", "hashed"):
            assert g[key] == r[key], key
        for key in ("mean_abs", "max_abs", "frac_nonzero"):
            assert g[key] == pytest.approx(r[key], rel=1e-6, abs=1e-12), key


def test_training_step_and_reloads_match_jax(tmp_path):
    jt, tt = _testbeds()
    assert tt.training_step == jt.training_step == 0
    tt.train(2, batch_size=1 << 13)
    assert tt.training_step == tt.stats.step == 2
    jt.stats.step = 2  # JAX's property reads its stats' step
    assert jt.training_step == 2
    path = tmp_path / "cfg2.json"
    path.write_text(json.dumps(CFG2))
    for reload in (lambda t: t.reload_network_from_file(str(path)), lambda t: t.reload_network_from_json(CFG2)):
        reload(jt)
        reload(tt)
        assert tt.training_step == jt.training_step == 0
        shapes = {k: tuple(v.shape) for k, v in weights.params_from_jax(jax.tree.map(np.asarray, jt._state.params)).items()}
        got = {k: tuple(p.shape) for k, p in list(tt.model.named_parameters()) + list(tt._state.extra.items())}
        assert got == shapes
        assert tt.n_params() == jt.n_params()
    # an empty path rebuilds from the current config
    tt.reload_network_from_file("")
    assert tt.training_step == 0 and tt.model.pos_encoding.n_levels == 3


def test_profiler_writes_a_trace(tmp_path):
    _, tt = _testbeds(extrinsics=False)
    with pytest.raises(RuntimeError, match="start_profiler"):
        tt.stop_profiler()
    tt.start_profiler(str(tmp_path / "trace"))
    with pytest.raises(RuntimeError, match="already running"):
        tt.start_profiler(str(tmp_path / "trace"))
    tt.render(8, 6, spp=1)
    path = tt.stop_profiler()
    assert path.startswith(str(tmp_path / "trace")) and path.endswith(".json")
    events = json.loads(open(path).read())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    assert tt.profiler.key_averages()


def test_bucket_adapts_after_every_chunk():
    # the first chunk marches the untrained grid, every cell occupied: most
    # rays fill K, so the bucket doubles after that chunk, inside the call
    tt = ttestbed.Testbed(config=CFG, device="cpu", seed=0)
    tt.set_training_data(sphere_dataset(4, 16))
    buckets, set_bucket = [], tt._set_bucket
    tt._set_bucket = lambda k: (buckets.append((tt.stats.step, k)), set_bucket(k))
    tt.train(17, batch_size=1 << 13)
    assert buckets[:2] == [(0, 32), (16, 64)]
    assert tt.train_config.k_samples == buckets[-1][1]
    assert tt.train_config.n_rays_per_batch == max(64, (1 << 13) // buckets[-1][1])


@pytest.mark.parametrize("aabb_scale,first", [(1, 32), (4, 256)])
def test_first_bucket_reaches_the_far_side_of_a_full_grid(aabb_scale, first):
    # rays from a camera inside the box of aabb_scale 4 (three cascades,
    # cone-angle steps) over a grid with every cell occupied: K = 32 spreads
    # over the first half of the 1024-candidate ladder only, the first
    # bucket's K over all of it, out to the box's far side
    from nerfshop_tpu_torch.ops import coords as tcoords, march as tmarch

    ds = sphere_dataset(3, 16)
    ds.aabb_scale = aabb_scale
    tt = ttestbed.Testbed(config=CFG, device="cpu", seed=0)
    tt.set_training_data(ds)
    assert tt._first_bucket() == first
    if aabb_scale == 1:
        return
    aabb = tcoords.BoundingBox.from_aabb_scale(4)
    occ = torch.ones((3, 128, 128, 128), dtype=torch.bool)
    rng = np.random.default_rng(0)
    eye = np.array([1.5, 0.5, 0.6], np.float32)
    d = np.array([-1.0, 0.0, 0.0], np.float32) + rng.normal(size=(64, 3)).astype(np.float32) * 0.1
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = torch.from_numpy(np.broadcast_to(eye, d.shape).copy())
    reach = {}
    for k in (32, first):
        s = tmarch.march_rays_training(o, torch.from_numpy(d), occ, aabb.min, aabb.max, 1.0 / 256, None, None,
                                       t_start_min=0.05, k_samples=k)
        reach[k] = float(torch.where(s.valid, s.t + s.dt, torch.zeros_like(s.t)).max(1).values.min())
    assert reach[32] < 1.5 < 2.5 < reach[first], reach


@pytest.mark.parametrize("aabb_scale", [1, 4])
def test_render_budget_past_one_cascade(aabb_scale):
    ds = sphere_dataset(3, 16)
    ds.aabb_scale = aabb_scale
    tt = ttestbed.Testbed(config=CFG, device="cpu", seed=0)
    tt.set_training_data(ds)
    tt.grid.occupancy.zero_()
    tt.grid.occupancy[:, 60:68, 60:68, 60:68] = True  # sparse
    opts = tt._render_options()
    assert (opts.k_samples, opts.n_windows, opts.use_grid_early_stop) == ((64, 2, True) if aabb_scale == 1 else (256, 2, False))
