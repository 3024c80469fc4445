"""The port's SDF testbed (``nerfshop_tpu_torch/train/sdf.py``), its BVH
(``geometry/bvh.py``), losses and Disney BRDF against the JAX package on
the same numpy inputs, weights and draws, on the CPU (where the BVH query
runs kernel G's plain version, the brute force)."""

import copy
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfshop_tpu import Testbed as JTestbed
from nerfshop_tpu.geometry import bvh as jbvh
from nerfshop_tpu.geometry import mesh_io as jmesh_io
from nerfshop_tpu.ops import brdf as jbrdf
from nerfshop_tpu.train import losses as jlosses
from nerfshop_tpu.train import sdf as jsdf
from nerfshop_tpu_torch import run as trun
from nerfshop_tpu_torch import weights
from nerfshop_tpu_torch.geometry import bvh as tbvh
from nerfshop_tpu_torch.geometry import mesh_io as tmesh_io
from nerfshop_tpu_torch.ops import brdf as tbrdf
from nerfshop_tpu_torch.ops import fused_mlp
from nerfshop_tpu_torch.ops import rays as trays
from nerfshop_tpu_torch.testbed import Testbed
from nerfshop_tpu_torch.train import losses as tlosses
from nerfshop_tpu_torch.train import sdf as tsdf

from test_bvh import cube_mesh, icosphere
from torch_one_thread import one_thread  # noqa: F401

CPU = torch.device("cpu")
#: configs/sdf/base.json cut to 5 levels of 2^11 (the 64-wide, 2-hidden-layer
#: MLP kept). Adam's epsilon is 1e-8, not the config's 1e-15: at 1e-15 the
#: first step moves every parameter by ±lr whatever its gradient, so one
#: whose gradient is ~1e-12 (its sign set by the summation order) moves by
#: 2·lr between the packages
CONFIG = {
    "loss": {"otype": "Mape"},
    "optimizer": {"otype": "Adam", "learning_rate": 1e-2, "beta1": 0.9, "beta2": 0.99, "epsilon": 1e-8,
                  "l2_reg": 1e-6},
    "encoding": {"otype": "HashGrid", "n_levels": 5, "n_features_per_level": 2, "log2_hashmap_size": 11,
                 "base_resolution": 8, "per_level_scale": 1.6},
    "network": {"otype": "FullyFusedMLP", "n_neurons": 64, "n_hidden_layers": 2},
}
#: the camera of tests/test_sdf.py: looking down +z at the unit box
CAM = np.array([[1, 0, 0, 0.5], [0, -1, 0, 0.5], [0, 0, 1, -1.0]], np.float32)
FOCAL = np.array([40.0, 40.0], np.float32)


def bumpy_icosphere(subdiv=2):
    """An icosphere displaced radially by a smooth bump field (not convex)."""
    m = icosphere(subdiv=subdiv)
    d = m.vertices - 0.5
    r = 1 + 0.15 * np.sin(7 * d[:, :1]) * np.cos(5 * d[:, 1:2]) * np.sin(6 * d[:, 2:])
    return jmesh_io.TriMesh((0.5 + d * r).astype(np.float32), m.faces)


MESHES = {"cube": cube_mesh, "sphere": lambda: icosphere(subdiv=2), "bumpy": bumpy_icosphere}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _query_points(mesh, n=600, seed=0):
    """Uniform points in the inflated box, points just off the surface and
    the vertices."""
    rng = np.random.default_rng(seed)
    lo, hi = mesh.vertices.min(0) - 0.1, mesh.vertices.max(0) + 0.1
    uni = rng.uniform(lo, hi, (n, 3))
    tri = mesh.vertices[mesh.faces[rng.integers(0, len(mesh.faces), n)]]
    b = rng.dirichlet(np.ones(3), n)
    near = np.einsum("nk,nkd->nd", b, tri) + rng.normal(0, 0.01, (n, 3))
    return np.concatenate([uni, near, mesh.vertices]).astype(np.float32)


@pytest.mark.parametrize("name", list(MESHES))
def test_build_bvh_arrays_equal_jax(name):
    mesh = MESHES[name]()
    ref = jbvh.build_bvh(mesh.vertices, mesh.faces)
    ours = tbvh.build_bvh(mesh.vertices, mesh.faces, CPU)
    assert ours._fields == ref._fields
    for k in ref._fields:
        a, b = getattr(ours, k).numpy(), np.asarray(getattr(ref, k))
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("name", list(MESHES))
def test_signed_distance_matches_jax(name):
    # the brute force (kernel G's plain version) vs JAX's BVH walk: within
    # 1e-5; signs equal where |d| > 1e-6 (ties between triangles may pick
    # another closest feature, of the same sign)
    mesh = MESHES[name]()
    pts = _query_points(mesh)
    ref = np.asarray(jax.jit(jbvh.signed_distance)(jbvh.build_bvh(mesh.vertices, mesh.faces), jnp.asarray(pts)))
    bvh = tbvh.build_bvh(mesh.vertices, mesh.faces, CPU)
    ours = tbvh.signed_distance(bvh, _t(pts)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    clear = np.abs(ref) > 1e-6
    np.testing.assert_array_equal(np.sign(ours[clear]), np.sign(ref[clear]))
    assert (ref < -1e-3).any() and (ref > 1e-3).any()
    # the triangle set of the BVH is build_triangles' (the edit path's)
    tris = tbvh.build_triangles(mesh.vertices, mesh.faces, CPU)
    for a, b in zip(tris, bvh.triangles()):
        assert torch.equal(a, b)


def test_bvh_kernel_wrapper_refuses_cpu():
    from nerfshop_tpu_torch import kernels

    # the launch's struct of pointers: PackedBvh's arrays in field order, then
    # the pseudo-normals of its BvhArrays
    names = [name for name, _ in kernels.BvhArgs._fields_]
    assert names == [*tbvh.PackedBvh._fields[:2], "tri_pseudo_v", "tri_pseudo_e", "tri_n"]
    assert set(names[2:]) <= set(tbvh.BvhArrays._fields)
    mesh = cube_mesh()
    packed = tbvh.pack_bvh(tbvh.build_bvh(mesh.vertices, mesh.faces, CPU))
    with pytest.raises(ValueError, match="CUDA device"):
        tbvh.bvh_signed_distance_cuda(packed, torch.zeros((4, 3)))


@pytest.mark.parametrize("name", list(jlosses.LOSSES))
def test_losses_match(name):
    # values and gradients within 1e-6 relative; the relative losses'
    # normalizers are constants of the gradient in both
    rng = np.random.default_rng(3)
    target = rng.normal(0, 1, 500).astype(np.float32)
    pred = (target + rng.normal(0, 0.3, 500)).astype(np.float32)
    pred[:5] = target[:5] + np.array([1e-3, 0.05, -0.05, 0.2, -0.2], np.float32)  # |d| = 0 has no common subgradient
    jf, tf = jlosses.LOSSES[name], tlosses.LOSSES[name]
    assert set(tlosses.LOSSES) == set(jlosses.LOSSES)
    ref = np.asarray(jax.jit(jf)(jnp.asarray(target), jnp.asarray(pred)))
    g_ref = np.asarray(jax.jit(jax.grad(lambda p: jnp.sum(jf(jnp.asarray(target), p))))(jnp.asarray(pred)))
    p = _t(pred).requires_grad_(True)
    out = tf(_t(target), p)
    (g,) = torch.autograd.grad(out.sum(), p)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-5, atol=1e-6)
    assert tlosses.build_loss({"otype": name}) is tf


@pytest.mark.parametrize("knobs", [{}, {"metallic": 0.6, "subsurface": 0.4, "sheen": 0.5, "clearcoat": 0.7,
                                        "roughness": 0.3, "basecolor": (0.9, 0.4, 0.2)}])
def test_disney_shade_matches(knobs):
    # within 1e-5 of the largest value: fp32 in both
    rng = np.random.default_rng(5)

    def unit(a):
        return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)

    n = unit(rng.normal(size=(400, 3)))
    v = unit(rng.normal(size=(400, 3)))
    L = unit(rng.normal(size=3))
    base = rng.uniform(0, 1, (400, 3)).astype(np.float32)
    vis = rng.uniform(0, 1, (400, 1)).astype(np.float32)
    jp, tp = jbrdf.BrdfParams(**knobs), tbrdf.BrdfParams(**knobs)
    assert vars(jp) == vars(tp)
    shade = jax.jit(lambda b, a, c, L_, V, N: jbrdf.disney_shade(b, a, c, jp, L_, V, N))
    ref = np.asarray(shade(jnp.asarray(base), jnp.asarray(jp.ambientcolor) * 0.25, jnp.ones(3) * vis,
                           jnp.asarray(L), jnp.asarray(v), jnp.asarray(n)))
    ours = tbrdf.disney_shade(_t(base), torch.tensor(tp.ambientcolor) * 0.25, torch.ones(3) * _t(vis), tp, _t(L),
                              _t(v), _t(n)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


# ---------------------------------------------------------------- the testbed


def _port_testbed(jtb, mesh, seed=0):
    g = torch.Generator().manual_seed(seed)
    ttb = tsdf.SdfTestbed.create(CONFIG, mesh, CPU, g)
    ttb.model.load_state_dict(weights.field_params_from_jax(jax.tree.map(np.asarray, jtb.state.params)))
    return ttb


BATCH = 2048


@pytest.fixture(scope="module")
def trained():
    """A JAX SDF testbed trained 40 steps on a bumpy icosphere, and the
    port's with its weights."""
    mesh = bumpy_icosphere()
    jtb = jsdf.SdfTestbed.create(CONFIG, mesh, jax.random.PRNGKey(0))
    jtb.train(40, batch_size=BATCH)
    return jtb, _port_testbed(jtb, mesh), mesh


@pytest.fixture
def fp32(trained, monkeypatch):
    """The trained pair with the MLP in float32 in both packages (JAX's
    ``compute_dtype``, the port's bf16 rounding turned off): the tracers'
    arithmetic compared without bf16 flips. A flip is a 2^-8 step of one
    hidden activation where another summation order lands on the other side
    of a rounding boundary, and the sphere and shadow traces amplify it
    (many small steps along a grazing ray; the soft shadow's k·d/t with
    k = 2048); the bf16 numerics themselves are held to JAX by the model
    and train-step tests above."""
    jtb, ttb, mesh = trained
    jtb32 = copy.copy(jtb)
    jtb32.model = jsdf.SdfModel(jtb.model.encoding, dataclasses.replace(jtb.model.network, compute_dtype=jnp.float32))
    jtb32._trace_fn = None
    monkeypatch.setattr(fused_mlp, "bf16_round", lambda x: x)
    return jtb32, ttb


def _draws(k, n, zero_offset):
    """JAX _sample_batch's draws from its key k (sdf.py:134-162)."""
    n_exact, n_offset, n_uniform = tsdf.SdfTestbed.batch_sizes(n)
    k1, k2, k3, k4 = jax.random.split(k, 4)
    u = jax.random.uniform(k1, (n_exact + n_offset,))
    b = jax.random.uniform(k2, (n_exact + n_offset, 2))
    uu = jax.random.uniform(k3, (n_offset, 3))
    uni = jax.random.uniform(k4, (n_uniform, 3), minval=-zero_offset, maxval=1 + zero_offset)
    return [_t(np.asarray(a)) for a in (u, b, uu, uni)]


def test_model_and_normalisation_match(trained):
    jtb, ttb, _ = trained
    np.testing.assert_array_equal(ttb.tri_cdf.numpy(), np.asarray(jtb.tri_cdf))
    np.testing.assert_array_equal(ttb.tri_v.numpy(), np.asarray(jtb.tri_v))
    pts = np.random.default_rng(1).uniform(0, 1, (2000, 3)).astype(np.float32)
    ref = np.asarray(jtb.model.apply(jtb.state.params, jnp.asarray(pts)))
    with torch.no_grad():
        ours = ttb.model.apply(ttb.state.inference_params, _t(pts)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def test_sample_batch_and_train_step_match(trained):
    # one step from the same weights and JAX's draws: positions within 1e-6,
    # targets within 1e-5, the loss within 1e-5 relative, the params within 1e-4
    # (from the trained state, restored afterwards for the other tests)
    jtb, _, mesh = trained
    ttb = _port_testbed(jtb, mesh)
    # the Adam moments JAX has after 40 steps, on the port's side
    adam = next(st for st in jtb.state.opt_state if hasattr(st, "mu"))
    for (name, p), m, v in zip(ttb.model.named_parameters(), jax.tree.leaves(adam.mu), jax.tree.leaves(adam.nu)):
        st = ttb.state.optimizer.state[p]
        st["exp_avg"].copy_(_t(np.asarray(m)))
        st["exp_avg_sq"].copy_(_t(np.asarray(v)))
        st["step"].fill_(40.0)
    ttb.state.step = ttb.step = 40
    saved = jax.tree.map(lambda a: np.array(a), (jtb.state, jtb.rng))
    k = jax.random.split(jtb.rng)[1]
    jpos, jtarget = jtb._sample_fn(k)  # _sample_batch(None, k, BATCH), compiled by the training
    pos, target = ttb._sample_batch(BATCH, _draws(k, BATCH, ttb.zero_offset))
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), rtol=0, atol=1e-6)
    np.testing.assert_allclose(target.numpy(), np.asarray(jtarget), rtol=0, atol=1e-5)
    try:
        jloss = jtb.train(1, batch_size=BATCH)
        ref = weights.field_params_from_jax(jax.tree.map(np.asarray, jtb.state.params))
    finally:
        jtb.state, jtb.rng = jax.tree.map(jnp.asarray, saved)
        jtb.step -= 1
    loss = float(ttb.train_step(pos, target))
    assert loss == pytest.approx(jloss, rel=1e-5)
    for name, p in ttb.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=0, atol=1e-4, err_msg=name)


def _rays(W=32, H=32, cam=CAM, focal=FOCAL):
    b = trays.rays_for_image((W, H), _t(cam), _t(focal), _t(np.array([0.5, 0.5], np.float32)))
    return b.origins, b.directions


def test_sphere_trace_matches(fp32):
    # t within 1e-4 on every ray but those of the eps band: fp32 sums in
    # another order may let a ray converge (|d| < eps) one step apart (t
    # within eps + 1e-4) or leave it marching after the 50 steps in both
    # (|d_final| ≥ eps: a grazing ray). The hit masks are equal away from
    # the band |d_final| ≈ 20·eps.
    eps = 5e-4
    jtb, ttb = fp32
    o, d = _rays()
    jt, jpos, jhit = jax.jit(jtb._sphere_trace)(jtb.state.params, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()))
    t, pos, hit = ttb._sphere_trace(ttb.state.inference_params, o, d)
    jt = np.asarray(jt)
    dt = np.abs(t.numpy() - jt)
    with torch.no_grad():
        d_final = ttb._field(ttb.state.inference_params, pos).abs().numpy()
    jd_final = np.abs(np.asarray(jax.jit(jtb.model.apply)(jtb.state.params, jnp.clip(jpos, 0, 1))))
    marching = (d_final >= eps) & (jd_final >= eps)
    band = eps + 1e-6  # a re-evaluated |d| may sit an ulp above eps
    one_step = (d_final < band) & (jd_final < band) & (dt <= eps + 1e-4)
    assert (dt <= 1e-4).mean() >= 0.99
    assert ((dt <= 1e-4) | marching | one_step).all(), np.nonzero(~((dt <= 1e-4) | marching | one_step))
    clear = np.abs(d_final - 20 * eps) > 1e-5
    np.testing.assert_array_equal(hit.numpy()[clear], np.asarray(jhit)[clear])
    assert 0.1 < hit.float().mean() < 0.9


@pytest.mark.parametrize("analytic", [True, False], ids=["analytic", "finite-difference"])
def test_normals_match(fp32, analytic):
    # unit normals within 1e-4 (autodiff) and 1e-3 (central differences of
    # 1e-3: fp32 ulps of the field over 2e-3)
    jtb, ttb = fp32
    o, d = _rays()
    _, pos, hit = ttb._sphere_trace(ttb.state.inference_params, o, d)
    pos = pos[hit]
    jtb.analytic_normals = ttb.analytic_normals = analytic
    try:
        ref = np.asarray(jax.jit(jtb._normals)(jtb.state.params, jnp.asarray(pos.numpy())))
        ours = ttb._normals(ttb.state.inference_params, pos).numpy()
    finally:
        jtb.analytic_normals = ttb.analytic_normals = True
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4 if analytic else 1e-3)


def test_shadow_trace_matches(fp32):
    # the soft visibility within 1e-4
    jtb, ttb = fp32
    o, d = _rays()
    _, pos, hit = ttb._sphere_trace(ttb.state.inference_params, o, d)
    pos = pos[hit]
    n = ttb._normals(ttb.state.inference_params, pos)
    sun = ttb._sun(CPU).expand_as(pos)
    start = pos + n * 3e-3
    shadow = jax.jit(lambda p, o_, d_: jtb._shadow_trace(p, o_, d_, 64.0))
    ref = np.asarray(shadow(jtb.state.params, jnp.asarray(start.numpy()), jnp.asarray(sun.numpy())))
    ours = ttb._shadow_trace(ttb.state.inference_params, start, sun, 64.0).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)
    assert (ours < 0.99).any()


@pytest.mark.parametrize("floor", [False, True], ids=["plain", "floor"])
def test_render_matches(fp32, floor):
    # a 32×32 frame: the hit mask equal on all but ≤ 2 pixels (the eps
    # band); the sRGB colour within 1e-3 on ≥ 99% of the pixels both hit
    # and within 0.05 on all (a ray of the trace's band: its t one step of
    # < eps apart moves its normal and its shadow)
    jtb, ttb = fp32
    jtb.floor_enable = ttb.floor_enable = floor
    try:
        ref = jtb.render(32, 32, CAM, FOCAL)
        ours = ttb.render(32, 32, CAM, FOCAL).numpy()
    finally:
        jtb.floor_enable = ttb.floor_enable = False
    assert ours.shape == ref.shape == (32, 32, 4) and np.isfinite(ours).all()
    same = ours[..., 3] == ref[..., 3]
    assert (~same).sum() <= 2
    close = (np.abs(ours - ref) <= 1e-3).all(-1)
    assert close[same].mean() >= 0.99
    np.testing.assert_allclose(ours[same], ref[same], rtol=0, atol=0.05)


def test_calculate_iou_matches(trained, monkeypatch):
    # within 1e-3: a point within a bf16 flip of the surface may change side
    # (JAX's BVH query jitted: the same function, one compile)
    monkeypatch.setattr(jbvh, "signed_distance", jax.jit(jbvh.signed_distance))
    jtb, ttb, _ = trained
    k = jax.random.split(jtb.rng)[1]
    pts = np.asarray(jax.random.uniform(k, (2048, 3)))
    ref = jtb.calculate_iou(2048)
    ours = ttb.calculate_iou(points=_t(pts))
    assert ours == pytest.approx(ref, abs=1e-3)
    assert ours > 0.5


# ------------------------------------------------------------------- facade


def test_testbed_sdf_mode_round_trip(tmp_path):
    mesh = bumpy_icosphere(subdiv=1)
    tmesh_io.save_obj(tmp_path / "bumpy.obj", tmesh_io.TriMesh(mesh.vertices, mesh.faces.astype(np.int32)))
    tb = Testbed("sdf", config=CONFIG, device="cpu", seed=0)
    tb.load_training_data(str(tmp_path / "bumpy.obj"))
    l0 = tb.train(1, 1024)
    l1 = tb.train(5, 1024)
    assert np.isfinite(l1) and l1 < l0 and tb.stats.step == 6
    assert 0.0 <= tb.calculate_iou(1024) <= 1.0
    tb.sun_dir = (0.0, 1.0, 0.0)
    assert tb.sdf.sun_dir == (0.0, 1.0, 0.0) and tb.brdf is tb.sdf.brdf
    img = tb.render(16, 12)
    assert img.shape == (12, 16, 4) and np.isfinite(img).all()
    tb.screenshot(str(tmp_path / "shot.png"), 16, 12, spp=1)
    assert (tmp_path / "shot.png").exists()
    with pytest.raises(RuntimeError, match="NeRF mode"):
        tb.get_density_on_grid(8)
    with pytest.raises(RuntimeError, match="SDF mode"):
        Testbed("image", device="cpu").calculate_iou()
    tb.save_snapshot(str(tmp_path / "s.snap"))
    again = Testbed(device="cpu", seed=5)
    again.load_snapshot(str(tmp_path / "s.snap"))
    assert again.mode.value == "sdf" and again.stats.step == 6
    again.sun_dir = (0.0, 1.0, 0.0)  # a shading knob, not in the snapshot
    np.testing.assert_array_equal(again.render(16, 12), img)  # the loaded weights render (F13)
    again.load_training_data(str(tmp_path / "bumpy.obj"))
    again.load_snapshot(str(tmp_path / "s.snap"))
    again.train(1, 1024)
    assert again.stats.step == 7
    # the CLI: the mode from the .obj suffix
    (tmp_path / "net.json").write_text(json.dumps(CONFIG))
    cli = trun.main(["--scene", str(tmp_path / "bumpy.obj"), "--network", str(tmp_path / "net.json"), "--n_steps", "2",
                     "--batch_size", "1024", "--screenshot_dir", str(tmp_path / "shots"), "--width", "16",
                     "--height", "12", "--device", "cpu"])
    assert cli.mode.value == "sdf" and cli.stats.step == 2
    assert tmesh_io.load_mesh(tmp_path / "bumpy.obj").faces.shape == (80, 3)
    with pytest.raises(RuntimeError, match="NeRF mode"):
        trun.main(["--scene", str(tmp_path / "bumpy.obj"), "--n_steps", "0", "--save_mesh", str(tmp_path / "m.obj"),
                   "--device", "cpu"])


def test_kernel_range_by_mode_raises_early():
    cfg = {**CONFIG, "network": {"n_neurons": 128, "n_hidden_layers": 2}}
    with pytest.raises(ValueError, match="kernel C.*hidden width 128"):
        Testbed("sdf", config=cfg, device="cuda")
    with pytest.raises(ValueError, match="kernels K and L.*Takikawa.*n_features_per_level 3"):
        Testbed("sdf", config={**CONFIG, "encoding": {"otype": "Takikawa", "n_features_per_level": 3}}, device="cuda")


@pytest.mark.xfail(strict=True, reason=(
    "F13 (reference fault): JAX load_snapshot restores params into Testbed._state, but "
    "_reset_network built a fresh SdfTestbed (nerfshop_tpu/testbed.py:291) whose render reads its "
    "own state (nerfshop_tpu/train/sdf.py:268), and train copies that state back "
    "(nerfshop_tpu/testbed.py:410); the loaded weights are lost"))
def test_jax_sdf_load_snapshot_keeps_weights(tmp_path):
    # what render and train read after load_snapshot: the SdfTestbed's state
    cfg = {**CONFIG, "encoding": {**CONFIG["encoding"], "n_levels": 3, "log2_hashmap_size": 9}}
    src = JTestbed("sdf", config=cfg)
    src.save_snapshot(str(tmp_path / "j.snap"))
    dst = JTestbed("sdf", config=cfg)
    dst.load_snapshot(str(tmp_path / "j.snap"))
    for a, b in zip(jax.tree.leaves(dst._sdf.state.params), jax.tree.leaves(src._state.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


#: F14's small config: the module's, cut as F13's test cuts it
F14_CONFIG = {**CONFIG, "encoding": {**CONFIG["encoding"], "n_levels": 3, "log2_hashmap_size": 9}}


@pytest.mark.xfail(strict=True, reason=(
    "F14 (reference fault): in SDF mode JAX Testbed.render renders self.camera_matrix and "
    "self._focal_for(...), dropping the camera_matrix it is given (nerfshop_tpu/testbed.py:760-763)"))
def test_jax_sdf_render_honours_camera_matrix():
    tb = JTestbed("sdf", config=F14_CONFIG)
    at_cam = tb.render(8, 6, camera_matrix=CAM)
    tb.camera_matrix = CAM.copy()
    np.testing.assert_array_equal(at_cam, tb.render(8, 6))


def test_sdf_render_honours_camera_matrix():
    # the port renders the camera it is given (F14 in the reference)
    tb = Testbed("sdf", config=F14_CONFIG, device="cpu", seed=0)
    default = tb.render(8, 6)
    at_cam = tb.render(8, 6, camera_matrix=CAM)
    assert not np.array_equal(at_cam, default)  # the two views differ
    tb.camera_matrix = CAM.copy()
    np.testing.assert_array_equal(at_cam, tb.render(8, 6))
