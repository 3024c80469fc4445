"""The port's outputs and its CLI (``nerfshop_tpu_torch/run.py``) against the
JAX package's: camera paths, the ground-truth overlay, the density grid,
the marching-tets mesh, density slices, and ``scripts/run.py`` run
unchanged (through ``runpy``) beside ``run.main`` from one snapshot; then
the port's CLI through every stage on a PNG scene it wrote itself."""

import json
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfshop_tpu.ops import grid as jgrid
from nerfshop_tpu.render import buffer as jbuffer
from nerfshop_tpu.render import camera_path as jcp
from nerfshop_tpu.testbed import Testbed as JTestbed
from nerfshop_tpu_torch import run as trun
from nerfshop_tpu_torch.data import image_io as tio
from nerfshop_tpu_torch.geometry import mesh_io as tmesh_io
from nerfshop_tpu_torch.render import buffer as tbuffer
from nerfshop_tpu_torch.render import camera_path as tcp
from nerfshop_tpu_torch.testbed import Testbed as TTestbed
from torch_one_thread import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CFG = {
    "loss": {"otype": "Huber"},
    "optimizer": {"otype": "Ema", "decay": 0.95, "nested": {"otype": "Adam", "learning_rate": 1e-2}},
    "encoding": {"otype": "HashGrid", "n_levels": 3, "n_features_per_level": 2,
                 "log2_hashmap_size": 12, "base_resolution": 8, "per_level_scale": 1.5},
    "network": {"n_neurons": 64, "n_hidden_layers": 1},
    "dir_encoding": {"otype": "SphericalHarmonics", "degree": 4},
    "rgb_network": {"n_neurons": 64, "n_hidden_layers": 2},
}
PATH_JSON = {
    "loop": False,
    "path": [
        {"R": [0.9, 0.1, -0.3, 0.2], "T": [0.5, -1.2, 0.6], "fov": 45.0, "aperture_size": 0.0},
        {"R": [0.7, 0.3, -0.1, 0.6], "T": [1.4, -0.2, 0.7], "fov": 55.0, "aperture_size": 0.01},
        {"R": [-0.2, 0.5, 0.4, 0.7], "T": [0.9, 1.3, 0.3], "fov": 50.0},
    ],
}


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """A JAX snapshot of the small network with seeded weights whose density
    crosses 2.5 inside the unit cube, and a density grid with a ball."""
    tb = JTestbed(config=CFG)
    rng = np.random.default_rng(0)
    params = jax.tree.map(np.array, tb._state.params)
    params["pos_encoding"]["table"] = rng.uniform(-1, 1, params["pos_encoding"]["table"].shape).astype(np.float32)
    for mlp in ("density_mlp", "rgb_mlp"):
        params[mlp]["weights"] = [rng.uniform(-1, 1, w.shape).astype(np.float32) * np.sqrt(6.0 / w.shape[0])
                                  for w in params[mlp]["weights"]]
    params["density_mlp"]["weights"][-1][:, 0] *= 3.0  # raw σ spread wide enough to cross the iso level
    params = jax.tree.map(jnp.asarray, params)
    tb._state = tb._state._replace(params=params, ema_params=params)
    c = (np.arange(128) + 0.5) / 128 - 0.5
    r2 = c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None, :] ** 2
    dens = np.where(r2 < 0.3**2, 400.0, 0.0)[None].astype(np.float32)
    tb._grid = jgrid.update_bitfield(tb._grid._replace(density=jnp.asarray(dens)))
    path = tmp_path_factory.mktemp("snapshot") / "model.snap"
    tb.save_snapshot(str(path))
    return path


@pytest.fixture(scope="module")
def testbeds(snapshot):
    jtb = JTestbed()
    jtb.load_snapshot(str(snapshot))
    ttb = TTestbed(device="cpu")
    ttb.load_snapshot(str(snapshot))
    return jtb, ttb


def _density_close(ours, ref):
    # bf16 MLP rounding at the same points and fp32 sums in another order: σ
    # within 1e-4 relative on 99.9% of cells; where a hidden activation lies
    # within an fp32 ulp of a bf16 rounding boundary the two round apart (a
    # step of 2^-8 relative), so within 1e-2 relative on all
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    rel = np.abs(ours - ref) / np.maximum(np.abs(ref), 1e-6)
    assert (rel <= 1e-4).mean() >= 0.999 and rel.max() <= 1e-2, ((rel > 1e-4).sum(), rel.max())


def test_camera_path_matches_jax(tmp_path):
    # the port's copy: the same keyframes from one JSON, the same
    # interpolation, and a save that loads back in JAX
    src = tmp_path / "path.json"
    for loop in (False, True):
        src.write_text(json.dumps({**PATH_JSON, "loop": loop}))
        ours, ref = tcp.CameraPath.load(src), jcp.CameraPath.load(src)
        for u in (0.0, 0.2, 0.5, 0.77, 1.0):
            a, b = ours.eval(u), ref.eval(u)
            np.testing.assert_array_equal(a.camera_matrix(), b.camera_matrix())
            assert (a.fov_deg, a.aperture) == (b.fov_deg, b.aperture)
        ours.add_camera(np.eye(4)[:3], fov_deg=30.0)
        ours.save(tmp_path / "saved.json")
        back = jcp.CameraPath.load(tmp_path / "saved.json")
        assert len(back.keyframes) == 4 and back.loop == loop
        np.testing.assert_array_equal(back.eval(0.6).camera_matrix(), ours.eval(0.6).camera_matrix())


@pytest.mark.parametrize("case", ["split", "error", "blend", "gt-smaller", "gt-larger"])
def test_overlay_ground_truth_matches_jax(case):
    # same sizes: within 1e-6 (the same elementwise arithmetic); a ground
    # truth of another size is resized first: within 1e-5 (the bilinear
    # weights, and when shrinking the widened triangle filter, sum in
    # another order)
    rng = np.random.default_rng(len(case))
    pred = rng.uniform(0, 1, (12, 16, 4)).astype(np.float32)
    gt_shape = {"gt-smaller": (6, 8, 3), "gt-larger": (30, 40, 4)}.get(case, (12, 16, 3))
    gt = rng.uniform(0, 1, gt_shape).astype(np.float32)
    mode = case if case in ("split", "error", "blend") else "blend"
    ref = np.asarray(jbuffer.overlay_ground_truth(jnp.asarray(pred), jnp.asarray(gt), mode))
    ours = tbuffer.overlay_ground_truth(torch.from_numpy(pred), torch.from_numpy(gt), mode).numpy()
    assert ours.shape == ref.shape == (12, 16, 4)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6 if mode == case else 1e-5)
    with pytest.raises(ValueError):
        tbuffer.overlay_ground_truth(torch.from_numpy(pred), torch.from_numpy(gt), "nope")


def test_density_on_grid_matches_jax(testbeds):
    jtb, ttb = testbeds
    ref = jtb.get_density_on_grid(32)
    ours = ttb.get_density_on_grid(32)
    assert ours.dtype == np.float32 and ours.shape == (32, 32, 32)
    assert (ref > 2.5).mean() > 0.01 and (ref < 2.5).mean() > 0.01  # the iso level crosses the cube
    _density_close(ours, ref)
    # over a box of its own
    from nerfshop_tpu.ops import coords as jcoords
    from nerfshop_tpu_torch.ops import coords as tcoords

    lo, hi = np.array([0.2, 0.3, 0.1], np.float32), np.array([0.7, 0.9, 0.5], np.float32)
    ref = jtb.get_density_on_grid(16, jcoords.BoundingBox(jnp.asarray(lo), jnp.asarray(hi)))
    ours = ttb.get_density_on_grid(16, tcoords.BoundingBox(torch.from_numpy(lo), torch.from_numpy(hi)))
    _density_close(ours, ref)


def test_marching_cubes_mesh_and_slices_match_jax(testbeds, tmp_path):
    # the same field → the same marching tets: vertex counts within 1%,
    # vertex colours (the radiance field at each vertex) within 1e-3 on average
    jtb, ttb = testbeds
    ref = jtb.compute_marching_cubes_mesh(24)
    ours = ttb.compute_marching_cubes_mesh(24)
    assert ref.n_vertices > 100 and abs(ours.n_vertices - ref.n_vertices) <= 0.01 * ref.n_vertices
    assert ours.colors.shape == (ours.n_vertices, 3) and np.isfinite(ours.colors).all()
    if ours.n_vertices == ref.n_vertices:
        np.testing.assert_allclose(ours.vertices, ref.vertices, rtol=0, atol=1e-5)
        assert np.abs(ours.colors - ref.colors).mean() <= 1e-3
    jtb.compute_and_save_png_slices(str(tmp_path / "jax.png"), resolution=16)
    ttb.compute_and_save_png_slices(str(tmp_path / "port.png"), resolution=16)
    a, b = tio.read_png(tmp_path / "port.png"), tio.read_png(tmp_path / "jax.png")
    assert a.shape == b.shape == (64, 64, 3)
    assert (np.abs(a.astype(int) - b.astype(int)) <= 1).all()


def test_cli_matches_jax(snapshot, testbeds, tmp_path, monkeypatch, capsys):
    # scripts/run.py and run.main from one snapshot: screenshots within
    # 1/255 on ≥ 99% of pixels (σ and rgb agree to ~1e-4; the PNG levels
    # can then round apart by one), density grids within 1e-4 relative,
    # mesh vertex counts within 1%
    jtb, _ = testbeds
    common = ["--load_snapshot", str(snapshot), "--n_steps", "0", "--width", "32", "--height", "24",
              "--screenshot_spp", "1", "--marching_cubes_res", "32"]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setattr(sys, "argv", ["run.py", *common, "--screenshot_dir", str(jdir), "--save_mesh", str(tmp_path / "jax.obj")])
    runpy.run_path(str(ROOT / "scripts" / "run.py"), run_name="__main__")
    jout = capsys.readouterr().out
    tb = trun.main([*common, "--screenshot_dir", str(tdir), "--save_mesh", str(tmp_path / "port.obj"), "--device", "cpu"])
    tout = capsys.readouterr().out
    assert [line.split()[0] for line in tout.splitlines()] == [line.split()[0] for line in jout.splitlines()]
    ours, ref = tio.read_image(tdir / "screenshot.png", linear=False), tio.read_image(jdir / "screenshot.png", linear=False)
    assert ours.shape == ref.shape == (24, 32, 4) and ref[..., 3].max() > 0.1  # content in view
    assert (np.abs(ours - ref) <= 1 / 255 + 1e-6).mean() >= 0.99
    _density_close(tb.get_density_on_grid(32), jtb.get_density_on_grid(32))
    jm, tm = tmesh_io.load_mesh(tmp_path / "jax.obj"), tmesh_io.load_mesh(tmp_path / "port.obj")
    assert jm.n_vertices > 100 and abs(tm.n_vertices - jm.n_vertices) <= 0.01 * jm.n_vertices


def _sphere_scene(root, n=4, size=16):
    """An analytic opaque sphere seen from ``n`` views, as transforms.json and
    RGBA PNGs written by the port."""
    (root / "images").mkdir(parents=True)
    frames = []
    for i in range(n):
        ang = 2 * np.pi * i / n
        eye = np.array([np.cos(ang), np.sin(ang), 0.3]) * 1.3
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        m = np.eye(4)
        m[:3, :3] = np.stack([right, up, -fwd], 1)
        m[:3, 3] = eye
        f = size * 1.2
        v, u = np.mgrid[0:size, 0:size] + 0.5
        d = (right[None, None] * ((u - size / 2) / f)[..., None] - up[None, None] * ((v - size / 2) / f)[..., None]
             + fwd[None, None])
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        b = np.sum(eye * d, -1)
        disc = b * b - (eye @ eye - 0.35**2)
        rgba = np.zeros((size, size, 4), np.float32)
        hit = disc > 0
        rgba[hit] = [0.8, 0.4, 0.2, 1.0]
        tio.write_image(root / "images" / f"{i:02d}.png", rgba, linear_input=False)
        frames.append({"file_path": f"images/{i:02d}.png", "transform_matrix": m.tolist()})
    (root / "transforms.json").write_text(json.dumps({"camera_angle_x": 2 * np.arctan(size / 2 / f),
                                                      "aabb_scale": 1, "frames": frames}))
    return root


def test_cli_runs_every_stage_on_a_png_scene(tmp_path, capsys):
    # the port's CLI alone through every stage, on the CPU: every output is
    # written and reads back, the final JSON has the evaluation's keys, and a
    # snapshot loaded before a scene keeps its weights
    scene = _sphere_scene(tmp_path / "scene")
    (tmp_path / "net.json").write_text(json.dumps(CFG))
    (tmp_path / "path.json").write_text(json.dumps(PATH_JSON))
    out = tmp_path / "out"
    out.mkdir()
    tb = trun.main([
        "--scene", str(scene), "--network", str(tmp_path / "net.json"), "--n_steps", "3", "--batch_size", "8192",
        "--save_snapshot", str(out / "model.snap"), "--save_mesh", str(out / "mesh.ply"), "--marching_cubes_res", "16",
        "--test_transforms", str(scene / "transforms.json"), "--eval_subsample", "2", "--screenshot_dir", str(out),
        "--width", "16", "--height", "12", "--screenshot_spp", "1", "--video_camera_path", str(tmp_path / "path.json"),
        "--video_n_frames", "2", "--video_output", str(out / "video"), "--video_spp", "1", "--device", "cpu",
    ])
    lines = capsys.readouterr().out.splitlines()
    result = json.loads(next(line for line in lines if line.startswith('{"psnr_mean"')))
    assert result["n_views"] == 2 and np.isfinite(result["psnr_mean"]) and 0 < result["ssim_mean"] <= 1
    assert tb.stats.step == 3 and any(line.startswith("  step      3") for line in lines)
    for name in ("screenshot.png", "video/frame_0000.png", "video/frame_0001.png"):
        img = tio.read_image(out / name, linear=False)
        assert img.shape == (12, 16, 4) and np.isfinite(img).all()
    assert tmesh_io.load_mesh(out / "mesh.ply").vertices.shape[1:] == (3,)
    again = trun.main(["--load_snapshot", str(out / "model.snap"), "--scene", str(scene), "--n_steps", "0",
                       "--device", "cpu"])
    assert again._dataset.n_images == 4 and again.stats.step == 3
    for k, v in again.inference_params.items():
        assert torch.equal(v, tb.inference_params[k]), k
    # --mode image (it raised before the Image testbed was ported) on one of
    # the scene's PNGs: trains, screenshots and prints its image_mse line
    img_cfg = {"encoding": {"otype": "HashGrid", "n_levels": 4, "log2_hashmap_size": 10, "base_resolution": 4},
               "network": {"n_neurons": 64, "n_hidden_layers": 2}}
    (tmp_path / "img.json").write_text(json.dumps(img_cfg))
    capsys.readouterr()
    image = trun.main(["--mode", "image", "--scene", str(scene / "images" / "00.png"), "--network",
                       str(tmp_path / "img.json"), "--n_steps", "2", "--batch_size", "1024", "--screenshot_dir",
                       str(out / "image"), "--width", "16", "--height", "16", "--device", "cpu"])
    last = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert image.mode.value == "image" and image.stats.step == 2
    assert set(last) == {"image_mse", "image_psnr"} and last["image_mse"] == pytest.approx(image.compute_image_mse())
    assert tio.read_image(out / "image" / "screenshot.png", linear=False).shape == (16, 16, 4)
