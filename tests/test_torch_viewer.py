"""The port's web viewer (``nerfshop_tpu_torch/viewer``) driven over HTTP on
a CPU testbed with a 32³ bake, as ``tests/test_viewer.py`` drives the JAX
one: the page and state, baked, exact and overlaid frames (PNG through the
port's encoder, read back by its reader), training, every edit verb, the
incremental rebake after a drag of an applied cage, and the launcher's
scene-then-snapshot order (F12).

The membrane verb draws its directions from a ``torch.Generator`` seeded 5
where JAX uses ``jax.random.PRNGKey(5)``: the draws, and so the membrane's
values, differ between the packages."""

import json
import socket
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from nerfshop_tpu_torch.data import image_io
from nerfshop_tpu_torch.viewer.server import ViewerServer
from test_torch_baked import _ball_density, _testbed
from test_torch_render import CENTER, look_at

W, H = 48, 32


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def viewer():
    tb = _testbed(_ball_density(r=0.25))
    srv = ViewerServer(tb, port=_free_port(), bake_resolution=32)
    httpd = srv.start_background()
    yield f"http://127.0.0.1:{srv.port}", srv
    httpd.shutdown()
    httpd.server_close()


def _post(url, path, body):
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(), method="POST")
    return urllib.request.urlopen(req, timeout=120)


def _edit(url, verb, body=None):
    return json.loads(_post(url, f"/edit/{verb}", body or {}).read())


def _state(url):
    return json.loads(urllib.request.urlopen(url + "/state", timeout=30).read())


def _png(tmp_path, body) -> np.ndarray:
    path = tmp_path / "frame.png"
    path.write_bytes(body)
    return image_io.read_png(path)


def test_index_and_state(viewer):
    url, srv = viewer
    html = urllib.request.urlopen(url + "/", timeout=30).read()
    assert b"nerfshop_tpu viewer" in html
    state = _state(url)
    assert len(state["camera"]) == 3 and state["n_operators"] == 0 and state["edit_stage"] is None
    with pytest.raises(urllib.error.HTTPError):
        urllib.request.urlopen(url + "/nothing", timeout=30)


def test_render_baked_exact_and_overlays(viewer, tmp_path):
    url, srv = viewer
    cam = look_at(CENTER + np.array([0.9, -0.9, 0.5], np.float32))
    r = _post(url, "/render", {"width": W, "height": H, "camera": cam.tolist()})
    assert r.headers["Content-Type"] == "image/png"
    img = _png(tmp_path, r.read())
    assert img.shape == (H, W, 4)
    # the baked preview's frame, quantized as the server does
    ref = (np.clip(srv.tb.render_interactive(W, H), 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(img, ref)
    state = _state(url)
    assert state["last_rebake_s"] > 0 and state["last_frame_ms"] > 0 and state["last_png_ms"] > 0
    exact = _png(tmp_path, _post(url, "/render", {"width": W, "height": H, "exact": True}).read())
    assert exact.shape == (H, W, 4)
    over = _png(tmp_path, _post(url, "/render", {"width": W, "height": H, "visualize_unit_cube": True,
                                                  "visualize_cameras": True}).read())
    assert over.shape == (H, W, 4) and np.any(over != img)


def test_train_then_render_rebakes_in_full(viewer):
    url, srv = viewer
    _post(url, "/render", {"width": W, "height": H})
    step = srv.tb.stats.step
    out = json.loads(_post(url, "/train", {"n_steps": 2, "batch_size": 1 << 13}).read())
    assert np.isfinite(out["loss"]) and out["step"] == step + 2
    before = _state(url)["last_rebake_s"]
    _post(url, "/render", {"width": W, "height": H})
    assert srv.tb.last_bake_incremental is False and _state(url)["last_rebake_s"] != before
    assert len(_state(url)["loss_history"]) > 0


# the next three tests are one edit, in order


def test_edit_verbs_before_apply(viewer):
    url, srv = viewer
    out = _edit(url, "select_sphere", {"center": [0.5, 0.5, 0.5], "radius": 0.12})
    assert out["ok"] and out["stage"] == "RegionGrowing"
    srv._gs.target_cage_vertices = 40  # a coarse cage keeps the CPU lookups cheap
    assert _edit(url, "compute_proxy")["stage"] == "ProxyMesh"
    assert _edit(url, "extract_cage")["stage"] == "TetMesh"
    # the manipulations before the cage is applied (each one after it
    # rebuilds the operator and refreshes the grid, seconds on the CPU)
    v = np.asarray(_state(url)["cage_vertices"], np.float32)
    assert len(v) > 3
    assert _edit(url, "move_vertex", {"index": 0, "position": (v[0] + 0.02).tolist()})["ok"]
    np.testing.assert_allclose(_state(url)["cage_vertices"][0], v[0] + 0.02, atol=1e-6)
    assert _edit(url, "set_cage_vertices", {"vertices": v.tolist()})["ok"]
    assert _edit(url, "transform_group", {"indices": [0, 1, 2], "offset": [0.0, 0.01, 0.0]})["ok"]
    assert _edit(url, "membrane", {"amplitude": 1.0})["ok"] and srv._gs.membrane is not None
    assert _edit(url, "membrane", {"amplitude": 0.0})["ok"] and srv._gs.membrane is None
    assert srv.tb.edit_operators == []


def test_apply_then_drag_rebakes_incrementally(viewer, tmp_path):
    url, srv = viewer
    tb = srv.tb
    out = _edit(url, "apply")
    assert out["ok"] and out["n_operators"] == 1
    _post(url, "/render", {"width": W, "height": H})
    assert tb.last_bake_incremental is False  # the stack grew: a full bake
    s0 = _state(url)["last_rebake_s"]
    # a drag of the applied cage: its slot's operator is replaced, the next
    # frame patches the region it touches
    op = tb.edit_operators[0]
    assert _edit(url, "translate", {"offset": [0.03, 0.0, 0.0]})["ok"]
    assert tb.edit_operators[0] is not op
    img = _png(tmp_path, _post(url, "/render", {"width": W, "height": H, "visualize_cage": True}).read())
    assert img.shape == (H, W, 4)
    assert tb.last_bake_incremental is True and _state(url)["last_rebake_s"] != s0
    assert _edit(url, "save_edits", {"path": str(tmp_path / "edits.json")})["ok"]
    assert (tmp_path / "edits.json").exists()


def test_vanish_rebakes_in_full_and_clear(viewer):
    url, srv = viewer
    tb = srv.tb
    grid = tb.grid
    assert _edit(url, "vanish")["ok"]
    assert tb.grid is not grid and int((tb.grid.density == 0).sum()) > int((grid.density == 0).sum())
    _post(url, "/render", {"width": W, "height": H})
    assert tb.last_bake_incremental is False  # only the grid changed: a full bake
    out = _edit(url, "clear")
    assert out["ok"] and out["n_operators"] == 0 and out["stage"] is None


def test_project_and_grow(viewer):
    url, srv = viewer
    srv.tb.camera_matrix = look_at(CENTER + np.array([0.0, -1.3, 0.0], np.float32))
    alpha = srv.tb.render_interactive(W, H)[..., 3]
    ys, xs = np.nonzero(alpha > 0.9)  # scribble where the (random) field is opaque
    pix = [[(x + 0.5) / W, (y + 0.5) / H] for y, x in list(zip(ys, xs))[:: max(1, len(ys) // 16)]]
    out = _edit(url, "project", {"pixels": pix, "width": W, "height": H, "growing_steps": 50})
    assert out["ok"] and out["hits"] > 0 and out["stage"] == "RegionGrowing"
    assert _edit(url, "grow", {"steps": 20})["ok"]


def test_unknown_verb_and_errors(viewer):
    url, _ = viewer
    out = _edit(url, "nonsense")
    assert out["ok"] is False and "nonsense" in out["error"]
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, "/edit/move_vertex", {})  # no selection in progress: the error goes back to the client
    assert e.value.code == 500


def test_launcher_loads_the_scene_then_the_snapshot(tmp_path):
    """F12: ``--scene`` with ``--snapshot`` keeps the snapshot's weights (the
    scene's fresh network would replace them, loaded the other way round)."""
    from nerfshop_tpu_torch.viewer.__main__ import make_testbed
    from test_torch_png import _png_scene

    from nerfshop_tpu_torch.testbed import Testbed
    from test_torch_render import CFG

    (tmp_path / "scene").mkdir()
    _png_scene(tmp_path / "scene")
    tb = Testbed(config=CFG, device="cpu", seed=0)
    tb.load_training_data(str(tmp_path / "scene"))
    with torch.no_grad():
        tb.model.pos_encoding.table.uniform_(-1.0, 1.0, generator=torch.Generator().manual_seed(4))
    tb.save_snapshot(str(tmp_path / "a.snap"))
    loaded = make_testbed(scene=str(tmp_path / "scene"), snapshot=str(tmp_path / "a.snap"), device="cpu")
    assert torch.equal(loaded.model.pos_encoding.table, tb.model.pos_encoding.table)
    assert loaded._dataset.n_images == 3
