"""The port's headless edit demo (``nerfshop_tpu_torch/edit_demo.py``) against
``scripts/edit_demo.py``, on the CPU, stage by stage.

The JAX script is read, not run: its arguments and defaults, the lines it
prints and the keys of its JSON line are taken from its source and held to
the port's. The stages then run through their functions on a 4-view
16 × 16 sphere scene from a snapshot of a small network whose density is
high wherever the grid's ball is, so that the scribble hits and the region
grows. ``main`` as a whole is left to ``chip_smoke.py``'s [edit-demo]: on
the CPU it takes ~30 s on one thread at any scene size (three refreshes of
the 128³ grid through the operator stack, and the default ``DistillConfig``'s
steps), which the stage tests skip: the operator is built but not added, and
the student takes one step."""

import ast
import contextlib
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from nerfshop_tpu_torch import edit_demo
from nerfshop_tpu_torch.data import image_io
from nerfshop_tpu_torch.ops import grid as tgrid
from nerfshop_tpu_torch.testbed import Testbed
from test_torch_cli import CFG, _sphere_scene
from test_torch_render import seeded_density
from torch_one_thread import one_thread  # noqa: F401

SCRIPT = ast.parse((Path(__file__).resolve().parents[1] / "scripts" / "edit_demo.py").read_text())


def _jax_arguments() -> dict:
    """{option: default} of the script's ``add_argument`` calls."""
    out = {}
    for node in ast.walk(SCRIPT):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            kw = {k.arg: k.value for k in node.keywords}
            # constants and constant expressions such as 1 << 18
            out[node.args[0].value] = eval(ast.unparse(kw["default"]), {"__builtins__": {}}) if "default" in kw else None
    return out


PORT = ast.parse(Path(edit_demo.__file__).read_text())


def _result_keys(tree) -> set:
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "result":
            return {k.value for k in node.value.keys}
    raise AssertionError("no result dict")


def _printed(tree) -> list:
    """The source of what each ``print`` call prints."""
    return sorted(ast.unparse(node.args[0]) for node in ast.walk(tree)
                  if isinstance(node, ast.Call) and getattr(node.func, "id", "") == "print" and node.args)


def test_arguments_are_the_scripts():
    jax_args = _jax_arguments()
    args = vars(edit_demo.parse_args(["--scene", "s"]))
    # every option of the script, with its default, but the scene (the
    # script's default is a capture that does not ship) and --device
    assert set(jax_args) == {f"--{k}" for k in args} - {"--device"}
    for opt, default in jax_args.items():
        if opt != "--scene":
            assert args[opt[2:]] == default, opt
    assert args["device"] == "cuda"
    with pytest.raises(SystemExit):
        edit_demo.parse_args([])


@pytest.fixture(scope="module")
def demo_scene(tmp_path_factory):
    """A 4-view sphere scene and a snapshot of a small network trained on
    nothing: a seeded table, σ large where the grid's ball is."""
    root = tmp_path_factory.mktemp("edit_demo")
    scene = _sphere_scene(root / "scene", n=4, size=16)
    tb = Testbed(config=CFG, device="cpu", seed=0)
    tb.load_training_data(str(scene))
    with torch.no_grad():
        tb.model.pos_encoding.table.uniform_(-1.0, 1.0, generator=torch.Generator().manual_seed(1))
        tb.model.density_mlp.weights[-1][:, 0].abs_().mul_(3.0)
        for k, v in tb.model.named_parameters():
            tb._state.ema[k].copy_(v)
    tb.grid.density.copy_(torch.from_numpy(seeded_density()))
    tgrid.update_bitfield(tb.grid)
    tb.save_snapshot(str(root / "model.snap"))
    return root, scene


def test_prints_the_scripts_lines_and_keys():
    # the same lines, from the same expressions, and the same JSON keys
    assert _printed(PORT) == _printed(SCRIPT)
    assert _result_keys(PORT) == _result_keys(SCRIPT)


@pytest.fixture(scope="module")
def demo(demo_scene):
    """Stage 1 from the snapshot, and the eval view → (testbed, view)."""
    root, scene = demo_scene
    args = edit_demo.parse_args(["--scene", str(scene), "--snapshot", str(root / "model.snap"), "--downscale", "1",
                                 "--device", "cpu", "--out", str(root / "out")])
    tb = edit_demo.load_testbed(args)
    return tb, edit_demo.eval_view(args.scene, args.view, args.downscale)


@pytest.fixture(scope="module")
def selected(demo):
    """Stage 2 → (growing selection, hits, cells grown, printed lines)."""
    tb, v = demo
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        gs, hits, grown = edit_demo.select_region(tb, v)
    return gs, hits, grown, buf.getvalue().splitlines()


def test_loads_the_snapshot_and_renders_the_view(demo, demo_scene, tmp_path):
    root, _ = demo_scene
    tb, v = demo
    snap = Testbed(config=CFG, device="cpu")
    snap.load_snapshot(str(root / "model.snap"))
    for (k, a), b in zip(tb.model.named_parameters(), snap.model.parameters()):
        assert torch.equal(a, b), k
    assert (v.W, v.H) == (16, 16) and v.gt.shape == (16, 16, 4) and v.xforms.shape[0] == 4
    img = edit_demo.render_view(tb, v, tmp_path, "1_before")
    assert img.shape == (16, 16, 4) and np.isfinite(img).all()
    assert np.array_equal(image_io.read_image(tmp_path / "1_before.png", linear=False).shape, img.shape)


def test_select_region(selected):
    gs, hits, grown, lines = selected
    assert hits > 0 and grown > 0
    assert lines == [f"scribble projection: {hits} hits", f"region grow: {grown} cells",
                     f"cage: {len(gs.cage.vertices_original)} verts, {len(gs.tet_mesh.tets)} tets"]
    assert len(gs.cage.vertices_original) > 10 and len(gs.tet_mesh.tets) > 10


@pytest.fixture(scope="module")
def operator(demo, selected):
    """Stage 3 at the scene's default offset → (operator, offset, cage before)."""
    tb, v = demo
    gs = selected[0]
    before = np.array(gs.cage.vertices_deformed, copy=True)
    offset = edit_demo.scene_up_offset(v.xforms)
    op, lut_s = edit_demo.build_operator(tb, gs, offset)
    assert lut_s > 0
    return op, offset, before


def test_build_operator(demo, selected, operator):
    gs = selected[0]
    op, offset, before = operator
    # 0.3 along the rig's up (its cameras' mean −y axis)
    up = -np.asarray(demo[1].xforms)[:, :, 1].mean(0)
    np.testing.assert_allclose(offset, 0.3 * up / np.linalg.norm(up), rtol=1e-6)
    moved = np.asarray(gs.cage.vertices_deformed) - before
    np.testing.assert_allclose(moved, np.broadcast_to(offset, moved.shape), atol=1e-6)
    assert op.membrane is not None
    assert all(bool(torch.isfinite(t).all()) for t in op.membrane if isinstance(t, torch.Tensor))


def test_distill_one_step(demo, operator, tmp_path):
    tb, _ = demo
    student, seconds = edit_demo.distill_edit(tb, (operator[0],), 1)
    assert seconds > 0 and student.step == 1
    assert all(bool(torch.isfinite(p).all()) for p in student.model.parameters())


def test_write_result(tmp_path, capsys):
    result = {"metric": "edit_demo", "screenshots": str(tmp_path), "tets": 3}
    edit_demo.write_result(tmp_path, result)
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == result
    assert json.loads((tmp_path / "result.json").read_text()) == result
