"""The port's own copies of the JAX package's host modules (``common``,
``config``, ``data``, ``utils/metrics``, the viewer's overlays and page)
and of its native host library's source against the originals: the same enums, constants and configs, the
same dataset from the same files, the same metric and volume-ingest code
(``data/volume_io.py``) and values, and the same C++ below the header
comment. The port's ``build_bvh`` shares its triangle arithmetic with
``build_triangles``, so it is no verbatim copy: ``tests/test_torch_sdf.py``
holds its arrays equal to JAX's."""

import enum
import json

import numpy as np
import pytest

from nerfshop_tpu import common as jcommon
from nerfshop_tpu import config as jconfig
from nerfshop_tpu.data import nerf_loader as jloader
from nerfshop_tpu_torch import common as tcommon
from nerfshop_tpu_torch import config as tconfig
from nerfshop_tpu_torch.data import nerf_loader as tloader

CONFIGS = ["default_nerf_config", "fast_nerf_config", "tpu_flagship_nerf_config", "default_image_config",
           "default_sdf_config", "default_volume_config"]


@pytest.mark.parametrize("name", CONFIGS)
def test_configs_equal(name):
    assert dict(getattr(tconfig, name)()) == dict(getattr(jconfig, name)())


def test_common_enums_and_constants_equal():
    enums = [k for k, v in vars(jcommon).items() if isinstance(v, type) and issubclass(v, enum.Enum)]
    assert {"TestbedMode", "RenderMode", "TonemapCurve"} <= set(enums)
    for k in enums:
        assert [(m.name, m.value) for m in getattr(tcommon, k)] == [(m.name, m.value) for m in getattr(jcommon, k)], k
    consts = [k for k, v in vars(jcommon).items() if k.isupper() and isinstance(v, (int, float))]
    assert {"GRID_RESOLUTION", "MIN_CONE_STEPSIZE", "MAX_CONE_STEPSIZE", "DENSITY_GRID_DECAY"} <= set(consts)
    for k in consts:
        assert getattr(tcommon, k) == getattr(jcommon, k), k


def test_nerf_loader_loads_the_same_scene(tmp_path):
    from PIL import Image

    from nerfshop_tpu.data import exr

    rng = np.random.default_rng(4)
    (tmp_path / "images").mkdir()
    frames = []
    for i in range(3):
        m = np.eye(4)
        m[:3, 3] = rng.uniform(-1, 1, 3)
        if i < 2:
            img = (rng.uniform(0, 1, (8, 10, 4)) * 255).astype(np.uint8)
            Image.fromarray(img).save(tmp_path / "images" / f"{i}.png")
            path = f"images/{i}"
        else:
            hdr = rng.uniform(0, 2, (8, 10, 4)).astype(np.float32)
            exr.write_exr(str(tmp_path / "images" / "2.exr"), {c: hdr[..., k] for k, c in enumerate("RGBA")})
            path = "images/2.exr"
        frames.append({"file_path": path, "transform_matrix": m.tolist(), "fl_x": 11.0 + i})
    meta = {"camera_angle_x": 0.7, "aabb_scale": 4, "scale": 0.4, "offset": [0.5, 0.4, 0.5],
            "k1": 0.01, "cx": 5.2, "cy": 3.9, "frames": frames}
    (tmp_path / "transforms.json").write_text(json.dumps(meta))

    ref = jloader.load_nerf(tmp_path / "transforms.json")
    ours = tloader.load_nerf(tmp_path / "transforms.json")
    assert ours.n_images == ref.n_images == 3 and ours.aabb_scale == ref.aabb_scale == 4
    np.testing.assert_array_equal(ours.images, ref.images)
    np.testing.assert_array_equal(ours.xforms, ref.xforms)
    for m in ("focal_matrix", "principal_matrix", "distortion_matrix"):
        np.testing.assert_array_equal(getattr(ours, m)(), getattr(ref, m)())
    assert ours.scale == ref.scale and ours.color_space == ref.color_space
    np.testing.assert_array_equal(ours.offset, ref.offset)


def _code(path):
    """A module's AST without its docstring."""
    import ast

    tree = ast.parse(path.read_text())
    body = tree.body[1:] if isinstance(tree.body[0], ast.Expr) and isinstance(tree.body[0].value, ast.Constant) else tree.body
    return [ast.dump(node) for node in body]


def test_metrics_code_is_the_originals():
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    assert _code(root / "nerfshop_tpu_torch/utils/metrics.py") == _code(root / "nerfshop_tpu/utils/metrics.py")


def test_volume_io_code_is_the_originals():
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    assert _code(root / "nerfshop_tpu_torch/data/volume_io.py") == _code(root / "nerfshop_tpu/data/volume_io.py")


def test_viewer_overlay_code_is_the_originals():
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    assert _code(root / "nerfshop_tpu_torch/viewer/overlay.py") == _code(root / "nerfshop_tpu/viewer/overlay.py")


def test_viewer_page_is_the_originals():
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    page = "viewer/static/index.html"
    assert (root / "nerfshop_tpu_torch" / page).read_bytes() == (root / "nerfshop_tpu" / page).read_bytes()


def test_host_ops_source_is_the_originals():
    # everything from the first #include on; only the header comment differs
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]

    def body(p):
        text = (root / p).read_text()
        return text[text.index("\n#include") + 1:]

    assert body("nerfshop_tpu_torch/csrc/host_ops.cpp") == body("nerfshop_tpu/native/host_ops.cpp")


@pytest.mark.parametrize("metric", ["PSNR", "SSIM", "FLIP", "MSE", "L1", "MAPE", "SMAPE", "MRSE"])
def test_metrics_match(metric):
    from nerfshop_tpu.utils import metrics as jmetrics
    from nerfshop_tpu_torch.utils import metrics as tmetrics

    rng = np.random.default_rng(5)
    a = rng.uniform(0, 1, (40, 48, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    ours = tmetrics.compute_error(metric, a, b)
    assert ours == jmetrics.compute_error(metric, a, b) and np.isfinite(ours)
    assert tmetrics.psnr(a, a) == jmetrics.psnr(a, a) == 120.0
