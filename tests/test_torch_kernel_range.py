"""The network configs the CUDA kernels compute are checked where the network
is built (``models/nerf_network.check_kernel_range``): on a CUDA device a
config whose encoding lies outside kernels A/B (a brick grid of D = 3 or 2,
F = 2 or 4) or K/L (a plain grid at F = 2, Takikawa at F = 2, 4, 8) raises
``ValueError`` naming the kernel before anything is allocated, so these
tests run without a card; the CPU, whose plain paths take every config,
still builds them. Every MLP is in range: kernel C takes the ones its
template does (hidden width 64, 1 or 2 hidden layers, ReLU, no output
activation, 1-128 inputs, 1-16 outputs), the GEMM route
(``ops/fused_mlp.gemm_mlp``) every other, chosen from the shapes when the
MLP is built (``MLP.route``). The check reads
the testbed's mode: the Image mode's grid is 2-D, and the SDF, Image and
Volume modes have one MLP with 1, 3 and 4 outputs."""

from pathlib import Path

import numpy as np
import pytest
import torch

from nerfshop_tpu_torch import testbed
from nerfshop_tpu_torch.config import default_nerf_config, load_network_config
from nerfshop_tpu_torch.models import encodings
from nerfshop_tpu_torch.models import mlp as tmlp
from nerfshop_tpu_torch.models.nerf_network import FIELD_SHAPES, build_nerf_network, check_kernel_range
from torch_one_thread import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CUDA = torch.device("cuda")


def _with(**blocks):
    cfg = default_nerf_config()
    for key, block in blocks.items():
        cfg[key] = {**cfg.get(key, {}), **block}
    return cfg


def field_mlp(cfg, mode):
    """The SDF, Image or Volume mode's one MLP as ``FieldModel.build`` makes
    it, on the CPU, without the encoding's tables (the Image one is 2^24
    rows a level)."""
    n_in, n_out = FIELD_SHAPES[mode]
    width = encodings.encoding_shape(dict(cfg["encoding"]), n_in)[0]
    return tmlp.build_network(dict(cfg.get("network", {})), width, n_out, device="cpu")


def _grid_2d(F):
    return _with(encoding={"otype": "Composite", "nested": [
        {"n_dims_to_encode": 1, "otype": "Identity"},
        {"otype": "HashGrid", "n_levels": 15, "n_features_per_level": F}]})


#: (label, config, the text the error names): encodings outside the kernels
OUTSIDE = (
    ("brick F=8", lambda: _with(encoding={"n_levels": 8, "n_features_per_level": 8}), "kernels B.*n_input_dims 3, n_features_per_level 8"),
    ("brick F=1", lambda: _with(encoding={"n_features_per_level": 1}), "kernels B.*n_input_dims 3, n_features_per_level 1"),
    ("2-D grid F=8", lambda: _grid_2d(8), "kernels B.*n_input_dims 2, n_features_per_level 8"),
    ("2-D grid F=1", lambda: _grid_2d(1), "kernels B.*n_input_dims 2, n_features_per_level 1"),
    # an .ingp snapshot's table of a tpu_hash_fast network: kernels K and L read F = 2 only
    ("plain F=4", lambda: {**load_network_config(ROOT / "configs/nerf/tpu_hash_fast.json"),
                           "encoding": {**load_network_config(ROOT / "configs/nerf/tpu_hash_fast.json")["encoding"],
                                        "layout": "plain"}}, "kernels K and L.*n_features_per_level 4"),
)


@pytest.mark.parametrize("label,make,match", OUTSIDE, ids=[o[0] for o in OUTSIDE])
def test_cuda_build_raises_before_allocating(label, make, match):
    cfg = make()
    with pytest.raises(ValueError, match=match):
        check_kernel_range(cfg, CUDA)
    # no CUDA here: an allocation on the card would raise another error first
    with pytest.raises(ValueError, match=match):
        build_nerf_network(cfg, device=CUDA)
    with pytest.raises(ValueError, match=match):
        testbed.Testbed(config=cfg, device="cuda")
    model = build_nerf_network(cfg, device=torch.device("cpu"))
    assert sum(p.numel() for p in model.parameters()) > 0
    check_kernel_range(cfg, "cpu")


#: (label, config, its grids (layout, D, F, L), the density and rgb MLPs'
#: routes): configs that raised before the F = 4 instances of kernels A, B,
#: F and J and the GEMM route, each now taken
INSIDE = (
    ("tpu_hash_fast F=4", lambda: load_network_config(ROOT / "configs/nerf/tpu_hash_fast.json"),
     [("brick", 3, 4, 8)], ("fused", "fused")),
    ("128-wide network", lambda: _with(network={"n_neurons": 128}), [("brick", 3, 2, 16)], ("gemm", "fused")),
    ("128-wide rgb network", lambda: _with(rgb_network={"n_neurons": 128}), [("brick", 3, 2, 16)], ("fused", "gemm")),
    ("3 hidden layers", lambda: _with(rgb_network={"n_hidden_layers": 3}), [("brick", 3, 2, 16)], ("fused", "gemm")),
    ("sigmoid output", lambda: _with(network={"output_activation": "Sigmoid"}), [("brick", 3, 2, 16)], ("gemm", "fused")),
    ("140-wide encoding", lambda: _with(encoding={"n_levels": 70}), [("brick", 3, 2, 70)], ("gemm", "fused")),
    ("2-D grid", lambda: _grid_2d(4), [("brick", 2, 4, 15)], ("fused", "fused")),
    ("tpu_flagship", lambda: load_network_config(ROOT / "configs/nerf/tpu_flagship.json"), [], ("gemm", "fused")),
)


@pytest.mark.parametrize("label,make,grids,routes", INSIDE, ids=[o[0] for o in INSIDE])
def test_cuda_build_takes_the_config(label, make, grids, routes):
    # the check passes for the card; the grids are the kernels' instances;
    # the MLPs built (on the CPU) carry the route their shapes chose
    cfg = make()
    check_kernel_range(cfg, CUDA)
    assert encodings.encoding_shape(dict(cfg["encoding"]), 3)[1] == grids
    model = build_nerf_network(cfg, device=torch.device("cpu"))
    assert (model.density_mlp.route, model.rgb_mlp.route) == routes


@pytest.mark.parametrize("mode,encoding", [
    ("nerf", {"layout": "plain"}),  # an .ingp load's table: kernels K and L
    ("image", {"layout": "plain"}),
    ("sdf", {"otype": "Takikawa"}),  # JAX's defaults: 10 levels of 8 features, C at 80 inputs
    ("sdf", {"otype": "Takikawa", "n_features_per_level": 2, "sum_instead_of_concat": True}),
    ("sdf", {"otype": "Frequency"}),
    ("volume", {"otype": "OneBlob"}),
])
def test_kernel_range_takes_the_xor_and_elementwise_encodings(mode, encoding):
    cfg = load_network_config(ROOT / "configs" / mode / "base.json")
    cfg["encoding"] = {**cfg["encoding"], **encoding}
    check_kernel_range(cfg, CUDA, mode)


@pytest.mark.parametrize("config", [None, "base.json"])
def test_kernel_range_takes_the_default_configs(config):
    cfg = default_nerf_config() if config is None else load_network_config(ROOT / "configs/nerf" / config)
    check_kernel_range(cfg, CUDA)
    model = build_nerf_network(cfg, device=torch.device("cpu"))
    assert (model.density_mlp.route, model.rgb_mlp.route) == ("fused", "fused")


@pytest.mark.parametrize("mode", ["sdf", "image", "volume"])
def test_kernel_range_takes_the_mode_configs(mode):
    # each shipped config of the other modes, and the mode's default
    from nerfshop_tpu_torch import config as tconfig

    for cfg in (load_network_config(ROOT / "configs" / mode / "base.json"), getattr(tconfig, f"default_{mode}_config")()):
        check_kernel_range(cfg, CUDA, testbed.TestbedMode(mode))
        assert field_mlp(cfg, mode).route == "fused"


@pytest.mark.parametrize("mode,change,match", [
    ("image", {"encoding": {"n_features_per_level": 8}}, "n_input_dims 2, n_features_per_level 8"),
    ("volume", {"encoding": {"n_features_per_level": 1}}, "n_input_dims 3, n_features_per_level 1"),
    ("sdf", {"encoding": {"otype": "Takikawa", "n_features_per_level": 3}}, "Takikawa.*n_features_per_level 3"),
    ("sdf", {"encoding": {"layout": "paired"}}, "paired"),
])
def test_mode_configs_outside_raise(mode, change, match):
    cfg = load_network_config(ROOT / "configs" / mode / "base.json")
    for key, block in change.items():
        cfg[key] = {**cfg[key], **block}
    error = NotImplementedError if "paired" in match else ValueError
    with pytest.raises(error, match=match):
        check_kernel_range(cfg, CUDA, mode)
    with pytest.raises(error, match=match):
        testbed.Testbed(mode, config=cfg, device="cuda")
    check_kernel_range(cfg, "cpu", mode)


@pytest.mark.parametrize("mode,change,route", [
    ("image", {"encoding": {"n_features_per_level": 4}}, "fused"),  # kernels B and A at D = 2, F = 4
    ("sdf", {"network": {"n_hidden_layers": 3}}, "gemm"),
    ("volume", {"encoding": {"n_levels": 70}}, "gemm"),  # 140 inputs
])
def test_mode_configs_inside(mode, change, route):
    cfg = load_network_config(ROOT / "configs" / mode / "base.json")
    for key, block in change.items():
        cfg[key] = {**cfg[key], **block}
    check_kernel_range(cfg, CUDA, mode)
    assert field_mlp(cfg, mode).route == route


@pytest.mark.parametrize("otype,cfg,n_in", [
    ("HashGrid", {"n_levels": 8, "n_features_per_level": 4}, 3),
    ("SphericalHarmonics", {"degree": 3}, 3),
    ("Composite", {"nested": [{"n_dims_to_encode": 3, "otype": "SphericalHarmonics", "degree": 4}, {"otype": "Identity"}]}, 3),
    ("Composite", {"nested": [{"n_dims_to_encode": 1, "otype": "Identity"}, {"otype": "DenseGrid", "n_levels": 2}]}, 3),
])
def test_encoding_shape_matches_built_encoding(otype, cfg, n_in):
    cfg = {"otype": otype, **cfg}
    width, grids = encodings.encoding_shape(cfg, n_in)
    built = encodings.build_encoding(cfg, n_in, 1.5, device="cpu")
    assert width == built.n_output_dims
    mods = [m for m in built.modules() if isinstance(m, encodings.GridEncoding)]
    assert grids == [(m.layout, m.n_input_dims, m.n_features_per_level, m.n_levels) for m in mods]


def test_snapshot_of_an_unsupported_config_fails_at_load(tmp_path):
    # a brick grid at F = 8 (outside kernels B and A), saved from the CPU
    cfg = _with(encoding={"n_levels": 4, "n_features_per_level": 8, "log2_hashmap_size": 12})
    src = testbed.Testbed(config=cfg, device="cpu", seed=0)
    path = tmp_path / "f8.snap"
    src.save_snapshot(str(path))
    tb = testbed.Testbed(device="cpu", seed=1)
    before = dict(tb._network_config)
    tb.device = CUDA  # what a testbed on the card checks; nothing reaches the card
    with pytest.raises(ValueError, match="n_features_per_level 8"):
        tb.load_snapshot(str(path))
    assert dict(tb._network_config) == before  # the testbed was left as it was
    tb.device = torch.device("cpu")
    tb.load_snapshot(str(path))
    assert tb.model.pos_encoding.n_features_per_level == 8
    np.testing.assert_array_equal(
        tb.model.pos_encoding.table.detach().numpy(), src.model.pos_encoding.table.detach().numpy()
    )
