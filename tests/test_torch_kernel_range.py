"""The network configs the CUDA kernels compute are checked where the network
is built (``models/nerf_network.check_kernel_range``): on a CUDA device a
config outside kernels A/B (a grid of D = 3 or 2, F = 2) or kernel C (the
fused MLP's widths and depth) raises ``ValueError`` naming the kernel before
anything is allocated, so these tests run without a card; the CPU, whose
plain paths take every config, still builds them. The check reads the
testbed's mode: the Image mode's grid is 2-D, and the SDF, Image and Volume
modes have one MLP with 1, 3 and 4 outputs."""

from pathlib import Path

import numpy as np
import pytest
import torch

from nerfshop_tpu_torch import testbed
from nerfshop_tpu_torch.config import default_nerf_config, load_network_config
from nerfshop_tpu_torch.models import encodings
from nerfshop_tpu_torch.models.nerf_network import build_nerf_network, check_kernel_range
from torch_one_thread import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CUDA = torch.device("cuda")


def _with(**blocks):
    cfg = default_nerf_config()
    for key, block in blocks.items():
        cfg[key] = {**cfg.get(key, {}), **block}
    return cfg


#: (label, config, the text the error names)
OUTSIDE = (
    ("tpu_hash_fast F=4", lambda: load_network_config(ROOT / "configs/nerf/tpu_hash_fast.json"), "n_features_per_level 4"),
    ("128-wide network", lambda: _with(network={"n_neurons": 128}), "density MLP.*kernel C.*hidden width 128"),
    ("128-wide rgb network", lambda: _with(rgb_network={"n_neurons": 128}), "rgb MLP.*kernel C.*hidden width 128"),
    ("3 hidden layers", lambda: _with(rgb_network={"n_hidden_layers": 3}), "kernel C.*3 hidden layers"),
    ("sigmoid output", lambda: _with(network={"output_activation": "Sigmoid"}), "kernel C.*output activation"),
    ("140-wide encoding", lambda: _with(encoding={"n_levels": 70}), "kernel C.*input width 140"),
    # a 2-D grid is in B's and A's range since they took D = 2 (the Image
    # testbed); F = 4 in one is not
    ("2-D grid", lambda: _with(encoding={"otype": "Composite", "nested": [
        {"n_dims_to_encode": 1, "otype": "Identity"},
        {"otype": "HashGrid", "n_levels": 15, "n_features_per_level": 4}]}), "n_input_dims 2, n_features_per_level 4"),
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


@pytest.mark.parametrize("mode", ["sdf", "image", "volume"])
def test_kernel_range_takes_the_mode_configs(mode):
    # each shipped config of the other modes, and the mode's default
    from nerfshop_tpu_torch import config as tconfig

    check_kernel_range(load_network_config(ROOT / "configs" / mode / "base.json"), CUDA, mode)
    check_kernel_range(getattr(tconfig, f"default_{mode}_config")(), CUDA, testbed.TestbedMode(mode))


@pytest.mark.parametrize("mode,change,match", [
    ("image", {"encoding": {"n_features_per_level": 4}}, "n_input_dims 2, n_features_per_level 4"),
    ("sdf", {"network": {"n_hidden_layers": 3}}, "MLP.*kernel C.*3 hidden layers"),
    ("volume", {"encoding": {"n_levels": 70}}, "MLP.*kernel C.*input width 140"),
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
    cfg = load_network_config(ROOT / "configs/nerf/tpu_hash_fast.json")
    src = testbed.Testbed(config=cfg, device="cpu", seed=0)
    path = tmp_path / "f4.snap"
    src.save_snapshot(str(path))
    tb = testbed.Testbed(device="cpu", seed=1)
    before = dict(tb._network_config)
    tb.device = CUDA  # what a testbed on the card checks; nothing reaches the card
    with pytest.raises(ValueError, match="n_features_per_level 4"):
        tb.load_snapshot(str(path))
    assert dict(tb._network_config) == before  # the testbed was left as it was
    tb.device = torch.device("cpu")
    tb.load_snapshot(str(path))
    assert tb.model.pos_encoding.n_features_per_level == 4
    np.testing.assert_array_equal(
        tb.model.pos_encoding.table.detach().numpy(), src.model.pos_encoding.table.detach().numpy()
    )
