"""The Takikawa octree encoding in the port's SDF testbed: the triangle octree
(``nerfshop_tpu_torch/geometry/triangle_octree.py``) equal to JAX's level
for level, bool for bool, and ``SdfTestbed`` with a Takikawa config held to
JAX's: the octree built over the normalised mesh, the field, and a training
step from JAX's weights, Adam moments and draws; the CLI in SDF mode with a
Takikawa config, whose network waits for the mesh. On the CPU the encode is
kernel K's plain version and its backward kernel L's."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfshop_tpu.geometry.triangle_octree import TriangleOctree as JOctree
from nerfshop_tpu.train import sdf as jsdf
from nerfshop_tpu_torch import run as trun
from nerfshop_tpu_torch import weights
from nerfshop_tpu_torch.geometry import mesh_io as tmesh_io
from nerfshop_tpu_torch.geometry.triangle_octree import TriangleOctree as TOctree
from nerfshop_tpu_torch.models.encodings import TakikawaEncoding
from nerfshop_tpu_torch.testbed import Testbed
from nerfshop_tpu_torch.train import sdf as tsdf

from test_torch_sdf import CONFIG, _draws, _t, bumpy_icosphere
from torch_one_thread import one_thread  # noqa: F401

#: CONFIG's network, loss and optimizer with a Takikawa encoding: 3 levels
#: from depth 3 (sizes 736, 4920 and 8192 of 2^13, the middle one not a
#: power of two), 8 features
TAKIKAWA = {**CONFIG, "encoding": {"otype": "Takikawa", "n_levels": 3, "starting_level": 3, "n_features_per_level": 8,
                                   "log2_hashmap_size": 13}}
BATCH = 2048


@pytest.mark.parametrize("depth", [6, 12])
def test_octree_levels_equal_jax(depth):
    m = bumpy_icosphere()
    j = JOctree.build(m.vertices, m.faces, depth)
    t = TOctree.build(m.vertices, m.faces, depth)
    assert t.depth == j.depth and len(t.levels) == len(j.levels) == min(depth, 8) + 1
    for a, b in zip(t.levels, j.levels):
        assert a.dtype == b.dtype == bool
        np.testing.assert_array_equal(a, b)
    assert t.n_vertices == j.n_vertices
    for d in (0, 3, depth, depth + 2):
        np.testing.assert_array_equal(t.occupancy_at_depth(d), j.occupancy_at_depth(d))
    pts = np.random.default_rng(0).uniform(0, 1, (500, 3))
    np.testing.assert_array_equal(t.contains(pts, depth), j.contains(pts, depth))


@pytest.fixture(scope="module")
def trained():
    """A JAX SDF testbed with the Takikawa config trained 20 steps, and the
    port's with its weights and Adam moments."""
    mesh = bumpy_icosphere()
    jtb = jsdf.SdfTestbed.create(TAKIKAWA, mesh, jax.random.PRNGKey(0))
    jtb.train(20, batch_size=BATCH)
    ttb = tsdf.SdfTestbed.create(TAKIKAWA, mesh, torch.device("cpu"), torch.Generator().manual_seed(0))
    ttb.model.load_state_dict(weights.field_params_from_jax(jax.tree.map(np.asarray, jtb.state.params)))
    adam = next(st for st in jtb.state.opt_state if hasattr(st, "mu"))
    for (_, p), m, v in zip(ttb.model.named_parameters(), jax.tree.leaves(adam.mu), jax.tree.leaves(adam.nu)):
        st = ttb.state.optimizer.state[p]
        st["exp_avg"].copy_(_t(np.asarray(m)))
        st["exp_avg_sq"].copy_(_t(np.asarray(v)))
        st["step"].fill_(20.0)
    ttb.state.step = ttb.step = 20
    return jtb, ttb


def test_octree_and_encoding_built_as_jax(trained):
    jtb, ttb = trained
    enc_j, enc_t = jtb.model.encoding, ttb.model.encoding
    assert isinstance(enc_t, TakikawaEncoding)
    assert enc_t.level_sizes == enc_j.level_sizes == [736, 4920, 8192]
    assert enc_t.octree.depth == enc_j.octree.depth == 6
    for a, b in zip(enc_t.octree.levels, enc_j.octree.levels):
        np.testing.assert_array_equal(a, b)


def test_field_and_train_step_match(trained):
    # the field within 1e-5; one step from the same weights, moments and
    # JAX's draws: the loss within 1e-5 relative, the params within 1e-4
    jtb, ttb = trained
    pts = np.random.default_rng(1).uniform(-0.05, 1.05, (2000, 3)).astype(np.float32)
    # F20: JAX's encoding cached its masks while the step was traced, so the
    # cache holds that trace's tracers; a fresh cache for this call
    jtb.model.encoding._masks = None
    ref = np.asarray(jtb.model.apply(jtb.state.params, jnp.asarray(pts)))
    with torch.no_grad():
        ours = ttb.model.apply(ttb.state.inference_params, _t(pts)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    k = jax.random.split(jtb.rng)[1]
    pos, target = ttb._sample_batch(BATCH, _draws(k, BATCH, ttb.zero_offset))
    jloss = jtb.train(1, batch_size=BATCH)
    loss = float(ttb.train_step(pos, target))
    assert loss == pytest.approx(jloss, rel=1e-5)
    ref = weights.field_params_from_jax(jax.tree.map(np.asarray, jtb.state.params))
    for name, p in ttb.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=0, atol=1e-4, err_msg=name)


def test_takikawa_needs_a_mesh():
    with pytest.raises(ValueError, match="requires a mesh"):
        tsdf.SdfTestbed.create(TAKIKAWA, None, torch.device("cpu"), torch.Generator())
    # the Testbed waits for the mesh (JAX's create raises at the config)
    tb = Testbed("sdf", config=TAKIKAWA, device="cpu", seed=0)
    assert tb._state is None


def test_cli_trains_a_takikawa_config(tmp_path):
    obj = tmp_path / "bumpy.obj"
    tmesh_io.save_obj(obj, tmesh_io.TriMesh(*(np.asarray(a) for a in (bumpy_icosphere().vertices, bumpy_icosphere().faces))))
    (tmp_path / "taki.json").write_text(json.dumps(TAKIKAWA))
    tb = trun.main(["--mode", "sdf", "--network", str(tmp_path / "taki.json"), "--scene", str(obj), "--n_steps", "3",
                    "--batch_size", "1024", "--device", "cpu"])
    assert tb.stats.step == 3 and np.isfinite(tb.stats.loss)
    assert isinstance(tb.model.encoding, TakikawaEncoding)
    img = tb.render(16, 12)
    assert img.shape == (12, 16, 4) and np.isfinite(img).all()


@pytest.mark.xfail(strict=True, raises=jax.errors.UnexpectedTracerError, reason=(
    "F20 (reference fault): TakikawaEncoding._mask_arrays caches its masks on first use "
    "(nerfshop_tpu/models/encodings.py:483-490); inside the jitted training step that cache holds the trace's "
    "tracers, so an apply outside it after training raises"))
def test_jax_takikawa_applies_after_training():
    jtb = jsdf.SdfTestbed.create(TAKIKAWA, bumpy_icosphere(), jax.random.PRNGKey(1))
    jtb.train(1, batch_size=256)
    jtb.model.apply(jtb.state.params, jnp.full((4, 3), 0.5))
