"""The edit path of the port against the JAX package: ``render_frame``
through an operator stack, the grid refresh's density with the −1 kill
sentinel, edits files in both directions, and the ``Testbed`` edit API.

Weights move with ``params_from_jax`` and operators with
``operators_from_jax`` (built once by the JAX host code); both renderers
see the same grid. A sample whose tet lookup is a near tie (see
``test_torch_editing.py``) may warp differently in the two packages; the
frames hold to the bound of the unedited render parity with lenses: 1e-4
on 99% of values and 1e-3 on all."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfshop_tpu.editing import operators as jops
from nerfshop_tpu.editing import serialization as jser
from nerfshop_tpu.editing.cage import Cage as JCage
from nerfshop_tpu.editing.tet_mesh import TetMesh as JTetMesh
from nerfshop_tpu.models import nerf_network as jnn
from nerfshop_tpu.ops import coords as jcoords
from nerfshop_tpu.ops import grid as jgrid
from nerfshop_tpu.render import renderer as jrender
from nerfshop_tpu.train import nerf as jtrain
from nerfshop_tpu_torch import weights
from nerfshop_tpu_torch.editing import operators as tops
from nerfshop_tpu_torch.editing import serialization as tser
from nerfshop_tpu_torch.models import nerf_network as tnn
from nerfshop_tpu_torch.ops import coords as tcoords
from nerfshop_tpu_torch.ops import grid as tgrid
from nerfshop_tpu_torch.render import renderer as trender
from nerfshop_tpu_torch.train import nerf as ttrain
from test_bvh import cube_mesh
from test_torch_editing import _stack_ambiguous
from test_torch_render import CENTER, CFG, look_at, seeded_density
from torch_one_thread import one_thread  # noqa: F401

CPU = torch.device("cpu")
W = H = 32


@pytest.fixture(scope="module")
def scene():
    jm = jnn.build_nerf_network(CFG)
    tree = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    tree["pos_encoding"]["table"] = rng.uniform(-1, 1, tree["pos_encoding"]["table"].shape).astype(np.float32)
    tree["density_mlp"]["weights"][-1][:, 0] *= 3.0
    tm = tnn.build_nerf_network(CFG)
    tm.load_state_dict(weights.params_from_jax(tree))
    dens = seeded_density()
    jg = jgrid.update_bitfield(jgrid.OccupancyGrid.create(1)._replace(density=jnp.asarray(dens)))
    tg = tgrid.OccupancyGrid(torch.from_numpy(dens), torch.from_numpy(np.asarray(jg.occupancy).copy()),
                             torch.tensor(float(jg.mean_density)))
    return jm, jax.tree.map(jnp.asarray, tree), jg, tm, tg


@pytest.fixture(scope="module")
def jax_stack():
    """[translated cube cage, affine duplicate of the moved content], built
    by the JAX host code, and the identity cage of the same tet mesh."""
    mesh = cube_mesh(0.2, 0.8)
    jtm = JTetMesh.from_cage(JCage.from_mesh(mesh), ideal_edge=0.15)
    identity = jops.CageDeformationOp.from_tet_mesh(jtm, lut_res=24)
    cage = JCage.from_mesh(mesh)
    cage.translate(np.array([0.12, 0.0, 0.0], np.float32))
    moved = JTetMesh(jtm.vertices_original, jtm.vertices_deformed.copy(), jtm.tets, jtm.mvc_weights,
                     cage_vertex_id=jtm.cage_vertex_id)
    moved.update_deformed(cage)
    cage_op = jops.CageDeformationOp.from_tet_mesh(moved, lut_res=24)
    dup = jops.AffineDuplicationOp.create(center=[0.62, 0.5, 0.5], half_extents=[0.2, 0.2, 0.2],
                                          transform_t=[-0.3, 0.05, 0.1])
    return [cage_op, dup], identity


def _render(scene, operators, torch_ops=None, eye=(1.1, -0.9, 0.4), **opts_kw):
    jm, jparams, jg, tm, tg = scene
    xf = look_at(CENTER + np.array(eye, np.float32))
    # no grid early stop: the slots reach below the dense ball's surface,
    # into the cage
    base = dict(k_samples=32, n_windows=2, n_candidates=512, chunk=256, use_grid_early_stop=False)
    base.update(opts_kw)
    f, p = np.array([28.0, 28.0], np.float32), np.array([0.5, 0.5], np.float32)
    ref = jrender.render_frame(jm, jparams, jg, (W, H), jnp.asarray(xf), jnp.asarray(f), jnp.asarray(p),
                               opts=jrender.RenderOptions(**base), operators=tuple(operators))
    tops_ = weights.operators_from_jax(operators, CPU) if torch_ops is None else torch_ops
    ours = trender.render_frame(tm, None, tg, (W, H), torch.from_numpy(xf), torch.from_numpy(f), torch.from_numpy(p),
                                opts=trender.RenderOptions(**base), operators=tuple(tops_))
    return np.asarray(ref.rgba), np.asarray(ref.depth), ours.rgba.numpy(), ours.depth.numpy()


def _close(ours, ref):
    err = np.abs(ours - ref)
    assert (err <= 1e-4).mean() >= 0.99 and err.max() <= 1e-3, (err.max(), (err > 1e-4).mean())


def test_render_through_stack_matches_jax(scene, jax_stack):
    stack, _ = jax_stack
    jr, jd, tr, td = _render(scene, stack)
    _, _, plain, _ = _render(scene, [])
    assert tr.shape == (H, W, 4) and np.isfinite(tr).all()
    _close(tr, jr)
    _close(td, jd)
    assert np.abs(tr - plain).max() > 0.05  # the stack changed the frame


def test_identity_cage_frame_equals_unedited(scene, jax_stack):
    # the delta-form warp moves no position; directions go through the
    # identity rotations (SVD round-off, ~1e-7) and a renormalization, which
    # is where the last ulps of rgb come from
    _, identity = jax_stack
    (top,) = weights.operators_from_jax([identity], CPU)
    jm, jparams, jg, tm, tg = scene
    xf = torch.from_numpy(look_at(CENTER + np.array([1.1, -0.9, 0.4], np.float32)))
    opts = trender.RenderOptions(k_samples=32, n_windows=2, n_candidates=512, chunk=256, use_grid_early_stop=False)
    f = torch.tensor([28.0, 28.0])
    plain = trender.render_frame(tm, None, tg, (W, H), xf, f, opts=opts)
    ident = trender.render_frame(tm, None, tg, (W, H), xf, f, opts=opts, operators=(top,))
    np.testing.assert_allclose(ident.rgba.numpy(), plain.rgba.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ident.depth.numpy(), plain.depth.numpy())


def test_operator_with_membrane_raises(scene, jax_stack):
    # the membrane renders (test_torch_membrane.py); a membrane that is not
    # a poisson.MembraneData raises
    _, _, _, tm, tg = scene
    (top,) = weights.operators_from_jax([jax_stack[1]], CPU)
    xf = torch.from_numpy(look_at(CENTER + np.array([1.1, -0.9, 0.4], np.float32)))
    with pytest.raises(TypeError, match="MembraneData"):
        trender.render_frame(tm, None, tg, (8, 8), xf, torch.tensor([8.0, 8.0]), operators=(top._replace(membrane=object()),))


def test_density_with_kill_matches_jax(scene, jax_stack):
    stack, _ = jax_stack
    jm, jparams, jg, tm, tg = scene
    rng = np.random.default_rng(2)
    pos = rng.uniform(0.1, 0.9, (6000, 3)).astype(np.float32)
    # the refresh reads a parameter set of its own (the EMA copy)
    ema_tree = jax.tree.map(lambda a: np.asarray(a) * 0.9, jparams)
    jfn = jtrain.make_density_fn(jm, jax.tree.map(jnp.asarray, ema_tree), jcoords.BoundingBox.unit(), tuple(stack))
    tfn = ttrain.make_density_fn(tm, tcoords.BoundingBox.from_aabb_scale(1, device=CPU),
                                 tuple(weights.operators_from_jax(stack, CPU)), weights.params_from_jax(ema_tree))
    ref = np.asarray(jfn(jnp.asarray(pos)))
    ours = tfn(torch.from_numpy(pos)).detach().numpy()
    src = np.asarray(jops.affine_map_positions(stack[1], jnp.asarray(pos))[0])
    ok = ~_stack_ambiguous(stack[0], src)
    kill = ref == -1.0
    assert kill[ok].any() and (~kill[ok]).any()
    np.testing.assert_array_equal(ours[ok] == -1.0, kill[ok])
    live = ok & ~kill
    np.testing.assert_allclose(ours[live], ref[live], rtol=1e-5, atol=0)
    # without operators and params: the model's own density, no kill
    plain = ttrain.make_density_fn(tm, tcoords.BoundingBox.from_aabb_scale(1, device=CPU))(torch.from_numpy(pos))
    assert (plain.detach().numpy() > 0).all()


def test_edits_files_move_both_ways(tmp_path, jax_stack):
    stack, _ = jax_stack
    jser.save_edits(tmp_path / "jax.json", stack, {"mode": "nerf"})
    ours = tser.load_edits(tmp_path / "jax.json", CPU)
    tser.save_edits(tmp_path / "port.json", ours, {"mode": "nerf"})
    back = jser.load_edits(tmp_path / "port.json")
    assert [type(o).__name__ for o in ours] == [type(o).__name__ for o in back] == ["CageDeformationOp", "AffineDuplicationOp"]
    for j, t, b in zip(stack, ours, back):
        for f in type(j)._fields:
            if f == "membrane":
                continue
            jv, tv, bv = getattr(j, f), getattr(t, f), getattr(b, f)
            if f.startswith("lut_"):
                assert tv.res == jv.res == bv.res
                for a in ("bbox_lo", "inv_cell", "cells"):
                    np.testing.assert_array_equal(getattr(tv, a).numpy(), np.asarray(getattr(jv, a)))
                    np.testing.assert_array_equal(np.asarray(getattr(bv, a)), np.asarray(getattr(jv, a)))
            else:
                tv = tv.numpy() if isinstance(tv, torch.Tensor) else np.asarray(tv)
                np.testing.assert_array_equal(tv, np.asarray(jv), err_msg=f)
                np.testing.assert_array_equal(np.asarray(bv), np.asarray(jv), err_msg=f)
    # the port's own round trip is bit-equal too
    again = tser.load_edits(tmp_path / "port.json", CPU)
    for t, a in zip(ours, again):
        for f in tops.CAGE_ARRAYS if isinstance(t, tops.CageDeformationOp) else tops.AFFINE_ARRAYS:
            assert torch.equal(getattr(t, f), getattr(a, f))


def test_testbed_edit_api_on_cpu(tmp_path):
    from nerfshop_tpu_torch.testbed import Testbed

    tb = Testbed(config=CFG, device="cpu", seed=0)
    with torch.no_grad():
        tb.model.pos_encoding.table.uniform_(-1.0, 1.0)
    tb.grid.density.copy_(torch.from_numpy(seeded_density()))
    tgrid.update_bitfield(tb.grid)
    gs = tb.begin_cage_edit()
    gs.target_cage_vertices = 40  # a coarse cage keeps the CPU lookups cheap
    g = (np.arange(128) + 0.5) / 128
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    gs.set_selection((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2 < 0.12**2, level=0)
    cage = gs.compute_proxy()
    assert 10 < cage.n_vertices <= 40
    tm = gs.extract_cage()
    assert tm.n_tets > 10
    gs.transform_cage_group(offset=(0.08, 0.0, 0.0))
    before = tb.grid.density.clone()
    op = gs.make_operator()
    tb.add_edit_operator(op)
    assert len(tb.edit_operators) == 1
    # vacated source cells of the dense ball were cleared by the −1
    # sentinel (the EMA decay alone never reaches 0)
    assert bool(((before > 300) & (tb.grid.density == 0)).any())
    img = tb.render(24, 16, exact=True)
    assert img.shape == (16, 24, 4) and np.isfinite(img).all()
    tb.save_edits(tmp_path / "edits.json")
    tb.remove_edit_operator(0)
    assert not tb.edit_operators
    tb.load_edits(tmp_path / "edits.json")
    (loaded,) = tb.edit_operators
    for f in tops.CAGE_ARRAYS:
        assert torch.equal(getattr(loaded, f), getattr(op, f))
    assert torch.equal(loaded.lut_def.cells, op.lut_def.cells) and loaded.copy_mode == op.copy_mode
    # the membrane: kept on the selection, attached by make_operator,
    # rendered, and refused by save_edits (the edits file cannot hold it)
    gs.compute_membrane(tb.inference_params, torch.Generator().manual_seed(0), grid=tb.grid)
    with_membrane = gs.make_operator()
    assert with_membrane.membrane is gs.membrane and gs.membrane.packed.shape == (tm.n_tets, 120)
    tb.replace_edit_operator(0, with_membrane)
    img = tb.render(24, 16, exact=True)
    assert img.shape == (16, 24, 4) and np.isfinite(img).all()
    with pytest.raises(ValueError, match="membrane"):
        tb.save_edits(tmp_path / "edits2.json")
    gs.clear_membrane()
    assert gs.make_operator().membrane is None
    # vanish: a new grid, empty around the deformed tets
    vanished = gs.vanish(tb.grid)
    assert vanished is not tb.grid and int((vanished.density == 0).sum()) > int((tb.grid.density == 0).sum())


def test_scribble_projection_matches_jax(scene):
    from nerfshop_tpu.editing import selection as jsel
    from nerfshop_tpu.ops import rays as jrays
    from nerfshop_tpu_torch.editing import selection as tsel

    jm, jparams, jg, tm, tg = scene
    xf = look_at(CENTER + np.array([1.1, -0.9, 0.4], np.float32))
    b = jrays.rays_for_image((16, 16), jnp.asarray(xf), jnp.asarray([14.0, 14.0]), jnp.asarray([0.5, 0.5]))
    o, d = np.array(b.origins), np.array(b.directions)
    jh, jp, jc = jsel.project_selection_rays(jm, jparams, jg, o, d, jcoords.BoundingBox.unit())
    th, tp, tc = tsel.project_selection_rays(tm, None, tg, o, d, tcoords.BoundingBox.from_aabb_scale(1, device=CPU))
    assert 0 < jh.sum() < len(jh)
    np.testing.assert_array_equal(th, jh)
    np.testing.assert_allclose(tp[jh], jp[jh], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tc[jh], jc[jh])
