"""The port's editing core (``nerfshop_tpu_torch/editing``, ``geometry/bvh``)
against the JAX package on the same cages and the same seeded points:
MVC weights, signed distances, the tet mesh and its LUT, the tet lookup
(the plain version of kernel E) and the warps of both operator kinds.

Cage operators are built once by the JAX host code and carried across with
``weights.operators_from_jax``, so that a threshold flip in a host build
cannot hide a device mismatch. Lookups and warps are held to JAX except at
near ties: where the two best candidate scores, or the best score and the
threshold, lie within 1e-6 (fp32 sums in another order may flip those)."""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfshop_tpu.editing import mvc as jmvc
from nerfshop_tpu.editing import operators as jops
from nerfshop_tpu.editing import selection as jsel
from nerfshop_tpu.editing.cage import Cage as JCage
from nerfshop_tpu.editing.tet_mesh import TetMesh as JTetMesh
from nerfshop_tpu.geometry import bvh as jbvh
from nerfshop_tpu_torch import weights
from nerfshop_tpu_torch.editing import mvc as tmvc
from nerfshop_tpu_torch.editing import operators as tops
from nerfshop_tpu_torch.editing import selection as tsel
from nerfshop_tpu_torch.editing.cage import Cage as TCage
from nerfshop_tpu_torch.editing.tet_mesh import TetMesh as TTetMesh
from nerfshop_tpu_torch.geometry import bvh as tbvh
from nerfshop_tpu_torch.geometry.mesh_io import TriMesh as TTriMesh
from test_bvh import cube_mesh, icosphere
from test_concave_cage import _l_shape_cage
from torch_one_thread import one_thread  # noqa: F401

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
TIE = 1e-6

CAGES = {
    "cube": lambda: cube_mesh(0.3, 0.7),
    "sphere": lambda: icosphere(subdiv=2, radius=0.35),
    "lshape": _l_shape_cage,
}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cage_points(mesh, n=300, seed=0):
    """Inside and outside points, the cage's own vertices and points on faces."""
    rng = np.random.default_rng(seed)
    v = mesh.vertices
    lo, hi = v.min(0), v.max(0)
    pts = rng.uniform(lo - 0.1, hi + 0.1, (n, 3))
    fv = v[mesh.faces[:8]]
    on_face = (fv * np.array([0.2, 0.3, 0.5])[None, :, None]).sum(1)
    return np.concatenate([pts, v[:4], on_face]).astype(np.float32)


@pytest.mark.parametrize("name", list(CAGES))
def test_mvc_weights_match(name):
    # points at least 0.005 inside, the cage's vertices and points on its
    # faces (the points the pipeline asks about: tet vertices); closer to a
    # face from inside, or outside the cage, sin/arcsin ulps between XLA and
    # torch are amplified to a few 1e-5
    mesh = CAGES[name]()
    pts = _cage_points(mesh, n=600)
    sd = np.asarray(jbvh.signed_distance(jbvh.build_bvh(mesh.vertices, mesh.faces), jnp.asarray(pts)))
    pts = pts[(sd < -0.005) | (np.abs(sd) < 1e-9)]
    assert len(pts) > 100
    ref = np.asarray(jmvc.mvc_weights(jnp.asarray(pts), jnp.asarray(mesh.vertices), jnp.asarray(mesh.faces)))
    ours = tmvc.mvc_weights(_t(pts), _t(mesh.vertices), _t(mesh.faces.astype(np.int64))).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    g_ref = np.asarray(jmvc.mvc_gamma_weights(jnp.asarray(pts), jnp.asarray(mesh.vertices), jnp.asarray(mesh.faces), gamma=2.0))
    g = tmvc.mvc_gamma_weights(_t(pts), _t(mesh.vertices), _t(mesh.faces.astype(np.int64)), gamma=2.0).numpy()
    np.testing.assert_allclose(g, g_ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", list(CAGES))
def test_signed_distance_matches_bvh(name):
    mesh = CAGES[name]()
    pts = _cage_points(mesh, n=400, seed=1)
    ref = np.asarray(jbvh.signed_distance(jbvh.build_bvh(mesh.vertices, mesh.faces), jnp.asarray(pts)))
    ours = tbvh.signed_distance(tbvh.build_triangles(mesh.vertices, mesh.faces, CPU), _t(pts)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
    clear = np.abs(ref) > 1e-6
    np.testing.assert_array_equal(np.sign(ours[clear]), np.sign(ref[clear]))
    assert (ref < 0).any() and (ref > 0).any()


def _port_tet_mesh(jtm):
    return TTetMesh(jtm.vertices_original.copy(), jtm.vertices_deformed.copy(), jtm.tets.copy())


@pytest.fixture(scope="module")
def tet_meshes():
    out = {}
    for name, kw in (("cube", dict(ideal_edge=0.1)), ("lshape", {})):
        mesh = CAGES[name]()
        jtm = JTetMesh.from_cage(JCage.from_mesh(mesh), **kw)
        ttm = TTetMesh.from_cage(TCage.from_mesh(TTriMesh(mesh.vertices, mesh.faces)), device=CPU, **kw)
        out[name] = (mesh, jtm, ttm)
    return out


@pytest.mark.parametrize("name", ["cube", "lshape"])
def test_tet_mesh_from_cage_matches(tet_meshes, name):
    _, jtm, ttm = tet_meshes[name]
    np.testing.assert_array_equal(ttm.vertices_original, jtm.vertices_original)
    np.testing.assert_array_equal(ttm.tets, jtm.tets)
    np.testing.assert_array_equal(ttm.cage_vertex_id, jtm.cage_vertex_id)
    np.testing.assert_allclose(ttm.mvc_weights, jtm.mvc_weights, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["cube", "lshape"])
def test_deformation_and_rotations_match(tet_meshes, name):
    mesh, jtm, _ = tet_meshes[name]
    ttm = _port_tet_mesh(jtm)
    ttm.mvc_weights, ttm.cage_vertex_id = jtm.mvc_weights.copy(), jtm.cage_vertex_id.copy()
    jc, tc = JCage.from_mesh(mesh), TCage.from_mesh(TTriMesh(mesh.vertices, mesh.faces))
    for c in (jc, tc):
        c.transform(np.array([[0.9, -0.2, 0.0, 0.1], [0.2, 0.9, 0.0, -0.05], [0.0, 0.0, 1.1, 0.0]], np.float32))
    jtm2 = JTetMesh(jtm.vertices_original, jtm.vertices_deformed.copy(), jtm.tets, jtm.mvc_weights,
                    cage_vertex_id=jtm.cage_vertex_id)
    jtm2.update_deformed(jc)
    ttm.update_deformed(tc)
    np.testing.assert_array_equal(ttm.vertices_deformed, jtm2.vertices_deformed)
    np.testing.assert_allclose(ttm.rotations, jtm2.rotations, rtol=0, atol=1e-6)
    for k, v in ttm.device_arrays(CPU).items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jtm2.device_arrays()[k]), err_msg=k)
    back = TTetMesh.from_json(ttm.to_json())
    np.testing.assert_array_equal(back.tets, ttm.tets)
    np.testing.assert_allclose(back.rotations, ttm.rotations, rtol=0, atol=1e-6)


@pytest.mark.parametrize("res,max_t", [(16, 24), (24, 4)])
@pytest.mark.parametrize("name", ["cube", "lshape"])
def test_voxelize_matches_numpy_path(tet_meshes, name, res, max_t):
    _, jtm, _ = tet_meshes[name]
    ttm = _port_tet_mesh(jtm)
    ref = jtm._voxelize(jtm.vertices_original, res, max_t, use_native=False)
    ours = ttm._voxelize(ttm.vertices_original, res, max_t)
    for a, b in zip(ours[:3], ref[:3]):
        np.testing.assert_array_equal(a, b)
    assert ours[3] == ref[3]
    lut_d, lut_o = ttm.build_luts(CPU, res=res, max_t=max_t)
    assert lut_d.cells.dtype == torch.int32 and lut_o.res == res
    assert lut_o.cells.shape[1] >= min(ref[3], 256)  # the fanout grew until nothing truncated


# ------------------------------------------------------------- lookup, warps


def _jax_op(tet_meshes, name, translate=(0.0, 0.0, 0.0), copy_mode=False, lut_res=24):
    mesh, jtm0, _ = tet_meshes[name]
    jtm = JTetMesh(jtm0.vertices_original, jtm0.vertices_original.copy(), jtm0.tets, jtm0.mvc_weights,
                   cage_vertex_id=jtm0.cage_vertex_id)
    cage = JCage.from_mesh(mesh)
    cage.translate(np.asarray(translate, np.float32))
    jtm.update_deformed(cage)
    return jops.CageDeformationOp.from_tet_mesh(jtm, copy_mode=copy_mode, lut_res=lut_res)


def _probe_points(lut, n=600, seed=3):
    """Points inside, on cell and tet boundaries, near the surface and
    outside the LUT box."""
    rng = np.random.default_rng(seed)
    lo = np.asarray(lut.bbox_lo)
    hi = lo + lut.res / np.asarray(lut.inv_cell)
    inside = rng.uniform(lo, hi, (n, 3))
    outside = rng.uniform(lo - 0.2, hi + 0.2, (n // 3, 3))
    edge = lo + (hi - lo) * rng.integers(0, 5, (n // 6, 3)) / 4.0
    return np.concatenate([inside, outside, edge]).astype(np.float32)


def _ambiguous(lut, v0, inv_e, p, eps, near_miss=0.08):
    """Points whose lookup can flip under fp32 reordering: the two best
    candidate scores, or the best score and the threshold, within TIE."""
    cells = np.asarray(lut.cells)
    v0 = np.asarray(v0, np.float64)
    inv_e = np.asarray(inv_e, np.float64)
    lo, ic = np.asarray(lut.bbox_lo, np.float64), np.asarray(lut.inv_cell, np.float64)
    thr = eps if eps > 0 else -near_miss
    out = np.zeros(len(p), bool)
    for i, q in enumerate(p.astype(np.float64)):
        c = np.floor((q - lo) * ic).astype(int)
        if (c < 0).any() or (c >= lut.res).any():
            continue
        cand = cells[(c[0] * lut.res + c[1]) * lut.res + c[2]]
        cand = cand[cand >= 0]
        if not len(cand):
            continue
        w = np.einsum("nij,nj->ni", inv_e[cand], q - v0[cand])
        s = np.sort(np.minimum(1 - w.sum(1), w.min(1)))[::-1]
        out[i] = abs(s[0] - thr) < TIE or (len(s) > 1 and s[0] - s[1] < TIE)
    return out


@pytest.mark.parametrize("eps", [-1e-5, 5e-3])
@pytest.mark.parametrize("name", ["cube", "lshape"])
def test_tet_lookup_plain_matches_jax(tet_meshes, name, eps):
    jop = _jax_op(tet_meshes, name, translate=(0.05, -0.03, 0.02))
    (top,) = weights.operators_from_jax([jop], CPU)
    for which in ("def", "orig"):
        jl, tl = getattr(jop, f"lut_{which}"), getattr(top, f"lut_{which}")
        jv0, jinv = getattr(jop, f"v0_{which}"), getattr(jop, f"inv_{which}")
        p = _probe_points(jl)
        jf, jt, jb = (np.asarray(a) for a in jops.tet_lookup(jl, jv0, jinv, jnp.asarray(p), eps=eps))
        tf, tt, tb = tops.tet_lookup(tl, getattr(top, f"v0_{which}"), getattr(top, f"inv_{which}"), _t(p), eps=eps)
        tf, tt, tb = tf.numpy(), tt.numpy(), tb.numpy()
        ok = ~_ambiguous(jl, jv0, jinv, p, eps)
        assert ok.mean() > 0.95 and jf.any() and not jf.all()
        np.testing.assert_array_equal(tf[ok], jf[ok])
        np.testing.assert_array_equal(tt[ok], jt[ok])
        same = ok & (tt == jt)
        np.testing.assert_allclose(tb[same], jb[same], rtol=0, atol=1e-5)
        assert tt.dtype == np.int32 and tb.shape == (len(p), 4)


def _stack_ambiguous(jop, p):
    amb = np.zeros(len(p), bool)
    for which, eps in (("def", -1e-5), ("orig", 5e-3), ("orig", -1e-5)):
        amb |= _ambiguous(getattr(jop, f"lut_{which}"), getattr(jop, f"v0_{which}"), getattr(jop, f"inv_{which}"), p, eps)
    return amb


@pytest.mark.parametrize("case", ["identity", "translated", "copy"])
@pytest.mark.parametrize("name", ["cube", "lshape"])
def test_cage_warps_match(tet_meshes, name, case):
    shift = (0.0, 0.0, 0.0) if case == "identity" else (0.12, 0.0, -0.04)
    jop = _jax_op(tet_meshes, name, translate=shift, copy_mode=case == "copy")
    (top,) = weights.operators_from_jax([jop], CPU)
    p = _probe_points(jop.lut_def, seed=5)
    rng = np.random.default_rng(6)
    d = rng.normal(size=p.shape).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ok = ~_stack_ambiguous(jop, p)

    jr = [np.asarray(a) for a in jops.cage_map_samples(jop, jnp.asarray(p), jnp.asarray(d))]
    tr = [a.numpy() for a in tops.cage_map_samples(top, _t(p), _t(d))]
    for a, b in zip(tr[:2], jr[:2]):
        np.testing.assert_allclose(a[ok], b[ok], rtol=0, atol=1e-5)
    for a, b in zip(tr[2:], jr[2:]):
        np.testing.assert_array_equal(a[ok], b[ok])
    assert jr[3][ok].any()
    if case == "translated":
        assert jr[2][ok].any()  # some source samples are vacated
    if case == "identity":
        np.testing.assert_allclose(tr[0][ok], p[ok], rtol=0, atol=1e-5)  # the delta form moves nothing

    jp, jk = (np.asarray(a) for a in jops.cage_map_positions(jop, jnp.asarray(p)))
    tp, tk = (a.numpy() for a in tops.cage_map_positions(top, _t(p)))
    np.testing.assert_allclose(tp[ok], jp[ok], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tk[ok], jk[ok])

    jp, js = (np.asarray(a) for a in jops.cage_map_forward(jop, jnp.asarray(p)))
    tp, ts = (a.numpy() for a in tops.cage_map_forward(top, _t(p)))
    np.testing.assert_allclose(tp[ok], jp[ok], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ts[ok], js[ok])
    np.testing.assert_array_equal(tops.cage_in_source(top, _t(p)).numpy()[ok], np.asarray(jops.cage_in_source(jop, jnp.asarray(p)))[ok])
    for a, b in zip(tops.operator_roi_aabb(top), jops.operator_roi_aabb(jop)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


AFFINE = dict(center=[0.45, 0.5, 0.5], half_extents=[0.12, 0.1, 0.15], rotation=None,
              transform_rot=[[0.0, -1.1, 0.0], [1.1, 0.0, 0.0], [0.0, 0.0, 1.1]], transform_t=[1.05, -0.2, 0.05])


@pytest.mark.parametrize("hide", [False, True])
def test_affine_maps_match(hide):
    jop = jops.AffineDuplicationOp.create(**AFFINE, hide_original=hide)
    top = tops.AffineDuplicationOp.create(**AFFINE, hide_original=hide, device=CPU)
    rng = np.random.default_rng(7)
    p = rng.uniform(0.0, 1.0, (2000, 3)).astype(np.float32)
    d = rng.normal(size=p.shape).astype(np.float32)
    jr = [np.asarray(a) for a in jops.affine_map_samples(jop, jnp.asarray(p), jnp.asarray(d))]
    tr = [a.numpy() for a in tops.affine_map_samples(top, _t(p), _t(d))]
    np.testing.assert_allclose(tr[0], jr[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(tr[1], jr[1], rtol=0, atol=1e-5)
    for a, b in zip(tr[2:], jr[2:]):
        np.testing.assert_array_equal(a, b)
    assert jr[3].any() and (jr[2].any() == hide)
    jp, jk = (np.asarray(a) for a in jops.affine_map_positions(jop, jnp.asarray(p)))
    tp, tk = (a.numpy() for a in tops.affine_map_positions(top, _t(p)))
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tk, jk)
    for a, b in zip(tops.operator_roi_aabb(top), jops.operator_roi_aabb(jop)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_two_operator_stack_newest_first(tet_meshes):
    jcage = _jax_op(tet_meshes, "cube", translate=(0.1, 0.0, 0.0))
    jaff = jops.AffineDuplicationOp.create(center=[0.6, 0.5, 0.5], half_extents=[0.25] * 3, transform_t=[-0.3, 0.0, 0.1])
    jstack = [jcage, jaff]
    tstack = weights.operators_from_jax(jstack, CPU)
    assert isinstance(tstack[1], tops.AffineDuplicationOp) and tstack[1].hide_original is False
    p = _probe_points(jcage.lut_def, seed=8)
    rng = np.random.default_rng(9)
    d = rng.normal(size=p.shape).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # the cage sees what the newer affine op made of each point
    src = np.asarray(jops.affine_map_samples(jaff, jnp.asarray(p), jnp.asarray(d))[0])
    ok = ~_stack_ambiguous(jcage, src) & ~_stack_ambiguous(jcage, p)
    jr = [np.asarray(a) for a in jops.map_samples_through_stack(jstack, jnp.asarray(p), jnp.asarray(d))]
    tr = [a.numpy() for a in tops.map_samples_through_stack(tstack, _t(p), _t(d))]
    np.testing.assert_allclose(tr[0][ok], jr[0][ok], rtol=0, atol=1e-5)
    np.testing.assert_allclose(tr[1][ok], jr[1][ok], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tr[2][ok], jr[2][ok])
    jp, jk = (np.asarray(a) for a in jops.map_positions_through_stack(jstack, jnp.asarray(p)))
    tp, tk = (a.numpy() for a in tops.map_positions_through_stack(tstack, _t(p)))
    np.testing.assert_allclose(tp[ok], jp[ok], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tk[ok], jk[ok])
    # the other order gives another result: the order matters
    other = tops.map_positions_through_stack(tstack[::-1], _t(p))[0].numpy()
    assert np.abs(other - tp).max() > 1e-3


def test_operators_round_trip_through_jax_form(tet_meshes):
    jop = _jax_op(tet_meshes, "lshape", translate=(0.0, 0.05, 0.0), copy_mode=True)
    ops = weights.operators_from_jax([jop, jops.AffineDuplicationOp.create(**AFFINE)], CPU)
    back = weights.operators_to_jax(ops)
    assert [b["type"] for b in back] == ["CageDeformationOp", "AffineDuplicationOp"]
    rebuilt = jops.CageDeformationOp(**{
        k: (jops.TetLut(**{a: (jnp.asarray(x) if a != "res" else x) for a, x in v.items()}) if k.startswith("lut_")
            else jnp.asarray(v)) for k, v in back[0].items() if k != "type"})
    for f in jops.CageDeformationOp._fields:
        if f in ("lut_def", "lut_orig"):
            for a in ("bbox_lo", "inv_cell", "cells"):
                np.testing.assert_array_equal(np.asarray(getattr(getattr(rebuilt, f), a)), np.asarray(getattr(getattr(jop, f), a)))
        elif f != "membrane":
            np.testing.assert_array_equal(np.asarray(getattr(rebuilt, f)), np.asarray(getattr(jop, f)))
    # a membrane comes across (test_torch_membrane.py); an object that is
    # not a MembraneData raises
    with pytest.raises(TypeError):
        weights.operators_from_jax([jop._replace(membrane=object())], CPU)


# --------------------------------------------------------------- selection


def test_region_growing_matches_python_bfs(monkeypatch):
    # the JAX package's Python BFS (its native flood fill switched off)
    # against the port's, its plain version (grow_plain; grow runs the
    # native library, test_torch_native.py), with n_steps cutting the
    # growth short and then letting it finish
    from nerfshop_tpu import native

    monkeypatch.setattr(native, "get_lib", lambda: None)
    rng = np.random.default_rng(10)
    dens = np.zeros((1, 128, 128, 128), np.float32)
    dens[0, 40:70, 50:80, 30:60] = rng.uniform(0, 0.03, (30, 30, 30))
    seeds = np.array([[0, 55, 60, 45], [0, 41, 51, 31]], np.int32)
    jr, tr = jsel.RegionGrowing(density=dens), tsel.RegionGrowing(density=dens)
    jr.reset(seeds)
    tr.reset(seeds)
    for n in (500, 10**7):
        assert tr.grow_plain(n) == jr.grow(n)
        np.testing.assert_array_equal(tr.selection, jr.selection)
        assert list(tr.queue) == list(jr.queue)
    assert 100 < tr.selection.sum() < 27000


def test_proxy_cage_pipeline_matches():
    g = (np.arange(128) + 0.5) / 128
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    sel = ((x - 0.5) ** 2 + (y - 0.45) ** 2 + (z - 0.5) ** 2 < 0.18**2) | ((np.abs(x - 0.65) < 0.1) & (np.abs(y - 0.5) < 0.05) & (np.abs(z - 0.5) < 0.2))
    sel = jsel.closing(sel)
    np.testing.assert_array_equal(tsel.closing(sel), jsel.closing(sel))
    jfine, tfine = jsel.extract_fine_mesh(sel, 0), tsel.extract_fine_mesh(sel, 0)
    np.testing.assert_array_equal(tfine.vertices, jfine.vertices)
    np.testing.assert_array_equal(tfine.faces, jfine.faces)
    jc = jsel.compute_proxy_cage(sel, 0, target_vertices=60)
    tc = tsel.compute_proxy_cage(sel, 0, CPU, target_vertices=60)
    np.testing.assert_array_equal(tc.faces, jc.faces)
    np.testing.assert_allclose(tc.vertices, jc.vertices, rtol=0, atol=1e-6)
    jb, tb = jsel.box_cage(sel, 0), tsel.box_cage(sel, 0)
    np.testing.assert_array_equal(tb.vertices, jb.vertices)
    jl = jsel.largest_component(jfine)
    tl = tsel.largest_component(tfine)
    np.testing.assert_array_equal(tl.faces, jl.faces)


def test_tet_lookup_dispatches_by_device(tet_meshes):
    # CPU tensors take the plain loop and launch nothing; the kernel's
    # wrapper takes CUDA tensors only
    jop = _jax_op(tet_meshes, "cube")
    (top,) = weights.operators_from_jax([jop], CPU)
    p = _t(_probe_points(jop.lut_def, n=60))
    before = tops.tet_lookup_cuda.launches
    found, tet, bary = tops.tet_lookup(top.lut_def, top.v0_def, top.inv_def, p)
    assert tops.tet_lookup_cuda.launches == before
    assert found.dtype == torch.bool and tet.dtype == torch.int32 and bary.shape == (p.shape[0], 4)
    with pytest.raises(ValueError):
        tops.tet_lookup_cuda(top.packed.lut_def, top.packed.records[tops.REC_DEF], p, -0.08)


# ------------------------------------------------- kernel E's packed form


def _probe_with_cells(lut, seed=11):
    """_probe_points plus the centre of an empty cell and points in a cell
    of the LUT's widest fanout → (points, [empty-cell point, widest-cell
    points] index masks)."""
    cells = np.asarray(lut.cells)
    fan = (cells >= 0).sum(1)
    lo, ic, res = np.asarray(lut.bbox_lo), np.asarray(lut.inv_cell), lut.res

    def centre(c, jitter):
        ijk = np.array([c // (res * res), (c // res) % res, c % res])
        return lo + (ijk + 0.5 + jitter) / ic

    rng = np.random.default_rng(seed)
    widest = [centre(int(np.argmax(fan)), rng.uniform(-0.45, 0.45, 3)) for _ in range(8)]
    empty = [centre(int(np.flatnonzero(fan == 0)[0]), np.zeros(3))]
    p = np.concatenate([_probe_points(lut, seed=seed), np.array(empty + widest)]).astype(np.float32)
    n = len(p)
    return p, np.arange(n) == n - 9, np.arange(n) >= n - 8


def _with_empty_cell(jop):
    """``jop`` with the middle cell of both LUTs emptied (a cage's LUT may
    have no empty cell inside its box)."""

    def empty(lut):
        cells = np.array(lut.cells)
        cells[(lut.res**3) // 2 + lut.res // 2] = -1
        return lut._replace(cells=jnp.asarray(cells))

    return jop._replace(lut_def=empty(jop.lut_def), lut_orig=empty(jop.lut_orig))


@pytest.mark.parametrize("eps", [-1e-5, 5e-3])
@pytest.mark.parametrize("name", ["cube", "lshape"])
def test_packed_lookup_matches_padded_and_jax(tet_meshes, name, eps):
    # the plain lookup over the packed LUT is bit-equal to the one over the
    # padded LUT everywhere, and to JAX off the near ties
    jop = _with_empty_cell(_jax_op(tet_meshes, name, translate=(0.05, -0.03, 0.02)))
    (top,) = weights.operators_from_jax([jop], CPU)
    thr = tops._threshold(eps)
    for which, section in (("def", tops.REC_DEF), ("orig", tops.REC_ORIG)):
        jl = getattr(jop, f"lut_{which}")
        p, empty, widest = _probe_with_cells(jl)
        table = top.packed.records[section]
        padded = tops.tet_lookup_plain(getattr(top, f"lut_{which}"), table, _t(p), thr)
        packed = tops.tet_lookup_packed_plain(getattr(top.packed, f"lut_{which}"), table, _t(p), thr)
        for a, b in zip(padded, packed):
            assert torch.equal(a.view(torch.int32) if a.is_floating_point() else a, b.view(torch.int32) if b.is_floating_point() else b)
        jf, jt, jb = (np.asarray(a) for a in jops.tet_lookup(jl, getattr(jop, f"v0_{which}"), getattr(jop, f"inv_{which}"), jnp.asarray(p), eps=eps))
        ok = ~_ambiguous(jl, getattr(jop, f"v0_{which}"), getattr(jop, f"inv_{which}"), p, eps)
        tf, tt, tb = (a.numpy() for a in packed)
        np.testing.assert_array_equal(tf[ok], jf[ok])
        np.testing.assert_array_equal(tt[ok], jt[ok])
        np.testing.assert_allclose(tb[ok & (tt == jt)], jb[ok & (tt == jt)], rtol=0, atol=1e-5)
        assert not tf[empty].any() and tt[empty][0] == 0  # an empty cell finds nothing: tet 0
        outside = ~((p >= np.asarray(jl.bbox_lo)) & (p < np.asarray(jl.bbox_lo) + jl.res / np.asarray(jl.inv_cell))).all(1)
        assert outside.any() and not tf[outside].any() and (tt[outside] == 0).all()
        assert ok[widest].any() and tf[widest].any()


@pytest.mark.parametrize("name", ["cube", "lshape"])
def test_packed_form_reproduces_the_operator(tet_meshes, name):
    # the CSR LUTs list each cell's tets in LUT order; the records carry the
    # lookup rows, deltas and rotations bit for bit, so the warp's delta and
    # rotation from a record equal _bary_delta and _rotate_back of the arrays
    jop = _jax_op(tet_meshes, name, translate=(0.1, 0.02, -0.05))
    (top,) = weights.operators_from_jax([jop], CPU)
    pk = top.packed
    for lut, plut in ((top.lut_def, pk.lut_def), (top.lut_orig, pk.lut_orig)):
        cells = lut.cells.numpy()
        off, ids = plut.offsets.numpy(), plut.ids.numpy()
        assert off[0] == 0 and off[-1] == len(ids) == (cells >= 0).sum() and plut.res == lut.res
        for c in np.flatnonzero((cells >= 0).any(1))[::7]:
            np.testing.assert_array_equal(ids[off[c] : off[c + 1]], cells[c][cells[c] >= 0])
        assert plut.box == tuple(np.concatenate([lut.bbox_lo.numpy(), lut.inv_cell.numpy()]).tolist())
        assert plut.nbytes() == 4 * (len(off) + len(ids)) < lut.cells.numel() * 4
    rec = pk.records
    assert rec.shape == (4, top.v0_def.shape[0], 12) and rec.is_contiguous()
    for section, v0, inv in ((tops.REC_DEF, top.v0_def, top.inv_def), (tops.REC_ORIG, top.v0_orig, top.inv_orig)):
        assert torch.equal(rec[section], torch.cat([v0, inv.reshape(-1, 9)], 1))
    rng = np.random.default_rng(12)
    n = 500
    tet = _t(rng.integers(0, top.v0_def.shape[0], n).astype(np.int32)).long()
    bary = _t(rng.normal(size=(n, 4)).astype(np.float32))
    d = _t(rng.normal(size=(n, 3)).astype(np.float32))
    ref = tops._bary_delta((top.verts_orig - top.verts_def).reshape(-1, 12)[tet], bary)
    assert torch.equal(tops._bary_delta(rec[tops.REC_DELTA][tet], bary), ref)
    ref = tops._rotate_back(top.rot.reshape(-1, 9)[tet], d)
    assert torch.equal(tops._rotate_back(rec[tops.REC_ROT][tet, :9], d), ref)
    assert not rec[tops.REC_ROT][:, 9:].any()


def test_lookup_tie_and_nan_rules(tet_meshes):
    # chip_smoke.tie_nan_op: every tet has an exact copy listed just before
    # it (the earlier copy must win the tie) and a NaN tet heads every cell
    # (it never wins); both plain lookups keep those rules, and the warps
    # move every point as the unmodified operator does
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    jop = _with_empty_cell(_jax_op(tet_meshes, "cube", translate=(0.06, 0.0, 0.0)))
    (top,) = weights.operators_from_jax([jop], CPU)
    syn = chip_smoke.tie_nan_op(top)
    nt = top.v0_def.shape[0]
    p = _t(_probe_with_cells(jop.lut_def)[0])
    thr = tops._threshold(tops.INCLUSIVE_EPS)
    table = syn.packed.records[tops.REC_DEF]
    f, t, b = tops.tet_lookup_packed_plain(syn.packed.lut_def, table, p, thr)
    f2, t2, b2 = tops.tet_lookup_plain(syn.lut_def, table, p, thr)
    assert torch.equal(f, f2) and torch.equal(t, t2) and torch.equal(b, b2)
    f0, t0, b0 = tops.tet_lookup_plain(top.lut_def, top.packed.records[tops.REC_DEF], p, thr)
    assert f.any() and torch.equal(f, f0)
    assert ((t[f] >= nt) & (t[f] < 2 * nt)).all() and not (t == 2 * nt).any()
    assert torch.equal(t[f] - nt, t0[f]) and torch.equal(b[f], b0[f])
    d = torch.nn.functional.normalize(_t(np.random.default_rng(13).normal(size=(p.shape[0], 3)).astype(np.float32)), dim=1)
    for a, c in zip(tops.cage_map_samples_plain(syn, p, d), tops.cage_map_samples_plain(top, p, d)):
        assert torch.equal(a, c)


def test_cage_warps_dispatch_by_device(tet_meshes):
    # CPU tensors run the plain composition and launch nothing; the warp
    # instances' wrappers take CUDA tensors only, and an operator without
    # its packed form is refused there
    jop = _jax_op(tet_meshes, "lshape", translate=(0.0, 0.05, 0.0))
    (top,) = weights.operators_from_jax([jop], CPU)
    p = _t(_probe_points(jop.lut_def, n=90))
    d = torch.nn.functional.normalize(p - 0.5, dim=1)
    before = (tops.cage_warp_samples_cuda.launches, tops.cage_warp_positions_cuda.launches, tops.tet_lookup_cuda.launches)
    for a, b in zip(tops.cage_map_samples(top, p, d), tops.cage_map_samples_plain(top, p, d)):
        assert torch.equal(a, b)
    for a, b in zip(tops.cage_map_positions(top, p), tops.cage_map_positions_plain(top, p)):
        assert torch.equal(a, b)
    tops.cage_in_source(top, p)
    tops.cage_map_forward(top, p)
    after = (tops.cage_warp_samples_cuda.launches, tops.cage_warp_positions_cuda.launches, tops.tet_lookup_cuda.launches)
    assert after == before
    with pytest.raises(ValueError):
        tops.cage_warp_samples_cuda(top, p, d)
    with pytest.raises(ValueError):
        tops.cage_warp_positions_cuda(top, p)
    with pytest.raises(ValueError, match="packed"):
        tops.cage_warp_positions_cuda(top._replace(packed=None), p)
