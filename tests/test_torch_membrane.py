"""The port's Poisson membrane against the JAX package: the SH9 helpers, the
membrane's boundary values, the residuals of a sample, the full operator
stack, the plain version of kernel E's ``WARP_MEMBRANE`` instance and its
packed rows, and ``render_frame`` with a membrane operator in both blend
modes.

The sphere directions are JAX's draws, handed to the port as arrays. The
field runs its MLPs with bf16 operands in both packages (see
``test_torch_train_step.py``); a value on a bf16 rounding boundary may round
the other way, and each membrane value averages 100 directions, so the
membrane's arrays are held within 1e-4 relative (L2), the SH algebra
within 1e-6, and the per-sample residuals and warps within 1e-5. Samples whose
tet lookup is a near tie (``test_torch_editing.py``) are left out of the
per-sample comparisons."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfshop_tpu.editing import operators as jops
from nerfshop_tpu.editing import poisson as jpoisson
from nerfshop_tpu.editing.cage import Cage as JCage
from nerfshop_tpu.editing.tet_mesh import TetMesh as JTetMesh
from nerfshop_tpu.ops import coords as jcoords
from nerfshop_tpu.ops import sh as jsh
from nerfshop_tpu_torch import weights
from nerfshop_tpu_torch.editing import operators as tops
from nerfshop_tpu_torch.editing import poisson as tpoisson
from nerfshop_tpu_torch.editing import serialization as tser
from nerfshop_tpu_torch.editing.cage import Cage as TCage
from nerfshop_tpu_torch.editing.tet_mesh import TetMesh as TTetMesh
from nerfshop_tpu_torch.geometry.mesh_io import TriMesh as TTriMesh
from nerfshop_tpu_torch.ops import coords as tcoords
from nerfshop_tpu_torch.ops import sh as tsh
from nerfshop_tpu_torch.render import renderer as trender
from test_bvh import cube_mesh
from test_torch_edit_render import _close, _render, jax_stack, scene  # noqa: F401 (fixtures)
from test_torch_editing import _stack_ambiguous
from test_torch_render import CENTER, look_at
from torch_one_thread import one_thread  # noqa: F401

CPU = torch.device("cpu")
SHIFT = np.array([0.12, 0.0, 0.0], np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jax_dirs(key):
    """The (inside, outside) directions JAX's compute_membrane draws from ``key``."""
    k1, k2 = jax.random.split(key)
    return tuple(np.asarray(jsh.stratified_sphere_directions(k, 10, 10)) for k in (k1, k2))


# ----------------------------------------------------------------------- SH


def test_sh9_basis_eval_and_projection_match():
    rng = np.random.default_rng(0)
    d = rng.normal(size=(500, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    coeffs = rng.normal(size=(500, 9, 3)).astype(np.float32)
    vals = rng.uniform(0, 1, (4, 500, 3)).astype(np.float32)
    np.testing.assert_allclose(tsh.sh9_basis(torch.from_numpy(d)).numpy(), np.asarray(jsh.sh9_basis(jnp.asarray(d))),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(tsh.evaluate_sh9(torch.from_numpy(coeffs), torch.from_numpy(d)).numpy(),
                               np.asarray(jsh.evaluate_sh9(jnp.asarray(coeffs), jnp.asarray(d))), rtol=0, atol=1e-6)
    ref = np.stack([np.asarray(jsh.project_sh9(jnp.asarray(d), jnp.asarray(v))) for v in vals])
    np.testing.assert_allclose(tsh.project_sh9(torch.from_numpy(d), torch.from_numpy(vals)).numpy(), ref,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("n_phi", [10, 4])
def test_stratified_directions_from_jax_uniforms(n_phi):
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jsh.stratified_sphere_directions(key, 10, n_phi))
    # the two uniform arrays that JAX's function draws
    u = np.asarray(jax.random.uniform(key, (10, n_phi)))
    v = np.asarray(jax.random.uniform(jax.random.fold_in(key, 1), (10, n_phi)))
    ours = tsh.stratified_sphere_directions_from(torch.from_numpy(u), torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
    g = torch.Generator().manual_seed(0)
    drawn = tsh.stratified_sphere_directions(g, 10, n_phi)
    assert drawn.shape == (10 * n_phi, 3)
    np.testing.assert_allclose(drawn.norm(dim=1).numpy(), 1.0, atol=1e-6)


# ------------------------------------------------------------- the membrane


@pytest.fixture(scope="module")
def membrane_case(scene):
    """The cube cage of ``jax_stack`` moved +0.12 x, with the membrane JAX
    computes for it over the scene's field and grid, and the same cage,
    tets and directions on the port's side."""
    jm, jparams, jg, tm, tg = scene
    mesh = cube_mesh(0.2, 0.8)
    jtm = JTetMesh.from_cage(JCage.from_mesh(mesh), ideal_edge=0.15)
    jcage = JCage.from_mesh(mesh)
    jcage.translate(SHIFT)
    jtm.update_deformed(jcage)
    key = jax.random.PRNGKey(5)
    jmem = jpoisson.compute_membrane(jm, jparams, jcage, jtm, jcoords.BoundingBox.unit(), key, grid=jg)
    jop = jops.CageDeformationOp.from_tet_mesh(jtm, lut_res=24)._replace(membrane=jmem)
    tcage = TCage.from_mesh(TTriMesh(mesh.vertices, mesh.faces))
    tcage.translate(SHIFT)
    ttm = TTetMesh(jtm.vertices_original.copy(), jtm.vertices_deformed.copy(), jtm.tets.copy())
    return jop, jmem, tcage, ttm, _jax_dirs(key)


@pytest.fixture(scope="module")
def identity_with_membrane(scene, jax_stack):
    """``jax_stack``'s identity cage with a membrane of amplitude 0.5."""
    jm, jparams, *_ = scene
    _, identity = jax_stack
    mesh = cube_mesh(0.2, 0.8)
    jtm = JTetMesh.from_cage(JCage.from_mesh(mesh), ideal_edge=0.15)
    np.testing.assert_array_equal(np.asarray(identity.verts_orig), jtm.vertices_original[jtm.tets])
    jmem = jpoisson.compute_membrane(jm, jparams, JCage.from_mesh(mesh), jtm, jcoords.BoundingBox.unit(),
                                     jax.random.PRNGKey(9), amplitude=0.5)
    return identity._replace(membrane=jmem)


def test_compute_membrane_matches_jax(scene, membrane_case):
    jm, jparams, jg, tm, tg = scene
    jop, jmem, tcage, ttm, dirs = membrane_case
    aabb = tcoords.BoundingBox.from_aabb_scale(1, device=CPU)
    ours = tpoisson.compute_membrane(tm, None, tcage, ttm, aabb, tuple(torch.from_numpy(d) for d in dirs), grid=tg)
    assert float(np.asarray(jmem.outside_density).min()) > 1e-9  # the gate is open: the test sees values
    for f in ("density", "outside_density", "sh"):
        ref = np.asarray(getattr(jmem, f))
        assert getattr(ours, f).shape == ref.shape, f
        assert _rel(getattr(ours, f).numpy(), ref) < 1e-4, (f, _rel(getattr(ours, f).numpy(), ref))
    assert float(np.abs(np.asarray(jmem.density)).max()) > 0
    assert ours.amplitude == float(jmem.amplitude) and ours.packed.shape == (len(ttm.tets), 120)


def test_occupied_at_matches_jax(scene):
    _, _, jg, _, tg = scene
    pos = np.random.default_rng(1).uniform(-0.2, 1.2, (2000, 3)).astype(np.float32)
    ref = np.asarray(jpoisson._occupied_at(jg, jnp.asarray(pos)))
    np.testing.assert_array_equal(tpoisson._occupied_at(tg, torch.from_numpy(pos)).numpy(), ref)
    assert ref.any() and not ref.all()


def _membrane_inputs(jop, n=3000, seed=7):
    rng = np.random.default_rng(seed)
    lo = np.asarray(jop.lut_def.bbox_lo)
    hi = lo + jop.lut_def.res / np.asarray(jop.lut_def.inv_cell)
    p = rng.uniform(lo - 0.1, hi + 0.1, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return p, d


def test_membrane_residuals_at_match(membrane_case):
    jop, jmem, *_ = membrane_case
    (top,) = weights.operators_from_jax([jop], CPU)
    p, d = _membrane_inputs(jop)
    found, tet, bary = jops.tet_lookup(jop.lut_def, jop.v0_def, jop.inv_def, jnp.asarray(p))
    ref = [np.asarray(a) for a in jpoisson.membrane_residuals_at(jmem, tet, bary, found, jnp.asarray(d))]
    ours = tpoisson.membrane_residuals_at(top.membrane, torch.from_numpy(np.asarray(tet)),
                                          torch.from_numpy(np.asarray(bary)), torch.from_numpy(np.asarray(found)),
                                          torch.from_numpy(d))
    assert np.asarray(found).mean() > 0.2
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5)


def _kernel_arithmetic(packed, amplitude, tet, bary, in_target, direction):
    """WARP_MEMBRANE's arithmetic on the packed rows, in numpy float64 (the
    order of ``csrc/tet_lookup.cu``'s add_membrane)."""
    rows = packed[tet].astype(np.float64).reshape(-1, 30, 4)
    b = bary.astype(np.float64)
    dot = np.einsum("nqk,nk->nq", rows, b)  # [N, 30]
    basis = tsh.sh9_basis(torch.from_numpy(direction.astype(np.float64))).numpy()
    rgb = np.stack([np.sum(basis * dot[:, 2 + c : 29 : 3], axis=1) for c in range(3)], -1)
    on = in_target.astype(np.float64)
    return dot[:, 0] * amplitude * on, dot[:, 1] * amplitude * on, rgb * on[:, None]


def test_warp_membrane_plain_and_packed_rows_match_jax(membrane_case):
    # the plain version against JAX's full stack of this one cage, and the
    # kernel's formula over the packed rows against the plain residuals
    jop, *_ = membrane_case
    (top,) = weights.operators_from_jax([jop], CPU)
    p, d = _membrane_inputs(jop, seed=8)
    ok = ~_stack_ambiguous(jop, p)
    ref = [np.asarray(a) for a in jops.map_samples_through_stack_full([jop], jnp.asarray(p), jnp.asarray(d))]
    pos, dirs, empty, in_t, rs, ro, rc = [a.numpy() for a in tops.cage_map_membrane_plain(top, torch.from_numpy(p),
                                                                                          torch.from_numpy(d))]
    np.testing.assert_array_equal(empty[ok], ref[2][ok])
    np.testing.assert_allclose(pos[ok], ref[0][ok], rtol=0, atol=1e-5)
    np.testing.assert_allclose(dirs[ok], ref[1][ok], rtol=0, atol=1e-5)
    for a, b in zip((rs, ro, rc), ref[3:]):
        np.testing.assert_allclose(a[ok], b[ok], rtol=1e-5, atol=1e-5)
    assert in_t.mean() > 0.2 and (ro[in_t] > 1e-9).mean() > 0.5

    found, tet, bary = (a.numpy() for a in tops.tet_lookup_plain(
        top.lut_def, tops._table(top.v0_def, top.inv_def), torch.from_numpy(p), tops._threshold(tops.INCLUSIVE_EPS)))
    k = _kernel_arithmetic(top.membrane.packed.numpy(), top.membrane.amplitude, tet, bary, in_t, dirs)
    for a, b in zip(k, (rs, ro, rc)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_stack_full_two_membrane_cages_and_a_duplicate(membrane_case, identity_with_membrane, jax_stack):
    jop, *_ = membrane_case
    stack, identity = jax_stack
    jstack = [jop, identity_with_membrane, stack[1]]
    tstack = weights.operators_from_jax(jstack, CPU)
    p, d = _membrane_inputs(jop, n=4000, seed=9)
    ok = ~(_stack_ambiguous(jop, p) | _stack_ambiguous(identity, p))
    ref = [np.asarray(a) for a in jops.map_samples_through_stack_full(jstack, jnp.asarray(p), jnp.asarray(d))]
    ours = [a.numpy() for a in tops.map_samples_through_stack_full(tstack, torch.from_numpy(p), torch.from_numpy(d))]
    np.testing.assert_array_equal(ours[2][ok], ref[2][ok])
    for a, b in zip(ours[:2] + ours[3:], ref[:2] + ref[3:]):
        np.testing.assert_allclose(a[ok], b[ok], rtol=1e-5, atol=1e-5)
    # both membranes contribute somewhere
    assert (ref[4] > 0).mean() > 0.2
    # without a membrane the full stack is the plain stack, with zero residuals
    plain = tops.map_samples_through_stack([tstack[2]], torch.from_numpy(p), torch.from_numpy(d))
    full = tops.map_samples_through_stack_full([tstack[2]], torch.from_numpy(p), torch.from_numpy(d))
    for a, b in zip(plain, full[:3]):
        assert torch.equal(a, b)
    assert not full[3].any() and not full[4].any() and not full[5].any()


@pytest.mark.parametrize("mode", ["target", "additive"])
def test_render_with_membrane_matches_jax(scene, membrane_case, jax_stack, mode):
    jop, *_ = membrane_case
    stack, _ = jax_stack
    jr, jd, tr, td = _render(scene, [jop, stack[1]], membrane_mode=mode, chunk=128)
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-3)
    _close(tr, jr)
    # the membrane changed the frame (the port's frame without it)
    jm, jparams, jg, tm, tg = scene
    top, tdup = weights.operators_from_jax([jop._replace(membrane=None), stack[1]], CPU)
    xf = torch.from_numpy(look_at(CENTER + np.array([1.1, -0.9, 0.4], np.float32)))
    opts = trender.RenderOptions(k_samples=32, n_windows=2, n_candidates=512, chunk=128, use_grid_early_stop=False)
    f, pp = torch.tensor([28.0, 28.0]), torch.tensor([0.5, 0.5])
    tr0 = trender.render_frame(tm, None, tg, (tr.shape[1], tr.shape[0]), xf, f, pp, opts=opts, operators=(top, tdup))
    assert np.abs(tr - tr0.rgba.numpy()).max() > 1e-3


def test_membrane_weights_round_trip(membrane_case):
    jop, jmem, *_ = membrane_case
    (top,) = weights.operators_from_jax([jop], CPU)
    (back,) = weights.operators_to_jax([top])
    for f in ("density", "outside_density", "sh"):
        np.testing.assert_array_equal(back["membrane"][f], np.asarray(getattr(jmem, f)))
    assert back["membrane"]["amplitude"] == np.float32(jmem.amplitude)
    with pytest.raises(TypeError):
        weights.operators_from_jax([jop._replace(membrane=object())], CPU)


def test_save_edits_refuses_a_membrane(tmp_path, membrane_case):
    # F10: the JAX package's save_edits drops the membrane; the port refuses
    jop, *_ = membrane_case
    (top,) = weights.operators_from_jax([jop], CPU)
    with pytest.raises(ValueError, match="membrane"):
        tser.save_edits(tmp_path / "e.json", [top])
    tser.save_edits(tmp_path / "e.json", [top._replace(membrane=None)])
