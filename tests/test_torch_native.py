"""The port's native host library (``nerfshop_tpu_torch/native.py`` over
``csrc/host_ops.cpp``) against its numpy paths and against the JAX package's
``native`` module: the LUT voxelizer's cells bit for bit, the region
growing's selection, the cell clearing and ``GrowingSelection.vanish``; and
a build that fails raises."""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfshop_tpu import native as jnative
from nerfshop_tpu.editing import selection as jsel
from nerfshop_tpu.editing.cage import Cage as JCage
from nerfshop_tpu.editing.growing_selection import GrowingSelection as JGrowingSelection
from nerfshop_tpu.editing.tet_mesh import TetMesh as JTetMesh
from nerfshop_tpu.ops import grid as jgrid
from nerfshop_tpu_torch import native
from nerfshop_tpu_torch.editing import selection as tsel
from nerfshop_tpu_torch.editing.growing_selection import GrowingSelection as TGrowingSelection
from nerfshop_tpu_torch.editing.tet_mesh import TetMesh as TTetMesh
from nerfshop_tpu_torch.ops import grid as tgrid
from test_bvh import cube_mesh
from test_concave_cage import _l_shape_cage
from torch_one_thread import one_thread  # noqa: F401

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def tet_meshes():
    out = {}
    for name, mesh, kw in (("cube", cube_mesh(0.3, 0.7), dict(ideal_edge=0.15)), ("lshape", _l_shape_cage(), {})):
        cage = JCage.from_mesh(mesh)
        jtm = JTetMesh.from_cage(cage, **kw)
        cage.translate(np.array([0.05, -0.03, 0.02], np.float32))
        jtm.update_deformed(cage)
        out[name] = jtm
    return out


def _port(jtm):
    return TTetMesh(jtm.vertices_original.copy(), jtm.vertices_deformed.copy(), jtm.tets.copy())


def _cell_sets_differ(a, b):
    """Rows of two LUTs whose tet lists differ, and the largest number of
    tets in one list and not the other."""
    rows = np.nonzero((a != b).any(axis=1))[0]
    extra = [len(set(a[r][a[r] >= 0]) ^ set(b[r][b[r] >= 0])) for r in rows]
    return len(rows), max(extra, default=0)


@pytest.mark.parametrize("res,max_t", [(16, 64), (64, 32), (24, 4)])
@pytest.mark.parametrize("name", ["cube", "lshape"])
def test_voxelize_native_matches_numpy_and_jax(tet_meshes, name, res, max_t):
    # the library's cells bit-equal to the JAX package's library; against
    # the numpy path (the port's and the JAX package's, bit-equal to each
    # other) the same box and fanout, and the same cells except where a
    # cell centre lies within rounding of a tet's face-plane slack: the
    # plane test sums in another order (f32 normals, f64 centres), and such
    # a cell may list one tet more or less (1 cell of 262144 on the L-shape
    # at res 64); (24, 4) truncates most cells, where each keeps its lowest
    # tets as the numpy path does
    jtm = tet_meshes[name]
    ttm = _port(jtm)
    for verts in (ttm.vertices_original, ttm.vertices_deformed):
        ours = ttm._voxelize(verts, res, max_t)
        plain = ttm._voxelize_plain(verts, res, max_t)
        jax_numpy = jtm._voxelize(verts, res, max_t, use_native=False)
        for b, c in zip(plain[:3], jax_numpy[:3]):
            np.testing.assert_array_equal(b, c)
        for a, b in zip(ours[:2], plain[:2]):
            np.testing.assert_array_equal(a, b)
        assert ours[2].shape == plain[2].shape and ours[3] == plain[3] > 0
        n_rows, extra = _cell_sets_differ(ours[2], plain[2])
        assert n_rows <= max(1, res**3 // 100000) and extra <= 1, (n_rows, extra)
        if max_t >= ours[3]:
            jax_native = jtm._voxelize(verts, res, max_t, use_native=True)
            for a, c in zip(ours, jax_native):
                np.testing.assert_array_equal(a, c)
    if max_t == 4:
        assert ours[3] > max_t


@pytest.mark.parametrize("res,max_t", [(16, 64), (64, 32)])
@pytest.mark.parametrize("name", ["cube", "lshape"])
def test_lut_differences_are_rounding_ties(tet_meshes, name, res, max_t):
    # chip_smoke.lut_differences, [native]'s rule on the card: every tet
    # that the library's LUT and the numpy path's list differently in a
    # cell is decided within LUT_TIE_REL of the box's largest coordinate
    # (the L-shape at res 64 has one such cell); a tet planted in a cell
    # far outside it, or dropped from a cell it covers, is off by more
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    ttm = _port(tet_meshes[name])
    for verts in (ttm.vertices_original, ttm.vertices_deformed):
        ours = ttm._voxelize(verts, res, max_t)[2]
        plain = ttm._voxelize_plain(verts, res, max_t)[2]
        n_rows, extra, worst = chip_smoke.lut_differences(ttm, verts, res, ours, plain)
        assert n_rows == _cell_sets_differ(ours, plain)[0] and extra <= 1 and worst <= chip_smoke.LUT_TIE_REL
        # tet 0 dropped from the cell of its centroid, and planted in the
        # cell at the box's far corner from it
        _, lo, inv_cell = ttm._box(verts, res)
        ijk = ((verts[ttm.tets[0]].mean(0) - lo) * inv_cell).astype(int)
        far = np.where(ijk < res // 2, res - 1, 0)
        padded = np.pad(plain, ((0, 0), (0, 1)), constant_values=-1)
        for (i, j, k), listed in ((ijk, True), (far, False)):
            broken = padded.copy()
            row = broken[(i * res + j) * res + k]
            assert (row == 0).any() == listed
            if listed:
                row[row == 0] = -1
            else:
                row[-1] = 0
            n_bad, extra_bad, worst_bad = chip_smoke.lut_differences(ttm, verts, res, broken, padded)
            assert n_bad == 1 and extra_bad == 1 and worst_bad > 1e3 * chip_smoke.LUT_TIE_REL, worst_bad


def test_library_voxelize_raw_matches_jax_native(tet_meshes):
    jtm = tet_meshes["lshape"]
    lo = jtm.vertices_deformed.min(0) - 1e-4
    inv = (32 / (jtm.vertices_deformed.max(0) + 1e-4 - lo)).astype(np.float32)
    ours = native.voxelize_tets(jtm.vertices_deformed, jtm.tets, 32, lo.astype(np.float32), inv, 128)
    ref = jnative.voxelize_tets(jtm.vertices_deformed, jtm.tets, 32, lo.astype(np.float32), inv, 128)
    assert ref is not None and ours[1] == ref[1]
    np.testing.assert_array_equal(ours[0], ref[0])


def _density(seed=10):
    rng = np.random.default_rng(seed)
    dens = np.zeros((2, 128, 128, 128), np.float32)
    dens[0, 40:70, 50:80, 30:60] = rng.uniform(0, 0.03, (30, 30, 30))
    dens[0, 100:128, 60:70, 60:70] = 0.05  # touches the cascade's boundary
    dens[1] = rng.uniform(0, 0.02, (128, 128, 128))
    return dens


@pytest.mark.parametrize("n_steps", [500, 10**7])
def test_region_grow_matches_jax_native_and_bfs(n_steps):
    dens = _density()
    seeds = np.array([[0, 55, 60, 45], [0, 41, 51, 31], [0, 110, 65, 65]], np.int32)
    tr, jr, pr = (m.RegionGrowing(density=dens) for m in (tsel, jsel, tsel))
    for r in (tr, jr, pr):
        r.reset(seeds)
    assert jnative.get_lib() is not None
    assert tr.grow(n_steps) == jr.grow(n_steps)
    np.testing.assert_array_equal(tr.selection, jr.selection)
    assert tr.growing_level == jr.growing_level and not tr.queue
    pr.grow_plain(n_steps)
    if n_steps > 10**6:
        # unlimited: the plain BFS grows the same region (and both moved out
        # a cascade: the region touches the boundary)
        assert tr.growing_level == pr.growing_level == 1
        np.testing.assert_array_equal(tr.selection, pr.selection)
    else:
        assert 0 < tr.selection.sum() and tr.growing_level == 0


def test_region_grow_library_call():
    dens = np.zeros((128, 128, 128), np.float32)
    dens[40:60, 40:60, 40:60] = 1.0
    sel = np.zeros((128, 128, 128), np.uint8)
    seeds = np.asarray([(50 * 128 + 50) * 128 + 50], np.int32)
    assert native.region_grow(dens, sel, seeds, 0.5, 10**7) == 20**3
    assert sel.sum() == 20**3 and sel[41, 45, 55] and not sel[20, 20, 20]
    with pytest.raises(ValueError):
        native.region_grow(dens, sel.astype(bool), seeds, 0.5, 10)


def _clear_plain(verts, tets, res, lo, cell_w, density):
    """The numpy cell clearing (the JAX package's fallback of ``vanish``)."""
    tv = verts[tets]
    tl = np.clip(np.floor((tv.min(1) - lo) / cell_w).astype(int) - 1, 0, res - 1)
    th = np.clip(np.floor((tv.max(1) - lo) / cell_w).astype(int) + 1, 0, res - 1)
    for (x0, y0, z0), (x1, y1, z1) in zip(tl, th):
        density[x0 : x1 + 1, y0 : y1 + 1, z0 : z1 + 1] = 0.0


@pytest.mark.parametrize("mip", [0, 1])
def test_clear_cells_matches_numpy_and_jax(tet_meshes, mip):
    jtm = tet_meshes["lshape"]
    scale = 2.0**mip
    lo, cell_w = 0.5 - scale / 2, scale / 128
    base = np.random.default_rng(2).uniform(0.5, 1.0, (128, 128, 128)).astype(np.float32)
    ours, plain, ref = base.copy(), base.copy(), base.copy()
    native.clear_cells_in_tets(jtm.vertices_deformed, jtm.tets, 128, lo, cell_w, ours)
    _clear_plain(jtm.vertices_deformed, jtm.tets, 128, lo, cell_w, plain)
    jnative.clear_cells_in_tets(jtm.vertices_deformed, jtm.tets, 128, lo, cell_w, ref)
    np.testing.assert_array_equal(ours, plain)
    np.testing.assert_array_equal(ours, ref)
    assert 0 < (ours == 0).mean() < 0.5


def test_vanish_matches_jax(tet_meshes):
    jtm = tet_meshes["cube"]
    dens = _density(3)
    jg = jgrid.update_bitfield(jgrid.OccupancyGrid.create(2)._replace(density=jnp.asarray(dens)))
    tg = tgrid.update_bitfield(tgrid.OccupancyGrid(torch.from_numpy(dens.copy()), torch.ones((2, 128, 128, 128), dtype=torch.bool),
                                                   torch.zeros(())))
    js = JGrowingSelection(model=None, aabb=None)
    js.tet_mesh = jtm
    ts = TGrowingSelection(model=None, aabb=None, device=CPU)
    ts.tet_mesh = _port(jtm)
    jv, tv = js.vanish(jg), ts.vanish(tg)
    np.testing.assert_array_equal(tv.density.numpy(), np.asarray(jv.density))
    np.testing.assert_allclose(float(tv.mean_density), float(jv.mean_density), rtol=1e-6)
    # the bitfield from the same density: the two means sum in another
    # order, so a cell within 1e-5 of the threshold may fall either side
    thresh = float(jv.mean_density)
    # (a coarser cascade also ORs in the finer one's cells)
    clear = np.abs(np.asarray(jv.density)[0] - thresh) > 1e-5 * thresh
    np.testing.assert_array_equal(tv.occupancy.numpy()[0][clear], np.asarray(jv.occupancy)[0][clear])
    assert np.mean(tv.occupancy.numpy() != np.asarray(jv.occupancy)) < 1e-5
    assert int((tv.density == 0).sum()) > int((tg.density == 0).sum())
    assert torch.equal(tg.density, torch.from_numpy(dens))  # the input grid is not changed
    with pytest.raises(RuntimeError):
        TGrowingSelection(model=None, aabb=None, device=CPU).vanish(tg)


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build(bad)
    with pytest.raises(RuntimeError, match="cannot be built"):
        native.build(native.SOURCE, compiler=str(tmp_path / "no-such-compiler"))
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_is_built_once_per_source():
    path = native.library_path()
    assert native.build() == path and path.exists() and path.parent == native.BUILD_DIR
    assert native.get_lib() is native.get_lib()
