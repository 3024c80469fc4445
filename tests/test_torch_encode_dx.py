"""The hash-grid encode's gradient with respect to the positions (kernel F's
plain version, ``GridEncodeFunction``'s d_x) against JAX's autodiff of
``GridEncoding.apply`` and against the sum kernel F computes, and what
needs it: ``RenderMode.Normals`` against JAX's frame and ``optimize_mesh``
against JAX's steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfshop_tpu.models import encodings as jenc
from nerfshop_tpu_torch.models import encodings as tenc
from nerfshop_tpu_torch.ops import table_ops
from test_torch_render import CENTER, _render_both, look_at, scene  # noqa: F401  (scene: the shared fixture)

# (L, log2 T, base res, per-level scale): all-dense levels, and mostly hashed ones
CONFIGS = {
    "dense": dict(n_levels=3, log2_hashmap_size=14, base_resolution=4, per_level_scale=1.5),
    "hash": dict(n_levels=4, log2_hashmap_size=12, base_resolution=8, per_level_scale=2.2),
}


def _pair(name, seed=0):
    kw = dict(n_input_dims=3, n_features_per_level=2, **CONFIGS[name])
    je = jenc.GridEncoding(**kw)
    te = tenc.GridEncoding(**kw)
    table = np.asarray(je.init(jax.random.PRNGKey(seed))["table"]) * 1e3  # O(0.1) features
    with torch.no_grad():
        te.table.copy_(torch.from_numpy(table))
    return je, te, table


def _points(te, seed=0, n=384):
    """Uniform points, the cube's corners, and per level points whose cell is
    the last one (p0 = res − 1) on one axis or all three."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    x[:4] = [[0, 0, 0], [1, 1, 1], [1, 0, 0.5], [0.5, 1, 0]]
    edge = []
    for scale, res in zip(te.level_scales, te.level_res):
        u = min((res - 0.75) / scale, 1.0)  # p = u·scale + 0.5 ≥ res − 0.25 when u < 1
        edge += [[u, 0.3, 0.6], [0.2, u, 0.7], [u, u, u]]
    return np.concatenate([x, np.asarray(edge, np.float32)])


def _dx_formula(te, table, x, dout):
    """The sum kernel F computes, in float64 numpy: d_x[n, d] = Σ_l scale_l ·
    [p0_d ≠ res_l − 1] · Σ_c ∂w8_c/∂w1_d · Σ_f dout[n, l, f] · table[row(l, n, c), f]."""
    idx, w1 = (a.numpy() for a in te.brick_fracs(torch.from_numpy(x)))
    N, L = x.shape[0], te.n_levels
    dout = dout.reshape(N, L, 2).astype(np.float64)
    dx = np.zeros((N, 3))
    for l in range(L):
        m, res, off = te.level_sizes[l], te.level_res[l], te.level_offsets[l]
        p0 = np.clip(np.floor(x.astype(np.float32) * np.float32(te.level_scales[l]) + np.float32(0.5)), 0, res - 1)
        w = w1[l].astype(np.float64)
        for c in range(8):
            rows = (idx[l].astype(np.int64) + te.brick_shifts[l][c]) % m + off
            g = (dout[:, l, :] * table[rows].astype(np.float64)).sum(-1)
            for d in range(3):
                dw = np.ones(N)
                for e in range(3):
                    if e != d:
                        dw *= w[:, e] if (c >> e) & 1 else 1.0 - w[:, e]
                sign = 1.0 if (c >> d) & 1 else -1.0
                dx[:, d] += np.where(p0[:, d] != res - 1, te.level_scales[l], 0.0) * sign * dw * g
    return dx


#: kernel F's threads a sample (``kDxLanes`` of ``csrc/grid_encode.cu``):
#: lane j sums levels j, j + F_LANES, ... one at a time
F_LANES = 2


def _fma(a, b, c):
    """fmaf: a·b + c rounded once to float32 (a·b is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def _blend2(e00, e10, e01, e11, u, v):
    """The kernel's bilinear blend: along u at v = 0 and at v = 1 (a + u·(b − a),
    one FMA each), then along v."""
    def blend(a, b, w):
        return _fma(w, b - a, a)

    return blend(blend(e00, e10, u), blend(e01, e11, u), v)


def _kernel_f_model(te, table, x, dout):
    """Kernel F's arithmetic in float32, in its order. Per level: the corner
    dots ⟨dout, row_c⟩; for each axis the four differences of the dots along
    it, blended bilinearly in the other two axes' folded fractions; times
    scale_l where the axis moves. A sample's F_LANES lanes each sum their
    levels (lane j: levels j, j + F_LANES, ...) in turn; the xor shuffles
    then add the lanes 1 apart, 2 apart, ..."""
    xt = torch.from_numpy(x)
    tab = torch.from_numpy(table)
    N, L = x.shape[0], te.n_levels
    g = torch.from_numpy(dout).reshape(N, L, 2)
    idx, w1 = te.brick_fracs(xt)
    terms = []
    for l in range(L):
        m, res, off = te.level_sizes[l], te.level_res[l], te.level_offsets[l]
        scale = torch.tensor(te.level_scales[l], dtype=torch.float32)
        p0 = torch.clamp(torch.floor(xt * scale + 0.5), 0, res - 1)
        sc = torch.where(p0 != res - 1, scale, torch.zeros(()))
        rows = (idx[l].long()[:, None] + torch.tensor(te.brick_shifts[l])[None, :]) % m + off
        v = tab[rows]  # [N, 8, 2]
        gc = _fma(g[:, l, None, 0], v[..., 0], g[:, l, None, 1] * v[..., 1]).unbind(1)
        wx, wy, wz = w1[l].unbind(1)
        dd = torch.stack([
            _blend2(gc[1] - gc[0], gc[3] - gc[2], gc[5] - gc[4], gc[7] - gc[6], wy, wz),
            _blend2(gc[2] - gc[0], gc[3] - gc[1], gc[6] - gc[4], gc[7] - gc[5], wx, wz),
            _blend2(gc[4] - gc[0], gc[5] - gc[1], gc[6] - gc[2], gc[7] - gc[3], wx, wy),
        ], 1)
        terms.append((sc, dd))
    acc = [torch.zeros((N, 3)) for _ in range(F_LANES)]
    for l, (sc, dd) in enumerate(terms):
        acc[l % F_LANES] = _fma(sc, dd, acc[l % F_LANES])
    o = 1
    while o < F_LANES:
        acc = [acc[j] + acc[j ^ o] for j in range(F_LANES)]
        o *= 2
    return acc[0].numpy()


def _module_dx(te, x, ct, table_grad=False):
    """d_x (and d_table) of Σ ct · te(x) through ``GridEncodeFunction``."""
    te.table.requires_grad_(table_grad)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = te(xt)
    assert type(out.grad_fn).__name__ == "GridEncodeFunctionBackward"
    wrt = [xt, te.table] if table_grad else [xt]
    return torch.autograd.grad((out * torch.from_numpy(ct)).sum(), wrt)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_dx_matches_jax_grad(name):
    # JAX on the CPU differentiates its fp32 reference (the bf16 features of
    # the accelerator VJP, table_ops.py:261-267, would put it ~2^-8 relative
    # off), so fp32 against fp32 in another summation order: 1e-5 of max |d_x|
    je, te, table = _pair(name)
    x = _points(te, 1)
    ct = np.random.default_rng(2).standard_normal((x.shape[0], te.n_output_dims)).astype(np.float32)

    def f(xx):
        return jnp.sum(je.apply({"table": jnp.asarray(table)}, xx) * ct)

    ref = np.asarray(jax.grad(f)(jnp.asarray(x)))
    (ours,) = _module_dx(te, x, ct)
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_dx_matches_autograd_and_kernel_sum(name):
    # the backward's d_x, autograd of the plain forward and kernel F's sum
    # written out in float64: within 1e-5 of max |d_x| (fp32 sums)
    _, te, table = _pair(name)
    x = _points(te, 3)
    ct = np.random.default_rng(4).standard_normal((x.shape[0], te.n_output_dims)).astype(np.float32)
    (ours,) = _module_dx(te, x, ct)
    xt = torch.from_numpy(x).requires_grad_(True)
    plain = table_ops.grid_encode_plain(te.table.detach(), xt, te, with_fracs=False)[0]
    (auto,) = torch.autograd.grad((plain * torch.from_numpy(ct)).sum(), [xt])
    formula = _dx_formula(te, table, x, ct)
    tol = 1e-5 * np.abs(formula).max()
    np.testing.assert_allclose(ours.numpy(), auto.numpy(), rtol=0, atol=tol)
    np.testing.assert_allclose(ours.numpy(), formula, rtol=0, atol=tol)
    # a sample whose every axis sits in the last cell of every level has no gradient
    ones = np.ones((1, 3), np.float32)
    (edge,) = _module_dx(te, ones, ct[:1])
    if all(int(np.floor(s + 0.5)) >= r - 1 for s, r in zip(te.level_scales, te.level_res)):
        assert torch.equal(edge, torch.zeros_like(edge))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_kernel_f_arithmetic_matches_jax_grad(name):
    # the factored derivative of kernel F, in its order in float32, against
    # JAX's autodiff and the float64 sum on the cube's corners and every
    # level's last-cell points: 1e-5 of max |d_x|, as above
    je, te, table = _pair(name)
    x = _points(te, 1)
    ct = np.random.default_rng(2).standard_normal((x.shape[0], te.n_output_dims)).astype(np.float32)

    def f(xx):
        return jnp.sum(je.apply({"table": jnp.asarray(table)}, xx) * ct)

    ref = np.asarray(jax.grad(f)(jnp.asarray(x)))
    ours = _kernel_f_model(te, table, x, ct)
    formula = _dx_formula(te, table, x, ct)
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    np.testing.assert_allclose(ours, formula, rtol=0, atol=1e-5 * np.abs(formula).max())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_kernel_f_records_give_the_slots(name):
    # kernel F's level records, read as the kernel reads them: res − 1, m,
    # offset and the scale's float32 bits; the base slot (cu0 + k1·cu1 +
    # k2·cu2) & mask in uint32 equal to the plain slots on every point; the
    # corner shifts the brick shifts
    _, te, _ = _pair(name)
    x = _points(te, 9)
    rec = te.kernel_records()
    assert rec.dtype == torch.int32 and rec.shape == (te.n_levels, 16) and rec.device.type == "cpu"
    rec = rec.numpy()
    idx = te.brick_fracs(torch.from_numpy(x))[0].numpy()
    for l in range(te.n_levels):
        r = rec[l]
        assert r[0] == te.level_res[l] - 1 and r[1] == te.level_sizes[l] and r[2] == te.level_offsets[l]
        assert r[3:4].view(np.float32)[0] == np.float32(te.level_scales[l])
        assert list(r[8:]) == list(te.brick_shifts[l])
        p = x * r[3:4].view(np.float32)[0] + np.float32(0.5)  # float32 steps, as the kernel rounds them
        cu = np.clip(np.floor(p), 0, r[0]).astype(np.uint32)
        k1, k2, mask = r[4:7].view(np.uint32)
        with np.errstate(over="ignore"):
            base = (cu[:, 0] + cu[:, 1] * k1 + cu[:, 2] * k2) & mask
        np.testing.assert_array_equal(base, idx[l].astype(np.uint32))
    # the records travel in the launch's parameters: at most 32 levels
    deep = tenc.GridEncoding(n_levels=table_ops.DX_MAX_LEVELS + 1, log2_hashmap_size=8, per_level_scale=1.1)
    with pytest.raises(ValueError, match="at most 32 levels"):
        table_ops.grid_encode_dx_cuda(deep.table.detach(), torch.zeros((4, 3)), torch.zeros((4, 2 * deep.n_levels)), deep)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_table_grad_unchanged_with_dx(name):
    # asking for d_x as well changes neither the table gradient nor d_x
    _, te, _ = _pair(name)
    x = _points(te, 5)
    ct = np.random.default_rng(6).standard_normal((x.shape[0], te.n_output_dims)).astype(np.float32)
    out = te(torch.from_numpy(x))
    (table_only,) = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), [te.table])
    dx_both, table_both = _module_dx(te, x, ct, table_grad=True)
    (dx_only,) = _module_dx(te, x, ct)
    assert torch.equal(table_both, table_only)
    assert torch.equal(dx_both, dx_only)


def test_dx_only_backward_writes_no_fracs(monkeypatch):
    # a table that needs no gradient: the forward writes no slots or fracs and
    # the backward runs no table gradient
    _, te, _ = _pair("hash")
    x = _points(te, 7)
    seen, called = [], []
    plain, tg = table_ops.grid_encode_plain, table_ops.table_grad
    monkeypatch.setattr(table_ops, "grid_encode_plain", lambda t, xx, e, with_fracs=True: (seen.append(with_fracs), plain(t, xx, e, with_fracs))[1])
    monkeypatch.setattr(table_ops, "table_grad", lambda *a: (called.append(1), tg(*a))[1])
    ct = np.ones((x.shape[0], te.n_output_dims), np.float32)
    _module_dx(te, x, ct)
    assert seen[0] is False and not called
    te.table.requires_grad_(True)


@pytest.mark.parametrize("edited", [False, True], ids=["plain", "affine-duplicate"])
def test_normals_frame_matches_jax(scene, edited):  # noqa: F811
    # composited frames (a slot's normal is ill-conditioned where ∇σ ≈ 0, but
    # such slots carry almost no weight). The MLP backward rounds to bf16 at
    # other points in the two frameworks (torch each layer's cotangent, JAX
    # its products), a step of 2^-8 relative where a value crosses a rounding
    # boundary: within 1e-4 on 99% of values and 1e-3 on all; depth within
    # 1e-5 as in every mode
    from nerfshop_tpu.common import RenderMode

    ops = ()
    if edited:
        from nerfshop_tpu.editing import operators as jops

        ops = (jops.AffineDuplicationOp.create(center=[0.5, 0.5, 0.5], half_extents=[0.3, 0.3, 0.3],
                                               transform_t=[0.1, 0.0, 0.0]),)
    jr, jd, tr, td = _render_both(scene, dict(mode=RenderMode.Normals), operators=ops)
    assert tr.shape == jr.shape and np.isfinite(tr).all()
    assert jr[..., 3].max() > 0.5 and np.ptp(jr[..., :3]) > 0.2  # normals in view
    err = np.abs(tr - jr)
    assert (err <= 1e-4).mean() >= 0.99 and err.max() <= 1e-3, (err.max(), (err <= 1e-4).mean())
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-5)
    if edited:
        plain = _render_both(scene, dict(mode=RenderMode.Normals))[2]
        assert np.abs(tr - plain).max() > 1e-2  # the operator moved the normals


def test_optimize_mesh_matches_jax():
    # 10 Adam steps from one mesh and one network, with the inflate force.
    # The steps are lr-sized (Adam's m/√s ≈ ±1) whatever the gradient's size,
    # so the vertices follow JAX's to float32 rounding of the update: each
    # coordinate within 1e-6 (~16 ulps at 0.5) of JAX's
    from nerfshop_tpu.config import default_nerf_config
    from nerfshop_tpu.geometry import isosurface as jiso
    from nerfshop_tpu.geometry import mesh_opt as jopt
    from nerfshop_tpu.geometry.mesh_io import TriMesh as JMesh
    from nerfshop_tpu.models import nerf_network as jnn
    from nerfshop_tpu_torch import weights
    from nerfshop_tpu_torch.geometry import mesh_opt as topt
    from nerfshop_tpu_torch.geometry.mesh_io import TriMesh as TMesh
    from nerfshop_tpu_torch.models import nerf_network as tnn

    cfg = default_nerf_config()
    cfg["encoding"].update(n_levels=4, log2_hashmap_size=12, base_resolution=8, per_level_scale=1.5)
    jm = jnn.build_nerf_network(cfg)
    tree = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(3)))
    tree["pos_encoding"]["table"] = np.random.default_rng(5).uniform(-1, 1, tree["pos_encoding"]["table"].shape).astype(np.float32)
    tm = tnn.build_nerf_network(cfg)
    tm.load_state_dict(weights.params_from_jax(tree))
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = {k: v.detach() for k, v in tm.state_dict().items()}

    g = (np.arange(10) + 0.5) / 10
    r = np.sqrt(((np.stack(np.meshgrid(g, g, g, indexing="ij"), -1) - 0.5) ** 2).sum(-1))
    base = jiso.orient_consistently(jiso.marching_tets((0.3 - r).astype(np.float32), 0.0, (0.05,) * 3, (0.1,) * 3))
    assert base.n_vertices > 50
    kw = dict(n_steps=10, thresh=1.0, density_amount=0.1, smooth_amount=4.0, inflate_amount=0.01)
    ref = jopt.optimize_mesh(lambda p: jm.density(jparams, jnp.clip(p, 0, 1)),
                             JMesh(base.vertices.copy(), base.faces.copy()), **kw)
    ours = topt.optimize_mesh(lambda p: tnn.density_with(tm, tparams, torch.clamp(p, 0, 1)),
                              TMesh(base.vertices.copy(), base.faces.copy()), **kw)
    moved = np.abs(ref.vertices - base.vertices)
    assert moved.max() > 5e-4  # ten steps of ~1e-4
    err = np.abs(ours.vertices - ref.vertices)
    assert err.max() <= 1e-6, err.max()
    # the neighbour tables hold the same rings (JAX lists them in set order)
    jn, jc = jopt.build_neighbor_table(base.faces, base.n_vertices)
    tn, tc = topt.build_neighbor_table(base.faces, base.n_vertices)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(np.sort(tn, 1), np.sort(jn, 1))
