"""The hash grid at four features a level (``configs/nerf/tpu_hash_fast.json``:
8 levels × F = 4) against the JAX package on the CPU: the encode forward,
the table gradient (the sort, the segment sums and the corner fold), the
position gradient and the second order (``DensityFns.bwd_bwd_input``,
``nerfshop_tpu/torch_interop.py:55``) against ``make_brick_encode`` and its
autodiff at D = 3 and 2 on a small grid (4 levels, a 2^12 table); kernel
J's plain closed form against autograd at F = 4; then the whole network's
forward and one training step with its Adam + EMA update at
``tpu_hash_fast.json`` with the table cut to 2^14 rows.

On the CPU every wrapper runs its plain version; the kernels' F = 4
instances are held to those plain versions on the card by
``chip_smoke.py``'s [hash-fast] phase. Tolerances: fp32 in another
summation order, 1e-5 of the largest entry (forward, table and position
gradients, J's closed form); through the MLPs, whose operands both packages
round to bf16 (a value on a rounding boundary can round the other way under
another summation order), 2e-3 relative L2, as the F = 2 tests."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfshop_tpu import torch_interop as jinterop
from nerfshop_tpu.models import encodings as jenc
from nerfshop_tpu.models import mlp as jmlp
from nerfshop_tpu.models import nerf_network as jnn
from nerfshop_tpu.ops import coords as jcoords, march as jmarch, rays as jrays
from nerfshop_tpu.train import losses as jlosses, nerf as jnerf, optim as joptim
from nerfshop_tpu_torch import torch_interop as tinterop
from nerfshop_tpu_torch import weights
from nerfshop_tpu_torch.config import load_network_config
from nerfshop_tpu_torch.models import encodings as tenc
from nerfshop_tpu_torch.models import mlp as tmlp
from nerfshop_tpu_torch.models import nerf_network as tnn
from nerfshop_tpu_torch.ops import grid as tgrid, table_ops
from nerfshop_tpu_torch.train import nerf as tnerf, optim as toptim
from test_torch_train_step import _models, _rel, sphere_dataset
from torch_one_thread import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
GRID = dict(n_levels=4, n_features_per_level=4, log2_hashmap_size=12, base_resolution=8, per_level_scale=2.2)
REL = 2e-3


def _pair(D, seed=0):
    je = jenc.GridEncoding(n_input_dims=D, **GRID)
    te = tenc.GridEncoding(n_input_dims=D, **GRID)
    table = np.asarray(je.init(jax.random.PRNGKey(seed))["table"]) * 1e3  # O(0.1) features
    with torch.no_grad():
        te.table.copy_(torch.from_numpy(table))
    return je, te, table


def _points(D, seed, n=384):
    """Uniform points in [0, 1]^D with the corners of the box and points on
    the faces (the clamp at the last cell)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, D)).astype(np.float32)
    corners = np.array([[(c >> d) & 1 for d in range(D)] for c in range(1 << D)], np.float32)
    x[: len(corners)] = corners
    x[len(corners): len(corners) + D] = np.where(np.eye(D, dtype=bool), 1.0, 0.37).astype(np.float32)
    return x


@pytest.mark.parametrize("D", [3, 2])
def test_f4_level_metadata_and_forward_match_jax(D):
    # the slots equal, the features within 1e-6 (fp32, another corner order)
    je, te, table = _pair(D)
    assert te.level_sizes == je.level_sizes and te.brick_shifts == je._brick_shifts
    assert te.n_output_dims == je.n_output_dims == 16
    x = _points(D, 1)
    ji, jw = je._brick_fracs(jnp.asarray(x))
    ti, tw = te.brick_fracs(torch.from_numpy(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    ref = np.asarray(je.apply({"table": jnp.asarray(table)}, jnp.asarray(x)))
    with torch.no_grad():
        out = te(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    # both of kernel B's modes give the same features
    full, idx, w1 = table_ops.grid_encode(te.table.detach(), torch.from_numpy(x), te, with_fracs=True)
    assert idx.shape == (4, x.shape[0]) and w1.shape == (4, x.shape[0], D)
    assert torch.equal(full, torch.from_numpy(out))


@pytest.mark.parametrize("D", [3, 2])
def test_f4_table_and_position_gradients_match_jax(D):
    # d_table through the sort, kernel A's plain version and the corner fold
    # (one torch.roll a corner, rows of 2^D × 4), and d_x through kernel F's
    # plain version, against jax.grad: 1e-5 of the largest entry
    je, te, table = _pair(D)
    x = _points(D, 3)
    ct = np.random.default_rng(4).standard_normal((x.shape[0], te.n_output_dims)).astype(np.float32)

    def f(t, xx):
        return jnp.sum(je.apply({"table": t}, xx) * ct)

    ref_t, ref_x = (np.asarray(a) for a in jax.grad(f, argnums=(0, 1))(jnp.asarray(table), jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = te(xt)
    assert type(out.grad_fn).__name__ == "GridEncodeFunctionBackward"
    d_table, d_x = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), [te.table, xt])
    assert np.abs(ref_t).max() > 0 and np.abs(ref_x).max() > 1e-2
    np.testing.assert_allclose(d_table.numpy(), ref_t, rtol=0, atol=1e-5 * np.abs(ref_t).max())
    np.testing.assert_allclose(d_x.numpy(), ref_x, rtol=0, atol=1e-5 * np.abs(ref_x).max())
    # the fold by hand: the brick rows' sum for one level, rolled corner by corner
    idx, w1 = te.brick_fracs(torch.from_numpy(x))
    dB = table_ops.segsum.sorted_segment_rowsum_plain(
        *(t.contiguous() for t in _sorted_level(idx, w1, torch.from_numpy(ct), te, 1)), te.level_sizes[1])
    assert dB.shape == (te.level_sizes[1], (1 << D) * 4)
    lo, hi = te.level_offsets[1], te.level_offsets[2]
    np.testing.assert_allclose(table_ops.fold_corners(dB, te, 1).numpy(), ref_t[lo:hi], rtol=0,
                               atol=1e-5 * np.abs(ref_t).max())


def _sorted_level(idx, w1, ct, te, level):
    """One level's (keys, fractions, cotangents) sorted by slot, as
    ``table_grad`` hands them to kernel A."""
    F = te.n_features_per_level
    dout = ct.reshape(ct.shape[0], te.n_levels, F)[:, level]
    keys, perm = torch.sort(idx[level], stable=True)
    return keys, w1[level][perm], dout[perm]


def test_f4_kernel_j_plain_matches_autograd():
    # kernel J's closed form (dh, d_x2) against autograd of the plain
    # encode's position gradient at F = 4: 1e-5 of the largest entry
    _, te, _ = _pair(3)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(_points(3, 6))
    g = torch.from_numpy(rng.standard_normal((x.shape[0], te.n_output_dims)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((x.shape[0], 3)).astype(np.float32))
    dh, dx2 = table_ops.grid_encode_dx_bwd_plain(te.table, x, g, v, te)
    xg = x.clone().requires_grad_(True)
    gg = g.clone().requires_grad_(True)
    out = table_ops.grid_encode_plain(te.table.detach(), xg, te, with_fracs=False)[0]
    (dx,) = torch.autograd.grad(out, xg, gg, create_graph=True)
    ref_x2, ref_dh = torch.autograd.grad(dx, (xg, gg), v)
    assert dh.shape == g.shape and float(ref_dh.abs().max()) > 0 and float(ref_x2.abs().max()) > 0
    for ours, ref in ((dh, ref_dh), (dx2, ref_x2)):
        np.testing.assert_allclose(ours.numpy(), ref.numpy(), rtol=0, atol=1e-5 * float(ref.abs().max()))


def test_f4_density_second_order_matches_jax():
    # the density module at F = 4 (a 4-level grid, 16-wide MLPs) against
    # JAX's DensityFns: forward within 1e-5 of max, bwd and bwd_bwd_input
    # within 2e-3 relative L2 (bf16 MLP operands)
    kw = dict(n_input_dims=3, **{**GRID, "log2_hashmap_size": 10, "base_resolution": 4, "per_level_scale": 1.5})
    jm = jnn.NerfNetwork(
        pos_encoding=jenc.GridEncoding(**kw), dir_encoding=jenc.SphericalHarmonicsEncoding(degree=4),
        density_mlp=jmlp.MLP(n_input_dims=16, n_output_dims=16, n_neurons=16, n_hidden_layers=1),
        rgb_mlp=jmlp.MLP(n_input_dims=32, n_output_dims=3, n_neurons=16, n_hidden_layers=1),
    )
    jp = jm.init(jax.random.PRNGKey(0))
    jp["pos_encoding"]["table"] = jp["pos_encoding"]["table"] * 1e3
    tm = tnn.NerfNetwork(
        pos_encoding=tenc.GridEncoding(**kw), dir_encoding=tenc.SphericalHarmonicsEncoding(degree=4),
        density_mlp=tmlp.MLP(16, 16, n_neurons=16, n_hidden_layers=1),
        rgb_mlp=tmlp.MLP(32, 3, n_neurons=16, n_hidden_layers=1),
    )
    tm.load_state_dict(weights.params_from_jax(jax.tree.map(np.asarray, jp)))
    rng = np.random.default_rng(3)
    N = 48
    pos = rng.uniform(0.05, 0.95, (N, 3)).astype(np.float32)
    d_out = rng.normal(size=(N, 16)).astype(np.float32)
    d_dpos = rng.normal(size=(N, 3)).astype(np.float32)
    jf, fns = jinterop.DensityFns(jm, jp), tinterop.NerfDensityModule(tm).fns
    ref = jf.fwd_density(pos)
    out = fns.fwd_density(torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    g_ref = jf.bwd_density(pos, d_out)
    g = fns.bwd_density(torch.from_numpy(pos), torch.from_numpy(d_out)).numpy()
    assert np.abs(g_ref).max() > 1.0 and _rel(g, g_ref) < REL
    ref_pos2, ref_dout = jf.bwd_bwd_input_density(pos, d_out, d_dpos)
    d_pos2, d_dout = fns.bwd_bwd_input_density(*(torch.from_numpy(a) for a in (pos, d_out, d_dpos)))
    assert np.abs(ref_pos2).max() > 1.0 and np.abs(ref_dout).max() > 1.0
    assert _rel(d_pos2.numpy(), ref_pos2) < REL, _rel(d_pos2.numpy(), ref_pos2)
    assert _rel(d_dout.numpy(), ref_dout) < REL, _rel(d_dout.numpy(), ref_dout)


def _hash_fast(log2_size=14):
    """``tpu_hash_fast.json``, the table cut to 2^``log2_size`` rows a level
    (the full 2^19 is the card's)."""
    cfg = load_network_config(ROOT / "configs/nerf/tpu_hash_fast.json")
    cfg["encoding"] = {**cfg["encoding"], "log2_hashmap_size": log2_size}
    return cfg


def step_grads(cfg, seed=0, R=64, K=16):
    """One training step's loss and gradients in both packages from the
    same weights (JAX's, seeded) and the same draws on the 3-view sphere of
    ``tests/test_torch_train_step.py`` (a random occupancy, the mean density
    0) → (JAX model, params, port model, JAX loss, JAX grads, port loss,
    port grads by name)."""
    ds = sphere_dataset(3, 16)
    jm, jp, tm = _models(cfg, seed=seed)
    tcfg = tnerf.NerfTrainConfig(n_rays_per_batch=R, k_samples=K, n_candidates=256, near_distance=0.05)
    rng = np.random.default_rng(seed + 1)
    img_idx = rng.integers(0, 3, R).astype(np.int32)
    pix = np.floor(rng.uniform(0, 1, (R, 2)) * 16).astype(np.float32)
    t_jitter = rng.uniform(0, 1, R).astype(np.float32)
    spread = rng.uniform(0, 1, (R, K)).astype(np.float32)
    bg = rng.uniform(0, 1, (R, 3)).astype(np.float32)
    ijk = (np.indices((128,) * 3).transpose(1, 2, 3, 0) + 0.5) / 128
    occ = (np.linalg.norm(ijk - 0.5, axis=-1) < 0.3 + rng.uniform(-0.05, 0.05, (128,) * 3))[None]

    dev = jnerf.DeviceDataset.from_dataset(ds)
    bundle = jrays.rays_from_pixels(jnp.asarray(img_idx), jnp.asarray(pix), dev.xforms, dev.focals, dev.principals,
                                    jnp.asarray([16.0, 16.0]), dev.distortions)
    aabb = jcoords.BoundingBox.from_aabb_scale(1)
    samples = jmarch.march_rays(
        bundle.origins, bundle.directions, jnp.asarray(occ), aabb.min, aabb.max, jnp.asarray(0.0),
        t_jitter=jnp.asarray(t_jitter), t_start_min=0.05, k_samples=K, n_candidates=256,
        selection="spread", spread_rng=jnp.asarray(spread),
    )
    targets = dev.images[img_idx, pix[:, 1].astype(int), pix[:, 0].astype(int)]
    (jl, jaux), jg = jax.value_and_grad(jnerf.nerf_loss_fn, has_aux=True)(
        jp, jm, samples, bundle.origins, bundle.directions, targets, jnp.asarray(bg), aabb,
        jlosses.huber, tcfg.min_transmittance, near_distance=0.05, mean_grid_density=jnp.asarray(0.0, jnp.float32),
    )
    grid = tgrid.OccupancyGrid(torch.zeros(1, 128, 128, 128), torch.from_numpy(occ), torch.tensor(0.0))
    grads, aux = tnerf.grads_from_draws(
        tm, grid, tnerf.DeviceDataset.from_dataset(ds, "cpu"), tcfg, torch.from_numpy(img_idx),
        torch.from_numpy(pix), torch.from_numpy(t_jitter), torch.from_numpy(spread), torch.from_numpy(bg),
    )
    assert int(aux["measured_samples"]) == int(jaux["measured_samples"]) > R
    return jm, jp, tm, float(jl), jg, float(aux["loss"]), grads


def test_hash_fast_network_forward_matches():
    # 8 levels × F = 4, the 32→64→16 and 32→64→64→3 MLPs of base.json:
    # within 2e-3 relative L2 (bf16 numerics), as the default config's
    cfg = _hash_fast()
    assert cfg["encoding"]["n_features_per_level"] == 4 and cfg["encoding"]["n_levels"] == 8
    jm, jp, tm = _models(cfg, seed=5)
    assert tm.pos_encoding.n_output_dims == 32 and tm.pos_encoding.table.shape[1] == 4
    x = np.random.default_rng(6).uniform(0, 1, (256, 3)).astype(np.float32)
    d = np.random.default_rng(7).uniform(0, 1, (256, 3)).astype(np.float32)
    jrgb, jsig = jm(jp, jnp.asarray(x), jnp.asarray(d))
    with torch.no_grad():
        trgb, tsig = tm(torch.from_numpy(x), torch.from_numpy(d))
    assert _rel(trgb.numpy(), jrgb) < REL and _rel(tsig.numpy(), jsig) < REL


def test_hash_fast_training_step_matches():
    # one step's loss (1e-4 relative) and gradients (every leaf within 2e-3
    # relative L2) from the same draws, then the config's Adam + EMA update
    # of each package from its own gradients
    cfg = _hash_fast()
    jm, jp, tm, jl, jg, tl, grads = step_grads(cfg)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    jgrads = weights.params_from_jax(jax.tree.map(np.asarray, jg))
    assert set(jgrads) == set(grads)
    for name, g in grads.items():
        assert float(g.abs().max()) > 0 and _rel(g.numpy(), jgrads[name].numpy()) < REL, name
    check_adam_step(cfg, jp, jg, tm, grads)


def check_adam_step(cfg, jp, jg, tm, grads):
    """The config's Adam + EMA update of each package from its own
    gradients: parameters and EMA within 1e-5 (rtol) of optax's. The first
    step moves a weight by about the learning rate times the sign of its
    gradient plus ``l2_reg`` times the weight, so where such an entry near 0
    takes the other sign under bf16 rounding (at most 1% of a leaf) the two
    differ by that step; elsewhere they agree."""
    spec = joptim.build_optimizer(dict(cfg["optimizer"]))
    jstate = joptim.apply_gradients(joptim.create_train_state(jp, spec), jg, spec)
    before = {name: p.detach().clone() for name, p in tm.named_parameters()}
    tstate = toptim.TrainState(tm, toptim.build_optimizer(dict(cfg["optimizer"])))
    tstate.apply_gradients(grads)
    assert tstate.step == 1
    jparams = weights.params_from_jax(jax.tree.map(np.asarray, jstate.params))
    jema = weights.params_from_jax(jax.tree.map(np.asarray, jstate.ema_params))
    jgrads = weights.params_from_jax(jax.tree.map(np.asarray, jg))
    l2 = tstate.spec.adam.get("l2_reg", 0.0)
    for name, p in tm.named_parameters():
        same = np.sign((grads[name] + l2 * before[name]).numpy()) == np.sign((jgrads[name] + l2 * before[name]).numpy())
        assert same.mean() > 0.99, (name, same.mean())
        np.testing.assert_allclose(p.detach().numpy()[same], jparams[name].numpy()[same], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(tstate.ema[name].numpy()[same], jema[name].numpy()[same], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("F", [1, 8])
def test_kernel_wrappers_refuse_other_feature_counts(F):
    # B, F and J take F = 2 or 4 and raise on any other, before touching a
    # tensor; the range check names kernels B and A for the card
    enc = tenc.GridEncoding(n_input_dims=3, n_levels=2, n_features_per_level=F, log2_hashmap_size=8)
    x = torch.rand(4, 3)
    table = enc.table.detach()
    with pytest.raises(ValueError, match="F=2 or 4"):
        table_ops.grid_encode_cuda(table, x, enc)
    with pytest.raises(ValueError, match="F=2 or 4"):
        table_ops.grid_encode_dx_cuda(table, x, torch.zeros(4, 2 * F), enc)
    with pytest.raises(ValueError, match="F=2 or 4"):
        table_ops.grid_encode_dx_bwd_cuda(table, x, torch.zeros(4, 2 * F), torch.zeros(4, 3), enc)
    with pytest.raises(ValueError, match=f"kernels B .* n_features_per_level {F}"):
        table_ops.check_supported(3, F)
    # and the CPU takes them through the plain versions
    out = table_ops.grid_encode(table, x, enc, with_fracs=False)[0]
    assert out.shape == (4, 2 * F)
