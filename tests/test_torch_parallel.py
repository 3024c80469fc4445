"""The port's ``parallel/mesh.py`` (``torch.distributed``) against the JAX
package's ``nerfshop_tpu/parallel/mesh.py``: JAX's data-parallel step, its
error-map variant and its pixel-sharded render on ``make_mesh(2)`` of the
suite's virtual CPU devices (``tests/conftest.py``), the port's on two gloo
processes on the CPU (``tests/torch_ranks.py``: a ``FileStore``
rendezvous, one thread a rank, a timeout a rank), at
``tests/test_parallel.py``'s tiny setup, each rank fed the draws JAX's
shard makes from its ``fold_in`` key.

Tolerances: the mean loss within 1e-4 relative and Adam's first moments
(0.1 × the averaged gradients) within 2e-3 relative L2 a leaf, the bound of
``tests/test_torch_train_step.py`` (both packages round the MLPs' operands
and cotangents to bf16 at the same points; a value on a rounding boundary
can round the other way under another summation order). The new
parameters within 1e-6 + 1e-5·|p| of JAX's wherever the gradient is above
1e-3 of its leaf's largest in both packages; elsewhere within 2·lr + 1e-6:
Adam's first step is lr·g / (|g| + ε), so a tiny gradient that rounds to
the other sign moves its parameter by up to 2·lr. The error map within
1e-3 relative (it sums the rays' losses, read through the same bf16
forward). The sharded frame within 1e-5 of JAX's (its test's bound) and
equal to the port's serial frame bit for bit (per-ray arithmetic; the same
chunk function on whole chunks). The two ranks' states, error maps and
grids bit-equal. The two-rank gradients against one process's over the
union of the draws: the table's within 1e-5 relative L2 (float32 sums
split in two); the MLP weights' within 2^-7, since each weight's gradient
is rounded to bf16 after its sum over the rays (the backward of its bf16
cast), on each rank before the mean and once over the union (read
1.4-2.8e-3)."""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfshop_tpu.ops import grid as jgrid, rays as jrays
from nerfshop_tpu.parallel import mesh as jmesh
from nerfshop_tpu.render import renderer as jrenderer
from nerfshop_tpu.train import nerf as jnerf, optim as joptim
from nerfshop_tpu_torch import weights
from nerfshop_tpu_torch.parallel import mesh as tmesh
from nerfshop_tpu_torch.train import nerf as tnerf
from test_parallel import _tiny_setup
from torch_one_thread import one_thread  # noqa: F401
from torch_ranks import run_ranks
import torch_ranks

GRID = dict(n_input_dims=3, n_levels=4, n_features_per_level=2, log2_hashmap_size=12, base_resolution=8,
            per_level_scale=1.5)
OPTIMIZER = {"otype": "Adam", "learning_rate": 1e-2}
LR = 1e-2
REL = 2e-3
#: an MLP weight's gradient is rounded to bf16 after its sum over the rays
#: (the backward of the weight's bf16 cast), once a rank and once over the
#: union: two roundings of 2^-8 apart
BF16_SUM_REL = 2.0**-7


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _torch(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _shard_draws(key, n, k_samples, images, error_map=None):
    """The draws ``make_grad_fn`` makes from a shard's key
    (train/nerf.py:231-262, ops/rays.py:243-269, the march's split)."""
    k_rays, k_march, k_bg, _ = jax.random.split(key, 4)
    img_idx, pix, _ = jrays.sample_training_pixels(k_rays, n, images, error_map)
    k1, k2 = jax.random.split(k_march)
    return _torch(img_idx, pix, jax.random.uniform(k1, (n,)), jax.random.uniform(k2, (n, k_samples)),
                  jax.random.uniform(k_bg, (n, 3)))


def _adam_mu(opt_state):
    (mu,) = [s.mu for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")]
    return weights.params_from_jax(jax.tree.map(np.asarray, mu))


def _ball_grid():
    g = (np.arange(128) + 0.5) / 128
    xx, yy, zz = np.meshgrid(g, g, g, indexing="ij")
    occ = (((xx - 0.5) ** 2 + (yy - 0.5) ** 2 + (zz - 0.5) ** 2) < 0.2**2)[None]
    return occ, np.where(occ, 5.0, 0.0).astype(np.float32)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """JAX's parallel step, error-map step and sharded render on a 2-device
    mesh, and the port's two gloo ranks on the same weights and draws →
    (JAX's results, the ranks' results)."""
    model, cfg, spec, data = _tiny_setup()
    params = model.init(jax.random.PRNGKey(0))
    mesh = jmesh.make_mesh(2)
    grid = jgrid.OccupancyGrid.create(1)
    key = jax.random.PRNGKey(1)
    n_local = cfg.n_rays_per_batch // 2
    state = jmesh.replicate(mesh, joptim.create_train_state(params, spec))
    new_state, aux = jax.jit(jmesh.make_parallel_train_step(model, spec, cfg, mesh))(state, grid, data, key)
    draws = [_shard_draws(jax.random.fold_in(key, r), n_local, cfg.k_samples, data.images) for r in range(2)]

    cfg_em = dataclasses.replace(cfg, use_error_map=True, error_map_resolution=8, error_map_decay=0.9)
    em = jnerf.create_error_map(data.images.shape[0], 8)
    new_state_em, aux_em, new_em = jax.jit(jmesh.make_parallel_train_step(model, spec, cfg_em, mesh))(
        state, grid, data, key, em)
    em_draws = [_shard_draws(jax.random.fold_in(key, r), n_local, cfg.k_samples, data.images, em) for r in range(2)]

    occ, density = _ball_grid()
    rgrid = grid._replace(occupancy=jnp.asarray(occ), density=jnp.asarray(density))
    W, H = 32, 24
    xf = np.asarray([[1.0, 0, 0, 0.5], [0, 1.0, 0, 0.5], [0, 0, 1.0, -0.6]], np.float32)
    focal = np.asarray([30.0, 30.0], np.float32)
    opts = dict(k_samples=16, n_candidates=256, n_windows=1, chunk=W * H)
    rgba, depth = jmesh.render_frame_sharded(model, params, rgrid, mesh, (W, H), jnp.asarray(xf), jnp.asarray(focal),
                                             opts=jrenderer.RenderOptions(**opts))

    payload = {
        "grid": GRID, "weights": weights.params_from_jax(jax.tree.map(np.asarray, params)),
        "data": dict(zip(("images", "xforms", "focals", "principals", "distortions"),
                         _torch(data.images, data.xforms, data.focals, data.principals, data.distortions))),
        "cfg": {k: getattr(cfg, k) for k in tnerf.NerfTrainConfig.__dataclass_fields__},
        "optimizer": OPTIMIZER, "draws": draws, "em_draws": em_draws, "error_map": _torch(em)[0],
        "render": {"density": torch.from_numpy(density), "occupancy": torch.from_numpy(occ), "opts": opts,
                   "resolution": (W, H), "xform": torch.from_numpy(xf), "focal": torch.from_numpy(focal)},
    }
    ranks = run_ranks("parallel_job", 2, payload, tmp_path_factory.mktemp("ranks"))
    jax_out = {
        "loss": float(aux["loss"]), "params": weights.params_from_jax(jax.tree.map(np.asarray, new_state.params)),
        "mu": _adam_mu(new_state.opt_state), "em_loss": float(aux_em["loss"]), "em": np.asarray(new_em),
        "em_params": weights.params_from_jax(jax.tree.map(np.asarray, new_state_em.params)),
        "em_mu": _adam_mu(new_state_em.opt_state),
        "rgba": np.asarray(rgba), "depth": np.asarray(depth),
    }
    return jax_out, ranks


def _check_params(got: dict, ref: dict, mu_got: dict, mu_ref: dict):
    for name, p in ref.items():
        p, q = p.numpy(), got[name].numpy()
        g_ref, g_got = np.abs(mu_ref[name].numpy()), np.abs(mu_got[name].numpy())
        big = (g_ref > 1e-3 * g_ref.max()) & (g_got > 1e-3 * g_got.max())
        assert big.any(), name
        np.testing.assert_allclose(q[big], p[big], rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(q, p, rtol=0, atol=2 * LR + 1e-6, err_msg=name)


def test_parallel_step_matches_jax(case):
    jx, ranks = case
    r0 = ranks[0]
    np.testing.assert_allclose(float(r0["loss"]), jx["loss"], rtol=1e-4)
    mu = {k[len("adam.exp_avg."):]: v for k, v in r0.items() if k.startswith("adam.exp_avg.")}
    assert set(mu) == set(jx["mu"])
    for name, m in mu.items():
        assert float(m.abs().max()) > 0, name
        assert _rel(m.numpy(), jx["mu"][name].numpy()) < REL, (name, _rel(m.numpy(), jx["mu"][name].numpy()))
    got = {k[len("param."):]: v for k, v in r0.items() if k.startswith("param.")}
    _check_params(got, jx["params"], mu, jx["mu"])


def test_parallel_error_map_step_matches_jax(case):
    jx, ranks = case
    r0 = ranks[0]
    np.testing.assert_allclose(float(r0["em_loss"]), jx["em_loss"], rtol=1e-4)
    d = jx["em"] - np.ones_like(jx["em"]) * 0.9
    assert (d >= -1e-6).all() and d.sum() > 0  # deposits landed, the decay once
    np.testing.assert_allclose(r0["em"].numpy(), jx["em"], rtol=1e-3, atol=1e-6)
    got = {k[len("em.param."):]: v for k, v in r0.items() if k.startswith("em.param.")}
    mu = {k[len("em.adam.exp_avg."):]: v for k, v in r0.items() if k.startswith("em.adam.exp_avg.")}
    for name, m in mu.items():
        assert _rel(m.numpy(), jx["em_mu"][name].numpy()) < REL, name
    _check_params(got, jx["em_params"], mu, jx["em_mu"])


def test_render_frame_sharded_matches_jax_and_the_serial_frame(case):
    jx, ranks = case
    for r in ranks:
        np.testing.assert_allclose(r["rgba"].numpy(), jx["rgba"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(r["depth"].numpy(), jx["depth"], rtol=0, atol=1e-5)
    assert float(ranks[0]["rgba"][..., 3].max()) > 0.01  # something rendered
    assert torch.equal(ranks[0]["rgba"], ranks[0]["serial_rgba"]) and torch.equal(ranks[0]["depth"], ranks[0]["serial_depth"])


def test_ranks_stay_bit_equal(case):
    # the states after the step, the error-map step and a 3-step run with
    # the EMA and a grid refresh on draws alike on every rank, the new
    # error map, the frame, and a grid replicated from rank 0
    _, (r0, r1) = case
    keys = [k for k in r0 if k.startswith(("param.", "adam.", "em", "run.", "rep.")) or k in ("lr", "rgba", "depth")]
    assert {"run.ema.pos_encoding.table", "run.grid.density", "run.step", "em", "rep.occupancy"} <= set(keys)
    for k in keys:
        assert torch.equal(r0[k], r1[k]), k
    assert int(r0["run.step"]) == 3 and float(r0["run.grid.density"].max()) > 0
    assert all(np.isfinite(float(r0[f"run.loss{i}"])) for i in range(3))
    assert not torch.equal(r0["run.ema.pos_encoding.table"], r0["run.param.pos_encoding.table"])


def test_two_rank_gradients_match_one_process_over_the_union(case):
    _, (r0, _) = case
    np.testing.assert_allclose(float(r0["loss"]), float(r0["union_loss"]), rtol=1e-6)
    names = [k[len("union."):] for k in r0 if k.startswith("union.")]
    assert len(names) == len([k for k in r0 if k.startswith("grad.")])
    for name in names:
        g, u = r0[f"grad.{name}"].numpy(), r0[f"union.{name}"].numpy()
        bound = BF16_SUM_REL if "mlp" in name else 1e-5
        assert np.abs(u).max() > 0 and _rel(g, u) < bound, (name, _rel(g, u))


def test_step_needs_the_world_to_divide_the_batch():
    cfg = tnerf.NerfTrainConfig(n_rays_per_batch=256)
    spec = None
    with pytest.raises(ValueError, match="not divisible by mesh size 3"):
        tmesh.make_parallel_train_step(None, spec, cfg, tmesh.Mesh(None, 3, 0, torch.device("cpu")))
    step = tmesh.make_parallel_train_step(None, spec, cfg, tmesh.Mesh(None, 4, 1, torch.device("cpu")))
    assert step.local_cfg.n_rays_per_batch == 64


def test_mesh_needs_an_initialised_group_and_shards_rays():
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.make_mesh("cpu")
    mesh = tmesh.Mesh(None, 2, 1, torch.device("cpu"))
    a, b = tmesh.shard_rays(mesh, torch.arange(8), torch.arange(16).reshape(8, 2))
    assert a.tolist() == [4, 5, 6, 7] and b[:, 0].tolist() == [8, 10, 12, 14]
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.shard_rays(mesh, torch.arange(7))
    # each rank's generator is its own, and any rank can remake another's
    g1, g1_again = tmesh.rank_generator(mesh, 5), tmesh.rank_generator(tmesh.Mesh(None, 2, 0, mesh.device), 5, rank=1)
    g0 = tmesh.rank_generator(mesh, 5, rank=0)
    a, b, c = (torch.rand(4, generator=g) for g in (g1, g1_again, g0))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_run_ranks_kills_a_hung_rank(tmp_path):
    # the job named module:function; rank 0 returns (one thread, the CPU;
    # on a loaded machine it may not have started in time), rank 1 outlives
    # the deadline: the caller fails, and the ranks are killed
    t0 = time.monotonic()
    with pytest.raises(AssertionError, match=r"ranks \[(0, )?1\] of torch_ranks:hang_job \(gloo\) did not end within 5.0 s"):
        run_ranks("torch_ranks:hang_job", 2, {"seconds": 600}, tmp_path, timeout=5.0)
    assert time.monotonic() - t0 < 30 and torch_ranks.RANK_TIMEOUT == 120.0
