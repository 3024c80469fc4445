"""The NeRF training state's leaves outside the network in snapshots: the
pose deltas, log exposures and distortion map (``camera.*``) and the
trainable envmap, which the port keeps in ``TrainState.extra`` and JAX in
its ``params`` pytree (``camera``, ``envmap``), saved under the same flat
paths (``/camera/rot`` …, ``/envmap``) with their EMA copy.

A port testbed with every camera knob and the envmap on round-trips them
and their EMA bit-equal, and renders the same frame; its snapshot loads in
a JAX testbed with the same knobs and JAX's loads in the port, both at 0
difference; a snapshot without the leaves loads into a testbed without
them as before, and where the two differ the port does what JAX's
``_restore_like`` does (a leaf the testbed has and the snapshot lacks
raises ``KeyError``, a snapshot leaf the testbed lacks is ignored)."""

import jax
import numpy as np
import pytest
import torch

from nerfshop_tpu.testbed import Testbed as JTestbed
from nerfshop_tpu_torch import weights
from nerfshop_tpu_torch.io import snapshot as tsnap
from nerfshop_tpu_torch.ops import grid as tgrid
from nerfshop_tpu_torch.testbed import Testbed as TTestbed
from test_torch_train_step import TINY, look_at, sphere_dataset
from torch_one_thread import one_thread  # noqa: F401

#: TINY with an EMA, so that the EMA copies of the leaves are saved too
CFG = dict(TINY, optimizer={"otype": "Ema", "decay": 0.95, "nested": {"otype": "Adam", "learning_rate": 1e-2}})
EXTRA = {"camera.rot", "camera.trans", "camera.log_exposure", "camera.distortion_map", "envmap"}
W, H = 12, 8
EYE = np.array([1.7, 0.4, 0.9], np.float32)


def _knobs(tb, on=True):
    t = tb.nerf.training
    t.optimize_extrinsics = t.optimize_exposure = t.optimize_distortion = t.train_envmap = on
    return tb


def _port_testbed(seed=0):
    """A port testbed with every camera knob and the envmap on, over the
    3-view sphere, its leaves and their EMA set to seeded values (live ≠
    EMA) and its grid to a seeded density."""
    tb = _knobs(TTestbed("nerf", config=CFG, device="cpu", seed=seed))
    tb.set_training_data(sphere_dataset(3, 16))
    state = tb._state
    assert set(state.extra) == set(state.extra_ema) == EXTRA
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for group in (state.extra, state.extra_ema):
            for k, v in group.items():
                v.copy_(torch.from_numpy(rng.uniform(0.0, 0.3, tuple(v.shape)).astype(np.float32)))
    return _seed_grid(tb, rng)


def _seed_grid(tb, rng):
    """The testbed's grid set to a seeded density, its bitfield updated."""
    tb.grid.density.copy_(torch.from_numpy(rng.uniform(0, 5, tuple(tb.grid.density.shape)).astype(np.float32)))
    tgrid.update_bitfield(tb.grid)
    return tb


def _frame(tb):
    return tb.render(W, H, linear=True, camera_matrix=look_at(EYE)).copy()


def _leaves(tb):
    """(live, EMA) of the port testbed's extra leaves as numpy."""
    s = tb._state
    return ({k: v.detach().numpy().copy() for k, v in s.extra.items()},
            {k: v.numpy().copy() for k, v in s.extra_ema.items()})


def _jax_leaves(jtb):
    """(live, EMA) of the JAX testbed's camera and envmap leaves, by the
    port's names."""
    def pick(tree):
        flat = weights.params_from_jax(jax.tree.map(np.asarray, tree))
        return {k: v.numpy() for k, v in flat.items() if k in EXTRA}

    return pick(jtb._state.params), pick(jtb._state.ema_params)


def _assert_leaves_equal(got, ref):
    for g, r in zip(got, ref):
        assert set(g) == set(r) == EXTRA
        for k in EXTRA:
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


def test_port_round_trip_keeps_the_leaves_and_their_ema(tmp_path):
    a = _port_testbed(1)
    path = tmp_path / "a.snap"
    a.save_snapshot(str(path))
    snap = tsnap.load_snapshot(path)
    assert {"/camera/rot", "/camera/trans", "/camera/log_exposure", "/camera/distortion_map",
            "/envmap"} <= set(snap["params"]) & set(snap["ema_params"])
    b = _knobs(TTestbed(device="cpu", seed=5))
    b.load_snapshot(str(path))
    _assert_leaves_equal(_leaves(b), _leaves(a))
    for k, v in b._state.extra.items():  # still the leaves the optimizer steps
        assert v.requires_grad and v.is_leaf, k
    assert np.array_equal(_frame(b), _frame(a))
    assert float(np.abs(_frame(b)).max()) > 0


def test_port_snapshot_loads_in_jax_and_back(tmp_path):
    # port → JAX at 0 difference; JAX moves the leaves, saves, and the port
    # loads JAX's snapshot at 0 difference
    src = _port_testbed(2)
    path = tmp_path / "port.snap"
    src.save_snapshot(str(path))
    jtb = _knobs(JTestbed())
    jtb.load_snapshot(str(path))
    _assert_leaves_equal(_jax_leaves(jtb), _leaves(src))

    rng = np.random.default_rng(9)
    params, ema = (jax.tree.map(np.asarray, t) for t in (jtb._state.params, jtb._state.ema_params))
    for tree in (params, ema):
        tree["envmap"] = rng.uniform(0, 1, tree["envmap"].shape).astype(np.float32)
        tree["camera"] = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in tree["camera"].items()}
    jtb._state = jtb._state._replace(params=jax.tree.map(jax.numpy.asarray, params),
                                     ema_params=jax.tree.map(jax.numpy.asarray, ema))
    back = tmp_path / "jax.snap"
    jtb.save_snapshot(str(back))
    dst = _knobs(TTestbed(device="cpu", seed=3))
    dst.load_snapshot(str(back))
    _assert_leaves_equal(_leaves(dst), _jax_leaves(jtb))


def test_snapshots_and_testbeds_without_the_leaves(tmp_path):
    # without the leaves on either side: loads as before, nothing extra saved
    plain = TTestbed("nerf", config=CFG, device="cpu", seed=4)
    plain.set_training_data(sphere_dataset(3, 16))
    _seed_grid(plain, np.random.default_rng(4))
    assert not plain._state.extra
    bare = tmp_path / "bare.snap"
    plain.save_snapshot(str(bare))
    assert not any(k.startswith(("/camera", "/envmap")) for k in tsnap.load_snapshot(bare)["params"])
    again = TTestbed(device="cpu", seed=6)
    again.load_snapshot(str(bare))
    assert not again._state.extra
    assert np.array_equal(_frame(again), _frame(plain))

    # a snapshot with the leaves into a testbed without them: ignored, in
    # both packages
    full = tmp_path / "full.snap"
    src = _port_testbed(7)
    src.save_snapshot(str(full))
    ours = TTestbed(device="cpu", seed=6)
    ours.load_snapshot(str(full))
    assert not ours._state.extra
    for k, v in src.inference_params.items():
        assert torch.equal(ours.inference_params[k], v), k
    theirs = JTestbed()
    theirs.load_snapshot(str(full))
    assert "camera" not in theirs._state.params and "envmap" not in theirs._state.params

    # a testbed with the leaves and a snapshot without them: KeyError, in
    # both packages
    with pytest.raises(KeyError):
        _knobs(TTestbed(device="cpu", seed=6)).load_snapshot(str(bare))
    with pytest.raises(KeyError):
        _knobs(JTestbed()).load_snapshot(str(bare))
