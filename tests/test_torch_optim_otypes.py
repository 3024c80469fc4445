"""The optimizer otypes of the port (``nerfshop_tpu_torch/train/optim.py``)
against the JAX package's ``train/optim.py``: JAX reads the first node under
the Ema and ExponentialDecay wrappers as Adam's settings whatever its otype
says, so an ``SGD`` node, alone or nested, gives Adam's update with its
learning rate, betas, epsilon and ``l2_reg`` in both packages; the port names
the otype it read as Adam in a warning (F19: tcnn's other optimizers cannot
be checked while tcnn is not vendored)."""

import warnings

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from nerfshop_tpu.train import optim as joptim
from nerfshop_tpu_torch.train import optim as toptim
from torch_one_thread import one_thread  # noqa: F401

SGD = {"otype": "SGD", "learning_rate": 3e-2, "beta1": 0.8, "beta2": 0.95, "epsilon": 1e-6, "l2_reg": 1e-3}
CFGS = {
    "SGD": SGD,
    "nested": {"otype": "Ema", "decay": 0.9, "nested": {"otype": "ExponentialDecay", "decay_start": 1,
                                                         "decay_interval": 1, "decay_base": 0.5, "nested": SGD}},
    "Adam": {**SGD, "otype": "Adam"},
}


class _Two(nn.Module):
    def __init__(self, a, b):
        super().__init__()
        self.a = nn.Parameter(torch.from_numpy(a.copy()))
        self.b = nn.Parameter(torch.from_numpy(b.copy()))


@pytest.mark.parametrize("name", list(CFGS))
def test_update_matches_jax(name):
    cfg = CFGS[name]
    rng = np.random.default_rng(7)
    a, b = rng.normal(size=(4, 3)).astype(np.float32), rng.normal(size=(5,)).astype(np.float32)
    grads = [(rng.normal(size=(4, 3)).astype(np.float32), rng.normal(size=(5,)).astype(np.float32)) for _ in range(3)]
    spec_j = joptim.build_optimizer(cfg)
    state_j = joptim.create_train_state({"a": jnp.asarray(a), "b": jnp.asarray(b)}, spec_j)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        spec_t = toptim.build_optimizer(cfg)
    named = [str(w.message) for w in caught]
    if name == "Adam":
        assert not named
    else:
        assert len(named) == 1 and "'SGD' is read as Adam" in named[0]
    assert {k: spec_t.adam[k] for k in ("learning_rate", "beta1", "beta2", "epsilon", "l2_reg")} == {
        k: SGD[k] for k in ("learning_rate", "beta1", "beta2", "epsilon", "l2_reg")}
    model = _Two(a, b)
    st = toptim.TrainState(model, spec_t)
    for ga, gb in grads:
        state_j = joptim.apply_gradients(state_j, {"a": jnp.asarray(ga), "b": jnp.asarray(gb)}, spec_j)
        st.apply_gradients({"a": torch.from_numpy(ga), "b": torch.from_numpy(gb)})
    np.testing.assert_allclose(model.a.detach().numpy(), np.asarray(state_j.params["a"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(model.b.detach().numpy(), np.asarray(state_j.params["b"]), rtol=1e-5, atol=1e-6)
    if spec_j.ema_decay:
        np.testing.assert_allclose(st.ema["a"].numpy(), np.asarray(state_j.ema_params["a"]), rtol=1e-5, atol=1e-6)


def test_sgd_is_adam_in_jax_too():
    # JAX's chain for an "SGD" node is its Adam chain: the same transformation
    spec_sgd = joptim.build_optimizer(SGD)
    spec_adam = joptim.build_optimizer({**SGD, "otype": "Adam"})
    p = {"w": jnp.ones((3,))}
    g = {"w": jnp.asarray([0.5, -1.0, 2.0])}
    u1, _ = spec_sgd.tx.update(g, spec_sgd.tx.init(p), p)
    u2, _ = spec_adam.tx.update(g, spec_adam.tx.init(p), p)
    np.testing.assert_array_equal(np.asarray(optax.apply_updates(p, u1)["w"]), np.asarray(optax.apply_updates(p, u2)["w"]))
