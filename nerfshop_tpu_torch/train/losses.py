"""Per-channel photometric losses (counterpart of ``nerfshop_tpu/train/losses.py``).

Reduction is left to the caller: the NeRF loss averages over rays. The
relative losses treat their normalizer as a constant of the gradient, as
the reference does (``detach`` where JAX has ``stop_gradient``).
"""

from __future__ import annotations

import torch

_EPS = 1e-2


def l2(target, pred):
    d = pred - target
    return d * d


def relative_l2(target, pred):
    d = pred - target
    factor = 1.0 / (pred.detach().square() + _EPS)
    return d * d * factor


def l1(target, pred):
    return (pred - target).abs()


def huber(target, pred, alpha: float = 0.1):
    """Divided by 5 so the quadratic region matches L2, as the reference does."""
    d = pred - target
    ad = d.abs()
    return torch.where(ad > alpha, ad - 0.5 * alpha, 0.5 / alpha * d * d) / 5.0


def log_l1(target, pred):
    return torch.log((pred - target).abs() + 1.0)


def smape(target, pred):
    d = (pred - target).abs()
    factor = 1.0 / (0.5 * (pred.abs() + target.abs()) + _EPS).detach()
    return d * factor


def mape(target, pred):
    d = (pred - target).abs()
    factor = 1.0 / (pred.abs() + _EPS).detach()
    return d * factor


LOSSES = {
    "L2": l2,
    "RelativeL2": relative_l2,
    "L1": l1,
    "Huber": huber,
    "LogL1": log_l1,
    "Smape": smape,
    "Mape": mape,
}


def build_loss(cfg: dict):
    return LOSSES[cfg.get("otype", "L2")]
