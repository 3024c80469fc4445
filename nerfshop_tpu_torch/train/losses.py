"""Per-channel photometric losses (counterpart of ``nerfshop_tpu/train/losses.py``).

Reduction is left to the caller: the NeRF loss averages over rays.
"""

from __future__ import annotations

import torch


def l2(target, pred):
    d = pred - target
    return d * d


def l1(target, pred):
    return (pred - target).abs()


def huber(target, pred, alpha: float = 0.1):
    """Divided by 5 so the quadratic region matches L2, as the reference does."""
    d = pred - target
    ad = d.abs()
    return torch.where(ad > alpha, ad - 0.5 * alpha, 0.5 / alpha * d * d) / 5.0


LOSSES = {"L2": l2, "L1": l1, "Huber": huber}
