"""Optimizer from the JSON config tree: ``Ema { ExponentialDecay { Adam } }``.

Counterpart of ``nerfshop_tpu/train/optim.py``. ``torch.optim.Adam``'s
``weight_decay`` adds ``l2_reg · param`` to the gradient before the moment
updates, which is the coupled L2 that ``optax.add_decayed_weights`` before
``scale_by_adam`` gives. The ExponentialDecay schedule sets the learning
rate before each step, and the EMA copy of the parameters
(``inference_params``) follows each step.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
from torch import nn


def _unwrap(cfg: dict):
    """Peel Ema/ExponentialDecay wrappers → (adam_cfg, schedule_cfg, ema_decay)."""
    ema_decay = None
    schedule_cfg = None
    node = dict(cfg)
    while True:
        otype = node.get("otype", "Adam")
        if otype == "Ema":
            ema_decay = node.get("decay", 0.99)
            node = dict(node.get("nested", {}))
        elif otype == "ExponentialDecay":
            schedule_cfg = node
            node = dict(node.get("nested", {}))
        elif otype == "Adam":
            return node, schedule_cfg, ema_decay
        else:
            raise NotImplementedError(f"optimizer otype {otype!r} is not ported")


def make_schedule(adam_cfg: dict, schedule_cfg: Optional[dict]) -> Callable[[int], float]:
    """step → learning rate: ×decay_base every decay_interval steps past decay_start."""
    base_lr = adam_cfg.get("learning_rate", 1e-2)
    if schedule_cfg is None:
        return lambda step: base_lr
    start = schedule_cfg.get("decay_start", 0)
    interval = schedule_cfg.get("decay_interval", 10000)
    base = schedule_cfg.get("decay_base", 0.33)
    end = schedule_cfg.get("decay_end", None)

    def schedule(step: int) -> float:
        eff = min(max(step, 0), end) if end is not None else step
        return base_lr * base ** math.floor(max(eff - start, 0) / interval)

    return schedule


@dataclass
class OptimizerSpec:
    adam: dict
    schedule: Callable[[int], float]
    ema_decay: Optional[float]


def build_optimizer(cfg: dict) -> OptimizerSpec:
    adam_cfg, schedule_cfg, ema_decay = _unwrap(dict(cfg))
    return OptimizerSpec(adam=adam_cfg, schedule=make_schedule(adam_cfg, schedule_cfg), ema_decay=ema_decay)


class TrainState:
    """Module parameters + Adam state + EMA copy + step count."""

    def __init__(self, model: nn.Module, spec: OptimizerSpec):
        self.model = model
        self.spec = spec
        a = spec.adam
        self.optimizer = torch.optim.Adam(
            model.parameters(),
            lr=spec.schedule(0),
            betas=(a.get("beta1", 0.9), a.get("beta2", 0.999)),
            eps=a.get("epsilon", 1e-8),
            weight_decay=a.get("l2_reg", 0.0),
        )
        self.ema: Optional[Dict[str, torch.Tensor]] = None
        if spec.ema_decay:
            self.ema = {k: v.detach().clone() for k, v in model.named_parameters()}
        self.step = 0

    @property
    def inference_params(self) -> Dict[str, torch.Tensor]:
        """The EMA parameters where there is an EMA, else the live ones."""
        if self.ema is not None:
            return self.ema
        return {k: v.detach() for k, v in self.model.named_parameters()}

    @torch.no_grad()
    def apply_gradients(self, grads: Dict[str, torch.Tensor]) -> None:
        for name, p in self.model.named_parameters():
            p.grad = grads[name]
        for group in self.optimizer.param_groups:
            group["lr"] = self.spec.schedule(self.step)
        self.optimizer.step()
        if self.ema is not None:
            d = self.spec.ema_decay
            for name, p in self.model.named_parameters():
                e = self.ema[name]
                e.mul_(d).add_(p, alpha=1.0 - d)
        self.step += 1
