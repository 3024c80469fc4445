"""Optimizer from the JSON config tree: ``Ema { ExponentialDecay { Adam } }``.

Counterpart of ``nerfshop_tpu/train/optim.py``. As there, the first node
under the Ema and ExponentialDecay wrappers is read as Adam's settings
(``learning_rate``, ``beta1``, ``beta2``, ``epsilon``, ``l2_reg``) whatever
its ``otype`` says; an otype other than Adam is named in a warning. ``torch.optim.Adam``'s
``weight_decay`` adds ``l2_reg · param`` to the gradient before the moment
updates, which is the coupled L2 that ``optax.add_decayed_weights`` before
``scale_by_adam`` gives. The Adam is the fused, capturable one, with its
learning rate, its step count and its moments on the parameters' device
from the start, so that a step reads no host value and can be captured in
a CUDA graph (``train/nerf.py::make_train_loop``). The ExponentialDecay
schedule's value is written into the learning-rate tensor before each step,
and the EMA copy of the parameters (``inference_params``) follows each step
in one ``foreach`` lerp.
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch
from torch import nn


def _unwrap(cfg: dict):
    """Peel Ema/ExponentialDecay wrappers → (adam_cfg, schedule_cfg, ema_decay).
    Any other node is Adam's config, as in the JAX package (which builds
    Adam for every otype); one that is not ``Adam`` is named in a warning."""
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
        else:
            if otype != "Adam":
                warnings.warn(
                    f"optimizer otype {otype!r} is read as Adam with its learning_rate, beta1, beta2, epsilon and "
                    "l2_reg, as the JAX package reads it",
                    stacklevel=3,
                )
            return node, schedule_cfg, ema_decay


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
    """Module parameters + Adam state + EMA copy + step count.

    ``extra`` holds parameters outside the module by name: the NeRF's
    ``camera.*`` pose, exposure and distortion-map leaves and its
    ``envmap`` (JAX keeps them in the same params pytree), each a leaf
    tensor that Adam, the schedule and the EMA treat as the module's
    parameters, as JAX's ``create_train_state`` does: one Adam at the
    schedule's rate. Their EMA copy is ``inference_extra``;
    ``inference_params`` and ``ema`` stay the module's.

    ``step`` is the host's count of applied steps (the schedule's argument);
    Adam's own count, which its bias correction reads, lives on the device."""

    def __init__(self, model: nn.Module, spec: OptimizerSpec, extra: Optional[Dict[str, torch.Tensor]] = None):
        self.model = model
        self.spec = spec
        a = spec.adam
        self.extra = {k: v.detach().clone().float().requires_grad_(True) for k, v in (extra or {}).items()}
        #: (name, parameter) of the module's parameters, then the extra leaves
        self.named = list(model.named_parameters()) + list(self.extra.items())
        self.params = [p for _, p in self.named]
        #: the learning rate of the next step, written by :meth:`update`
        self.lr = torch.full((), spec.schedule(0), dtype=torch.float32, device=self.params[0].device)
        self.optimizer = torch.optim.Adam(
            self.params,
            lr=self.lr,
            betas=(a.get("beta1", 0.9), a.get("beta2", 0.999)),
            eps=a.get("epsilon", 1e-8),
            weight_decay=a.get("l2_reg", 0.0),
            fused=True,
            capturable=True,
        )
        # the state Adam would make at its first step, made now: a step
        # captured in a graph must find it, not allocate and zero it
        for p in self.params:
            self.optimizer.state[p] = {
                "step": torch.zeros((), dtype=torch.float32, device=p.device),
                "exp_avg": torch.zeros_like(p),
                "exp_avg_sq": torch.zeros_like(p),
            }
        self.ema: Optional[Dict[str, torch.Tensor]] = None
        self.extra_ema: Dict[str, torch.Tensor] = {}
        if spec.ema_decay:
            self.ema = {k: v.detach().clone() for k, v in model.named_parameters()}
            self.extra_ema = {k: v.detach().clone() for k, v in self.extra.items()}
        self.step = 0

    @property
    def inference_params(self) -> Dict[str, torch.Tensor]:
        """The EMA parameters where there is an EMA, else the live ones."""
        if self.ema is not None:
            return self.ema
        return {k: v.detach() for k, v in self.model.named_parameters()}

    @property
    def inference_extra(self) -> Dict[str, torch.Tensor]:
        """The extra leaves' EMA where there is an EMA, else the live ones."""
        if self.ema is not None:
            return self.extra_ema
        return {k: v.detach() for k, v in self.extra.items()}

    def tensors(self) -> List[torch.Tensor]:
        """Every tensor a step writes: parameters, Adam's state, the EMA
        copy and the learning rate."""
        out = [p.data for p in self.params] + [self.lr]
        for p in self.params:
            out += list(self.optimizer.state[p].values())
        return out + (list(self.ema.values()) + list(self.extra_ema.values()) if self.ema is not None else [])

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], lr: Optional[torch.Tensor] = None) -> None:
        """One Adam + EMA step on the device alone, at learning rate ``lr``
        (a 0-d tensor on the parameters' device) or, without it, at the one
        already in ``self.lr``. ``step`` is not counted."""
        for name, p in self.named:
            p.grad = grads[name]
        if lr is not None:
            self.lr.copy_(lr)
        self.optimizer.step()
        for p in self.params:
            p.grad = None
        if self.ema is not None:
            torch._foreach_lerp_(list(self.ema.values()) + list(self.extra_ema.values()), self.params,
                                 1.0 - self.spec.ema_decay)

    def apply_gradients(self, grads: Dict[str, torch.Tensor]) -> None:
        """One step at the schedule's learning rate for ``step``, counted."""
        self.lr.fill_(self.spec.schedule(self.step))
        self.update(grads)
        self.step += 1
