"""Adam with L2 decay, in the order the reference trainers use.

``pygcn_tpu/train/optim.py:adam_l2`` rebuilds ``torch.optim.Adam(lr,
weight_decay)`` in optax; here it is that optimizer itself. L2 decay is added
into the gradient before the moments (not decoupled AdamW), and an optional
global-norm clip runs before the decay, as ``clip_grad_norm_`` does before
``optimizer.step()`` in the reference (``pygcn/gnn-over-mlp.py:311``).
:class:`ReduceLROnPlateau` is the JAX package's host-side plateau scheduler,
driving :func:`set_learning_rate`.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import torch


class AdamL2(torch.optim.Adam):
    """``torch.optim.Adam`` that clips the global gradient norm first."""

    def __init__(self, params: Iterable, lr: float, weight_decay: float = 0.0, *,
                 grad_clip_norm: Optional[float] = None, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, lr=lr, betas=(b1, b2), eps=eps,
                         weight_decay=weight_decay)
        self.grad_clip_norm = grad_clip_norm

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        if self.grad_clip_norm is not None:
            params = [p for g in self.param_groups for p in g["params"]
                      if p.grad is not None]
            torch.nn.utils.clip_grad_norm_(params, self.grad_clip_norm)
        super().step()
        return loss


def adam_l2(params: Iterable, learning_rate: float, weight_decay: float = 0.0, *,
            grad_clip_norm: Optional[float] = None, b1: float = 0.9,
            b2: float = 0.999, eps: float = 1e-8) -> AdamL2:
    """torch Adam with L2 decay and optional clipping (clip, then decay, then Adam)."""
    return AdamL2(params, learning_rate, weight_decay, grad_clip_norm=grad_clip_norm,
                  b1=b1, b2=b2, eps=eps)


def set_learning_rate(opt: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    for group in opt.param_groups:
        group["lr"] = float(lr)
    return opt


def get_learning_rate(opt: torch.optim.Optimizer) -> float:
    return float(opt.param_groups[0]["lr"])


@dataclasses.dataclass
class ReduceLROnPlateau:
    """Host-side plateau scheduler driving :func:`set_learning_rate`: after
    more than ``patience`` epochs whose metric does not beat the best by the
    relative ``threshold``, the rate is multiplied by ``factor`` (not below
    ``min_lr``) and ``cooldown`` epochs pass before bad epochs count again."""

    mode: str = "min"
    factor: float = 0.5
    patience: int = 10
    threshold: float = 1e-4
    min_lr: float = 0.0
    cooldown: int = 0

    best: Optional[float] = None
    num_bad: int = 0
    cooldown_counter: int = 0

    def _is_better(self, metric: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return metric < self.best * (1 - self.threshold)
        return metric > self.best * (1 + self.threshold)

    def step(self, metric: float, opt: torch.optim.Optimizer):
        """Update with the epoch metric; returns ``(opt, reduced)``."""
        metric = float(metric)
        if self._is_better(metric):
            self.best = metric
            self.num_bad = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
        else:
            self.num_bad += 1

        if self.num_bad > self.patience:
            old = get_learning_rate(opt)
            new = max(old * self.factor, self.min_lr)
            if new < old:
                opt = set_learning_rate(opt, new)
            self.num_bad = 0
            self.cooldown_counter = self.cooldown
            return opt, True
        return opt, False

    def state_dict(self) -> dict:
        return {
            "best": self.best,
            "num_bad": self.num_bad,
            "cooldown_counter": self.cooldown_counter,
        }

    def load_state_dict(self, d: dict) -> None:
        self.best = d["best"]
        self.num_bad = d["num_bad"]
        self.cooldown_counter = d["cooldown_counter"]
