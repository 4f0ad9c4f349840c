"""Adam with L2 decay, in the order the reference trainers use.

``pygcn_tpu/train/optim.py:adam_l2`` rebuilds ``torch.optim.Adam(lr,
weight_decay)`` in optax; here it is that optimizer itself. L2 decay is added
into the gradient before the moments (not decoupled AdamW), and an optional
global-norm clip runs before the decay, as ``clip_grad_norm_`` does before
``optimizer.step()`` in the reference (``pygcn/gnn-over-mlp.py:311``).
"""

from __future__ import annotations

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
