"""Training metrics: the port of ``pygcn_tpu/train/metrics.py``.

The reference's metric set: MSE (``pygcn/gnn-over-mlp.py:309``),
classification accuracy (``pygcn/utils.py:400-404``) and Spearman's rank
correlation (``scipy.stats.spearmanr``, ``pygcn/gnn-over-mlp.py:331``), here
the Pearson correlation of tie-averaged ranks in torch, on the tensors'
device.
"""

from __future__ import annotations

import torch


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Argmax match rate (reference ``accuracy``, ``pygcn/utils.py:400-404``)."""
    return (logits.argmax(dim=1) == labels).float().mean()


def _ranks(x: torch.Tensor) -> torch.Tensor:
    """1-based ranks, ties given the mean of their positions (float32)."""
    n = x.shape[0]
    order = torch.argsort(x)
    sorted_x = x[order]
    same_as_prev = torch.cat([sorted_x.new_zeros(1, dtype=torch.bool),
                              sorted_x[1:] == sorted_x[:-1]])
    group = torch.cumsum(~same_as_prev, 0) - 1
    pos = torch.arange(1, n + 1, dtype=torch.float32, device=x.device)
    group_sum = torch.zeros(n, device=x.device).index_add_(0, group, pos)
    group_cnt = torch.zeros(n, device=x.device).index_add_(0, group, torch.ones_like(pos))
    mean_rank = group_sum / torch.clamp(group_cnt, min=1)
    return torch.empty(n, device=x.device).index_put_((order,), mean_rank[group])


def spearman(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Spearman's rho: the Pearson correlation of the tie-averaged ranks (0
    when either side is constant)."""
    rp, rt = _ranks(pred.reshape(-1)), _ranks(target.reshape(-1))
    rp = rp - rp.mean()
    rt = rt - rt.mean()
    denom = torch.sqrt((rp ** 2).sum() * (rt ** 2).sum())
    return torch.where(denom == 0, torch.zeros_like(denom), (rp * rt).sum() / denom)
