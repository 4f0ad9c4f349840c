"""The surrogate evaluator over a 2-D ``graph × data`` mesh.

The port of ``pygcn_tpu/parallel/dist_evaluator.py``. Rank ``(g, d)`` holds
node rows ``g`` (the partition plan's shard, with its halo exchange) of the
policy samples ``d`` of the batch:

- **graph axis**: each SpMM runs through :func:`make_dist_spmm` over the
  ``graph`` group of the rank's line;
- **data axis**: the per-layer fold of the batch into SpMM columns turns the
  batch's split into a split of those columns (``col_axis``), so the two
  axes meet inside one product.

JAX's GSPMD inserts the reductions that cross ranks; here they are written
out. The standardisation's sums and valid-row count and the pool's masked
sum and flag count are all-reduced over the ``graph`` group, with a
gradient (:func:`~pygcn_tpu_torch.parallel.dist_spmm.all_reduce_with_grad`);
:func:`make_dist_evaluator_step` sums the gradients and the loss over every
rank of the mesh. Padded node rows (the plan rounds the node count up) are
left out of the statistics and the pool, so on real rows the model computes
the single-device :class:`~pygcn_tpu_torch.nn.models.GCNOverMLP` to float
tolerance. Its parameters are that model's, under the same names, so state
dicts and checkpoints swap freely between the two.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from pygcn_tpu_torch.nn.layers import MLP3
from pygcn_tpu_torch.nn.models import GCN3
from pygcn_tpu_torch.parallel.dist_gcn import reduce_gradients
from pygcn_tpu_torch.parallel.dist_spmm import (all_reduce_with_grad, make_dist_spmm,
                                                pad_node_features, plan_shard, seeded)
from pygcn_tpu_torch.parallel.mesh import Mesh
from pygcn_tpu_torch.parallel.partition import DistPlan


def masked_batch_standardize(x: torch.Tensor, valid: torch.Tensor, eps: float = 1e-5,
                             group=None) -> torch.Tensor:
    """``batch_standardize`` over the node axis with padded rows left out.

    ``x``: ``[..., S, H]``, this rank's rows; ``valid``: ``[S]`` in {0, 1}.
    The statistics are taken over the valid rows of every rank of
    ``group`` (the valid count and the sums all-reduced), so on valid rows
    the result is the unpadded computation's. Padded rows get values that
    nothing reads: they have no edges and no flag."""
    v = valid[:, None].to(x.dtype)
    sums = (x * v).sum(dim=-2, keepdim=True)
    both = all_reduce_with_grad(torch.cat([sums.reshape(-1), valid.sum().reshape(1).to(x.dtype)]),
                                group)
    n = torch.clamp(both[-1], min=1.0)
    mean = both[:-1].view_as(sums) / n
    d = (x - mean) * v
    var = all_reduce_with_grad((d * d).sum(dim=-2, keepdim=True), group) / n
    return (x - mean) * torch.rsqrt(var + eps)


def masked_mean_pool_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """:func:`~pygcn_tpu_torch.nn.layers.masked_mean_pool` over the node
    rows of every rank of ``group``: ``[..., S, F]`` → ``[..., F - 1]``, the
    masked sums and the flag count all-reduced in one call (padded rows
    carry flag 0)."""
    flag = x[..., -1]
    sums = (x * flag[..., None])[..., :-1].sum(dim=-2)
    count = torch.count_nonzero(flag, dim=-1).to(x.dtype)[..., None]
    both = all_reduce_with_grad(torch.cat([sums, count], dim=-1), group)
    return both[..., :-1] / torch.clamp(both[..., -1:], min=1.0)


class DistGCNOverMLP(nn.Module):
    """:class:`~pygcn_tpu_torch.nn.models.GCNOverMLP` with node rows split
    over ``axis_graph`` and policy samples over ``axis_data``.

    ``gcn`` and ``mlp`` are built as the single-device model builds them,
    from ``generator``, so one seed gives both models the same weights and
    their state dicts share keys. :meth:`forward` takes this rank's
    ``[B/D, S, F]`` block (:meth:`shard_batch`) and returns the predictions
    of its samples, the same on every rank of its ``graph`` line."""

    def __init__(self, mesh: Mesh, plan: DistPlan, *, gcn_nfeat: int, gcn_nhid: int,
                 gcn_nclass: int, dim_touched: int, linear_nin: int, linear_nhid1: int,
                 linear_nhid2: int, linear_nout: int = 1, axis_graph: str = "graph",
                 axis_data: str = "data", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mesh, self.axis_graph, self.axis_data = mesh, axis_graph, axis_data
        self.dim_touched = dim_touched
        self.n_nodes = plan.n_nodes
        self.shard = plan_shard(mesh, plan, axis_graph)
        self.spmm = make_dist_spmm(mesh, self.shard, axis_graph, col_axis=axis_data)
        g = seeded(generator)
        self.gcn = GCN3(gcn_nfeat, gcn_nhid, gcn_nclass, generator=g)
        self.mlp = MLP3(linear_nin, linear_nhid1, linear_nhid2, linear_nout, generator=g)
        s = self.shard.shard_size
        rows = np.arange(mesh.coord(axis_graph) * s, (mesh.coord(axis_graph) + 1) * s)
        self.register_buffer("valid", torch.from_numpy((rows < plan.n_nodes).astype(np.float32)),
                             persistent=False)
        self.to(mesh.device)

    @property
    def graph_group(self):
        return self.mesh.group(self.axis_graph)

    def _wide_spmm(self, support: torch.Tensor) -> torch.Tensor:
        """``[b, S, H]`` → A @ support per sample, as one ``[S, b·H]`` SpMM."""
        b, s, h = support.shape
        agg = self.spmm(support.transpose(0, 1).reshape(s, b * h))
        return agg.view(s, b, h).transpose(0, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: this rank's ``[B/D, S, F]`` → ``[B/D, linear_nout]``."""
        gc, group = self.gcn, self.graph_group
        h = x[:, :, :self.dim_touched]
        # gc1, gc2: conv → ReLU → masked standardisation; gc3: conv → ReLU
        h = self._wide_spmm(h @ gc.gc1.weight) + gc.gc1.bias
        h = masked_batch_standardize(torch.relu(h), self.valid, group=group)
        h = self._wide_spmm(h @ gc.gc2.weight) + gc.gc2.bias
        h = masked_batch_standardize(torch.relu(h), self.valid, group=group)
        h = torch.relu(self._wide_spmm(h @ gc.gc3.weight) + gc.gc3.bias)
        h = torch.cat([h, x[:, :, self.dim_touched:]], dim=2)
        return self.mlp(masked_mean_pool_rows(h, group))

    # ---- this rank's share of the inputs ---------------------------------
    def _samples(self, n: int) -> slice:
        q = self.mesh.size(self.axis_data)
        if n % q:
            raise ValueError(f"batch of {n} samples over {q} data ranks")
        b = n // q
        return slice(self.mesh.coord(self.axis_data) * b, (self.mesh.coord(self.axis_data) + 1) * b)

    def shard_batch(self, x) -> torch.Tensor:
        """``[B, N, F]`` → this rank's samples and rows, node-padded, on its device."""
        x = torch.as_tensor(x)
        s = self.shard.shard_size
        c = self.mesh.coord(self.axis_graph)
        x = pad_node_features(x[self._samples(x.shape[0])].transpose(0, 1), self.shard)
        return x[c * s:(c + 1) * s].transpose(0, 1).contiguous().to(self.mesh.device)

    def shard_targets(self, y) -> torch.Tensor:
        """``[B]`` → this rank's samples' targets, on its device."""
        y = torch.as_tensor(y)
        return y[self._samples(y.shape[0])].contiguous().to(self.mesh.device)


def make_dist_evaluator_step(model: DistGCNOverMLP, optimizer: torch.optim.Optimizer):
    """``step(bx, by) -> loss``: one MSE step over the mesh on this rank's
    block of the batch (:meth:`DistGCNOverMLP.shard_batch`,
    :meth:`~DistGCNOverMLP.shard_targets`).

    The loss is the mean over the global batch. The ``graph`` line's
    all-reduce gives its Q ranks the same predictions and loss, so each
    rank scales its share by 1/Q: the backward through that all-reduce
    then hands every rank the gradient of the line's loss once, and the
    head's gradients summed over the line count it once. One all-reduce
    over every rank of the mesh sums the gradients and the loss; the
    optimizer's update follows, the same on every rank (its L2 and
    clipping see the global gradient). Returns the loss before the update."""
    mesh = model.mesh
    q, dsize = mesh.size(model.axis_graph), mesh.size(model.axis_data)
    params = [p for p in model.parameters() if p.requires_grad]

    def step(bx: torch.Tensor, by: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        pred = model(bx)[:, 0]
        loss = ((pred - by) ** 2).sum() / (by.shape[0] * dsize * q)
        loss.backward()
        loss = reduce_gradients(params, loss, mesh.group_all())
        optimizer.step()
        return loss

    return step
