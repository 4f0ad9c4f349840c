"""The distributed GCN and the distributed classifier step.

The port of ``pygcn_tpu/parallel/dist_gcn.py``. Activations are row-sharded
over the ``"graph"`` axis (each rank its ``[S, H]`` block), weights
replicated. JAX's ``jit`` inserts the gradient all-reduce; here
:func:`make_dist_classifier_step` runs it: one ``all_reduce`` (SUM) of every
gradient and the loss, flattened, before the optimizer's update, so L2 decay
and clipping apply once, to the global gradient, as optax applies them to
JAX's.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from pygcn_tpu_torch.nn.layers import GraphConv
from pygcn_tpu_torch.parallel.dist_spmm import DistModule, seeded
from pygcn_tpu_torch.parallel.mesh import Mesh


class DistGCN(DistModule):
    """N-layer GCN over a distributed graph: ``dims = [f_in, h1, ..., f_out]``,
    ReLU between layers and an optional ``final_activation`` (e.g.
    log-softmax). Its layers are the port's :class:`GraphConv`\\ s, so its
    state dict is :class:`~pygcn_tpu_torch.apps.train_fullgraph.GCN`'s
    (``layers.<i>.weight``, ``layers.<i>.bias``) and, from one generator, so
    are its weights. ``remat`` recomputes each layer, halo exchange
    included, in the backward pass (``torch.utils.checkpoint``)."""

    def __init__(self, mesh: Mesh, plan, dims: Sequence[int],
                 final_activation: Optional[Callable] = None, axis: str = "graph",
                 remat: bool = False, *, generator: Optional[torch.Generator] = None):
        super().__init__(mesh, plan, axis)
        g = seeded(generator)
        self.dims = list(dims)
        self.layers = nn.ModuleList(
            GraphConv(fi, fo, generator=g) for fi, fo in zip(self.dims[:-1], self.dims[1:]))
        self.final_activation = final_activation
        self.remat = remat

    def _layer(self, layer: GraphConv, h: torch.Tensor) -> torch.Tensor:
        return self.spmm(h @ layer.weight) + layer.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i, layer in enumerate(self.layers):
            if self.remat and torch.is_grad_enabled():
                h = checkpoint(self._layer, layer, h, use_reentrant=False)
            else:
                h = self._layer(layer, h)
            if i < len(self.layers) - 1:
                h = torch.relu(h)
            elif self.final_activation is not None:
                h = self.final_activation(h)
        return h


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over the group's ranks, in place (``t`` itself without a
    process group)."""
    if dist.is_initialized():
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def reduce_gradients(params, loss: torch.Tensor, group=None) -> torch.Tensor:
    """Sum the gradients of ``params`` (zero where a parameter has none) and
    ``loss`` over the group's ranks in one flat all-reduce; each ``.grad``
    becomes its sum and the summed loss is returned."""
    flat = all_reduce_sum(torch.cat(
        [(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
         for p in params] + [loss.detach().reshape(1)]), group)
    offset = 0
    for p in params:
        p.grad = flat[offset:offset + p.numel()].view_as(p)
        offset += p.numel()
    return flat[-1]


def make_dist_classifier_step(model: DistModule, optimizer: torch.optim.Optimizer):
    """``step(x, labels, mask) -> loss``: one full-batch distributed step of
    a log-softmax node classifier on this rank's rows (``labels`` and the
    float ``mask`` padded and sharded as ``x``).

    The loss is the masked NLL over every rank's rows: each rank divides its
    own sum by the global mask count, so the gradients' sum over the ranks
    is the global gradient. Every rank runs the backward (a rank whose mask
    is all zeros too: its halo exchanges are collectives), then one
    all-reduce sums the gradients and the loss; the update follows, the same
    on every rank. Returns the global loss before the update, as JAX's step
    does.

    A model that splits its weights over another axis
    (:class:`~pygcn_tpu_torch.parallel.tp_gcn.TPDistGCN`) clips by the
    global norm itself (its ``clip_grad_norm_``) when the optimizer clips;
    the optimizer's own clip, by the norm of this rank's leaves, which is
    no larger, then leaves the gradients as they are."""
    group = model.mesh.group(model.axis)
    params = [p for p in model.parameters() if p.requires_grad]
    clip = getattr(optimizer, "grad_clip_norm", None)
    global_clip = clip is not None and hasattr(model, "clip_grad_norm_")

    def step(x: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        count = all_reduce_sum(mask.sum(), group)
        logp = model(x)
        per_node = -logp.gather(1, labels[:, None].long())[:, 0]
        loss = (per_node * mask).sum() / count
        loss.backward()
        loss = reduce_gradients(params, loss, group)
        if global_clip:
            model.clip_grad_norm_(clip)
        optimizer.step()
        return loss

    return step
