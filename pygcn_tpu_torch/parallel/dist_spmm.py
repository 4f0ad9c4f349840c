"""Distributed SpMM over the ranks of a mesh axis: halo exchange plus local
aggregation.

The port of ``pygcn_tpu/parallel/dist_spmm.py``. ``make_dist_spmm(mesh,
plan)`` returns ``f(x) -> A @ x`` on this rank's rows: ``x`` is its
``[S, F]`` block of the padded ``[P·S, F]`` features (:func:`shard_features`)
and so is the result. On each rank:

1. gather its boundary rows for every peer (``send_idx``): ``[P, halo, F]``;
2. one ``all_to_all_single`` delivers each rank its halo table (slice *o*:
   the rows rank *o* sent);
3. the local edges aggregate from the resident rows and the remote edges
   from the halo table, on the plan's stacked ELL layouts
   (``ops/ell.ell_apply_arrays``) or, without them, on its COO edge arrays.

``torch.distributed``'s collectives have no gradient, so the exchange is a
:class:`torch.autograd.Function` whose backward runs the reverse
all-to-all and adds each received gradient into the row it was sent from;
JAX derives the same from ``all_to_all``'s transpose. The aggregation's
gradient is autograd's. No tile kernel runs on this path, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from pygcn_tpu_torch.ops.ell import ell_apply_arrays
from pygcn_tpu_torch.ops.gat import _segment_sum
from pygcn_tpu_torch.parallel.mesh import Mesh
from pygcn_tpu_torch.parallel.partition import DistPlan, PlanShard


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Slice *i* of ``t``'s first axis goes to rank *i*; slice *o* of the
    result came from rank *o*. Without a process group (one rank) a copy."""
    if not dist.is_initialized():
        return t.clone()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t.contiguous(), group=group)
    return out


class HaloExchange(torch.autograd.Function):
    """``x [S, F]`` → the incoming halo table ``[P, halo, F]``: each rank
    ships ``x[send_idx[i]]`` to rank *i*. The backward ships the table's
    gradient back the same way and adds it into the rows sent."""

    @staticmethod
    def forward(ctx, x, send_idx, group):
        p, halo = send_idx.shape
        outgoing = x.index_select(0, send_idx.reshape(-1)).view(p, halo, x.shape[1])
        ctx.save_for_backward(send_idx)
        ctx.group, ctx.n_rows = group, x.shape[0]
        return _all_to_all(outgoing, group)

    @staticmethod
    def backward(ctx, g):
        (send_idx,) = ctx.saved_tensors
        back = _all_to_all(g, ctx.group)  # slice i: the gradient of the rows sent to rank i
        dx = g.new_zeros((ctx.n_rows, g.shape[-1]))
        return dx.index_add_(0, send_idx.reshape(-1), back.reshape(-1, g.shape[-1])), None, None


def halo_exchange(x: torch.Tensor, send_idx: torch.Tensor, group=None) -> torch.Tensor:
    return HaloExchange.apply(x, send_idx, group)


class AllReduceSum(torch.autograd.Function):
    """``t`` summed over the group's ranks, with a gradient: the backward
    is the sum of the incoming gradients over the same ranks (each rank's
    ``t`` reaches every rank's result). Without a process group, ``t``."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        if dist.is_initialized():
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return AllReduceSum.apply(g.contiguous(), ctx.group), None


def all_reduce_with_grad(t: torch.Tensor, group=None) -> torch.Tensor:
    return AllReduceSum.apply(t, group)


# The model axes (``tp_gcn.py``, ``pipeline.py``, ``moe.py``) share one
# convention for the loss over a line of ranks: every rank of the line holds
# the whole loss, computed from the line's replicated output. A collective
# that builds a replicated value from per-rank parts then passes its
# gradient through unsummed (each rank keeps the gradient of its own part),
# and a replicated value that feeds per-rank partial work all-reduces its
# gradient: Megatron's ``g`` and ``f``. Replicated weights used whole then
# get their whole gradient on every rank, with no reduction.


def _group_rank(group) -> int:
    return dist.get_rank(group) if group is not None else dist.get_rank()


class CopyToGroup(torch.autograd.Function):
    """Megatron's ``f``: ``t`` unchanged; the backward sums the gradient
    over the group's ranks (each rank's partial work saw only its part)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        if dist.is_initialized():
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class ReduceFromGroup(torch.autograd.Function):
    """Megatron's ``g``: ``t`` summed over the group's ranks; the backward
    hands each rank the gradient of the sum unchanged."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.contiguous().clone()
        if dist.is_initialized():
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class GatherFromGroup(torch.autograd.Function):
    """Every rank's ``t`` (equal shapes) concatenated along axis 0 in group
    rank order; the backward keeps this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.n = t.shape[0]
        if not dist.is_initialized():
            ctx.index = 0
            return t.clone()
        ctx.index = _group_rank(group)
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.index * ctx.n:(ctx.index + 1) * ctx.n], None


class SplitToGroup(torch.autograd.Function):
    """This rank's block of a replicated ``t``'s axis 0 (group rank ``i``
    of ``P``: rows ``i·n/P`` to ``(i+1)·n/P``); the backward gathers every
    rank's block gradient into the whole gradient, the same on every rank."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        if not dist.is_initialized():
            return t.clone()
        n = t.shape[0] // dist.get_world_size(group)
        i = _group_rank(group)
        return t[i * n:(i + 1) * n].clone()

    @staticmethod
    def backward(ctx, g):
        return GatherFromGroup.apply(g, ctx.group), None


def copy_to_group(t: torch.Tensor, group=None) -> torch.Tensor:
    return CopyToGroup.apply(t, group)


def reduce_from_group(t: torch.Tensor, group=None) -> torch.Tensor:
    return ReduceFromGroup.apply(t, group)


def gather_from_group(t: torch.Tensor, group=None) -> torch.Tensor:
    return GatherFromGroup.apply(t, group)


def split_to_group(t: torch.Tensor, group=None) -> torch.Tensor:
    return SplitToGroup.apply(t, group)


def plan_shard(mesh: Mesh, plan, axis: str = "graph") -> PlanShard:
    """This rank's row of ``plan`` on the mesh's device (``plan`` as it is
    when it is one rank's already)."""
    if isinstance(plan, PlanShard):
        return plan
    if mesh.size(axis) != plan.n_shards:
        raise ValueError(f"plan of {plan.n_shards} shards on a {axis!r} axis of "
                         f"{mesh.size(axis)} ranks")
    return plan.shard(mesh.coord(axis), mesh.device)


def make_dist_spmm(mesh: Mesh, plan, axis: str = "graph", col_axis: Optional[str] = None,
                   parts: str = "full"):
    """The distributed SpMM on this rank: ``f(x [S, F]) -> (A @ X)[S, F]``.

    ``col_axis`` names a second mesh axis over which the feature columns
    are split (the graph×data evaluator, ``parallel/dist_evaluator.py``):
    ``x`` is then this rank's ``[S, F_local]`` block of rows and columns.
    Every step here is column-wise independent, so nothing is gathered over
    that axis: the halo exchange runs over ``axis``'s group of this rank's
    line alone and moves only its columns.

    ``parts`` selects a component for cost attribution: ``"local"`` skips
    the halo exchange and the remote aggregation; ``"halo"`` runs only the
    boundary gather, the all-to-all and the remote aggregation; ``"full"``
    (the default) is the real op, and the two components sum to it."""
    if parts not in ("full", "local", "halo"):
        raise ValueError(f"unknown parts {parts!r}")
    if col_axis is not None and (col_axis == axis or col_axis not in mesh.axis_names):
        raise ValueError(f"col_axis {col_axis!r} is not a second axis of the mesh "
                         f"{mesh.axis_names}")
    shard = plan_shard(mesh, plan, axis)
    group = mesh.group(axis)
    use_ell = shard.loc_ell is not None and shard.rem_ell is not None
    s = shard.shard_size

    def f(x: torch.Tensor) -> torch.Tensor:
        y = None
        if parts != "halo":
            y = (ell_apply_arrays(*shard.loc_ell, s, x) if use_ell else
                 _segment_sum(x.index_select(0, shard.loc_s) * shard.loc_w[:, None],
                              shard.loc_r, s))
        if parts != "local":
            table = halo_exchange(x, shard.send_idx, group).reshape(-1, x.shape[1])
            y_remote = (ell_apply_arrays(*shard.rem_ell, s, table) if use_ell else
                        _segment_sum(table.index_select(0, shard.rem_h) * shard.rem_w[:, None],
                                     shard.rem_r, s))
            y = y_remote if y is None else y + y_remote
        return y

    return f


def pad_node_features(x, plan: DistPlan | PlanShard) -> torch.Tensor:
    """Zero-pad ``[N, ...]`` node values (a tensor or an array) to the
    plan's ``[P·S, ...]``."""
    x = torch.as_tensor(x)
    pad = plan.n_nodes_padded - x.shape[0]
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))]) if pad else x


def shard_features(x, mesh: Mesh, axis: str = "graph") -> torch.Tensor:
    """This rank's rows of the padded ``[P·S, ...]`` ``x``, on its device."""
    x = torch.as_tensor(x)
    rows = x.shape[0] // mesh.size(axis)
    c = mesh.coord(axis)
    return x[c * rows:(c + 1) * rows].contiguous().to(mesh.device)


def gather_features(x: torch.Tensor, mesh: Mesh, axis: str = "graph") -> torch.Tensor:
    """Every rank's rows of the axis, in rank order: the padded ``[P·S, ...]``
    that :func:`shard_features` split (a collective: every rank calls it)."""
    if not dist.is_initialized():
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, x.contiguous(), group=mesh.group(axis))
    return torch.cat(parts)


def seeded(generator: Optional[torch.Generator]) -> torch.Generator:
    """``generator``, or one seeded with 0 (the layers' own default)."""
    return generator if generator is not None else torch.Generator().manual_seed(0)


class DistModule(nn.Module):
    """What the distributed models share: the mesh, the graph axis, this
    rank's row of the plan (``shard``) and the distributed SpMM over it.
    Weights are replicated: every rank holds them all."""

    def __init__(self, mesh: Mesh, plan, axis: str = "graph"):
        super().__init__()
        self.mesh, self.axis = mesh, axis
        self.shard = plan_shard(mesh, plan, axis)
        self.spmm = make_dist_spmm(mesh, self.shard, axis)

    def shard_x(self, x) -> torch.Tensor:
        """This rank's rows of ``[N, ...]`` node values, zero-padded, on its device."""
        return shard_features(pad_node_features(x, self.shard), self.mesh, self.axis)
