"""Expert parallelism: a top-1-gated mixture-of-experts MLP over an
``expert`` axis.

The port of ``pygcn_tpu/parallel/moe.py``. A softmax router sends each
token (here: each node) to its argmax expert, with a fixed per-expert
capacity; tokens past an expert's capacity are dropped (their output is
zero: pair the layer with a residual). The output is the expert's output
weighted by the router's probability, which carries the gradient into the
gate.

JAX dispatches and combines with one-hot ``[N, E, C]`` einsums
(:func:`top1_dispatch`), a TPU idiom (dense products on the MXU, no
scatter). At the arxiv width that tensor is 169,343 × 8 × 26,460 floats,
about 143 GB, so :meth:`ExpertParallelMLP.forward` routes by index instead
(:func:`top1_route`): each token's (expert, slot, kept, probability), a
gather of the kept tokens into ``[E_local, C, H]``, the experts' two
batched products, and a gather back weighted by the probability; the
einsum form stays for reference and equals it.

Tokens and the gate are replicated; each rank of the ``expert`` line runs
its ``E / size`` experts on the tokens routed to them, and one all-gather
over the line gives every rank all ``[E, C, H]`` expert outputs. Under
``dist_spmm.py``'s convention (every rank holds the whole loss) the
all-gather's backward keeps this rank's experts' gradient, and the tokens'
path into the local experts all-reduces its gradient (Megatron's ``f``),
so the gate and the tokens get their whole gradient on every rank.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pygcn_tpu_torch.nn import init as tinit
from pygcn_tpu_torch.parallel.dist_spmm import copy_to_group, gather_from_group
from pygcn_tpu_torch.parallel.mesh import Mesh


def _top1(gate_logits: torch.Tensor):
    probs = F.softmax(gate_logits, dim=1)
    expert = torch.argmax(probs, dim=1)  # the first index on ties
    onehot = F.one_hot(expert, gate_logits.shape[1]).to(gate_logits.dtype)
    # each token's place in its expert's queue, first come first in; the
    # running sum runs along the inner axis of the [E, N] transpose (along
    # axis 0 of [N, E] a GPU scans each of the E columns serially)
    pos = torch.cumsum(onehot.t().contiguous(), dim=1).t() - onehot
    return probs, expert, onehot, pos


def top1_dispatch(gate_logits: torch.Tensor, capacity: int):
    """``[N, E]`` router logits → ``(dispatch [N, E, C], combine [N, E,
    C])``, JAX's one-hot form: ``dispatch`` routes token ``n`` to slot
    ``c`` of its argmax expert (all zeros once that expert is full);
    ``combine`` is ``dispatch`` times the chosen expert's probability."""
    probs, _, onehot, pos = _top1(gate_logits)
    keep = onehot * (pos < capacity)
    slot = (pos[:, :, None] == torch.arange(capacity, device=pos.device,
                                            dtype=pos.dtype)).to(gate_logits.dtype)
    dispatch = keep[:, :, None] * slot
    top_p = (probs * onehot).sum(dim=1)
    return dispatch, dispatch * top_p[:, None, None]


def top1_route(gate_logits: torch.Tensor, capacity: int):
    """The same routing by index: ``(expert [N], slot [N], keep [N] bool,
    p [N])``, token ``n`` going to slot ``slot[n]`` of expert ``expert[n]``
    when ``keep[n]``, weighted by ``p[n]`` (differentiable in the logits)."""
    probs, expert, _, pos = _top1(gate_logits)
    slot = pos.gather(1, expert[:, None])[:, 0].long()
    return expert, slot, slot < capacity, probs.gather(1, expert[:, None])[:, 0]


class ExpertParallelMLP(nn.Module):
    """Two-layer ReLU MLP experts, ``n_experts / size`` of them on each rank
    of the ``expert`` axis. ``forward(x [N, h]) -> [N, h]``; dropped tokens
    give zeros.

    Parameters, under JAX's names: ``gate`` ``[h, E]`` (replicated), and
    this rank's experts' ``w1`` ``[E_local, h, hidden]``, ``b1``, ``w2``
    ``[E_local, hidden, h]``, ``b2``. From one generator, GraphConv's
    bounds: the gate, every expert's ``w1``, every expert's ``w2``; the
    biases zero. Every rank of the axis calls :meth:`forward` on the same
    tokens."""

    def __init__(self, mesh: Mesh, n_experts: int, h: int, hidden: Optional[int] = None,
                 capacity_factor: float = 1.25, axis: str = "expert", *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        size = mesh.size(axis)
        if n_experts % size != 0:
            raise ValueError(f"n_experts {n_experts} not divisible by mesh axis '{axis}' "
                             f"size {size}")
        self.mesh, self.axis = mesh, axis
        self.n_experts, self.h = n_experts, h
        self.hidden = hidden or 4 * h
        self.capacity_factor = capacity_factor
        self.n_local = n_experts // size
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        e, f = n_experts, self.hidden
        lo = mesh.coord(axis) * self.n_local
        mine = slice(lo, lo + self.n_local)
        self.gate = nn.Parameter(tinit.graphconv_weight(h, e, g))
        w1 = torch.stack([tinit.graphconv_weight(h, f, g) for _ in range(e)])
        w2 = torch.stack([tinit.graphconv_weight(f, h, g) for _ in range(e)])
        self.w1 = nn.Parameter(w1[mine].contiguous())
        self.b1 = nn.Parameter(torch.zeros(self.n_local, f))
        self.w2 = nn.Parameter(w2[mine].contiguous())
        self.b2 = nn.Parameter(torch.zeros(self.n_local, h))
        self.to(mesh.device)

    def capacity(self, n_tokens: int) -> int:
        per = self.capacity_factor * n_tokens / self.n_experts
        return max(1, int(-(-per // 1)))  # ceil, as JAX's

    def experts(self, expert_in: torch.Tensor) -> torch.Tensor:
        """This rank's experts on ``[E_local, C, h]`` → ``[E_local, C, h]``."""
        h1 = torch.relu(torch.bmm(expert_in, self.w1) + self.b1[:, None, :])
        return torch.bmm(h1, self.w2) + self.b2[:, None, :]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[0], self.capacity(x.shape[0])
        group = self.mesh.group(self.axis)
        expert, slot, keep, p = top1_route(x @ self.gate, c)
        # which token fills each of this rank's [E_local · C] slots (n: none)
        lo = self.mesh.coord(self.axis) * self.n_local
        mine = keep & (expert >= lo) & (expert < lo + self.n_local)
        token = torch.full((self.n_local * c,), n, dtype=torch.long, device=x.device)
        token[(expert[mine] - lo) * c + slot[mine]] = torch.nonzero(mine)[:, 0]
        padded = torch.cat([copy_to_group(x, group), x.new_zeros(1, x.shape[1])])
        expert_in = padded.index_select(0, token).view(self.n_local, c, x.shape[1])
        out = gather_from_group(self.experts(expert_in), group)  # [E, C, h]
        flat = torch.where(keep, expert * c + slot, torch.zeros_like(slot))
        picked = out.reshape(-1, x.shape[1]).index_select(0, flat)
        return picked * (p * keep.to(p.dtype))[:, None]

    def forward_dense(self, x: torch.Tensor) -> torch.Tensor:
        """JAX's einsum form (:func:`top1_dispatch`), on an expert axis of
        one rank; it builds ``[N, E, C]``: for small ``N`` only."""
        if self.n_local != self.n_experts:
            raise ValueError("forward_dense needs every expert on this rank")
        dispatch, combine = top1_dispatch(x @ self.gate, self.capacity(x.shape[0]))
        expert_out = self.experts(torch.einsum("nec,nh->ech", dispatch, x))
        return torch.einsum("nec,ech->nh", combine, expert_out)
