"""Distributed GAT and GATv2 over the graph axis (halo-exchange attention).

The port of ``pygcn_tpu/parallel/dist_gat.py``. ``build_dist_plan``
partitions edges by receiver, so every receiver's incoming edges live on its
owner rank and the edge softmax is local to the shard. Only sender-side rows
cross ranks, in one halo exchange per layer: v1 ships ``[s | logit_src]``
(the transformed features and the source logits side by side); v2 ships the
source transform ``s_l`` alone, its logits ``a · leaky_relu(s_l[u] +
s_r[v])`` computed on the receiver's rank. The softmax runs over the
shard's local and remote edges together: a segment max (a constant shift
that carries no gradient, set to 0 where a receiver has no edge), then
exp, a segment sum floored at 1e-16, and the weighted sum of the senders'
rows. As in JAX, an edge is valid where its plan weight is not 0 (padding
edges carry 0; the normalised adjacency's edges are positive). No tile
kernel runs on this path.

Parameters are the single-device layers' (``nn/gat.GATConv``,
``GATv2Conv``), in their order and under their names, so a
:class:`DistGAT`'s state dict is ``nn.gat.GAT``'s.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pygcn_tpu_torch.nn import init as tinit
from pygcn_tpu_torch.ops.gat import _leaky, _segment_max, _segment_sum
from pygcn_tpu_torch.parallel.dist_spmm import DistModule, halo_exchange, seeded
from pygcn_tpu_torch.parallel.mesh import Mesh


class DistGATConv(DistModule):
    """One multi-head GAT (or, with ``v2``, GATv2) layer on this rank's rows:
    ``x [S, F_in]`` → ``[S, H·F]`` (``concat``) or ``[S, F]`` (the mean over
    heads)."""

    def __init__(self, mesh: Mesh, plan, in_features: int, out_features: int,
                 heads: int = 1, concat: bool = True, negative_slope: float = 0.2,
                 axis: str = "graph", v2: bool = False, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(mesh, plan, axis)
        g = seeded(generator)
        h, f = heads, out_features
        self.heads, self.out_features = h, f
        self.concat, self.negative_slope, self.v2 = concat, negative_slope, v2
        if v2:  # GATv2Conv's order: w_l, a, w_r, b
            self.w_l = nn.Parameter(tinit.graphconv_weight(in_features, h * f, g))
            self.a = nn.Parameter(tinit.graphconv_weight(h, f, g))
            self.w_r = nn.Parameter(tinit.graphconv_weight(in_features, h * f, g))
        else:  # GATConv's: w, a_src, a_dst, b
            self.w = nn.Parameter(tinit.graphconv_weight(in_features, h * f, g))
            self.a_src = nn.Parameter(tinit.graphconv_weight(h, f, g))
            self.a_dst = nn.Parameter(tinit.graphconv_weight(h, f, g))
        self.b = nn.Parameter(tinit.graphconv_bias(h * f if concat else f, g))
        sh = self.shard
        self._edges = ((sh.loc_s, sh.loc_r, (sh.loc_w != 0)[:, None]),
                       (sh.rem_h, sh.rem_r, (sh.rem_w != 0)[:, None]))

    def _attend(self, table: torch.Tensor, recv: torch.Tensor) -> torch.Tensor:
        """The shard's attention: ``table`` holds the sender-side rows (v1
        ``[s2 | lsrc]``, v2 ``s_l2``), ``recv`` the receiver side (v1
        ``ldst [S, H]``, v2 ``s_r2 [S, H·F]``); one halo exchange of
        ``table``. Returns ``[S, H·F]``."""
        h, f, slope = self.heads, self.out_features, self.negative_slope
        n = self.shard.shard_size
        halo = halo_exchange(table, self.shard.send_idx, self.mesh.group(self.axis))
        sources = (table, halo.reshape(-1, table.shape[1]))  # local rows, then the halo table

        logits = []
        for src, (senders, receivers, valid) in zip(sources, self._edges):
            if self.v2:
                pre = _leaky(src.index_select(0, senders) + recv.index_select(0, receivers),
                             slope)
                e = (pre.view(-1, h, f) * self.a).sum(dim=-1)  # [E, H]
            else:
                e = _leaky(src[:, h * f:].index_select(0, senders)
                           + recv.index_select(0, receivers), slope)
            logits.append(torch.where(valid, e, -torch.inf))

        (_, r_loc, v_loc), (_, r_rem, v_rem) = self._edges
        e_loc, e_rem = logits
        m = torch.maximum(_segment_max(e_loc.detach(), r_loc, n),
                          _segment_max(e_rem.detach(), r_rem, n))
        m = torch.where(torch.isfinite(m), m, 0.0)
        ex = (torch.exp(e_loc - m.index_select(0, r_loc)) * v_loc,
              torch.exp(e_rem - m.index_select(0, r_rem)) * v_rem)
        denom = torch.clamp(_segment_sum(ex[0], r_loc, n) + _segment_sum(ex[1], r_rem, n),
                            min=1e-16)

        out = table.new_zeros((n, h * f))
        for x, src, (senders, receivers, _) in zip(ex, sources, self._edges):
            alpha = x / denom.index_select(0, receivers)  # [E, H]
            rows = src[:, : h * f].index_select(0, senders)
            out = out.index_add(0, receivers, rows * alpha.repeat_interleave(f, dim=1))
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, f = self.heads, self.out_features
        if self.v2:
            out = self._attend(x @ self.w_l, x @ self.w_r)
        else:
            s2 = x @ self.w
            s3 = s2.view(-1, h, f)
            lsrc = torch.einsum("nhf,hf->nh", s3, self.a_src)
            ldst = torch.einsum("nhf,hf->nh", s3, self.a_dst)
            out = self._attend(torch.cat([s2, lsrc], dim=1), ldst)
        if not self.concat:
            out = out.view(-1, h, f).mean(dim=1)
        return out + self.b


class DistGAT(nn.Module):
    """2-layer distributed GAT classifier, as ``nn.gat.GAT``:
    ``elu(gat1: heads, concat) → gat2: out_heads, mean → log_softmax``."""

    def __init__(self, mesh: Mesh, plan, nfeat: int, nhid: int, nclass: int, heads: int = 8,
                 out_heads: int = 1, negative_slope: float = 0.2, axis: str = "graph",
                 v2: bool = False, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = seeded(generator)
        self.gat1 = DistGATConv(mesh, plan, nfeat, nhid, heads=heads, concat=True,
                                negative_slope=negative_slope, axis=axis, v2=v2, generator=g)
        self.gat2 = DistGATConv(mesh, self.gat1.shard, nhid * heads, nclass, heads=out_heads,
                                concat=False, negative_slope=negative_slope, axis=axis, v2=v2,
                                generator=g)
        self.mesh, self.axis, self.shard = mesh, axis, self.gat1.shard
        self.shard_x = self.gat1.shard_x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.elu(self.gat1(x))
        return F.log_softmax(self.gat2(x), dim=1)
