"""The GAT of Veličković et al. (ICLR 2018) in plain PyTorch, over the edges
of ``max(A, A^T) + I`` (its weights are not used): per head,
``alpha_vu = softmax_u(leaky_relu(a_src · s_u + a_dst · s_v))`` over the
senders ``u`` of each receiver ``v``, ``out_v = Σ_u alpha_vu s_u`` with
``s = h W``; the hidden layer's heads concatenated and followed by ELU, the
output layer's averaged, then log-softmax. ``params`` holds the leaves by
name (``gat<l>.w [in, H·F]``, ``gat<l>.a_src``/``a_dst [H, F]``,
``gat<l>.b``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.adjacency import Adjacency, normalized


def adjacency(rows, cols, vals, n: int, device, dtype=torch.float32) -> Adjacency:
    return normalized(rows, cols, vals, n, device, dtype)


def _layer(params: dict, name: str, adj: Adjacency, h: torch.Tensor, heads: int,
           slope: float, concat: bool, matmul) -> torch.Tensor:
    n = h.shape[0]
    w = params[f"{name}.w"]
    s = matmul(h, w).view(n, heads, -1)
    l_src = (s * params[f"{name}.a_src"]).sum(-1)
    l_dst = (s * params[f"{name}.a_dst"]).sum(-1)
    e = l_src[adj.cols] + l_dst[adj.rows]
    e = torch.where(e >= 0, e, slope * e)
    m = e.new_full((n, heads), -torch.inf).scatter_reduce(
        0, adj.rows[:, None].expand_as(e), e.detach(), "amax", include_self=True)
    p = torch.exp(e - m[adj.rows])
    den = e.new_zeros((n, heads)).index_add(0, adj.rows, p)
    num = s.new_zeros(s.shape).index_add(0, adj.rows, p[..., None] * s[adj.cols])
    out = num / den[..., None]
    out = out.reshape(n, -1) if concat else out.mean(dim=1)
    return out + params[f"{name}.b"]


def forward(config: dict, params: dict, adj: Adjacency, x: torch.Tensor,
            matmul=torch.matmul) -> torch.Tensor:
    slope = config["negative_slope"]
    h = F.elu(_layer(params, "gat1", adj, x, config["heads"], slope, True, matmul))
    out = _layer(params, "gat2", adj, h, config["out_heads"], slope, False, matmul)
    return F.log_softmax(out, dim=1)
