"""Graph attention network (GAT) layers as ``nn.Module``\\ s.

The port of ``pygcn_tpu/nn/gat.py``: multi-head additive attention
(Veličković et al. 2018) or its dynamic GATv2 form (Brody et al. 2022), ELU
between the layers, head-concat on the hidden layer and head-mean on the
output layer. Weights are drawn from an explicit ``torch.Generator`` with the
reference's GraphConv bounds (``pygcn_tpu_torch/nn/init.py``); tests that
need the JAX package's weights carry them across with
``pygcn_tpu_torch.convert``. Training with dropout (the paper's, on the
layer inputs and the attention coefficients) takes an explicit generator.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pygcn_tpu_torch.graph.graph import Graph
from pygcn_tpu_torch.nn import init as tinit
from pygcn_tpu_torch.nn.layers import dropout
from pygcn_tpu_torch.ops.gat import (attention_aggregate, gat_attention, gat_conv_ell,
                                     gat_conv_hybrid, gatv2_attention, gatv2_conv_ell,
                                     gatv2_conv_hybrid)
from pygcn_tpu_torch.ops.gat_colpanel import gat_conv_colpanel, gatv2_conv_colpanel
from pygcn_tpu_torch.utils.logging import span


class GATConv(nn.Module):
    """One multi-head GAT layer.

    ``out = concat_h(Σ_u alpha^h_uv · (x_u @ W^h))`` (mean over heads when
    ``concat=False``), ``alpha`` the per-receiver softmax of
    ``leaky_relu(a_src·s_u + a_dst·s_v)``. Parameters as in the JAX tree:
    ``w [in, H·F]``, ``a_src``/``a_dst [H, F]``, ``b [H·F]`` (``[F]`` when
    averaging).
    """

    def __init__(self, in_features: int, out_features: int, heads: int = 1,
                 concat: bool = True, negative_slope: float = 0.2, bias: bool = True, *,
                 generator: torch.Generator):
        super().__init__()
        h, f = heads, out_features
        self.heads, self.out_features = h, f
        self.concat, self.negative_slope = concat, negative_slope
        self.w = nn.Parameter(tinit.graphconv_weight(in_features, h * f, generator))
        self.a_src = nn.Parameter(tinit.graphconv_weight(h, f, generator))
        self.a_dst = nn.Parameter(tinit.graphconv_weight(h, f, generator))
        self.b = nn.Parameter(tinit.graphconv_bias(h * f if concat else f, generator)) \
            if bias else None

    def forward(self, x: torch.Tensor, graph: Graph, edge_map=None, hybrid_tiles: bool = False,
                tiles_t=None, attn_dropout=None, colpanel: bool = False) -> torch.Tensor:
        """The column-panel sweeps when ``colpanel`` (``ops/gat_colpanel.py``;
        run ``check_gat_colpanel`` on the host graph once), else tile
        attention on the hybrid layout when ``hybrid_tiles`` (with
        ``tiles_t`` from ``ops.gat.build_gat_tiles_t``), else the ELL path
        when an ``edge_map`` is given, else the COO path. ``attn_dropout``
        drops attention coefficients; the tile path takes none, so with it
        the layer runs the ELL or COO path, as in JAX."""
        n = x.shape[0]
        h, f = self.heads, self.out_features
        s = torch.matmul(x, self.w).view(n, h, f)
        if colpanel:
            out = gat_conv_colpanel(graph, s, self.a_src, self.a_dst, self.negative_slope,
                                    attn_dropout)
        elif hybrid_tiles and attn_dropout is None:
            out = gat_conv_hybrid(graph, tiles_t, s, self.a_src, self.a_dst, self.negative_slope)
        elif edge_map is not None:
            out = gat_conv_ell(graph, edge_map, s, self.a_src, self.a_dst, self.negative_slope,
                               attn_dropout)
        else:
            alpha = gat_attention(graph, s, self.a_src, self.a_dst, self.negative_slope)
            if attn_dropout is not None:
                alpha = attn_dropout(alpha)  # the paper's dropout on the coefficients
            out = attention_aggregate(graph, s, alpha)  # [N, H, F]
        return _combine_heads(out, self.concat, self.b)


def _combine_heads(out: torch.Tensor, concat: bool, b) -> torch.Tensor:
    """``[N, H, F]`` → ``[N, H·F]`` (``concat``) or the mean over heads, plus the bias."""
    out = out.reshape(out.shape[0], -1) if concat else out.mean(dim=1)
    return out if b is None else out + b


class GATv2Conv(nn.Module):
    """One multi-head GATv2 layer.

    ``e_uv = a · leaky_relu(x_u @ W_l + x_v @ W_r)``: the nonlinearity
    precedes the attention vector, so the ranking of neighbours can depend on
    the receiver. Aggregates the source transform,
    ``out_v = Σ_u alpha_uv · (x_u @ W_l)``. Parameters as in the JAX tree:
    ``w_l [in, H·F]``, ``a [H, F]``, ``w_r [in, H·F]`` (absent with
    ``share_weights``, which ties ``W_r = W_l``) and ``b``.
    """

    def __init__(self, in_features: int, out_features: int, heads: int = 1,
                 concat: bool = True, negative_slope: float = 0.2, bias: bool = True,
                 share_weights: bool = False, *, generator: torch.Generator):
        super().__init__()
        h, f = heads, out_features
        self.heads, self.out_features = h, f
        self.concat, self.negative_slope = concat, negative_slope
        self.w_l = nn.Parameter(tinit.graphconv_weight(in_features, h * f, generator))
        self.a = nn.Parameter(tinit.graphconv_weight(h, f, generator))
        self.w_r = None if share_weights else nn.Parameter(
            tinit.graphconv_weight(in_features, h * f, generator))
        self.b = nn.Parameter(tinit.graphconv_bias(h * f if concat else f, generator)) \
            if bias else None

    def forward(self, x: torch.Tensor, graph: Graph, edge_map=None, hybrid_tiles: bool = False,
                tiles_t=None, attn_dropout=None, colpanel: bool = False) -> torch.Tensor:
        """The paths of :meth:`GATConv.forward`; on the hybrid layout the
        tile edges run on kernels B7/B8/B9."""
        n = x.shape[0]
        h, f = self.heads, self.out_features
        s_l = torch.matmul(x, self.w_l).view(n, h, f)
        s_r = torch.matmul(x, self.w_l if self.w_r is None else self.w_r).view(n, h, f)
        if colpanel:
            out = gatv2_conv_colpanel(graph, s_l, s_r, self.a, self.negative_slope, attn_dropout)
        elif hybrid_tiles and attn_dropout is None:
            out = gatv2_conv_hybrid(graph, tiles_t, s_l, s_r, self.a, self.negative_slope)
        elif edge_map is not None:
            out = gatv2_conv_ell(graph, edge_map, s_l, s_r, self.a, self.negative_slope,
                                 attn_dropout)
        else:
            alpha = gatv2_attention(graph, s_l, s_r, self.a, self.negative_slope)
            if attn_dropout is not None:
                alpha = attn_dropout(alpha)
            out = attention_aggregate(graph, s_l, alpha)  # [N, H, F]
        return _combine_heads(out, self.concat, self.b)


class GAT(nn.Module):
    """2-layer GAT: ``elu(GATConv(heads, concat)) → GATConv(out_heads, mean)``
    with log-softmax output, the standard transductive configuration (8
    hidden heads of 8 features, one output head); ``v2`` takes
    :class:`GATv2Conv` layers.

    ``dropout`` applies to both layers' inputs and attention coefficients
    when :meth:`forward` gets a ``dropout_generator`` in training mode (the
    JAX model's ``dropout_rng``); then the layers leave the hybrid tile path
    for the slot path, as JAX's do, and input dropout still applies.
    Evaluation (no generator, or eval mode) runs the tile path. ``colpanel``
    runs both layers on the column-panel sweeps (graphs above a million
    nodes), with or without attention dropout."""

    def __init__(self, nfeat: int, nhid: int, nclass: int, heads: int = 8, out_heads: int = 1,
                 negative_slope: float = 0.2, dropout: float = 0.0, v2: bool = False, *,
                 generator: torch.Generator):
        super().__init__()
        self.dropout = dropout
        conv = GATv2Conv if v2 else GATConv
        self.gat1 = conv(nfeat, nhid, heads, concat=True, negative_slope=negative_slope,
                         generator=generator)
        self.gat2 = conv(nhid * heads, nclass, out_heads, concat=False,
                         negative_slope=negative_slope, generator=generator)

    def forward(self, x: torch.Tensor, graph: Graph, edge_map=None, hybrid_tiles: bool = False,
                tiles_t=None, dropout_generator=None, colpanel: bool = False) -> torch.Tensor:
        drop = None
        if dropout_generator is not None and self.training and self.dropout > 0.0:
            def drop(a):
                return dropout(a, self.dropout, dropout_generator)
        kw = dict(edge_map=edge_map, hybrid_tiles=hybrid_tiles, tiles_t=tiles_t,
                  attn_dropout=drop, colpanel=colpanel)
        with span("model.forward"):
            if drop is not None:
                x = drop(x)
            x = F.elu(self.gat1(x, graph, **kw))
            if drop is not None:
                x = drop(x)
            return F.log_softmax(self.gat2(x, graph, **kw), dim=1)
