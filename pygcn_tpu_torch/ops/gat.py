"""Graph attention (GAT) ops: edge softmax and dynamic-weight aggregation.

The port of ``pygcn_tpu/ops/gat.py`` (GAT v1 and GATv2). v1's attention
logits decompose per edge ``u -> v`` as ``leaky_relu(a_src · s_u + a_dst · s_v)``
with ``s = x @ W``, so each edge needs two per-node scalars per head. GATv2's
``a · leaky_relu(s_l[u] + s_r[v])`` does not decompose: each edge needs the
full feature vectors. For each version three paths compute the same
convolution:

- **COO** (:func:`gat_attention`/:func:`gatv2_attention`,
  :func:`attention_aggregate`): softmax and aggregation over the graph's
  receiver-sorted edge arrays.
- **ELL** (:func:`gat_conv_ell`/:func:`gatv2_conv_ell`): per-bucket blocks of
  the bucketed-ELL layout, with an :class:`EdgeMap` telling which slots hold
  real edges.
- **hybrid** (:func:`gat_conv_hybrid`/:func:`gatv2_conv_hybrid`): tile edges
  on kernels B3/B5/B6 or B7/B8/B9 (``ops/cuda/gat_tile_attn.py``), residual
  edges on the ELL one-pass, merged by the rescaled flash combine.

Attention dropout (``attn_dropout``, a function that drops and rescales the
values of a tensor, ``nn.layers.dropout`` on one generator) runs on the COO
and ELL paths, as in JAX: on the attention coefficients, or, on the one-pass
ELL path, on the unnormalised numerator only (the denominator keeps every
edge), which is the same. The hybrid tile path takes none: the models send a
step with attention dropout to the slot path.

The JAX package replicates ``[.., H]`` logits f-fold into ``[.., H·F]`` lanes
(a TPU layout workaround); the port computes in ``[.., H]`` and broadcasts,
with the same results.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pygcn_tpu_torch.graph.graph import Graph, tree_to
from pygcn_tpu_torch.ops.cuda.gat_tile_attn import (NEG, gat_tile_partials, gatv2_tile_partials,
                                                    transpose_bcsr)
from pygcn_tpu_torch.utils.logging import span


def _leaky(x: torch.Tensor, slope: float) -> torch.Tensor:
    # where(x >= 0): the derivative at 0 is 1, as jax.nn.leaky_relu's
    return torch.where(x >= 0, x, slope * x)


def _segment_max(values: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """Per-segment max of ``values [E, ...]``; ``-inf`` for empty segments."""
    out = values.new_full((n,) + values.shape[1:], -torch.inf)
    idx = ids.long().view((-1,) + (1,) * (values.dim() - 1)).expand_as(values)
    return out.scatter_reduce(0, idx, values, "amax", include_self=True)


def _segment_sum(values: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    return values.new_zeros((n,) + values.shape[1:]).index_add_(0, ids, values)


def _edge_valid(graph: Graph) -> torch.Tensor:
    """``[E_pad]`` {0, 1}: padding edges (beyond ``n_edges``) must not attend."""
    return (torch.arange(graph.e_pad, device=graph.device) < graph.n_edges).float()


def edge_softmax(graph: Graph, logits: torch.Tensor) -> torch.Tensor:
    """Softmax of edge logits over each receiver's incoming edges.

    ``logits``: ``[E_pad]`` or ``[E_pad, H]`` → same shape; padding edges get
    0. The per-receiver max is a constant shift (it carries no gradient; the
    softmax does not depend on it).
    """
    valid = _edge_valid(graph).view((-1,) + (1,) * (logits.dim() - 1))
    neg = torch.where(valid > 0, logits, -torch.inf)
    m = _segment_max(neg.detach(), graph.receivers, graph.n_nodes)
    m = torch.where(torch.isfinite(m), m, 0.0)  # receivers with no edges
    recv = graph.receivers.long()
    ex = torch.exp(neg - m[recv]) * valid
    denom = _segment_sum(ex, graph.receivers, graph.n_nodes)[recv]
    return ex / torch.clamp(denom, min=1e-16)


def attention_aggregate(graph: Graph, s: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """``out_v = Σ_{u→v} alpha_uv · s_u``: COO SpMM with per-edge values.

    ``s``: ``[N, ...feat]``; ``alpha``: ``[E_pad]`` or per head ``[E_pad, H]``
    against ``s [N, H, F]``.
    """
    feat_shape = s.shape[1:]
    gathered = s.reshape(s.shape[0], -1).index_select(0, graph.senders)
    if alpha.dim() == 1:
        weighted = gathered * alpha[:, None]
    else:
        e = gathered.shape[0]
        weighted = (gathered.view((e,) + feat_shape) * alpha[..., None]).reshape(e, -1)
    out = _segment_sum(weighted, graph.receivers, graph.n_nodes)
    return out.view((graph.n_nodes,) + feat_shape)


def _node_logits(s: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor):
    return torch.einsum("nhf,hf->nh", s, a_src), torch.einsum("nhf,hf->nh", s, a_dst)


def gat_attention(graph: Graph, s: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor,
                  negative_slope: float = 0.2) -> torch.Tensor:
    """Per-edge, per-head attention weights ``alpha [E_pad, H]`` for
    ``s [N, H, F]`` and attention vectors ``a_src``/``a_dst [H, F]``."""
    logit_src, logit_dst = _node_logits(s, a_src, a_dst)
    e = logit_src[graph.senders.long()] + logit_dst[graph.receivers.long()]
    return edge_softmax(graph, _leaky(e, negative_slope))


def _v2_logits(g: torch.Tensor, d: torch.Tensor, a: torch.Tensor, negative_slope: float):
    """``a · leaky(g + d)`` over the last two axes: ``[..., H, F] → [..., H]``."""
    return torch.einsum("...hf,hf->...h", _leaky(g + d, negative_slope), a)


def gatv2_attention(graph: Graph, s_l: torch.Tensor, s_r: torch.Tensor, a: torch.Tensor,
                    negative_slope: float = 0.2) -> torch.Tensor:
    """Per-edge, per-head GATv2 attention weights ``alpha [E_pad, H]`` for the
    source and receiver transforms ``s_l``/``s_r [N, H, F]`` and ``a [H, F]``:
    the softmax of ``e_uv = a · leaky_relu(s_l[u] + s_r[v])``."""
    n, h, f = s_l.shape
    g = s_l.reshape(n, h * f).index_select(0, graph.senders).view(-1, h, f)
    d = s_r.reshape(n, h * f).index_select(0, graph.receivers).view(-1, h, f)
    return edge_softmax(graph, _v2_logits(g, d, a, negative_slope))


# ---------------------------------------------------------------------- #
# bucketed-ELL GAT: per-receiver reductions ride the layout's virtual rows
# ---------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class EdgeMap:
    """Per bucket, ``eidx [Nb, K]`` (the ELL block's shape): each slot's edge
    position in the graph's receiver-major edge order; padding slots hold
    ``sentinel`` (``e_pad``)."""

    eidx: tuple
    sentinel: int

    def to(self, device) -> "EdgeMap":
        return tree_to(self, device)


def build_edge_map(graph: Graph) -> EdgeMap:
    """Host-side: the ELL virtual-row chunking of ``ops/ell.py: build_ell``
    replayed over edge ids instead of values (the same row-major scan order
    as the NumPy and native builders)."""
    if graph.ell is None:
        raise ValueError("graph has no ELL layout (build with build_ell=True)")
    ks = graph.ell.ks
    indptr = graph.to_scipy().tocsr().indptr
    n = graph.n_nodes
    kmax = ks[-1]
    deg = np.diff(indptr).astype(np.int64)

    n_chunks = np.maximum(1, -(-deg // kmax))
    vrow_row = np.repeat(np.arange(n, dtype=np.int64), n_chunks)
    first = np.concatenate([[0], np.cumsum(n_chunks)[:-1]])
    chunk_ofs = np.arange(vrow_row.size) - np.repeat(first, n_chunks)
    vstart = indptr[vrow_row] + chunk_ofs * kmax
    vlen = np.minimum(deg[vrow_row] - chunk_ofs * kmax, kmax)
    bucket = np.searchsorted(ks, np.maximum(vlen, 1))

    sentinel = graph.e_pad
    eidx_out = []
    for j, k in enumerate(ks):
        sel = np.nonzero(bucket == j)[0]
        if sel.size == 0:
            eidx_out.append(torch.full((1, k), sentinel, dtype=torch.int32))
            continue
        offs = np.arange(k)
        idx = vstart[sel][:, None] + offs
        eidx = np.where(offs < vlen[sel][:, None], idx, sentinel)
        eidx_out.append(torch.from_numpy(eidx.astype(np.int32)))
    return EdgeMap(eidx=tuple(eidx_out), sentinel=sentinel)


def gat_conv_ell(graph: Graph, em: EdgeMap, s: torch.Tensor, a_src: torch.Tensor,
                 a_dst: torch.Tensor, negative_slope: float = 0.2, attn_dropout=None,
                 stabilizer: str = "flash") -> torch.Tensor:
    """GAT convolution on the bucketed-ELL layout: ``[N, H, F]`` out.

    ``stabilizer="flash"`` (the default; ``"bound"`` is its old name) runs
    :func:`gat_conv_ell_onepass`, exact by a per-virtual-row max and the
    rescaled combine. ``"segmax"`` is the three-pass form: a per-receiver max
    first, then the denominators, then the weighted sum.
    """
    if stabilizer in ("flash", "bound"):
        return gat_conv_ell_onepass(graph, em, s, a_src, a_dst, negative_slope, attn_dropout)
    if stabilizer != "segmax":
        raise ValueError(f"unknown stabilizer {stabilizer!r}")
    ell = graph.ell
    n, h, f = s.shape
    logit_src, logit_dst = _node_logits(s, a_src, a_dst)
    s2 = s.reshape(n, h * f)

    e_blocks, valid_blocks, max_parts = [], [], []
    for cols, eidx, rows in zip(ell.cols, em.eidx, ell.rows):
        nb, k = cols.shape
        valid = (eidx != em.sentinel)[..., None]  # [nb, k, 1]
        lsrc = logit_src.index_select(0, cols.reshape(-1)).view(nb, k, h)
        ldst = logit_dst.index_select(0, rows)[:, None, :]
        e = torch.where(valid, _leaky(lsrc + ldst, negative_slope), -torch.inf)
        e_blocks.append(e)
        valid_blocks.append(valid)
        max_parts.append(e.detach().amax(dim=1))  # [nb, h]
    r = torch.cat(ell.rows)
    m = _segment_max(torch.cat(max_parts), r, n)
    m = torch.where(torch.isfinite(m), m, 0.0)  # [N, H], a constant shift

    ex_blocks, den_parts = [], []
    for e, valid, rows in zip(e_blocks, valid_blocks, ell.rows):
        ex = torch.exp(e - m.index_select(0, rows)[:, None, :]) * valid
        ex_blocks.append(ex)
        den_parts.append(ex.sum(dim=1))
    denom = torch.clamp(_segment_sum(torch.cat(den_parts), r, n), min=1e-16)

    out_parts = []
    for cols, ex, rows in zip(ell.cols, ex_blocks, ell.rows):
        nb, k = cols.shape
        alpha = ex / denom.index_select(0, rows)[:, None, :]  # [nb, k, h]
        if attn_dropout is not None:
            alpha = attn_dropout(alpha)
        g = s2.index_select(0, cols.reshape(-1)).view(nb, k, h, f)
        out_parts.append((g * alpha[..., None]).reshape(nb, k, h * f).sum(dim=1))
    return _segment_sum(torch.cat(out_parts), r, n).view(n, h, f)


def gat_conv_ell_onepass(graph: Graph, em: EdgeMap, s: torch.Tensor, a_src: torch.Tensor,
                         a_dst: torch.Tensor, negative_slope: float = 0.2,
                         attn_dropout=None) -> torch.Tensor:
    """One-pass GAT convolution, exact by a flash-style two-level softmax:
    each virtual row exponentiates against its own max and emits partial
    ``(num, den, max)``; the combine rescales every partial by
    ``exp(local_max − receiver_max)`` before the segment sums."""
    n, h, f = s.shape
    logit_src, logit_dst = _node_logits(s, a_src, a_dst)
    valids = [eidx != em.sentinel for eidx in em.eidx]
    num, den, _m = _ell_attn_partials(graph.ell, logit_src, logit_dst, s.reshape(n, h * f),
                                      h, f, negative_slope, valids, attn_dropout)
    return (num.view(n, h, f) / torch.clamp(den, min=1e-16)[..., None])


def _ell_attn_partials(ell, logit_src, logit_dst, s2, h: int, f: int, negative_slope: float,
                       valids, attn_dropout=None):
    """Per-receiver attention partials over an ELL layout's edges.

    ``logit_src``/``logit_dst``: per-head node logits ``[N, H]``; ``s2``:
    ``[N, H·F]`` features; ``valids``: per-bucket ``[Nb, K]`` bool of real
    slots. Returns ``(num [N, H·F], den [N, H], m [N, H])``:
    ``num = Σ exp(e − m_v) s``, ``den = Σ exp(e − m_v)`` and ``m`` the
    per-receiver max logit over these edges (``-inf`` where a receiver has
    none; no gradient). ``attn_dropout`` drops terms of ``num`` only. The
    JAX function returns ``den`` and ``m`` replicated f-fold, ``[N, H·F]``;
    the values are the same.
    """
    n = s2.shape[0]
    parts = []
    for cols, rows, valid2 in zip(ell.cols, ell.rows, valids):
        nb, k = cols.shape
        flat = cols.reshape(-1)
        lsrc = logit_src.index_select(0, flat).view(nb, k, h)
        ldst = logit_dst.index_select(0, rows)[:, None, :]
        e = torch.where(valid2[..., None], _leaky(lsrc + ldst, negative_slope), -torch.inf)
        parts.append(_vrow_partials(e, s2.index_select(0, flat).view(nb, k, h, f),
                                    _kept(attn_dropout, e)))
    return _combine_vrow_partials(ell, parts, n, f)


def _kept(attn_dropout, e: torch.Tensor):
    """The attention-dropout factors ``[nb, K, H]`` of a bucket whose slot
    logits are ``e`` (0 or ``1 / keep``), or None without dropout."""
    return None if attn_dropout is None else attn_dropout(torch.ones_like(e.detach()))


def _vrow_partials(e: torch.Tensor, g: torch.Tensor, kept=None):
    """One bucket's virtual-row partials ``(num [nb, H·F], den [nb, H],
    max [nb, H])`` from its slot logits ``e [nb, K, H]`` (``-inf`` on padding
    slots) and gathered features ``g [nb, K, H, F]``, each row exponentiated
    against its own max (no gradient through the max); ``kept`` (attention
    dropout's factors) scales the terms of ``num`` only."""
    nb, k, h, f = g.shape
    # local max over this virtual row's slots; -inf only for all-padding rows
    bmax = e.detach().amax(dim=1)  # [nb, h]
    shift = torch.where(torch.isfinite(bmax), bmax, 0.0)
    ex = torch.exp(e - shift[:, None, :])  # [nb, k, h]; padding slots exp(-inf) = 0
    w = ex if kept is None else ex * kept
    return (g * w[..., None]).sum(dim=1).reshape(nb, h * f), ex.sum(dim=1), bmax


def _combine_vrow_partials(ell, parts, n: int, f: int):
    """Every virtual row's partials onto its receiver's max: ``(num [N, H·F],
    den [N, H], m [N, H])``, ``m`` ``-inf`` where a receiver has no slot."""
    num_parts, den_parts, max_parts = zip(*parts)
    r = torch.cat(ell.rows)
    bmax = torch.cat(max_parts)  # [V, h]
    m = _segment_max(bmax, r, n)
    shift_m = torch.where(torch.isfinite(m), m, 0.0)
    # each virtual row's partials onto the receiver's shift; the local shifts
    # cancel exactly (all-padding rows get scale 0)
    scale = torch.exp(bmax - shift_m.index_select(0, r))  # [V, h]
    num = _segment_sum(torch.cat(num_parts) * scale.repeat_interleave(f, dim=1), r, n)
    den = _segment_sum(torch.cat(den_parts) * scale, r, n)
    return num, den, m


def gatv2_conv_ell(graph: Graph, em: EdgeMap, s_l: torch.Tensor, s_r: torch.Tensor,
                   a: torch.Tensor, negative_slope: float = 0.2, attn_dropout=None,
                   stabilizer: str = "flash") -> torch.Tensor:
    """GATv2 convolution on the bucketed-ELL layout: ``[N, H, F]`` out.

    ``stabilizer="flash"`` (the default; ``"bound"`` is its old name) runs
    :func:`gatv2_conv_ell_onepass`; v1's node-level bound has no v2 analogue
    (the nonlinearity precedes ``a``), but the exact per-virtual-row combine
    needs none. ``"segmax"`` is the three-pass form: a per-receiver max, then
    the denominators, then the weighted sum of ``s_l``.
    """
    if stabilizer in ("flash", "bound"):
        return gatv2_conv_ell_onepass(graph, em, s_l, s_r, a, negative_slope, attn_dropout)
    if stabilizer != "segmax":
        raise ValueError(f"unknown stabilizer {stabilizer!r}")
    ell = graph.ell
    n, h, f = s_l.shape
    sl2, sr2 = s_l.reshape(n, h * f), s_r.reshape(n, h * f)

    e_blocks, valid_blocks, max_parts = [], [], []
    for cols, eidx, rows in zip(ell.cols, em.eidx, ell.rows):
        nb, k = cols.shape
        valid = (eidx != em.sentinel)[..., None]  # [nb, k, 1]
        g = sl2.index_select(0, cols.reshape(-1)).view(nb, k, h, f)
        d = sr2.index_select(0, rows).view(nb, 1, h, f)
        e = torch.where(valid, _v2_logits(g, d, a, negative_slope), -torch.inf)
        e_blocks.append(e)
        valid_blocks.append(valid)
        max_parts.append(e.detach().amax(dim=1))  # [nb, h]
    r = torch.cat(ell.rows)
    m = _segment_max(torch.cat(max_parts), r, n)
    m = torch.where(torch.isfinite(m), m, 0.0)  # [N, H], a constant shift

    ex_blocks, den_parts = [], []
    for e, valid, rows in zip(e_blocks, valid_blocks, ell.rows):
        ex = torch.exp(e - m.index_select(0, rows)[:, None, :]) * valid
        ex_blocks.append(ex)
        den_parts.append(ex.sum(dim=1))
    denom = torch.clamp(_segment_sum(torch.cat(den_parts), r, n), min=1e-16)

    out_parts = []
    for cols, ex, rows in zip(ell.cols, ex_blocks, ell.rows):
        nb, k = cols.shape
        alpha = ex / denom.index_select(0, rows)[:, None, :]  # [nb, k, h]
        if attn_dropout is not None:
            alpha = attn_dropout(alpha)
        g = sl2.index_select(0, cols.reshape(-1)).view(nb, k, h, f)
        out_parts.append((g * alpha[..., None]).reshape(nb, k, h * f).sum(dim=1))
    return _segment_sum(torch.cat(out_parts), r, n).view(n, h, f)


def gatv2_conv_ell_onepass(graph: Graph, em: EdgeMap, s_l: torch.Tensor, s_r: torch.Tensor,
                           a: torch.Tensor, negative_slope: float = 0.2,
                           attn_dropout=None) -> torch.Tensor:
    """One-pass GATv2 convolution by the flash-style two-level softmax of
    :func:`gat_conv_ell_onepass`: one gather of the source block per bucket
    feeds both the logit and the weighted sum."""
    n, h, f = s_l.shape
    valids = [eidx != em.sentinel for eidx in em.eidx]
    num, den, _m = _ell_attn_partials_v2(graph.ell, s_l.reshape(n, h * f),
                                         s_r.reshape(n, h * f), a, h, f, negative_slope, valids,
                                         attn_dropout)
    return num.view(n, h, f) / torch.clamp(den, min=1e-16)[..., None]


def _ell_attn_partials_v2(ell, sl2, sr2, a, h: int, f: int, negative_slope: float, valids,
                          attn_dropout=None):
    """Per-receiver GATv2 attention partials over an ELL layout's edges, the
    v2 analogue of :func:`_ell_attn_partials` with the same return contract:
    ``(num [N, H·F], den [N, H], m [N, H])``, ``num`` aggregating ``sl2``. The
    JAX function returns ``den`` and ``m`` replicated f-fold, ``[N, H·F]``;
    the values are the same."""
    n = sl2.shape[0]
    parts = []
    for cols, rows, valid2 in zip(ell.cols, ell.rows, valids):
        nb, k = cols.shape
        g = sl2.index_select(0, cols.reshape(-1)).view(nb, k, h, f)
        d = sr2.index_select(0, rows).view(nb, 1, h, f)
        e = torch.where(valid2[..., None], _v2_logits(g, d, a, negative_slope), -torch.inf)
        parts.append(_vrow_partials(e, g, _kept(attn_dropout, e)))
    return _combine_vrow_partials(ell, parts, n, f)


def build_gat_tiles_t(graph: Graph):
    """Host-side: the exact transpose of the hybrid layout's forward tiles
    (:func:`~pygcn_tpu_torch.ops.cuda.gat_tile_attn.transpose_bcsr`) for
    :func:`gat_conv_hybrid`'s sender-indexed backward, or None when the
    hybrid layout has no tiles.

    Also checks that every real edge has a nonzero weight:
    :func:`gat_conv_hybrid` reads residual-slot validity from ``ell.vals != 0``,
    so an explicitly stored zero-weight edge would silently drop out of
    attention, unlike on the edge-map and COO paths, which are structural.
    """
    if graph.hybrid is None:
        raise ValueError("graph has no hybrid layout; build with build_hybrid=True")
    w = graph.weights[: graph.n_edges].cpu().numpy()
    if w.size and not np.all(w != 0):
        raise ValueError(
            "gat_conv_hybrid requires all real edge weights to be nonzero "
            "(residual-slot validity is inferred from vals != 0); found "
            f"{int((w == 0).sum())} zero-weight edges; use the edge_map "
            "(gat_conv_ell) path for graphs with explicit zero edges"
        )
    if graph.hybrid.bcsr is None:
        return None
    return transpose_bcsr(graph.hybrid.bcsr)


def gat_conv_hybrid(graph: Graph, tiles_t, s: torch.Tensor, a_src: torch.Tensor,
                    a_dst: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """GAT convolution on the hybrid BCSR+ELL layout: ``[N, H, F]`` out.

    Edges inside the dense tiles run on kernels B3/B5/B6
    (:func:`~pygcn_tpu_torch.ops.cuda.gat_tile_attn.gat_tile_partials`), the
    residual edges on the ELL one-pass; both emit per-receiver
    ``(num, den, max)`` partials, and the exact softmax over the whole
    neighbourhood is their rescaled flash merge. ``tiles_t`` is
    :func:`build_gat_tiles_t` of the graph. Needs the hybrid layout with an
    ELL residual; attention dropout is not supported here.
    """
    ell = _hybrid_residual(graph, tiles_t)
    n, h, f = s.shape
    lsrc_n, ldst_n = _node_logits(s, a_src, a_dst)  # [N, H]
    s2 = s.reshape(n, h * f)
    with span("gat.ell"):
        edge = _ell_attn_partials(ell, lsrc_n, ldst_n, s2, h, f, negative_slope,
                                  [v != 0 for v in ell.vals])
    tile = None
    if graph.hybrid.bcsr is not None:
        with span("gat.tile"):
            tile = gat_tile_partials((h, f, negative_slope), graph.hybrid.bcsr, tiles_t,
                                     lsrc_n, ldst_n, s2)
    return _flash_merge(tile, edge, n, h, f)


def _hybrid_residual(graph: Graph, tiles_t):
    """The hybrid layout's ELL residual, after the checks both hybrid
    convolutions need. Its slot is real iff it stores an adjacency value
    (normalised adjacencies are > 0 on real edges), so callers pass
    ``vals != 0`` as the valid slots."""
    from pygcn_tpu_torch.ops.ell import ELL

    hy = graph.hybrid
    if hy is None:
        raise ValueError("graph has no hybrid layout; build with build_hybrid=True")
    if not isinstance(hy.ell, ELL):
        raise ValueError("hybrid attention needs an ELL residual (hybrid_residual='ell')")
    if hy.bcsr is not None and tiles_t is None:
        raise ValueError("pass tiles_t=build_gat_tiles_t(graph)")
    return hy.ell


def _flash_merge(tile, edge, n: int, h: int, f: int) -> torch.Tensor:
    """``[N, H, F]`` softmax-weighted sums from the tile side's and the ELL
    residual's ``(num [N, H·F], den [N, H], m [N, H])`` partials (``tile``
    None when the layout has no tiles).

    The exact softmax across both structures: both partial sets are rescaled
    onto the combined per-receiver max. The tile side marks "no edge" with
    NEG, the ELL side with -inf; receivers with no edge at all end at
    0 / 1e-16.
    """
    num_e, den_e, m_e = edge
    if tile is None:
        return num_e.view(n, h, f) / torch.clamp(den_e, min=1e-16)[..., None]
    num_t, den_t, m_t = tile
    m_comb = torch.maximum(m_t, m_e).detach()
    shift = torch.where(m_comb > -1e29, m_comb, 0.0)
    st = torch.exp(m_t - shift)
    se = torch.exp(torch.where(torch.isfinite(m_e), m_e, NEG) - shift)
    num = num_t.view(n, h, f) * st[..., None] + num_e.view(n, h, f) * se[..., None]
    den = den_t * st + den_e * se
    return num / torch.clamp(den, min=1e-16)[..., None]


def gatv2_conv_hybrid(graph: Graph, tiles_t, s_l: torch.Tensor, s_r: torch.Tensor,
                      a: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """GATv2 convolution on the hybrid BCSR+ELL layout: ``[N, H, F]`` out.

    Tile edges run on kernels B7/B8/B9
    (:func:`~pygcn_tpu_torch.ops.cuda.gat_tile_attn.gatv2_tile_partials`), the
    residual edges on the ELL v2 one-pass, and :func:`gat_conv_hybrid`'s flash
    merge joins them. The same constraints as v1: the hybrid layout with an
    ELL residual, all-nonzero edge weights (checked by
    :func:`build_gat_tiles_t`), no attention dropout on this path.
    """
    ell = _hybrid_residual(graph, tiles_t)
    n, h, f = s_l.shape
    sl2, sr2 = s_l.reshape(n, h * f), s_r.reshape(n, h * f)
    edge = _ell_attn_partials_v2(ell, sl2, sr2, a, h, f, negative_slope,
                                 [v != 0 for v in ell.vals])
    tile = None if graph.hybrid.bcsr is None else gatv2_tile_partials(
        (h, f, negative_slope), graph.hybrid.bcsr, tiles_t, sl2, sr2, a)
    return _flash_merge(tile, edge, n, h, f)
