"""GAT / GATv2 attention on the column-panel layout — graphs above a million nodes.

The port of ``pygcn_tpu/ops/gat_colpanel.py``: the exact edge softmax in two
sweeps over the live buckets of ``graph.colpanel`` (``ops/colpanel.py``),
every sender-side gather reading the panel's slice of the node tables.

- **Sweep A** (no gradient): the per-receiver logit max ``m [N, H]``. A
  bucket's virtual rows hold at most a row's slots in one panel, and the
  max is order-free, so each bucket updates ``m`` by ``scatter_reduce_``.
- **Sweep B**: with ``m`` known every bucket's terms are final:
  ``num += Σ exp(e − m_v)·s_u`` and ``den += Σ exp(e − m_v)``, added with one
  add per receiver and bucket (``colpanel.merge_add``), so the forward gives
  the same bits on every run.

Slot validity is read from the stored ``vals != 0``: a receiver with no edge
keeps ``m = -inf``, takes a shift of 0 and gets ``num / max(den, 1e-16) = 0``.
:func:`check_gat_colpanel` is the host-side guard against the two inputs
that break the inference: explicit zero-weight edges and duplicate edges
(``build_col_panel_ell``'s ``tocsc()`` sums them). Attention ignores the weights
themselves, as every GAT path does.

Without attention dropout the convolutions are :class:`torch.autograd.Function`\\ s
with a hand-written backward: a third sweep re-derives each bucket's
coefficients from the saved ``(m, den)`` (``[N, H]``) and adds the sender
gradients into the panel's rows of the ``[N, H, F]`` gradient, the receiver
gradients with one add per receiver and bucket (the sender adds repeat rows,
so the gradients agree between runs to rounding, not bit for bit). With
``attn_dropout`` (a function that drops and rescales a tensor's values,
``nn.layers.dropout`` on one generator) autograd differentiates the sweeps;
the dropout scales the numerator's terms only, ``den`` keeps every edge.

The JAX module computes in f-replicated ``[.., H·F]`` lanes, serialises its
panel groups behind optimisation barriers and splits the step into two
programs, all to fit a TPU's 15.75 GB; the port computes in ``[.., H]`` and
runs the buckets in order.
"""

from __future__ import annotations


import numpy as np
import scipy.sparse as sp
import torch

from pygcn_tpu_torch.ops.colpanel import ColPanelELL, buckets, merge_add, row_chunks
from pygcn_tpu_torch.ops.gat import _kept, _leaky

# Bound on one bucket's widest transient, ``[rows·k, H·F]`` elements (512 MiB
# of f32); the backward keeps about five such tensors alive at once. A wider
# bucket runs in row chunks, with the same values.
ATTN_CHUNK_BUDGET_ELEMS = 1 << 27


def check_gat_colpanel(graph, senders=None, receivers=None, weights=None) -> None:
    """Host-side guard for the ``vals != 0`` validity inference; run it once,
    before the graph moves to the card (or pass the host edge arrays).

    Raises when an edge has weight 0 (its slot would look empty and drop out
    of the softmax), or when COO edges repeat: ``build_col_panel_ell`` sums
    duplicates, so a duplicate pair attends once here against once per copy
    on the COO path, and a pair that cancels to 0 not at all.
    """
    if graph.colpanel is None:
        raise ValueError("graph has no colpanel layout; build with build_colpanel=True")
    ne = graph.n_edges

    def host(t, given):
        return np.asarray(t[:ne].cpu().numpy() if given is None else given)[:ne]

    w = host(graph.weights, weights)
    if w.size and not np.all(w != 0):
        raise ValueError(
            "colpanel attention requires all real edge weights to be nonzero (slot "
            f"validity is inferred from vals != 0); found {int((w == 0).sum())} "
            "zero-weight edges — use the ELL path for graphs with explicit zero edges")
    m = sp.coo_matrix((w, (host(graph.receivers, receivers), host(graph.senders, senders))),
                      shape=(graph.n_nodes, graph.n_nodes)).tocsc()
    if m.nnz != ne or (m.nnz and not np.all(m.data != 0)):
        raise ValueError(
            f"colpanel attention requires duplicate-free edges: {ne} COO edges coalesce "
            f"to {m.nnz} stored entries ({int((m.data == 0).sum())} summing to zero) — "
            "duplicates attend once (or never, if cancelled) on this layout vs once per "
            "copy on the COO path; deduplicate the edge list first")


def _layout(graph) -> ColPanelELL:
    pe = graph if isinstance(graph, ColPanelELL) else graph.colpanel
    if pe is None:
        raise ValueError("graph has no colpanel layout; build with build_colpanel=True")
    return pe


def _chunks(pe: ColPanelELL, hf: int):
    """Every live bucket as ``(start, width, rows, merge, [(cols, valid,
    rows)] per row chunk)``."""
    for s, w, cols, vals, rows, merge in buckets(pe):
        nb, k = cols.shape
        yield s, w, rows, merge, [(cols[sl], vals[sl] != 0, rows[sl])
                                  for sl in row_chunks(nb, k * hf, ATTN_CHUNK_BUDGET_ELEMS)]


def _shift(m: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The receivers' softmax shifts ``[nb, 1, H]``: their max, 0 where a
    receiver has no edge (``m = -inf``)."""
    sh = m.index_select(0, rows)
    return torch.where(torch.isfinite(sh), sh, 0.0)[:, None, :]


def _cat(parts):
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _two_sweeps(pe, n, h, f, like, logits, gather, attn_dropout):
    """``(num [N, H·F], den [N, H], m [N, H])`` over the layout.
    ``logits(s, w, cols, valid, rows)`` gives a chunk's ``e [nb, k, H]``
    (``-inf`` on empty slots), ``gather(s, w, cols)`` its messages
    ``[nb, k, H, F]``."""
    hf = h * f
    m = like.new_full((n, h), -torch.inf)
    with torch.no_grad():
        for s, w, _, _, chunks in _chunks(pe, hf):
            for cols, valid, rows in chunks:
                bmax = logits(s, w, cols, valid, rows).amax(dim=1)  # [nb, H]
                m.scatter_reduce_(0, rows.long()[:, None].expand_as(bmax), bmax, "amax")
    num = like.new_zeros((n, hf))
    den = like.new_zeros((n, h))
    for s, w, rows_b, merge, chunks in _chunks(pe, hf):
        num_parts, den_parts = [], []
        for cols, valid, rows in chunks:
            ex = torch.exp(logits(s, w, cols, valid, rows) - _shift(m, rows))  # [nb, k, H]
            den_parts.append(ex.sum(dim=1))
            kept = _kept(attn_dropout, ex)
            wt = ex if kept is None else ex * kept
            num_parts.append((gather(s, w, cols) * wt[..., None]).sum(dim=1).reshape(-1, hf))
        merge_add(num, rows_b, merge, _cat(num_parts))
        merge_add(den, rows_b, merge, _cat(den_parts))
    return num, den, m


def _finish(num, den, n, h, f):
    return num.view(n, h, f) / torch.clamp(den, min=1e-16)[..., None]


def _leaky_grad(pre: torch.Tensor, slope: float) -> torch.Tensor:
    # >= 0: the derivative at 0 is 1, as jax.nn.leaky_relu's
    return torch.where(pre >= 0, 1.0, slope)


# ---------------------------------------------------------------------- #
# GAT v1: e = leaky(a_src·s_u + a_dst·s_v)
# ---------------------------------------------------------------------- #


def gat_conv_colpanel(graph, s: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor,
                      negative_slope: float = 0.2, attn_dropout=None) -> torch.Tensor:
    """GAT convolution over ``graph.colpanel`` (or a bare
    :class:`~pygcn_tpu_torch.ops.colpanel.ColPanelELL`): ``s [N, H, F]``
    per-head features, ``a_src``/``a_dst [H, F]``; ``[N, H, F]`` out."""
    pe = _layout(graph)
    if attn_dropout is None:
        return _GATColPanel.apply(s, a_src, a_dst, pe, float(negative_slope))
    n, h, f = s.shape
    num, den, _ = _v1_sweeps(pe, s, a_src, a_dst, negative_slope, attn_dropout)
    return _finish(num, den, n, h, f)


def _v1_tables(s, a_src, a_dst):
    """``s2 [N, H·F]`` and the per-node source and receiver logits ``[N, H]``."""
    n, h, f = s.shape
    return (s.reshape(n, h * f), torch.einsum("nhf,hf->nh", s, a_src),
            torch.einsum("nhf,hf->nh", s, a_dst))


def _v1_pre(lsrc, ldst, s, w, cols, rows):
    """A chunk's pre-activation logits ``[nb, k, H]``."""
    nb, k = cols.shape
    return (lsrc[s:s + w].index_select(0, cols.reshape(-1)).view(nb, k, -1)
            + ldst.index_select(0, rows)[:, None, :])


def _v1_sweeps(pe, s, a_src, a_dst, slope, attn_dropout):
    n, h, f = s.shape
    s2, lsrc, ldst = _v1_tables(s, a_src, a_dst)

    def logits(s0, w, cols, valid, rows):
        pre = _v1_pre(lsrc, ldst, s0, w, cols, rows)
        return torch.where(valid[..., None], _leaky(pre, slope), -torch.inf)

    def gather(s0, w, cols):
        nb, k = cols.shape
        return s2[s0:s0 + w].index_select(0, cols.reshape(-1)).view(nb, k, h, f)

    return _two_sweeps(pe, n, h, f, s, logits, gather, attn_dropout)


class _GATColPanel(torch.autograd.Function):
    """The two sweeps forward; the third, hand-written, backward."""

    @staticmethod
    def forward(ctx, s, a_src, a_dst, pe, slope):
        n, h, f = s.shape
        num, den, m = _v1_sweeps(pe, s, a_src, a_dst, slope, None)
        out = _finish(num, den, n, h, f)
        ctx.save_for_backward(s, a_src, a_dst, m, den, out)
        ctx.pe, ctx.slope = pe, slope
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        s, a_src, a_dst, m, den, out = ctx.saved_tensors
        ds, da_src, da_dst = _v1_backward(ctx.pe, s, a_src, a_dst, m, den, out,
                                          dout.contiguous(), ctx.slope)
        return ds, da_src, da_dst, None, None


def _v1_backward(pe, s, a_src, a_dst, m, den, out, dout, slope):
    """The softmax-attention gradient identities per bucket (those of JAX's
    ``_gat_v1_bwd``), with ``p = dout / den`` and ``q = Σ_f dout·out / den``::

        s1 = Σ_f s_u·p_v       de = ex·(s1 − q_v)      dpre = de·leaky'(pre)
        ds[u]    += ex·p_v                              (the message path)
        dlsrc[u] += dpre        dldst[v] += Σ_k dpre    (the logit paths)
        ds += dlsrc·a_src + dldst·a_dst;  da_src = Σ_u dlsrc·s_u;  da_dst = Σ_v dldst·s_v
    """
    n, h, f = s.shape
    s2, lsrc, ldst = _v1_tables(s, a_src, a_dst)
    deng = torch.clamp(den, min=1e-16)
    p = dout / deng[..., None]  # [N, H, F]
    q = (dout * out).sum(dim=-1) / deng  # [N, H]
    ds = torch.zeros_like(s)
    dlsrc = torch.zeros_like(m)
    dldst = torch.zeros_like(m)
    for s0, w, rows_b, merge, chunks in _chunks(pe, h * f):
        dld_parts = []
        for cols, valid, rows in chunks:
            nb, k = cols.shape
            flat = cols.reshape(-1)
            pre = _v1_pre(lsrc, ldst, s0, w, cols, rows)
            e = torch.where(valid[..., None], _leaky(pre, slope), -torch.inf)
            ex = torch.exp(e - _shift(m, rows))  # [nb, k, H]; 0 on empty slots
            g = s2[s0:s0 + w].index_select(0, flat).view(nb, k, h, f)
            pr = p.index_select(0, rows)[:, None]  # [nb, 1, H, F]
            de = ex * ((g * pr).sum(dim=-1) - q.index_select(0, rows)[:, None, :])
            dpre = torch.where(valid[..., None], de * _leaky_grad(pre, slope), 0.0)
            ds[s0:s0 + w].index_add_(0, flat, (ex[..., None] * pr).view(-1, h, f))
            dlsrc[s0:s0 + w].index_add_(0, flat, dpre.view(-1, h))
            dld_parts.append(dpre.sum(dim=1))
        merge_add(dldst, rows_b, merge, _cat(dld_parts))
    ds += dlsrc[..., None] * a_src + dldst[..., None] * a_dst
    return (ds, torch.einsum("nh,nhf->hf", dlsrc, s), torch.einsum("nh,nhf->hf", dldst, s))


# ---------------------------------------------------------------------- #
# GATv2: e = a · leaky(s_l[u] + s_r[v])
# ---------------------------------------------------------------------- #


def gatv2_conv_colpanel(graph, s_l: torch.Tensor, s_r: torch.Tensor, a: torch.Tensor,
                        negative_slope: float = 0.2, attn_dropout=None) -> torch.Tensor:
    """GATv2 convolution over ``graph.colpanel``: source and receiver
    transforms ``s_l``/``s_r [N, H, F]``, ``a [H, F]``; aggregates ``s_l``.
    The logit needs the gathered source rows, so both sweeps gather them."""
    pe = _layout(graph)
    if attn_dropout is None:
        return _GATv2ColPanel.apply(s_l, s_r, a, pe, float(negative_slope))
    n, h, f = s_l.shape
    num, den, _ = _v2_sweeps(pe, s_l, s_r, a, negative_slope, attn_dropout)
    return _finish(num, den, n, h, f)


def _v2_gather(sl2, s0, w, cols, h, f):
    nb, k = cols.shape
    return sl2[s0:s0 + w].index_select(0, cols.reshape(-1)).view(nb, k, h, f)


def _v2_sweeps(pe, s_l, s_r, a, slope, attn_dropout):
    n, h, f = s_l.shape
    sl2 = s_l.reshape(n, h * f)

    def logits(s0, w, cols, valid, rows):
        pre = _v2_gather(sl2, s0, w, cols, h, f) + s_r.index_select(0, rows)[:, None]
        e = (_leaky(pre, slope) * a).sum(dim=-1)  # per slot, whatever the chunk
        return torch.where(valid[..., None], e, -torch.inf)

    def gather(s0, w, cols):
        return _v2_gather(sl2, s0, w, cols, h, f)

    return _two_sweeps(pe, n, h, f, s_l, logits, gather, attn_dropout)


class _GATv2ColPanel(torch.autograd.Function):
    """The two sweeps forward; the third, hand-written, backward."""

    @staticmethod
    def forward(ctx, s_l, s_r, a, pe, slope):
        n, h, f = s_l.shape
        num, den, m = _v2_sweeps(pe, s_l, s_r, a, slope, None)
        out = _finish(num, den, n, h, f)
        ctx.save_for_backward(s_l, s_r, a, m, den, out)
        ctx.pe, ctx.slope = pe, slope
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        s_l, s_r, a, m, den, out = ctx.saved_tensors
        dsl, dsr, da = _v2_backward(ctx.pe, s_l, s_r, a, m, den, out, dout.contiguous(),
                                    ctx.slope)
        return dsl, dsr, da, None, None


def _v2_backward(pe, s_l, s_r, a, m, den, out, dout, slope):
    """JAX's ``_gatv2_bwd`` per bucket, with ``p`` and ``q`` as in v1::

        de = ex·(Σ_f s_l[u]·p_v − q_v)          dpre = de·a·leaky'(pre)
        ds_l[u] += ex·p_v + dpre    ds_r[v] += Σ_k dpre    da += Σ de·leaky(pre)
    """
    n, h, f = s_l.shape
    sl2 = s_l.reshape(n, h * f)
    deng = torch.clamp(den, min=1e-16)
    p = dout / deng[..., None]
    q = (dout * out).sum(dim=-1) / deng
    dsl = torch.zeros_like(s_l)
    dsr = torch.zeros_like(s_r)
    da = torch.zeros_like(a)
    for s0, w, rows_b, merge, chunks in _chunks(pe, h * f):
        dsr_parts = []
        for cols, valid, rows in chunks:
            g = _v2_gather(sl2, s0, w, cols, h, f)  # [nb, k, H, F]
            pre = g + s_r.index_select(0, rows)[:, None]
            lk = _leaky(pre, slope)
            e = torch.where(valid[..., None], (lk * a).sum(dim=-1), -torch.inf)
            ex = torch.exp(e - _shift(m, rows))  # [nb, k, H]; 0 on empty slots
            pr = p.index_select(0, rows)[:, None]  # [nb, 1, H, F]
            de = ex * ((g * pr).sum(dim=-1) - q.index_select(0, rows)[:, None, :])
            dpre = torch.where(valid[..., None, None],
                               de[..., None] * a * _leaky_grad(pre, slope), 0.0)
            da += (de[..., None] * lk).sum(dim=(0, 1))
            dsl[s0:s0 + w].index_add_(0, cols.reshape(-1),
                                      (ex[..., None] * pr + dpre).view(-1, h, f))
            dsr_parts.append(dpre.sum(dim=1))
        merge_add(dsr, rows_b, merge, _cat(dsr_parts))
    return dsl, dsr, da
