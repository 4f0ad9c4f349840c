"""Kernels B3, B5, B6 (GAT) and B7, B8, B9 (GATv2): attention over the hybrid
layout's dense tiles.

Replaces the TPU kernels of ``pygcn_tpu/ops/pallas/gat_tile_attn.py`` on the
default (``TILE_REVISIT = True``) path of its ``gat_tile_partials``:

- **B3** ``_fwd_kernel_revisit``: per receiver ``v`` and head ``h``, the
  online softmax over the tile edges ``u -> v`` of
  ``e = leaky(ldst[v] + lsrc[u])``, emitted as partials ``num [N, H·F]``,
  ``den [N, H]`` and ``m [N, H]`` (the max over tile edges, ``NEG`` where a
  receiver has none);
- **B5** ``_bwd_dldst_kernel`` (``stream=False``): the receiver gradient
  ``dldst``, over the forward tiles;
- **B6** ``_bwd_sender_kernel`` (``stream=False``): the sender gradients
  ``ds`` and ``dlsrc``, over the exact transpose tiles (:func:`transpose_bcsr`);

their per-tile ("stream") modes, on its ``TILE_REVISIT = False`` path, where
every tile is computed on its own and the tiles are merged by block row (JAX:
``segment_max``/``segment_sum`` after the kernel):

- **B4** ``_fwd_kernel_stream``, its merge fused: the merged ``(num, den,
  m)``, each tile's rows added into zero-filled outputs and its row maxima
  merged by an atomic max (the plain version: per-tile partials merged by
  :func:`softmax_merge`);
- **B5s** (``_bwd_dldst_kernel``, ``stream=True``), its merge fused: the
  merged ``dldst``, each tile's rows added into a zero-filled output (the
  plain version: per-tile blocks summed by :func:`sum_by_block_row`);
- **B6s** (``_bwd_sender_kernel``, ``stream=True``), its merge fused: the
  merged ``(ds, dlsrc)``, each tile's rows added into zero-filled outputs;

and of its ``gatv2_tile_partials``, where the logit of a tile edge ``u -> v``
is ``e = Σ_f a[h,f]·leaky(sl[u,hF+f] + sr[v,hF+f])``:

- **B7** ``_v2_fwd_kernel``: the partials ``num [N, H·F]`` (of ``sl``),
  ``den [N, H]`` and ``m [N, H]``, as B3's;
- **B8** ``_v2_bwd_recv_kernel``: ``dsr [N, H·F]`` and the per-receiver
  partial ``dapart [N, H·F]`` of ``da``, over the forward tiles;
- **B9** ``_v2_bwd_send_kernel``: ``dsl [N, H·F]``, over the transpose tiles.

The CUDA sources, ``pygcn_tpu_torch/csrc/gat_tile_attn.cu`` (B3-B6,
B4/B5s/B6s) and ``gatv2_tile_attn.cu`` (B7/B8/B9), carry the design notes.
B3, B5, B6, B7, B8 and B9 run B1's balanced schedule (:func:`spmm_schedule`
at :data:`MAX_TILES`, cached per tile set in ``bcsr.cache`` with arrival
counters of its own; B3, B5, B7 and B8 share the forward tiles' entry, B6
and B9 the transpose tiles'): one CTA per work item of at most C tiles of a
block row, for all heads; each tile's mask decoded once; each thread walking
only its own row's edges; the items of a split row writing partials that
the last to arrive merges in item order, so the result is the same bits
every run: B3's and B7's ``(m, den, num)`` by the flash merge
(:func:`scheduled_merge` in plain PyTorch), the backward kernels' gradients
by a plain sum (:func:`scheduled_sum`). B4, B5s and B6s take one CTA per
tile for all heads, each thread walking its own row's edges, and add into
their outputs with f32 reductions, so their sums come in no fixed order. At
the ogbn-arxiv hybrid's shapes all are bound by bytes (the tiles as stored,
about 0.19 GB a launch). Every kernel takes any per-head width F, with
shared memory that fits the card whatever F: B3-B6 in slabs of 64 columns;
B7 with whole rows staged up to F = 208, B8 and B9 with own rows in
registers up to F = 40, and above those the F-chunked kernels (32 columns
at a time). B3-B6, B4 and B5s-B6s take any number of heads: they stage
their node arrays for as many heads as the card's shared memory holds,
restaging between groups.

Tile shapes: square tiles whose side is a multiple of :data:`SIDE_MULTIPLE`
(every side JAX's kernels take on a TPU, where the ``(H, tk)`` logit block
needs 128 lanes, and the 32 and 64 of the CPU tests), with 128 as the
kernels' fast case. A CTA works on a panel of at most :data:`PANEL` x
:data:`PANEL` of a tile; a wider side reaches the kernels as its panels
(:func:`tile_panels`), so the side has no upper bound. Other shapes raise
(:func:`check_tile_side`).

Tile values only gate the mask (``tile != 0``); they are never multiplied in.
Each kernel has a plain PyTorch version here (``*_plain``), the CPU path and
the card's yardstick. The wrappers pick by the device of the operands: CPU
tensors run the plain version, CUDA tensors run the kernel or raise, any other
device raises. ``launches`` counts each kernel's launches. GATv2 has no
stream mode, in JAX or here: :data:`TILE_REVISIT` does not change B7/B8/B9.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from pygcn_tpu_torch.graph.graph import BCSR
from pygcn_tpu_torch.ops.cuda.bcsr_spmm import SpMMSchedule, spmm_schedule, sum_by_block_row

NEG = -1e30  # finite stand-in for -inf: max/exp algebra without NaNs

# The kernels take square tiles whose side is a multiple of SIDE_MULTIPLE; a
# CTA covers a panel of at most PANEL x PANEL of one. With the ints of one
# work item, checked against the libraries.
SIDE_MULTIPLE = 32
PANEL = 128
ITEM_INTS = 6

# The most tiles one work item of the item-scheduled kernels (B3, B5-B9)
# takes (C): B1's schedule, cached per tile set apart from B1's.
# ``chip_smoke.py`` times each at C = 1, 2 and 4 (PERF.md).
MAX_TILES = 2

# Own edges that a thread of the F-chunked GATv2 kernels (B7 above the staged
# kernel's reach, B8 and B9 above F = 40) carries through one batch (EB in
# gatv2_tile_attn.cu): a row with more in one work item takes more batches.
CHUNK_EDGES = 32

# The JAX package's A/B flag (``pygcn_tpu/ops/pallas/gat_tile_attn.py:115``),
# with its default. :class:`GATTilePartials` reads it once in its forward
# and runs its backward in the same mode: False runs B4, then B5s and B6s, in
# place of B3, B5 and B6.
TILE_REVISIT = True

# Kernel launches since import (or since a caller reset them to 0).
launches = {"B3": 0, "B4": 0, "B5": 0, "B5s": 0, "B6": 0, "B6s": 0, "B7": 0, "B8": 0,
            "B9": 0}

_libs = {}


def transpose_bcsr(bcsr: BCSR) -> BCSR:
    """Host-side exact transpose of a tile set: the same edges with
    coordinates swapped, tiles re-sorted by block row, and one all-zero tile at
    block column 0 for each block row left empty.

    Built in NumPy from the tiles' CPU copy, with the JAX package's ``lexsort``
    order, so the arrays equal ``pygcn_tpu``'s ``transpose_bcsr`` array for
    array. The sender-indexed backward (B6) must see exactly the forward tile
    edges; a transpose layout built by re-running tile selection on ``A^T``
    could route a borderline tile differently.
    """
    data_t = bcsr.data.cpu()
    bf16 = data_t.dtype == torch.bfloat16
    data = (data_t.view(torch.int16) if bf16 else data_t).numpy()
    br = bcsr.block_rows.cpu().numpy()
    bc = bcsr.block_cols.cpu().numpy()
    order = np.lexsort((br, bc))
    nbr = bc[order].astype(np.int32)
    nbc = br[order].astype(np.int32)
    nd = data[order].transpose(0, 2, 1)
    n_block_rows, n_block_cols = bcsr.n_block_cols, bcsr.n_block_rows
    empty = np.setdiff1d(np.arange(n_block_rows, dtype=np.int64), nbr)
    if empty.size:
        nd = np.concatenate([nd, np.zeros((empty.size, bcsr.tk, bcsr.tm), nd.dtype)])
        nbr = np.concatenate([nbr, empty.astype(np.int32)])
        nbc = np.concatenate([nbc, np.zeros(empty.size, np.int32)])
        o2 = np.lexsort((nbc, nbr))
        nd, nbr, nbc = nd[o2], nbr[o2], nbc[o2]
    ptr = np.zeros(n_block_rows + 1, np.int64)
    np.add.at(ptr, nbr + 1, 1)
    ptr = np.cumsum(ptr).astype(np.int32)
    out = torch.from_numpy(np.ascontiguousarray(nd))
    return BCSR(
        data=out.view(torch.bfloat16) if bf16 else out,
        block_rows=torch.from_numpy(nbr), block_cols=torch.from_numpy(nbc),
        block_row_ptr=torch.from_numpy(ptr), tm=bcsr.tk, tk=bcsr.tm,
        n_block_rows=n_block_rows, n_block_cols=n_block_cols,
    )


def _leaky(x: torch.Tensor, slope: float) -> torch.Tensor:
    # where(x >= 0): the derivative at 0 is 1, as jax.nn.leaky_relu's
    return torch.where(x >= 0, x, slope * x)


# --------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------- #


def _slabs(a: torch.Tensor, blocks: torch.Tensor, n_blocks: int, size: int) -> torch.Tensor:
    """``[T, size, W]``: rows ``blocks[t]·size ..`` of ``a [N, W]``, zero past N."""
    ap = torch.nn.functional.pad(a, (0, 0, 0, n_blocks * size - a.shape[0]))
    return ap.view(n_blocks, size, a.shape[1]).index_select(0, blocks.long())


def tile_fwd_plain(bcsr: BCSR, lsrc, ldst, s2, h: int, f: int, slope: float):
    """B3's function with tensor ops: ``(num [N, H·F], den [N, H], m [N, H])``,
    B4's per-tile partials merged by :func:`softmax_merge`: the same ``m``,
    and the same ``num``/``den`` relative to it up to rounding, as the
    kernel's online order."""
    parts = tile_fwd_stream_plain(bcsr, lsrc, ldst, s2, h, f, slope)
    return softmax_merge(bcsr, *parts, s2.shape[0])


def tile_fwd_stream_plain(bcsr: BCSR, lsrc, ldst, s2, h: int, f: int, slope: float):
    """B4's per-tile partials, as the JAX kernel emits them before its merge:
    per tile ``(num_t [T, tm, H·F], den_t [T, tm, H], max_t [T, tm, H])``
    (:func:`_tile_partials`)."""
    tm, tk = bcsr.tm, bcsr.tk
    ls = _slabs(lsrc, bcsr.block_cols, bcsr.n_block_cols, tk)  # [T, tk, H]
    ld = _slabs(ldst, bcsr.block_rows, bcsr.n_block_rows, tm)  # [T, tm, H]
    sv = _slabs(s2, bcsr.block_cols, bcsr.n_block_cols, tk)  # [T, tk, H·F]
    logits = (_leaky(ld[:, :, hh, None] + ls[:, None, :, hh], slope) for hh in range(h))
    return _tile_partials(bcsr, logits, sv, f)


def _tile_partials(bcsr: BCSR, logits, sv, f: int):
    """Per tile ``(num_t [T, tm, H·F], den_t [T, tm, H], max_t [T, tm, H])``
    from each head's tile logits ``[T, tm, tk]`` (an iterable over heads) and
    the senders' features ``sv [T, tk, H·F]``: each row's max over the tile's
    own edges (``NEG`` where the row has none there, with ``num_t = den_t = 0``),
    then one exponentiation against it. Loops over heads, so no
    ``[T, H, tm, tk]`` temporary is built."""
    mask = bcsr.data != 0  # [T, tm, tk]
    nums, dens, maxs = [], [], []
    for hh, e in enumerate(logits):
        neg = torch.where(mask, e, NEG)
        tmax = neg.amax(dim=2, keepdim=True)  # [T, tm, 1]
        ex = torch.where(mask, torch.exp(neg - tmax), 0.0)
        dens.append(ex.sum(dim=2, keepdim=True))
        nums.append(torch.bmm(ex, sv[:, :, hh * f:(hh + 1) * f]))
        maxs.append(tmax)
    return torch.cat(nums, 2), torch.cat(dens, 2), torch.cat(maxs, 2)


def softmax_merge(bcsr: BCSR, num_t, den_t, max_t, n: int):
    """Merge per-tile partials (:func:`tile_fwd_stream_plain`'s) into
    ``(num [n, H·F], den [n, H], m [n, H])``,
    as the JAX package's stream path does (``gat_tile_attn.py:246-257``):
    ``m`` is the max of ``max_t`` over each block row's tiles, every tile is
    rescaled by ``exp(max_t − m)`` (``m`` taken as 0 where it is ``NEG``), and
    the rescaled blocks are summed by block row. Plain PyTorch, on the CPU and
    the card alike.

    The max starts from ``NEG`` (``scatter_reduce`` ``amax`` with
    ``include_self``): a receiver with no tile edge has ``m = NEG`` and
    ``num = den = 0``, as in the revisit mode. JAX's ``segment_max`` gives
    ``-inf`` for a block row that owns no tile at all; the tiles JAX builds
    give every empty block row a zero tile, so the two agree there, and on
    tile sets without it (``drop_zero_tiles``) the port keeps ``NEG``.
    """
    t, tm, h = max_t.shape
    br = bcsr.block_rows.long()
    m = max_t.new_full((bcsr.n_block_rows, tm, h), NEG)
    m = m.scatter_reduce(0, br[:, None, None].expand(t, tm, h), max_t, "amax",
                         include_self=True)
    shift = torch.where(m > -1e29, m, 0.0)
    scale = torch.exp(max_t - shift[br])  # [T, tm, H]
    den = sum_by_block_row(den_t * scale, bcsr, n)
    num = sum_by_block_row((num_t.view(t, tm, h, -1) * scale[..., None]).view(t, tm, -1),
                           bcsr, n)
    return num, den, m.view(-1, h)[:n]


def scheduled_merge(bcsr: BCSR, num_t, den_t, max_t, n: int, max_tiles: int):
    """B3's and B7's split-and-merge in plain PyTorch: per-tile partials
    (B4's, or their v2 counterpart) merged into ``(num [n, H·F], den [n, H],
    m [n, H])`` along the work items of :func:`spmm_schedule` at
    ``max_tiles``, as the kernels merge them.

    Each item's partial ``(m_i, den_i, num_i)`` is its tiles' partials
    rescaled onto the item's max; a block row's result is the flash merge of
    its items in item order: ``m = max_i m_i`` and each part scaled by
    ``exp(m_i − m)``, the parts added one item after another. A part whose
    ``m_i`` is still ``NEG`` (no edge) adds nothing; ``exp(NEG − NEG) = 1``
    never leaks in. ``m`` is exactly the max over the row's tile edges.
    """
    t, tm, h = max_t.shape
    hf = num_t.shape[2]
    dev = max_t.device
    items = spmm_schedule(bcsr, max_tiles).items.long().to(dev)
    n_items = items.shape[0]
    of_tile = torch.repeat_interleave(torch.arange(n_items, device=dev), items[:, 1] - items[:, 0])

    def flash(m_parts, den_parts, num_parts, seg, n_seg, order=None):
        """Merge parts into segments: the max, then the rescaled sums (in
        ``order``'s steps when given: one part per segment a step)."""
        m = m_parts.new_full((n_seg, tm, h), NEG).scatter_reduce(
            0, seg[:, None, None].expand_as(m_parts), m_parts, "amax", include_self=True)
        scale = torch.where(m_parts == NEG, 0.0, torch.exp(m_parts - m[seg]))
        den = den_parts.new_zeros((n_seg, tm, h))
        num = num_parts.new_zeros((n_seg, tm, hf))
        d = den_parts * scale
        nm = (num_parts.view(-1, tm, h, hf // h) * scale[..., None]).view(-1, tm, hf)
        if order is None:
            den.index_add_(0, seg, d)
            num.index_add_(0, seg, nm)
        else:
            for step in range(int(order.max()) + 1 if order.numel() else 0):
                sel = order == step
                den[seg[sel]] += d[sel]
                num[seg[sel]] += nm[sel]
        return m, den, num

    m_i, den_i, num_i = flash(max_t, den_t, num_t, of_tile, n_items)
    row = items[:, 2].contiguous()
    part = torch.arange(n_items, device=dev) - torch.searchsorted(row, row)  # place in its row
    m, den, num = flash(m_i, den_i, num_i, row, bcsr.n_block_rows, order=part)
    return num.view(-1, hf)[:n], den.view(-1, h)[:n], m.view(-1, h)[:n]


def tile_fwd_scheduled_plain(bcsr: BCSR, lsrc, ldst, s2, h: int, f: int, slope: float,
                             max_tiles: int):
    """B3's function as B3 computes it: :func:`scheduled_merge` of the
    per-tile partials at ``max_tiles``."""
    parts = tile_fwd_stream_plain(bcsr, lsrc, ldst, s2, h, f, slope)
    return scheduled_merge(bcsr, *parts, s2.shape[0], max_tiles)


def tile_bwd_dldst_stream_plain(bcsr: BCSR, lsrc, ldst, s2, m, dnum, dden, h: int, f: int,
                                slope: float):
    """B5's and B5s's per-tile blocks, as the JAX kernel emits them before
    its merge: per tile ``dldst_t [T, tm, H]`` over the forward tiles, with
    ``p = mask·exp(e − m_v)`` (``m`` the merged max the forward returned)."""
    tm, tk = bcsr.tm, bcsr.tk
    mask = bcsr.data != 0
    ls = _slabs(lsrc, bcsr.block_cols, bcsr.n_block_cols, tk)
    sv = _slabs(s2, bcsr.block_cols, bcsr.n_block_cols, tk)
    ld = _slabs(ldst, bcsr.block_rows, bcsr.n_block_rows, tm)
    mv = _slabs(m, bcsr.block_rows, bcsr.n_block_rows, tm)
    dnv = _slabs(dnum, bcsr.block_rows, bcsr.n_block_rows, tm)
    ddv = _slabs(dden, bcsr.block_rows, bcsr.n_block_rows, tm)
    out = []
    for hh in range(h):
        fs = slice(hh * f, (hh + 1) * f)
        pre = ld[:, :, hh, None] + ls[:, None, :, hh]  # [T, tm(v), tk(u)]
        p = torch.where(mask, torch.exp(_leaky(pre, slope) - mv[:, :, hh, None]), 0.0)
        gdot = torch.bmm(dnv[:, :, fs], sv[:, :, fs].transpose(1, 2))
        de = p * (gdot + ddv[:, :, hh, None]) * torch.where(pre >= 0, 1.0, slope)
        out.append(de.sum(dim=2, keepdim=True))
    return torch.cat(out, 2)


def tile_bwd_dldst_plain(bcsr: BCSR, lsrc, ldst, s2, m, dnum, dden, h: int, f: int,
                         slope: float):
    """B5's and B5s's function: ``dldst [N, H]`` over the forward tiles, with
    ``p = mask·exp(e − m_v)`` (``m`` as B3 or B4 returned it): the per-tile
    blocks merged."""
    parts = tile_bwd_dldst_stream_plain(bcsr, lsrc, ldst, s2, m, dnum, dden, h, f, slope)
    return sum_by_block_row(parts, bcsr, s2.shape[0])


def tile_bwd_sender_stream_plain(bcsr_t: BCSR, lsrc, ldst, s2, m, dnum, dden, h: int, f: int,
                                 slope: float):
    """B6s's per-tile blocks, as the JAX kernel emits them before its merge:
    per transpose tile ``(ds_t [Tt, tm, H·F], dlsrc_t [Tt, tm, H])``; the
    tiles' rows are senders ``u`` and their columns receivers ``v``."""
    tm, tk = bcsr_t.tm, bcsr_t.tk
    mask = bcsr_t.data != 0
    lu = _slabs(lsrc, bcsr_t.block_rows, bcsr_t.n_block_rows, tm)
    su = _slabs(s2, bcsr_t.block_rows, bcsr_t.n_block_rows, tm)
    ldv = _slabs(ldst, bcsr_t.block_cols, bcsr_t.n_block_cols, tk)
    mv = _slabs(m, bcsr_t.block_cols, bcsr_t.n_block_cols, tk)
    dnv = _slabs(dnum, bcsr_t.block_cols, bcsr_t.n_block_cols, tk)
    ddv = _slabs(dden, bcsr_t.block_cols, bcsr_t.n_block_cols, tk)
    ds, dl = [], []
    for hh in range(h):
        fs = slice(hh * f, (hh + 1) * f)
        pre = lu[:, :, hh, None] + ldv[:, None, :, hh]  # [T, tm(u), tk(v)]
        p = torch.where(mask, torch.exp(_leaky(pre, slope) - mv[:, None, :, hh]), 0.0)
        ds.append(torch.bmm(p, dnv[:, :, fs]))
        gdot = torch.bmm(su[:, :, fs], dnv[:, :, fs].transpose(1, 2))
        de = p * (gdot + ddv[:, None, :, hh]) * torch.where(pre >= 0, 1.0, slope)
        dl.append(de.sum(dim=2, keepdim=True))
    return torch.cat(ds, 2), torch.cat(dl, 2)


def tile_bwd_sender_plain(bcsr_t: BCSR, lsrc, ldst, s2, m, dnum, dden, h: int, f: int,
                          slope: float):
    """B6's function: ``(ds [N, H·F], dlsrc [N, H])`` over the transpose
    tiles: B6s's blocks merged."""
    n = s2.shape[0]
    ds_t, dl_t = tile_bwd_sender_stream_plain(bcsr_t, lsrc, ldst, s2, m, dnum, dden, h, f, slope)
    return sum_by_block_row(ds_t, bcsr_t, n), sum_by_block_row(dl_t, bcsr_t, n)


def tile_bwd_dldst_scheduled_plain(bcsr: BCSR, lsrc, ldst, s2, m, dnum, dden, h: int, f: int,
                                   slope: float, max_tiles: int):
    """B5's function as B5 computes it: :func:`scheduled_sum` of the per-tile
    partials at ``max_tiles``."""
    parts = tile_bwd_dldst_stream_plain(bcsr, lsrc, ldst, s2, m, dnum, dden, h, f, slope)
    return scheduled_sum(bcsr, parts, s2.shape[0], max_tiles)


def tile_bwd_sender_scheduled_plain(bcsr_t: BCSR, lsrc, ldst, s2, m, dnum, dden, h: int,
                                    f: int, slope: float, max_tiles: int):
    """B6's function as B6 computes it: :func:`scheduled_sum` of the per-tile
    partials ``(ds_t, dlsrc_t)`` at ``max_tiles``."""
    n = s2.shape[0]
    parts = tile_bwd_sender_stream_plain(bcsr_t, lsrc, ldst, s2, m, dnum, dden, h, f, slope)
    return tuple(scheduled_sum(bcsr_t, x, n, max_tiles) for x in parts)


def _v2_logit(a, rows, cols, hh: int, f: int, slope: float) -> torch.Tensor:
    """``[T, tm, tk]`` v2 logit of head ``hh`` between the row side's
    ``rows [T, tm, H·F]`` and the column side's ``cols [T, tk, H·F]``: the
    terms ``a[hh, ff]·leaky(pre)`` added in the order ``ff = 0 .. F-1``, as
    ``pygcn_tpu``'s ``_v2_logit``. One ``[T, tm, tk]`` temporary per term, never
    a ``[T, tm, tk, F]`` one."""
    e = None
    for ff in range(f):
        idx = hh * f + ff
        term = a[hh, ff] * _leaky(rows[:, :, idx, None] + cols[:, None, :, idx], slope)
        e = term if e is None else e + term
    return e


def tile_v2_fwd_stream_plain(bcsr: BCSR, sl2, sr2, a, h: int, f: int, slope: float):
    """B7's per-tile partials ``(num_t [T, tm, H·F], den_t, max_t [T, tm, H])``,
    ``num_t`` aggregating ``sl2`` (:func:`_tile_partials`)."""
    slv = _slabs(sl2, bcsr.block_cols, bcsr.n_block_cols, bcsr.tk)  # [T, tk(u), H·F]
    srv = _slabs(sr2, bcsr.block_rows, bcsr.n_block_rows, bcsr.tm)  # [T, tm(v), H·F]
    logits = (_v2_logit(a, srv, slv, hh, f, slope) for hh in range(h))
    return _tile_partials(bcsr, logits, slv, f)


def tile_v2_fwd_plain(bcsr: BCSR, sl2, sr2, a, h: int, f: int, slope: float):
    """B7's function with tensor ops: ``(num [N, H·F], den [N, H], m [N, H])``,
    ``num`` aggregating ``sl2``; per-tile partials and their merge as in
    :func:`tile_fwd_plain`."""
    parts = tile_v2_fwd_stream_plain(bcsr, sl2, sr2, a, h, f, slope)
    return softmax_merge(bcsr, *parts, sl2.shape[0])


def tile_v2_fwd_scheduled_plain(bcsr: BCSR, sl2, sr2, a, h: int, f: int, slope: float,
                                max_tiles: int):
    """B7's function as B7 computes it: :func:`scheduled_merge` of the
    per-tile partials at ``max_tiles``."""
    parts = tile_v2_fwd_stream_plain(bcsr, sl2, sr2, a, h, f, slope)
    return scheduled_merge(bcsr, *parts, sl2.shape[0], max_tiles)


def tile_v2_bwd_recv_stream_plain(bcsr: BCSR, sl2, sr2, a, m, dnum, dden, h: int, f: int,
                                  slope: float):
    """B8's per-tile partials ``(dsr_t [T, tm, H·F], dapart_t [T, tm, H·F])``
    over the forward tiles, with ``p = mask·exp(e − m_v)`` (``m`` as B7
    returned it) and ``de = p·(sl_u·dnum_v + dden_v)``."""
    tm, tk = bcsr.tm, bcsr.tk
    mask = bcsr.data != 0
    slv = _slabs(sl2, bcsr.block_cols, bcsr.n_block_cols, tk)
    srv = _slabs(sr2, bcsr.block_rows, bcsr.n_block_rows, tm)
    mv = _slabs(m, bcsr.block_rows, bcsr.n_block_rows, tm)
    dnv = _slabs(dnum, bcsr.block_rows, bcsr.n_block_rows, tm)
    ddv = _slabs(dden, bcsr.block_rows, bcsr.n_block_rows, tm)
    dsr, dap = [], []
    for hh in range(h):
        fs = slice(hh * f, (hh + 1) * f)
        e = _v2_logit(a, srv, slv, hh, f, slope)  # [T, tm(v), tk(u)]
        p = torch.where(mask, torch.exp(e - mv[:, :, hh, None]), 0.0)
        gdot = torch.bmm(dnv[:, :, fs], slv[:, :, fs].transpose(1, 2))
        de = p * (gdot + ddv[:, :, hh, None])
        for ff in range(f):
            idx = hh * f + ff
            pre = srv[:, :, idx, None] + slv[:, None, :, idx]
            dsr.append((de * (a[hh, ff] * torch.where(pre >= 0, 1.0, slope))).sum(dim=2))
            dap.append((de * _leaky(pre, slope)).sum(dim=2))
    return torch.stack(dsr, 2), torch.stack(dap, 2)


def tile_v2_bwd_recv_plain(bcsr: BCSR, sl2, sr2, a, m, dnum, dden, h: int, f: int,
                           slope: float):
    """B8's function: ``(dsr [N, H·F], dapart [N, H·F])`` over the forward
    tiles, the per-tile partials summed by block row; ``da`` is ``dapart``
    summed over nodes."""
    n = sl2.shape[0]
    parts = tile_v2_bwd_recv_stream_plain(bcsr, sl2, sr2, a, m, dnum, dden, h, f, slope)
    return tuple(sum_by_block_row(x, bcsr, n) for x in parts)


def tile_v2_bwd_send_stream_plain(bcsr_t: BCSR, sl2, sr2, a, m, dnum, dden, h: int, f: int,
                                  slope: float):
    """B9's per-tile partials ``dsl_t [Tt, tm, H·F]`` over the transpose
    tiles, whose rows are senders ``u`` and columns receivers ``v``: the
    aggregation term ``Σ_v p·dnum_v`` plus the logit term through ``leaky'``."""
    tm, tk = bcsr_t.tm, bcsr_t.tk
    mask = bcsr_t.data != 0
    slu = _slabs(sl2, bcsr_t.block_rows, bcsr_t.n_block_rows, tm)
    srv = _slabs(sr2, bcsr_t.block_cols, bcsr_t.n_block_cols, tk)
    mv = _slabs(m, bcsr_t.block_cols, bcsr_t.n_block_cols, tk)
    dnv = _slabs(dnum, bcsr_t.block_cols, bcsr_t.n_block_cols, tk)
    ddv = _slabs(dden, bcsr_t.block_cols, bcsr_t.n_block_cols, tk)
    dsl = []
    for hh in range(h):
        fs = slice(hh * f, (hh + 1) * f)
        e = _v2_logit(a, slu, srv, hh, f, slope)  # [T, tm(u), tk(v)]
        p = torch.where(mask, torch.exp(e - mv[:, None, :, hh]), 0.0)
        agg = torch.bmm(p, dnv[:, :, fs])  # [T, tm, F]
        gdot = torch.bmm(slu[:, :, fs], dnv[:, :, fs].transpose(1, 2))
        de = p * (gdot + ddv[:, None, :, hh])
        logit = []
        for ff in range(f):
            idx = hh * f + ff
            pre = slu[:, :, idx, None] + srv[:, None, :, idx]
            logit.append((de * (a[hh, ff] * torch.where(pre >= 0, 1.0, slope))).sum(dim=2))
        dsl.append(agg + torch.stack(logit, 2))
    return torch.cat(dsl, 2)


def tile_v2_bwd_send_plain(bcsr_t: BCSR, sl2, sr2, a, m, dnum, dden, h: int, f: int,
                           slope: float):
    """B9's function: ``dsl [N, H·F]`` over the transpose tiles, the per-tile
    partials summed by block row."""
    parts = tile_v2_bwd_send_stream_plain(bcsr_t, sl2, sr2, a, m, dnum, dden, h, f, slope)
    return sum_by_block_row(parts, bcsr_t, sl2.shape[0])


def scheduled_sum(bcsr: BCSR, parts, n: int, max_tiles: int):
    """The backward kernels' (B5, B6, B8, B9) split-row sum in plain PyTorch:
    per-tile partials ``[T, tm, W]`` summed along the work items of
    :func:`spmm_schedule` at ``max_tiles`` as the kernels sum them: each
    item's tiles one after another, then a block row's items in item order. ``[n, W]``; rows of block rows
    without tiles are zero."""
    t, tm, w = parts.shape
    dev = parts.device
    items = spmm_schedule(bcsr, max_tiles).items.long().to(dev)
    n_items = items.shape[0]
    counts = items[:, 1] - items[:, 0]
    of_tile = torch.repeat_interleave(torch.arange(n_items, device=dev), counts)
    place = torch.arange(t, device=dev) - items[of_tile, 0]  # place of a tile in its item
    item_sum = parts.new_zeros((n_items, tm, w))
    for step in range(int(counts.max()) if n_items else 0):
        sel = place == step
        item_sum[of_tile[sel]] += parts[sel]
    row = items[:, 2].contiguous()
    part = torch.arange(n_items, device=dev) - torch.searchsorted(row, row)  # place in its row
    out = parts.new_zeros((bcsr.n_block_rows, tm, w))
    for step in range(int(part.max()) + 1 if n_items else 0):
        sel = part == step
        out[row[sel]] += item_sum[sel]
    return out.view(-1, w)[:n]


def tile_v2_bwd_recv_scheduled_plain(bcsr: BCSR, sl2, sr2, a, m, dnum, dden, h: int, f: int,
                                     slope: float, max_tiles: int):
    """B8's function as B8 computes it: :func:`scheduled_sum` of the per-tile
    partials at ``max_tiles``."""
    n = sl2.shape[0]
    parts = tile_v2_bwd_recv_stream_plain(bcsr, sl2, sr2, a, m, dnum, dden, h, f, slope)
    return tuple(scheduled_sum(bcsr, x, n, max_tiles) for x in parts)


def tile_v2_bwd_send_scheduled_plain(bcsr_t: BCSR, sl2, sr2, a, m, dnum, dden, h: int, f: int,
                                     slope: float, max_tiles: int):
    """B9's function as B9 computes it: :func:`scheduled_sum` of the per-tile
    partials at ``max_tiles``."""
    parts = tile_v2_bwd_send_stream_plain(bcsr_t, sl2, sr2, a, m, dnum, dden, h, f, slope)
    return scheduled_sum(bcsr_t, parts, sl2.shape[0], max_tiles)


# --------------------------------------------------------------------- #
# kernels
# --------------------------------------------------------------------- #


def _load(name: str):
    """The built library ``name`` (``gat_tile_attn`` or ``gatv2_tile_attn``),
    its entry points typed; builds it at first use."""
    if name not in _libs:
        from pygcn_tpu_torch.ops.cuda import build

        build.build([name])
        lib = ctypes.CDLL(str(build.library_path(name)))
        p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # the stream modes: tiles, block_cols, block_rows, <operands>,
        # <outputs> (B4: and its bits buffer), n_tiles, n, h, f, tile_bf16,
        # slope, stream
        entries = ((("gat_tile_fwd_stream", 7), ("gat_tile_bwd_dldst_stream", 7),
                    ("gat_tile_bwd_sender_stream", 8))
                   if name == "gat_tile_attn" else ())
        # (each entry then takes the geometry: side, panels, src)
        for fn_name, n_ptrs in entries:
            fn = getattr(lib, fn_name)
            fn.argtypes = [p] * (3 + n_ptrs) + [i] * 5 + [i, i, p] + [fl, p]
            fn.restype = ctypes.c_int
        # on work items (B3, B5-B9): tiles, block_cols, items, the operands,
        # the outputs, ws, counters; n_items, n_slots, n, h, f, max_tiles,
        # tile_bf16; side, panels, src; slope; stream
        items = ((("gat_tile_fwd", 3, 3), ("gat_tile_bwd_dldst", 6, 1),
                  ("gat_tile_bwd_sender", 6, 2)) if name == "gat_tile_attn" else
                 (("gatv2_tile_fwd", 3, 3), ("gatv2_tile_fwd_chunked", 3, 3),
                  ("gatv2_tile_bwd_recv", 6, 2), ("gatv2_tile_bwd_send", 6, 1)))
        for fn_name, n_ins, n_outs in items:
            fn = getattr(lib, fn_name)
            fn.argtypes = [p] * (5 + n_ins + n_outs) + [i] * 7 + [i, i, p] + [fl, p]
            fn.restype = ctypes.c_int
        config = getattr(lib, f"{name}_config")
        config.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
        config.restype = ctypes.c_int
        panel, multiple, item = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        config(ctypes.byref(panel), ctypes.byref(multiple), ctypes.byref(item))
        got = (panel.value, multiple.value, item.value)
        if got != (PANEL, SIDE_MULTIPLE, ITEM_INTS):
            raise RuntimeError(f"{name} built for panels, side multiples and work items of "
                               f"{got}; wrapper expects {(PANEL, SIDE_MULTIPLE, ITEM_INTS)}")
        _libs[name] = lib
    return _libs[name]


def check_tile_side(name: str, bcsr: BCSR) -> None:
    """Raise unless the GAT kernels take ``bcsr``'s tiles: square, with a
    side that is a positive multiple of :data:`SIDE_MULTIPLE`."""
    tm, tk = bcsr.tm, bcsr.tk
    if tm != tk or tm < SIDE_MULTIPLE or tm % SIDE_MULTIPLE:
        raise ValueError(f"{name} takes square tiles whose side is a positive multiple of "
                         f"{SIDE_MULTIPLE}; got {(tm, tk)}")


@dataclasses.dataclass(frozen=True)
class Panels:
    """A tile set as the GAT kernels walk it: panels of at most
    :data:`PANEL` x :data:`PANEL`, sorted by panel block row, with the
    tiles' own arrays when a tile is one panel (``src`` None).

    A side S above :data:`PANEL` is cut into ``panels = ceil(S / PANEL)``
    panels each way: panel block row ``b`` is panel ``b % panels`` of tile
    block row ``b // panels``, and ``src[t]`` the tile of panel tile ``t``.
    Every panel of every tile is kept, empty ones included (they add no edge).
    """

    block_rows: torch.Tensor  # [T'] int32
    block_cols: torch.Tensor  # [T'] int32
    block_row_ptr: torch.Tensor  # [n_block_rows + 1] int32
    n_block_rows: int
    src: Optional[torch.Tensor]  # [T'] int32, or None: the panels are the tiles
    side: int
    panels: int


def tile_panels(bcsr: BCSR) -> Panels:
    """The panels of ``bcsr`` (:class:`Panels`). A side up to :data:`PANEL`
    wraps the tiles' own arrays; a wider side's panel arrays are built in
    NumPy on the first call and kept in ``bcsr.cache``."""
    side = bcsr.tm
    panels = -(-side // PANEL)
    if panels == 1:
        return Panels(bcsr.block_rows, bcsr.block_cols, bcsr.block_row_ptr, bcsr.n_block_rows,
                      None, side, 1)
    key = ("gat_panels",)
    if key not in bcsr.cache:
        br = bcsr.block_rows.cpu().numpy().astype(np.int64)
        bc = bcsr.block_cols.cpu().numpy().astype(np.int64)
        tile = np.repeat(np.arange(br.size), panels * panels)
        pr = np.tile(np.repeat(np.arange(panels), panels), br.size)
        pc = np.tile(np.arange(panels), br.size * panels)
        rows, cols = br[tile] * panels + pr, bc[tile] * panels + pc
        order = np.lexsort((cols, rows))
        n_rows = bcsr.n_block_rows * panels
        ptr = np.zeros(n_rows + 1, np.int64)
        np.add.at(ptr, rows + 1, 1)
        dev = bcsr.block_rows.device

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32)).to(dev)

        bcsr.cache[key] = Panels(put(rows[order]), put(cols[order]), put(np.cumsum(ptr)),
                                 n_rows, put(tile[order]), side, panels)
    return bcsr.cache[key]


def _geometry(view: Panels) -> tuple:
    """The geometry arguments of every kernel entry: side, panels, src."""
    return view.side, view.panels, None if view.src is None else view.src.data_ptr()


def _check_cuda(name: str, bcsr: BCSR, tensors, shapes, n: int, f: int) -> None:
    """Everything kernel ``name`` needs of its operands; raises otherwise.

    ``tensors`` must have the ``shapes`` given: for B3-B6 ``lsrc``,
    ``ldst`` ``[n, H]`` and ``s2`` ``[n, H·F]``; for B7/B8/B9 ``sl2``, ``sr2``
    ``[n, H·F]`` and ``a`` ``[H, F]``; then for the backward ``m`` ``[n, H]``,
    ``dnum`` ``[n, H·F]`` and ``dden`` ``[n, H]``.
    """
    check_tile_side(name, bcsr)
    dev = tensors[0].device
    arrays = (bcsr.data, bcsr.block_rows, bcsr.block_cols, bcsr.block_row_ptr, *tensors)
    if dev.type != "cuda" or any(t.device != dev for t in arrays):
        raise ValueError(f"{name} needs the tiles and operands on one CUDA device, got "
                         + ", ".join(str(t.device) for t in arrays))
    if not all(t.is_contiguous() for t in arrays):
        raise ValueError(f"{name} needs contiguous tiles, indices and operands")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name} operands must be float32")
    if any(t.shape != s for t, s in zip(tensors, shapes)):
        raise ValueError(f"{name} operands must be shaped " + ", ".join(map(str, shapes))
                         + "; got " + ", ".join(str(tuple(t.shape)) for t in tensors))
    if bcsr.data.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"tiles must be float32 or bfloat16, got {bcsr.data.dtype}")
    if any(t.dtype != torch.int32
           for t in (bcsr.block_rows, bcsr.block_cols, bcsr.block_row_ptr)):
        raise TypeError("block_rows, block_cols and block_row_ptr must be int32")
    # Shapes only: checking the indices' values would wait for the device.
    if bcsr.block_row_ptr.numel() != bcsr.n_block_rows + 1:
        raise ValueError("block_row_ptr must have n_block_rows + 1 entries")
    if bcsr.block_cols.numel() != bcsr.data.shape[0] or \
            bcsr.block_rows.numel() != bcsr.data.shape[0]:
        raise ValueError("block_rows and block_cols must have one entry per tile")
    if n > bcsr.n_block_rows * bcsr.tm or n > bcsr.n_block_cols * bcsr.tk:
        raise ValueError(f"{n} nodes exceed the tiles' {bcsr.n_block_rows * bcsr.tm} rows "
                         f"or {bcsr.n_block_cols * bcsr.tk} columns")
    if f < 1:
        raise ValueError(f"{name} takes F >= 1 features per head, got {f}")
    if bcsr.data.data_ptr() % 16:
        raise ValueError("tiles must be 16-byte aligned")


def _launch_stream(name: str, fn_name: str, bcsr: BCSR, ins, outs, h: int, f: int,
                   slope: float):
    """Launch stream kernel ``fn_name`` (B4, B5s, B6s) over every panel tile."""
    lib = _load("gat_tile_attn")
    n = ins[0].shape[0]
    dev = ins[0].device
    view = tile_panels(bcsr)
    with torch.cuda.device(dev):
        err = getattr(lib, fn_name)(
            bcsr.data.data_ptr(), view.block_cols.data_ptr(), view.block_rows.data_ptr(),
            *(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
            view.block_rows.shape[0], n, h, f, int(bcsr.data.dtype == torch.bfloat16),
            *_geometry(view), float(slope), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err} (H={h}, F={f})")
    launches[name] += 1


def _item_schedule(bcsr: BCSR) -> tuple[SpMMSchedule, torch.Tensor]:
    """The work items at :data:`MAX_TILES` of B3, B5, B7 and B8 over a
    forward tile set, or of B6 and B9 over a transpose one, on the tiles'
    device, and their int32 arrival counters (one per split item, zero
    between launches), built on the first launch over ``bcsr`` and kept in
    ``bcsr.cache`` under a key of their own: B1's entry has counters of
    another size, and a launch of B1 never shares counters with a launch of a
    GAT kernel. The kernels over one tile set share its entry, counters
    included (B3 and B5, B7 and B8; B6 and B9): a step launches them one
    after the other on one stream, and the last item of a split row resets
    its counter before the next launch starts. Like B1's, they assume one
    launch at a time over a tile set. A side above :data:`PANEL` schedules
    its panel tiles (:func:`tile_panels`)."""
    key = ("gat_tile", MAX_TILES)
    if key not in bcsr.cache:
        dev = bcsr.block_row_ptr.device
        sched = spmm_schedule(tile_panels(bcsr), MAX_TILES)
        bcsr.cache[key] = (dataclasses.replace(sched, items=sched.items.to(dev)),
                           torch.zeros(max(sched.n_slots, 1), dtype=torch.int32, device=dev))
    return bcsr.cache[key]


def most_own_edges(bcsr: BCSR) -> int:
    """The most edges one row has in one work item at :data:`MAX_TILES`: above
    :data:`CHUNK_EDGES` the chunked kernels walk that row in several batches."""
    counts = (bcsr.data != 0).sum(dim=2).cpu().numpy()  # [T, tm]
    items = spmm_schedule(bcsr, MAX_TILES).items.cpu().numpy()
    return max((int(counts[b:e].sum(0).max()) for b, e in items[:, :2] if e > b), default=0)


def _launch_items(lib_name: str, name: str, fn_name: str, bcsr: BCSR, ins, outs, h: int,
                  f: int, slope: float, ws_width: int):
    """Launch ``fn_name`` (B3, B5-B9): one CTA per work item of
    :func:`_item_schedule`, the split items' partials in a workspace of
    ``n_slots * PANEL * ws_width`` floats (a slot is one panel's rows)."""
    lib = _load(lib_name)
    n = ins[0].shape[0]
    dev = ins[0].device
    view = tile_panels(bcsr)
    sched, counters = _item_schedule(bcsr)
    ws = (torch.empty(sched.n_slots * PANEL * ws_width, dtype=torch.float32, device=dev)
          if sched.n_slots else None)
    with torch.cuda.device(dev):
        err = getattr(lib, fn_name)(
            bcsr.data.data_ptr(), view.block_cols.data_ptr(), sched.items.data_ptr(),
            *(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
            None if ws is None else ws.data_ptr(), counters.data_ptr(),
            sched.items.shape[0], sched.n_slots, n, h, f, MAX_TILES,
            int(bcsr.data.dtype == torch.bfloat16), *_geometry(view), float(slope),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err} (H={h}, F={f}, "
                           f"C={MAX_TILES})")
    launches[name] += 1


def _empty(n, w, like):
    return torch.empty((n, w), dtype=torch.float32, device=like.device)


def _v1_shapes(n, h, f):
    """B3/B5/B6's operand shapes: lsrc, ldst, s2, then m, dnum, dden."""
    return ((n, h), (n, h), (n, h * f), (n, h), (n, h * f), (n, h))


def _v2_shapes(n, h, f):
    """B7/B8/B9's operand shapes: sl2, sr2, a, then m, dnum, dden."""
    return ((n, h * f), (n, h * f), (h, f), (n, h), (n, h * f), (n, h))


def tile_fwd_cuda(bcsr: BCSR, lsrc, ldst, s2, h: int, f: int, slope: float):
    """Launch B3 on the current stream; raises on anything it does not take."""
    n = s2.shape[0]
    _check_cuda("B3", bcsr, (lsrc, ldst, s2), _v1_shapes(n, h, f), n, f)
    num, den, m = _empty(n, h * f, s2), _empty(n, h, s2), _empty(n, h, s2)
    if n and h:
        _launch_items("gat_tile_attn", "B3", "gat_tile_fwd", bcsr, (lsrc, ldst, s2),
                      (num, den, m), h, f, slope, h * f + 2 * h)
    return num, den, m


def tile_bwd_dldst_cuda(bcsr: BCSR, lsrc, ldst, s2, m, dnum, dden, h: int, f: int,
                        slope: float):
    """Launch B5 on the current stream; raises on anything it does not take."""
    n = s2.shape[0]
    ins = (lsrc, ldst, s2, m, dnum, dden)
    _check_cuda("B5", bcsr, ins, _v1_shapes(n, h, f), n, f)
    dldst = _empty(n, h, s2)
    if n and h:
        _launch_items("gat_tile_attn", "B5", "gat_tile_bwd_dldst", bcsr, ins, (dldst,), h, f,
                      slope, h)
    return dldst


def tile_bwd_sender_cuda(bcsr_t: BCSR, lsrc, ldst, s2, m, dnum, dden, h: int, f: int,
                         slope: float):
    """Launch B6 on the current stream; raises on anything it does not take."""
    n = s2.shape[0]
    ins = (lsrc, ldst, s2, m, dnum, dden)
    _check_cuda("B6", bcsr_t, ins, _v1_shapes(n, h, f), n, f)
    ds, dlsrc = _empty(n, h * f, s2), _empty(n, h, s2)
    if n and h:
        _launch_items("gat_tile_attn", "B6", "gat_tile_bwd_sender", bcsr_t, ins, (ds, dlsrc), h,
                      f, slope, h * f + h)
    return ds, dlsrc


def _zeros(n, w, like):
    return torch.zeros((n, w), dtype=torch.float32, device=like.device)


def tile_fwd_stream_cuda(bcsr: BCSR, lsrc, ldst, s2, h: int, f: int, slope: float):
    """Launch B4 on the current stream → the merged ``(num [n, H·F], den
    [n, H], m [n, H])``: ``num`` and ``den`` zero-filled and ``m`` filled with
    ``NEG``, then every tile's row maxima and sums merged in, through a bits
    buffer of the panel tiles' mask words ``[T', PANEL, 4]``. Raises on anything it does
    not take."""
    n = s2.shape[0]
    _check_cuda("B4", bcsr, (lsrc, ldst, s2), _v1_shapes(n, h, f), n, f)
    num, den = _zeros(n, h * f, s2), _zeros(n, h, s2)
    m = torch.full((n, h), NEG, dtype=torch.float32, device=s2.device)
    t = bcsr.data.shape[0]
    if t and n and h:
        n_panels = tile_panels(bcsr).block_rows.shape[0]
        bits = torch.empty((n_panels, PANEL, 4), dtype=torch.int32, device=s2.device)
        _launch_stream("B4", "gat_tile_fwd_stream", bcsr, (lsrc, ldst, s2),
                       (num, den, m, bits), h, f, slope)
    return num, den, m


def tile_bwd_dldst_stream_cuda(bcsr: BCSR, lsrc, ldst, s2, m, dnum, dden, h: int, f: int,
                               slope: float):
    """Launch B5s on the current stream → the merged ``dldst [n, H]``,
    zero-filled, then every tile's rows added in. Raises on anything it does
    not take."""
    n = s2.shape[0]
    ins = (lsrc, ldst, s2, m, dnum, dden)
    _check_cuda("B5s", bcsr, ins, _v1_shapes(n, h, f), n, f)
    dldst = _zeros(n, h, s2)
    if bcsr.data.shape[0] and n and h:
        _launch_stream("B5s", "gat_tile_bwd_dldst_stream", bcsr, ins, (dldst,), h, f, slope)
    return dldst


def tile_bwd_sender_stream_cuda(bcsr_t: BCSR, lsrc, ldst, s2, m, dnum, dden, h: int, f: int,
                                slope: float):
    """Launch B6s on the current stream → the merged ``(ds [n, H·F],
    dlsrc [n, H])``, zero-filled, then every transpose tile's rows added in.
    Raises on anything it does not take."""
    n = s2.shape[0]
    ins = (lsrc, ldst, s2, m, dnum, dden)
    _check_cuda("B6s", bcsr_t, ins, _v1_shapes(n, h, f), n, f)
    ds, dlsrc = _zeros(n, h * f, s2), _zeros(n, h, s2)
    if bcsr_t.data.shape[0] and n and h:
        _launch_stream("B6s", "gat_tile_bwd_sender_stream", bcsr_t, ins, (ds, dlsrc), h, f,
                       slope)
    return ds, dlsrc


def tile_v2_fwd_cuda(bcsr: BCSR, sl2, sr2, a, h: int, f: int, slope: float,
                     chunked: bool = False):
    """Launch B7 on the current stream; raises on anything it does not take.
    ``chunked`` runs its F-chunked kernel at any F (the main path takes it
    only above the staged kernel's reach), to test and time the two."""
    n = sl2.shape[0]
    ins = (sl2, sr2, a)
    _check_cuda("B7", bcsr, ins, _v2_shapes(n, h, f), n, f)
    num, den, m = _empty(n, h * f, sl2), _empty(n, h, sl2), _empty(n, h, sl2)
    if n and h:
        _launch_items("gatv2_tile_attn", "B7",
                      "gatv2_tile_fwd_chunked" if chunked else "gatv2_tile_fwd", bcsr, ins,
                      (num, den, m), h, f, slope, h * f + 2 * h)
    return num, den, m


def tile_v2_bwd_recv_cuda(bcsr: BCSR, sl2, sr2, a, m, dnum, dden, h: int, f: int,
                          slope: float):
    """Launch B8 on the current stream; raises on anything it does not take."""
    n = sl2.shape[0]
    ins = (sl2, sr2, a, m, dnum, dden)
    _check_cuda("B8", bcsr, ins, _v2_shapes(n, h, f), n, f)
    dsr, dapart = _empty(n, h * f, sl2), _empty(n, h * f, sl2)
    if n and h:
        _launch_items("gatv2_tile_attn", "B8", "gatv2_tile_bwd_recv", bcsr, ins, (dsr, dapart),
                      h, f, slope, 2 * h * f)
    return dsr, dapart


def tile_v2_bwd_send_cuda(bcsr_t: BCSR, sl2, sr2, a, m, dnum, dden, h: int, f: int,
                          slope: float):
    """Launch B9 on the current stream; raises on anything it does not take."""
    n = sl2.shape[0]
    ins = (sl2, sr2, a, m, dnum, dden)
    _check_cuda("B9", bcsr_t, ins, _v2_shapes(n, h, f), n, f)
    dsl = _empty(n, h * f, sl2)
    if n and h:
        _launch_items("gatv2_tile_attn", "B9", "gatv2_tile_bwd_send", bcsr_t, ins, (dsl,), h, f,
                      slope, h * f)
    return dsl


def _pick(plain, cuda, x: torch.Tensor):
    if x.device.type == "cpu":
        return plain
    if x.device.type == "cuda":
        return cuda
    raise ValueError(f"GAT tile attention runs on cpu (plain) or cuda (kernel), not {x.device}")


def tile_fwd(bcsr, lsrc, ldst, s2, h, f, slope):
    return _pick(tile_fwd_plain, tile_fwd_cuda, s2)(bcsr, lsrc, ldst, s2, h, f, slope)


def tile_bwd_dldst(bcsr, *args):
    return _pick(tile_bwd_dldst_plain, tile_bwd_dldst_cuda, args[2])(bcsr, *args)


def tile_bwd_sender(bcsr_t, *args):
    return _pick(tile_bwd_sender_plain, tile_bwd_sender_cuda, args[2])(bcsr_t, *args)


def tile_fwd_stream(bcsr, lsrc, ldst, s2, h, f, slope):
    """B4 → the merged ``(num, den, m)``; on the CPU the plain per-tile
    partials merged by :func:`softmax_merge`."""
    return _pick(tile_fwd_plain, tile_fwd_stream_cuda, s2)(bcsr, lsrc, ldst, s2, h, f, slope)


def tile_bwd_dldst_stream(bcsr, *args):
    """B5s → the merged ``dldst``; on the CPU the plain per-tile blocks
    summed by block row."""
    return _pick(tile_bwd_dldst_plain, tile_bwd_dldst_stream_cuda, args[2])(bcsr, *args)


def tile_bwd_sender_stream(bcsr_t, *args):
    """B6s → the merged ``(ds, dlsrc)``; on the CPU the plain per-tile blocks
    summed by block row."""
    return _pick(tile_bwd_sender_plain, tile_bwd_sender_stream_cuda, args[2])(bcsr_t, *args)


def tile_v2_fwd(bcsr, sl2, sr2, a, h, f, slope):
    return _pick(tile_v2_fwd_plain, tile_v2_fwd_cuda, sl2)(bcsr, sl2, sr2, a, h, f, slope)


def tile_v2_bwd_recv(bcsr, *args):
    return _pick(tile_v2_bwd_recv_plain, tile_v2_bwd_recv_cuda, args[0])(bcsr, *args)


def tile_v2_bwd_send(bcsr_t, *args):
    return _pick(tile_v2_bwd_send_plain, tile_v2_bwd_send_cuda, args[0])(bcsr_t, *args)


def _require_square(name: str, bcsr: BCSR, bcsr_t: BCSR) -> None:
    # Operands are indexed by block row in one pass and by block column in
    # the other; the two index spaces coincide only for square tiles.
    if bcsr.tm != bcsr.tk or bcsr_t.tm != bcsr_t.tk:
        raise ValueError(
            f"{name} backward requires square tiles (tm == tk); "
            f"got ({bcsr.tm}, {bcsr.tk}) / ({bcsr_t.tm}, {bcsr_t.tk})")


class GATTilePartials(torch.autograd.Function):
    """Per-receiver attention partials over the tile edges, with the backward
    of ``pygcn_tpu``'s ``custom_vjp``: B3 forward, then B5 over the forward
    tiles and B6 over ``bcsr_t``; or, when :data:`TILE_REVISIT` is False at the
    forward, B4, then B5s and B6s, each merged in its kernel. ``m`` carries no
    gradient."""

    @staticmethod
    def forward(ctx, meta, bcsr, bcsr_t, lsrc, ldst, s2):
        h, f, slope = meta
        lsrc, ldst, s2 = lsrc.contiguous(), ldst.contiguous(), s2.contiguous()
        ctx.revisit = TILE_REVISIT
        if ctx.revisit:
            num, den, m = tile_fwd(bcsr, lsrc, ldst, s2, h, f, slope)
        else:
            num, den, m = tile_fwd_stream(bcsr, lsrc, ldst, s2, h, f, slope)
        ctx.meta, ctx.bcsr, ctx.bcsr_t = meta, bcsr, bcsr_t
        ctx.save_for_backward(lsrc, ldst, s2, m)
        ctx.mark_non_differentiable(m)
        return num, den, m

    @staticmethod
    def backward(ctx, dnum, dden, _dm):
        h, f, slope = ctx.meta
        bcsr, bcsr_t = ctx.bcsr, ctx.bcsr_t
        _require_square("gat_tile_partials", bcsr, bcsr_t)
        lsrc, ldst, s2, m = ctx.saved_tensors
        args = (lsrc, ldst, s2, m, dnum.contiguous(), dden.contiguous(), h, f, slope)
        if ctx.revisit:
            dldst = tile_bwd_dldst(bcsr, *args)
            ds, dlsrc = tile_bwd_sender(bcsr_t, *args)
        else:
            dldst = tile_bwd_dldst_stream(bcsr, *args)
            ds, dlsrc = tile_bwd_sender_stream(bcsr_t, *args)
        return None, None, None, dlsrc, dldst, ds


def gat_tile_partials(meta, bcsr: BCSR, bcsr_t: BCSR, lsrc, ldst, s2):
    """``(num [N, H·F], den [N, H], m [N, H])`` over the tile edges.

    ``meta = (h, f, slope)``; ``bcsr``/``bcsr_t`` are the hybrid layout's
    forward tiles and their :func:`transpose_bcsr`; ``lsrc``/``ldst`` are the
    per-head logits ``[N, H]`` and ``s2`` the features ``[N, H·F]``. ``m`` is
    the per-receiver max over tile edges (``NEG`` where a receiver has none)
    and is non-differentiable; combine with other partials by the rescaled
    flash merge (``ops/gat.py: gat_conv_hybrid``).
    """
    return GATTilePartials.apply(meta, bcsr, bcsr_t, lsrc, ldst, s2)



class GATv2TilePartials(torch.autograd.Function):
    """Per-receiver GATv2 attention partials over the tile edges, with the
    backward of ``pygcn_tpu``'s ``custom_vjp``: B7 forward, then B8 over the
    forward tiles (``dsr`` and ``da``) and B9 over ``bcsr_t`` (``dsl``). ``m``
    carries no gradient."""

    @staticmethod
    def forward(ctx, meta, bcsr, bcsr_t, sl2, sr2, a):
        h, f, slope = meta
        sl2, sr2, a = sl2.contiguous(), sr2.contiguous(), a.contiguous()
        num, den, m = tile_v2_fwd(bcsr, sl2, sr2, a, h, f, slope)
        ctx.meta, ctx.bcsr, ctx.bcsr_t = meta, bcsr, bcsr_t
        ctx.save_for_backward(sl2, sr2, a, m)
        ctx.mark_non_differentiable(m)
        return num, den, m

    @staticmethod
    def backward(ctx, dnum, dden, _dm):
        h, f, slope = ctx.meta
        bcsr, bcsr_t = ctx.bcsr, ctx.bcsr_t
        _require_square("gatv2_tile_partials", bcsr, bcsr_t)
        sl2, sr2, a, m = ctx.saved_tensors
        args = (sl2, sr2, a, m, dnum.contiguous(), dden.contiguous(), h, f, slope)
        dsr, dapart = tile_v2_bwd_recv(bcsr, *args)
        da = dapart.sum(dim=0).view(h, f)  # the JAX package sums it outside its kernel too
        dsl = tile_v2_bwd_send(bcsr_t, *args)
        return None, None, None, dsl, dsr, da


def gatv2_tile_partials(meta, bcsr: BCSR, bcsr_t: BCSR, sl2, sr2, a):
    """``(num [N, H·F], den [N, H], m [N, H])`` of GATv2 over the tile edges.

    ``meta = (h, f, slope)``; ``sl2``/``sr2`` are the source and receiver
    transforms ``[N, H·F]`` (``sl2`` is also the aggregated feature) and ``a``
    the attention vector ``[H, F]``. Otherwise as :func:`gat_tile_partials`.
    """
    return GATv2TilePartials.apply(meta, bcsr, bcsr_t, sl2, sr2, a)
