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

and of its ``gatv2_tile_partials``, where the logit of a tile edge ``u -> v``
is ``e = Σ_f a[h,f]·leaky(sl[u,hF+f] + sr[v,hF+f])``:

- **B7** ``_v2_fwd_kernel``: the partials ``num [N, H·F]`` (of ``sl``),
  ``den [N, H]`` and ``m [N, H]``, as B3's;
- **B8** ``_v2_bwd_recv_kernel``: ``dsr [N, H·F]`` and the per-receiver
  partial ``dapart [N, H·F]`` of ``da``, over the forward tiles;
- **B9** ``_v2_bwd_send_kernel``: ``dsl [N, H·F]``, over the transpose tiles.

The CUDA sources, ``pygcn_tpu_torch/csrc/gat_tile_attn.cu`` (B3/B5/B6) and
``gatv2_tile_attn.cu`` (B7/B8/B9), carry the design notes: one CTA per (head,
block row) loops over the row's tiles, each thread owns one row of the block,
and each output is written once, without atomics. At the ogbn-arxiv hybrid's
shapes all six are bound by bytes (the tiles as stored, about 0.19 GB a
launch); the kernels evaluate every (row, column) slot of a tile column that
some row of the warp needs, so they sit above that bound.

Tile values only gate the mask (``tile != 0``); they are never multiplied in.
Each kernel has a plain PyTorch version here (``*_plain``), the CPU path and
the card's yardstick. The wrappers pick by the device of the operands: CPU
tensors run the plain version, CUDA tensors run the kernel or raise, any other
device raises. ``launches`` counts each kernel's launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pygcn_tpu_torch.graph.graph import BCSR

NEG = -1e30  # finite stand-in for -inf: max/exp algebra without NaNs

# The tile shape the kernels are compiled for, and the per-head widths F they
# take (each is padded up to the next compiled width).
TILE = (128, 128)
MAX_F = 64

# Kernel launches since import (or since a caller reset them to 0).
launches = {"B3": 0, "B5": 0, "B6": 0, "B7": 0, "B8": 0, "B9": 0}

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


def _by_block_row(parts: torch.Tensor, bcsr: BCSR, n: int) -> torch.Tensor:
    """Sum per-tile ``[T, tm, W]`` parts into their block rows → ``[n, W]``."""
    out = parts.new_zeros((bcsr.n_block_rows, bcsr.tm, parts.shape[2]))
    out.index_add_(0, bcsr.block_rows.long(), parts)
    return out.view(-1, parts.shape[2])[:n]


def tile_fwd_plain(bcsr: BCSR, lsrc, ldst, s2, h: int, f: int, slope: float):
    """B3's function with tensor ops: ``(num [N, H·F], den [N, H], m [N, H])``.

    Takes the max over each receiver's tile edges before exponentiating
    (:func:`_softmax_partials`): the same ``m``, and the same ``num``/``den``
    relative to it, as the kernel's online order. Loops over heads, so no
    ``[T, H, tm, tk]`` temporary is built.
    """
    tm, tk = bcsr.tm, bcsr.tk
    ls = _slabs(lsrc, bcsr.block_cols, bcsr.n_block_cols, tk)  # [T, tk, H]
    ld = _slabs(ldst, bcsr.block_rows, bcsr.n_block_rows, tm)  # [T, tm, H]
    sv = _slabs(s2, bcsr.block_cols, bcsr.n_block_cols, tk)  # [T, tk, H·F]
    logits = (_leaky(ld[:, :, hh, None] + ls[:, None, :, hh], slope) for hh in range(h))
    return _softmax_partials(bcsr, logits, sv, f, s2.shape[0])


def _softmax_partials(bcsr: BCSR, logits, sv, f: int, n: int):
    """``(num [n, H·F], den [n, H], m [n, H])`` from each head's tile logits
    ``[T, tm, tk]`` (an iterable over heads) and the senders' features
    ``sv [T, tk, H·F]``: each tile's row max, merged by block row
    (``scatter_reduce`` ``amax`` on a ``NEG`` start), then one exponentiation
    against it."""
    tm = bcsr.tm
    t = bcsr.data.shape[0]
    mask = bcsr.data != 0  # [T, tm, tk]
    br = bcsr.block_rows.long()
    nums, dens, ms = [], [], []
    for hh, e in enumerate(logits):
        neg = torch.where(mask, e, NEG)
        tmax = neg.amax(dim=2)  # [T, tm]
        m = torch.full((bcsr.n_block_rows, tm), NEG, dtype=e.dtype, device=e.device)
        m = m.scatter_reduce(0, br[:, None].expand(t, tm), tmax, "amax", include_self=True)
        ex = torch.where(mask, torch.exp(neg - m[br][:, :, None]), 0.0)
        dens.append(_by_block_row(ex.sum(dim=2, keepdim=True), bcsr, n))
        nums.append(_by_block_row(torch.bmm(ex, sv[:, :, hh * f:(hh + 1) * f]), bcsr, n))
        ms.append(m.view(-1, 1)[:n])
    return torch.cat(nums, 1), torch.cat(dens, 1), torch.cat(ms, 1)


def tile_bwd_dldst_plain(bcsr: BCSR, lsrc, ldst, s2, m, dnum, dden, h: int, f: int,
                         slope: float):
    """B5's function: ``dldst [N, H]`` over the forward tiles, with
    ``p = mask·exp(e − m_v)`` (``m`` as B3 returned it)."""
    n = s2.shape[0]
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
        out.append(_by_block_row(de.sum(dim=2, keepdim=True), bcsr, n))
    return torch.cat(out, 1)


def tile_bwd_sender_plain(bcsr_t: BCSR, lsrc, ldst, s2, m, dnum, dden, h: int, f: int,
                          slope: float):
    """B6's function: ``(ds [N, H·F], dlsrc [N, H])`` over the transpose
    tiles, whose rows are senders ``u`` and columns receivers ``v``."""
    n = s2.shape[0]
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
        ds.append(_by_block_row(torch.bmm(p, dnv[:, :, fs]), bcsr_t, n))
        gdot = torch.bmm(su[:, :, fs], dnv[:, :, fs].transpose(1, 2))
        de = p * (gdot + ddv[:, None, :, hh]) * torch.where(pre >= 0, 1.0, slope)
        dl.append(_by_block_row(de.sum(dim=2, keepdim=True), bcsr_t, n))
    return torch.cat(ds, 1), torch.cat(dl, 1)


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


def tile_v2_fwd_plain(bcsr: BCSR, sl2, sr2, a, h: int, f: int, slope: float):
    """B7's function with tensor ops: ``(num [N, H·F], den [N, H], m [N, H])``,
    ``num`` aggregating ``sl2``; the max and merge as in :func:`tile_fwd_plain`."""
    slv = _slabs(sl2, bcsr.block_cols, bcsr.n_block_cols, bcsr.tk)  # [T, tk(u), H·F]
    srv = _slabs(sr2, bcsr.block_rows, bcsr.n_block_rows, bcsr.tm)  # [T, tm(v), H·F]
    logits = (_v2_logit(a, srv, slv, hh, f, slope) for hh in range(h))
    return _softmax_partials(bcsr, logits, slv, f, sl2.shape[0])


def tile_v2_bwd_recv_plain(bcsr: BCSR, sl2, sr2, a, m, dnum, dden, h: int, f: int,
                           slope: float):
    """B8's function: ``(dsr [N, H·F], dapart [N, H·F])`` over the forward
    tiles, with ``p = mask·exp(e − m_v)`` (``m`` as B7 returned it) and
    ``de = p·(sl_u·dnum_v + dden_v)``; ``da`` is ``dapart`` summed over nodes."""
    n = sl2.shape[0]
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
        g_sr, g_ap = [], []
        for ff in range(f):
            idx = hh * f + ff
            pre = srv[:, :, idx, None] + slv[:, None, :, idx]
            g_sr.append((de * (a[hh, ff] * torch.where(pre >= 0, 1.0, slope))).sum(dim=2))
            g_ap.append((de * _leaky(pre, slope)).sum(dim=2))
        dsr.append(_by_block_row(torch.stack(g_sr, 2), bcsr, n))
        dap.append(_by_block_row(torch.stack(g_ap, 2), bcsr, n))
    return torch.cat(dsr, 1), torch.cat(dap, 1)


def tile_v2_bwd_send_plain(bcsr_t: BCSR, sl2, sr2, a, m, dnum, dden, h: int, f: int,
                           slope: float):
    """B9's function: ``dsl [N, H·F]`` over the transpose tiles, whose rows are
    senders ``u`` and columns receivers ``v``: the aggregation term
    ``Σ_v p·dnum_v`` plus the logit term through ``leaky'``."""
    n = sl2.shape[0]
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
        dsl.append(_by_block_row(agg + torch.stack(logit, 2), bcsr_t, n))
    return torch.cat(dsl, 1)


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
        # tiles, block_cols, block_row_ptr, <operands>, <outputs>,
        # n_block_rows, n, h, f, tile_bf16, slope, stream
        entries = ((("gat_tile_fwd", 6), ("gat_tile_bwd_dldst", 7), ("gat_tile_bwd_sender", 8))
                   if name == "gat_tile_attn" else
                   (("gatv2_tile_fwd", 6), ("gatv2_tile_bwd_recv", 8),
                    ("gatv2_tile_bwd_send", 7)))
        for fn_name, n_ptrs in entries:
            fn = getattr(lib, fn_name)
            fn.argtypes = [p] * (3 + n_ptrs) + [i] * 5 + [fl, p]
            fn.restype = ctypes.c_int
        config = getattr(lib, f"{name}_config")
        config.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
        config.restype = ctypes.c_int
        tm, tk, max_f = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        config(ctypes.byref(tm), ctypes.byref(tk), ctypes.byref(max_f))
        if (tm.value, tk.value, max_f.value) != (*TILE, MAX_F):
            raise RuntimeError(f"{name} built for {(tm.value, tk.value)} tiles and F <= "
                               f"{max_f.value}; wrapper expects {TILE} and {MAX_F}")
        _libs[name] = lib
    return _libs[name]


def _check_cuda(name: str, bcsr: BCSR, tensors, shapes, n: int, f: int) -> None:
    """Everything kernel ``name`` needs of its operands; raises otherwise.

    ``tensors`` must have the ``shapes`` given: for B3/B5/B6 ``lsrc``,
    ``ldst`` ``[n, H]`` and ``s2`` ``[n, H·F]``; for B7/B8/B9 ``sl2``, ``sr2``
    ``[n, H·F]`` and ``a`` ``[H, F]``; then for the backward ``m`` ``[n, H]``,
    ``dnum`` ``[n, H·F]`` and ``dden`` ``[n, H]``.
    """
    dev = tensors[0].device
    arrays = (bcsr.data, bcsr.block_cols, bcsr.block_row_ptr, *tensors)
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
    if bcsr.block_cols.dtype != torch.int32 or bcsr.block_row_ptr.dtype != torch.int32:
        raise TypeError("block_cols and block_row_ptr must be int32")
    if (bcsr.tm, bcsr.tk) != TILE:
        raise ValueError(f"{name} is built for {TILE} tiles, got {(bcsr.tm, bcsr.tk)}")
    # Shapes only: checking the pointers' values would wait for the device.
    if bcsr.block_row_ptr.numel() != bcsr.n_block_rows + 1:
        raise ValueError("block_row_ptr must have n_block_rows + 1 entries")
    if bcsr.block_cols.numel() != bcsr.data.shape[0]:
        raise ValueError("block_cols must have one entry per tile")
    if n > bcsr.n_block_rows * bcsr.tm or n > bcsr.n_block_cols * bcsr.tk:
        raise ValueError(f"{n} nodes exceed the tiles' {bcsr.n_block_rows * bcsr.tm} rows "
                         f"or {bcsr.n_block_cols * bcsr.tk} columns")
    if not 1 <= f <= MAX_F:
        raise ValueError(f"{name} takes 1 <= F <= {MAX_F} features per head, got {f}")
    if bcsr.data.data_ptr() % 16:
        raise ValueError("tiles must be 16-byte aligned")


def _launch(lib_name: str, name: str, fn_name: str, bcsr: BCSR, ins, outs, h: int, f: int,
            slope: float):
    lib = _load(lib_name)
    n = ins[0].shape[0]
    dev = ins[0].device
    with torch.cuda.device(dev):
        err = getattr(lib, fn_name)(
            bcsr.data.data_ptr(), bcsr.block_cols.data_ptr(), bcsr.block_row_ptr.data_ptr(),
            *(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
            bcsr.n_block_rows, n, h, f, int(bcsr.data.dtype == torch.bfloat16),
            float(slope), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")
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
        _launch("gat_tile_attn", "B3", "gat_tile_fwd", bcsr, (lsrc, ldst, s2), (num, den, m), h,
                f, slope)
    return num, den, m


def tile_bwd_dldst_cuda(bcsr: BCSR, lsrc, ldst, s2, m, dnum, dden, h: int, f: int,
                        slope: float):
    """Launch B5 on the current stream; raises on anything it does not take."""
    n = s2.shape[0]
    ins = (lsrc, ldst, s2, m, dnum, dden)
    _check_cuda("B5", bcsr, ins, _v1_shapes(n, h, f), n, f)
    dldst = _empty(n, h, s2)
    if n and h:
        _launch("gat_tile_attn", "B5", "gat_tile_bwd_dldst", bcsr, ins, (dldst,), h, f, slope)
    return dldst


def tile_bwd_sender_cuda(bcsr_t: BCSR, lsrc, ldst, s2, m, dnum, dden, h: int, f: int,
                         slope: float):
    """Launch B6 on the current stream; raises on anything it does not take."""
    n = s2.shape[0]
    ins = (lsrc, ldst, s2, m, dnum, dden)
    _check_cuda("B6", bcsr_t, ins, _v1_shapes(n, h, f), n, f)
    ds, dlsrc = _empty(n, h * f, s2), _empty(n, h, s2)
    if n and h:
        _launch("gat_tile_attn", "B6", "gat_tile_bwd_sender", bcsr_t, ins, (ds, dlsrc), h, f, slope)
    return ds, dlsrc


def tile_v2_fwd_cuda(bcsr: BCSR, sl2, sr2, a, h: int, f: int, slope: float):
    """Launch B7 on the current stream; raises on anything it does not take."""
    n = sl2.shape[0]
    ins = (sl2, sr2, a)
    _check_cuda("B7", bcsr, ins, _v2_shapes(n, h, f), n, f)
    num, den, m = _empty(n, h * f, sl2), _empty(n, h, sl2), _empty(n, h, sl2)
    if n and h:
        _launch("gatv2_tile_attn", "B7", "gatv2_tile_fwd", bcsr, ins, (num, den, m), h, f, slope)
    return num, den, m


def tile_v2_bwd_recv_cuda(bcsr: BCSR, sl2, sr2, a, m, dnum, dden, h: int, f: int,
                          slope: float):
    """Launch B8 on the current stream; raises on anything it does not take."""
    n = sl2.shape[0]
    ins = (sl2, sr2, a, m, dnum, dden)
    _check_cuda("B8", bcsr, ins, _v2_shapes(n, h, f), n, f)
    dsr, dapart = _empty(n, h * f, sl2), _empty(n, h * f, sl2)
    if n and h:
        _launch("gatv2_tile_attn", "B8", "gatv2_tile_bwd_recv", bcsr, ins, (dsr, dapart), h, f,
                slope)
    return dsr, dapart


def tile_v2_bwd_send_cuda(bcsr_t: BCSR, sl2, sr2, a, m, dnum, dden, h: int, f: int,
                          slope: float):
    """Launch B9 on the current stream; raises on anything it does not take."""
    n = sl2.shape[0]
    ins = (sl2, sr2, a, m, dnum, dden)
    _check_cuda("B9", bcsr_t, ins, _v2_shapes(n, h, f), n, f)
    dsl = _empty(n, h * f, sl2)
    if n and h:
        _launch("gatv2_tile_attn", "B9", "gatv2_tile_bwd_send", bcsr_t, ins, (dsl,), h, f, slope)
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
    tiles and B6 over ``bcsr_t``. ``m`` carries no gradient."""

    @staticmethod
    def forward(ctx, meta, bcsr, bcsr_t, lsrc, ldst, s2):
        h, f, slope = meta
        lsrc, ldst, s2 = lsrc.contiguous(), ldst.contiguous(), s2.contiguous()
        num, den, m = tile_fwd(bcsr, lsrc, ldst, s2, h, f, slope)
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
        dldst = tile_bwd_dldst(bcsr, *args)
        ds, dlsrc = tile_bwd_sender(bcsr_t, *args)
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
