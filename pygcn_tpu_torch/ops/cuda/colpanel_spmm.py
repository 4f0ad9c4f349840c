"""Kernel E2: the column-panel SpMM ``y = A @ x`` (``ops/colpanel.py``) in
one launch a product.

E2 replaces no TPU kernel: the JAX package leaves this product to XLA
(``pygcn_tpu/ops/colpanel.py:183 col_panel_spmm_raw``, a ``take`` and one
``segment_sum``). It replaces the plain chain that runs once per live bucket
of every sender panel, an ``index_select``, a product by the values, a sum
over the slots, a ``segment_reduce`` where rows repeat and an ``index_add_``
into a zero-filled output, with one launch that walks each output row's
virtual rows across all panels, sums them in f32 registers and writes the row
once. Written for the H100 in ``pygcn_tpu_torch/csrc/colpanel_spmm.cu``,
which carries the design note and the bound (bytes).

:func:`colpanel_schedule` builds E2's schedule from a layout: per output row
the references to its virtual rows in panel, bucket and slot order, each with
its bucket's table index, first slot and length (the layout's ``lens``, so
that no padding is read); a row with no edge writes zeros; a hub row, over
:data:`HUB_SLOTS` slots, is cut at virtual-row boundaries into parts whose
partials the last part to arrive sums in part order. Built once per layout
on the first launch and kept in ``pe.cache``; a transpose layout that holds
its forward layout's structure (``pe.twin``, ``ops/colpanel.share_structure``)
runs on the forward layout's schedule.

:func:`colpanel_spmm_cuda` launches E2 on a CUDA f32 ``x`` and raises on
anything else; ``ops/colpanel.col_panel_spmm_raw`` picks it by ``x``'s
device. ``launches`` counts its launches.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

# The ints of one reference and of one hub part, checked against the library.
REF_INTS = 2
PART_INTS = 8

# A row of more slots than this is cut into parts of about this many (at
# virtual-row boundaries, so a part may hold up to a widest bucket more), so
# that no row sets the launch's tail. At the ogbn-products benchmark graph on
# an H100, 512 took 2.6% (H = 256) and 4.4% (H = 47) off a product against
# 2,048, 1,024 about half that, and 4,096 was slower; with no cut its hub
# rows took a product from 17 to 138 ms.
HUB_SLOTS = 512

# Kernel launches since import (or since a caller reset them to 0).
launches = 0

_lib = None

# row_ptr[r] carries this bit when row r is a hub row, summed by its parts
_SPLIT = 1 << 31


def _load():
    global _lib
    if _lib is None:
        from pygcn_tpu_torch.ops.cuda import build

        build.build(["colpanel_spmm"])
        lib = ctypes.CDLL(str(build.library_path("colpanel_spmm")))
        lib.colpanel_spmm_f32.argtypes = (
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
            + [ctypes.c_int, ctypes.c_void_p])
        lib.colpanel_spmm_f32.restype = ctypes.c_int
        lib.colpanel_spmm_config.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        lib.colpanel_spmm_config.restype = ctypes.c_int
        ref, part = ctypes.c_int(), ctypes.c_int()
        lib.colpanel_spmm_config(ctypes.byref(ref), ctypes.byref(part))
        if (ref.value, part.value) != (REF_INTS, PART_INTS):
            raise RuntimeError(f"library built for references of {ref.value} ints and parts of "
                               f"{part.value}, wrapper expects {REF_INTS} and {PART_INTS}")
        _lib = lib
    return _lib


@dataclasses.dataclass(frozen=True)
class ColPanelSchedule:
    """E2's schedule over one column-panel layout.

    ``refs[i]`` is ``(slot, table << 16 | length)``: the flat slots ``slot ..
    slot + length - 1`` of bucket table ``table`` (the layout's buckets
    numbered in panel and bucket order), one virtual row's edges. Output row
    ``r``'s references are ``refs[row_ptr[r] .. row_ptr[r + 1] - 1]`` (each
    entry read without its top bit), in panel, bucket and slot order; none
    for a row without edges, which E2 writes as zeros. ``row_ptr[r]`` has its
    top bit set (reads negative) where row ``r`` is a hub row: its
    references are summed by the items of ``parts``, ``(row, first ref, end
    ref, 0, part, first part, parts, 0)`` each, in the row's order; part
    ``i`` writes partial ``i``, and the row is the sum of its partials in
    part order. ``n_cols`` is one past the last column the layout covers.
    """

    row_ptr: torch.Tensor  # [n_rows + 1] int32
    refs: torch.Tensor  # [n_refs, REF_INTS] int32
    parts: torch.Tensor  # [n_parts, PART_INTS] int32
    n_tables: int
    n_cols: int

    @property
    def n_parts(self) -> int:
        return self.parts.shape[0]


def colpanel_schedule(pe) -> ColPanelSchedule:
    """E2's schedule over ``pe`` (:class:`ColPanelSchedule`), from its virtual
    rows' rows (copied to the host once, which waits for the device) and
    lengths (kept on the host) in vectorised NumPy. Each bucket's rows are
    sorted, so a counting sort by row of the panel-major, bucket-order
    sequence of virtual rows gives each row's references in order."""
    ks = [k for fb in pe.panels for k in fb.ks]
    if ks and max(ks) > HUB_SLOTS:
        raise ValueError(f"HUB_SLOTS ({HUB_SLOTS}) is under the widest bucket ({max(ks)})")
    if len(ks) >= 1 << 15:
        raise ValueError(f"{len(ks)} bucket tables: E2 numbers them in 15 bits")
    buckets = []  # (table, rows, virtual-row indices, lengths) of the virtual rows with edges
    for t, (r, n) in enumerate(zip((r for fb in pe.panels for r in fb.rows),
                                   (n for fb in pe.panels for n in fb.lens))):
        n = n.astype(np.int64)
        keep = np.flatnonzero(n > 0)
        buckets.append((t, r.cpu().numpy().astype(np.int64)[keep], keep, n[keep]))
    n_rows = pe.n_rows
    count = np.bincount(np.concatenate([np.zeros(0, np.int64)] + [b[1] for b in buckets]),
                        minlength=n_rows)
    ptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(count, out=ptr[1:])
    n_refs = int(ptr[-1])
    if n_refs >= 1 << 30:
        raise ValueError(f"{n_refs} virtual rows: E2 indexes them in 30 bits")

    # the counting sort: a bucket's virtual rows land after those of the
    # buckets before it, in their order within the bucket (a row split over
    # the widest bucket repeats there, in chunk order)
    fill = ptr[:-1].copy()
    slot, info = np.empty(n_refs, np.int64), np.empty(n_refs, np.int64)
    for t, r, keep, n in buckets:
        if r.size == 0:
            continue
        idx = np.arange(r.size)
        head = np.concatenate([[True], r[1:] != r[:-1]])
        rank = idx - np.maximum.accumulate(np.where(head, idx, 0))
        at = fill[r] + rank
        slot[at] = keep * ks[t]
        info[at] = (t << 16) | n
        fill[r[head]] += np.diff(np.append(idx[head], r.size))
    if n_refs and int(slot.max()) + max(ks) > np.iinfo(np.int32).max:
        raise ValueError("a bucket of over 2**31 slots: E2 indexes slots in 32 bits")

    # hub rows: a reference that starts at slot s of its row goes to part
    # s // HUB_SLOTS; a row with a reference past its first part is cut
    row_of = np.repeat(np.arange(n_rows), count)
    before = np.concatenate([[0], np.cumsum(info & 0xFFFF)])
    part_of = (before[:-1] - before[ptr[row_of]]) // HUB_SLOTS
    split = np.zeros(n_rows, bool)
    split[row_of[part_of > 0]] = True
    opens = np.ones(n_refs, bool)
    opens[1:] = (row_of[1:] != row_of[:-1]) | (part_of[1:] != part_of[:-1])
    begin = np.flatnonzero(opens & split[row_of])
    part_row = row_of[begin]
    end = np.minimum(np.append(begin[1:], n_refs), ptr[part_row + 1])
    first = np.searchsorted(part_row, part_row)
    n_of = np.bincount(part_row, minlength=n_rows)[part_row]
    zero = np.zeros_like(begin)
    parts = np.stack([part_row, begin, end, zero, np.arange(begin.size), first, n_of, zero], 1)

    flagged = ptr.astype(np.uint32)
    flagged[:-1][split] |= np.uint32(_SPLIT)
    return ColPanelSchedule(
        row_ptr=torch.from_numpy(flagged.view(np.int32)),
        refs=torch.from_numpy(np.stack([slot, info], 1).astype(np.int32)),
        parts=torch.from_numpy(parts.astype(np.int32)), n_tables=len(ks),
        n_cols=pe.starts[-1] + pe.widths[-1] if pe.panels else 0)


def _device_schedule(pe, dev):
    """E2's schedule on ``dev``, the buckets' table (the cols pointers, the
    vals pointers and the panel starts) and the arrival counters (one per
    part, zero between launches), built on the first launch over ``pe`` and
    kept in ``pe.cache``; a layout that holds its ``twin``'s columns, rows
    and lengths takes the twin's schedule. The layout's arrays are checked
    once, here."""
    key = "colpanel_spmm"
    if key not in pe.cache:
        fbs = pe.panels
        cols = [c for fb in fbs for c in fb.cols]
        vals = [v for fb in fbs for v in fb.vals]
        ints = [*cols, *(r for fb in fbs for r in fb.rows)]
        tensors = (*ints, *vals)
        if any(t.device != dev for t in tensors):
            raise ValueError(f"E2 needs the layout on {dev}, got "
                             + ", ".join(sorted({str(t.device) for t in tensors})))
        if any(t.dtype != torch.int32 for t in ints):
            raise TypeError("the layout's cols and rows must be int32")
        if any(v.dtype != torch.float32 for v in vals):
            raise TypeError("the layout's vals must be float32")
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("E2 needs a contiguous layout")
        if pe.twin is not None:
            sched = _device_schedule(pe.twin, dev)[0]
        else:
            sched = colpanel_schedule(pe)
            sched = dataclasses.replace(sched, row_ptr=sched.row_ptr.to(dev),
                                        refs=sched.refs.to(dev), parts=sched.parts.to(dev))
        starts = [s for fb, s in zip(fbs, pe.starts) for _ in fb.ks]
        tables = torch.tensor([c.data_ptr() for c in cols] + [v.data_ptr() for v in vals]
                              + starts, dtype=torch.int64)
        counters = torch.zeros(max(sched.n_parts, 1), dtype=torch.int32, device=dev)
        pe.cache[key] = (sched, tables.to(dev), counters)
    return pe.cache[key]


def colpanel_spmm_cuda(pe, x: torch.Tensor) -> torch.Tensor:
    """Launch kernel E2 on the current stream: ``A @ x`` for f32 ``x`` of
    shape ``[n_cols, H]`` on the layout's CUDA device → ``[n_rows, H]`` f32.
    Raises on anything it does not take."""
    global launches
    if x.dim() != 2:
        raise ValueError(f"x must be [n_cols, H], got shape {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"E2 takes float32 x, got {x.dtype}")
    layout_dev = next((c.device for fb in pe.panels for c in fb.cols), x.device)
    if x.device != layout_dev:
        raise ValueError(f"x is on {x.device}, the layout on {layout_dev}")
    if x.device.type != "cuda":
        raise ValueError(f"E2 runs on a CUDA device, not {x.device}")
    sched, tables, counters = _device_schedule(pe, x.device)
    if x.shape[0] < sched.n_cols:
        raise ValueError(f"x has {x.shape[0]} rows; the layout reads {sched.n_cols}")
    lib = _load()
    x = x.contiguous()
    h = x.shape[1]
    out = torch.empty((pe.n_rows, h), dtype=torch.float32, device=x.device)
    if pe.n_rows == 0 or h == 0:
        return out
    ws = (torch.empty((sched.n_parts, h), dtype=torch.float32, device=x.device)
          if sched.n_parts else None)
    with torch.cuda.device(x.device):
        err = lib.colpanel_spmm_f32(
            tables.data_ptr(), sched.n_tables, sched.row_ptr.data_ptr(), sched.refs.data_ptr(),
            pe.n_rows, sched.parts.data_ptr(), sched.n_parts, x.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), counters.data_ptr(), h,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"colpanel_spmm kernel launch failed with CUDA error {err}")
    launches += 1
    return out
