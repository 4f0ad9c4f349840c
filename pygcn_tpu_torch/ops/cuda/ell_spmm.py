"""Kernel E1: the ELL half's SpMM ``y = A @ x`` over the bucketed ELL layout
(``ops/ell.py``) in one pass.

E1 replaces no TPU kernel: the JAX package leaves this product to XLA
(``pygcn_tpu/ops/ell.py:159 ell_spmm_raw``, a ``take`` and a
``segment_sum``). It replaces the plain version's chain, per bucket an
``index_select``, a product by the values, a sum over the slots and an
``index_add_`` into a zero-filled output, with one launch that gathers,
weights and sums each virtual row in f32 registers and writes each output
row once. Written for the H100 in ``pygcn_tpu_torch/csrc/ell_spmm.cu``,
which carries the design note and the bound (bytes).

:func:`ell_schedule` builds E1's work items from a layout: one per virtual
row that holds edges, with its length (``ell.lens``, counted by the layout's
builder), so that the padding is never read; rows without edges get an item
that writes zeros; a row split over several virtual rows writes partials that
the last of them to arrive sums in part order. Built once per layout on the
first launch and kept in ``ell.cache``.

:func:`ell_spmm_cuda` launches E1 on a CUDA f32 ``x`` and raises on anything
else; ``ops/ell.ell_spmm_raw`` picks it by ``x``'s device. ``launches`` counts
its launches.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

# The ints of one work item, checked against the library.
ITEM_INTS = 8

# Kernel launches since import (or since a caller reset them to 0).
launches = 0

_lib = None


def _load():
    global _lib
    if _lib is None:
        from pygcn_tpu_torch.ops.cuda import build

        build.build(["ell_spmm"])
        lib = ctypes.CDLL(str(build.library_path("ell_spmm")))
        lib.ell_spmm_f32.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                      ctypes.c_longlong] + [ctypes.c_void_p] * 4
                                     + [ctypes.c_int, ctypes.c_void_p])
        lib.ell_spmm_f32.restype = ctypes.c_int
        lib.ell_spmm_config.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.ell_spmm_config.restype = ctypes.c_int
        item = ctypes.c_int()
        lib.ell_spmm_config(ctypes.byref(item))
        if item.value != ITEM_INTS:
            raise RuntimeError(f"library built for work items of {item.value} ints, wrapper "
                               f"expects {ITEM_INTS}")
        _lib = lib
    return _lib


@dataclasses.dataclass(frozen=True)
class ELLSchedule:
    """E1's work items over one ELL layout.

    ``items[i]`` is ``(bucket, slot, length, row, part, first, parts, 0)``:
    item ``i`` sums the flat slots ``slot .. slot + length - 1`` of bucket
    ``bucket``'s ``cols``/``vals`` (one virtual row's edges) into output row
    ``row``. A row of one item, or of none (an item of length 0 writes its
    zeros), has ``part = first = -1`` and ``parts = 1``. The ``parts`` items
    of a row split over several virtual rows write partials ``first .. first
    + parts - 1`` (item ``i`` to ``part``), in the row's chunk order, and
    their sum in that order is the row. Items run the widest bucket first.
    ``n_cols`` is one past the largest column the layout reads.
    """

    items: torch.Tensor  # [n_items, ITEM_INTS] int32
    n_parts: int
    n_cols: int


def ell_schedule(ell) -> ELLSchedule:
    """E1's work items over ``ell`` (:class:`ELLSchedule`), from its virtual
    rows' lengths (``ell.lens``, which the layout's builder counts) and
    rows. These are copied to the host once (which waits for the device) and
    the items built in NumPy."""
    ks = ell.ks
    widest_first = range(len(ks) - 1, -1, -1)
    lens = {j: ell.lens[j].cpu().numpy().astype(np.int64) for j in widest_first}
    rows = {j: ell.rows[j].cpu().numpy().astype(np.int64) for j in widest_first}
    bucket = np.concatenate([np.full(rows[j].size, j, np.int64) for j in widest_first])
    slot = np.concatenate([np.arange(rows[j].size, dtype=np.int64) * ks[j]
                           for j in widest_first])
    length = np.concatenate([lens[j] for j in widest_first])
    row = np.concatenate([rows[j] for j in widest_first])
    keep = length > 0
    bucket, slot, length, row = bucket[keep], slot[keep], length[keep], row[keep]

    count = np.bincount(row, minlength=ell.n_rows)
    empty = np.flatnonzero(count[:ell.n_rows] == 0)  # rows without edges: zeros
    zeros = np.zeros(empty.size, np.int64)
    bucket, slot = np.concatenate([bucket, zeros]), np.concatenate([slot, zeros])
    length, row = np.concatenate([length, zeros]), np.concatenate([row, empty])

    parts = np.maximum(count[row], 1)
    split = np.flatnonzero(parts > 1)
    split = split[np.argsort(row[split], kind="stable")]  # by row, each in chunk order
    part = np.full(row.size, -1, np.int64)
    first = np.full(row.size, -1, np.int64)
    part[split] = np.arange(split.size)
    first[split] = np.searchsorted(row[split], row[split])
    items = np.stack([bucket, slot, length, row, part, first, parts, np.zeros_like(row)], 1)
    n_cols = max((int(c.max()) + 1 for c in ell.cols if c.numel()), default=0)
    return ELLSchedule(items=torch.from_numpy(items.astype(np.int32)), n_parts=int(split.size),
                       n_cols=n_cols)


def _device_schedule(ell):
    """E1's schedule on the layout's device, the buckets' pointer table and
    the arrival counters (one per part, zero between launches), built on the
    first launch over ``ell`` and kept in ``ell.cache``. The layout's arrays
    are checked once, here."""
    key = "ell_spmm"
    if key not in ell.cache:
        tensors = (*ell.cols, *ell.vals, *ell.rows, *ell.lens)
        dev = ell.cols[0].device
        if dev.type != "cuda" or any(t.device != dev for t in tensors):
            raise ValueError("E1 needs the layout on one CUDA device, got "
                             + ", ".join(sorted({str(t.device) for t in tensors})))
        if any(t.dtype != torch.int32 for t in (*ell.cols, *ell.rows, *ell.lens)):
            raise TypeError("the layout's cols, rows and lens must be int32")
        if any(v.dtype != torch.float32 for v in ell.vals):
            raise TypeError("the layout's vals must be float32")
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("E1 needs a contiguous layout")
        sched = ell_schedule(ell)
        tables = torch.tensor([c.data_ptr() for c in ell.cols] + [v.data_ptr() for v in ell.vals],
                              dtype=torch.int64).to(dev)
        counters = torch.zeros(max(sched.n_parts, 1), dtype=torch.int32, device=dev)
        ell.cache[key] = (dataclasses.replace(sched, items=sched.items.to(dev)), tables, counters)
    return ell.cache[key]


def ell_spmm_cuda(ell, x: torch.Tensor) -> torch.Tensor:
    """Launch kernel E1 on the current stream: ``A @ x`` for f32 ``x`` of
    shape ``[n_cols, H]`` on the layout's CUDA device → ``[n_rows, H]`` f32.
    Raises on anything it does not take."""
    global launches
    if x.dim() != 2:
        raise ValueError(f"x must be [n_cols, H], got shape {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"E1 takes float32 x, got {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"E1 runs on a CUDA device, not {x.device}")
    if x.device != ell.cols[0].device:
        raise ValueError(f"x is on {x.device}, the layout on {ell.cols[0].device}")
    sched, tables, counters = _device_schedule(ell)
    if x.shape[0] < sched.n_cols:
        raise ValueError(f"x has {x.shape[0]} rows; the layout reads {sched.n_cols}")
    lib = _load()
    x = x.contiguous()
    h = x.shape[1]
    out = torch.empty((ell.n_rows, h), dtype=torch.float32, device=x.device)
    n_items = sched.items.shape[0]
    if n_items == 0 or h == 0:
        return out
    ws = torch.empty((sched.n_parts, h), dtype=torch.float32, device=x.device) if sched.n_parts else None
    with torch.cuda.device(x.device):
        err = lib.ell_spmm_f32(tables.data_ptr(), len(ell.ks), sched.items.data_ptr(), n_items,
                               x.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(),
                               counters.data_ptr(), h,
                               torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ell_spmm kernel launch failed with CUDA error {err}")
    launches += 1
    return out
