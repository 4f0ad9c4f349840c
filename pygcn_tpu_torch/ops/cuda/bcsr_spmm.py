"""Kernels B1 and B2: block-sparse SpMM ``y = A @ x`` over BCSR tiles.

B1 replaces the TPU kernel ``pygcn_tpu/ops/pallas/bcsr_spmm.py:_kernel``
(through its wrappers ``bcsr_spmm`` and ``bcsr_spmm_vjp``); B2 replaces its
``_kernel_stream`` together with the ``segment_sum`` that merges the per-tile
parts. :data:`BCSR_STREAM` picks B2, as the JAX package's flag of the same
name does. Both are written for the H100 in ``pygcn_tpu_torch/csrc/bcsr_spmm.cu``,
which carries the design note.

What bounds them: at the ogbn-arxiv hybrid's shapes (2863 f32 tiles about 7%
full, H = 128) the function moves 0.36 GB, 0.108 ms at 3.35 TB/s, and its
2·nnz·H products take 0.01 ms: bytes. Multiplying whole tiles is 12 GFLOP, so
both kernels run the products on the tensor cores in 3xTF32 (each f32 operand
split into two TF32 halves, three MMAs, f32 accuracy), or one bf16 MMA for
bf16 tiles, and each CTA covers up to 128 columns so each tile is read once.

- B1 runs a balanced schedule (:func:`spmm_schedule`): each block row's tiles
  are cut into work items of at most :data:`MAX_TILES`, one CTA each, so the
  longest block row no longer sets the launch's tail. A row of one item
  writes its output block once; the items of a longer row write partial
  blocks to a workspace and the last to arrive sums them in item order.
  B1 is deterministic: the same bits every run. The schedule is built once
  per tile set and kept in ``bcsr.cache``; a launch never waits for the host.
- B2 keeps one CTA per tile and adds each tile's product into the
  zero-filled output with four-wide f32 atomic reductions, so it writes no
  ``[T, 128, H]`` parts and runs no separate merge. The order of its sums
  varies from run to run (within 1e-4 of the plain version).

:func:`bcsr_spmm` picks the path by the device of ``x``: a CPU tensor runs
the plain version, a CUDA tensor runs the kernel or raises, and any other
device raises. ``launches`` counts B1's launches, ``stream_launches`` B2's.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from pygcn_tpu_torch.graph.graph import BCSR, Graph

# The tile shape the kernel is compiled for, and the ints of one work item
# (checked against the library).
TILE = (128, 128)
ITEM_INTS = 6

# The JAX package's A/B flag (``pygcn_tpu/ops/pallas/bcsr_spmm.py:47``), with
# its default, read at each call: True runs B2 instead of B1.
BCSR_STREAM = False

# The most tiles one work item of B1 takes (C). Picked from a sweep over
# {2, 4, 8} at the ogbn-arxiv hybrid on an H100 (``chip_smoke.py`` times it;
# PERF.md): 2 was the fastest at H = 128 and 40.
MAX_TILES = 2

# Kernel launches since import (or since a caller reset them to 0): B1, B2.
launches = 0
stream_launches = 0

_lib = None


def _load():
    global _lib
    if _lib is None:
        from pygcn_tpu_torch.ops.cuda import build

        build.build(["bcsr_spmm"])
        lib = ctypes.CDLL(str(build.library_path("bcsr_spmm")))
        for name in ("bcsr_spmm_f32", "bcsr_spmm_bf16"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for name in ("bcsr_spmm_stream_f32", "bcsr_spmm_stream_bf16"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.bcsr_spmm_tile.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
        lib.bcsr_spmm_tile.restype = ctypes.c_int
        tm, tk, item = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        lib.bcsr_spmm_tile(ctypes.byref(tm), ctypes.byref(tk), ctypes.byref(item))
        if (tm.value, tk.value, item.value) != (*TILE, ITEM_INTS):
            raise RuntimeError(f"library built for {(tm.value, tk.value)} tiles and "
                               f"{item.value}-int work items, wrapper expects {TILE} "
                               f"and {ITEM_INTS}")
        _lib = lib
    return _lib


@dataclasses.dataclass(frozen=True)
class SpMMSchedule:
    """B1's work items over one tile set.

    ``items[i]`` is ``(begin, end, row, slot, first, parts)``: item ``i``
    multiplies tiles ``begin .. end - 1`` of block row ``row``. A block row of
    one item (at most ``max_tiles`` tiles, or none) has ``slot = first = -1``
    and ``parts = 1`` and writes its output block itself. The ``parts`` items
    of a longer row write partial blocks to workspace slots ``first ..
    first + parts - 1`` (item ``i`` to ``slot``), in item order, and their sum
    is the row's output.
    """

    items: torch.Tensor  # [n_items, ITEM_INTS] int32
    n_slots: int  # partial blocks: the items of rows split into several


def spmm_schedule(bcsr: BCSR, max_tiles: int) -> SpMMSchedule:
    """Cut each block row's tile run into items of at most ``max_tiles``
    consecutive tiles (a row without tiles gets one empty item), in block-row
    order. Plain NumPy on ``block_row_ptr``, on the CPU; a CUDA tile set's
    pointer is copied to the host once, which waits for the device."""
    if max_tiles < 1:
        raise ValueError(f"max_tiles must be >= 1, got {max_tiles}")
    ptr = bcsr.block_row_ptr.cpu().numpy().astype(np.int64)
    per_row = np.maximum(1, -(-np.diff(ptr) // max_tiles))  # items of each row
    n_items = int(per_row.sum())
    row = np.repeat(np.arange(bcsr.n_block_rows), per_row)
    part = np.arange(n_items) - np.repeat(np.cumsum(per_row) - per_row, per_row)
    begin = ptr[row] + part * max_tiles
    end = np.minimum(begin + max_tiles, ptr[row + 1])
    split = per_row[row] > 1
    slot = np.full(n_items, -1)
    slot[split] = np.arange(int(split.sum()))
    first = np.where(split, slot - part, -1)
    items = np.stack([begin, end, row, slot, first, per_row[row]], axis=1)
    return SpMMSchedule(items=torch.from_numpy(items.astype(np.int32)), n_slots=int(split.sum()))


def _device_schedule(bcsr: BCSR, h: int) -> tuple[SpMMSchedule, torch.Tensor]:
    """B1's schedule at :data:`MAX_TILES` on the tiles' device and its int32
    arrival counters (zero between launches, at least one per split item and
    64 columns of ``h``), built on the first launch over ``bcsr`` and kept in
    ``bcsr.cache``."""
    key = ("bcsr_spmm", MAX_TILES)
    dev = bcsr.block_row_ptr.device
    if key not in bcsr.cache:
        sched = spmm_schedule(bcsr, MAX_TILES)
        bcsr.cache[key] = (dataclasses.replace(sched, items=sched.items.to(dev)),
                           torch.zeros(0, dtype=torch.int32, device=dev))
    sched, counters = bcsr.cache[key]
    need = sched.n_slots * -(-h // 64)
    if counters.numel() < need:
        counters = torch.zeros(need, dtype=torch.int32, device=dev)
        bcsr.cache[key] = (sched, counters)
    return sched, counters


def _check(bcsr: BCSR, x: torch.Tensor, n_rows: int) -> None:
    if x.dim() != 2:
        raise ValueError(f"x must be [n_cols, H], got shape {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if bcsr.data.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"tiles must be float32 or bfloat16, got {bcsr.data.dtype}")
    if x.shape[0] > bcsr.n_block_cols * bcsr.tk:
        raise ValueError(f"x has {x.shape[0]} rows; the tiles cover "
                         f"{bcsr.n_block_cols * bcsr.tk}")
    if n_rows > bcsr.n_block_rows * bcsr.tm:
        raise ValueError(f"n_rows={n_rows} exceeds the tiles' "
                         f"{bcsr.n_block_rows * bcsr.tm} rows")


def sum_by_block_row(parts: torch.Tensor, bcsr: BCSR, n_rows: int) -> torch.Tensor:
    """Merge per-tile blocks ``[T, tm, W]`` into their block rows → ``[n_rows, W]``.

    ``index_add_`` by ``block_rows``, as the JAX package's ``segment_sum``
    over the tiles' row ids: rows of block rows that own no tile come out
    zero. Plain PyTorch, on the CPU and the card alike.
    """
    out = parts.new_zeros((bcsr.n_block_rows, bcsr.tm, parts.shape[2]))
    out.index_add_(0, bcsr.block_rows.long(), parts)
    return out.view(-1, parts.shape[2])[:n_rows]


def bcsr_spmm_stream_plain(bcsr: BCSR, x: torch.Tensor) -> torch.Tensor:
    """The per-tile products of ``_kernel_stream``, plain PyTorch: gather x
    slabs ``[T, tk, H]`` by block column and ``bmm`` them with the tiles →
    parts ``[T, tm, H]``.

    bf16 tiles round x to bf16 first and sum in f32, as the kernels do.
    """
    _check(bcsr, x, 0)
    tk = bcsr.tk
    h = x.shape[1]
    if bcsr.data.dtype == torch.bfloat16:
        x = x.to(torch.bfloat16).float()
    xp = torch.nn.functional.pad(x, (0, 0, 0, bcsr.n_block_cols * tk - x.shape[0]))
    slabs = xp.view(bcsr.n_block_cols, tk, h).index_select(0, bcsr.block_cols)
    return torch.bmm(bcsr.data.float(), slabs)


def bcsr_spmm_plain(bcsr: BCSR, x: torch.Tensor, *, n_rows: int) -> torch.Tensor:
    """B1's and B2's plain PyTorch version: the per-tile parts, merged by block row."""
    _check(bcsr, x, n_rows)
    return sum_by_block_row(bcsr_spmm_stream_plain(bcsr, x), bcsr, n_rows)


def _check_cuda(name: str, bcsr: BCSR, x: torch.Tensor) -> None:
    """What kernel ``name`` needs beyond :func:`_check`."""
    tensors = (bcsr.data, bcsr.block_rows, bcsr.block_cols, bcsr.block_row_ptr, x)
    if any(t.device != x.device for t in tensors) or x.device.type != "cuda":
        raise ValueError(f"{name} needs the tiles and x on one CUDA device, got "
                         + ", ".join(str(t.device) for t in tensors))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous tiles, indices and x")
    if any(t.dtype != torch.int32 for t in tensors[1:4]):
        raise TypeError("block_cols, block_rows and block_row_ptr must be int32")
    # Shapes only: checking the indices' values would wait for the device.
    # They come from _build_bcsr, which sorts tiles by block row.
    if bcsr.block_row_ptr.numel() != bcsr.n_block_rows + 1:
        raise ValueError("block_row_ptr must have n_block_rows + 1 entries")
    if not bcsr.block_cols.numel() == bcsr.block_rows.numel() == bcsr.data.shape[0]:
        raise ValueError("block_rows and block_cols must have one entry per tile")
    if (bcsr.tm, bcsr.tk) != TILE:
        raise ValueError(f"kernel is built for {TILE} tiles, got {(bcsr.tm, bcsr.tk)}")
    if bcsr.data.data_ptr() % 16:
        raise ValueError("tiles must be 16-byte aligned (16-byte cp.async loads)")


def bcsr_spmm_cuda(bcsr: BCSR, x: torch.Tensor, *, n_rows: int) -> torch.Tensor:
    """Launch kernel B1 on the current stream; raises on anything it does not take."""
    global launches
    _check(bcsr, x, n_rows)
    _check_cuda("bcsr_spmm_cuda", bcsr, x)
    lib = _load()
    h = x.shape[1]
    out = torch.empty((n_rows, h), dtype=torch.float32, device=x.device)
    if n_rows == 0 or h == 0:
        return out
    sched, counters = _device_schedule(bcsr, h)
    ws = (torch.empty((sched.n_slots, bcsr.tm, h), dtype=torch.float32, device=x.device)
          if sched.n_slots else None)
    fn = lib.bcsr_spmm_bf16 if bcsr.data.dtype == torch.bfloat16 else lib.bcsr_spmm_f32
    with torch.cuda.device(x.device):
        err = fn(bcsr.data.data_ptr(), bcsr.block_cols.data_ptr(), sched.items.data_ptr(),
                 x.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(),
                 counters.data_ptr(), sched.items.shape[0], sched.n_slots, n_rows,
                 x.shape[0], h, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"bcsr_spmm kernel launch failed with CUDA error {err}")
    launches += 1
    return out


def bcsr_spmm_stream_cuda(bcsr: BCSR, x: torch.Tensor, *, n_rows: int) -> torch.Tensor:
    """Launch kernel B2 on the current stream → ``[n_rows, H]``: a zero fill,
    then every tile's product added in. Raises on anything it does not take."""
    global stream_launches
    _check(bcsr, x, n_rows)
    _check_cuda("bcsr_spmm_stream_cuda", bcsr, x)
    lib = _load()
    t, h = bcsr.data.shape[0], x.shape[1]
    out = torch.zeros((n_rows, h), dtype=torch.float32, device=x.device)
    if t == 0 or n_rows == 0 or h == 0:
        return out
    bf16 = bcsr.data.dtype == torch.bfloat16
    fn = lib.bcsr_spmm_stream_bf16 if bf16 else lib.bcsr_spmm_stream_f32
    with torch.cuda.device(x.device):
        err = fn(bcsr.data.data_ptr(), bcsr.block_rows.data_ptr(), bcsr.block_cols.data_ptr(),
                 x.data_ptr(), out.data_ptr(), t, n_rows, x.shape[0], h,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"bcsr_spmm stream kernel launch failed with CUDA error {err}")
    stream_launches += 1
    return out


def _pick(plain, cuda, x: torch.Tensor):
    if x.device.type == "cpu":
        return plain
    if x.device.type == "cuda":
        return cuda
    raise ValueError(f"bcsr_spmm runs on cpu (plain) or cuda (kernel), not {x.device}")


def bcsr_spmm_stream(bcsr: BCSR, x: torch.Tensor, *, n_rows: int) -> torch.Tensor:
    """B2: ``A @ x`` → ``[n_rows, H]``; on the CPU the plain per-tile parts
    merged by :func:`sum_by_block_row`."""
    return _pick(bcsr_spmm_plain, bcsr_spmm_stream_cuda, x)(bcsr, x, n_rows=n_rows)


def bcsr_spmm(bcsr: BCSR, x: torch.Tensor, *, n_rows: int) -> torch.Tensor:
    """``A @ x`` with ``A`` in BCSR tiles: ``x [n_cols, H]`` f32 → ``[n_rows, H]`` f32.

    B1, or with :data:`BCSR_STREAM` B2.
    """
    if BCSR_STREAM:
        return bcsr_spmm_stream(bcsr, x, n_rows=n_rows)
    return _pick(bcsr_spmm_plain, bcsr_spmm_cuda, x)(bcsr, x, n_rows=n_rows)


class BCSRSpMM(torch.autograd.Function):
    """``graph.bcsr @ x``; backward runs ``bcsr_t`` (``bcsr`` when symmetric).

    With ``transpose=True`` the two swap: ``graph.bcsr_t @ x`` forward and
    ``graph.bcsr`` in the backward (``spmm_t``).
    """

    @staticmethod
    def forward(ctx, x, graph: Graph, transpose: bool = False):
        ctx.graph, ctx.transpose = graph, transpose
        return bcsr_spmm(_tiles(graph, transpose), x.contiguous(), n_rows=graph.n_nodes)

    @staticmethod
    def backward(ctx, g):
        tiles = _tiles(ctx.graph, not ctx.transpose)
        return bcsr_spmm(tiles, g.contiguous(), n_rows=ctx.graph.n_nodes), None, None


def _tiles(graph: Graph, transpose: bool) -> BCSR:
    if graph.is_symmetric or not transpose:
        return graph.bcsr
    if graph.bcsr_t is None:
        raise ValueError("asymmetric graph has no transpose BCSR layout (bcsr_t)")
    return graph.bcsr_t
