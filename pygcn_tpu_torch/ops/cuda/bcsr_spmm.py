"""Kernel B1: block-sparse SpMM ``y = A @ x`` over BCSR tiles.

Replaces the TPU kernel ``pygcn_tpu/ops/pallas/bcsr_spmm.py:_kernel`` (through
its wrappers ``bcsr_spmm`` and ``bcsr_spmm_vjp``). The CUDA source,
``pygcn_tpu_torch/csrc/bcsr_spmm.cu``, carries the design note: one CTA per
(block row, 64-column slab of H) loops over the row's tiles and writes its
output once, deterministic and without atomics. On an H100 the product at the
ogbn-arxiv hybrid's shapes (H = 128, f32, tiles about 7% full) is bound by
bytes: about 0.11 ms at 3.35 TB/s, where its 2·nnz·H operations take about
0.01 ms. The kernel multiplies whole tiles, about 0.18 ms of f32 FMA work
outside the tensor cores, which keeps it above that bound.

:func:`bcsr_spmm` picks the path by the device of ``x``: a CPU tensor runs
:func:`bcsr_spmm_plain`, a CUDA tensor runs the kernel or raises, and any
other device raises. ``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from pygcn_tpu_torch.graph.graph import BCSR, Graph

# The tile shape the kernel is compiled for (checked against the library).
TILE = (128, 128)

# Kernel launches since import (or since a caller reset it to 0).
launches = 0

_lib = None


def _load():
    global _lib
    if _lib is None:
        from pygcn_tpu_torch.ops.cuda import build

        build.build(["bcsr_spmm"])
        lib = ctypes.CDLL(str(build.library_path("bcsr_spmm")))
        for name in ("bcsr_spmm_f32", "bcsr_spmm_bf16"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.bcsr_spmm_tile.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        lib.bcsr_spmm_tile.restype = ctypes.c_int
        tm, tk = ctypes.c_int(), ctypes.c_int()
        lib.bcsr_spmm_tile(ctypes.byref(tm), ctypes.byref(tk))
        if (tm.value, tk.value) != TILE:
            raise RuntimeError(f"library built for {(tm.value, tk.value)} tiles, "
                               f"wrapper expects {TILE}")
        _lib = lib
    return _lib


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


def bcsr_spmm_plain(bcsr: BCSR, x: torch.Tensor, *, n_rows: int) -> torch.Tensor:
    """The kernel's plain PyTorch version: gather x slabs ``[T, tk, H]`` by
    block column, ``bmm`` with the tiles, ``index_add_`` by block row.

    bf16 tiles round x to bf16 first and sum in f32, as the kernel does.
    """
    _check(bcsr, x, n_rows)
    tm, tk = bcsr.tm, bcsr.tk
    h = x.shape[1]
    if bcsr.data.dtype == torch.bfloat16:
        x = x.to(torch.bfloat16).float()
    xp = torch.nn.functional.pad(x, (0, 0, 0, bcsr.n_block_cols * tk - x.shape[0]))
    slabs = xp.view(bcsr.n_block_cols, tk, h).index_select(0, bcsr.block_cols)
    parts = torch.bmm(bcsr.data.float(), slabs)
    out = torch.zeros((bcsr.n_block_rows, tm, h), dtype=torch.float32, device=x.device)
    out.index_add_(0, bcsr.block_rows, parts)
    return out.view(bcsr.n_block_rows * tm, h)[:n_rows]


def bcsr_spmm_cuda(bcsr: BCSR, x: torch.Tensor, *, n_rows: int) -> torch.Tensor:
    """Launch kernel B1 on the current stream; raises on anything it does not take."""
    global launches
    _check(bcsr, x, n_rows)
    tensors = (bcsr.data, bcsr.block_cols, bcsr.block_row_ptr, x)
    if any(t.device != x.device for t in tensors) or x.device.type != "cuda":
        raise ValueError("bcsr_spmm_cuda needs the tiles and x on one CUDA device, got "
                         + ", ".join(str(t.device) for t in tensors))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("bcsr_spmm_cuda needs contiguous tiles, indices and x")
    if bcsr.block_cols.dtype != torch.int32 or bcsr.block_row_ptr.dtype != torch.int32:
        raise TypeError("block_cols and block_row_ptr must be int32")
    # Shapes only: checking the pointers' values would wait for the device.
    # They come from _build_bcsr, which sorts tiles by block row.
    if bcsr.block_row_ptr.numel() != bcsr.n_block_rows + 1:
        raise ValueError("block_row_ptr must have n_block_rows + 1 entries")
    if bcsr.block_cols.numel() != bcsr.data.shape[0]:
        raise ValueError("block_cols must have one entry per tile")
    if (bcsr.tm, bcsr.tk) != TILE:
        raise ValueError(f"kernel is built for {TILE} tiles, got {(bcsr.tm, bcsr.tk)}")
    if bcsr.data.data_ptr() % (4 * bcsr.data.element_size()):
        raise ValueError("tiles must be aligned to 4 elements (16-byte f32, 8-byte bf16 loads)")
    lib = _load()
    h = x.shape[1]
    out = torch.empty((n_rows, h), dtype=torch.float32, device=x.device)
    if n_rows == 0 or h == 0:
        return out
    fn = lib.bcsr_spmm_bf16 if bcsr.data.dtype == torch.bfloat16 else lib.bcsr_spmm_f32
    with torch.cuda.device(x.device):
        err = fn(bcsr.data.data_ptr(), bcsr.block_cols.data_ptr(),
                 bcsr.block_row_ptr.data_ptr(), x.data_ptr(), out.data_ptr(),
                 bcsr.n_block_rows, n_rows, x.shape[0], h,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"bcsr_spmm kernel launch failed with CUDA error {err}")
    launches += 1
    return out


def bcsr_spmm(bcsr: BCSR, x: torch.Tensor, *, n_rows: int) -> torch.Tensor:
    """``A @ x`` with ``A`` in BCSR tiles: ``x [n_cols, H]`` f32 → ``[n_rows, H]`` f32."""
    if x.device.type == "cpu":
        return bcsr_spmm_plain(bcsr, x, n_rows=n_rows)
    if x.device.type == "cuda":
        return bcsr_spmm_cuda(bcsr, x, n_rows=n_rows)
    raise ValueError(f"bcsr_spmm runs on cpu (plain) or cuda (kernel), not {x.device}")


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
