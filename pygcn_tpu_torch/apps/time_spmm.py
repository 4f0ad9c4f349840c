"""Kernels B1 and B2 timed on the ``--clustered`` flagship's tiles, with and without the longest block row.

Builds the tiles of ``train_fullgraph --clustered`` (169,343 nodes, the hybrid
layout at ``hybrid_min_edges_per_tile=64``) on the card and, at H = 128 and
40, times with CUDA events (mean of 50 calls after warm-up, each twice in
turns):

- ``b1_ms``: kernel B1 (``bcsr_spmm_cuda``), and ``b1_ms_without_longest_row``
  on the same tiles without their longest block row (that row then owns
  none): how much of a launch the longest row sets;
- ``stream_ms``: the stream mode, ``bcsr_spmm`` with ``BCSR_STREAM`` (kernel
  B2 and whatever merge the version runs), with and without that row;
- ``b1_bf16_ms``: B1 on the same tiles stored as bf16, and
  ``empty_16x8_share``: the share of the tiles' 16 x 8 blocks (an f32 MMA's
  A operand) that hold no entry;

beside the bound (:func:`spmm_bound`) and the peak memory above the inputs
of one B1 and one stream call. It prints one JSON line per width. It calls
only what every version of the port has, so an earlier checkout is timed
with the same script, run by path with the package to time first on the
path::

    PYTHONPATH=. python3 pygcn_tpu_torch/apps/time_spmm.py --label new
    PYTHONPATH=<earlier checkout> python3 pygcn_tpu_torch/apps/time_spmm.py --label parent

The module also holds what ``chip_smoke.py`` and the tests share about these
kernels: the bound, the tiles without their longest row, and the long-row
tile set.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and f32
# FLOP/s outside the tensor cores, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

WIDTHS = (128, 40)
ITERS = 50


def without_longest_row(b):
    """Tile set ``b`` with its longest block row's tiles taken out (that row
    then owns none)."""
    per_row = b.block_row_ptr[1:] - b.block_row_ptr[:-1]
    r = int(per_row.argmax())
    keep = b.block_rows != r
    ptr = b.block_row_ptr.clone()
    ptr[r + 1:] -= per_row[r]
    return dataclasses.replace(b, data=b.data[keep].contiguous(),
                               block_rows=b.block_rows[keep].contiguous(),
                               block_cols=b.block_cols[keep].contiguous(), block_row_ptr=ptr)


def spmm_bound(bcsr, n, h):
    """``(bound_ms, bound_by, bytes, flops)`` of ``A @ x`` over ``bcsr`` with
    ``x [n, h]`` f32 → ``[n, h]``: the tiles as stored, the x rows under some
    tile and the output, each moved once, over 3.35 TB/s; one multiply and one
    add per stored nonzero and column, over 67 TFLOP/s f32."""
    n_x_rows = min(n, int(torch.unique(bcsr.block_cols).numel()) * bcsr.tk)
    nbytes = (bcsr.data.numel() * bcsr.data.element_size() + n_x_rows * h * 4 + n * h * 4)
    flops = 2 * int(torch.count_nonzero(bcsr.data)) * h
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations",
            nbytes, flops)


def long_row_counts(c):
    """Tiles per block row of the long-row tile set at B1's ``MAX_TILES`` =
    ``c``: none, one, c and c + 1 (one item, one split), the flagship's
    longest row (43) and two."""
    return (0, 1, c, c + 1, 43, 2)


def long_row_matrix(c, rng):
    """A scipy COO matrix whose block row r has entries (40 random ones each)
    in ``long_row_counts(c)[r]`` of its 44 block columns, with a ragged last
    block row and a ragged last block column (the flagship's x has
    1323 * 128 - 1 rows)."""
    import scipy.sparse as sp

    counts = long_row_counts(c)
    n_rows, n_cols = 128 * len(counts) - 5, 128 * 44 - 1
    rows, cols = [], []
    for r, k in enumerate(counts):
        for bc in rng.choice(44, size=k, replace=False):
            rows.append(r * 128 + rng.integers(0, 128, 40))
            cols.append(bc * 128 + rng.integers(0, 128, 40))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    keep = (rows < n_rows) & (cols < n_cols)
    return sp.coo_matrix((rng.standard_normal(int(keep.sum())).astype(np.float32),
                          (rows[keep], cols[keep])), shape=(n_rows, n_cols))


def long_row_tiles(c, rng, dtype=torch.float32):
    """:func:`long_row_matrix`'s tile set with ``dtype`` tiles; the row
    without tiles has no padding tile. Returns ``(bcsr, n_rows, n_cols)``."""
    from pygcn_tpu_torch.graph.graph import _build_bcsr, drop_zero_tiles

    m = long_row_matrix(c, rng)
    b = drop_zero_tiles(_build_bcsr(m, (128, 128)))
    per_row = tuple(np.diff(b.block_row_ptr.numpy()))
    if per_row != long_row_counts(c):
        raise ValueError(f"long-row tile set has {per_row} tiles per block row, "
                         f"want {long_row_counts(c)}")
    return dataclasses.replace(b, data=b.data.to(dtype)), *m.shape


def _peak_above(fn) -> int:
    """Peak device bytes allocated during ``fn()`` above what was allocated before."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--label", default="", help="a name printed in each row")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("time_spmm times the CUDA device; none is available")
    torch.backends.cuda.matmul.allow_tf32 = False

    from pygcn_tpu_torch.apps.train_fullgraph import clustered_dataset
    from pygcn_tpu_torch.ops.cuda import bcsr_spmm as b1
    from pygcn_tpu_torch.utils.timing import cuda_ms

    graph = clustered_dataset(169_343, 13.3, 40, 128, 0, attention=False).graph
    bcsr = graph.hybrid.bcsr.to("cuda")
    n = graph.n_nodes
    short = without_longest_row(bcsr)
    bf16 = dataclasses.replace(bcsr, data=bcsr.data.to(torch.bfloat16))
    t = bcsr.data.shape[0]
    empty = 1.0 - float((bcsr.data.view(t, 8, 16, 16, 8) != 0).any(dim=4).any(dim=2)
                        .float().mean())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)

    def stream(b, x):
        saved = b1.BCSR_STREAM
        b1.BCSR_STREAM = True
        try:
            return b1.bcsr_spmm(b, x, n_rows=n)
        finally:
            b1.BCSR_STREAM = saved

    rows = []
    for h in WIDTHS:
        x = torch.randn((n, h), device="cuda", generator=gen)
        ref = b1.bcsr_spmm_plain(bcsr, x, n_rows=n)
        for name, got in (("B1", b1.bcsr_spmm_cuda(bcsr, x, n_rows=n)),
                          ("stream", stream(bcsr, x))):
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4, msg=name)
        bound_ms, bound_by, nbytes, flops = spmm_bound(bcsr, n, h)
        row = {"label": args.label, "card": card, "H": h, "tiles": t, "empty_16x8_share": empty,
               "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops}
        timed = {"b1_ms": lambda: b1.bcsr_spmm_cuda(bcsr, x, n_rows=n),
                 "b1_ms_without_longest_row": lambda: b1.bcsr_spmm_cuda(short, x, n_rows=n),
                 "stream_ms": lambda: stream(bcsr, x),
                 "stream_ms_without_longest_row": lambda: stream(short, x),
                 "b1_bf16_ms": lambda: b1.bcsr_spmm_cuda(bf16, x, n_rows=n)}
        # each time twice, in turns, to show the spread
        for _ in range(2):
            for key, fn in timed.items():
                row.setdefault(key + "_runs", []).append(cuda_ms(fn, iters=ITERS))
        for key in timed:
            row[key] = min(row[key + "_runs"])
        row["b1_peak_bytes"] = _peak_above(timed["b1_ms"])
        row["stream_peak_bytes"] = _peak_above(timed["stream_ms"])
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
