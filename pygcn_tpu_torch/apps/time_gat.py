"""Times of the GAT tile kernels at head shapes other than the main path's,
on the flagship's tiles (ogbn-arxiv scale, the ``--clustered`` hybrid
layout), on one CUDA card.

- ``WIDTH_SHAPES``: B7, B8 and B9 at the main path's layers (8x8 and 1x40
  at ``--hidden 8``, 8x128 at ``--hidden 128``), at per-head widths between
  40 and one 64-column slab, and above the widths whose rows an H100's shared
  memory held before the chunked kernels (1x160, 1x224); B7's chunked
  kernel (``B7c``) at each of them too, beside the staged one that B7 runs up
  to F = 208; and GAT's backward kernels B5 and B6 and the stream kernels
  B4, B5s and B6s (their merges fused: each gives the merged outputs) at
  each of them, also without the longest block row
  (``ms_without_longest_row_runs``: how much of a launch the 43-tile row's
  tail holds).
- ``HEAD_SHAPES``: B3 and B7 from one head of width 1 up to eight heads: what
  one more head, or a wider one, adds to a launch.
- ``MANY_HEAD_SHAPES``: B3, B4 and B5s at 256 and 512 heads of width 1, more
  heads than their shared memory stages at once (they walk them in groups).

Each kernel is timed twice, the mean of 20 launches after warm-up between
two CUDA events; the backward kernels take the plain forward's ``m``. One
JSON line per kernel and shape, then the card's name and power limit. A
launch that fails is recorded with its error, not timed, and the script then
exits with 1 after the last row. Run on the card from the root of a
checkout::

    PYTHONPATH=. python3 pygcn_tpu_torch/apps/time_gat.py [--label L]

With ``PYTHONPATH=<an earlier checkout>`` the same script times that
checkout's kernels (their wrappers take the same arguments; an earlier B7
without ``chunked`` gives ``B7c`` an error row), so two trees can be
compared back to back on one card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

WIDTH_SHAPES = ((8, 8), (1, 40), (1, 48), (1, 64), (8, 64), (8, 128), (1, 160), (1, 224))
HEAD_SHAPES = ((1, 1), (1, 8), (2, 8), (4, 8), (8, 8), (1, 40), (8, 16))
MANY_HEAD_SHAPES = ((256, 1), (512, 1))
SLOPE = 0.2


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--label", default="", help="a name printed in each row")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("time_gat times the CUDA device; none is available")

    from pygcn_tpu_torch.apps.time_spmm import without_longest_row
    from pygcn_tpu_torch.apps.train_fullgraph import clustered_dataset
    from pygcn_tpu_torch.ops.cuda import gat_tile_attn as gta
    from pygcn_tpu_torch.ops.gat import build_gat_tiles_t
    from pygcn_tpu_torch.utils.timing import cuda_ms

    graph = clustered_dataset(169_343, 13.3, 40, 128, 0, attention=True).graph
    tiles_t = build_gat_tiles_t(graph).to("cuda")
    bcsr = graph.hybrid.bcsr.to("cuda")
    short, short_t = without_longest_row(bcsr), without_longest_row(tiles_t)
    n = graph.n_nodes
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []

    def timed(name, h, f, fn, short_fn=None):
        row = {"label": args.label, "kernel": name, "H": h, "F": f}
        try:
            row["ms_runs"] = [cuda_ms(fn, iters=20) for _ in range(2)]
            if short_fn is not None:
                row["ms_without_longest_row_runs"] = [cuda_ms(short_fn, iters=20)
                                                      for _ in range(2)]
        except (RuntimeError, TypeError) as err:  # a launch refused, or no `chunked`
            row["error"] = str(err)
        print(json.dumps(row), flush=True)
        rows.append(row)

    def v2_operands(h, f):
        sl2, sr2 = (torch.randn(n, h * f, device="cuda", generator=gen) for _ in range(2))
        return sl2, sr2, torch.randn(h, f, device="cuda", generator=gen) / f ** 0.5

    for h, f in WIDTH_SHAPES:
        sl2, sr2, a = v2_operands(h, f)
        m = gta.tile_v2_fwd_plain(bcsr, sl2, sr2, a, h, f, SLOPE)[2]
        dnum, dden = (torch.randn(n, w, device="cuda", generator=gen) for w in (h * f, h))
        bwd = (sl2, sr2, a, m, dnum, dden, h, f, SLOPE)
        timed("B7", h, f, lambda: gta.tile_v2_fwd_cuda(bcsr, sl2, sr2, a, h, f, SLOPE))
        timed("B7c", h, f,
              lambda: gta.tile_v2_fwd_cuda(bcsr, sl2, sr2, a, h, f, SLOPE, chunked=True))
        timed("B8", h, f, lambda: gta.tile_v2_bwd_recv_cuda(bcsr, *bwd))
        timed("B9", h, f, lambda: gta.tile_v2_bwd_send_cuda(tiles_t, *bwd))
        lsrc, ldst = (torch.randn(n, h, device="cuda", generator=gen) for _ in range(2))
        s2 = torch.randn(n, h * f, device="cuda", generator=gen)
        m = gta.tile_fwd_cuda(bcsr, lsrc, ldst, s2, h, f, SLOPE)[2]
        bwd = (lsrc, ldst, s2, m, dnum, dden, h, f, SLOPE)
        timed("B5", h, f, lambda: gta.tile_bwd_dldst_cuda(bcsr, *bwd),
              lambda: gta.tile_bwd_dldst_cuda(short, *bwd))
        timed("B6", h, f, lambda: gta.tile_bwd_sender_cuda(tiles_t, *bwd),
              lambda: gta.tile_bwd_sender_cuda(short_t, *bwd))
        timed("B4", h, f, lambda: gta.tile_fwd_stream_cuda(bcsr, lsrc, ldst, s2, h, f, SLOPE),
              lambda: gta.tile_fwd_stream_cuda(short, lsrc, ldst, s2, h, f, SLOPE))
        timed("B5s", h, f, lambda: gta.tile_bwd_dldst_stream_cuda(bcsr, *bwd),
              lambda: gta.tile_bwd_dldst_stream_cuda(short, *bwd))
        timed("B6s", h, f, lambda: gta.tile_bwd_sender_stream_cuda(tiles_t, *bwd),
              lambda: gta.tile_bwd_sender_stream_cuda(short_t, *bwd))
    for h, f in HEAD_SHAPES:
        lsrc, ldst = (torch.randn(n, h, device="cuda", generator=gen) for _ in range(2))
        s2 = torch.randn(n, h * f, device="cuda", generator=gen)
        timed("B3", h, f, lambda: gta.tile_fwd_cuda(bcsr, lsrc, ldst, s2, h, f, SLOPE))
        sl2, sr2, a = v2_operands(h, f)
        timed("B7", h, f, lambda: gta.tile_v2_fwd_cuda(bcsr, sl2, sr2, a, h, f, SLOPE))
    for h, f in MANY_HEAD_SHAPES:
        lsrc, ldst, s2, dnum, dden = (torch.randn(n, h * f, device="cuda", generator=gen)
                                      for _ in range(5))
        m = gta.tile_fwd_plain(bcsr, lsrc, ldst, s2, h, f, SLOPE)[2]
        bwd = (lsrc, ldst, s2, m, dnum, dden, h, f, SLOPE)
        timed("B3", h, f, lambda: gta.tile_fwd_cuda(bcsr, lsrc, ldst, s2, h, f, SLOPE))
        timed("B4", h, f, lambda: gta.tile_fwd_stream_cuda(bcsr, lsrc, ldst, s2, h, f, SLOPE))
        timed("B5s", h, f, lambda: gta.tile_bwd_dldst_stream_cuda(bcsr, *bwd))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return rows


if __name__ == "__main__":
    failed = [f"{r['kernel']} {r['H']}x{r['F']}" for r in main() if "error" in r]
    if failed:
        sys.exit(f"time_gat: launches failed: {', '.join(failed)}")
