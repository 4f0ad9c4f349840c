"""Revisit against stream: the two modes of the tile kernels, on one graph and one card.

The port of ``tools/ab_kernel_stream.py``. On the ``--clustered`` flagship
graph of ``train_fullgraph`` (169,343 nodes, locality ordered, the hybrid
layout at ``hybrid_min_edges_per_tile=64``) it runs three operations in each
mode, first with the flags' defaults (``BCSR_STREAM = False``,
``TILE_REVISIT = True``: kernels B1, B3, B5, B6), then with both flipped
(B2, whose merge is fused, and B4, B5s, B6s and their merges):

- ``hybrid_spmm``: ``hybrid_spmm_raw`` at H = ``--spmm_width`` (128);
- ``gat_hybrid_fwd``: the ``gat_conv_hybrid`` forward at ``--heads`` ×
  ``--head_dim`` (8 × 8);
- ``gat_hybrid_step``: its gradient step ``s − 1e-6·∇_s Σ out²``.

Each is timed with CUDA events (mean of ``--iters`` calls after warm-up) and
its peak device memory read with ``torch.cuda.max_memory_allocated``. It
prints one JSON row per (mode, op), then one row with the largest difference
between the two modes' outputs (for the step, between the gradients), also
divided by the largest magnitude of the revisit output, and restores both
flags when it ends. ``--device cpu`` runs the plain versions
and times nothing (``ms`` and the memory fields are null there).

Usage::

    python -m pygcn_tpu_torch.apps.ab_kernel_stream
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from pygcn_tpu_torch.apps.train_fullgraph import clustered_dataset, resolve_device
from pygcn_tpu_torch.ops import gat as gat_ops
from pygcn_tpu_torch.ops.cuda import bcsr_spmm as bsp
from pygcn_tpu_torch.ops.cuda import gat_tile_attn as gta
from pygcn_tpu_torch.ops.hybrid import hybrid_spmm_raw
from pygcn_tpu_torch.utils.timing import cuda_ms

MODES = ("revisit", "stream")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs a CUDA card")
    ap.add_argument("--n_nodes", type=int, default=169_343)
    ap.add_argument("--avg_degree", type=float, default=13.3)
    ap.add_argument("--spmm_width", type=int, default=128)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--head_dim", type=int, default=8)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def _launches() -> dict:
    return {"B1": bsp.launches, "B2": bsp.stream_launches, **gta.launches}


def main(argv=None) -> list:
    """Run the A/B; returns the printed rows."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    data = clustered_dataset(args.n_nodes, args.avg_degree, 40, 128, args.seed, attention=True)
    graph = data.graph
    if graph.hybrid is None or graph.hybrid.bcsr is None:
        raise ValueError("the graph's hybrid layout has no tiles: nothing to compare")
    tiles_t = gat_ops.build_gat_tiles_t(graph).to(device)
    graph = graph.to(device)
    n, h, f = graph.n_nodes, args.heads, args.head_dim
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(n, args.spmm_width))
                         .astype(np.float32)).to(device)
    rng = np.random.default_rng(1)
    s, a_src, a_dst = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device)
                       for shape in ((n, h, f), (h, f), (h, f)))

    def gat_grad():
        v = s.clone().requires_grad_(True)
        out = gat_ops.gat_conv_hybrid(graph, tiles_t, v, a_src, a_dst)
        (g,) = torch.autograd.grad((out ** 2).sum(), v)
        return g

    ops = {
        "hybrid_spmm": lambda: hybrid_spmm_raw(graph.hybrid, x),
        "gat_hybrid_fwd": lambda: gat_ops.gat_conv_hybrid(graph, tiles_t, s, a_src, a_dst),
        "gat_hybrid_step": lambda: s - 1e-6 * gat_grad(),
    }
    compared = {"gat_hybrid_step": gat_grad}  # the output the modes are held to, if not the op's
    rows, outputs = [], {}
    saved = (bsp.BCSR_STREAM, gta.TILE_REVISIT)
    try:
        for mode in MODES:
            bsp.BCSR_STREAM = mode == "stream"
            gta.TILE_REVISIT = mode == "revisit"
            for op, fn in ops.items():
                before = _launches()
                outputs[mode, op] = compared.get(op, fn)()
                row = {"mode": mode, "op": op, "device": str(device),
                       "launches": {k: v - before[k] for k, v in _launches().items()
                                    if v != before[k]},
                       "ms": None, "peak_mem_bytes": None, "resident_mem_bytes": None}
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                    row["resident_mem_bytes"] = torch.cuda.memory_allocated(device)
                    torch.cuda.reset_peak_memory_stats(device)
                    fn()
                    torch.cuda.synchronize(device)
                    row["peak_mem_bytes"] = torch.cuda.max_memory_allocated(device)
                    row["ms"] = cuda_ms(fn, iters=args.iters)
                    row["device"] = torch.cuda.get_device_name(device)
                print(json.dumps(row), flush=True)
                rows.append(row)
    finally:
        bsp.BCSR_STREAM, gta.TILE_REVISIT = saved
    diff = {"op": "max_abs_diff_stream_vs_revisit", "tiles": graph.hybrid.bcsr.data.shape[0]}
    for op in ops:
        ref = outputs["revisit", op]
        diff[op] = float((outputs["stream", op] - ref).abs().max())
        diff[op + "_relative"] = diff[op] / max(float(ref.abs().max()), 1e-30)
    print(json.dumps(diff), flush=True)
    rows.append(diff)
    return rows


if __name__ == "__main__":
    main()
