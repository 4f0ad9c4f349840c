"""``gat_tile_roofline``: the least time of the tile half's attention in a
step, forward and backward (``benchmark/work.py``), over the device time of
the tile-attention kernels B3/B5/B6 (or their stream modes B4/B5s/B6s), in
%. The kernels are found by their names."""

import sys

from benchmark.work import gat_tile_work, least_seconds

KERNELS = ("gat_fwd_", "gat_bwd_")


def _is_tile_kernel(name):
    return any(k in name for k in KERNELS)


def read(ctx):
    edges = ctx.run.tile_edges()
    kernel_ms = ctx.trace.ms_per_step(_is_tile_kernel)
    if ctx.peak is None or edges is None or kernel_ms is None:
        return None
    launches = ctx.run.spec.tile_launches(ctx.config)
    found = ctx.trace.launches(_is_tile_kernel)
    if found < len(launches) * ctx.trace.steps:
        print(f"gat_tile_roofline: {found} tile-attention launches in {ctx.trace.steps} "
              f"epochs, at least {len(launches)} an epoch expected; not read", file=sys.stderr)
        return None
    least = sum(least_seconds(*gat_tile_work(edges, k, h, f), ctx.peak)[0]
                for k, h, f in launches)
    return 100.0 * least * 1e3 / kernel_ms
