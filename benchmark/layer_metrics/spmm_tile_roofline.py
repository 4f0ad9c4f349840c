"""``spmm_tile_roofline``: the least time of the tile half's products in a
step (bytes and operations of the tile-routed edges, ``benchmark/work.py``)
over the device time of kernel B1's launches, in %. B1 is found by its
kernel name."""

import sys

from benchmark.work import least_seconds, spmm_tile_work

B1 = "bcsr_spmm_kernel"


def read(ctx):
    edges = ctx.run.tile_edges()
    kernel_ms = ctx.trace.ms_per_step(lambda name: B1 in name)
    if ctx.peak is None or edges is None or kernel_ms is None:
        return None
    launches = ctx.run.spec.tile_launches(ctx.config)
    found = ctx.trace.launches(lambda name: B1 in name)
    if found != len(launches) * ctx.trace.steps:
        print(f"spmm_tile_roofline: {found} B1 launches in {ctx.trace.steps} epochs, "
              f"{len(launches)} an epoch expected; not read", file=sys.stderr)
        return None
    least = sum(least_seconds(*spmm_tile_work(edges, w, t), ctx.peak)[0] for w, t in launches)
    return 100.0 * least * 1e3 / kernel_ms
