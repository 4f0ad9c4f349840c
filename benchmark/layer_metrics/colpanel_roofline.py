"""``colpanel_roofline``: the least time of an epoch's column-panel products
(bytes and operations counted from the graph, ``benchmark/colpanel_work.py``)
over ``colpanel_half_ms``, in %."""

from benchmark.colpanel_work import graph_edges, half_ms, least_ms


def read(ctx):
    ms = half_ms(ctx)
    if ctx.peak is None or not ms:
        return None
    products = ctx.run.spec.tile_launches(ctx.config)
    return 100.0 * least_ms(graph_edges(ctx.run.graph), products, ctx.peak) / ms
