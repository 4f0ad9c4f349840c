"""``tile_edge_share``: the share of the graph's edges that the hybrid layout
routed to tiles (``graph.hybrid.tile_edges / graph.n_edges``), in %."""


def read(ctx):
    c = ctx.run.counts()
    if c["tile_edges"] is None:
        return None
    return 100.0 * c["tile_edges"] / c["n_edges"]
