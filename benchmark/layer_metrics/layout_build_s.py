"""``layout_build_s``: host seconds of the port's pipeline (symmetrise and
normalise, locality order and reorder, ``Graph.from_scipy``'s layouts, the
GAT's edge map and transposed tiles), from the benchmark's span around it."""


def read(ctx):
    return ctx.spans.total("layout_build")
