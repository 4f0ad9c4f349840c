"""``ell_gather_scatter_ms``: device ms a step of the gathers and the adds by
index (the ``gather`` and ``index_add`` groups): the ELL half's
``index_select`` and ``index_add_`` and the GAT residual's."""

from benchmark.trace import group_of


def read(ctx):
    return ctx.trace.ms_per_step(lambda name: group_of(name) in ("gather", "index_add"))
