"""The work of an epoch's column-panel products and the device time the
program's ``spmm.colpanel`` spans launched, for the ``colpanel_*`` readers.

The work is counted from the graph, not from the layout, so that it reads
the same whatever implements the product: per product at width H the
edges' 8 bytes (an f32 value and an int32 index), every sender row read once
and every receiver row written once at 4·H bytes, and 2 operations per edge
and column (``work.spmm_tile_work`` over the whole graph's edges). A GCN
epoch runs each layer's product forward, its transpose backward and the
evaluation's forward (``models/gcn.tile_launches``).

The device time is read from the trace of ``span_passes.attributed``'s
pass, once more with ``spmm.colpanel`` added to the spans ``attribution.py``
knows (a span it predates); the pass itself, and what the other readers take
from it, stay as they are whichever reader runs first.
"""

from __future__ import annotations

import contextlib

from benchmark import attribution, span_passes
from benchmark.work import TileEdges, least_seconds, spmm_tile_work

SPAN = "spmm.colpanel"


def graph_edges(graph) -> TileEdges:
    """The graph's edges with their distinct senders and receivers."""
    import torch

    e = graph.n_edges
    return TileEdges(e, int(torch.unique(graph.senders[:e]).numel()),
                     int(torch.unique(graph.receivers[:e]).numel()))


def least_ms(edges: TileEdges, products: list, peak: dict) -> float:
    """The least ms of ``products`` (``(width, transpose)`` each) over the
    graph's ``edges``."""
    return 1e3 * sum(least_seconds(*spmm_tile_work(edges, w, t), peak)[0] for w, t in products)


@contextlib.contextmanager
def _with_span():
    known = attribution.SPANS
    attribution.SPANS = known + (SPAN,)
    try:
        yield
    finally:
        attribution.SPANS = known


def half_ms(ctx):
    """Device ms an epoch launched in ``spmm.colpanel`` spans, by launch;
    None without any, or where over 1% of the busy time has no launch
    record."""
    cache = ctx.run.__dict__.setdefault("_span_passes", {})
    if "colpanel" not in cache:
        a = span_passes.attributed(ctx)
        if a is not None:
            with _with_span():
                path = span_passes.OUT / f"{ctx.cell['name']}.spans.json"
                a = attribution.read(str(path), ctx.mix["profile_steps"], span_passes.WINDOW)
        cache["colpanel"] = a
    a = cache["colpanel"]
    if a is None or a.unattributed_ms > 0.01 * a.busy_ms:
        return None
    return a.ms.get(SPAN)
