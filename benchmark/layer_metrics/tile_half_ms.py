"""``tile_half_ms``: device ms an epoch of every op the program's
``spmm.tile`` and ``gat.tile`` spans launched (kernel B1, or B3/B5/B6, with
their fills and merges; forward, backward by its forward op, and
evaluation), attributed by launch (``benchmark/attribution.py``). None
where over 1% of the busy time has no launch record."""

from benchmark.span_passes import half_ms


def read(ctx):
    return half_ms(ctx, ("spmm.tile", "gat.tile"))
