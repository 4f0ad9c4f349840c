"""``ell_half_ms``: device ms an epoch of every op the program's ``spmm.ell``
and ``gat.ell`` spans launched (the ELL half of the sparse products and the
GAT's ELL attention residual; forward, backward by its forward op, and
evaluation), attributed by launch (``benchmark/attribution.py``). None
where over 1% of the busy time has no launch record."""

from benchmark.span_passes import half_ms


def read(ctx):
    return half_ms(ctx, ("spmm.ell", "gat.ell"))
