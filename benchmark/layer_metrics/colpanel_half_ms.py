"""``colpanel_half_ms``: device ms an epoch of every op the program's
``spmm.colpanel`` spans launched (the column-panel products: forward,
backward on the transpose layout, and evaluation), attributed by launch
(``benchmark/colpanel_work.py``). None where over 1% of the busy time has no
launch record, or in a program without the span."""

from benchmark.colpanel_work import half_ms


def read(ctx):
    return half_ms(ctx)
