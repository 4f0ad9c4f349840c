"""``locality_order_s``: host seconds of the program's
``pipeline.locality_order`` spans in the set-up's host pipeline, run once
more under the program's recorder after the window
(``benchmark/span_passes.py``)."""

from benchmark.span_passes import seconds_in, setup_recorded


def read(ctx):
    records = setup_recorded(ctx)
    return None if records is None else seconds_in(records, "pipeline.locality_order")
