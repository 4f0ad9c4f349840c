"""``colpanel_buckets``: the bucket products (row chunks of live buckets) the
column-panel SpMM runs in one more epoch, read from the program's counter
``ops/colpanel.bucket_products``. None in a program without the counter, or
where the epoch ran none (a graph under ``COLPANEL_MIN_NODES``)."""

import importlib


def read(ctx):
    colpanel = importlib.import_module("pygcn_tpu_torch.ops.colpanel")
    if not hasattr(colpanel, "bucket_products"):
        return None
    before = colpanel.bucket_products
    ctx.run.epoch()
    return (colpanel.bucket_products - before) or None
