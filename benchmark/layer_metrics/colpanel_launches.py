"""``colpanel_launches``: the launches of kernel E2, the column-panel SpMM, in
one more epoch, read from the program's counter
``ops/cuda/colpanel_spmm.launches`` (a GCN epoch: 9, one a product). None in
a program without the module or the counter, or where the epoch launched
none (a graph under ``COLPANEL_MIN_NODES``, or off the card)."""

import importlib


def read(ctx):
    try:
        e2 = importlib.import_module("pygcn_tpu_torch.ops.cuda.colpanel_spmm")
    except ImportError:
        return None
    if not hasattr(e2, "launches"):
        return None
    before = e2.launches
    ctx.run.epoch()
    return (e2.launches - before) or None
