"""``step_mfu``: the operations of a step and its evaluation forward (every
GEMM forward and backward, the sparse products, the attention; counted in
``benchmark/work.py`` from the model's shapes and the graph's edges) over
the unprofiled window's ``step_ms`` times the card's f32 peak, in %."""


def read(ctx):
    if ctx.peak is None:
        return None
    c = ctx.run.counts()
    ops = ctx.run.spec.step_ops(ctx.config, c["n_nodes"], c["n_edges"])
    step_s = ctx.record["seconds"] / ctx.record["steps"]
    return 100.0 * ops / (step_s * ctx.peak["f32_flops_per_s"])
