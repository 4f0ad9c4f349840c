"""``peak_mem_gib``: ``torch.cuda.max_memory_allocated()`` over warm-up and
window, counted from a reset once the graph, weights and inputs were on the
card, in GiB."""


def read(ctx):
    return ctx.peak_bytes / 2**30
