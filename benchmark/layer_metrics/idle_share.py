"""``idle_share``: the share of an epoch's wall time in which the card ran
nothing: one less the card's busy time an epoch in the device trace (the
union of its kernels, copies and fills) over the unprofiled window's
``step_ms``, in %. The profiled epochs' own wall time is not the base:
recording each launch slows the host, which stretches a host-bound epoch
(the GAT's 1,248 launches) and its gaps."""


def read(ctx):
    if not ctx.trace.records:
        return None
    step_s = ctx.record["seconds"] / ctx.record["steps"]
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.steps / step_s)
