"""``step_ms``: the window's seconds over the training steps it completed
(each with the evaluation forward its traffic schedules), in ms."""


def read(ctx):
    return ctx.record["seconds"] / ctx.record["steps"] * 1e3
