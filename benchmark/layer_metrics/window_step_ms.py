"""``window_step_ms``: the window's seconds over the training steps it
completed, in ms, as ``step_ms`` reads it, in a cell whose step the host
sets: its runs spread with the host's speed, too widely for a bound, so
the number stands here without one."""


def read(ctx):
    return ctx.record["seconds"] / ctx.record["steps"] * 1e3
