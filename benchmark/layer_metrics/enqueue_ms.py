"""``enqueue_ms``: host ms an epoch inside the program's ``train_step`` spans
and its ``model.forward`` spans outside any ``train_step`` (the evaluation),
over ``profile_steps`` epochs under the program's recorder with no profiler
running: how long the host takes to hand the card an epoch, the benchmark's
loss read and argmax copy left out. It reads near the step where the
program waits for the card inside a span."""

from benchmark.span_passes import recorded, under


def read(ctx):
    got = recorded(ctx)
    if got is None:
        return None
    records, epochs = got
    ns = [r.end_ns - r.start_ns for r in records if r.name == "train_step"
          or (r.name == "model.forward" and not under(r, "train_step"))]
    return sum(ns) / 1e6 / epochs if ns else None
