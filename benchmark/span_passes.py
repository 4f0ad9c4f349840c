"""The passes that read the program's own spans (``pygcn_tpu_torch/utils/
logging.span``) in a traced run on the card, each run once after the window
and kept on the cell's ``Run`` for the readers that share it:

- :func:`attributed`: ``profile_steps`` more epochs under ``torch.profiler``
  (host and card, inside a ``bench.span_window`` range), their device time
  by span (``benchmark/attribution.py``); prints ``idle_by_span`` and
  ``span_device_ms`` to standard error;
- :func:`recorded`: ``profile_steps`` more epochs under the program's
  recorder with no profiler running: the host's own time in each span;
- :func:`setup_recorded`: the cell's ``build_graph`` once more under the
  recorder: the set-up's host pipeline by span. It runs after the window, so
  a first call's one-off costs (imports, loading the native library) fall
  outside it.

A program without the span API (an earlier checkout) gives nothing to read:
each pass then returns None, and so does every reader of it. Off the card
they return None too: the CPU runs of the harness are tests at a cut size.
"""

from __future__ import annotations

import importlib
import json
import sys
import time

from benchmark.harness import ROOT, Spans

WINDOW = "bench.span_window"
OUT = ROOT / "bench_out"  # where the attributed epochs' trace is written


def on_card(ctx) -> bool:
    return ctx.run.device.type == "cuda"


def _cached(ctx, key: str, make):
    cache = ctx.run.__dict__.setdefault("_span_passes", {})
    if key not in cache:
        cache[key] = make(ctx) if on_card(ctx) else None
    return cache[key]


def _recording():
    """The program's recorder, or None in a program without spans."""
    try:
        from pygcn_tpu_torch.utils.logging import recording
    except ImportError:
        return None
    return recording


def _sync(ctx) -> None:
    import torch

    if ctx.run.device.type == "cuda":
        torch.cuda.synchronize(ctx.run.device)


def attributed(ctx):
    """The :class:`~benchmark.attribution.Attribution` of ``profile_steps``
    more epochs, or None."""
    return _cached(ctx, "attributed", _attribute)


def _attribute(ctx):
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark import attribution

    n = ctx.mix["profile_steps"]
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if ctx.run.device.type == "cuda"
                                     else [])
    _sync(ctx)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            for _ in range(n):
                ctx.run.epoch()
            _sync(ctx)
            wall = time.perf_counter() - t0
    _report("profiled", ctx, n, wall)
    OUT.mkdir(parents=True, exist_ok=True)
    path = str(OUT / f"{ctx.cell['name']}.spans.json")
    prof.export_chrome_trace(path)
    a = attribution.read(path, n, WINDOW)
    print("idle_by_span " + json.dumps(a.idle_ms), file=sys.stderr)
    print("span_device_ms " + json.dumps({"busy": a.busy_ms, "unattributed": a.unattributed_ms,
                                          **a.ms}), file=sys.stderr)
    print("span_top_ops " + json.dumps(a.top), file=sys.stderr)
    return a


def half_ms(ctx, names: tuple):
    """Device ms an epoch of the ops attributed to the spans ``names``; None
    without any, or when over 1% of the busy time has no launch record."""
    a = attributed(ctx)
    if a is None or a.unattributed_ms > 0.01 * a.busy_ms:
        return None
    hits = [a.ms[k] for k in names if k in a.ms]
    return sum(hits) if hits else None


def recorded(ctx):
    """``(records, epochs)`` of ``profile_steps`` more epochs under the
    program's recorder, or None."""
    return _cached(ctx, "recorded", _record)


def _record(ctx):
    recording = _recording()
    if recording is None:
        return None
    n = ctx.mix["profile_steps"]
    _sync(ctx)
    with recording() as records:
        t0 = time.perf_counter()
        for _ in range(n):
            ctx.run.epoch()
        _sync(ctx)
        wall = time.perf_counter() - t0
    _report("recorded", ctx, n, wall)
    return records, n


def _report(kind: str, ctx, n: int, wall: float) -> None:
    """What a pass's epochs took on the host clock, beside the window's."""
    step = ctx.record["seconds"] / ctx.record["steps"]
    print(f"{kind} epochs: {n}, {wall / n * 1e3:.3f} ms an epoch against the window's "
          f"{step * 1e3:.3f}", file=sys.stderr)


def setup_recorded(ctx):
    """The records of the cell's ``build_graph`` run once more, or None."""
    return _cached(ctx, "setup", _record_setup)


def _record_setup(ctx):
    recording = _recording()
    if recording is None:
        return None
    mod = importlib.import_module(f"benchmark.drivers.{ctx.mix['driver']}")
    with recording() as records:
        mod.build_graph(ctx.config, ctx.mix, Spans())
    return records


def under(record, name: str) -> bool:
    """Whether ``record`` opened inside a span named ``name``."""
    p = record.parent
    while p is not None and p.name != name:
        p = p.parent
    return p is not None


def seconds_in(records, name: str):
    """Seconds of the spans ``name`` that open inside no other of that name;
    None without any."""
    hits = [r.end_ns - r.start_ns for r in records if r.name == name and not under(r, name)]
    return sum(hits) / 1e9 if hits else None
