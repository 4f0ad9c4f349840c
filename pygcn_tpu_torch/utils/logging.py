"""Metrics logging and the program's spans.

The port of ``pygcn_tpu/utils/logging.py``: a structured ``MetricsLogger``
(stdout and an optional JSONL file, the same records as the JAX package's),
and :func:`span`, a named range around one layer of the main path (the step,
the model's forward, the ELL and tile halves of the sparse products, the
host pipeline). A span costs one check when nothing listens; under
``torch.profiler`` it is a ``record_function`` range in the profiler's trace;
under :func:`recording` it appends one :class:`SpanRecord`, stamped on the
wall clock that the profiler's Chrome trace also keeps
(``ts * 1000 + baseTimeNanoseconds``), so that recorded spans lie over a
device trace. The reference's observability is bare ``print`` and
``time.time()`` deltas (e.g. ``pygcn/gnn-over-mlp.py:400,429``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
from typing import Optional

import torch
from torch._C._autograd import _profiler_enabled


class MetricsLogger:
    def __init__(self, jsonl_path: Optional[str] = None, echo: bool = True):
        self.jsonl_path = jsonl_path
        self.echo = echo
        self._fh = open(jsonl_path, "a") if jsonl_path else None

    def log(self, step: int, **metrics) -> None:
        rec = {"step": int(step), "time": time.time(), **{
            k: (float(v) if hasattr(v, "__float__") else v) for k, v in metrics.items()
        }}
        if self.echo:
            parts = " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                             for k, v in rec.items() if k != "time")
            print(parts, flush=True)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


@dataclasses.dataclass(eq=False, slots=True)
class SpanRecord:
    """One span as :func:`recording` keeps it: its name, the span it opened
    inside on the same thread (None at the top), the thread's native id (the
    ``tid`` of a Chrome trace), and its start and end in ns on the wall clock
    (``end_ns`` None while it is open)."""

    name: str
    parent: Optional["SpanRecord"] = dataclasses.field(repr=False)
    thread: int
    start_ns: int
    end_ns: Optional[int] = None


_recorders: list = []  # the record lists of the open recording() blocks
_open = threading.local()  # .stack: this thread's open SpanRecords
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager around one layer's work, named ``name``.

    With no recorder open and the profiler off it is one shared no-op
    context: a check, no allocation."""
    if not _recorders and not _profiler_enabled():
        return _OFF
    return _span(name)


@contextlib.contextmanager
def _span(name: str):
    with torch.profiler.record_function(name) if _profiler_enabled() else _OFF:
        if not _recorders:
            yield
            return
        stack = _open.__dict__.setdefault("stack", [])
        rec = SpanRecord(name, stack[-1] if stack else None, threading.get_native_id(),
                         time.time_ns())
        stack.append(rec)
        for records in _recorders:
            records.append(rec)
        try:
            yield
        finally:
            rec.end_ns = time.time_ns()
            stack.pop()


@contextlib.contextmanager
def recording():
    """Record every span opened inside, on any thread; yields the list of
    :class:`SpanRecord` in the order they opened. The records stay the
    caller's; nothing is kept once the block ends."""
    records: list = []
    _recorders.append(records)
    try:
        yield records
    finally:
        _recorders[:] = [r for r in _recorders if r is not records]
