"""Metrics logging and tracing.

The port of ``pygcn_tpu/utils/logging.py``: a structured ``MetricsLogger``
(stdout and an optional JSONL file, the same records as the JAX package's),
a ``timed`` context, and :func:`trace`, a ``torch.profiler`` trace of a
region in place of JAX's ``tpu_trace``. The reference's observability is
bare ``print`` and ``time.time()`` deltas (e.g.
``pygcn/gnn-over-mlp.py:400,429``).
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Optional


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


@contextlib.contextmanager
def timed(label: str, echo: bool = True):
    t0 = time.perf_counter()
    yield
    if echo:
        print(f"[timed] {label}: {time.perf_counter() - t0:.3f}s", flush=True)


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Trace a region with ``torch.profiler`` (the CPU, and the card when
    there is one) into ``log_dir`` as a TensorBoard trace; nothing when
    ``log_dir`` is unset."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
