"""Device timing with CUDA events.

Replaces ``pygcn_tpu/utils/benchmark.py:time_chained``: PyTorch returns before
the card finishes, so a host clock measures the enqueue; two CUDA events on
the current stream, around many calls and read after a synchronise, measure
the card. There is no CPU path: timing a device metric on the CPU is refused.
"""

from __future__ import annotations

from typing import Callable

import torch


def cuda_ms(fn: Callable[[], object], *, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn()`` on the current CUDA stream.

    Runs ``warmup`` untimed calls, then ``iters`` calls between two events.
    Raises when no CUDA device is present.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_ms times the CUDA device; none is available")
    if iters < 1:
        raise ValueError("iters must be >= 1")
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
