"""Reading a run's Chrome traces (``torch.profiler``).

The device trace holds the card's activity alone over a few epochs that
start and end on an idle card, so every record in it (kernels, copies,
fills) belongs to those epochs, whatever its device time (the profiler's
fault C8, kernels taken by device time falling outside their steps, cannot
arise). The host trace holds the same epochs again with the host's
operators, inside the ``bench.profile_window`` range; it names what the host
was doing while the card stood idle. Recording the host's operators slows
the host, so only the labels are read from it.
"""

from __future__ import annotations

import dataclasses
import json
from collections import Counter

import numpy as np

WINDOW = "bench.profile_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")

# Kernel-name fragments of each group, tried in order (copied from the
# repo's chip smoke): the adds by index (``index_add_``, ``scatter_reduce_``,
# whose kernel is ``_scatter_gather_elementwise_kernel``, ``segment_reduce``),
# the gathers of ``index_select``, the elementwise passes, the reductions,
# and the GEMMs.
STEP_GROUPS = (("index_add", ("indexFunc", "index_add", "scatter", "segment")),
               ("gather", ("gather", "indexSelect", "index_select")),
               ("elementwise", ("elementwise", "Elementwise")),
               ("reduce", ("reduce_kernel", "Reduce")),
               ("gemm", ("gemm", "Gemm", "xmma", "cutlass", "cublas")))


def group_of(name: str) -> str:
    return next((g for g, frags in STEP_GROUPS if any(f in name for f in frags)), "other")


@dataclasses.dataclass
class Trace:
    """The profiled window: its device records ``(name, start µs, µs)``,
    its length and the card's busy seconds in it, the epochs it holds, and
    its idle gaps labelled by what the host was doing."""

    records: list
    window_s: float
    busy_s: float
    steps: int
    gaps: list  # (label, seconds), longest first

    def ms_per_step(self, match) -> float | None:
        """Device ms a step of the records whose name ``match`` accepts;
        None when there are none."""
        hits = [d for name, _, d in self.records if match(name)]
        return sum(hits) / 1e3 / self.steps if hits else None

    def launches(self, match) -> int:
        return sum(1 for name, _, _ in self.records if match(name))


def _union(intervals: np.ndarray, lo: float, hi: float) -> list:
    """Merged ``[start, end]`` intervals, clipped to ``[lo, hi]``."""
    out = []
    for s, e in intervals[np.argsort(intervals[:, 0])] if len(intervals) else []:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _events(path: str) -> list:
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def _gaps(intervals: list, lo: float, hi: float) -> list:
    """The idle stretches of ``[lo, hi]`` between merged ``intervals``."""
    edges = [lo] + [t for iv in intervals for t in iv] + [hi]
    return [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2) if edges[k + 1] > edges[k]]


def _device_intervals(records: list) -> np.ndarray:
    return np.array([[s, s + d] for _, s, d in records], float).reshape(-1, 2)


def read(profiled: dict, n_gaps: int = 200) -> Trace:
    """The :class:`Trace` of a driver's ``profile`` result: the device
    trace's records and busy time over the host-timed window, and the host
    trace's idle gaps by label."""
    steps = profiled["steps"]
    host = _events(profiled["host_trace"])
    win = [e for e in host if e["name"] == WINDOW and e.get("cat") == "user_annotation"]
    if len(win) != 1:
        raise ValueError(f"{profiled['host_trace']}: expected one {WINDOW} range, "
                         f"found {len(win)}")
    lo, hi = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    host_records = [(e["name"], e["ts"], e["dur"]) for e in host if e.get("cat") in DEVICE_CATS]
    gaps = _gaps(_union(_device_intervals(host_records), lo, hi), lo, hi)
    labels = _label_gaps(host, gaps, n_gaps)
    if profiled["device_trace"] is None:  # no card: the host's window alone
        return Trace([], (hi - lo) / 1e6, 0.0, steps, labels)
    records = [(e["name"], e["ts"], e["dur"]) for e in _events(profiled["device_trace"])
               if e.get("cat") in DEVICE_CATS]
    iv = _device_intervals(records)
    busy = _union(iv, float(iv[:, 0].min()), float(iv[:, 1].max())) if len(iv) else []
    busy_s = sum(e - s for s, e in busy) / 1e6
    return Trace(records, profiled["window_s"], busy_s, steps, labels)


def _label_gaps(events: list, gaps: list, n_gaps: int) -> list:
    """Seconds of idle card by what the host was doing, over the ``n_gaps``
    longest gaps: the innermost host event at each gap's middle, under the
    benchmark's range around it."""
    host = [e for e in events if e.get("cat") in HOST_CATS and e["name"] != WINDOW]
    if not host:
        return []
    starts = np.array([e["ts"] for e in host], float)
    ends = starts + np.array([e["dur"] for e in host], float)
    spans = [k for k, e in enumerate(host) if e["name"].startswith("bench.")]
    by_label = Counter()
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:n_gaps]:
        mid = (a + b) / 2
        inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
        if inside.size == 0:
            label = "none"
        else:
            inner = host[inside[np.argmax(starts[inside])]]["name"]
            outer = [host[k]["name"] for k in spans if starts[k] <= mid <= ends[k]]
            label = f"{outer[0]}/{inner}" if outer and outer[0] != inner else inner
        by_label[label] += float(b - a) / 1e6
    return by_label.most_common()


def top_records(trace: Trace, n: int = 10) -> list:
    """The ``n`` device operations that took most time in the window, in
    seconds."""
    total = Counter()
    for name, _, d in trace.records:
        total[name] += d / 1e6
    return [[name[:120], s] for name, s in total.most_common(n)]
