"""Device time by the program's own spans, from one Chrome trace of host and
card together (``torch.profiler`` with CPU and CUDA activities).

- A device op (kernel, copy or fill) belongs to the innermost program span
  open around its host launch on the launching thread. The launch is the
  CUDA runtime (or driver API) call that carries the op's correlation id.
- Where the launch lies inside a backward node (``autograd::engine::
  evaluate_function: ...``) and no span opened inside that node, as on the
  autograd engine's thread, the op takes the span that enclosed the node's
  forward op: the last op outside any backward node to record the node's
  ``Sequence number``.
- A device op with no launch record is unattributed; one launched outside
  every program span is :data:`OUTSIDE`.
- The card's idle gaps in the window go to the innermost program span open,
  on any thread, at each gap's middle (``"none"`` where there is none).
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import Counter, defaultdict

from benchmark.trace import DEVICE_CATS, _device_intervals, _events, _gaps, _union

# the program's spans (``pygcn_tpu_torch/utils/logging.span``)
SPANS = ("train_step", "model.forward", "spmm.ell", "spmm.tile", "gat.ell", "gat.tile",
         "pipeline.locality_order", "pipeline.layouts")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
BACKWARD = "autograd::engine::evaluate_function: "
OUTSIDE = "(outside)"


@dataclasses.dataclass
class Attribution:
    """A window's device ms an epoch by span (:data:`OUTSIDE` for ops
    launched in none), the unattributed and busy ms an epoch, the idle ms an
    epoch by span over the longest gaps, and each span's top device ops."""

    ms: dict
    unattributed_ms: float
    busy_ms: float
    idle_ms: dict
    top: dict


class _Nest:
    """One thread's properly nested intervals ``(start, end, payload)``:
    which is the innermost open at a time."""

    def __init__(self, intervals: list):
        self.items = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
        self.starts = [iv[0] for iv in self.items]
        self.parent = []
        stack = []
        for k, (s, _, _) in enumerate(self.items):
            while stack and self.items[stack[-1]][1] < s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(k)

    def at(self, t: float):
        """The innermost interval open at ``t``, or None."""
        k = bisect.bisect_right(self.starts, t) - 1
        while k >= 0 and self.items[k][1] < t:
            k = self.parent[k]
        return self.items[k] if k >= 0 else None


def _by_thread(events: list) -> dict:
    out = defaultdict(list)
    for e in events:
        out[e["tid"]].append((e["ts"], e["ts"] + e["dur"], e))
    return {tid: _Nest(ivs) for tid, ivs in out.items()}


def attribute(events: list, steps: int, window: str, n_gaps: int = 200) -> Attribution:
    """The :class:`Attribution` of a trace's ``X`` events over ``steps``
    epochs inside the host range named ``window``."""
    host = [e for e in events if e.get("cat") not in DEVICE_CATS]
    spans = _by_thread([e for e in host if e.get("cat") == "user_annotation"
                        and e["name"] in SPANS])
    nodes = _by_thread([e for e in host if e["name"].startswith(BACKWARD)
                        and "Sequence number" in e.get("args", {})])

    def span_at(tid, t):
        return spans[tid].at(t) if tid in spans else None

    # sequence number -> the span around its forward op: the last op outside
    # backward nodes to record the number (an op that makes no node, such as
    # an argmax, records the number the next node will take)
    forward = {}
    for e in sorted(host, key=lambda e: e["ts"]):
        seq = e.get("args", {}).get("Sequence number")
        if (seq is None or e["name"].startswith(BACKWARD)
                or (e["tid"] in nodes and nodes[e["tid"]].at(e["ts"]) is not None)):
            continue
        iv = span_at(e["tid"], e["ts"])
        forward[seq] = iv[2]["name"] if iv else OUTSIDE

    def label(launch):
        tid, t = launch["tid"], launch["ts"]
        iv = span_at(tid, t)
        node = nodes[tid].at(t) if tid in nodes else None
        if node is not None and (iv is None or node[0] > iv[0]):
            return forward.get(node[2]["args"]["Sequence number"], OUTSIDE)
        return iv[2]["name"] if iv else OUTSIDE

    launches = {e["args"]["correlation"]: e for e in host
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    us, unattributed = Counter(), 0.0
    ops = defaultdict(Counter)
    for e in device:
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            unattributed += e["dur"]
            continue
        name = label(launch)
        us[name] += e["dur"]
        ops[name][e["name"]] += e["dur"]
    iv = _device_intervals([(e["name"], e["ts"], e["dur"]) for e in device])
    busy = _union(iv, float(iv[:, 0].min()), float(iv[:, 1].max())) if len(iv) else []
    win = [e for e in host if e["name"] == window and e.get("cat") == "user_annotation"]
    idle = Counter()
    if len(win) == 1:
        lo, hi = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
        gaps = _gaps(_union(iv, lo, hi), lo, hi)
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:n_gaps]:
            mid = (a + b) / 2
            open_ = [s for s in (span_at(tid, mid) for tid in spans) if s is not None]
            inner = max(open_, key=lambda s: s[0])[2]["name"] if open_ else "none"
            idle[inner] += (b - a) / 1e3 / steps
    per_step = 1e3 * steps
    return Attribution(
        ms={k: v / per_step for k, v in us.most_common()},
        unattributed_ms=unattributed / per_step,
        busy_ms=sum(e - s for s, e in busy) / per_step,
        idle_ms=dict(idle.most_common()),
        top={k: [[n[:80], d / per_step] for n, d in c.most_common(3)] for k, c in ops.items()})


def read(path: str, steps: int, window: str, n_gaps: int = 200) -> Attribution:
    return attribute(_events(path), steps, window, n_gaps)
