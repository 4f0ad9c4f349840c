"""Where a full-graph GCN training step spends its time on the CUDA card.

Builds the same run as ``train_fullgraph`` (any of its flags; ``--clustered``
for the flagship), warms up, then traces a few training steps with
``torch.profiler`` and prints one JSON line: the host wall time per step (without and with the
profiler), the device time per step summed over kernels, the device's busy
share of the profiled window, and the kernels by device time per step. Needs a CUDA card.

Usage::

    python -m pygcn_tpu_torch.apps.profile_fullgraph --clustered
"""

from __future__ import annotations

import json
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from pygcn_tpu_torch.apps.train_fullgraph import parse_args, prepare, train_step

STEPS = 5
WARMUP = 3


def _kernel_us(evt) -> float:
    """Device microseconds of a kernel event; 0 for host-side operator events."""
    if evt.device_type != torch.autograd.DeviceType.CUDA:
        return 0.0
    return float(evt.self_device_time_total)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if torch.device(args.device).type != "cuda":
        raise SystemExit("profile_fullgraph measures the CUDA device; pass a cuda --device")
    run = prepare(args)

    def step():
        return train_step(run.model, run.opt, run.x, run.labels, run.mask, run.graph)

    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        step()
    torch.cuda.synchronize()
    plain_step_ms = (time.perf_counter() - t0) / STEPS * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels = [(e.key, _kernel_us(e) / STEPS / 1e3, e.count / STEPS)
               for e in prof.key_averages() if _kernel_us(e) > 0]
    kernels.sort(key=lambda k: -k[1])
    device_ms = sum(k[1] for k in kernels)
    step_ms = wall_s / STEPS * 1e3
    out = {
        "device": torch.cuda.get_device_name(0),
        "steps": STEPS,
        "host_ms_per_step": plain_step_ms,
        "host_ms_per_step_profiled": step_ms,
        "device_ms_per_step": device_ms,
        "busy_share": device_ms / step_ms if step_ms else None,
        "tile_frac": run.tile_frac,
        "kernels": [{"name": n[:120], "ms_per_step": ms, "calls_per_step": c}
                    for n, ms, c in kernels[:25]],
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
