"""Where a full-graph GCN, GAT or GATv2 training step spends its time on the CUDA card.

Builds the same run as ``train_fullgraph`` (any of its flags; ``--clustered``
for the flagship), warms up, then traces a few training steps with
``torch.profiler`` and prints one JSON line: the host wall time per step (without and with the
profiler), the device time per step summed over kernels, the device's busy
share of the profiled window, the kernels by device time per step, and the
device memory of one step read phase by phase (``memory_gib``: where its peak
falls). Needs a CUDA card.
``--stream`` (read here, not by ``train_fullgraph``) runs the per-tile kernels:
``BCSR_STREAM = True`` and ``TILE_REVISIT = False`` for the run.

Usage::

    python -m pygcn_tpu_torch.apps.profile_fullgraph --clustered
    python -m pygcn_tpu_torch.apps.profile_fullgraph --clustered --model gat --hidden 8
    python -m pygcn_tpu_torch.apps.profile_fullgraph --clustered --model gatv2 --hidden 8
    python -m pygcn_tpu_torch.apps.profile_fullgraph --clustered --model gat --hidden 8 --stream
"""

from __future__ import annotations

import json
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from pygcn_tpu_torch.apps.train_fullgraph import masked_nll, parse_args, prepare, train_step

STEPS = 5
WARMUP = 3


def _kernel_us(evt) -> float:
    """Device microseconds of a kernel event; 0 for host-side operator events."""
    if evt.device_type != torch.autograd.DeviceType.CUDA:
        return 0.0
    return float(evt.self_device_time_total)


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    stream = "--stream" in argv
    args = parse_args([a for a in argv if a != "--stream"])
    if torch.device(args.device).type != "cuda":
        raise SystemExit("profile_fullgraph measures the CUDA device; pass a cuda --device")
    from pygcn_tpu_torch.ops.cuda import bcsr_spmm, gat_tile_attn

    saved = (bcsr_spmm.BCSR_STREAM, gat_tile_attn.TILE_REVISIT)
    bcsr_spmm.BCSR_STREAM, gat_tile_attn.TILE_REVISIT = stream, not stream
    try:
        return _profile(args, stream)
    finally:
        bcsr_spmm.BCSR_STREAM, gat_tile_attn.TILE_REVISIT = saved


def _profile(args, stream: bool) -> dict:
    run = prepare(args)

    def step():
        return train_step(run.model, run.opt, run.x, run.labels, run.mask, run.graph,
                          **run.fwd_kw)

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
    memory = _memory_phases(run)
    kernels = [(e.key, _kernel_us(e) / STEPS / 1e3, e.count / STEPS)
               for e in prof.key_averages() if _kernel_us(e) > 0]
    kernels.sort(key=lambda k: -k[1])
    device_ms = sum(k[1] for k in kernels)
    step_ms = wall_s / STEPS * 1e3
    out = {
        "device": torch.cuda.get_device_name(0),
        "model": args.model,
        "stream": stream,
        "steps": STEPS,
        "host_ms_per_step": plain_step_ms,
        "host_ms_per_step_profiled": step_ms,
        "device_ms_per_step": device_ms,
        "busy_share": device_ms / step_ms if step_ms else None,
        "tile_frac": run.tile_frac,
        "memory_gib": memory,
        "kernels": [{"name": n[:120], "ms_per_step": ms, "calls_per_step": c}
                    for n, ms, c in kernels[:25]],
    }
    print(json.dumps(out))
    return out


def _memory_phases(run) -> dict:
    """One more training step, taken phase by phase as ``train_step`` runs it,
    with the caching allocator's counts in GiB: allocated before it, the peak
    of the forward up to the loss and what it leaves allocated, the peak of
    the backward, and of the optimiser's update."""
    gib = 2.0 ** -30
    run.opt.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {"before": torch.cuda.memory_allocated() * gib}
    loss = masked_nll(run.model(run.x, run.graph, **run.fwd_kw), run.labels, run.mask)
    out.update(forward_peak=torch.cuda.max_memory_allocated() * gib,
               after_forward=torch.cuda.memory_allocated() * gib)
    torch.cuda.reset_peak_memory_stats()
    loss.backward()
    out["backward_peak"] = torch.cuda.max_memory_allocated() * gib
    torch.cuda.reset_peak_memory_stats()
    run.opt.step()
    torch.cuda.synchronize()
    out["update_peak"] = torch.cuda.max_memory_allocated() * gib
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
