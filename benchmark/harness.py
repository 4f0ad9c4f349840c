"""The harness: runs one cell once and builds its result line.

Everything that belongs to one configuration, traffic mix, driver or metric
is found by name: ``BENCHMARK.json`` names the cell's configuration (its
``file``) and traffic (``benchmark/traffic/<traffic>.json``); the mix names
its driver (``benchmark/drivers/<driver>.py``) and generator; each metric
has a reader, ``benchmark/end_to_end/<name>.py`` or
``benchmark/layer_metrics/<name>.py`` (a name's part after a dot marks the
cells it is split for, and shares the reader); each cell's limits are in
``benchmark/limits/<cell>.json``.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import math
import os
import statistics
import sys
import time
import types
from collections import defaultdict
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that may not be loaded in a benchmark process: the
# JAX package the port came from, and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "pygcn_tpu")


class Spans:
    """Host-clock spans by name, kept in memory."""

    def __init__(self):
        self.seconds = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name].append(time.perf_counter() - t0)

    def total(self, name: str):
        return sum(self.seconds[name]) if name in self.seconds else None


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(spec: dict, workload: str) -> tuple:
    """``(cell, config, mix, limits)`` of the cell named ``workload``."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: {sorted(cells)}")
    cell = cells[workload]
    config_file = next(c["file"] for c in spec["configs"] if c["name"] == cell["config"])
    config = load_json(ROOT / config_file)
    mix = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{workload}.json")
    return cell, config, mix, limits


def metrics_of(spec: dict, workload: str, trace: bool) -> list:
    """The metric entries this cell reports in a run with or without the trace."""
    entries = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in entries if workload in m.get("workloads", [workload])]


def reader(family: str, name: str):
    """The reader of metric ``name``: ``benchmark/<family>/<quantity>.py``,
    the quantity being the name up to its first dot (``gemm_ms.attn`` is
    ``gemm_ms`` in the cell it is split for)."""
    return importlib.import_module(f"benchmark.{family}.{name.split('.')[0]}")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def set_precision(torch, config: dict) -> None:
    tf32 = config["precision"]["allow_tf32"]
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def run_cell(spec: dict, workload: str, seed: int, seconds: float, trace: bool, *,
             t0: float, device: str = "cuda", out_dir: Path | None = None) -> dict:
    """Run ``workload`` once and return its result line as a dict. ``t0``
    is the process's start on the host clock. ``device`` other than
    ``"cuda"`` skips the look for a card (tests on the CPU)."""
    import torch

    from benchmark.peaks import peak_of
    from benchmark.trace import read as read_trace
    from benchmark.trace import top_records

    cell, config, mix, limits = cell_files(spec, workload)
    if device == "cuda" and not (torch.cuda.is_available()
                                 and torch.cuda.device_count() >= cell["chips"]):
        raise SystemExit(f"{workload} needs {cell['chips']} CUDA device(s); found "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    set_precision(torch, config)
    driver = importlib.import_module(f"benchmark.drivers.{mix['driver']}")
    spans = Spans()
    run = driver.Run(config, mix, seed, device, spans)
    on_card = run.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(run.device)
    run.start()
    setup_s = time.perf_counter() - t0
    record = run.window(seconds)
    peak_bytes = torch.cuda.max_memory_allocated(run.device) if on_card else 0
    kind = torch.cuda.get_device_name(run.device) if on_card else "cpu"
    ctx = types.SimpleNamespace(run=run, config=config, mix=mix, cell=cell, record=record,
                                setup_s=setup_s, peak_bytes=peak_bytes, spans=spans,
                                peak=peak_of(kind), trace=None)
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                   "count": cell["chips"], "memory_peak_bytes": peak_bytes}
    breakdown = None
    if trace:
        out_dir = out_dir or ROOT / "bench_out"
        out_dir.mkdir(parents=True, exist_ok=True)
        ctx.trace = read_trace(run.profile(str(out_dir / f"{workload}.seed{seed}")))
        device_info.update(busy_s=ctx.trace.busy_s, window_s=ctx.trace.window_s)
        breakdown = {"device_ops": top_records(ctx.trace),
                     "idle_gaps": [[k, s] for k, s in ctx.trace.gaps[:10]]}
    metrics = {}
    for m in metrics_of(spec, workload, trace):
        family = "layer_metrics" if trace else "end_to_end"
        value = reader(family, m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    print("counts " + json.dumps(run.counts()), file=sys.stderr)
    gaps = run.check()
    compared = {k: {"value": v, "limit": limits[k]} for k, v in gaps.items()}
    correct = all(math.isfinite(v) and v <= limits[k] for k, v in gaps.items())
    result = {"correct": correct, "attempted": record["steps"], "failed": record["failed"],
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = compared
    print("spans " + json.dumps({k: sum(v) for k, v in spans.seconds.items()}), file=sys.stderr)
    q = statistics.quantiles(record["step_s"], n=10) if record["steps"] > 1 else [0.0] * 9
    print(f"window: {record['steps']} steps, step ms p10 {q[0] * 1e3:.3f} p50 {q[4] * 1e3:.3f} "
          f"p90 {q[8] * 1e3:.3f} max {max(record['step_s']) * 1e3:.3f}", file=sys.stderr)
    return result


def cache_dirs() -> None:
    """Point every build and kernel cache a library might use at fixed
    directories inside the checkout (the port's own kernels build into
    ``pygcn_tpu_torch/_build`` and ``native/``, both inside it too)."""
    base = ROOT / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)
