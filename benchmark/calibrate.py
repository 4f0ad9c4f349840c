"""Readings that the check's limits are set from; not run by the benchmark.

    python benchmark/calibrate.py --workload gcn_arxiv-clustered \\
        --seeds 11,12,13 --control-seeds 21,22,23 --out readings.jsonl

Builds the cell's graph once, then for each of ``--seeds`` runs the program's
first steps (sound) and for each of ``--control-seeds`` the control (the
float32 reference with its dense products in TF32, the precision below the
configuration's float32 with TF32 off), the float32 reference without TF32,
the float64 reference a second time (its own floor: its sums by index run
in no fixed order) and each fault of ``faults.py`` planted in the program,
and compares each with the float64 reference, as a run does.
Writes one JSON line a reading: the compared gaps and, by leaf and by
step, what they were taken from. Runs on the card, at the mix's own size:
the limits are read there.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from benchmark.compare import training_gaps  # noqa: E402
from benchmark.control import control  # noqa: E402
from benchmark.drivers import fullgraph  # noqa: E402
from benchmark.faults import FAULTS  # noqa: E402


def detail(prog: dict, ref: dict, params0: dict) -> dict:
    """Per step and per leaf: the loss gaps, and each leaf's reference norms
    and the program's, of the first gradient and of the change."""
    norm = lambda t: float(torch.linalg.vector_norm(t.double()))  # noqa: E731
    leaves = {k: {"g_ref": norm(ref["grad1"][k]), "g_prog": norm(prog["grad1"][k]),
                  "g_diff": norm(prog["grad1"][k] - ref["grad1"][k]),
                  "d_ref": norm(ref["params"][k] - params0[k]),
                  "d_prog": norm(prog["params"][k] - params0[k])} for k in ref["grad1"]}
    return {"loss_gaps": [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])],
            "median_g_ref": statistics.median(v["g_ref"] for v in leaves.values()),
            "leaves": leaves}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    harness.cache_dirs()
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    _, config, mix, _ = harness.cell_files(spec, args.workload)
    harness.set_precision(torch, config)
    device = torch.device("cuda")
    spans = harness.Spans()
    built = fullgraph.build_graph(config, mix, spans)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    out = open(args.out, "a")

    def program(seed, fault=None):
        run = fullgraph.FullGraphRun(config, mix, seed, device, spans, built=built)
        if fault:
            FAULTS[fault](run)
        run.start()
        prog = run.readings()
        run.release()
        return run, prog

    def emit(kind, seed, prog, ref, params0, seconds):
        row = {"workload": args.workload, "kind": kind, "seed": seed, "seconds": seconds,
               **training_gaps(prog, ref, params0), "detail": detail(prog, ref, params0)}
        out.write(json.dumps(row) + "\n")
        out.flush()
        print(json.dumps({k: v for k, v in row.items() if k != "detail"}), flush=True)

    for seed in sorted(set(seeds) | set(control_seeds)):
        t0 = time.perf_counter()
        run, prog = program(seed)
        ref = run.reference()
        if seed in seeds:
            emit("sound", seed, prog, ref, run.params0, time.perf_counter() - t0)
        if seed in control_seeds:
            others = {"control_tf32": lambda: control(run),
                      "reference_f32": lambda: run.reference(torch.float32),
                      "reference_again": run.reference}
            others.update({f: lambda f=f: program(seed, f)[1] for f in FAULTS})
            for kind, reading in others.items():
                t1 = time.perf_counter()
                emit(kind, seed, reading(), ref, run.params0, time.perf_counter() - t1)
        del ref
    out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
