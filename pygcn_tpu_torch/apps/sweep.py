"""Grid-sweep CLI over the port's training apps.

The port of ``pygcn_tpu/apps/sweep.py``. It completes the reference's sweep
convention (list-valued ``Config`` entries, ``pygcn/config.py:76-80``) as a
CLI: each ``--set key=v1,v2,...`` adds a grid axis; every combination runs
the target app with those flags appended, metrics are collected from the
app's return value, and results are ranked and written to
``<out_dir>/sweep_results.jsonl``. Every trial gets ``--out_dir``, as in the
JAX CLI; ``train_cora`` takes none, so ``--app train_cora`` ends in
argparse's exit there too.

Usage::

    python -m pygcn_tpu_torch.apps.sweep --app train_evaluator \
        --set lr=0.01,0.003 --set hidden=16,32 \
        --metric test_spearman --out_dir sweep_out -- \
        --vac_result_path vac.csv --epochs 20
"""

from __future__ import annotations

import argparse
import json
import os

from pygcn_tpu_torch.train.sweep import SweepResult
from pygcn_tpu_torch.utils.config import Config


def _parse_value(tok: str):
    for cast in (int, float):
        try:
            return cast(tok)
        except ValueError:
            pass
    return tok


# app name -> (module path, metric names of the main() return tuple)
APPS = {
    "train_evaluator": ("pygcn_tpu_torch.apps.train_evaluator", ("test_loss", "test_spearman")),
    "train_cora": ("pygcn_tpu_torch.apps.train_cora", ("test_acc",)),
}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    ap.add_argument("--app", choices=sorted(APPS), default="train_evaluator")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=V1,V2,...",
                    help="grid axis: app flag name (no --) and comma-separated values")
    ap.add_argument("--metric", default=None,
                    help="ranking metric (default: the app's last returned metric)")
    ap.add_argument("--mode", choices=["max", "min"], default="max")
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("app_args", nargs="*",
                    help="base flags passed to every trial (after '--')")
    args = ap.parse_args(argv)

    import importlib

    mod_path, metric_names = APPS[args.app]
    app_main = importlib.import_module(mod_path).main
    metric = args.metric or metric_names[-1]
    if metric not in metric_names:
        raise SystemExit(f"--metric must be one of {metric_names} for {args.app}")

    cfg = Config()
    for spec in args.set:
        key, _, vals = spec.partition("=")
        if not vals:
            raise SystemExit(f"--set needs KEY=V1,V2,... (got {spec!r})")
        cfg[key] = [_parse_value(t) for t in vals.split(",")]
    swept = [k for k, v in cfg.state_dict.items() if isinstance(v, list)]
    if not cfg.has_list():
        raise SystemExit("no grid axes: pass at least one --set KEY=V1,V2,...")

    os.makedirs(args.out_dir, exist_ok=True)
    results_path = os.path.join(args.out_dir, "sweep_results.jsonl")
    results_f = open(results_path, "w")

    from pygcn_tpu_torch.train.sweep import run_sweep

    counter = {"i": 0}

    def trial(c: Config):
        i = counter["i"]
        counter["i"] += 1
        trial_dir = os.path.join(args.out_dir, f"trial_{i:03d}")
        argv_trial = list(args.app_args) + ["--out_dir", trial_dir]
        for k in swept:
            argv_trial += [f"--{k}", str(c[k])]
        out = app_main(argv_trial)
        out = out if isinstance(out, tuple) else (out,)
        return dict(zip(metric_names, (float(v) for v in out)))

    def on_trial(i, record):
        results_f.write(json.dumps(record) + "\n")
        results_f.flush()
        shown = record.get("error") or record["metrics"]
        print(f"trial {i}: {record['params']} -> {shown}", flush=True)

    result = run_sweep(trial, cfg, metric=metric, mode=args.mode, on_trial=on_trial)
    results_f.close()

    best = result.best
    print("--- ranking ---")
    print(result.table())
    print(f"best ({args.mode} {metric}): {best['params']} -> {best['metrics']}")
    with open(os.path.join(args.out_dir, "best.json"), "w") as f:
        json.dump(best, f, indent=2)
    return result


if __name__ == "__main__":
    main()
