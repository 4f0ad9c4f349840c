"""``chip_smoke.py``'s ``model_axes`` phase alone on the card, with no kernel
build and without the phases whose data it reuses.

The arxiv data comes from ``train_fullgraph.load_data`` (``--clustered``,
the CLI's defaults: 169,343 nodes), the plan shard from a
``train_fullgraph.run_sharded`` run of the distributed GCN at world size 1
over NCCL (whose ms/step the phase prints beside TP's), and in place of the
evaluator's world and ground truth a 2943-CBG world of
``apps/common.build_synthetic_world`` with 40 random feature samples (8
touched features). Then ``run_model_axes`` prints its ``axes {...}`` line,
and ``python -m pygcn_tpu_torch.parallel.dryrun --ranks 1`` runs once and is
timed. Run from the root of a checkout on the card::

    PYTHONPATH=. python3 pygcn_tpu_torch/apps/time_axes.py
"""

from __future__ import annotations

import subprocess
import sys
import time


def main() -> None:
    import numpy as np

    import chip_smoke as cs

    torch = cs.setup()
    print(sys.version.split()[0], torch.__version__, torch.version.cuda, flush=True)
    print(cs.card_line(), flush=True)
    from pygcn_tpu_torch.apps import train_fullgraph as tapp
    from pygcn_tpu_torch.apps.common import build_synthetic_world

    t0 = time.time()
    args = tapp.parse_args(["--clustered", "--device", "cuda", "--max_epochs", str(cs.EPOCHS)])
    data = tapp.load_data(args)
    print(f"arxiv data {time.time() - t0:.1f}s", flush=True)
    with cs._OneRankGroup("dist"):
        run = tapp.run_sharded(args, data)
        shard, dist_ms = run["model"].shard, run["epoch_s"] * 1e3
        del run
    world = build_synthetic_world(n_cbgs=2943, n_pois=500, hours=48, seed=42, device="cuda")
    rng = np.random.default_rng(0)
    ev = {"world": world, "res": type("Split", (), {"idx_train": np.arange(40)})(),
          "feats": rng.normal(size=(40, 2943, 12)).astype(np.float32), "dim": 8,
          "y": rng.normal(size=(40,)).astype(np.float32)}
    t0 = time.time()
    cs.run_model_axes(torch, data, shard, dist_ms, ev)
    print(f"phase model_axes wall: {time.time() - t0:.1f}s", flush=True)
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "pygcn_tpu_torch.parallel.dryrun", "--ranks",
                           "1"], capture_output=True, text=True, timeout=300)
    print(f"dryrun CLI --ranks 1 (cuda): rc {proc.returncode} in {time.time() - t0:.1f}s: "
          f"{proc.stdout.strip()[-400:]} {proc.stderr.strip()[-1500:]}", flush=True)
    if proc.returncode:
        sys.exit(proc.returncode)


if __name__ == "__main__":
    main()
