"""Batch inference / serving CLI for a trained surrogate evaluator.

The port of ``pygcn_tpu/apps/predict.py`` on one CUDA card (``--device
cuda``, the default; ``--device cpu`` when asked). The reference has no
serving path — its trained ``.pt`` is unpickled inside each policy script
(``policy-generator.py:271-273``). This app loads ``evaluator.pkl`` (either
package's) once, pins weights and the co-visitation graph on the device, and
streams policy batches through ONE fixed-batch-shape forward (pad-and-trim;
rows are independent, since the evaluator standardises and pools each
sample alone, so padding changes no real row).

Two artifact modes:

- default: run from ``evaluator.pkl`` (params + model config);
- ``--export out.pt2`` additionally writes a ``torch.export`` artifact
  (weights + dense graph inside, ``train/export.py``), and ``--from_export
  in.pt2`` serves from such an artifact with NO model code in the loop. The
  artifact holds tensors on the device it was exported on.

Input policies: ``--policies_csv`` (a gt-format CSV's ``Vaccinated_Idxs``
column) or ``--random K``. Output: CSV of ``Vaccinated_Idxs, Prediction``
plus per-batch latency stats (the first batch left out); a batch's latency
runs from the host array to the predictions back on the host. :func:`main`
returns the predictions and ``{"batch_ms": [...], "export_s": ...}``.

Usage::

    python -m pygcn_tpu_torch.apps.predict --evaluator eval_run/evaluator.pkl \
        --random 100 --out preds.csv
"""

from __future__ import annotations

import argparse
import ast
import csv
import dataclasses
import time

import numpy as np
import torch

from pygcn_tpu_torch.apps.common import build_synthetic_world, set_process_title
from pygcn_tpu_torch.data.features import (
    assemble_evaluator_features,
    centrality_features,
    standardize,
)
from pygcn_tpu_torch.utils.device import resolve_device


def _policy_features(world, policies, feature_mode):
    """[B, N, F] evaluator inputs for a list of vaccinated-idx tuples."""
    n = world.n_cbgs
    b = len(policies)
    demo = standardize(world.demographics)
    embed = standardize(world.embeddings)
    node_feats = np.zeros((b, n, 4 + embed.shape[1] + 1), np.float32)
    node_feats[:, :, :4] = demo
    node_feats[:, :, 4:-1] = embed
    for i, p in enumerate(policies):
        node_feats[i, list(p), -1] = 1.0
    cent = centrality_features(world.adj)
    feats, _ = assemble_evaluator_features(
        node_feats, cent,
        feature_mode["with_pretrained_embed"], feature_mode["with_original_feat"],
    )
    return feats


class ServingForward(torch.nn.Module):
    """The evaluator's prediction per sample, ``[B, N, F]`` → ``[B]``, with
    the dense adjacency held as a buffer: the module that serves eagerly and
    that ``--export`` traces."""

    def __init__(self, evaluator: torch.nn.Module, graph):
        super().__init__()
        self.evaluator = evaluator
        self.register_buffer("adj", graph.dense)
        self._graph = graph

    def forward(self, bx: torch.Tensor) -> torch.Tensor:
        return self.evaluator(bx, dataclasses.replace(self._graph, dense=self.adj))[:, 0]


def load_server(evaluator_path: str, world, device):
    """``(ServingForward, feature_mode)`` of an ``evaluator.pkl`` on ``device``."""
    from pygcn_tpu_torch.train.checkpoint import load_evaluator

    model, ev = load_evaluator(evaluator_path, device)
    feature_mode = ev.get(
        "feature_mode",
        {"with_pretrained_embed": True, "with_original_feat": False},
    )
    return ServingForward(model.eval(), world.graph).eval(), feature_mode


def serve(predict_batch, feats: np.ndarray, batch: int, device):
    """Predictions for every row of ``feats``, in padded batches of
    ``batch``; returns ``(preds, per-batch latency in ms)``."""
    preds = np.zeros(feats.shape[0], np.float32)
    lat_ms = []
    pad_shape = (batch,) + feats.shape[1:]
    with torch.inference_mode():
        for lo in range(0, feats.shape[0], batch):
            chunk = feats[lo: lo + batch]
            bx = np.zeros(pad_shape, np.float32)
            bx[: len(chunk)] = chunk
            t0 = time.perf_counter()
            out = predict_batch(torch.from_numpy(bx).to(device)).cpu().numpy()
            lat_ms.append((time.perf_counter() - t0) * 1e3)
            preds[lo: lo + len(chunk)] = out[: len(chunk)]
    return preds, lat_ms


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs a CUDA card")
    ap.add_argument("--evaluator", default=None, help="evaluator.pkl from train_evaluator")
    ap.add_argument("--from_export", default=None,
                    help="serve from a torch.export artifact instead of the pickle")
    ap.add_argument("--export", default=None,
                    help="also write a torch.export serving artifact here")
    ap.add_argument("--policies_csv", default=None,
                    help="gt-format CSV; predicts for its Vaccinated_Idxs column")
    ap.add_argument("--random", type=int, default=0, help="predict for K random policies")
    ap.add_argument("--NN", type=int, default=5)
    ap.add_argument("--batch", type=int, default=32, help="fixed serving batch shape")
    ap.add_argument("--msa_name", default="SanFrancisco")
    ap.add_argument("--n_cbgs", type=int, default=64)
    ap.add_argument("--n_pois", type=int, default=20)
    ap.add_argument("--hours", type=int, default=48)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if not args.evaluator and not args.from_export:
        ap.error("need --evaluator or --from_export")

    set_process_title("predict")
    device = resolve_device(args.device)

    world = build_synthetic_world(
        n_cbgs=args.n_cbgs, n_pois=args.n_pois, hours=args.hours,
        msa_name=args.msa_name, seed=args.seed, device=device,
    )

    # --- assemble the request stream -------------------------------------
    policies = []
    if args.policies_csv:
        with open(args.policies_csv) as f:
            for row in csv.DictReader(f):
                policies.append(tuple(ast.literal_eval(row["Vaccinated_Idxs"])))
    rng = np.random.default_rng(args.seed)
    for _ in range(args.random):
        policies.append(tuple(sorted(rng.choice(world.n_cbgs, args.NN, replace=False))))
    if not policies:
        raise SystemExit("no policies: pass --policies_csv and/or --random K")

    # --- build the fixed-shape forward ------------------------------------
    if args.from_export:
        from pygcn_tpu_torch.train.export import load_artifact

        predict_batch, meta = load_artifact(args.from_export)
        feature_mode = meta["feature_mode"]
        batch = meta["batch"]
        if meta["n_cbgs"] != world.n_cbgs:
            raise SystemExit(
                f"artifact was exported for n_cbgs={meta['n_cbgs']}, world has {world.n_cbgs}"
            )
    else:
        predict_batch, feature_mode = load_server(args.evaluator, world, device)
        batch = args.batch

    # --- serve -------------------------------------------------------------
    feats = _policy_features(world, policies, feature_mode)
    export_s = None
    if args.export:
        from pygcn_tpu_torch.train.export import save_artifact

        t0 = time.perf_counter()
        example = torch.zeros((batch,) + feats.shape[1:], device=device)
        save_artifact(
            args.export, predict_batch, (example,),
            meta={"feature_mode": feature_mode, "batch": batch,
                  "n_cbgs": world.n_cbgs, "feat_dim": feats.shape[2]},
        )
        export_s = time.perf_counter() - t0
        print(f"serving artifact written: {args.export} ({export_s:.2f}s)")

    preds, lat_ms = serve(predict_batch, feats, batch, device)

    with open(args.out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Vaccinated_Idxs", "Prediction"])
        for p, y in zip(policies, preds):
            w.writerow(["[" + ", ".join(map(str, p)) + "]", float(y)])

    served = lat_ms[1:] or lat_ms  # the first batch includes the warm-up
    print(
        f"served {len(policies)} policies in {len(lat_ms)} batches of {batch}; "
        f"latency p50={np.percentile(served, 50):.2f}ms "
        f"p99={np.percentile(served, 99):.2f}ms over {len(served)} batches"
    )
    return preds, {"batch_ms": lat_ms, "export_s": export_s}


if __name__ == "__main__":
    main()
