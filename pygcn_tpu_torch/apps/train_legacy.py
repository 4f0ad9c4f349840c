"""Legacy per-sample GCN regressor trainer (reference ``pygcn/train.py``, E1).

The port of ``pygcn_tpu/apps/train_legacy.py`` on one CUDA card
(``--device cuda``, the default; ``--device cpu`` when asked): GCN backbone
→ node mean → MLP head, one sample at a time in the reference; each epoch
resamples ``accumulation_step`` (20) training samples with replacement from
NumPy's generator of ``--seed`` (the JAX CLI's picks), averages their
gradients and takes ONE optimizer step; MSE on total cases; splits truncated
to 16 samples (reference ``pygcn/train.py:117-119,134-204``). The
accumulation loop becomes one batched step: the picks go through the GCN as
one folded product, each standardised on its own.

Usage::

    python -m pygcn_tpu_torch.apps.train_legacy --vac_result_path vac.csv
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from pygcn_tpu_torch.apps.common import build_synthetic_world, set_process_title
from pygcn_tpu_torch.apps.train_evaluator import build_predictor_features
from pygcn_tpu_torch.data.vac_results import load_vac_results
from pygcn_tpu_torch.nn.models import GCNRegressor
from pygcn_tpu_torch.train.optim import adam_l2
from pygcn_tpu_torch.utils.device import resolve_device
from pygcn_tpu_torch.utils.logging import MetricsLogger


def epoch_picks(rng: np.random.Generator, idx_train: np.ndarray, n: int) -> np.ndarray:
    """One epoch's accumulation samples: ``n`` draws with replacement."""
    return rng.choice(idx_train, n, replace=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs a CUDA card")
    ap.add_argument("--vac_result_path", required=True)
    ap.add_argument("--msa_name", default="SanFrancisco")
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--weight_decay", type=float, default=5e-4)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--accumulation_step", type=int, default=20)
    ap.add_argument("--truncate", type=int, default=16)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--n_cbgs", type=int, default=64)
    ap.add_argument("--n_pois", type=int, default=20)
    ap.add_argument("--hours", type=int, default=96)
    args = ap.parse_args(argv)

    set_process_title("train_legacy")
    device = resolve_device(args.device)

    world = build_synthetic_world(
        n_cbgs=args.n_cbgs, n_pois=args.n_pois, hours=args.hours,
        msa_name=args.msa_name, seed=args.seed, device=device,
    )
    res = load_vac_results(args.vac_result_path, rel_result=True)
    feats = build_predictor_features(world, res)
    y = res.graph_labels[:, 0]
    y = ((y - y.mean()) / (y.std() + 1e-8)).astype(np.float32)

    # reference truncates each split to 16 samples (train.py:117-119)
    idx_train = res.idx_train[: args.truncate]
    idx_val = res.idx_val[: args.truncate]
    idx_test = res.idx_test[: args.truncate]

    model = GCNRegressor(
        gcn_nfeat=feats.shape[2], gcn_nhid=args.hidden, gcn_nclass=args.hidden,
        linear_nin=args.hidden, linear_nhid1=64, linear_nhid2=8, linear_nout=1,
        generator=torch.Generator().manual_seed(args.seed),
    ).to(device)
    opt = adam_l2(model.parameters(), args.lr, args.weight_decay)
    graph = world.graph
    feats_dev = torch.from_numpy(feats).to(device)
    y_dev = torch.from_numpy(y).to(device)

    def split_loss(idx):
        # the mean over samples of each one's squared error
        idx = torch.from_numpy(np.asarray(idx)).to(device)
        pred = model(feats_dev.index_select(0, idx), graph)[:, 0]
        return torch.mean((pred - y_dev.index_select(0, idx)) ** 2)

    rng = np.random.default_rng(args.seed)
    logger = MetricsLogger(None)
    for epoch in range(args.epochs):
        picks = epoch_picks(rng, idx_train, args.accumulation_step)
        opt.zero_grad(set_to_none=True)
        loss = split_loss(picks)
        loss.backward()
        opt.step()
        if epoch % 10 == 0:
            with torch.no_grad():
                logger.log(epoch, train_loss=loss.detach(), val_loss=split_loss(idx_val))

    with torch.no_grad():
        test = float(split_loss(idx_test))
    print(f"Test set results: loss= {test:.4f}")
    return test


if __name__ == "__main__":
    main()
