"""Non-GCN baselines (reference ``mlp.py`` E3, ``mlp_new.py`` E4,
``regression.py`` E5).

The port of ``pygcn_tpu/apps/baselines.py`` on one CUDA card (``--device
cuda``, the default; ``--device cpu`` when asked). Subcommands:

- ``mlp``         — masked-pool + MLP head on (4 demo + 4 graph + flag)
  features, the reference's torch baseline (``pygcn/mlp.py:209-253``);
- ``summary-ols`` — ordinary least squares of the targets on per-policy
  summary statistics (mean/std of the 8 node features over vaccinated CBGs,
  reference ``mlp_new.py:128-145`` / ``regression.py:139-185``), in closed
  form with NumPy and SciPy (coefficients, t-stats, R²);
- ``summary-mlp`` — scikit-learn's ``MLPRegressor`` on the same summary
  stats (reference ``mlp_new.py:177-209``); scikit-learn is imported only
  here, and its absence is reported.

Usage::

    python -m pygcn_tpu_torch.apps.baselines mlp --vac_result_path vac.csv
    python -m pygcn_tpu_torch.apps.baselines summary-ols --vac_result_path vac.csv
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from pygcn_tpu_torch.apps.common import build_synthetic_world, set_process_title
from pygcn_tpu_torch.data.features import centrality_features, standardize
from pygcn_tpu_torch.data.loader import make_split_loaders
from pygcn_tpu_torch.data.vac_results import load_vac_results
from pygcn_tpu_torch.nn.models import PoolMLPModel
from pygcn_tpu_torch.train.metrics import spearman
from pygcn_tpu_torch.train.optim import adam_l2
from pygcn_tpu_torch.utils.device import resolve_device


def numpy_ols(x: np.ndarray, y: np.ndarray):
    """Closed-form OLS with intercept and the full statsmodels-``summary()``
    inference set (the reference prints ``results.summary()`` at its
    ``regression.py:163-185``; statsmodels is absent in this environment):
    coefficients, standard errors, t-stats, two-sided p-values, R², adjusted
    R², the model F-statistic with its p-value, and (n, dof)."""
    from scipy import stats

    n, k = x.shape
    xd = np.concatenate([np.ones((n, 1)), x], axis=1)
    coef, *_ = np.linalg.lstsq(xd, y, rcond=None)
    resid = y - xd @ coef
    dof = max(n - k - 1, 1)
    ss_res = float(resid @ resid)
    sigma2 = ss_res / dof
    xtx_inv = np.linalg.pinv(xd.T @ xd)
    se = np.sqrt(np.clip(np.diag(xtx_inv) * sigma2, 1e-30, None))
    tstats = coef / se
    pvals = 2.0 * stats.t.sf(np.abs(tstats), dof)
    ss_tot = float(((y - y.mean()) ** 2).sum())
    r2 = 1.0 - ss_res / max(ss_tot, 1e-30)
    r2_adj = 1.0 - (1 - r2) * (n - 1) / dof
    f_stat = (r2 / max(1 - r2, 1e-30)) * (dof / k)
    f_pval = float(stats.f.sf(f_stat, k, dof))
    return {
        "coef": coef, "se": se, "t": tstats, "p": pvals,
        "r2": r2, "r2_adj": r2_adj, "f_stat": f_stat, "f_pval": f_pval,
        "n": n, "dof": dof,
    }


def print_ols_summary(fit: dict, target: str, feat_names=None) -> None:
    """A statsmodels-style coefficient table (reference ``regression.py``
    prints ``summary()`` per target)."""
    k = fit["coef"].size - 1
    names = ["const"] + list(
        feat_names if feat_names is not None else (f"x{i}" for i in range(k))
    )
    print(f"[OLS] target={target}  n={fit['n']}  "
          f"R2={fit['r2']:.4f}  R2_adj={fit['r2_adj']:.4f}  "
          f"F={fit['f_stat']:.2f} (p={fit['f_pval']:.3g})")
    print(f"    {'feature':<14} {'coef':>10} {'se':>10} {'t':>8} {'P>|t|':>8}")
    for i, name in enumerate(names):
        print(f"    {name:<14} {fit['coef'][i]:>10.4g} {fit['se'][i]:>10.4g} "
              f"{fit['t'][i]:>8.2f} {fit['p'][i]:>8.3g}")


def build_world_and_features(args):
    world = build_synthetic_world(
        n_cbgs=args.n_cbgs, n_pois=args.n_pois, hours=args.hours,
        msa_name=args.msa_name,
        seed=args.seed if getattr(args, "world_seed", None) is None else args.world_seed,
        device=args.device,
    )
    res = load_vac_results(args.vac_result_path, rel_result=True)
    cent = centrality_features(world.adj)
    demo = standardize(world.demographics)
    node_feats = np.concatenate([demo, cent], axis=1)  # [N, 8]
    return world, res, node_feats


def summary_stats(node_feats: np.ndarray, vac_tags) -> np.ndarray:
    """[B, 16]: mean and std of the 8 features over each policy's vaccinated
    nodes (reference ``mlp_new.py:128-145``)."""
    rows = []
    for tags in vac_tags:
        sel = node_feats[np.asarray(tags, np.int64)]
        rows.append(np.concatenate([sel.mean(axis=0), sel.std(axis=0)]))
    return np.asarray(rows, np.float32)


def run_mlp(args):
    device = torch.device(args.device)
    world, res, node_feats = build_world_and_features(args)
    b, n = res.num_samples, node_feats.shape[0]
    feats = np.zeros((b, n, node_feats.shape[1] + 1), np.float32)
    feats[:, :, :-1] = node_feats
    for i, tags in enumerate(res.vac_tags):
        feats[i, tags, -1] = 1.0
    y = res.graph_labels[:, args.target_code]
    y = ((y - y.mean()) / (y.std() + 1e-8)).astype(np.float32)

    train_loader, val_loader, test_loader = make_split_loaders(
        feats, y, res.idx_train, res.idx_val, res.idx_test, args.batch_size,
        quicktest=args.quicktest,
    )

    model = PoolMLPModel(linear_nin=node_feats.shape[1], linear_nhid1=64, linear_nhid2=8,
                         linear_nout=1, generator=torch.Generator().manual_seed(args.seed))
    model.to(device)
    opt = adam_l2(model.parameters(), args.lr, args.weight_decay)

    def to_device(a):
        return torch.from_numpy(a).to(device)

    for epoch in range(args.epochs):
        for bx, by in train_loader:
            opt.zero_grad(set_to_none=True)
            torch.mean((model(to_device(bx))[:, 0] - to_device(by)) ** 2).backward()
            opt.step()

    with torch.no_grad():
        preds = torch.cat([model(to_device(bx))[:, 0].cpu() for bx, _ in test_loader])
    truths = torch.from_numpy(np.concatenate([by for _, by in test_loader]))
    mse = float(torch.mean((preds - truths) ** 2))
    corr = float(spearman(preds, truths))
    print(f"mlp baseline: test mse={mse:.4f} spearman={corr:.4f}")
    return mse, corr


def run_summary_ols(args):
    _, res, node_feats = build_world_and_features(args)
    x = summary_stats(node_feats, res.vac_tags)
    targets = res.graph_labels
    names = ["Total_Cases", "Case_Rates_STD", "Total_Deaths", "Death_Rates_STD"]
    base = ["size", "elder", "income", "ew", "deg", "close", "betw", "mobility"]
    feat_names = [f"mean_{b}" for b in base] + [f"std_{b}" for b in base]
    for j in range(targets.shape[1]):
        fit = numpy_ols(x, targets[:, j].astype(np.float64))
        print_ols_summary(fit, names[j], feat_names[: x.shape[1]])

    # Held-out comparison point for the GCN evaluator (the reference fits OLS
    # on all data, regression.py:163-175; the extra train->test Spearman here
    # makes the baseline comparable to train_evaluator's test metric).
    from scipy import stats

    tr = np.concatenate([res.idx_train, res.idx_val])
    y = targets[:, args.target_code].astype(np.float64)
    # Standardize y the same way train_evaluator does (train_evaluator.py:
    # y -> (y - mean) / std) so the holdout MSE is on the SAME scale as the
    # evaluator's test MSE; Spearman is scale-invariant either way.
    y = (y - y.mean()) / max(y.std(), 1e-12)
    xd = np.concatenate([np.ones((x.shape[0], 1)), x], axis=1)
    coef, *_ = np.linalg.lstsq(xd[tr], y[tr], rcond=None)
    preds = xd[res.idx_test] @ coef
    corr = float(stats.spearmanr(preds, y[res.idx_test]).statistic)
    mse = float(np.mean((preds - y[res.idx_test]) ** 2))
    print(f"ols holdout [{names[args.target_code]}]: test mse={mse:.4g} "
          f"spearman={corr:.4f}")
    return fit


def run_summary_mlp(args):
    try:
        from sklearn.neural_network import MLPRegressor
    except ImportError as e:
        raise RuntimeError("baselines summary-mlp needs scikit-learn, which is not "
                           "installed") from e

    _, res, node_feats = build_world_and_features(args)
    x = summary_stats(node_feats, res.vac_tags)
    y = res.graph_labels[:, args.target_code]
    tr, te = res.idx_train, res.idx_test
    reg = MLPRegressor(
        hidden_layer_sizes=(64, 8), max_iter=args.epochs * 10,
        random_state=args.seed,
    ).fit(x[tr], y[tr])
    score = reg.score(x[te], y[te])
    preds = reg.predict(x[te])
    mse = float(np.mean((preds - y[te]) ** 2))
    from scipy import stats

    corr = float(stats.spearmanr(preds, y[te]).statistic)
    print(f"sklearn MLP baseline: test r2={score:.4f} mse={mse:.4f} "
          f"spearman={corr:.4f}")
    return score


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("cmd", choices=["mlp", "summary-ols", "summary-mlp"])
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs a CUDA card")
    ap.add_argument("--vac_result_path", required=True)
    ap.add_argument("--msa_name", default="SanFrancisco")
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--weight_decay", type=float, default=5e-4)
    ap.add_argument("--batch_size", type=int, default=20)
    ap.add_argument("--target_code", type=int, default=0)
    ap.add_argument("--quicktest", action="store_true")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--world_seed", type=int, default=None,
                    help="synthetic-world seed (default: --seed); fix it to "
                         "the gt CSV's world seed when varying --seed")
    ap.add_argument("--n_cbgs", type=int, default=64)
    ap.add_argument("--n_pois", type=int, default=20)
    ap.add_argument("--hours", type=int, default=96)
    args = ap.parse_args(argv)

    set_process_title("baselines")
    args.device = resolve_device(args.device)

    if args.cmd == "mlp":
        return run_mlp(args)
    if args.cmd == "summary-ols":
        return run_summary_ols(args)
    return run_summary_mlp(args)


if __name__ == "__main__":
    main()
