"""Full-batch semi-supervised node classification (the Kipf GCN workload).

The port of ``pygcn_tpu/apps/train_cora.py``, with its flags and output, on
one CUDA card (``--device cuda``, the default; ``--device cpu`` when asked).
The BASELINE Cora configuration: 2-layer GCN, hidden 16, dropout 0.5, Adam
lr 0.01 with L2 decay 5e-4, NLL over log_softmax, splits 140/300/1000. Runs
on real Planetoid files when both are present (``<dataset>.content`` and
``<dataset>.cites``), on the real structure with synthetic features and
labels when only the ``.cites`` file is, else on the synthetic SBM stand-in.
Graphs of Cora's size take the dense layout (``torch.mm`` on cuBLAS), so
this path runs no hand-written kernel, as in JAX.

Usage::

    python -m pygcn_tpu_torch.apps.train_cora --data_dir data/cora --epochs 200
"""

from __future__ import annotations

import argparse
import os
import time


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs a CUDA card")
    ap.add_argument("--data_dir", default="data/cora")
    ap.add_argument("--dataset", default="cora")
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--weight_decay", type=float, default=5e-4)
    ap.add_argument("--hidden", type=int, default=16)
    ap.add_argument("--dropout", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--adj_norm", choices=["sym", "row"], default="sym")
    ap.add_argument("--patience", type=int, default=0, help="0 = no early stop")
    ap.add_argument("--fastmode", action="store_true")
    ap.add_argument("--synthetic_nodes", type=int, default=1500)
    return ap.parse_args(argv)


def load(args: argparse.Namespace):
    """The dataset ``args`` name, as the JAX CLI picks it: real Planetoid
    files, then the structure alone, then the synthetic SBM."""
    from pygcn_tpu_torch.graph.datasets import (load_planetoid, load_planetoid_structure,
                                                sbm_classification)

    content = os.path.join(args.data_dir, f"{args.dataset}.content")
    cites = os.path.join(args.data_dir, f"{args.dataset}.cites")
    if os.path.exists(content) and os.path.exists(cites):
        data = load_planetoid(content, cites, adj_norm=args.adj_norm)
        print(f"loaded {args.dataset}: {data.graph.n_nodes} nodes, "
              f"{data.graph.n_edges} edges, {data.n_classes} classes")
    elif os.path.exists(cites):
        data = load_planetoid_structure(cites, seed=args.seed, adj_norm=args.adj_norm)
        print(f"loaded {args.dataset} STRUCTURE ({data.graph.n_nodes} nodes, "
              f"{data.graph.n_edges} normalized edges) — {content} missing, "
              "features/labels are synthetic")
    else:
        print(f"{content} not found — using synthetic SBM stand-in")
        data = sbm_classification(n=args.synthetic_nodes, n_classes=7, feat_dim=256,
                                  seed=args.seed, adj_norm=args.adj_norm)
    return data


def train(args: argparse.Namespace) -> dict:
    """Train and test as ``args`` say; returns ``test_acc``, ``test_loss``
    and the last training step's ``loss``."""
    import torch

    from pygcn_tpu_torch.apps.common import set_process_title
    from pygcn_tpu_torch.utils.device import resolve_device
    from pygcn_tpu_torch.nn.models import KipfGCN
    from pygcn_tpu_torch.train.loop import EarlyStopping, bool_mask, make_classifier_steps
    from pygcn_tpu_torch.train.optim import adam_l2

    set_process_title("train_cora")
    device = resolve_device(args.device)
    data = load(args)
    n = data.graph.n_nodes
    graph = data.graph.to(device)
    model = KipfGCN(data.features.shape[1], args.hidden, data.n_classes, dropout=args.dropout,
                    generator=torch.Generator().manual_seed(args.seed)).to(device)
    opt = adam_l2(model.parameters(), args.lr, args.weight_decay)
    train_step, eval_step = make_classifier_steps(model, opt, graph)

    x = torch.from_numpy(data.features).to(device)
    y = torch.from_numpy(data.labels).long().to(device)
    m_train, m_val, m_test = (bool_mask(idx, n).to(device)
                              for idx in (data.idx_train, data.idx_val, data.idx_test))

    stopper = EarlyStopping(patience=args.patience) if args.patience else None
    gen = torch.Generator(device=device).manual_seed(args.seed)  # the dropout draws
    loss = None
    t0 = time.time()
    for epoch in range(args.epochs):
        loss = train_step(x, y, m_train, gen)
        if not args.fastmode and (epoch % 10 == 9 or epoch == 0):
            val_loss, val_acc = eval_step(x, y, m_val)
            print(f"epoch {epoch + 1:4d} loss {float(loss):.4f} "
                  f"val_loss {float(val_loss):.4f} val_acc {float(val_acc):.4f}")
            if stopper and stopper(float(val_loss)):
                print("Early stopping")
                break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"Optimization Finished! {time.time() - t0:.2f}s")

    test_loss, test_acc = eval_step(x, y, m_test)
    print(f"Test set results: loss= {float(test_loss):.4f} "
          f"accuracy= {float(test_acc):.4f}")
    return {"test_acc": float(test_acc), "test_loss": float(test_loss),
            "loss": None if loss is None else float(loss)}


def main(argv=None) -> float:
    """Run the CLI; returns the test accuracy, as the JAX CLI does."""
    return train(parse_args(argv))["test_acc"]


if __name__ == "__main__":
    main()
