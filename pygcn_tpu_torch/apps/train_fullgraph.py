"""Full-graph GCN training at ogbn-arxiv scale on one CUDA card.

The port of ``pygcn_tpu/apps/train_fullgraph.py`` for ``--model gcn``: an
N-layer GCN over the sparse engine, Adam with L2 decay, masked NLL. Without
``--clustered`` it times epochs on a synthetic Chung-Lu power-law graph with
random labels. With ``--clustered`` it runs the convergence flagship: a
learnable community-classification graph with shuffled ids, locality
ordering (native label propagation when graphkit loads, else BFS), the
hybrid BCSR+ELL layout whose tiles run on kernel B1, per-epoch validation
and early stopping.

Runs on ``--device cuda`` (the default; raises when no card is present) or,
when asked, ``--device cpu``, where kernel B1 is replaced by its plain version.

Usage::

    python -m pygcn_tpu_torch.apps.train_fullgraph --clustered --max_epochs 50
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from pygcn_tpu_torch.graph.graph import Graph
from pygcn_tpu_torch.nn.layers import GraphConv


class GCN(nn.Module):
    """GraphConv stack with ReLU between layers and log-softmax at the end.

    ``remat`` recomputes each layer's activations in the backward pass
    (``torch.utils.checkpoint``) instead of keeping them.
    """

    def __init__(self, dims, *, generator: torch.Generator, remat: bool = False):
        super().__init__()
        self.layers = nn.ModuleList(
            GraphConv(fi, fo, generator=generator) for fi, fo in zip(dims[:-1], dims[1:])
        )
        self.remat = remat

    @staticmethod
    def _layer(layer: GraphConv, h: torch.Tensor, graph: Graph, is_last: bool):
        h = layer(h, graph)
        return h if is_last else torch.relu(h)

    def forward(self, x: torch.Tensor, graph: Graph) -> torch.Tensor:
        h = x
        for i, layer in enumerate(self.layers):
            is_last = i == len(self.layers) - 1
            if self.remat and torch.is_grad_enabled():
                h = checkpoint(self._layer, layer, h, graph, is_last, use_reentrant=False)
            else:
                h = self._layer(layer, h, graph, is_last)
        return F.log_softmax(h, dim=1)


def masked_nll(logp: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    per_node = -logp.gather(1, labels[:, None])[:, 0]
    return (per_node * mask).sum() / mask.sum()


def train_step(model: GCN, opt: torch.optim.Optimizer, x, labels, mask, graph) -> torch.Tensor:
    """One full-graph step; returns the loss before the update (as the JAX step does)."""
    opt.zero_grad(set_to_none=True)
    loss = masked_nll(model(x, graph), labels, mask)
    loss.backward()
    opt.step()
    return loss.detach()


def resolve_device(name: str) -> torch.device:
    """``torch.device(name)``; raises for a CUDA request on a machine without a card."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: no CUDA device is available (pass --device cpu "
            "to run the plain versions on the CPU)"
        )
    return device


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs a CUDA card")
    ap.add_argument("--n_nodes", type=int, default=169_343)
    ap.add_argument("--avg_degree", type=float, default=None,
                    help="default 7.1 (chung-lu arxiv density); 13.3 with --clustered")
    ap.add_argument("--feat_dim", type=int, default=128)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--n_classes", type=int, default=40)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--weight_decay", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--memstats", action="store_true",
                    help="print the peak device memory of the training run")
    ap.add_argument("--remat", action="store_true",
                    help="recompute layer activations in the backward pass")
    ap.add_argument("--model", default="gcn",
                    help="only gcn is ported; gat/gatv2/sage/gin/appnp exit")
    ap.add_argument("--shards", type=int, default=1,
                    help="only 1 is ported")
    ap.add_argument("--clustered", action="store_true",
                    help="the convergence flagship: community-classification "
                         "data with shuffled ids, locality ordering, hybrid "
                         "BCSR+ELL layout, early stopping")
    ap.add_argument("--patience", type=int, default=10)
    ap.add_argument("--max_epochs", type=int, default=200)
    ap.add_argument("--eval_every", type=int, default=1)
    ap.add_argument("--max_wall_s", type=float, default=None)
    ap.add_argument("--npz", default=None, help="not ported yet")
    ap.add_argument("--content", default=None, help="not ported yet")
    ap.add_argument("--cites", default=None, help="not ported yet")
    args = ap.parse_args(argv)
    if args.model != "gcn":
        raise SystemExit(f"--model {args.model}: not ported yet (only gcn is)")
    if args.shards != 1:
        raise SystemExit("--shards > 1: not ported yet")
    if args.npz or args.content or args.cites:
        raise SystemExit("--npz / --content / --cites: not ported yet")
    if args.avg_degree is None:
        args.avg_degree = 13.3 if args.clustered else 7.1
    return args


@dataclasses.dataclass
class Setup:
    """Everything a training run needs, on ``device``."""

    device: torch.device
    graph: Graph
    data: object  # NodeClassificationData with --clustered, else None
    x: torch.Tensor
    labels: torch.Tensor
    mask: torch.Tensor
    model: GCN
    opt: torch.optim.Optimizer
    tile_frac: Optional[float]  # share of edges on hybrid tiles (--clustered)


def prepare(args: argparse.Namespace) -> Setup:
    """Build the graph, features, model and optimizer that ``args`` describe."""
    device = resolve_device(args.device)

    from pygcn_tpu_torch.graph.datasets import chung_lu_graph
    from pygcn_tpu_torch.graph.transform import sym_normalize, symmetrize_max
    from pygcn_tpu_torch.train.optim import adam_l2

    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    data = None
    tile_frac = None
    if args.clustered:
        from pygcn_tpu_torch.graph.datasets import community_classification
        from pygcn_tpu_torch.parallel.partition import locality_order, reorder_dataset
        from pygcn_tpu_torch.utils import native

        data = community_classification(
            n=args.n_nodes, avg_degree=args.avg_degree,
            n_classes=args.n_classes, feat_dim=args.feat_dim, seed=args.seed,
            build_dense=False, build_bcsr=False, build_ell=False,
            build_hybrid=False, build_colpanel=False,
        )
        data = reorder_dataset(data, locality_order(data.graph, "auto"))
        # layouts on the ordered ids, by the Graph.from_coo auto-policy
        graph = Graph.from_scipy(data.graph.to_scipy(), is_symmetric=True,
                                 build_dense=False, build_bcsr=False,
                                 hybrid_min_edges_per_tile=64)
        data.graph = graph
        if graph.hybrid is not None:
            tile_frac = graph.hybrid.tile_edges / graph.n_edges
        print(f"clustered pipeline: locality order (graphkit "
              f"{'loaded' if native.available() else 'missing'}) + layouts built in "
              f"{time.time() - t0:.1f}s"
              + (f", tile_frac={tile_frac:.4f}, tiles="
                 f"{0 if graph.hybrid.bcsr is None else graph.hybrid.bcsr.data.shape[0]}"
                 if graph.hybrid is not None else ""))
        x = torch.from_numpy(data.features)
        labels = torch.from_numpy(data.labels.astype(np.int64))
        mask = torch.zeros(graph.n_nodes)
        mask[torch.from_numpy(data.idx_train.astype(np.int64))] = 1.0
        args.feat_dim, args.n_classes = x.shape[1], data.n_classes
    else:
        adj = sym_normalize(symmetrize_max(
            chung_lu_graph(args.n_nodes, args.avg_degree, seed=args.seed)))
        graph = Graph.from_scipy(adj, is_symmetric=True, build_dense=False, build_bcsr=False)
        x = torch.from_numpy(rng.normal(size=(graph.n_nodes, args.feat_dim)).astype(np.float32))
        labels = torch.from_numpy(rng.integers(0, args.n_classes, graph.n_nodes).astype(np.int64))
        mask = torch.from_numpy((rng.uniform(size=graph.n_nodes) < 0.1).astype(np.float32))
    print(f"graph: {graph.n_nodes} nodes, {graph.n_edges} edges "
          f"(built in {time.time() - t0:.1f}s)")

    graph = graph.to(device)
    x, labels, mask = x.to(device), labels.to(device), mask.to(device)
    dims = [args.feat_dim] + [args.hidden] * (args.layers - 1) + [args.n_classes]
    model = GCN(dims, generator=torch.Generator().manual_seed(args.seed),
                remat=args.remat).to(device)
    opt = adam_l2(model.parameters(), args.lr, args.weight_decay)
    return Setup(device, graph, data, x, labels, mask, model, opt, tile_frac)


def main(argv=None):
    """Run the CLI. With ``--clustered`` returns a dict of the run's results
    (accuracies, step and evaluation counts, ``tile_frac``, the ``graph`` on
    its device and, with ``--memstats``, ``peak_mem_bytes``); else the
    seconds per epoch."""
    args = parse_args(argv)
    run = prepare(args)
    device = run.device

    def run_step():
        return train_step(run.model, run.opt, run.x, run.labels, run.mask, run.graph)

    @torch.no_grad()
    def predict():
        return run.model(run.x, run.graph)

    if args.memstats and device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if args.clustered:
        result = _run_convergence(args, run.data, run_step, predict)
        result.update(tile_frac=run.tile_frac, graph=run.graph)
    else:
        result = _time_epochs(args, run.graph, run_step)
    if args.memstats:
        if device.type == "cuda":
            peak = torch.cuda.max_memory_allocated(device)
            print(f"peak device memory: {peak / 2**30:.3f} GiB "
                  f"(torch.cuda.max_memory_allocated)")
        else:
            peak = None
            print("peak device memory: not measured (not a CUDA device)")
        if isinstance(result, dict):
            result["peak_mem_bytes"] = peak
    return result


def _time_epochs(args, graph, run_step):
    """Warm up once, then time ``--epochs`` steps; returns seconds per epoch."""
    float(run_step())  # warm-up; reading the loss waits for the device
    t0 = time.time()
    for _ in range(args.epochs):
        loss = run_step()
    loss_val = float(loss)
    dt = (time.time() - t0) / args.epochs
    spmm_equiv = args.layers * 2  # forward A@x and backward A^T@g per layer
    print(f"epoch time: {dt * 1e3:.1f} ms  loss={loss_val:.4f}  "
          f"~{graph.n_edges * spmm_equiv / dt / 1e6:.0f} Medge-traversals/s")
    return dt


def _run_convergence(args, data, run_step, predict):
    """Early-stopped training; reports ms/epoch, best val and test at best.

    Returns a dict with the accuracies, the number of training ``steps`` and
    evaluation forwards (``evals``) run, including the first (warm-up) pair,
    and the last ``loss``.
    """
    labels = np.asarray(data.labels)
    idx_val = np.asarray(data.idx_val)
    idx_test = np.asarray(data.idx_test)

    def preds_now():
        return predict().argmax(dim=1).cpu().numpy()

    t_wall = time.time()
    loss_v = float(run_step())
    preds_now()
    steps, evals = 1, 1
    warmup_s = time.time() - t_wall

    best_val, best_epoch, test_at_best = -1.0, 0, 0.0
    train_s = 0.0
    epochs = 0
    eval_every = max(1, args.eval_every)
    for ep in range(args.max_epochs):
        t1 = time.time()
        loss_v = float(run_step())  # waits for the device
        train_s += time.time() - t1
        steps += 1
        epochs += 1
        out_of_time = args.max_wall_s is not None and time.time() - t_wall > args.max_wall_s
        if ep % eval_every == 0 or out_of_time or ep == args.max_epochs - 1:
            preds = preds_now()
            evals += 1
            va = float((preds[idx_val] == labels[idx_val]).mean())
            if va > best_val:
                best_val, best_epoch = va, ep
                test_at_best = float((preds[idx_test] == labels[idx_test]).mean())
            if ep % 10 == 0 or out_of_time:
                print(f"epoch {ep}: loss={loss_v:.4f} val={va:.4f} "
                      f"(best {best_val:.4f} @ {best_epoch})")
        if ep - best_epoch >= args.patience:
            break
        if out_of_time:
            print(f"wall budget {args.max_wall_s:.0f}s reached at epoch {ep}")
            break
    total = time.time() - t_wall
    epoch_s = train_s / max(epochs, 1)
    print(f"converged: best val={best_val:.4f} test={test_at_best:.4f} "
          f"@ epoch {best_epoch} ({epochs} run, patience {args.patience})")
    print(f"timing: {epoch_s * 1e3:.1f} ms/epoch train, warm-up {warmup_s:.1f}s, "
          f"total wall {total:.1f}s")
    return {"val": best_val, "test": test_at_best, "epochs": epochs,
            "best_epoch": best_epoch, "epoch_s": epoch_s, "total_s": total,
            "steps": steps, "evals": evals, "loss": loss_v}


if __name__ == "__main__":
    main()
