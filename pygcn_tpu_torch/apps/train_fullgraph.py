"""Full-graph GNN training at ogbn-arxiv scale on one CUDA card.

The port of ``pygcn_tpu/apps/train_fullgraph.py`` for ``--model gcn`` (an
N-layer GCN over the sparse engine), ``--model gat`` (the 2-layer GAT of
``nn/gat.py``, ``--gat_heads`` heads of ``--hidden`` features),
``--model gatv2`` (the same GAT with GATv2 layers) and the 2-layer extension
families ``--model sage``, ``gin`` and ``appnp`` (``nn/sage.py``,
``nn/gin.py``), with Adam with L2 decay and masked NLL. Without
``--clustered`` it times epochs on a synthetic Chung-Lu power-law graph with
random labels, or on a labelled dataset (``--npz``, or ``--content`` with
``--cites``), then reports its validation and test accuracy. With
``--clustered`` it runs the convergence flagship (from a pre-built, already
ordered ``--npz`` file when one is given): a
learnable community-classification graph with shuffled ids, locality
ordering (native label propagation when graphkit loads, else BFS), the
hybrid BCSR+ELL layout whose tiles run on kernel B1 (GCN, SAGE, GIN, APPNP;
B2 with ``BCSR_STREAM``) or on the tile-attention kernels B3/B5/B6 (GAT;
B4/B5s/B6s with ``TILE_REVISIT = False``) or B7/B8/B9 (GATv2), per-epoch
validation and early stopping. Above ``COLPANEL_MIN_NODES`` nodes (1M,
the ogbn-products scale of ``chip_smoke.py``) the layout is the
``Graph.from_coo`` auto-policy's column panels: the GCN, SAGE, GIN and APPNP
SpMMs run ``ops/colpanel.py`` and GAT/GATv2 the column-panel attention sweeps
(``ops/gat_colpanel.py``), with no tile kernel.

Runs on ``--device cuda`` (the default; raises when no card is present) or,
when asked, ``--device cpu``, where the kernels are replaced by their plain
versions.

Usage::

    python -m pygcn_tpu_torch.apps.train_fullgraph --clustered --max_epochs 50
    python -m pygcn_tpu_torch.apps.train_fullgraph --clustered --model gat --hidden 8
    python -m pygcn_tpu_torch.apps.train_fullgraph --clustered --model gatv2 --hidden 8
    python -m pygcn_tpu_torch.apps.train_fullgraph --clustered --model sage
    python -m pygcn_tpu_torch.apps.train_fullgraph --npz data/arxiv.npz --epochs 50
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

from pygcn_tpu_torch.graph.graph import COLPANEL_MIN_NODES, Graph
from pygcn_tpu_torch.nn.gat import GAT
from pygcn_tpu_torch.nn.gin import APPNP, GIN
from pygcn_tpu_torch.nn.layers import GraphConv
from pygcn_tpu_torch.nn.sage import SAGE
from pygcn_tpu_torch.train.loop import masked_nll
from pygcn_tpu_torch.utils.device import resolve_device

# --model sage|gin|appnp: the JAX package's 2-layer extension families
EXTENSION_MODELS = {"sage": SAGE, "gin": GIN, "appnp": APPNP}


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


def train_step(model: nn.Module, opt: torch.optim.Optimizer, x, labels, mask, graph,
               **fwd_kw) -> torch.Tensor:
    """One full-graph step; returns the loss before the update (as the JAX step does).

    ``fwd_kw`` goes to the model's forward (the GAT's attention layouts).
    """
    opt.zero_grad(set_to_none=True)
    loss = masked_nll(model(x, graph, **fwd_kw), labels, mask)
    loss.backward()
    opt.step()
    return loss.detach()


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
    ap.add_argument("--layers", type=int, default=3,
                    help="GCN layers; the other models have two")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--weight_decay", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--memstats", action="store_true",
                    help="print the peak device memory of the training run")
    ap.add_argument("--remat", action="store_true",
                    help="recompute layer activations in the backward pass (GCN only)")
    ap.add_argument("--model", default="gcn",
                    choices=["gcn", "gat", "gatv2", *EXTENSION_MODELS],
                    help="gcn; gat or gatv2: the 2-layer multi-head GAT with v1 or "
                         "GATv2 layers (--hidden is the per-head width); sage, gin or "
                         "appnp: the 2-layer extension families (GIN runs on the "
                         "normalised adjacency). --layers and --remat apply to gcn only")
    ap.add_argument("--gat_heads", type=int, default=8)
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
    ap.add_argument("--npz", default=None,
                    help="train on a dataset in the .npz interchange format "
                         "(graph.datasets.load_npz_dataset); with --clustered, a "
                         "pre-built, already ordered convergence dataset")
    ap.add_argument("--content", default=None,
                    help="Planetoid .content file (with --cites: Cora-format data)")
    ap.add_argument("--cites", default=None, help="Planetoid .cites file")
    args = ap.parse_args(argv)
    if args.shards != 1:
        raise SystemExit("--shards > 1: not ported yet")
    if args.avg_degree is None:
        args.avg_degree = 13.3 if args.clustered else 7.1
    return args


@dataclasses.dataclass
class Setup:
    """Everything a training run needs, on ``device``."""

    device: torch.device
    graph: Graph
    data: object  # NodeClassificationData (--clustered, --npz, --content/--cites), else None
    x: torch.Tensor
    labels: torch.Tensor
    mask: torch.Tensor
    model: nn.Module  # GCN, GAT (v1 or v2), SAGE, GIN or APPNP
    opt: torch.optim.Optimizer
    tile_frac: Optional[float]  # share of edges on hybrid tiles (--clustered)
    fwd_kw: dict  # extra forward arguments: the GAT's edge_map, hybrid_tiles, tiles_t, colpanel


def clustered_dataset(n_nodes: int, avg_degree: float, n_classes: int, feat_dim: int,
                      seed: int, *, attention: bool, npz: Optional[str] = None):
    """The ``--clustered`` data on the host: community classification with
    shuffled ids and locality ordering (or, when ``npz`` names a file, that
    pre-built, already ordered dataset as it is), then the layouts of the
    ``Graph.from_coo`` auto-policy on the ordered ids (the hybrid layout at
    ``hybrid_min_edges_per_tile=64`` between 8K nodes and
    ``COLPANEL_MIN_NODES``, the column panels above). ``attention`` builds
    what the GAT needs as well: below the threshold the ELL slot path and the
    hybrid tiles, above it the column panels alone. The threshold is read
    when called."""
    import os

    from pygcn_tpu_torch.graph.datasets import community_classification, load_npz_dataset
    from pygcn_tpu_torch.parallel.partition import locality_order, reorder_dataset
    from pygcn_tpu_torch.utils import native

    t0 = time.time()
    bare = dict(build_dense=False, build_bcsr=False, build_ell=False, build_hybrid=False,
                build_colpanel=False)
    if npz and os.path.exists(npz):
        data = load_npz_dataset(npz, **bare)
    else:
        data = community_classification(
            n=n_nodes, avg_degree=avg_degree, n_classes=n_classes, feat_dim=feat_dim,
            seed=seed, **bare)
        data = reorder_dataset(data, locality_order(data.graph, "auto"))
    kw = dict(is_symmetric=True, build_dense=False, build_bcsr=False,
              hybrid_min_edges_per_tile=64, colpanel_min_nodes=COLPANEL_MIN_NODES)
    if attention:
        big = data.graph.n_nodes > COLPANEL_MIN_NODES
        kw.update(build_ell=not big, build_hybrid=not big, build_colpanel=big)
    graph = Graph.from_scipy(data.graph.to_scipy(), **kw)
    data.graph = graph
    hy, cp = graph.hybrid, graph.colpanel
    print(f"clustered pipeline: locality order (graphkit "
          f"{'loaded' if native.available() else 'missing'}) + layouts built in "
          f"{time.time() - t0:.1f}s"
          + (f", tile_frac={hy.tile_edges / graph.n_edges:.4f}, tiles="
             f"{0 if hy.bcsr is None else hy.bcsr.data.shape[0]}" if hy is not None else "")
          + (f", column panels: {len(cp.panels)} panels, {cp.n_vrows} virtual rows"
             if cp is not None else ""))
    return data


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
        data = clustered_dataset(args.n_nodes, args.avg_degree, args.n_classes, args.feat_dim,
                                 args.seed, attention=args.model in ("gat", "gatv2"),
                                 npz=args.npz)
        if data.graph.hybrid is not None:
            tile_frac = data.graph.hybrid.tile_edges / data.graph.n_edges
    elif args.npz:
        from pygcn_tpu_torch.graph.datasets import load_npz_dataset

        data = load_npz_dataset(args.npz, build_dense=False, build_bcsr=False)
    elif args.content and args.cites:
        from pygcn_tpu_torch.graph.datasets import load_planetoid

        data = load_planetoid(args.content, args.cites, build_dense=False, build_bcsr=False)
    if data is not None:
        graph = data.graph
        x = torch.from_numpy(data.features)
        labels = torch.from_numpy(data.labels.astype(np.int64))
        mask = torch.zeros(graph.n_nodes)
        mask[torch.from_numpy(data.idx_train.astype(np.int64))] = 1.0
        args.feat_dim, args.n_classes = x.shape[1], data.n_classes
    else:
        adj = sym_normalize(symmetrize_max(
            chung_lu_graph(args.n_nodes, args.avg_degree, seed=args.seed)))
        graph = Graph.from_scipy(adj, is_symmetric=True, build_dense=False, build_bcsr=False,
                                 colpanel_min_nodes=COLPANEL_MIN_NODES)
        x = torch.from_numpy(rng.normal(size=(graph.n_nodes, args.feat_dim)).astype(np.float32))
        labels = torch.from_numpy(rng.integers(0, args.n_classes, graph.n_nodes).astype(np.int64))
        mask = torch.from_numpy((rng.uniform(size=graph.n_nodes) < 0.1).astype(np.float32))
    print(f"graph: {graph.n_nodes} nodes, {graph.n_edges} edges "
          f"(built in {time.time() - t0:.1f}s)")

    gen = torch.Generator().manual_seed(args.seed)
    fwd_kw = {}
    if args.model in ("gat", "gatv2"):
        v2 = args.model == "gatv2"
        model = GAT(args.feat_dim, args.hidden, args.n_classes, heads=args.gat_heads, v2=v2,
                    generator=gen)
        fwd_kw = _gat_layouts(graph, v2)
    elif args.model in EXTENSION_MODELS:
        # note: the adjacency here is sym-normalised; GIN's canonical sum
        # aggregator wants raw weights, so with A_hat it runs as a
        # degree-weighted variant (as in the JAX package)
        model = EXTENSION_MODELS[args.model](args.feat_dim, args.hidden, args.n_classes,
                                             generator=gen)
    else:
        dims = [args.feat_dim] + [args.hidden] * (args.layers - 1) + [args.n_classes]
        model = GCN(dims, generator=gen, remat=args.remat)
    graph = graph.to(device)
    fwd_kw = {k: v.to(device) if hasattr(v, "to") else v for k, v in fwd_kw.items()}
    x, labels, mask = x.to(device), labels.to(device), mask.to(device)
    model = model.to(device)
    opt = adam_l2(model.parameters(), args.lr, args.weight_decay)
    return Setup(device, graph, data, x, labels, mask, model, opt, tile_frac, fwd_kw)


def _gat_layouts(graph: Graph, v2: bool) -> dict:
    """The GAT's attention layouts, built on the host: the ELL edge map and,
    when the hybrid layout has tiles and an ELL residual, the exact transpose
    tiles of the tile-attention path (kernels B3/B5/B6, or B7/B8/B9 with
    ``v2``); on a graph with column panels and no ELL (above
    ``COLPANEL_MIN_NODES``), the column-panel attention path, its edges
    checked by ``check_gat_colpanel`` here on the host."""
    from pygcn_tpu_torch.ops.ell import ELL
    from pygcn_tpu_torch.ops.gat import build_edge_map, build_gat_tiles_t

    model = "gatv2" if v2 else "gat"
    kw = {"edge_map": build_edge_map(graph) if graph.ell is not None else None,
          "hybrid_tiles": False, "tiles_t": None, "colpanel": False}
    hy, cp = graph.hybrid, graph.colpanel
    if hy is not None and hy.bcsr is not None and isinstance(hy.ell, ELL):
        kw.update(hybrid_tiles=True, tiles_t=build_gat_tiles_t(graph))
        print(f"{model}: tile-attention path (kernels "
              f"{'B7/B8/B9' if v2 else 'B3/B5/B6'} on {hy.bcsr.data.shape[0]} "
              f"tiles, {hy.tile_edges / graph.n_edges:.1%} of edges; ELL residual)")
    elif cp is not None and graph.ell is None:
        from pygcn_tpu_torch.ops.gat_colpanel import check_gat_colpanel

        check_gat_colpanel(graph)
        kw["colpanel"] = True
        print(f"{model}: colpanel attention path ({len(cp.panels)} panels, "
              f"{cp.n_vrows} virtual rows)")
    return kw


def main(argv=None):
    """Run the CLI. With ``--clustered`` returns a dict of the run's results
    (accuracies, step and evaluation counts, ``tile_frac``, the ``graph`` on
    its device, its training ``step`` (a function that runs one more and
    returns its loss, for profiling), for the GAT its ``edge_map``,
    ``hybrid_tiles``, ``tiles_t`` and ``colpanel``, and, with ``--memstats``,
    ``peak_mem_bytes``); on a
    labelled dataset (``--npz``, ``--content``/``--cites``) the dict
    ``{"dt", "val", "test"}``; else the seconds per epoch."""
    args = parse_args(argv)
    run = prepare(args)
    device = run.device

    def run_step():
        return train_step(run.model, run.opt, run.x, run.labels, run.mask, run.graph,
                          **run.fwd_kw)

    @torch.no_grad()
    def predict():
        return run.model(run.x, run.graph, **run.fwd_kw)

    if args.memstats and device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if args.clustered:
        result = _run_convergence(args, run.data, run_step, predict)
        result.update(tile_frac=run.tile_frac, graph=run.graph, step=run_step, **run.fwd_kw)
    else:
        result = _time_epochs(args, run.graph, run_step)
        if run.data is not None:
            result = {"dt": result, **_report_accuracy(run.data, predict)}
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
    spmm_equiv = args.layers * 3  # fwd + 2 per layer in bwd (dX via A^T, recompute)
    print(f"epoch time: {dt * 1e3:.1f} ms  loss={loss_val:.4f}  "
          f"~{graph.n_edges * spmm_equiv / dt / 1e6:.0f} Medge-traversals/s")
    return dt


def _report_accuracy(data, predict) -> dict:
    """Validation and test accuracy of the trained model on a labelled
    dataset, printed and returned as ``{"val", "test"}``."""
    preds = predict().argmax(dim=1).cpu().numpy()
    labels = np.asarray(data.labels)
    accs = {}
    for split, idx in (("val", data.idx_val), ("test", data.idx_test)):
        accs[split] = float((preds[idx] == labels[idx]).mean())
        print(f"{split} accuracy: {accs[split]:.4f}")
    return accs


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
