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

``--shards N`` (N > 1) partitions the graph over N ranks, one process each
(``parallel/``, the port of the JAX package's graph-parallel path): the
halo-exchange GCN, GAT, GATv2, SAGE or APPNP (not GIN, as in JAX) on the
clustered build without the hybrid layout or column panels, with no tile
kernel. It starts the N ranks itself (gloo on ``--device cpu``; NCCL with
one card per rank on ``cuda``, refused before starting anything when fewer
cards are visible), or, started by ``torchrun``, runs as one of them. Rank
0 reports, and ``main`` returns its result.

Runs on ``--device cuda`` (the default; raises when no card is present) or,
when asked, ``--device cpu``, where the kernels are replaced by their plain
versions.

Usage::

    python -m pygcn_tpu_torch.apps.train_fullgraph --clustered --max_epochs 50
    python -m pygcn_tpu_torch.apps.train_fullgraph --clustered --model gat --hidden 8
    python -m pygcn_tpu_torch.apps.train_fullgraph --clustered --model gatv2 --hidden 8
    python -m pygcn_tpu_torch.apps.train_fullgraph --clustered --model sage
    python -m pygcn_tpu_torch.apps.train_fullgraph --npz data/arxiv.npz --epochs 50
    python -m pygcn_tpu_torch.apps.train_fullgraph --clustered --shards 4 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import sys
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
from pygcn_tpu_torch.utils.logging import span

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
        with span("model.forward"):
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
    with span("train_step"):
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
                    help="partition the graph over this many ranks (one process each: "
                         "gloo on --device cpu, NCCL with one card each on cuda) and train "
                         "the halo-exchange model (gcn/gat/gatv2/sage/appnp)")
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
    if args.avg_degree is None:
        args.avg_degree = 13.3 if args.clustered else 7.1
    return args


@dataclasses.dataclass
class Data:
    """The run's data: the graph, the labelled dataset (``--clustered``,
    ``--npz``, ``--content``/``--cites``; else ``None``), features, labels
    and the training mask (on the host from :func:`load_data`)."""

    graph: Graph
    data: object  # NodeClassificationData or None
    x: torch.Tensor
    labels: torch.Tensor
    mask: torch.Tensor
    tile_frac: Optional[float]  # share of edges on hybrid tiles (--clustered)


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
                      seed: int, *, attention: bool, npz: Optional[str] = None,
                      sharded: bool = False):
    """The ``--clustered`` data on the host: community classification with
    shuffled ids and locality ordering (or, when ``npz`` names a file, that
    pre-built, already ordered dataset as it is), then the layouts of the
    ``Graph.from_coo`` auto-policy on the ordered ids (the hybrid layout at
    ``hybrid_min_edges_per_tile=64`` between 8K nodes and
    ``COLPANEL_MIN_NODES``, the column panels above). ``attention`` builds
    what the GAT needs as well: below the threshold the ELL slot path and the
    hybrid tiles, above it the column panels alone. ``sharded`` (``--shards``
    above 1) builds neither the hybrid layout nor column panels, whose
    whole-graph tiles the ranks do not use, and for attention the ELL
    layout, as the JAX package does. The threshold is read when called."""
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
    if sharded:
        kw.update(build_hybrid=False, build_colpanel=False)
        if attention:
            kw.update(build_ell=True)
    elif attention:
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


def load_data(args: argparse.Namespace) -> Data:
    """Build the graph, features, labels and mask that ``args`` describe, on
    the host."""
    from pygcn_tpu_torch.graph.datasets import chung_lu_graph
    from pygcn_tpu_torch.graph.transform import sym_normalize, symmetrize_max

    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    data = None
    tile_frac = None
    if args.clustered:
        data = clustered_dataset(args.n_nodes, args.avg_degree, args.n_classes, args.feat_dim,
                                 args.seed, attention=args.model in ("gat", "gatv2"),
                                 npz=args.npz, sharded=args.shards > 1)
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
    return Data(graph, data, x, labels, mask, tile_frac)


def prepare(args: argparse.Namespace) -> Setup:
    """Build the graph, features, model and optimizer that ``args`` describe."""
    from pygcn_tpu_torch.train.optim import adam_l2

    device = resolve_device(args.device)
    d = load_data(args)
    graph = d.graph
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
    model = model.to(device)
    opt = adam_l2(model.parameters(), args.lr, args.weight_decay)
    return Setup(device, graph, d.data, d.x.to(device), d.labels.to(device), d.mask.to(device),
                 model, opt, d.tile_frac, fwd_kw)


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
    with span("pipeline.layouts"):
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
    returns its loss, for profiling), the run's data as ``prepared`` (a
    :class:`Data` on the device, which :func:`run_sharded` takes), for the
    GAT its ``edge_map``,
    ``hybrid_tiles``, ``tiles_t`` and ``colpanel``, and, with ``--memstats``,
    ``peak_mem_bytes``); on a
    labelled dataset (``--npz``, ``--content``/``--cites``) the dict
    ``{"dt", "val", "test"}``; else the seconds per epoch. With ``--shards``
    above 1, rank 0's result (:func:`run_sharded`; its plain values when
    the ranks were started here)."""
    args = parse_args(argv)
    if args.shards > 1:
        return _main_sharded(args, sys.argv[1:] if argv is None else list(argv))
    run = prepare(args)

    def run_step():
        return train_step(run.model, run.opt, run.x, run.labels, run.mask, run.graph,
                          **run.fwd_kw)

    @torch.no_grad()
    def predict():
        return run.model(run.x, run.graph, **run.fwd_kw)

    result = _train(args, run.device, run.graph, run.data, run_step, predict)
    if args.clustered:
        result.update(tile_frac=run.tile_frac, graph=run.graph, step=run_step,
                      prepared=Data(run.graph, run.data, run.x, run.labels, run.mask,
                                    run.tile_frac), **run.fwd_kw)
    return result


def _train(args, device: torch.device, graph: Graph, data, run_step, predict, agree=None):
    """Train and report, on one device or on one rank (every rank runs it,
    in step): the early-stopped run with ``--clustered``, else timed epochs
    and, on a labelled dataset, its accuracies; with ``--memstats`` the peak
    device memory. ``agree`` makes a per-rank decision (the wall budget)
    the ranks' common one."""
    if args.memstats and device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if args.clustered:
        result = _run_convergence(args, data, run_step, predict, agree)
    else:
        result = _time_epochs(args, graph, run_step)
        if data is not None:
            result = {"dt": result, **_report_accuracy(data, predict)}
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


def _main_sharded(args, argv: list):
    """``--shards N``: run as a rank of the group this process belongs to
    (one ``torchrun`` started, or :class:`LocalRanks`), else start N ranks
    here, each running this CLI with ``argv``, and return rank 0's result.
    Refused before anything starts: GIN (as in JAX), and more ranks than
    visible cards on ``cuda``."""
    from pygcn_tpu_torch.parallel.launcher import initialize_multihost, start_ranks

    if args.model == "gin":
        raise SystemExit("--shards supports gcn/gat/gatv2/sage/appnp")
    if initialize_multihost(device=args.device).distributed:
        return run_sharded(args)
    return start_ranks(args.shards, args.device, _rank_main, argv)


def _rank_main(argv: list):
    """A started rank's job: the CLI inside the group, its result reduced
    to plain values (the step and model stay in the rank)."""
    from pygcn_tpu_torch.parallel.launcher import plain_values

    return plain_values(main(argv))


def run_sharded(args, d: Optional[Data] = None):
    """This rank's part of ``--shards``: partition the graph of ``d`` (built
    from ``args`` when ``None``) over the ``"graph"`` axis of the process
    group's ranks (``args.shards`` of them; 1 runs the whole plumbing with an
    empty halo), build the distributed model (``DistGCN``, ``DistGAT`` v1 or
    v2, ``DistSAGE`` or ``DistAPPNP``) from the ``--seed`` generator, and
    train and report it as :func:`main` does on one device, the loss and
    the predictions global. Only rank 0 prints; a rank outside the mesh
    returns ``None``. A dict result also carries
    ``plan_s`` (the plan's host build seconds), ``shard_size``, ``halo``
    (slots a peer), ``halo_rows`` (boundary rows the exchange moves), the
    ``model`` and ``step``."""
    import contextlib
    import io

    from pygcn_tpu_torch.parallel import build_dist_plan, make_mesh
    from pygcn_tpu_torch.parallel.dist_gcn import DistGCN, make_dist_classifier_step
    from pygcn_tpu_torch.parallel.dist_spmm import gather_features
    from pygcn_tpu_torch.parallel.launcher import any_rank
    from pygcn_tpu_torch.train.optim import adam_l2

    device = resolve_device(args.device)
    mesh = make_mesh([args.shards], ["graph"], device=device)
    if mesh.coords is None:  # a rank of a larger group, outside the mesh
        return None
    quiet = contextlib.redirect_stdout(io.StringIO()) if mesh.rank else contextlib.nullcontext()
    with quiet:
        d = load_data(args) if d is None else d
        t0 = time.perf_counter()
        plan = build_dist_plan(d.graph, args.shards)
        plan_s = time.perf_counter() - t0
        if d.data is not None:
            args.feat_dim, args.n_classes = d.x.shape[1], d.data.n_classes
        gen = torch.Generator().manual_seed(args.seed)
        dims = [args.feat_dim] + [args.hidden] * (args.layers - 1) + [args.n_classes]
        widths = (args.feat_dim, args.hidden, args.n_classes)
        if args.model in ("gat", "gatv2"):
            from pygcn_tpu_torch.parallel.dist_gat import DistGAT

            model = DistGAT(mesh, plan, *widths, heads=args.gat_heads,
                            v2=args.model == "gatv2", generator=gen)
        elif args.model == "sage":
            from pygcn_tpu_torch.parallel.dist_sage import DistSAGE

            model = DistSAGE(mesh, plan, *widths, generator=gen)
        elif args.model == "appnp":
            from pygcn_tpu_torch.parallel.dist_sage import DistAPPNP

            model = DistAPPNP(mesh, plan, *widths, generator=gen)
        else:
            model = DistGCN(mesh, plan, dims, final_activation=functools.partial(
                F.log_softmax, dim=1), remat=args.remat, generator=gen)
        model = model.to(device)
        opt = adam_l2(model.parameters(), args.lr, args.weight_decay)
        step = make_dist_classifier_step(model, opt)
        xs, labels, mask = (model.shard_x(t) for t in (d.x, d.labels, d.mask))
        print(f"sharded over {args.shards} devices: {plan.shard_size} nodes/shard, "
              f"halo {plan.halo} rows/peer ({plan.halo_rows} boundary rows in all; "
              f"plan built in {plan_s:.2f}s)")

        def run_step():
            return step(xs, labels, mask)

        @torch.no_grad()
        def predict():
            return gather_features(model(xs), mesh)[: d.graph.n_nodes]

        result = _train(args, device, d.graph, d.data, run_step, predict,
                        functools.partial(any_rank, mesh=mesh))
        if isinstance(result, dict):
            result.update(plan_s=plan_s, shard_size=plan.shard_size, halo=plan.halo,
                          halo_rows=plan.halo_rows, model=model, step=run_step)
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


def _run_convergence(args, data, run_step, predict, agree=None):
    """Early-stopped training; reports ms/epoch, best val and test at best.

    Returns a dict with the accuracies, the number of training ``steps`` and
    evaluation forwards (``evals``) run, including the first (warm-up) pair,
    and the last ``loss``. ``agree`` turns each rank's reading of the wall
    budget into the ranks' common decision.
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
        if agree is not None and args.max_wall_s is not None:
            out_of_time = agree(out_of_time)
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
