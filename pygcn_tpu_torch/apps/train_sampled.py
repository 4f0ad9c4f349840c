"""Minibatch GNN training with neighbourhood sampling (the Reddit-scale mode).

The port of ``pygcn_tpu/apps/train_sampled.py``, ``BASELINE.json``'s
"Reddit with neighborhood sampling" configuration: fixed-fanout layered
sampling on the host (``ops/sampling.py``), one producer thread ahead of
the device's steps, and on the device a feature gather, the fixed-fanout
block aggregations and Adam. ``--model gcn`` stacks sampled GCN layers;
``gat`` and ``gatv2`` attend over each sampled neighbourhood
(``--gat_heads`` heads of ``--hidden`` on inner layers, one head of
``n_classes`` on the last). Synthetic SBM data at the requested scale, or a
dataset in the ``.npz`` format (``--npz``).

The features stay on the device; each step receives the batch's input node
ids and gathers their rows there, so only ids, the block arrays and labels
cross from the host. ``--out_dir`` writes ``checkpoint_last.pkl`` at every
epoch boundary and, on SIGTERM/SIGINT, mid-epoch (the epoch then restarts on
``--resume``); the checkpoint keeps the sampler's draw counter as it stood
at the start of that epoch, so a resumed run draws the neighbourhoods an
uninterrupted one draws.

``--shards N`` (above 1) trains data-parallel over N ranks
(``parallel/dp_sampled.py``): ``--batch_size`` is the global batch, each
rank samples its shard (``ShardedNeighborSampler(shards=[rank])``; the
draw counter advances by ``N`` times the layers a batch, and the checkpoint
keeps it), steps on it, and one all-reduce averages the loss and the
gradients before Adam. ``--feature_sharded`` row-shards the features over
the ranks, each step fetching its input rows with one all-to-all;
``--align_seeds`` routes each seed to the rank owning its rows. The ranks
are those of the process group this process belongs to (``torchrun``), or
N started here (gloo on ``--device cpu``, one card each on ``cuda``: more
than the visible cards are refused); rank 0 alone prints and writes the
checkpoint. ``--sample_workers`` is the thread pool of
``ShardedNeighborSampler`` when one process samples several shards (a rank
samples one, so it changes nothing here, and with ``--shards 1`` it is
ignored, as in the JAX CLI); the blocks are the same bits either way.

Runs on ``--device cuda`` (the default; raises when no card is present) or,
when asked, ``--device cpu``.

Usage::

    python -m pygcn_tpu_torch.apps.train_sampled --n_nodes 50000 --fanouts 10 10 \\
        --batch_size 512 --epochs 3
    python -m pygcn_tpu_torch.apps.train_sampled --n_nodes 232965 --avg_degree 489 \\
        --feat_dim 602 --n_classes 41 --fanouts 25 10 --batch_size 1024 --epochs 1
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import os
import time
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from pygcn_tpu_torch import convert
from pygcn_tpu_torch.nn import init
from pygcn_tpu_torch.ops.sampling import (
    NeighborSampler,
    SampledBatch,
    iter_sampled_batches,
    sampled_gat_forward,
    sampled_gatv2_forward,
    sampled_gcn_forward,
)
from pygcn_tpu_torch.parallel.launcher import any_rank
from pygcn_tpu_torch.train.checkpoint import (
    adam_state,
    load_adam_state,
    load_checkpoint,
    save_checkpoint_state,
)
from pygcn_tpu_torch.train.optim import adam_l2
from pygcn_tpu_torch.train.preempt import PreemptionGuard
from pygcn_tpu_torch.utils.device import resolve_device

# the flags that decide the dataset: a prepared dataset serves any run whose
# flags agree on these
DATA_FLAGS = ("npz", "n_nodes", "avg_degree", "feat_dim", "n_classes", "seed", "homophily",
              "feature_signal", "train_per_class", "locality")


class SampledModel(nn.Module):
    """Per-layer parameters under the JAX package's names (``w``, ``b``,
    ``a_src``, ...), applied by ``forward_fn`` of ``ops/sampling.py``.
    ``layers``: per layer a dict of tensors (the subclasses' ``init`` draws
    them at random; ``convert.sampled_params_to_state_dict`` loads JAX's
    lists)."""

    forward_fn = None

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.ParameterDict({k: nn.Parameter(v) for k, v in layer.items()}) for layer in layers)

    def forward(self, blocks, x_input: torch.Tensor) -> torch.Tensor:
        return type(self).forward_fn(self.layers, blocks, x_input)


class SampledGCN(SampledModel):
    """Sampled GCN layers, ReLU between them."""

    forward_fn = staticmethod(sampled_gcn_forward)

    @classmethod
    def init(cls, dims, *, generator: torch.Generator) -> "SampledGCN":
        """Layers ``dims[0] -> ... -> dims[-1]`` with GraphConv's bounds."""
        return cls([{"w": init.graphconv_weight(fi, fo, generator),
                     "b": init.graphconv_bias(fo, generator)}
                    for fi, fo in zip(dims[:-1], dims[1:])])


def gat_layer_dims(n_layers: int, feat_dim: int, heads: int, hidden: int, n_classes: int):
    """``(in, heads, per-head width)`` of each attention layer: heads of
    ``hidden`` concatenated on inner layers, one head of ``n_classes`` last."""
    if n_layers == 1:
        return [(feat_dim, 1, n_classes)]
    return ([(feat_dim, heads, hidden)] + [(heads * hidden, heads, hidden)] * (n_layers - 2)
            + [(heads * hidden, 1, n_classes)])


class SampledGAT(SampledModel):
    forward_fn = staticmethod(sampled_gat_forward)

    @classmethod
    def init(cls, layer_dims, *, generator: torch.Generator) -> "SampledGAT":
        return cls([{"w": init.graphconv_weight(fi, h * fo, generator),
                     "a_src": init.graphconv_weight(h, fo, generator),
                     "a_dst": init.graphconv_weight(h, fo, generator),
                     "b": init.graphconv_bias(h * fo, generator)}
                    for fi, h, fo in layer_dims])


class SampledGATv2(SampledModel):
    forward_fn = staticmethod(sampled_gatv2_forward)

    @classmethod
    def init(cls, layer_dims, *, generator: torch.Generator) -> "SampledGATv2":
        return cls([{"w_l": init.graphconv_weight(fi, h * fo, generator),
                     "w_r": init.graphconv_weight(fi, h * fo, generator),
                     "a": init.graphconv_weight(h, fo, generator),
                     "b": init.graphconv_bias(h * fo, generator)}
                    for fi, h, fo in layer_dims])


MODELS = {"gcn": SampledGCN, "gat": SampledGAT, "gatv2": SampledGATv2}


def build_model(args: argparse.Namespace, n_classes: int) -> SampledModel:
    gen = torch.Generator().manual_seed(args.seed)
    if args.model == "gcn":
        dims = [args.feat_dim] + [args.hidden] * (len(args.fanouts) - 1) + [n_classes]
    else:
        dims = gat_layer_dims(len(args.fanouts), args.feat_dim, args.gat_heads, args.hidden,
                              n_classes)
    return MODELS[args.model].init(dims, generator=gen)


def train_step(model: SampledModel, opt: torch.optim.Optimizer, blocks, x_in: torch.Tensor,
               y: torch.Tensor) -> torch.Tensor:
    """One step: mean NLL over the seeds, backward, Adam; returns the loss
    before the update (as the JAX step does)."""
    opt.zero_grad(set_to_none=True)
    logits = model(blocks, x_in)
    loss = F.nll_loss(F.log_softmax(logits, dim=1), y)
    loss.backward()
    opt.step()
    return loss.detach()


@dataclasses.dataclass
class Prepared:
    """A dataset ready for sampled training on ``device``."""

    flags: tuple  # the DATA_FLAGS values it was built from
    device: torch.device
    data: object  # NodeClassificationData, no layout built
    adj: sp.csr_matrix  # the sampler's adjacency (int64 indices)
    x_full: Optional[torch.Tensor]  # [N, F] features on the device (None: row-sharded)
    labels: np.ndarray  # [N] int64
    setup_s: dict  # host seconds by stage


def _data_flags(args) -> tuple:
    return tuple(getattr(args, f) for f in DATA_FLAGS)


def prepare(args: argparse.Namespace, device: torch.device) -> Prepared:
    """The dataset, the sampler's CSR and the features on ``device``, with
    the host seconds of each stage."""
    from pygcn_tpu_torch.graph.datasets import load_npz_dataset, sbm_classification

    flags = _data_flags(args)
    # the sampler reads the CSR alone: build no layout
    bare = dict(build_dense=False, build_bcsr=False, build_ell=False, build_hybrid=False,
                build_colpanel=False)
    setup_s = {}
    t0 = time.perf_counter()
    if args.npz:
        data = load_npz_dataset(args.npz, **bare)
    else:
        data = sbm_classification(
            n=args.n_nodes, n_classes=args.n_classes, feat_dim=args.feat_dim,
            avg_degree=args.avg_degree, seed=args.seed, homophily=args.homophily,
            feature_signal=args.feature_signal,
            train_per_class=args.train_per_class or args.n_nodes // (4 * args.n_classes),
            n_val=1000, n_test=2000, **bare)
    setup_s["data"] = time.perf_counter() - t0
    if args.locality:
        from pygcn_tpu_torch.parallel.partition import locality_order, reorder_dataset

        t0 = time.perf_counter()
        data = reorder_dataset(data, locality_order(data.graph))
        setup_s["locality"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    csr = data.graph.to_scipy().tocsr()
    adj = sp.csr_matrix((csr.data, csr.indices.astype(np.int64), csr.indptr.astype(np.int64)),
                        shape=csr.shape)
    del csr
    setup_s["sampler_csr"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    x_full = None  # with --feature_sharded each rank takes its own rows
    if not (args.feature_sharded and args.shards > 1):
        x_full = torch.from_numpy(data.features).to(device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    setup_s["features_to_device"] = time.perf_counter() - t0
    return Prepared(flags, device, data, adj, x_full, np.asarray(data.labels, np.int64), setup_s)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs a CUDA card")
    ap.add_argument("--n_nodes", type=int, default=20000)
    ap.add_argument("--avg_degree", type=float, default=10.0,
                    help="synthetic-graph density (the Reddit configuration: 489)")
    ap.add_argument("--feat_dim", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--n_classes", type=int, default=8)
    ap.add_argument("--fanouts", type=int, nargs="+", default=[10, 10])
    ap.add_argument("--batch_size", type=int, default=512)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefetch", type=int, default=2,
                    help="host-sampling lookahead depth (0 = serial)")
    ap.add_argument("--model", choices=["gcn", "gat", "gatv2"], default="gcn",
                    help="gat/gatv2: attention over each sampled neighbourhood "
                         "(--hidden = per-head width; v2 = dynamic attention)")
    ap.add_argument("--gat_heads", type=int, default=4)
    ap.add_argument("--homophily", type=float, default=0.9,
                    help="exact edge homophily of the synthetic SBM")
    ap.add_argument("--feature_signal", type=float, default=0.35,
                    help="class-slice Bernoulli rate of the synthetic features")
    ap.add_argument("--train_per_class", type=int, default=0,
                    help="labelled training nodes per class (0 = n_nodes / (4 * n_classes))")
    ap.add_argument("--npz", default=None,
                    help="train on a dataset in the .npz interchange format instead of "
                         "synthetic SBM data")
    ap.add_argument("--shards", type=int, default=1,
                    help="data-parallel ranks over a 'data' mesh; --batch_size is the GLOBAL "
                         "batch (must divide)")
    ap.add_argument("--sample_workers", type=int, default=0,
                    help="threads of the sharded sampler when one process samples several "
                         "shards (a rank samples one; bit-identical to serial; ignored with "
                         "--shards 1)")
    ap.add_argument("--feature_sharded", action="store_true",
                    help="row-shard node features over the ranks instead of replicating "
                         "them; each step fetches its input rows with one all_to_all "
                         "(needs --shards > 1)")
    ap.add_argument("--align_seeds", action="store_true",
                    help="route each seed to the rank owning its feature rows (same global "
                         "gradient, fewer rows moved on locality-ordered graphs; needs "
                         "--feature_sharded)")
    ap.add_argument("--locality", action="store_true",
                    help="relabel nodes community-contiguously (locality_order) first")
    ap.add_argument("--eval_every", type=int, default=0,
                    help="print validation accuracy every N epochs (0 = only the final "
                         "test accuracy)")
    ap.add_argument("--out_dir", default=None,
                    help="write checkpoint_last.pkl per epoch (and on SIGTERM/SIGINT) "
                         "for --resume")
    ap.add_argument("--resume", action="store_true",
                    help="continue from <out_dir>/checkpoint_last.pkl")
    args = ap.parse_args(argv)
    # the JAX package's own checks, in its order
    if args.feature_sharded and args.shards <= 1:
        raise SystemExit("--feature_sharded needs --shards > 1")
    if args.align_seeds and not args.feature_sharded:
        raise SystemExit("--align_seeds needs --feature_sharded")
    return args


def _to_device(batch: SampledBatch, y: np.ndarray, device):
    return ([b.to(device) for b in batch.blocks], torch.from_numpy(batch.input_nodes).to(device),
            torch.from_numpy(y).to(device))


def h2d_bytes(batch: SampledBatch, y: np.ndarray) -> int:
    """Bytes one training step copies from the host: blocks, ids, labels."""
    return sum(b.nbytes for b in batch.blocks) + batch.input_nodes.nbytes + y.nbytes


def epoch_seed_batches(idx_train: np.ndarray, batch_size: int, seed: int, epoch: int):
    """The seed batches of ``epoch``: a permutation of ``idx_train`` from a
    stream of its own (epoch k's order does not depend on having run epochs
    0..k-1, so --resume replays the same schedule), the short last batch
    topped up from its start."""
    perm = np.random.default_rng([seed, epoch]).permutation(idx_train)
    for s in range(max(1, len(idx_train) // batch_size)):
        seeds = perm[s * batch_size:(s + 1) * batch_size]
        if seeds.size < batch_size:
            seeds = np.concatenate([seeds, perm[:batch_size - seeds.size]])
        yield seeds


def run_dp_batch(dp_step, prep: Prepared, batch: SampledBatch, x_train: torch.Tensor,
                 mesh, shard_size: Optional[int] = None):
    """One data-parallel step on this rank's shard ``batch``: its blocks,
    ids and labels to the device and ``dp_step`` (``parallel/dp_sampled``),
    which gathers its rows from the replicated ``x_train`` or, with
    ``shard_size``, fetches them from every rank's row block ``x_train``
    after building the plan of every rank's input nodes (collectives every
    rank joins). Returns the loss and the rows the fetch moved between
    ranks (0 when replicated)."""
    from pygcn_tpu_torch.parallel.dp_sampled import build_fetch_plan, gather_input_nodes

    blocks, input_nodes, y = _to_device(batch, prep.labels[batch.output_nodes], prep.device)
    if shard_size is None:
        return dp_step(blocks, input_nodes, x_train, y), 0
    plan = build_fetch_plan(gather_input_nodes(batch.input_nodes, mesh), shard_size)
    return dp_step(blocks, plan, x_train, y), int(plan.send_counts.sum())


def run_batch(model: SampledModel, opt: torch.optim.Optimizer, prep: Prepared,
              seeds: np.ndarray, batch: SampledBatch) -> torch.Tensor:
    """One training step on a sampled batch: its blocks, ids and labels to
    the device, the feature gather there, then :func:`train_step`."""
    blocks, input_nodes, y = _to_device(batch, prep.labels[seeds], prep.device)
    with record_function("sampled.feature_gather"):  # a profiler range (chip_smoke.py)
        x_in = prep.x_full.index_select(0, input_nodes)
    return train_step(model, opt, blocks, x_in, y)


@torch.no_grad()
def evaluate(model: SampledModel, prep: Prepared, sampler: NeighborSampler, idx) -> float:
    """Accuracy on ``idx`` over one batch drawn from ``sampler``."""
    idx = np.asarray(idx)
    batch = sampler.sample(idx)
    blocks, input_nodes, _ = _to_device(batch, prep.labels[idx], prep.device)
    x_in = (prep.x_full.index_select(0, input_nodes) if prep.x_full is not None else
            torch.from_numpy(prep.data.features[batch.input_nodes]).to(prep.device))
    logits = model(blocks, x_in)
    return float((logits.argmax(1).cpu().numpy() == prep.labels[idx]).mean())


def main(argv=None, prepared: Optional[Prepared] = None):
    """Run the CLI; returns None when preempted, else a dict: ``acc`` (test
    accuracy), ``loss`` (the last batch's), ``losses`` (every batch's),
    ``n_batches``, ``dt`` and ``ms_per_batch`` (host sampling included),
    ``wait_ms`` and ``step_ms`` (per batch: waiting on the sampler, and the
    step up to its device sync), ``h2d_bytes`` (mean per batch),
    ``node_counts`` (per batch, the node count of each layer's input,
    innermost first), ``peak_mem_bytes`` (CUDA), ``fetch_rows_moved`` (rows
    the row-sharded fetch moved between ranks), the ``model``, its ``opt``,
    the training ``sampler``, the ``prepared`` data, and for one more step
    ``sample`` (seeds → this rank's batch) and ``run_step(seeds, batch)``
    (→ its loss). ``prepared``: a
    dataset from an earlier run with the same data flags (its host set-up
    is then not paid again). With ``--shards`` above 1, this rank's result
    (:func:`train`), or rank 0's plain values when the ranks were started
    here."""
    args = parse_args(argv)
    mesh = None
    if args.shards > 1:
        from pygcn_tpu_torch.parallel.launcher import shard_mesh

        mesh, result = shard_mesh(args.shards, args.device, argv, _rank_main)
        if mesh is None or mesh.coords is None:  # ranks started here, or outside the mesh
            return result
    device = resolve_device(args.device)
    from pygcn_tpu_torch.apps.common import set_process_title

    set_process_title("train_sampled")
    quiet = mesh is not None and mesh.rank != 0
    with contextlib.redirect_stdout(io.StringIO()) if quiet else contextlib.nullcontext():
        if prepared is None:
            prepared = prepare(args, device)
        elif prepared.flags != _data_flags(args) or prepared.device != device:
            raise ValueError("prepared data was built from other data flags or for another "
                             "device")
        return train(args, prepared, mesh)


def _rank_main(argv):
    """A started rank's job: the CLI inside the group, its plain values."""
    from pygcn_tpu_torch.parallel.launcher import plain_values

    return plain_values(main(argv))


def train(args: argparse.Namespace, prep: Prepared, mesh=None):
    """Train on ``prep`` as :func:`main` reports it: on one device, or with
    ``mesh`` (a 1-D ``data`` mesh, every rank calling this) data-parallel,
    replicated or, with ``args.feature_sharded``, row-sharded features
    (``args.align_seeds`` routing each seed to its rows' rank); ``args.shards``
    is read by :func:`main` alone. Only rank 0 writes the checkpoint."""
    device = prep.device
    data = prep.data
    args.feature_sharded = args.feature_sharded and mesh is not None
    args.feat_dim = data.features.shape[1]
    print(f"data: {data.graph.n_nodes} nodes, {data.graph.n_edges} edges, "
          f"{args.feat_dim} features; host set-up "
          + ", ".join(f"{k} {v:.1f}s" for k, v in prep.setup_s.items()), flush=True)

    sampler = NeighborSampler(prep.adj, fanouts=args.fanouts, mode="gcn", seed=args.seed)
    model = build_model(args, data.n_classes).to(device)
    opt = adam_l2(model.parameters(), args.lr)

    ckpt_last = None
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        ckpt_last = os.path.join(args.out_dir, "checkpoint_last.pkl")
    start_epoch = 0
    if args.resume:
        if not (ckpt_last and os.path.exists(ckpt_last)):
            raise SystemExit("--resume needs an --out_dir with checkpoint_last.pkl")
        payload = load_checkpoint(ckpt_last)
        model.load_state_dict(convert.sampled_params_to_state_dict(payload["params"]))
        load_adam_state(opt, model, payload["opt_state"])
        start_epoch = payload["epoch"]
        sampler.n_draws = int(payload.get("extra", {}).get("n_draws", 0))
        print(f"resumed from epoch {start_epoch}")

    def save(epoch: int, n_draws: int) -> None:
        if mesh is None or mesh.rank == 0:
            save_checkpoint_state(convert.state_dict_to_sampled_params(model.state_dict()),
                                  epoch, adam_state(opt, model), {}, ckpt_last,
                                  extra={"n_draws": int(n_draws)})

    sample_fn = None
    moved = [0]  # rows the feature fetch moved between ranks

    def step_on(seeds, batch):
        return run_batch(model, opt, prep, seeds, batch)

    if mesh is not None:
        from pygcn_tpu_torch.parallel.dp_sampled import (ShardedNeighborSampler,
                                                         make_dp_sampled_step,
                                                         shard_feature_rows)

        shard_size = None
        if args.feature_sharded:
            # this rank's block of rows; the whole matrix stays on the host
            x_train, shard_size = shard_feature_rows(mesh, data.features)
        else:
            x_train = prep.x_full
        sharded = ShardedNeighborSampler(
            sampler, mesh.size("data"), workers=args.sample_workers,
            align_shard_size=shard_size if args.align_seeds else None,
            shards=[mesh.coord("data")])
        dp_step = make_dp_sampled_step(mesh, model, opt, feature_sharded=args.feature_sharded)

        def sample_fn(seeds):
            return sharded(seeds)[0]

        def step_on(seeds, batch):
            loss, rows = run_dp_batch(dp_step, prep, batch, x_train, mesh, shard_size)
            moved[0] += rows
            return loss

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    losses, node_counts = [], []
    n_batches, copied = 0, 0
    # the split of a batch's time: waiting on the host sampler (the producer
    # behind) against the step, up to the device sync of its loss
    wait_s = step_s = 0.0
    guard = PreemptionGuard() if ckpt_last else None
    with guard if guard is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        for epoch in range(start_epoch, start_epoch + args.epochs):
            epoch_draws = sampler.n_draws
            batches = iter_sampled_batches(
                sampler, epoch_seed_batches(data.idx_train, args.batch_size, args.seed, epoch),
                prefetch=args.prefetch, sample_fn=sample_fn)
            with contextlib.closing(batches):
                while True:
                    t_w = time.perf_counter()
                    try:
                        seeds, batch = next(batches)
                    except StopIteration:
                        break
                    wait_s += time.perf_counter() - t_w
                    t_s = time.perf_counter()
                    # the ranks stop together
                    if guard is not None and any_rank(guard.requested, mesh):
                        # preempted mid-epoch: this epoch restarts on --resume,
                        # from the draw counter it started with
                        save(epoch, epoch_draws)
                        print(f"preempted in epoch {epoch}: saved {ckpt_last}; "
                              "rerun with --resume to continue")
                        return None
                    loss = step_on(seeds, batch)
                    losses.append(loss.item())  # the device sync
                    step_s += time.perf_counter() - t_s
                    n_batches += 1
                    copied += h2d_bytes(batch, prep.labels[batch.output_nodes])
                    node_counts.append((batch.input_nodes.size,
                                        *(b.cols.shape[0] for b in batch.blocks)))
            if args.eval_every and (epoch + 1) % args.eval_every == 0:
                # drawn from the training sampler's stream, as in the JAX package
                va = evaluate(model, prep, sampler, data.idx_val)
                print(f"epoch {epoch}: loss={losses[-1]:.4f} val_acc={va:.4f} "
                      f"({(time.perf_counter() - t0) / n_batches * 1e3:.1f} ms/batch cum.)",
                      flush=True)
            if ckpt_last:  # the epoch boundary: resumable after a hard crash
                save(epoch + 1, sampler.n_draws)
        dt = time.perf_counter() - t0

    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    # test accuracy with a wider-fanout evaluation sample
    eval_sampler = NeighborSampler(prep.adj, fanouts=[f * 2 for f in args.fanouts], seed=1)
    acc = evaluate(model, prep, eval_sampler, data.idx_test)
    n = max(n_batches, 1)
    loss_val = losses[-1] if losses else float("nan")
    print(f"{n_batches} minibatches in {dt:.1f}s ({dt / n * 1e3:.1f} ms/batch incl. host "
          f"sampling); final loss {loss_val:.4f}, test acc {acc:.4f}")
    print(f"utilization split: sampler-wait {wait_s / n * 1e3:.1f} ms/batch, step "
          f"(to its device sync) {step_s / n * 1e3:.1f} ms/batch (overlap hides host "
          "sampling when wait ~ 0)")
    return {"acc": acc, "loss": loss_val, "losses": losses, "n_batches": n_batches, "dt": dt,
            "ms_per_batch": dt / n * 1e3, "wait_ms": wait_s / n * 1e3,
            "step_ms": step_s / n * 1e3, "h2d_bytes": copied / n, "node_counts": node_counts,
            "peak_mem_bytes": peak, "fetch_rows_moved": moved[0], "model": model, "opt": opt,
            "sampler": sampler, "prepared": prep, "run_step": step_on,
            "sample": sample_fn or sampler.sample}


if __name__ == "__main__":
    main()
