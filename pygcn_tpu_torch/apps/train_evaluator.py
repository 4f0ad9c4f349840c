"""Surrogate-evaluator trainer (the reference's main ``gnn-over-mlp.py``).

The port of ``pygcn_tpu/apps/train_evaluator.py`` on one CUDA card
(``--device cuda``, the default; ``--device cpu`` when asked). Pipeline: gt
CSV → predictor node features (standardised demographics + embeddings +
per-sample vaccination flags) → centrality features → one of four assembly
modes → :class:`~pygcn_tpu_torch.nn.models.GCNOverMLP`, trained with Adam +
L2, gradient clipping at 0.1, a plateau scheduler ('max' on the best
validation Spearman so far, factor 0.5, patience 8), early stopping (30),
two best-metric checkpoints (least validation loss, most Spearman), a
preemption checkpoint and ``--resume``; MSE and Spearman metrics
(reference ``pygcn/gnn-over-mlp.py:300-432``).

Features and labels sit on the device; a training step gets its batch by
indexing them there, and the losses of an epoch reach the host in one sync.
Each epoch reshuffles the training order in place with the generator of
``(seed, epoch)`` (:func:`shuffle_epoch`), and ``--resume`` replays the
shuffles of the epochs before the one it resumes, so a resumed run takes the
batches an uninterrupted one would. With ``impl="dense"`` (the evaluator's
co-visitation graph is dense, so ``"auto"`` picks it) every SpMM is a
``torch.mm``; :func:`make_model` also takes ``impl="bcsr"``, whose products
run kernel B1 on the graph's tiles. A finished run writes ``evaluator.pkl``
with the JAX CLI's keys, ``params`` the JAX-shaped tree of NumPy arrays, so
either package's policy scripts can load it.

``--data_parallel`` splits each batch's policy samples over the ranks of a
1-D ``data`` mesh, as the JAX CLI splits them over its devices: the ranks of
the process group this process belongs to (``torchrun``), else one per
visible card on ``cuda`` (started here, as ``train_fullgraph --shards``
starts them) and one on the CPU. Every rank reads the same batches from the
training loader (the JAX CLI's path under this flag, short batches
dropped), computes the single-device model on its slice, and one
all-reduce sums the gradients and the loss before Adam; the loss is the
global batch's mean. Rank 0 alone prints and writes the checkpoints, the
metrics and ``evaluator.pkl``.

Usage::

    python -m pygcn_tpu_torch.apps.train_evaluator --vac_result_path vac.csv \
        --epochs 50 --out_dir eval_run
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import os
import pickle
import sys

import numpy as np
import torch

from pygcn_tpu_torch.apps.common import build_synthetic_world, set_process_title
from pygcn_tpu_torch.data.features import (assemble_evaluator_features, centrality_features,
                                           standardize)
from pygcn_tpu_torch.data.loader import ArrayLoader, kfold_splits, make_split_loaders
from pygcn_tpu_torch.data.vac_results import load_vac_results
from pygcn_tpu_torch.nn.models import GCNOverMLP
from pygcn_tpu_torch.parallel.launcher import any_rank
from pygcn_tpu_torch.train.checkpoint import (adam_state, load_adam_state, load_checkpoint,
                                              load_model_params, model_params,
                                              save_checkpoint_state)
from pygcn_tpu_torch.train.loop import EarlyStopping
from pygcn_tpu_torch.train.metrics import spearman
from pygcn_tpu_torch.train.optim import ReduceLROnPlateau, adam_l2
from pygcn_tpu_torch.train.preempt import PreemptionGuard
from pygcn_tpu_torch.utils.device import resolve_device
from pygcn_tpu_torch.utils.logging import MetricsLogger


def build_predictor_features(world, res) -> np.ndarray:
    """[B, N, 4 demo + E embed + 1 flag] (reference ``pygcn/utils.py:280-311``)."""
    demo = standardize(world.demographics)
    embed = standardize(world.embeddings)
    b = res.num_samples
    n = world.n_cbgs
    f = 4 + embed.shape[1] + 1
    feats = np.zeros((b, n, f), np.float32)
    feats[:, :, :4] = demo
    feats[:, :, 4:-1] = embed
    for i, tags in enumerate(res.vac_tags):
        feats[i, tags, -1] = 1.0
    return feats


def shuffle_epoch(order: np.ndarray, seed: int, epoch: int) -> np.ndarray:
    """Shuffle the training order in place for ``epoch``, as the JAX
    trainer does (each epoch shuffles the previous epoch's order)."""
    np.random.default_rng([seed, epoch]).shuffle(order)
    return order


def epoch_batches(order, batch_size: int) -> list:
    """The epoch's full batches of sample indices (slices of ``order``, an
    array or a tensor), in order; a short last batch is skipped, as in the
    JAX trainer."""
    return [order[b * batch_size:(b + 1) * batch_size]
            for b in range(len(order) // batch_size)]


def make_model(dim_touched: int, n_features: int, hidden: int, seed: int,
               impl: str = "auto", device="cuda") -> GCNOverMLP:
    """The evaluator at the trainer's widths (GCN ``hidden`` wide, MLP head
    64 → 8 → 1), its weights drawn from the generator of ``seed``."""
    return GCNOverMLP(
        gcn_nfeat=dim_touched, gcn_nhid=hidden, gcn_nclass=hidden, dim_touched=dim_touched,
        linear_nin=hidden + (n_features - dim_touched) - 1, linear_nhid1=64, linear_nhid2=8,
        linear_nout=1, impl=impl, generator=torch.Generator().manual_seed(seed),
    ).to(device)


def make_train_step(model: GCNOverMLP, opt: torch.optim.Optimizer, graph, bf16: bool = False,
                    mesh=None):
    """``train_step(bx, by) -> loss``: MSE of the evaluator's predictions,
    backward, one optimizer step; the loss (before the update) stays on the
    device. With ``bf16`` the parameters, the batch and the dense adjacency
    are cast to bf16 for the forward, the loss computed in f32, and the
    gradients flow back through the casts to the f32 parameters (the JAX
    trainer's explicit casts; autocast would keep the standardisation in
    f32).

    With ``mesh`` (a 1-D ``data`` mesh) ``bx, by`` is the global batch, the
    same on every rank, its size a multiple of the ranks (else
    ``ValueError``, as JAX's placement of the batch raises): each rank
    computes its contiguous slice of the samples, its squared errors summed
    over the global batch size, and one all-reduce sums the gradients and
    the loss before the optimizer steps."""
    compute_graph = graph
    if bf16 and graph.dense is not None:
        compute_graph = dataclasses.replace(graph, dense=graph.dense.to(torch.bfloat16))

    def predict(bx):
        if not bf16:
            return model(bx, compute_graph)
        params = {name: p.to(torch.bfloat16) for name, p in model.named_parameters()}
        return torch.func.functional_call(model, params, (bx.to(torch.bfloat16), compute_graph))

    params = [p for p in model.parameters() if p.requires_grad]

    def train_step(bx: torch.Tensor, by: torch.Tensor) -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        if mesh is None:
            loss = torch.mean((predict(bx)[:, 0].float() - by) ** 2)
            loss.backward()
            opt.step()
            return loss.detach()
        from pygcn_tpu_torch.parallel.dist_gcn import reduce_gradients

        q = mesh.size("data")
        if bx.shape[0] % q:
            raise ValueError(f"batch of {bx.shape[0]} samples over {q} data ranks")
        b = bx.shape[0] // q
        mine = slice(mesh.coord("data") * b, (mesh.coord("data") + 1) * b)
        loss = ((predict(bx[mine])[:, 0].float() - by[mine]) ** 2).sum() / bx.shape[0]
        loss.backward()
        loss = reduce_gradients(params, loss, mesh.group("data"))
        opt.step()
        return loss

    return train_step


@torch.no_grad()
def evaluate(model: GCNOverMLP, graph, loader, device):
    """Mean of the batches' MSE, and Spearman over all predictions."""
    losses, preds, truths = [], [], []
    for bx, by in loader:
        p = model(torch.from_numpy(bx).to(device), graph)[:, 0]
        losses.append(float(torch.mean((p - torch.from_numpy(by).to(device)) ** 2)))
        preds.append(p.cpu())
        truths.append(torch.from_numpy(by))
    corr = float(spearman(torch.cat(preds), torch.cat(truths)))
    return float(np.mean(losses)), corr


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs a CUDA card")
    ap.add_argument("--vac_result_path", required=True)
    ap.add_argument("--synthetic", action="store_true", default=True)
    ap.add_argument("--msa_name", default="SanFrancisco")
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--weight_decay", type=float, default=5e-4)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--batch_size", type=int, default=20)
    ap.add_argument("--NN", type=int, default=5)
    ap.add_argument("--target_code", type=int, default=0, choices=[0, 1],
                    help="0=total_cases, 1=case_std")
    ap.add_argument("--with_pretrained_embed", action="store_true", default=True)
    ap.add_argument("--with_original_feat", action="store_true")
    ap.add_argument("--rel_result", action="store_true", default=True)
    ap.add_argument("--quicktest", action="store_true")
    ap.add_argument("--kfold", type=int, default=0,
                    help="k-fold CV over train+val (the reference's commented "
                         "scaffold at gnn-over-mlp.py:434-480); 0 = off")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--world_seed", type=int, default=None,
                    help="synthetic-world seed (default: --seed). Set this "
                         "to the gt CSV's world seed when varying --seed for "
                         "model-init variance: the world must stay matched "
                         "to the ground truth")
    ap.add_argument("--n_cbgs", type=int, default=64)
    ap.add_argument("--n_pois", type=int, default=20)
    ap.add_argument("--hours", type=int, default=96)
    ap.add_argument("--patience", type=int, default=30)
    ap.add_argument("--grad_clip", type=float, default=0.1)
    ap.add_argument("--bf16", action="store_true",
                    help="mixed precision: bf16 compute (parameters, batch and "
                         "dense adjacency cast inside the step), f32 master "
                         "parameters, loss and updates")
    ap.add_argument("--data_parallel", action="store_true",
                    help="split each batch's policy samples over ranks (see above)")
    ap.add_argument("--out_dir", required=True)
    return ap.parse_args(argv)


def main(argv=None):
    """Run the CLI; returns ``(test_loss, test_spearman)`` (k-fold: the
    folds' means), or ``None`` after a preemption save."""
    args = parse_args(argv)
    mesh = None
    if args.data_parallel:
        from pygcn_tpu_torch.parallel.launcher import initialize_multihost, start_ranks
        from pygcn_tpu_torch.parallel.mesh import make_mesh

        info = initialize_multihost(device=args.device)
        cards = torch.cuda.device_count() if torch.device(args.device).type == "cuda" else 1
        if not info.distributed and cards > 1:
            return start_ranks(cards, args.device, main,
                               sys.argv[1:] if argv is None else list(argv))
        n_dev = info.process_count
        if args.batch_size % n_dev:
            raise SystemExit(f"--data_parallel needs batch_size divisible by {n_dev} devices")
        mesh = make_mesh([n_dev], ["data"], device=resolve_device(args.device))
    writes = mesh is None or mesh.rank == 0
    with contextlib.redirect_stdout(io.StringIO()) if not writes else contextlib.nullcontext():
        return _run(args, mesh, writes)


def _run(args, mesh, writes: bool):
    set_process_title("train_evaluator")
    device = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)

    if not os.path.exists(args.vac_result_path) and writes:
        print("gt CSV missing: generating synthetic ground truth first")
        from pygcn_tpu_torch.apps import gt_gen

        gt_gen.main([
            "--out", args.vac_result_path, "--num_samples", "48",
            "--NN", str(args.NN), "--n_cbgs", str(args.n_cbgs),
            "--hours", str(args.hours), "--num_seeds", "4", "--device", args.device,
        ])
    any_rank(False, mesh)  # the other ranks read the CSV once rank 0 has written it

    world = build_synthetic_world(
        n_cbgs=args.n_cbgs, n_pois=args.n_pois, hours=args.hours, msa_name=args.msa_name,
        seed=args.seed if args.world_seed is None else args.world_seed, device=device,
    )
    res = load_vac_results(args.vac_result_path, rel_result=args.rel_result)
    node_feats = build_predictor_features(world, res)
    cent = centrality_features(world.adj)
    feats, dim_touched = assemble_evaluator_features(
        node_feats, cent, args.with_pretrained_embed, args.with_original_feat)
    y = res.graph_labels[:, args.target_code]
    # standardize the target for stable MSE scale
    y = ((y - y.mean()) / (y.std() + 1e-8)).astype(np.float32)

    train_loader, val_loader, test_loader = make_split_loaders(
        feats, y, res.idx_train, res.idx_val, res.idx_test,
        args.batch_size, quicktest=args.quicktest, seed=args.seed,
    )
    if mesh is not None:
        train_loader.drop_last = True  # every rank's slice the same size
    graph = world.graph

    def new_model(seed, dp_mesh=None):
        model = make_model(dim_touched, feats.shape[2], args.hidden, seed, device=device)
        opt = adam_l2(model.parameters(), args.lr, args.weight_decay,
                      grad_clip_norm=args.grad_clip)
        return model, opt, make_train_step(model, opt, graph, args.bf16, dp_mesh)

    def to_device(*arrays):
        return [torch.from_numpy(a).to(device) for a in arrays]

    if args.kfold > 0:
        tv_idx = np.concatenate([res.idx_train, res.idx_val])
        fold_metrics = []
        for fold, (tr, va) in enumerate(kfold_splits(len(tv_idx), args.kfold, args.seed)):
            fmodel, _, fstep = new_model(args.seed + fold)
            tr_loader = ArrayLoader([feats[tv_idx[tr]], y[tv_idx[tr]]], args.batch_size,
                                    shuffle=True, seed=args.seed)
            va_loader = ArrayLoader([feats[tv_idx[va]], y[tv_idx[va]]], args.batch_size)
            for _ in range(args.epochs):
                for bx, by in tr_loader:
                    fstep(*to_device(bx, by))
            vl, vc = evaluate(fmodel, graph, va_loader, device)
            fold_metrics.append((vl, vc))
            print(f"fold {fold}: val_loss={vl:.4f} val_spearman={vc:.4f}")
        mean_loss = float(np.mean([m[0] for m in fold_metrics]))
        mean_corr = float(np.mean([m[1] for m in fold_metrics]))
        print(f"kfold mean: val_loss={mean_loss:.4f} val_spearman={mean_corr:.4f}")
        return mean_loss, mean_corr

    model, opt, train_step = new_model(args.seed, mesh)
    sched = ReduceLROnPlateau(mode="max", factor=0.5, patience=8, min_lr=1e-8)
    stopper = EarlyStopping(patience=args.patience)
    feats_dev, y_dev = to_device(feats, y)

    ckpt_minloss = os.path.join(args.out_dir, "checkpoint_minloss.pkl")
    ckpt_maxcorr = os.path.join(args.out_dir, "checkpoint_maxcorr.pkl")
    ckpt_last = os.path.join(args.out_dir, "checkpoint_last.pkl")

    def save(path, epoch, extra=None):
        if writes:
            save_checkpoint_state(model_params(model), epoch, adam_state(opt, model),
                                  sched.state_dict(), path, extra=extra)

    start_epoch = 0
    min_val_loss, max_val_corr = np.inf, -np.inf
    # --resume prefers the preemption checkpoint (exact training state incl.
    # best-metric watermarks + early-stop counters) over the best-metric one
    resume_path = next(
        (p for p in (ckpt_last, ckpt_maxcorr) if args.resume and os.path.exists(p)), None)
    if resume_path is not None:
        payload = load_checkpoint(resume_path)
        load_model_params(model, payload["params"])
        load_adam_state(opt, model, payload["opt_state"])
        start_epoch = payload["epoch"]
        sched.load_state_dict(payload["scheduler_state"])
        extra = payload.get("extra")
        if extra is not None:  # preemption checkpoint: exact loop state
            min_val_loss = float(extra["min_val_loss"])
            max_val_corr = float(extra["max_val_corr"])
            stopper.load_state_dict(extra["stopper"])
        else:
            # best-metric checkpoint carries no watermarks: seed them from one
            # eval so the first resumed epoch can't overwrite a better model
            min_val_loss, max_val_corr = evaluate(model, graph, val_loader, device)
        print(f"resumed from epoch {start_epoch} ({os.path.basename(resume_path)})")

    logger = MetricsLogger(os.path.join(args.out_dir, "metrics.jsonl") if writes else None)
    order = np.array(res.idx_train)
    for epoch in range(start_epoch):  # the order an uninterrupted run reaches
        shuffle_epoch(order, args.seed, epoch)
    with PreemptionGuard() as guard:
        for epoch in range(start_epoch, start_epoch + args.epochs):
            if args.quicktest or mesh is not None:
                # the loader path for shrunken batches and split ones
                train_losses = [float(train_step(*to_device(bx, by)))
                                for bx, by in train_loader]
            else:
                shuffle_epoch(order, args.seed, epoch)
                losses = [train_step(feats_dev.index_select(0, idx),
                                     y_dev.index_select(0, idx))
                          for idx in epoch_batches(torch.from_numpy(order).to(device),
                                                   args.batch_size)]
                train_losses = torch.stack(losses).tolist() if losses else []  # one sync
            val_loss, val_corr = evaluate(model, graph, val_loader, device)
            logger.log(epoch, train_loss=np.mean(train_losses), val_loss=val_loss,
                       val_spearman=val_corr)

            if val_loss < min_val_loss:
                min_val_loss = val_loss
                save(ckpt_minloss, epoch)
            if val_corr > max_val_corr:
                max_val_corr = val_corr
                save(ckpt_maxcorr, epoch)
            sched.step(max_val_corr, opt)
            if any_rank(guard.requested, mesh):
                # preemption: persist the exact loop state (next epoch, sched,
                # best-metric watermarks, early-stop counters) in the explicit
                # `extra` slot and exit cleanly for a --resume rerun
                save(ckpt_last, epoch + 1, extra={
                    "min_val_loss": float(min_val_loss), "max_val_corr": float(max_val_corr),
                    "stopper": stopper.state_dict()})
                logger.close()
                print(f"preempted at epoch {epoch}: saved {ckpt_last}; "
                      "rerun with --resume to continue")
                return None
            if any_rank(stopper(val_loss), mesh):
                print("Early stopping")
                break

    test_loss, test_corr = evaluate(model, graph, test_loader, device)
    print(f"test loss: {test_loss}")
    print(f"Spearman correlation: {test_corr}")

    if not writes:
        logger.close()
        return test_loss, test_corr
    # the run completed: drop the preemption checkpoint so a supervisor's
    # redundant `--resume` relaunch can't rewind to a stale mid-run epoch
    if os.path.exists(ckpt_last):
        os.remove(ckpt_last)

    # whole-model handoff for the policy scripts (reference gnn-over-mlp.py:489)
    with open(os.path.join(args.out_dir, "evaluator.pkl"), "wb") as f:
        pickle.dump({
            "model_config": {k: getattr(model, k) for k in (
                "gcn_nfeat", "gcn_nhid", "gcn_nclass", "dim_touched",
                "linear_nin", "linear_nhid1", "linear_nhid2", "linear_nout")},
            "params": model_params(model),
            "dim_touched": dim_touched,
            "feature_mode": {
                "with_pretrained_embed": args.with_pretrained_embed,
                "with_original_feat": args.with_original_feat,
            },
            "test_loss": test_loss,
            "test_spearman": test_corr,
        }, f)
    logger.close()
    return test_loss, test_corr


if __name__ == "__main__":
    main()
