"""The five-axis dry run: one step of every parallel path on tiny shapes.

The port of ``__graft_entry__.py``'s ``dryrun_multichip(n)``, with its gates:

- always: the distributed GCN step over a ``graph`` mesh of ``n`` ranks
  (halo-exchange SpMM, replicated weights, one all-reduce of the gradients);
- at ``n >= 2``: the GPipe pipeline's forward and backward over ``pipe``,
  the expert-parallel MoE's over ``expert``, and the data-parallel sampled
  step over ``data``, with replicated and with row-sharded features;
- at ``n >= 4`` and even: the tensor-parallel GCN step on a ``[n/2, 2]``
  ``graph × model`` mesh and the surrogate evaluator's step on a
  ``[n/2, 2]`` ``graph × data`` mesh.

Together: graph, data, model, pipe and expert. Each branch checks that its
loss is finite. Every rank of a group of ``n`` ranks calls
:func:`dryrun_multichip` (at ``n = 1`` a process with no group may).

    python -m pygcn_tpu_torch.parallel.dryrun --ranks 4 --device cpu

starts its ranks itself (``launcher.LocalRanks``: gloo on ``cpu``, NCCL
with one card a rank on ``cuda``, the default) and prints rank 0's losses;
more ranks than visible cards are refused before anything starts.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def _finite(name: str, loss) -> float:
    value = float(torch.as_tensor(loss).detach())
    if not math.isfinite(value):
        raise RuntimeError(f"{name}: non-finite loss {value}")
    return value


def dryrun_multichip(n_devices: int, device: Optional[str] = None) -> dict:
    """One step of each parallel path at ``n_devices`` ranks; returns this
    rank's losses by path. ``device``: the meshes' device (default: in a
    process group, this rank's card under NCCL and the CPU under gloo;
    without one, the card)."""
    import torch.distributed as dist

    from pygcn_tpu_torch.graph.datasets import sbm_classification
    from pygcn_tpu_torch.parallel import build_dist_plan, make_mesh
    from pygcn_tpu_torch.parallel.dist_gcn import DistGCN, make_dist_classifier_step
    from pygcn_tpu_torch.train.optim import adam_l2

    world = dist.get_world_size() if dist.is_initialized() else 1
    if device is None and not dist.is_initialized():
        device = "cuda"
    if world != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) on a group of {world} ranks")
    n = n_devices
    losses = {}
    data = sbm_classification(n=16 * n, n_classes=3, feat_dim=16, avg_degree=4.0, seed=0,
                              train_per_class=4, n_val=8, n_test=8, build_dense=False,
                              build_bcsr=False, build_ell=False, build_hybrid=False)
    n_nodes = data.graph.n_nodes
    log_softmax = lambda h: F.log_softmax(h, dim=1)  # noqa: E731

    def classifier_inputs(model, plan):
        npad = plan.n_nodes_padded
        mask = np.zeros(npad, np.float32)
        mask[data.idx_train] = 1.0
        return (model.shard_x(data.features),
                model.shard_x(np.pad(data.labels.astype(np.int64), (0, npad - n_nodes))),
                model.shard_x(mask))

    mesh = make_mesh([n], ["graph"], device=device)
    plan = build_dist_plan(data.graph, n)
    model = DistGCN(mesh, plan, [16, 16, 3], final_activation=log_softmax,
                    generator=torch.Generator().manual_seed(0)).to(mesh.device)
    step = make_dist_classifier_step(model, adam_l2(model.parameters(), 0.01, 5e-4))
    losses["dist_gcn"] = _finite("distributed train step", step(*classifier_inputs(model, plan)))

    # 2-D graph×model mesh: the tensor-parallel GCN, one full train step
    if n >= 4 and n % 2 == 0:
        from pygcn_tpu_torch.parallel.tp_gcn import TPDistGCN

        mesh_tp = make_mesh([n // 2, 2], ["graph", "model"], device=device)
        plan_tp = build_dist_plan(data.graph, n // 2)
        tp = TPDistGCN(mesh_tp, plan_tp, [16, 8, 3], final_activation=log_softmax,
                       generator=torch.Generator().manual_seed(2))
        tp_step = make_dist_classifier_step(tp, adam_l2(tp.parameters(), 0.01, 5e-4))
        losses["tp_gcn"] = _finite("TP train step", tp_step(*classifier_inputs(tp, plan_tp)))

    # the GPipe pipeline over "pipe": a deep GCN's middle layers, fwd + bwd
    if n >= 2:
        from pygcn_tpu_torch.parallel.pipeline import PipelinedDeepGCN

        mesh_pp = make_mesh([n], ["pipe"], device=device)
        rng = np.random.default_rng(0)
        n_pp = 24
        adj = rng.uniform(size=(n_pp, n_pp)).astype(np.float32) / n_pp
        pp = PipelinedDeepGCN(mesh_pp, adj, f_in=4, hidden=8, n_out=1,
                              generator=torch.Generator().manual_seed(3))
        xb = torch.from_numpy(rng.normal(size=(2 * n, n_pp, 4)).astype(np.float32))
        yb = torch.from_numpy(rng.normal(size=(2 * n,)).astype(np.float32))
        xb, yb = xb.to(mesh_pp.device), yb.to(mesh_pp.device)
        loss = torch.mean((pp(xb, microbatch=2).mean(dim=(1, 2)) - yb) ** 2)
        loss.backward()
        losses["pipeline"] = _finite("pipeline fwd/bwd", loss)

    # expert parallelism over "expert": top-1 MoE, fwd + bwd
    if n >= 2:
        from pygcn_tpu_torch.parallel.moe import ExpertParallelMLP

        mesh_ep = make_mesh([n], ["expert"], device=device)
        moe = ExpertParallelMLP(mesh_ep, n_experts=n, h=8, hidden=16,
                                generator=torch.Generator().manual_seed(4))
        xe = torch.from_numpy(np.random.default_rng(1).normal(size=(4 * n, 8))
                              .astype(np.float32)).to(mesh_ep.device)
        loss = torch.mean((xe + moe(xe)) ** 2)
        loss.backward()
        losses["moe"] = _finite("expert-parallel fwd/bwd", loss)

    # data-parallel sampled training over "data": each rank samples its
    # shard, one all-reduce of the gradients; replicated then row-sharded
    # features
    if n >= 2:
        from pygcn_tpu_torch.apps.train_sampled import SampledGCN
        from pygcn_tpu_torch.ops.sampling import NeighborSampler
        from pygcn_tpu_torch.parallel.dp_sampled import (ShardedNeighborSampler,
                                                         build_fetch_plan, gather_input_nodes,
                                                         make_dp_sampled_step,
                                                         shard_feature_rows)

        mesh_dp = make_mesh([n], ["data"], device=device)
        dev = mesh_dp.device
        sampler = NeighborSampler(data.graph.to_scipy().tocsr(), fanouts=[2, 2], seed=0)
        (batch,) = ShardedNeighborSampler(sampler, n, shards=[mesh_dp.coord("data")])(
            np.arange(2 * n) % n_nodes)
        blocks = [b.to(dev) for b in batch.blocks]
        y = torch.from_numpy(data.labels[batch.output_nodes].astype(np.int64)).to(dev)
        rng = np.random.default_rng(2)
        dims = [16, 8, 3]
        layers = [{"w": torch.from_numpy(rng.normal(size=(fi, fo)).astype(np.float32)),
                   "b": torch.zeros(fo)} for fi, fo in zip(dims[:-1], dims[1:])]
        for feature_sharded in (False, True):
            net = SampledGCN([{k: v.clone() for k, v in layer.items()} for layer in layers])
            net = net.to(dev)
            dp_step = make_dp_sampled_step(mesh_dp, net, adam_l2(net.parameters(), 0.01, 5e-4),
                                           feature_sharded=feature_sharded)
            if feature_sharded:
                x_shard, s = shard_feature_rows(mesh_dp, data.features)
                fetch = build_fetch_plan(gather_input_nodes(batch.input_nodes, mesh_dp), s)
                loss = dp_step(blocks, fetch, x_shard, y)
            else:
                nodes = torch.from_numpy(batch.input_nodes).to(dev)
                loss = dp_step(blocks, nodes, torch.from_numpy(data.features).to(dev), y)
            name = "dp_sampled_feature_sharded" if feature_sharded else "dp_sampled"
            losses[name] = _finite(name, loss)

    # 2-D graph×data mesh: the surrogate evaluator, node rows over "graph",
    # policy samples over "data" (folded into the SpMM's columns)
    if n >= 4 and n % 2 == 0:
        from pygcn_tpu_torch.parallel.dist_evaluator import (DistGCNOverMLP,
                                                             make_dist_evaluator_step)

        g_ax, d_ax = n // 2, 2
        mesh2 = make_mesh([g_ax, d_ax], ["graph", "data"], device=device)
        plan2 = build_dist_plan(data.graph, g_ax)
        feat, dt, hid, b = 8, 6, 8, 2 * d_ax
        ev = DistGCNOverMLP(mesh2, plan2, gcn_nfeat=dt, gcn_nhid=hid, gcn_nclass=hid,
                            dim_touched=dt, linear_nin=hid + (feat - dt) - 1, linear_nhid1=8,
                            linear_nhid2=4, generator=torch.Generator().manual_seed(1))
        rng = np.random.default_rng(0)
        bx = rng.normal(size=(b, n_nodes, feat)).astype(np.float32)
        bx[:, :, -1] = (rng.uniform(size=bx.shape[:2]) < 0.2).astype(np.float32)
        by = rng.normal(size=(b,)).astype(np.float32)
        ev_step = make_dist_evaluator_step(ev, adam_l2(ev.parameters(), 0.01, 5e-4))
        losses["evaluator_graph_data"] = _finite(
            "2-D evaluator step", ev_step(ev.shard_batch(bx), ev.shard_targets(by)))
    return losses


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, default=1)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    from pygcn_tpu_torch.parallel.launcher import start_ranks
    from pygcn_tpu_torch.parallel.mesh import require_devices

    if args.device == "cuda":
        try:  # more ranks than cards: refused before any rank starts
            require_devices(args.ranks, torch.cuda.device_count())
        except ValueError as e:
            raise SystemExit(str(e)) from None
    losses = start_ranks(args.ranks, args.device, dryrun_multichip, args.ranks)
    print(json.dumps({"ranks": args.ranks, "device": args.device, "losses": losses}),
          flush=True)
    return losses


if __name__ == "__main__":
    main(sys.argv[1:])
