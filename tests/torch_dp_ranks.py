"""Jobs that the parity tests of the port's data-parallel path run on gloo ranks.

The sibling of ``tests/torch_dist_ranks.py``: the ranks
(``pygcn_tpu_torch.parallel.launcher.LocalRanks``) import this module to find
the job they are handed, so it imports nothing of JAX or of the JAX
package, and no test module. Each job takes host inputs (NumPy arrays,
state dicts, a world's tensors) and returns this rank's NumPy results; the
tests compare them with the JAX package's, computed in the pytest process.
A rank outside the job's mesh returns ``None``.
"""

from __future__ import annotations

import numpy as np
import torch

from pygcn_tpu_torch.parallel import make_mesh
from pygcn_tpu_torch.parallel.dist_evaluator import DistGCNOverMLP, make_dist_evaluator_step
from pygcn_tpu_torch.parallel.launcher import plain_values
from pygcn_tpu_torch.train.optim import adam_l2

_MESHES = {}


def mesh_of(shape, names=("graph", "data")):
    """The mesh of ``shape`` over the group's first ranks, made once per
    rank (``new_group`` is a collective of the whole group)."""
    key = (tuple(shape), tuple(names))
    if key not in _MESHES:
        _MESHES[key] = make_mesh(list(shape), list(names))
    return _MESHES[key]


def _numpy(named) -> dict:
    return {k: v.detach().numpy().copy() for k, v in named}


def evaluator_job(shape, plan, state, kw, x, y, cfg, steps):
    """``DistGCNOverMLP`` on a ``graph × data`` mesh of ``shape`` at
    ``state``: this rank's predictions with its coordinates, then ``steps``
    evaluator steps: their losses, the first step's gradients and the final
    parameters."""
    mesh = mesh_of(shape)
    if mesh.coords is None:
        return None
    model = DistGCNOverMLP(mesh, plan, **kw)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()})
    bx, by = model.shard_batch(x), model.shard_targets(y)
    with torch.no_grad():
        pred = model(bx).numpy()
    step = make_dist_evaluator_step(model, adam_l2(model.parameters(), cfg["lr"], cfg["wd"],
                                                   grad_clip_norm=cfg["clip"]))
    losses, grads = [], None
    for i in range(steps):
        losses.append(float(step(bx, by)))
        if i == 0:
            grads = _numpy((k, p.grad) for k, p in model.named_parameters())
    return {"coords": mesh.coords, "pred": pred, "losses": losses, "grads": grads,
            "params": _numpy(model.named_parameters())}


def evaluator_dp_step_job(state, kw, batches, cfg):
    """``train_evaluator``'s ``--data_parallel`` step (the single-device
    ``GCNOverMLP`` on this rank's slice, one all-reduce) over the global
    ``batches`` ``[(bx, by), ...]`` on the group's ``data`` mesh: the losses
    and the final parameters."""
    from pygcn_tpu_torch.apps import train_evaluator as tev

    mesh = mesh_of((torch.distributed.get_world_size(),), ("data",))
    model = tev.make_model(kw["dim_touched"], kw["n_features"], kw["hidden"], 0, device="cpu")
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()})
    opt = adam_l2(model.parameters(), cfg["lr"], cfg["wd"], grad_clip_norm=cfg["clip"])
    step = tev.make_train_step(model, opt, kw["graph"], mesh=mesh)
    losses = [float(step(torch.from_numpy(bx), torch.from_numpy(by))) for bx, by in batches]
    return {"losses": losses, "params": _numpy(model.named_parameters())}


def sim_job(params, visits, attack, seeds, num_seeds):
    """``simulate_policy_batch`` over the group's ``data`` mesh: every
    field of the whole batch, as this rank received it."""
    from pygcn_tpu_torch.sim.dist import simulate_policy_batch

    mesh = mesh_of((torch.distributed.get_world_size(),), ("data",))
    out = simulate_policy_batch(params, visits, attack, seeds, num_seeds, mesh=mesh)
    return {k: v.numpy() for k, v in out.items()}


def cli_job(app: str, argv):
    """``pygcn_tpu_torch.apps.<app>.main(argv)`` as a rank of this group,
    its plain values."""
    import importlib

    return plain_values(importlib.import_module(f"pygcn_tpu_torch.apps.{app}").main(argv))


def cli_refusal_job(app: str, argv):
    """``pygcn_tpu_torch.apps.<app>.main(argv)`` as a rank of this group,
    expected to refuse on every rank before any collective that a rank
    could miss: the message of its ``SystemExit`` or ``ValueError``, or
    ``None`` where it ran to its end. The group stays open for the next
    job."""
    import importlib

    try:
        importlib.import_module(f"pygcn_tpu_torch.apps.{app}").main(argv)
    except (SystemExit, ValueError) as e:
        return str(e)
    return None


def fetch_job(x, input_nodes_by_rank):
    """The row-sharded fetch of this rank's ``input_nodes``: every rank
    gathers the others' ids, builds the plan and fetches; returns the rows
    and the plan's stats."""
    from pygcn_tpu_torch.parallel.dp_sampled import (build_fetch_plan, fetch_plan_stats,
                                                     fetch_rows, gather_input_nodes,
                                                     shard_feature_rows)

    mesh = mesh_of((torch.distributed.get_world_size(),), ("data",))
    mine = input_nodes_by_rank[mesh.coord("data")]
    x_shard, s = shard_feature_rows(mesh, x)
    nodes = gather_input_nodes(mine, mesh)
    plan = build_fetch_plan(nodes, s)
    return {"rows": fetch_rows(plan, x_shard, mesh).numpy(),
            "gathered": nodes, "stats": fetch_plan_stats(plan, nodes, s)}


def dp_sampled_job(model_name, adj, x, labels, layer_dims, state, seed_batches, cfg,
                   feature_sharded):
    """``make_dp_sampled_step`` on the group's ``data`` mesh: each rank
    samples its shard of each global batch (``ShardedNeighborSampler``,
    ``shards=[rank]``; with ``feature_sharded`` the seeds aligned to their
    rows' rank) and steps; returns the losses, the first step's gradients
    and the final parameters."""
    from pygcn_tpu_torch.apps import train_sampled as tapp
    from pygcn_tpu_torch.ops.sampling import NeighborSampler
    from pygcn_tpu_torch.parallel.dp_sampled import (ShardedNeighborSampler, build_fetch_plan,
                                                     gather_input_nodes, make_dp_sampled_step,
                                                     shard_feature_rows)

    mesh = mesh_of((torch.distributed.get_world_size(),), ("data",))
    g = mesh.coord("data")
    net = tapp.MODELS[model_name].init(layer_dims, generator=torch.Generator().manual_seed(0))
    net.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()})
    opt = adam_l2(net.parameters(), cfg["lr"])
    step = make_dp_sampled_step(mesh, net, opt, feature_sharded=feature_sharded)
    x_shard, s = shard_feature_rows(mesh, x)
    group = ShardedNeighborSampler(NeighborSampler(adj, cfg["fanouts"], seed=cfg["seed"]),
                                   mesh.size("data"), shards=[g],
                                   align_shard_size=s if feature_sharded else None)
    x_full = torch.from_numpy(x)
    losses, grads = [], []
    for seeds in seed_batches:
        (b,) = group(seeds)
        y = torch.from_numpy(labels[b.output_nodes])
        if feature_sharded:
            plan = build_fetch_plan(gather_input_nodes(b.input_nodes, mesh), s)
            losses.append(float(step(b.blocks, plan, x_shard, y)))
        else:
            losses.append(float(step(b.blocks, torch.from_numpy(b.input_nodes), x_full, y)))
        grads.append(_numpy((k, p.grad) for k, p in net.named_parameters()))
    return {"losses": losses, "grads": grads, "params": _numpy(net.named_parameters())}
