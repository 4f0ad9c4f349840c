"""Jobs that the parity tests of the port's graph-parallel path run on gloo ranks.

The ranks are spawned processes (``pygcn_tpu_torch.parallel.launcher.LocalRanks``)
that import this module to find the job they are handed, so it imports
nothing of JAX or of the JAX package, and no test module. Each job takes
host NumPy inputs (a ``DistPlan``, features, weights) and returns this
rank's NumPy results; the tests compare them, gathered in rank order, with
the JAX package's, computed in the pytest process. A rank outside the
job's mesh (a mesh of 2 or 4 ranks on a group of 8) returns ``None``.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from pygcn_tpu_torch.parallel import make_dist_spmm, make_mesh
from pygcn_tpu_torch.parallel.dist_gat import DistGAT
from pygcn_tpu_torch.parallel.dist_gcn import DistGCN, make_dist_classifier_step
from pygcn_tpu_torch.parallel.dist_sage import DistAPPNP, DistSAGE
from pygcn_tpu_torch.parallel.dist_spmm import shard_features
from pygcn_tpu_torch.train.optim import adam_l2

_MESHES = {}


def mesh_of(n: int):
    """The 1-D ``"graph"`` mesh of the group's first ``n`` ranks, made once
    per rank (``new_group`` is a collective of the whole group)."""
    if n not in _MESHES:
        _MESHES[n] = make_mesh([n], ["graph"])
    return _MESHES[n]


def spmm_job(plan, x, ct):
    """The distributed SpMM of the padded ``x`` in each ``parts`` mode, and
    the gradient of ``<ct, A x>`` through the full one."""
    mesh = mesh_of(plan.n_shards)
    if mesh.coords is None:
        return None
    out = {}
    for parts in ("full", "local", "halo"):
        xs = shard_features(x, mesh).requires_grad_(parts == "full")
        y = make_dist_spmm(mesh, plan, parts=parts)(xs)
        out[parts] = y.detach().numpy()
        if parts == "full":
            (y * shard_features(ct, mesh)).sum().backward()
            out["grad"] = xs.grad.numpy()
    return out


def build_model(kind: str, mesh, plan, cfg: dict):
    """``kind``: ``gcn``, ``gcn_remat``, ``sage``, ``appnp``, ``gat`` or
    ``gatv2``, at the sizes of ``cfg``."""
    if kind in ("gcn", "gcn_remat"):
        return DistGCN(mesh, plan, cfg["dims"], final_activation=lambda h: F.log_softmax(h, 1),
                       remat=kind == "gcn_remat")
    if kind == "sage":
        return DistSAGE(mesh, plan, cfg["nfeat"], cfg["nhid"], cfg["nclass"])
    if kind == "appnp":
        return DistAPPNP(mesh, plan, cfg["nfeat"], cfg["nhid"], cfg["nclass"], k=cfg["k"],
                         alpha=cfg["alpha"])
    return DistGAT(mesh, plan, cfg["nfeat"], cfg["nhid"], cfg["nclass"], heads=cfg["heads"],
                   v2=kind == "gatv2")


def _load(model, state: dict) -> None:
    model.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                           for k, v in state.items()})


def _numpy_params(model) -> dict:
    return {k: p.detach().numpy().copy() for k, p in model.named_parameters()}


def model_job(kind, plan, state, x, labels, mask, cfg, steps):
    """The forward at ``state`` (this rank's log-probs), then ``steps``
    distributed classifier steps: their losses, the first step's global
    gradients and the final parameters."""
    mesh = mesh_of(plan.n_shards)
    if mesh.coords is None:
        return None
    model = build_model(kind, mesh, plan, cfg)
    _load(model, state)
    xs, ys, ms = (model.shard_x(a) for a in (x, labels, mask))
    with torch.no_grad():
        logp = model(xs).numpy()
    step = make_dist_classifier_step(model, adam_l2(model.parameters(), cfg["lr"], cfg["wd"]))
    losses, grads = [], None
    for i in range(steps):
        losses.append(float(step(xs, ys, ms)))
        if i == 0:
            grads = {k: p.grad.numpy().copy() for k, p in model.named_parameters()}
    return {"logp": logp, "losses": losses, "grads": grads, "params": _numpy_params(model)}


def checkpoint_job(plan, state, x, labels, mask, cfg, path):
    """Three steps, rank 0 saves the state, every rank restores it into a
    new model and optimizer; then one more step of the live state and one
    of the restored: their losses and parameters, and the checkpoint's
    epoch and scheduler state."""
    from pygcn_tpu_torch.train.checkpoint import (adam_state, get_checkpoint_state,
                                                  load_adam_state, load_model_params,
                                                  model_params, save_checkpoint_state)

    mesh = mesh_of(plan.n_shards)
    if mesh.coords is None:
        return None

    def fresh():
        model = build_model("gcn", mesh, plan, cfg)
        _load(model, state)
        opt = adam_l2(model.parameters(), cfg["lr"])
        return model, opt, make_dist_classifier_step(model, opt)

    model, opt, step = fresh()
    xs, ys, ms = (model.shard_x(a) for a in (x, labels, mask))
    for _ in range(3):
        step(xs, ys, ms)
    if mesh.rank == 0:
        save_checkpoint_state(model_params(model), 3, adam_state(opt, model), {"lr": cfg["lr"]},
                              path)
    dist.barrier(group=mesh.group("graph"))
    params, epoch, opt_state, sched = get_checkpoint_state(path)
    r_model, r_opt, r_step = fresh()
    load_model_params(r_model, params)
    load_adam_state(r_opt, r_model, opt_state)
    loss, r_loss = float(step(xs, ys, ms)), float(r_step(xs, ys, ms))
    return {"epoch": epoch, "sched": sched, "loss": loss, "r_loss": r_loss,
            "params": _numpy_params(model), "r_params": _numpy_params(r_model)}


def cli_job(argv):
    """``train_fullgraph.main(argv)`` as a rank of this group (``--shards``
    at most the group's size); ranks outside the mesh return ``None``."""
    from pygcn_tpu_torch.apps import train_fullgraph

    return train_fullgraph._rank_main(argv)


def pid_job():
    return os.getpid()


def fail_on_rank_1():
    return 1 / (1 - dist.get_rank())


def hang_on_rank_0():
    if dist.get_rank() == 0:
        dist.barrier()
