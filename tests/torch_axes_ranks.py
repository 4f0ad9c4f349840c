"""Jobs that the parity tests of the port's model axes and sharded
checkpoints run on gloo ranks.

The ranks are spawned processes (``pygcn_tpu_torch.parallel.launcher.LocalRanks``)
that import this module to find the job they are handed, so it imports
nothing of JAX or of the JAX package, and no test module. Each job takes
host NumPy inputs (a ``DistPlan``, features, the JAX package's parameter
trees as NumPy) and returns this rank's NumPy results; the tests compare
them with the JAX package's, computed in the pytest process. A rank outside
the job's mesh (a mesh of 2 ranks on a group of 4) returns ``None``.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from pygcn_tpu_torch import convert
from pygcn_tpu_torch.parallel import make_mesh
from pygcn_tpu_torch.parallel.dist_gcn import DistGCN, make_dist_classifier_step
from pygcn_tpu_torch.parallel.moe import ExpertParallelMLP
from pygcn_tpu_torch.parallel.pipeline import PipelinedDeepGCN, local_stages, make_gpipe
from pygcn_tpu_torch.parallel.tp_gcn import TPDistGCN
from pygcn_tpu_torch.train.optim import adam_l2

_MESHES = {}


def mesh_of(shape, names):
    """The mesh of the group's first ``prod(shape)`` ranks, made once per
    rank (``new_group`` is a collective of the whole group)."""
    key = (tuple(shape), tuple(names))
    if key not in _MESHES:
        _MESHES[key] = make_mesh(list(shape), list(names))
    return _MESHES[key]


def _log_softmax(h):
    return F.log_softmax(h, dim=1)


def _numpy(named) -> dict:
    return {k: v.detach().numpy().copy() for k, v in named}


def tp_job(shape, dims, plan, params, x, labels, mask, cfg, steps):
    """``TPDistGCN`` on a ``graph × model`` mesh of ``shape`` from JAX's
    whole ``params``: this rank's log-probs, then ``steps`` classifier
    steps: their losses, the first step's gradients and the final shards."""
    mesh = mesh_of(shape, ("graph", "model"))
    model = TPDistGCN(mesh, plan, dims, final_activation=_log_softmax)
    c, tp = mesh.coord("model"), mesh.size("model")
    model.load_state_dict(convert.tp_params_to_state_dict(params, c, tp))
    xs, ys, ms = (model.shard_x(a) for a in (x, labels, mask))
    with torch.no_grad():
        logp = model(xs).numpy()
    opt = adam_l2(model.parameters(), cfg["lr"], cfg["wd"], grad_clip_norm=cfg.get("clip"))
    step = make_dist_classifier_step(model, opt)
    losses, grads = [], None
    for i in range(steps):
        losses.append(float(step(xs, ys, ms)))
        if i == 0:  # read after the update: clipped in place when the optimizer clips
            grads = _numpy((k, p.grad) for k, p in model.named_parameters())
    return {"coords": mesh.coords, "logp": logp, "losses": losses, "grads": grads,
            "params": _numpy(model.named_parameters())}


def tp1_job(plan, x, dims):
    """At a model axis of one rank, ``TPDistGCN`` and ``DistGCN`` from one
    seed: the largest difference of their weights and of their forwards."""
    mesh = mesh_of((dist.get_world_size(), 1), ("graph", "model"))
    gcn_mesh = mesh_of((dist.get_world_size(),), ("graph",))
    tp = TPDistGCN(mesh, plan, dims, generator=torch.Generator().manual_seed(5))
    gcn = DistGCN(gcn_mesh, plan, dims, generator=torch.Generator().manual_seed(5))
    a, b = tp.state_dict(), gcn.state_dict()
    if set(a) != set(b):
        return {"keys": sorted(a), "want": sorted(b)}
    with torch.no_grad():
        fwd = float((tp(tp.shard_x(x)) - gcn(gcn.shard_x(x))).abs().max())
    return {"weights": max(float((a[k] - b[k]).abs().max()) for k in a), "forward": fwd}


def tp_train_job(plan, x, labels, mask, steps):
    """``TPDistGCN [16, 8, 3]`` on the 2×2 mesh trained ``steps`` steps from
    the port's own init: the col weight's shape and this rank's log-probs."""
    mesh = mesh_of((2, 2), ("graph", "model"))
    model = TPDistGCN(mesh, plan, [16, 8, 3], final_activation=_log_softmax)
    step = make_dist_classifier_step(model, adam_l2(model.parameters(), 0.01, 5e-4))
    xs, ys, ms = (model.shard_x(a) for a in (x, labels, mask))
    losses = [float(step(xs, ys, ms)) for _ in range(steps)]
    with torch.no_grad():
        logp = model(xs).numpy()
    return {"coords": mesh.coords, "w0": tuple(model.layers[0].weight.shape), "losses": losses,
            "logp": logp}


def tanh_stage(p, h):
    return torch.tanh(h @ p["w"] + p["b"]) if "b" in p else torch.tanh(h @ p["w"])


def gpipe_job(stacked, x):
    """``make_gpipe`` over the group's ``pipe`` axis on this rank's stages of
    ``stacked``: the output and the gradients of ``sum(y ** 2)`` with
    respect to this rank's stages and the input."""
    mesh = mesh_of((dist.get_world_size(),), ("pipe",))
    local = {k: torch.tensor(v).requires_grad_(True)
             for k, v in local_stages({k: torch.as_tensor(v) for k, v in stacked.items()},
                                      mesh).items()}
    xs = torch.tensor(x).requires_grad_(True)
    y = make_gpipe(mesh, tanh_stage)(local, xs)
    (y ** 2).sum().backward()
    return {"y": y.detach().numpy(), "grads": {k: v.grad.numpy() for k, v in local.items()},
            "x_grad": xs.grad.numpy()}


def pipeline_job(adj, params, x, y, microbatch, steps, lr):
    """``PipelinedDeepGCN`` on the group's ``pipe`` axis from JAX's tree:
    the forward, the gradients of the mean squared error of the per-sample
    mean output, and ``steps`` Adam steps (losses, final parameters)."""
    mesh = mesh_of((dist.get_world_size(),), ("pipe",))
    stages = np.asarray(params["stages"]["w"]).shape[0]
    model = PipelinedDeepGCN(mesh, adj, params["pre"]["w"].shape[0], params["pre"]["w"].shape[1],
                             params["head"]["w"].shape[1], n_stages=stages)
    model.load_state_dict(convert.pipeline_params_to_state_dict(
        params, mesh.coord("pipe"), mesh.size("pipe")))
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    with torch.no_grad():
        out = model(x, microbatch).numpy()
    opt = adam_l2(model.parameters(), lr)
    losses, grads = [], None
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((model(x, microbatch).mean(dim=(1, 2)) - y) ** 2)
        loss.backward()
        if i == 0:
            grads = _numpy((k, p.grad) for k, p in model.named_parameters())
        opt.step()
        losses.append(float(loss))
    return {"out": out, "grads": grads, "losses": losses,
            "params": _numpy(model.named_parameters())}


def moe_job(n_ranks, params, x, y, cfg):
    """``ExpertParallelMLP`` on an ``expert`` axis of the group's first
    ``n_ranks`` ranks from JAX's tree: the forward and the gradients of the
    residual MSE ``mean((x + moe(x) - y) ** 2)``, and of ``x``."""
    mesh = mesh_of((n_ranks,), ("expert",))
    if mesh.coords is None:
        return None
    moe = ExpertParallelMLP(mesh, cfg["n_experts"], cfg["h"], cfg["hidden"],
                            capacity_factor=cfg["capacity_factor"])
    moe.load_state_dict(convert.moe_params_to_state_dict(params, mesh.coord("expert"), n_ranks))
    xs = torch.tensor(x).requires_grad_(True)
    out = moe(xs)
    torch.mean((xs + out - torch.as_tensor(y)) ** 2).backward()
    return {"out": out.detach().numpy(), "x_grad": xs.grad.numpy(),
            "grads": _numpy((k, p.grad) for k, p in moe.named_parameters())}


def dryrun_job(n):
    from pygcn_tpu_torch.parallel.dryrun import dryrun_multichip

    return dryrun_multichip(n)


# ---- sharded checkpoints ---------------------------------------------------


def ckpt_elastic_job(path):
    """Save an ``[8, 8]`` leaf row-sharded over the group's 4 ranks (2 rows
    each), a replicated leaf and an epoch, asynchronously; restore onto a
    2-rank mesh (4 rows each) from ``ShardSpec``s, the leaf alone onto a
    3-rank mesh (3, 3 and 2 rows), and onto the 4 ranks from the concrete
    tree. Returns each rank's restored rows and values."""
    from pygcn_tpu_torch.train.checkpoint_dist import DistCheckpointer, ShardSpec, shard_leaf

    mesh4 = mesh_of((4,), ("graph",))
    mesh2 = mesh_of((2,), ("graph",))
    mesh3 = mesh_of((3,), ("graph",))
    r = mesh4.coord("graph")
    full = torch.arange(64.0, dtype=torch.float32).reshape(8, 8)
    tree = {"params": [{"w": shard_leaf(full[2 * r:2 * r + 2].clone(), mesh4, "graph"),
                        "b": torch.ones(3)}], "epoch": torch.tensor(7)}
    ck4 = DistCheckpointer(mesh4)  # async
    ck2 = DistCheckpointer(mesh2, async_save=False)
    ck3 = DistCheckpointer(mesh3, async_save=False)
    ck4.save(path, tree)
    ck4.wait()
    out = {"rank": r}
    same = ck4.restore(path, like=tree)
    out["same_w"] = same["params"][0]["w"].to_local().numpy()
    out["same_placement"] = (str(same["params"][0]["w"].placements),
                             tuple(same["params"][0]["w"].shape))
    if mesh2.coords is not None:
        like = {"params": [{"w": ShardSpec((8, 8), torch.float32, mesh2, "graph"),
                            "b": ShardSpec((3,), torch.float32, mesh2)}],
                "epoch": ShardSpec((), torch.int64, mesh2)}
        back = ck2.restore(path, like=like)
        w = back["params"][0]["w"]
        out.update(w=w.to_local().numpy(), w_shape=tuple(w.shape), b=back["params"][0]["b"].numpy(),
                   epoch=int(back["epoch"]))
    if mesh3.coords is not None:  # 8 rows on 3 ranks: 3, 3 and 2
        w3 = ck3.restore(path, like={"params": [{"w": ShardSpec((8, 8), torch.float32, mesh3,
                                                                 "graph")}]})
        out["w3"] = w3["params"][0]["w"].to_local().numpy()
    dist.barrier()
    ck4.close()
    return out


def ckpt_whole_job(path):
    """A synchronous save of a column-sharded leaf and a value, restored
    whole (``like=None``) on every rank; an asynchronous save whose files
    exist once ``wait()`` returns, and a second save over it, restored."""
    from pygcn_tpu_torch.train.checkpoint_dist import DistCheckpointer, shard_leaf

    mesh = mesh_of((4,), ("graph",))
    r = mesh.coord("graph")
    full = torch.arange(24.0, dtype=torch.float32).reshape(3, 8)
    ck = DistCheckpointer(mesh, async_save=False)
    ck.save(os.path.join(path, "sync"), {"w": shard_leaf(full[:, 2 * r:2 * r + 2].clone(), mesh,
                                                         "graph", dim=1), "lr": 0.5})
    whole = ck.restore(os.path.join(path, "sync"))
    ck_async = DistCheckpointer(mesh)
    ck_async.save(os.path.join(path, "async"), {"w": torch.full((2,), 1.0)})
    ck_async.wait()
    files = sorted(os.listdir(os.path.join(path, "async")))
    ck_async.save(os.path.join(path, "async"), {"w": torch.full((2,), 2.0)})  # overwrites
    again = ck_async.restore(os.path.join(path, "async"), like={"w": torch.zeros(2)})
    return {"w": whole["w"].numpy(), "lr": whole["lr"], "files": files,
            "again": again["w"].numpy()}


def ckpt_tp_job(path, plan, x, labels, mask):
    """A ``TPDistGCN`` on the 2×2 mesh after two steps: its parameters and
    Adam state saved asynchronously, restored into a fresh model and
    optimizer (``like``: the live tree); the restored leaves against the
    live ones, and the next step of each."""
    from pygcn_tpu_torch.train.checkpoint_dist import (DistCheckpointer, load_state_tree,
                                                       state_tree)

    mesh = mesh_of((2, 2), ("graph", "model"))

    def fresh(seed):
        model = TPDistGCN(mesh, plan, [16, 8, 3], final_activation=_log_softmax,
                          generator=torch.Generator().manual_seed(seed))
        opt = adam_l2(model.parameters(), 0.01, 5e-4)
        return model, opt, make_dist_classifier_step(model, opt)

    model, opt, step = fresh(0)
    xs, ys, ms = (model.shard_x(a) for a in (x, labels, mask))
    for _ in range(2):
        step(xs, ys, ms)
    ck = DistCheckpointer(mesh)
    live = state_tree(model, opt, mesh, "model", model.split_dims())
    ck.save(path, live)
    ck.wait()
    r_model, r_opt, r_step = fresh(1)
    load_state_tree(r_model, ck.restore(path, like=live), r_opt)
    diffs = [float((a - b).abs().max()) for a, b in zip(model.parameters(), r_model.parameters())]
    diffs += [float((opt.state[a][k] - r_opt.state[b][k]).abs().max())
              for a, b in zip(model.parameters(), r_model.parameters())
              for k in ("exp_avg", "exp_avg_sq", "step")]
    loss, r_loss = float(step(xs, ys, ms)), float(r_step(xs, ys, ms))
    ck.close()
    return {"max_diff": max(diffs), "loss": loss, "r_loss": r_loss}
