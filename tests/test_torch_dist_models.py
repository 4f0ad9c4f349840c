"""The port's distributed models, classifier step, checkpoints and
``train_fullgraph --shards`` against the JAX package's, on gloo ranks.

JAX runs its distributed models on 4 devices of the 8-device CPU mesh of
``tests/conftest.py``, with weights from its own ``init``; the port runs 4
gloo ranks (one group, started once for the file, which also hosts the CLI
cases that join a group), with those weights carried across by
``pygcn_tpu_torch.convert``, on the same NumPy inputs. The forward, three
``make_dist_classifier_step`` steps (their losses and the final weights) and
the first step's gradients agree within 1e-4. The GAT's updated weights are
held only where JAX's gradient is at least 1e-6, as in
``tests/test_torch_sampled_apps.py``: Adam moves an entry whose gradient is
at rounding level by up to the learning rate on its rounding alone. The
rank-side jobs live in ``tests/torch_dist_ranks.py``, which imports no JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist_ranks as ranks_mod

from pygcn_tpu.apps import train_fullgraph as japp
from pygcn_tpu.graph.datasets import sbm_classification
from pygcn_tpu.parallel import build_dist_plan as j_build_dist_plan
from pygcn_tpu.parallel import make_mesh as j_make_mesh
from pygcn_tpu.parallel.dist_gat import DistGAT as JDistGAT
from pygcn_tpu.parallel.dist_gcn import DistGCN as JDistGCN
from pygcn_tpu.parallel.dist_gcn import make_dist_classifier_step as j_make_step
from pygcn_tpu.parallel.dist_sage import DistAPPNP as JDistAPPNP
from pygcn_tpu.parallel.dist_sage import DistSAGE as JDistSAGE
from pygcn_tpu.train import adam_l2 as j_adam_l2

from pygcn_tpu_torch import convert
from pygcn_tpu_torch.apps import train_fullgraph as tapp
from pygcn_tpu_torch.graph.graph import Graph as TGraph
from pygcn_tpu_torch.parallel import build_dist_plan
from pygcn_tpu_torch.parallel import launcher

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_FLOOR = 1e-6
P = 4
STEPS = 3
CFG = dict(dims=[12, 8, 8, 3], nfeat=12, nhid=5, nclass=3, heads=2, k=4, alpha=0.15,
           lr=0.01, wd=5e-4)
JOB_TIMEOUT_S = 180
# JAX's tests/test_apps.py sizes for train_fullgraph --shards
CLI_GCN = ["--n_nodes", "600", "--avg_degree", "5", "--feat_dim", "8", "--hidden", "8",
           "--n_classes", "3", "--epochs", "2", "--layers", "2", "--device", "cpu"]
CLI_FAMILY = ["--n_nodes", "300", "--avg_degree", "5", "--feat_dim", "8", "--hidden", "4",
              "--n_classes", "3", "--epochs", "1", "--gat_heads", "2", "--device", "cpu"]


@pytest.fixture(scope="module")
def ranks4():
    with launcher.LocalRanks(P, timeout_s=JOB_TIMEOUT_S) as ranks:
        yield ranks


_DATA = {}


def data():
    """JAX's ``tests/test_dist_*.py`` SBM graph (160 nodes, 3 classes), the
    port's graph of the same edges, both plans, and padded inputs."""
    if not _DATA:
        d = sbm_classification(n=160, n_classes=3, feat_dim=12, seed=4, train_per_class=10,
                               n_val=24, n_test=48, build_dense=False, build_bcsr=False,
                               build_ell=False)
        jg = d.graph
        e = jg.n_edges
        tg = TGraph.from_coo(np.asarray(jg.senders[:e]), np.asarray(jg.receivers[:e]),
                             np.asarray(jg.weights[:e]), n_nodes=jg.n_nodes, build_dense=False,
                             build_bcsr=False, build_ell=False, build_hybrid=False)
        plan, jplan = build_dist_plan(tg, P), j_build_dist_plan(jg, P)
        npad, n = plan.n_nodes_padded, jg.n_nodes
        x = np.zeros((npad, 12), np.float32)
        x[:n] = d.features
        labels = np.zeros(npad, np.int64)
        labels[:n] = d.labels
        mask = np.zeros(npad, np.float32)
        mask[np.asarray(d.idx_train)] = 1.0
        _DATA.update(plan=plan, jplan=jplan, x=x, labels=labels, mask=mask, n=n)
    return _DATA


def jax_model(kind, mesh, plan):
    if kind.startswith("gcn"):
        return JDistGCN(mesh, plan, CFG["dims"],
                        final_activation=lambda h: jax.nn.log_softmax(h, axis=1))
    if kind == "sage":
        return JDistSAGE(mesh, plan, CFG["nfeat"], CFG["nhid"], CFG["nclass"])
    if kind == "appnp":
        return JDistAPPNP(mesh, plan, CFG["nfeat"], CFG["nhid"], CFG["nclass"], k=CFG["k"],
                          alpha=CFG["alpha"])
    return JDistGAT(mesh, plan, CFG["nfeat"], CFG["nhid"], CFG["nclass"], heads=CFG["heads"],
                    v2=kind == "gatv2")


def to_state(kind, params) -> dict:
    """JAX's parameter tree as the port model's state dict, as NumPy."""
    if kind.startswith("gcn"):
        state = convert.params_to_state_dict(params)
    elif kind in ("gat", "gatv2"):
        state = convert.gat_params_to_state_dict(params)
    else:
        state = convert.tree_to_state_dict(params)
    return {k: v.numpy() for k, v in state.items()}


_JAX = {}


def jax_run(kind):
    """JAX's forward, first-step gradients and three steps from its init."""
    key = "gcn" if kind.startswith("gcn") else kind
    if key not in _JAX:
        d = data()
        mesh = j_make_mesh([P], ["graph"])
        model = jax_model(kind, mesh, d["jplan"])
        params = model.init(jax.random.key(7))
        x = model.shard_x(d["x"])
        labels = jnp.asarray(d["labels"].astype(np.int32))
        mask = jnp.asarray(d["mask"])

        def loss_fn(p):
            logp = model.apply(p, x)
            per_node = -jnp.take_along_axis(logp, labels[:, None], axis=1)[:, 0]
            return (per_node * mask).sum() / mask.sum()

        sp = model.shard_params(params)
        out = {"state": to_state(kind, params),
               "logp": np.asarray(jax.jit(model.apply)(sp, x)),
               "grads": to_state(kind, jax.jit(jax.grad(loss_fn))(sp))}
        tx = j_adam_l2(CFG["lr"], CFG["wd"])
        step = j_make_step(model, tx)
        opt_state, losses = tx.init(sp), []
        for _ in range(STEPS):
            sp, opt_state, loss = step(sp, opt_state, x, labels, mask)
            losses.append(float(loss))
        out.update(losses=losses, params=to_state(kind, sp))
        _JAX[key] = out
    return _JAX[key]


def run_port(ranks, kind):
    d, want = data(), jax_run(kind)
    out = ranks.run(ranks_mod.model_job, kind, d["plan"], want["state"], d["x"], d["labels"],
                    d["mask"], CFG, STEPS)
    got = dict(out[0])
    got["logp"] = np.concatenate([r["logp"] for r in out])
    for r in out[1:]:  # the replicated state agrees on every rank
        assert r["losses"] == got["losses"]
        for k, v in r["params"].items():
            np.testing.assert_array_equal(v, got["params"][k])
    return got, want


@pytest.mark.parametrize("kind", ["gcn", "sage", "appnp", "gat", "gatv2"])
def test_dist_model_matches_jax(ranks4, kind):
    got, want = run_port(ranks4, kind)
    assert set(got["params"]) == set(want["params"])
    np.testing.assert_allclose(got["logp"], want["logp"], **TOL)
    np.testing.assert_allclose(got["losses"], want["losses"], **TOL)
    for k, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][k], g, **TOL, err_msg=k)
    for k, p in want["params"].items():
        held = np.abs(want["grads"][k]) >= GRAD_FLOOR if kind in ("gat", "gatv2") else True
        np.testing.assert_allclose(np.where(held, got["params"][k], p), p, **TOL, err_msg=k)


def test_dist_gcn_remat_gives_the_same_steps(ranks4):
    """``remat`` recomputes each layer, halo exchange included, in the
    backward pass: the same losses, gradients and weights."""
    plain, _ = run_port(ranks4, "gcn")
    remat, _ = run_port(ranks4, "gcn_remat")
    np.testing.assert_allclose(remat["losses"], plain["losses"], rtol=1e-6, atol=0)
    for k in plain["params"]:
        np.testing.assert_allclose(remat["grads"][k], plain["grads"][k], rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(remat["params"][k], plain["params"][k], rtol=1e-6, atol=1e-9)


def test_dist_checkpoint_roundtrip(ranks4, tmp_path):
    """Rank 0 saves the sharded run's state; every rank restores it and the
    restored state takes the live state's next step (JAX's
    ``test_dist_checkpoint_roundtrip``)."""
    d = data()
    state = jax_run("gcn")["state"]
    out = ranks4.run(ranks_mod.checkpoint_job, d["plan"], state, d["x"], d["labels"], d["mask"],
                     CFG, str(tmp_path / "dist_ckpt.pkl"))
    for r in out:
        assert r["epoch"] == 3 and r["sched"] == {"lr": CFG["lr"]}
        np.testing.assert_allclose(r["r_loss"], r["loss"], rtol=1e-6)
        for k, v in r["params"].items():
            np.testing.assert_allclose(r["r_params"][k], v, rtol=1e-6, atol=1e-9)


def test_cli_shards_starts_its_ranks():
    """``--shards 4 --device cpu`` from a plain process starts 4 gloo ranks
    and returns rank 0's seconds per epoch, as JAX's returns its own."""
    dt = tapp.main([*CLI_GCN, "--shards", "4"])
    assert isinstance(dt, float) and dt > 0


@pytest.mark.parametrize("model", ["gat", "gatv2", "sage", "appnp"])
def test_cli_shards_families_join_a_group(ranks4, model):
    """``--shards 2`` inside a group of 4 (as under ``torchrun``): the first
    two ranks run the model, the others sit out."""
    out = ranks4.run(ranks_mod.cli_job, [*CLI_FAMILY, "--model", model, "--shards", "2"])
    assert out[0] > 0 and out[2:] == [None, None]


def test_cli_shards_clustered_reports_accuracy(ranks4):
    """The convergence run over 4 ranks: the global loss and predictions
    agree on every rank, and the accuracies come back."""
    out = ranks4.run(ranks_mod.cli_job, ["--clustered", "--n_nodes", "600", "--feat_dim", "8",
                                         "--hidden", "8", "--n_classes", "3", "--max_epochs",
                                         "3", "--shards", "4", "--device", "cpu"])
    timed = ("epoch_s", "total_s", "plan_s")
    r = out[0]
    assert all({k: v for k, v in o.items() if k not in timed}
               == {k: v for k, v in r.items() if k not in timed} for o in out)
    assert r["steps"] == r["epochs"] + 1 and np.isfinite(r["loss"])
    assert 0 <= r["val"] <= 1 and 0 <= r["test"] <= 1
    assert r["shard_size"] * P >= 600 and r["halo_rows"] > 0


def test_cli_shards_refuses_gin_as_jax_does():
    msg = "--shards supports gcn/gat/gatv2/sage/appnp"
    with pytest.raises(SystemExit, match=msg):
        japp.main([*CLI_FAMILY[:-2], "--model", "gin", "--shards", "2"])
    with pytest.raises(SystemExit, match=msg):
        tapp.main([*CLI_FAMILY, "--model", "gin", "--shards", "2"])


def test_cli_shards_on_cuda_refuses_before_starting_ranks(monkeypatch):
    """More ranks than visible cards: JAX's mesh message, and no rank started."""
    def no_ranks(*a, **k):
        raise AssertionError("ranks were started")

    monkeypatch.setattr(launcher, "LocalRanks", no_ranks)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="mesh needs 2 devices, have 1"):
        tapp.main([*CLI_FAMILY[:-2], "--shards", "2", "--device", "cuda"])
