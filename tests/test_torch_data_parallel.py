"""The port's data-parallel evaluator, sharded simulator and their CLIs
against the JAX package's, on gloo ranks.

JAX runs ``DistGCNOverMLP`` on 4 devices of the 8-device CPU mesh of
``tests/conftest.py`` as ``graph × data`` meshes 2×2, 4×1 and 1×4, at the
shape of its ``tests/test_dist_gcn.py::test_dist_evaluator_2d_mesh_
matches_single_device``; the port runs one group of 4 gloo ranks, started
once for the file, with JAX's weights carried across by
``pygcn_tpu_torch.convert`` and the same NumPy inputs. The forward agrees
within 1e-5 of JAX's and of the port's single-device ``GCNOverMLP``; three
``make_dist_evaluator_step`` steps agree within 1e-4 (losses, first-step
gradients, parameters). ``train_evaluator --data_parallel``'s step over the
4 ranks agrees within 1e-4 with JAX's step on the same loader batches (JAX's
``--data_parallel`` runs its single-device step on the sharded batch). The
sharded simulator equals the unsharded port run bit for bit (the port's
simulator is held to JAX's draws in ``tests/test_torch_sim.py``), and
``gt_gen --shards 2`` and ``train_rl --shards 2`` write what the unsharded
runs write. The rank-side jobs live in ``tests/torch_dp_ranks.py``, which
imports no JAX.
"""

import csv
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
import torch_dp_ranks as jobs

from pygcn_tpu.graph.graph import Graph as JGraph
from pygcn_tpu.graph.transform import sym_normalize, symmetrize_max
from pygcn_tpu.nn.models import GCNOverMLP as JGCNOverMLP
from pygcn_tpu.parallel import build_dist_plan as j_build_dist_plan
from pygcn_tpu.parallel import make_mesh as j_make_mesh
from pygcn_tpu.parallel.dist_evaluator import DistGCNOverMLP as JDist
from pygcn_tpu.parallel.dist_evaluator import make_dist_evaluator_step as j_make_step
from pygcn_tpu.train import adam_l2 as j_adam_l2

from pygcn_tpu_torch import convert
from pygcn_tpu_torch.apps import gt_gen
from pygcn_tpu_torch.graph.graph import Graph as TGraph
from pygcn_tpu_torch.nn.models import GCNOverMLP
from pygcn_tpu_torch.parallel import DistGCNOverMLP, build_dist_plan, launcher, make_mesh
from pygcn_tpu_torch.sim.dist import simulate_policy_batch

torch.set_num_threads(1)

RANKS = 4
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
JOB_TIMEOUT_S = 180
N, BATCH, FEAT, DT, HID = 120, 4, 9, 8, 12
KW = dict(gcn_nfeat=DT, gcn_nhid=HID, gcn_nclass=HID, dim_touched=DT,
          linear_nin=HID + (FEAT - DT) - 1, linear_nhid1=16, linear_nhid2=8, linear_nout=1)
# JAX's test steps with adam_l2(0.01, 5e-4), no clipping (which would scale
# the gradients read after a step); the CLI's clipping at 0.1 for its step
OPT = dict(lr=0.01, wd=5e-4, clip=None)
CLI_OPT = dict(OPT, clip=0.1)
STEPS = 3
# JAX's tests/test_apps.py::test_train_evaluator_data_parallel sizes
EVAL_WORLD = ["--n_cbgs", "32", "--hours", "48"]


@pytest.fixture(scope="module")
def ranks():
    with launcher.LocalRanks(RANKS, timeout_s=JOB_TIMEOUT_S) as r:
        yield r


_DATA = {}


def data():
    """JAX's test graph, batch and targets, the graph in both packages, and
    JAX's evaluator parameters as the port's state dict."""
    if not _DATA:
        rng = np.random.default_rng(0)
        adj = sym_normalize(symmetrize_max(sp.random(N, N, density=0.06, random_state=0,
                                                     format="coo")))
        jg = JGraph.from_scipy(adj, is_symmetric=True, build_dense=True, build_bcsr=False,
                               build_ell=False)
        e = jg.n_edges
        tg = TGraph.from_coo(np.asarray(jg.senders[:e]), np.asarray(jg.receivers[:e]),
                             np.asarray(jg.weights[:e]), n_nodes=N, is_symmetric=True,
                             build_dense=True, build_bcsr=False, build_ell=False,
                             build_hybrid=False)
        x = rng.normal(size=(BATCH, N, FEAT)).astype(np.float32)
        flags = np.zeros((BATCH, N), np.float32)
        for i in range(BATCH):
            flags[i, rng.choice(N, 10, replace=False)] = 1.0
        x[:, :, -1] = flags
        y = rng.normal(size=(BATCH,)).astype(np.float32)
        params = JGCNOverMLP(**KW).init(jax.random.key(3))
        state = {k: v.numpy() for k, v in convert.evaluator_params_to_state_dict(params).items()}
        _DATA.update(jg=jg, tg=tg, x=x, y=y, params=params, state=state)
    return _DATA


_JAX = {}


def jax_evaluator():
    """JAX's ``DistGCNOverMLP`` on its test's 2×2 mesh: the forward, three
    ``make_dist_evaluator_step`` steps, and the first step's gradients (the
    single-device model's, to which the mesh's reduce). The port's meshes
    are all held to these: the function is the same on any mesh."""
    if not _JAX:
        d = data()
        mesh = j_make_mesh([2, 2], ["graph", "data"])
        model = JDist(mesh, j_build_dist_plan(d["jg"], 2), **KW)
        params = model.shard_params(d["params"])
        bx, by = model.shard_batch(d["x"]), model.shard_targets(d["y"])
        pred = np.asarray(model.apply(params, bx))

        single = JGCNOverMLP(**KW)

        def loss_fn(p):
            return jnp.mean((single.apply(p, jnp.asarray(d["x"]), d["jg"])[:, 0]
                             - jnp.asarray(d["y"])) ** 2)

        grads = jax.grad(loss_fn)(d["params"])
        tx = j_adam_l2(OPT["lr"], OPT["wd"], grad_clip_norm=OPT["clip"])
        step = j_make_step(model, tx)
        opt_state, losses = tx.init(params), []
        for _ in range(STEPS):
            params, opt_state, loss = step(params, opt_state, bx, by)
            losses.append(float(loss))
        _JAX.update(pred=pred, grads=convert.evaluator_params_to_state_dict(grads),
                    losses=losses,
                    params=convert.evaluator_params_to_state_dict(
                        jax.tree.map(np.asarray, params)))
    return _JAX


@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 4), (2, 1)],
                         ids=["2x2", "4x1", "1x4", "2x1_of_4"])
def test_dist_evaluator_matches_jax(ranks, shape):
    """The forward on each rank's samples (1e-5 of JAX's ``DistGCNOverMLP``
    and of the port's ``GCNOverMLP``), then three steps: losses, the first
    step's gradients (against JAX's single-device gradients: a gradient
    counted once per rank of a ``graph`` line would be Q times too large)
    and the parameters (1e-4). ``2x1_of_4``: a mesh on half the group, its
    gradients summed over the mesh's own group."""
    d = data()
    want = jax_evaluator()
    single = GCNOverMLP(**KW, impl="dense", generator=torch.Generator().manual_seed(0))
    single.load_state_dict({k: torch.from_numpy(v) for k, v in d["state"].items()})
    with torch.no_grad():
        port = single(torch.from_numpy(d["x"]), d["tg"]).numpy()
    np.testing.assert_allclose(port, want["pred"], **FWD_TOL)
    plan = build_dist_plan(d["tg"], shape[0])
    out = ranks.run(jobs.evaluator_job, shape, plan, d["state"], KW, d["x"], d["y"], OPT, STEPS)
    b = BATCH // shape[1]
    assert out[shape[0] * shape[1]:] == [None] * (RANKS - shape[0] * shape[1])  # outside the mesh
    for r in out[:shape[0] * shape[1]]:
        _, c_data = r["coords"]
        np.testing.assert_allclose(r["pred"], want["pred"][c_data * b:(c_data + 1) * b],
                                   **FWD_TOL)
        np.testing.assert_allclose(r["pred"], port[c_data * b:(c_data + 1) * b], **FWD_TOL)
        np.testing.assert_allclose(r["losses"], want["losses"], **STEP_TOL)
        for k, g in r["grads"].items():
            np.testing.assert_allclose(g, want["grads"][k].numpy(), **STEP_TOL, err_msg=k)
        for k, p in r["params"].items():
            np.testing.assert_allclose(p, want["params"][k].numpy(), **STEP_TOL, err_msg=k)
        # every rank holds the same weights after the update
        for k, p in r["params"].items():
            np.testing.assert_array_equal(p, out[0]["params"][k])


def test_dist_evaluator_state_dict_swaps_with_gcn_over_mlp():
    """A state dict crosses both ways between ``DistGCNOverMLP`` (one rank,
    no process group) and ``GCNOverMLP``; both compute the same forward."""
    d = data()
    mesh = make_mesh([1, 1], ["graph", "data"])
    dist_model = DistGCNOverMLP(mesh, build_dist_plan(d["tg"], 1), **KW,
                                generator=torch.Generator().manual_seed(5))
    single = GCNOverMLP(**KW, impl="dense", generator=torch.Generator().manual_seed(6))
    single.load_state_dict(dist_model.state_dict())
    with torch.no_grad():
        a = dist_model(dist_model.shard_batch(d["x"])).numpy()
        b = single(torch.from_numpy(d["x"]), d["tg"]).numpy()
    np.testing.assert_allclose(a, b, **FWD_TOL)
    back = DistGCNOverMLP(mesh, build_dist_plan(d["tg"], 1), **KW)
    back.load_state_dict(convert.evaluator_params_to_state_dict(
        convert.state_dict_to_evaluator_params(single.state_dict())))
    for k, v in back.state_dict().items():
        assert torch.equal(v, dist_model.state_dict()[k]), k


def test_data_parallel_step_matches_jax_loader_path(ranks):
    """``train_evaluator``'s ``--data_parallel`` step on 4 ranks (each its
    slice of a batch of 8, one all-reduce, AdamL2 with the CLI's clipping)
    against JAX's step on the whole batches, which is what its
    ``--data_parallel`` computes: three batches' losses and the parameters
    (1e-4)."""
    d = data()
    rng = np.random.default_rng(1)
    n_features = FEAT
    batches = [(rng.normal(size=(8, N, n_features)).astype(np.float32),
                rng.normal(size=(8,)).astype(np.float32)) for _ in range(STEPS)]
    for bx, _ in batches:
        bx[:, :, -1] = (rng.random((8, N)) < 0.1).astype(np.float32)
    jm = JGCNOverMLP(gcn_nfeat=DT, gcn_nhid=32, gcn_nclass=32, dim_touched=DT,
                     linear_nin=32 + (n_features - DT) - 1, linear_nhid1=64, linear_nhid2=8,
                     linear_nout=1)
    params = jm.init(jax.random.key(4))
    tx = j_adam_l2(CLI_OPT["lr"], CLI_OPT["wd"], grad_clip_norm=CLI_OPT["clip"])

    @jax.jit
    def j_step(params, opt_state, bx, by):
        def loss_fn(p):
            return jnp.mean((jm.apply(p, bx, d["jg"])[:, 0] - by) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return jax.tree.map(lambda a, u: a + u, params, updates), opt_state, loss

    j_params, opt_state, j_losses = params, tx.init(params), []
    for bx, by in batches:
        j_params, opt_state, loss = j_step(j_params, opt_state, jnp.asarray(bx), jnp.asarray(by))
        j_losses.append(float(loss))
    state = {k: v.numpy() for k, v in convert.evaluator_params_to_state_dict(params).items()}
    out = ranks.run(jobs.evaluator_dp_step_job, state,
                    dict(dim_touched=DT, n_features=n_features, hidden=32, graph=d["tg"]),
                    batches, CLI_OPT)
    want = convert.evaluator_params_to_state_dict(jax.tree.map(np.asarray, j_params))
    for r in out:
        np.testing.assert_allclose(r["losses"], j_losses, **STEP_TOL)
        for k, p in r["params"].items():
            np.testing.assert_allclose(p, want[k].numpy(), **STEP_TOL, err_msg=k)


def test_sharded_simulator_equals_unsharded_bit_for_bit(ranks):
    """``simulate_policy_batch(mesh=...)`` on 4 ranks with B = 11 (padded
    with repeats of row 0 to 12, trimmed back): every rank receives the
    unsharded run's fields, bit for bit."""
    from test_torch_sim import attack_rows, port_world

    params, visits = port_world(hours=24)
    b = 11
    attack = attack_rows(params, np.linspace(0.4, 1.0, b).tolist())
    seeds = list(range(100, 100 + b))
    want = simulate_policy_batch(params, visits, attack, seeds, 2)
    for r in ranks.run(jobs.sim_job, params, visits, attack, seeds, 2):
        assert set(r) == set(want)
        for k in want:
            assert r[k].shape[0] == b
            np.testing.assert_array_equal(r[k], want[k].numpy(), err_msg=k)


def read_rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_gt_gen_shards_writes_the_unsharded_csv(ranks, tmp_path):
    """``gt_gen --shards 2`` on 2 ranks of the group (the others outside
    the mesh) writes the unsharded run's CSV, every field the same text,
    through two batches of 3 and 2 policies (padding on the second)."""
    flags = ["--device", "cpu", "--num_samples", "5", "--batch", "3", "--num_seeds", "2",
             "--NN", "3", "--n_cbgs", "24", "--hours", "48"]
    plain, sharded = str(tmp_path / "plain.csv"), str(tmp_path / "sharded.csv")
    gt_gen.main([*flags, "--out", plain])
    out = ranks.run(jobs.cli_job, "gt_gen", [*flags, "--out", sharded, "--shards", "2"])
    assert out == [None] * RANKS
    assert read_rows(sharded) == read_rows(plain)
    assert len(read_rows(plain)) == 7  # header, the no-vaccination row, 5 policies


def test_train_rl_shards_keeps_the_unsharded_cache(ranks, tmp_path):
    """``train_rl --shards 2 --quicktest`` on 2 ranks: the same greedy
    result, cache and per-episode misses as the unsharded run; only rank 0
    wrote (one cache shard, one metrics file)."""
    from pygcn_tpu_torch.apps import train_rl

    flags = ["--device", "cpu", "--quicktest", "--n_cbgs", "32", "--hours", "48"]
    plain, sharded = str(tmp_path / "plain"), str(tmp_path / "sharded")
    want = train_rl.main([*flags, "--out_dir", plain])
    out = ranks.run(jobs.cli_job, "train_rl", [*flags, "--out_dir", sharded, "--shards", "2"])
    assert tuple(out[0]) == tuple(want) and tuple(out[1]) == tuple(want)
    assert out[2:] == [None, None]

    def cache(d):
        with open(os.path.join(d, "sim_cache_42.pkl"), "rb") as f:
            return pickle.load(f)

    assert cache(sharded) == cache(plain)
    assert sorted(os.listdir(sharded)) == sorted(os.listdir(plain))

    def misses(d):
        with open(os.path.join(d, "metrics.jsonl")) as f:
            return [r.get("misses") for r in map(__import__("json").loads, f)]

    assert misses(sharded) == misses(plain)


@pytest.fixture(scope="module")
def gt_csv(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("gt") / "vac.csv")
    gt_gen.main(["--device", "cpu", "--out", path, "--num_samples", "24", "--batch", "24",
                 "--num_seeds", "2", *EVAL_WORLD, "--NN", "4"])
    return path


def _evaluator_argv(gt_csv, out_dir, batch_size):
    return ["--device", "cpu", "--vac_result_path", gt_csv, "--out_dir", out_dir,
            "--epochs", "2", *EVAL_WORLD, "--NN", "4", "--batch_size", str(batch_size),
            "--data_parallel"]


def test_train_evaluator_data_parallel_cli(ranks, gt_csv, tmp_path):
    """``train_evaluator --data_parallel`` at JAX's test sizes on the 4
    ranks: finite, the same on every rank, rank 0 alone writing
    ``evaluator.pkl``."""
    out = ranks.run(jobs.cli_job, "train_evaluator",
                    _evaluator_argv(gt_csv, str(tmp_path / "dp"), 8))
    assert all(np.isfinite(r[0]) and r == out[0] for r in out)
    assert os.path.exists(str(tmp_path / "dp" / "evaluator.pkl"))


def test_train_evaluator_data_parallel_refuses_batches_that_do_not_divide(ranks, gt_csv,
                                                                         tmp_path):
    """On the 4 ranks, ``--batch_size 6`` is refused with JAX's message, and
    ``--quicktest``'s batches of 2 (at ``--batch_size 8``) with a
    ``ValueError`` on every rank, as JAX's placement of such a batch raises,
    rather than each rank training on no sample."""
    refused = ranks.run(jobs.cli_refusal_job, "train_evaluator",
                        _evaluator_argv(gt_csv, str(tmp_path / "six"), 6))
    assert all("needs batch_size divisible by 4 devices" in m for m in refused), refused
    refused = ranks.run(jobs.cli_refusal_job, "train_evaluator",
                        [*_evaluator_argv(gt_csv, str(tmp_path / "quick"), 8), "--quicktest"])
    assert refused == ["batch of 2 samples over 4 data ranks"] * RANKS, refused
