"""The port's data-parallel sampled training (``parallel/dp_sampled.py``,
``train_sampled --shards``) against the JAX package's, on gloo ranks.

JAX runs ``make_dp_sampled_step`` on 4 devices of the 8-device CPU mesh of
``tests/conftest.py``; the port runs one group of 4 gloo ranks, started once
for the file, each sampling its own shard (``shards=[rank]``) and stepping
on it, with JAX's parameters carried across by ``convert``. The sharded
sampler's blocks equal JAX's shard by shard, bit for bit, on the rows JAX
does not pad (its pow2 padding is not ported); the fetch plan rebuilds
``x[input_nodes]`` exactly and its local fraction equals JAX's; three steps
agree within 1e-4 (losses, gradients, and the parameters where every step's
JAX gradient is at least ``GRAD_FLOOR``, as in
``tests/test_torch_sampled_apps.py``). The rank-side jobs live in
``tests/torch_dp_ranks.py``, which imports no JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dp_ranks as jobs
from test_torch_sampled_apps import GRAD_FLOOR, JAX_FWD, jax_cli_params

from pygcn_tpu.graph.datasets import sbm_classification
from pygcn_tpu.ops import sampling as js
from pygcn_tpu.parallel import dp_sampled as jdp
from pygcn_tpu.parallel.mesh import make_mesh as j_make_mesh
from pygcn_tpu.train import adam_l2 as j_adam_l2

from pygcn_tpu_torch import convert
from pygcn_tpu_torch.apps import train_sampled as tapp
from pygcn_tpu_torch.ops import sampling as ts
from pygcn_tpu_torch.parallel import dp_sampled as tdp
from pygcn_tpu_torch.parallel import launcher

torch.set_num_threads(1)

G, B = 4, 8  # shards x per-shard batch
FANOUTS = [3, 2]
TOL = dict(rtol=1e-4, atol=1e-4)
JOB_TIMEOUT_S = 180
CALLS = 3
LR = 0.01


@pytest.fixture(scope="module")
def ranks():
    with launcher.LocalRanks(G, timeout_s=JOB_TIMEOUT_S) as r:
        yield r


_DATA = {}


def data():
    """JAX's ``tests/test_dp_sampled.py`` graph (200 nodes, 4 classes), its
    CSR, and three global seed batches."""
    if not _DATA:
        d = sbm_classification(n=200, n_classes=4, feat_dim=12, avg_degree=6.0, seed=0,
                               train_per_class=12, n_val=20, n_test=40, build_dense=False,
                               build_bcsr=False, build_ell=False)
        rng = np.random.default_rng(1)
        _DATA.update(data=d, adj=d.graph.to_scipy().tocsr(),
                     x=np.asarray(d.features, np.float32),
                     labels=np.asarray(d.labels, np.int64),
                     seeds=[rng.choice(d.idx_train, size=G * B, replace=True)
                            for _ in range(CALLS)])
    return _DATA


def jax_group(workers=0, align=None):
    d = data()
    return jdp.ShardedNeighborSampler(js.NeighborSampler(d["adj"], FANOUTS, seed=7), G,
                                      workers=workers, align_shard_size=align)


def assert_shard_is_jax_prefix(port: ts.SampledBatch, jbatch, g: int):
    n_in = int(jbatch.n_input_valid[g])
    np.testing.assert_array_equal(port.input_nodes, jbatch.input_nodes[g][:n_in])
    np.testing.assert_array_equal(port.output_nodes, jbatch.output_nodes[g])
    for pb, jb in zip(port.blocks, jbatch.blocks):
        m = pb.cols.shape[0]
        np.testing.assert_array_equal(pb.cols.numpy(), np.asarray(jb.cols[g])[:m])
        np.testing.assert_array_equal(pb.weights.numpy(), np.asarray(jb.weights[g])[:m])
        np.testing.assert_array_equal(pb.self_idx.numpy(), np.asarray(jb.self_idx[g])[:m])


@pytest.mark.parametrize("workers", [0, 4], ids=["serial", "workers4"])
@pytest.mark.parametrize("align", [False, True], ids=["split", "aligned"])
def test_sharded_sampler_matches_jax(workers, align):
    """Three group calls at G = 4: every shard's blocks and input nodes are
    JAX's shard, bit for bit, up to JAX's padding, serial or on 4 threads,
    split in order or aligned to the owning shard; one shard alone
    (``shards=[g]``) draws the same; the stream advances by G·L a call."""
    d = data()
    s = -(-200 // G)
    jgroup = jax_group(workers, s if align else None)
    sampler = ts.NeighborSampler(d["adj"], FANOUTS, seed=7)
    group = tdp.ShardedNeighborSampler(sampler, G, workers=workers,
                                       align_shard_size=s if align else None)
    alone = [tdp.ShardedNeighborSampler(ts.NeighborSampler(d["adj"], FANOUTS, seed=7), G,
                                        align_shard_size=s if align else None, shards=[g])
             for g in range(G)]
    for seeds in d["seeds"]:
        jbatch = jgroup(seeds)
        shards = group(seeds)
        assert len(shards) == G
        for g, port in enumerate(shards):
            assert_shard_is_jax_prefix(port, jbatch, g)
            (own,) = alone[g](seeds)
            np.testing.assert_array_equal(own.input_nodes, port.input_nodes)
            for a, b in zip(own.blocks, port.blocks):
                assert torch.equal(a.cols, b.cols) and torch.equal(a.weights, b.weights)
    assert sampler.n_draws == CALLS * G * len(FANOUTS) == jgroup.sampler._n_draws
    assert all(a.sampler.n_draws == sampler.n_draws for a in alone)


def test_indivisible_batch_is_refused():
    d = data()
    group = tdp.ShardedNeighborSampler(ts.NeighborSampler(d["adj"], [2], seed=0), 4)
    with pytest.raises(ValueError, match="global batch 10 not divisible by 4 shards"):
        group(np.arange(10))


def emulate_fetch(x, plan, shard_size, g_count):
    """The fetch (own rows locally, the all-to-all's rows in owner order)
    replayed with NumPy."""
    out = []
    for r in range(g_count):
        recv = []
        for o in range(g_count):
            starts = np.concatenate([[0], np.cumsum(plan.send_counts[o])])
            recv.append(x[o * shard_size:(o + 1) * shard_size][
                plan.send_idx[o][starts[r]:starts[r + 1]]])
        own = x[r * shard_size:(r + 1) * shard_size][plan.loc_idx[r]]
        out.append(np.concatenate(recv + [own])[plan.inv_perm[r]])
    return out


def test_fetch_plan_rebuilds_rows_and_local_frac_matches_jax(ranks):
    """On JAX's random ids (``tests/test_dp_sampled.py:165``) and on a sampled
    batch: the plan rebuilds ``x[input_nodes]`` exactly, a rank's own rows
    never enter the exchange, ``local_frac`` equals JAX's, and the rows
    moved are JAX's ``G·(G−1)·K`` at most; then the real fetch on 4 gloo
    ranks returns each rank's rows."""
    rng = np.random.default_rng(5)
    shard_size = 16
    x = rng.normal(size=(G * shard_size, 6)).astype(np.float32)
    ids = rng.integers(0, G * shard_size, size=(G, 11))
    plan = tdp.build_fetch_plan(list(ids), shard_size)
    for r, rows in enumerate(emulate_fetch(x, plan, shard_size, G)):
        np.testing.assert_array_equal(rows, x[ids[r]])
    assert (np.diag(plan.send_counts) == 0).all()

    d = data()
    s = -(-200 // G)
    jbatch = jax_group(align=s)(d["seeds"][0])
    jplan = jdp.build_fetch_plan(jbatch.input_nodes, s, n_valid=jbatch.n_input_valid)
    want = jdp.fetch_plan_stats(jplan, jbatch.input_nodes, s, n_valid=jbatch.n_input_valid)
    nodes = [jbatch.input_nodes[g][:int(jbatch.n_input_valid[g])] for g in range(G)]
    plan = tdp.build_fetch_plan(nodes, s)
    got = tdp.fetch_plan_stats(plan, nodes, s)
    assert got["local_frac"] == want["local_frac"]
    assert got["rows_over_ici"] <= want["rows_over_ici"]
    assert want["k_remote"] == 1 << max(got["k_remote"] - 1, 0).bit_length()
    xf = np.concatenate([d["x"], np.zeros((G * s - 200, 12), np.float32)])
    for r, rows in enumerate(emulate_fetch(xf, plan, s, G)):
        np.testing.assert_array_equal(rows, d["x"][nodes[r]])
    for r, out in enumerate(ranks.run(jobs.fetch_job, d["x"], nodes)):
        np.testing.assert_array_equal(out["rows"], d["x"][nodes[r]])
        assert [list(a) for a in out["gathered"]] == [list(a) for a in nodes]
        assert out["stats"] == got


def jax_dp_run(model, feature_sharded, params):
    """JAX's ``make_dp_sampled_step`` for three group calls: its losses, the
    averaged shard gradients of each step and the final parameters."""
    d = data()
    mesh = j_make_mesh([G], ("data",))
    tx = j_adam_l2(LR)
    fwd = JAX_FWD[model]
    step = jdp.make_dp_sampled_step(mesh, fwd, tx, feature_sharded=feature_sharded)
    x_full = jnp.asarray(d["x"])
    x_shard, s = jdp.shard_feature_rows(mesh, d["x"])
    group = jax_group(align=s if feature_sharded else None)
    opt_state, losses, grads = tx.init(params), [], []
    for seeds in d["seeds"]:
        batch = group(seeds)
        y = d["labels"][batch.output_nodes]

        def avg_loss(p):
            total = 0.0
            for g in range(G):
                local = js.SampledBatch(blocks=[js.SampledBlock(b.cols[g], b.weights[g],
                                                                b.self_idx[g])
                                                for b in batch.blocks],
                                        input_nodes=None, output_nodes=None)
                logp = jax.nn.log_softmax(fwd(p, local, x_full[batch.input_nodes[g]]), axis=1)
                total += -jnp.take_along_axis(logp, jnp.asarray(y[g])[:, None], axis=1).mean()
            return total / G

        grads.append(jax.grad(avg_loss)(params))
        if feature_sharded:
            plan = jdp.build_fetch_plan(batch.input_nodes, s, n_valid=batch.n_input_valid)
            placed = step.place(batch.blocks, plan, y)
            params, opt_state, loss = step(params, opt_state, *placed[:4], x_shard, placed[4])
        else:
            blocks, ids, yd = step.place(batch.blocks, batch.input_nodes, y)
            params, opt_state, loss = step(params, opt_state, blocks, ids, x_full, yd)
        losses.append(float(loss))
    return losses, grads, params


@pytest.mark.parametrize("feature_sharded", [False, True], ids=["replicated", "feature_sharded"])
@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_dp_step_matches_jax(ranks, model, feature_sharded):
    """Three steps at 4 ranks from JAX's parameters: the losses, every
    gradient entry (1e-4), and the parameters where every step's JAX
    gradient is at least ``GRAD_FLOOR`` (1e-4); ``feature_sharded`` with
    the seeds aligned to their rows' rank on both sides."""
    d = data()
    params = jax_cli_params(model, 12, 8, 2, 4)
    dims = ([12, 8, 4] if model == "gcn" else tapp.gat_layer_dims(2, 12, 2, 8, 4))
    state = {k: v.numpy() for k, v in convert.sampled_params_to_state_dict(params).items()}
    j_losses, j_grads, j_params = jax_dp_run(model, feature_sharded, params)
    out = ranks.run(jobs.dp_sampled_job, model, d["adj"], d["x"], d["labels"], dims, state,
                    d["seeds"], {"lr": LR, "fanouts": FANOUTS, "seed": 7}, feature_sharded)
    held = {k: np.ones(v.shape, bool) for k, v in state.items()}
    for step_grads in j_grads:
        for k, w in convert.sampled_params_to_state_dict(step_grads).items():
            held[k] &= np.abs(w.numpy()) >= GRAD_FLOOR
    want = {k: v.numpy() for k, v in convert.sampled_params_to_state_dict(
        jax.tree.map(np.asarray, j_params)).items()}
    for r in out:
        np.testing.assert_allclose(r["losses"], j_losses, **TOL)
        for got, w in zip(r["grads"], j_grads):
            for k, v in convert.sampled_params_to_state_dict(w).items():
                np.testing.assert_allclose(got[k], v.numpy(), **TOL, err_msg=k)
        for k, p in r["params"].items():
            np.testing.assert_allclose(p[held[k]], want[k][held[k]], **TOL, err_msg=k)
    # entries below the floor are mostly exact zeros: feature columns that no
    # sampled input row sets
    assert sum(h.sum() for h in held.values()) > 0.8 * sum(h.size for h in held.values())


# JAX's tests/test_apps.py::test_train_sampled_data_parallel, _feature_sharded
# and _locality_aligned
CLI = ["--device", "cpu", "--n_nodes", "1500", "--fanouts", "4", "4", "--batch_size", "128",
       "--epochs", "1", "--shards", "4"]


@pytest.mark.parametrize("flags", [
    [],
    ["--feature_sharded"],
    ["--feature_sharded", "--align_seeds", "--locality", "--sample_workers", "2"],
], ids=["replicated", "feature_sharded", "aligned_locality"])
def test_train_sampled_shards_cli(ranks, tmp_path, flags):
    """``train_sampled --shards 4`` as the 4 ranks of the group: finite
    losses, the same on every rank, an accuracy in [0, 1], and rank 0's
    checkpoint with the draw counter at 4 shards × 2 layers a batch."""
    from pygcn_tpu_torch.train.checkpoint import load_checkpoint

    out = ranks.run(jobs.cli_job, "train_sampled",
                    [*CLI, *flags, "--out_dir", str(tmp_path)])
    r0 = out[0]
    assert 0.0 <= r0["acc"] <= 1.0 and np.isfinite(r0["losses"]).all()
    assert all(r["losses"] == r0["losses"] for r in out)
    ckpt = load_checkpoint(str(tmp_path / "checkpoint_last.pkl"))
    assert ckpt["epoch"] == 1 and ckpt["extra"]["n_draws"] == r0["n_batches"] * G * 2
