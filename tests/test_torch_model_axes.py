"""The port's model axes (tensor-parallel GCN, GPipe pipeline, expert-parallel
MoE) and the five-axis dry run against the JAX package's, on gloo ranks.

JAX runs its models on the 8-device CPU mesh of ``tests/conftest.py`` (the
meshes' first 4 or 2 devices), with weights from its own ``init``; the port
runs one group of 4 gloo ranks, started once for the file, with those
weights carried across by ``pygcn_tpu_torch.convert`` and the same NumPy
inputs. Forwards agree within 1e-5 (FWD_TOL); gradients, held shard by
shard (JAX's whole gradient cut by the same ``convert`` function as the
weights), and Adam steps (losses, updated weights) within 1e-4 (STEP_TOL).
The rank-side jobs live in ``tests/torch_axes_ranks.py``, which imports no
JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_axes_ranks as jobs

from pygcn_tpu.graph.datasets import sbm_classification
from pygcn_tpu.parallel import build_dist_plan as j_build_dist_plan
from pygcn_tpu.parallel import make_mesh as j_make_mesh
from pygcn_tpu.parallel.dist_gcn import make_dist_classifier_step as j_make_step
from pygcn_tpu.parallel.moe import ExpertParallelMLP as JMoE
from pygcn_tpu.parallel.moe import top1_dispatch as j_top1_dispatch
from pygcn_tpu.parallel.pipeline import PipelinedDeepGCN as JPipelinedDeepGCN
from pygcn_tpu.parallel.pipeline import make_gpipe as j_make_gpipe
from pygcn_tpu.parallel.pipeline import stack_stage_params as j_stack
from pygcn_tpu.parallel.tp_gcn import TPDistGCN as JTPDistGCN
from pygcn_tpu.train import adam_l2 as j_adam_l2

from pygcn_tpu_torch import convert
from pygcn_tpu_torch.graph.graph import Graph as TGraph
from pygcn_tpu_torch.parallel import build_dist_plan, launcher
from pygcn_tpu_torch.parallel import dryrun
from pygcn_tpu_torch.parallel.mesh import Mesh
from pygcn_tpu_torch.parallel.moe import ExpertParallelMLP, top1_dispatch, top1_route
from pygcn_tpu_torch.parallel.pipeline import local_stages, stack_stage_params
from pygcn_tpu_torch.parallel.tp_gcn import TPDistGCN

torch.set_num_threads(1)

RANKS = 4
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
JOB_TIMEOUT_S = 180
STEPS = 3
OPT = dict(lr=0.01, wd=5e-4)
# the mesh shapes and widths of JAX's tests/test_tp_gcn.py, on 4 ranks:
# col, row, full; col, rowfull (pure TP); col, row, col, rowfull
TP_CASES = {"2x2-col-row-full": ((2, 2), [12, 8, 8, 3]),
            "1x4-col-rowfull": ((1, 4), [12, 8, 3]),
            "2x2-col-row-col-rowfull": ((2, 2), [12, 8, 8, 8, 3])}


@pytest.fixture(scope="module")
def ranks():
    with launcher.LocalRanks(RANKS, timeout_s=JOB_TIMEOUT_S) as r:
        yield r


def one_rank_mesh(names, sizes):
    """A mesh as rank 0 sees it, with no process group: enough for the
    checks that run before any collective."""
    return Mesh(tuple(names), tuple(sizes), 0, (0,) * len(sizes), torch.device("cpu"), {})


# ---- tensor parallelism ---------------------------------------------------

_DATA = {}


def tp_data(feat_dim, seed=3, **kw):
    """JAX's SBM data, the port's graph of the same edges, padded inputs."""
    key = (feat_dim, seed, tuple(sorted(kw.items())))
    if key not in _DATA:
        d = sbm_classification(n=kw.pop("n", 96), n_classes=3, feat_dim=feat_dim, seed=seed,
                               build_dense=False, build_bcsr=False, build_ell=False, **kw)
        jg = d.graph
        e = jg.n_edges
        tg = TGraph.from_coo(np.asarray(jg.senders[:e]), np.asarray(jg.receivers[:e]),
                             np.asarray(jg.weights[:e]), n_nodes=jg.n_nodes, build_dense=False,
                             build_bcsr=False, build_ell=False, build_hybrid=False)
        _DATA[key] = dict(d=d, jg=jg, tg=tg)
    return _DATA[key]


def padded_inputs(d, npad):
    n = d.graph.n_nodes
    x = np.zeros((npad, d.features.shape[1]), np.float32)
    x[:n] = d.features
    labels = np.zeros(npad, np.int64)
    labels[:n] = d.labels
    mask = np.zeros(npad, np.float32)
    mask[np.asarray(d.idx_train)] = 1.0
    return x, labels, mask


def log_softmax(h):
    return jax.nn.log_softmax(h, axis=1)


_JAX_TP = {}


def jax_tp(case, clip=None):
    """JAX's TPDistGCN on its mesh: init, forward, first-step gradients
    (unclipped) and three steps."""
    key = (case, clip)
    if key not in _JAX_TP:
        (g, m), dims = TP_CASES[case]
        t = tp_data(dims[0])
        mesh = j_make_mesh([g, m], ["graph", "model"])
        plan = j_build_dist_plan(t["jg"], g)
        model = JTPDistGCN(mesh, plan, dims, final_activation=log_softmax)
        params = model.init(jax.random.key(2))
        x, labels, mask = padded_inputs(t["d"], plan.n_nodes_padded)
        xs = model.shard_x(x)
        jl, jm = jnp.asarray(labels.astype(np.int32)), jnp.asarray(mask)

        def loss_fn(p):
            logp = model.apply(p, xs)
            return -(jnp.take_along_axis(logp, jl[:, None], axis=1)[:, 0] * jm).sum() / jm.sum()

        sp = model.shard_params(params)
        out = {"params0": jax.tree.map(np.asarray, params),
               "logp": np.asarray(jax.jit(model.apply)(sp, xs)),
               "grads": jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(sp)),
               "inputs": (x, labels, mask)}
        tx = j_adam_l2(OPT["lr"], OPT["wd"], grad_clip_norm=clip)
        step = j_make_step(model, tx)
        opt_state, losses = tx.init(sp), []
        for _ in range(STEPS):
            sp, opt_state, loss = step(sp, opt_state, xs, jl, jm)
            losses.append(float(loss))
        out.update(losses=losses, params=jax.tree.map(np.asarray, sp))
        _JAX_TP[key] = out
    return _JAX_TP[key]


_PORT_TP = {}


def port_tp(ranks, case, clip=None):
    key = (case, clip)
    if key not in _PORT_TP:
        (g, m), dims = TP_CASES[case]
        want = jax_tp(case, clip)
        plan = build_dist_plan(tp_data(dims[0])["tg"], g)
        _PORT_TP[key] = ranks.run(jobs.tp_job, (g, m), dims, plan, want["params0"],
                                  *want["inputs"], dict(OPT, clip=clip), STEPS)
    return _PORT_TP[key], jax_tp(case, clip)


def shard_of(tree, coords, case):
    """JAX's whole param (or gradient) list, cut for the rank at ``coords``."""
    (_, m), _ = TP_CASES[case]
    return {k: v.numpy() for k, v in convert.tp_params_to_state_dict(tree, coords[1], m).items()}


@pytest.mark.parametrize("case", list(TP_CASES))
def test_tp_gcn_forward_matches_jax(ranks, case):
    got, want = port_tp(ranks, case)
    (g, m), _ = TP_CASES[case]
    by_coords = {r["coords"]: r for r in got}
    for c in range(m):  # every model rank of a line holds the line's rows
        logp = np.concatenate([by_coords[(gi, c)]["logp"] for gi in range(g)])
        np.testing.assert_allclose(logp, want["logp"], **FWD_TOL)


@pytest.mark.parametrize("case", list(TP_CASES))
def test_tp_gcn_gradients_match_jax_shard_by_shard(ranks, case):
    got, want = port_tp(ranks, case)
    for r in got:
        for k, gw in shard_of(want["grads"], r["coords"], case).items():
            assert r["grads"][k].shape == gw.shape, k
            np.testing.assert_allclose(r["grads"][k], gw, **STEP_TOL, err_msg=f"{k} {r['coords']}")


@pytest.mark.parametrize("case", list(TP_CASES))
def test_tp_gcn_steps_match_jax(ranks, case):
    got, want = port_tp(ranks, case)
    (g, m), _ = TP_CASES[case]
    for r in got:
        np.testing.assert_allclose(r["losses"], want["losses"], **STEP_TOL)
        for k, pw in shard_of(want["params"], r["coords"], case).items():
            np.testing.assert_allclose(r["params"][k], pw, **STEP_TOL, err_msg=f"{k} {r['coords']}")
    # the reverse route: one model line's shards put together are JAX's tree
    line = [next(r for r in got if r["coords"] == (0, c))["params"] for c in range(m)]
    whole = convert.tp_state_dicts_to_params([{k: torch.from_numpy(v) for k, v in s.items()}
                                              for s in line])
    for layer, ref in zip(whole, want["params"]):
        for k in ("w", "b"):
            np.testing.assert_allclose(layer[k], ref[k], **STEP_TOL)


def test_tp_gcn_clips_by_the_global_norm_as_jax(ranks):
    """``grad_clip_norm`` on a TP model: the step clips by the norm of the
    whole gradient (shards summed over the model line, replicated leaves
    once), as optax does on JAX's global tree; the clip is active here."""
    case = "2x2-col-row-full"
    want = jax_tp(case)
    norm = np.sqrt(sum(float((v ** 2).sum()) for layer in want["grads"] for v in layer.values()))
    clip = 0.05
    assert norm > 4 * clip, norm
    got, want = port_tp(ranks, case, clip=clip)
    for r in got:
        np.testing.assert_allclose(r["losses"], want["losses"], **STEP_TOL)
        for k, pw in shard_of(want["params"], r["coords"], case).items():
            np.testing.assert_allclose(r["params"][k], pw, **STEP_TOL, err_msg=k)


def test_tp_gcn_refuses_indivisible_hidden():
    d = tp_data(8, seed=0, n=64)
    with pytest.raises(ValueError, match="not divisible"):
        JTPDistGCN(j_make_mesh([2, 4], ["graph", "model"]), j_build_dist_plan(d["jg"], 2),
                   [8, 6, 3])
    with pytest.raises(ValueError, match="not divisible"):
        TPDistGCN(one_rank_mesh(("graph", "model"), (1, 4)), build_dist_plan(d["tg"], 1),
                  [8, 6, 3])  # hidden 6 % tp 4 != 0


def test_tp_gcn_at_tp1_is_dist_gcn(ranks):
    """At a model axis of one rank, one seed gives ``DistGCN``'s weights
    under its names, and its forward (the row layer multiplies after its
    SpMM, so within rounding)."""
    d = tp_data(12)
    plan = build_dist_plan(d["tg"], RANKS)
    x, _, _ = padded_inputs(d["d"], plan.n_nodes_padded)
    for r in ranks.run(jobs.tp1_job, plan, x, [12, 8, 8, 3]):
        assert r["weights"] == 0.0 and r["forward"] <= FWD_TOL["atol"], r


def test_tp_gcn_trains_and_keeps_shardings(ranks):
    """JAX's test_tp_gcn_trains_and_keeps_shardings: 15 steps on 2×2; the col
    weight stays a ``[F, H/tp]`` shard and test accuracy exceeds 0.7."""
    t = tp_data(16, seed=1, n=160, train_per_class=10, n_val=30, n_test=60)
    d = t["d"]
    plan = build_dist_plan(t["tg"], 2)
    x, labels, mask = padded_inputs(d, plan.n_nodes_padded)
    out = ranks.run(jobs.tp_train_job, plan, x, labels, mask, 15)
    assert all(r["w0"] == (16, 4) for r in out)
    assert all(np.isfinite(r["losses"]).all() for r in out)
    by_coords = {r["coords"]: r for r in out}
    logp = np.concatenate([by_coords[(g, 0)]["logp"] for g in range(2)])
    preds = logp.argmax(1)[: d.graph.n_nodes]
    acc = (preds[d.idx_test] == np.asarray(d.labels)[d.idx_test]).mean()
    assert acc > 0.7, acc


# ---- pipeline parallelism -------------------------------------------------


def j_tanh_stage(p, h):
    return jnp.tanh(jnp.dot(h, p["w"]) + p["b"]) if "b" in p else jnp.tanh(jnp.dot(h, p["w"]))


def gpipe_case(seed, n_stages, width, with_bias):
    rng = np.random.default_rng(seed)
    stages = [{"w": rng.normal(size=(width, width), scale=0.5).astype(np.float32),
               **({"b": rng.normal(size=(width,)).astype(np.float32)} if with_bias else {})}
              for _ in range(n_stages)]
    x = rng.normal(size=(6, 3, width)).astype(np.float32)
    return stages, x


@pytest.mark.parametrize("n_stages", [4, 8])
def test_gpipe_matches_jax(ranks, n_stages):
    """4 stages on ``pipe`` = 4, and 8 grouped 2 per rank: the output, the
    stages' gradients (each rank its own) and the input's (every rank)."""
    stages, x = gpipe_case(n_stages, n_stages, 6, with_bias=n_stages == 4)
    mesh = j_make_mesh([RANKS], ["pipe"])
    apply = j_make_gpipe(mesh, j_tanh_stage)
    stacked = j_stack([jax.tree.map(jnp.asarray, s) for s in stages])
    y = np.asarray(apply(stacked, jnp.asarray(x)))
    g_p, g_x = jax.grad(lambda sp, xx: (apply(sp, xx) ** 2).sum(), argnums=(0, 1))(
        stacked, jnp.asarray(x))
    got = ranks.run(jobs.gpipe_job, {k: np.asarray(v) for k, v in stacked.items()}, x)
    per = n_stages // RANKS
    for d, r in enumerate(got):
        np.testing.assert_allclose(r["y"], y, **FWD_TOL)
        np.testing.assert_allclose(r["x_grad"], np.asarray(g_x), **STEP_TOL)
        for k, v in g_p.items():
            np.testing.assert_allclose(r["grads"][k], np.asarray(v)[d * per:(d + 1) * per],
                                       **STEP_TOL, err_msg=k)


def test_gpipe_refuses_a_stage_count_not_a_multiple():
    stages, x = gpipe_case(3, 6, 5, with_bias=False)
    with pytest.raises(ValueError, match="multiple"):
        j_make_gpipe(j_make_mesh([RANKS], ["pipe"]), j_tanh_stage)(
            j_stack([jax.tree.map(jnp.asarray, s) for s in stages]), jnp.asarray(x))
    with pytest.raises(ValueError, match="multiple"):
        local_stages(stack_stage_params(stages), one_rank_mesh(("pipe",), (RANKS,)))


_PIPE = {}


def pipeline_run(ranks):
    """JAX's test_pipelined_deep_gcn_matches_loop model (4 stages on
    ``pipe`` = 4): the forward, the first gradients and three Adam steps,
    in both packages."""
    if not _PIPE:
        rng = np.random.default_rng(2)
        n, f, hid, out, batch, mb = 30, 5, 8, 2, 8, 2
        a = rng.uniform(size=(n, n)).astype(np.float32)
        a = (a + a.T) / (2 * n)
        x = rng.normal(size=(batch, n, f)).astype(np.float32)
        y = rng.normal(size=(batch,)).astype(np.float32)
        model = JPipelinedDeepGCN(j_make_mesh([RANKS], ["pipe"]), a, f, hid, out)
        params = model.init(jax.random.key(0))
        sp = model.shard_params(params)

        forward = jax.jit(lambda p: model.apply(p, jnp.asarray(x), microbatch=mb))

        def loss_fn(p):
            return jnp.mean((forward(p).mean(axis=(1, 2)) - y) ** 2)

        value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
        want = {"out": np.asarray(forward(sp)),
                "grads": jax.tree.map(np.asarray, value_and_grad(sp)[1])}
        tx = j_adam_l2(OPT["lr"])
        opt_state, losses = tx.init(sp), []
        for _ in range(STEPS):
            loss, grads = value_and_grad(sp)
            updates, opt_state = tx.update(grads, opt_state, sp)
            sp = jax.tree.map(lambda p, u: p + u, sp, updates)
            losses.append(float(loss))
        want.update(losses=losses, params=jax.tree.map(np.asarray, sp))
        np_params = jax.tree.map(np.asarray, params)
        _PIPE.update(want=want, got=ranks.run(jobs.pipeline_job, a, np_params, x, y, mb, STEPS,
                                              OPT["lr"]))
    return _PIPE["got"], _PIPE["want"]


def test_pipelined_deep_gcn_forward_and_gradients_match_jax(ranks):
    got, want = pipeline_run(ranks)
    for d, r in enumerate(got):
        np.testing.assert_allclose(r["out"], want["out"], **FWD_TOL)
        for k, g in convert.pipeline_params_to_state_dict(want["grads"], d, RANKS).items():
            np.testing.assert_allclose(r["grads"][k], g.numpy(), **STEP_TOL, err_msg=f"{k} {d}")


def test_pipelined_deep_gcn_steps_match_jax(ranks):
    got, want = pipeline_run(ranks)
    for r in got:
        np.testing.assert_allclose(r["losses"], want["losses"], **STEP_TOL)
    whole = convert.state_dicts_to_pipeline_params(
        [{k: torch.from_numpy(v) for k, v in r["params"].items()} for r in got])
    for part in ("pre", "stages", "head"):
        for k in ("w", "b"):
            np.testing.assert_allclose(whole[part][k], want["params"][part][k], **STEP_TOL,
                                       err_msg=f"{part}.{k}")


# ---- expert parallelism ---------------------------------------------------


def test_top1_dispatch_routes_and_caps_as_jax():
    """JAX's overflow case (tokens 0, 1 fill expert 0, token 2 is dropped)
    and random logits with ties, dispatch bit for bit and combine within
    1e-6; the index route names the same slots."""
    rng = np.random.default_rng(0)
    cases = [(np.array([[9.0, 0.0], [9.0, 0.0], [9.0, 0.0], [0.0, 9.0]], np.float32), 2)]
    tied = rng.normal(size=(40, 4)).astype(np.float32)
    tied[::5, 1] = tied[::5, 2] = tied[::5].max(axis=1)
    cases.append((tied, 8))
    for logits, cap in cases:
        jd, jc = (np.asarray(a) for a in j_top1_dispatch(jnp.asarray(logits), cap))
        d, c = top1_dispatch(torch.from_numpy(logits), cap)
        np.testing.assert_array_equal(d.numpy(), jd)
        np.testing.assert_allclose(c.numpy(), jc, rtol=1e-6, atol=1e-7)
        expert, slot, keep, p = top1_route(torch.from_numpy(logits), cap)
        n_idx, e_idx, s_idx = np.nonzero(jd)
        assert keep.numpy().sum() == n_idx.size
        np.testing.assert_array_equal(expert.numpy()[n_idx], e_idx)
        np.testing.assert_array_equal(slot.numpy()[n_idx], s_idx)
        np.testing.assert_allclose(p.numpy()[n_idx], jc[n_idx, e_idx, s_idx], rtol=1e-6)
    assert d.shape == (40, 4, 8)
    d0, _ = top1_dispatch(torch.from_numpy(cases[0][0]), 2)
    assert float(d0[2].sum()) == 0.0


def test_index_route_equals_the_einsum_form():
    """The layer's gather route against JAX's one-hot einsums on one rank,
    with a capacity that drops tokens: outputs within 1e-6, gradients of
    every parameter and of the tokens within 1e-5."""
    torch.manual_seed(0)
    moe = ExpertParallelMLP(one_rank_mesh(("expert",), (1,)), n_experts=4, h=6, hidden=10,
                            capacity_factor=0.75, generator=torch.Generator().manual_seed(1))
    x = torch.randn(50, 6)
    _, _, keep, _ = top1_route(x @ moe.gate, moe.capacity(50))
    assert 0 < int(keep.sum()) < 50  # some tokens dropped
    outs, grads = [], []
    for fn in (moe.forward, moe.forward_dense):
        xs = x.clone().requires_grad_(True)
        moe.zero_grad()
        out = fn(xs)
        (out ** 2).sum().backward()
        outs.append(out.detach())
        grads.append([xs.grad] + [p.grad.clone() for p in moe.parameters()])
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-6, atol=1e-6)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


MOE_CFG = dict(n_experts=4, h=8, hidden=16, capacity_factor=1.25)


@pytest.mark.parametrize("n_ranks", [4, 2])
def test_expert_parallel_matches_jax(ranks, n_ranks):
    """``expert`` = 4 (one expert a rank) and 2 (two a rank, ranks 2 and 3
    outside the mesh); capacity 1.25 drops tokens. Forward within 1e-5; the
    gradients of the gate, of each rank's experts and of the tokens within
    1e-4."""
    rng = np.random.default_rng(n_ranks)
    x = rng.normal(size=(32, 8)).astype(np.float32)
    y = rng.normal(size=(32, 8)).astype(np.float32)
    moe = JMoE(j_make_mesh([n_ranks], ["expert"]), n_experts=4, h=8, hidden=16,
               capacity_factor=1.25)
    params = moe.init(jax.random.key(n_ranks))
    sp = moe.shard_params(params)
    out = np.asarray(moe.apply(sp, jnp.asarray(x)))
    g_p, g_x = jax.grad(lambda p, xx: jnp.mean((xx + moe.apply(p, xx) - y) ** 2),
                        argnums=(0, 1))(sp, jnp.asarray(x))
    _, _, keep, _ = top1_route(torch.from_numpy(x) @ torch.from_numpy(np.array(params["gate"])),
                               moe.capacity(32))
    assert int(keep.sum()) < 32  # the capacity drops tokens
    got = ranks.run(jobs.moe_job, n_ranks, jax.tree.map(np.asarray, params), x, y, MOE_CFG)
    assert got[n_ranks:] == [None] * (RANKS - n_ranks)
    for c, r in enumerate(got[:n_ranks]):
        np.testing.assert_allclose(r["out"], out, **FWD_TOL)
        np.testing.assert_allclose(r["x_grad"], np.asarray(g_x), **STEP_TOL)
        want = convert.moe_params_to_state_dict(jax.tree.map(np.asarray, g_p), c, n_ranks)
        assert set(r["grads"]) == set(want)
        for k, g in want.items():
            np.testing.assert_allclose(r["grads"][k], g.numpy(), **STEP_TOL, err_msg=f"{k} {c}")
        assert np.abs(r["grads"]["gate"]).sum() > 0 and np.abs(r["grads"]["w1"]).sum() > 0
    whole = convert.state_dicts_to_moe_params(
        [convert.moe_params_to_state_dict(jax.tree.map(np.asarray, params), c, n_ranks)
         for c in range(n_ranks)])
    for k in ("gate", *convert.MOE_EXPERT_LEAVES):
        np.testing.assert_array_equal(whole[k], np.asarray(params[k]))


def test_expert_count_must_divide_the_axis():
    with pytest.raises(ValueError, match="not divisible"):
        JMoE(j_make_mesh([4], ["expert"]), n_experts=6, h=8)
    with pytest.raises(ValueError, match="not divisible"):
        ExpertParallelMLP(one_rank_mesh(("expert",), (4,)), n_experts=6, h=8)


# ---- the five-axis dry run ------------------------------------------------


def test_dryrun_multichip_on_four_ranks(ranks):
    """``dryrun_multichip(4)``: every gate of JAX's (graph, tp, pipe,
    expert, data replicated and feature-sharded, graph × data), finite; the
    losses that the mesh makes global agree on every rank."""
    out = ranks.run(jobs.dryrun_job, RANKS)
    keys = {"dist_gcn", "tp_gcn", "pipeline", "moe", "dp_sampled",
            "dp_sampled_feature_sharded", "evaluator_graph_data"}
    for r in out:
        assert set(r) == keys and all(np.isfinite(v) for v in r.values())
        for k in ("dist_gcn", "pipeline", "moe", "dp_sampled"):
            assert r[k] == out[0][k], k


def test_dryrun_multichip_on_one_rank():
    """``dryrun_multichip(1)`` in a process with no group: the DistGCN step
    alone, as JAX's gates run at one device."""
    out = dryrun.dryrun_multichip(1, "cpu")
    assert set(out) == {"dist_gcn"} and np.isfinite(out["dist_gcn"])


def test_dryrun_cli_refuses_more_ranks_than_cards(monkeypatch):
    """``--ranks 2 --device cuda`` with one card: the mesh message, and no
    rank started."""
    def no_ranks(*a, **k):
        raise AssertionError("ranks were started")

    monkeypatch.setattr(launcher, "LocalRanks", no_ranks)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="mesh needs 2 devices, have 1"):
        dryrun.main(["--ranks", "2", "--device", "cuda"])
