"""The policy generators' core in the port against the JAX package.

The same NumPy inputs and the same weights (carried by
``pygcn_tpu_torch.convert``) go through ``pygcn_tpu.policy`` and
``pygcn_tpu_torch.policy``: k generator steps against a frozen evaluator
(losses 1e-5, generator weights 1e-4, flags equal), REINFORCE updates on the
same actions and rewards (losses 1e-5, weights 1e-4), ``normalize_rewards``
with the population σ, the greedy policy's tie rule, the replay buffer and
the simulation cache (shards cross between the packages). The Gumbel-top-k
sampler cannot draw JAX's bits, so its distribution is held instead: the
pairs it draws against the exact law of sequential sampling without
replacement, by chi-square.
"""

import itertools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.stats
import torch

from pygcn_tpu import policy as jpolicy
from pygcn_tpu.graph import Graph as JGraph
from pygcn_tpu.graph import sym_normalize, symmetrize_max
from pygcn_tpu.nn import models as jmodels
from pygcn_tpu.policy import reinforce as jreinforce
from pygcn_tpu.policy import topk as jtopk
from pygcn_tpu.train import adam_l2 as j_adam_l2
from pygcn_tpu_torch import convert
from pygcn_tpu_torch import policy as tpolicy
from pygcn_tpu_torch.graph.graph import Graph as TGraph
from pygcn_tpu_torch.nn import models as tmodels
from pygcn_tpu_torch.policy import reinforce as treinforce
from pygcn_tpu_torch.policy import topk as ttopk
from pygcn_tpu_torch.train.optim import adam_l2

torch.set_num_threads(1)

VAL = dict(rtol=1e-5, atol=1e-5)
WEIGHTS = dict(rtol=1e-4, atol=1e-4)
N = 48


def graphs(n=N, e=360, seed=0):
    """One normalised symmetric adjacency as a JAX and a port graph (dense)."""
    rng = np.random.default_rng(seed)
    m = sp.coo_matrix((rng.uniform(0.1, 1.0, e), (rng.integers(0, n, e), rng.integers(0, n, e))),
                      shape=(n, n))
    a = sym_normalize(symmetrize_max(m))
    return (JGraph.from_scipy(a, is_symmetric=True, build_dense=True),
            TGraph.from_scipy(a, is_symmetric=True, build_dense=True))


def carry(jmodule, tmodule, key):
    """JAX init at ``key``, the same weights loaded into the port module."""
    params = jmodule.init(jax.random.key(key))
    tmodule.load_state_dict(convert.evaluator_params_to_state_dict(params))
    return params


def assert_params(tmodule, jparams, **tol):
    got = convert.tree_to_state_dict(convert.state_dict_to_evaluator_params(
        tmodule.state_dict()))
    want = convert.tree_to_state_dict(jax.tree.map(np.asarray, jparams))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), err_msg=k, **tol)


def gen():
    return torch.Generator().manual_seed(0)


def evaluator_pair(base_width):
    """A GCNOverMLP reading ``[base, flag]`` whose GCN takes the first 6."""
    kw = dict(gcn_nfeat=6, gcn_nhid=12, gcn_nclass=8, dim_touched=6,
              linear_nin=8 + (base_width + 1 - 6) - 1, linear_nhid1=16, linear_nhid2=8,
              linear_nout=1)
    jm, tm = jmodels.GCNOverMLP(**kw), tmodels.GCNOverMLP(**kw, generator=gen())
    return jm, tm, carry(jm, tm, 1)


@pytest.mark.parametrize("hierarchical", [False, True])
def test_generator_steps_match_jax(hierarchical):
    """Six steps of ``make_generator_train_step``: the loss of each, the
    flag of each and the generator's weights after each equal JAX's, the
    evaluator stays as it was, and only the generator's weights move."""
    jg, tg = graphs()
    rng = np.random.default_rng(4)
    dim_touched, extra = 6, 3
    feats = rng.normal(size=(N, dim_touched + extra)).astype(np.float32)
    kw = dict(gcn_nfeat=dim_touched, gcn_nhid=12, gcn_nclass=8, dim_touched=dim_touched,
              nn_select=5, linear_nhid1=16, linear_nhid2=8)
    if hierarchical:
        feats[:, -1] = rng.integers(0, 3, N)  # the group id
        jm = jmodels.HierarchicalGenerator(linear_nin=8 + extra - 1, target_group=1, **kw)
        tm = tmodels.HierarchicalGenerator(linear_nin=8 + extra - 1, target_group=1, **kw,
                                           generator=gen())
    else:
        jm = jmodels.TopKGenerator(linear_nin=8 + extra, **kw)
        tm = tmodels.TopKGenerator(linear_nin=8 + extra, **kw, generator=gen())
    gen_params = carry(jm, tm, 2)
    base = rng.normal(size=(N, 10)).astype(np.float32)
    jev, tev, ev_params = evaluator_pair(10)
    ev_before = {k: v.clone() for k, v in tev.state_dict().items()}

    tx = j_adam_l2(0.01, 5e-4)
    opt_state = tx.init(gen_params)
    jstep = jpolicy.make_generator_train_step(jm, jev, ev_params, tx, jg, jnp.asarray(base))
    tstep = tpolicy.make_generator_train_step(tm, tev, adam_l2(tm.parameters(), 0.01, 5e-4), tg,
                                              torch.from_numpy(base))
    policies = set()
    for _ in range(6):
        gen_params, opt_state, j_loss, j_flag = jstep(gen_params, opt_state, jnp.asarray(feats))
        t_loss, t_flag = tstep(torch.from_numpy(feats))
        np.testing.assert_allclose(float(t_loss), float(j_loss), **VAL)
        assert tpolicy.extract_policy(t_flag) == jpolicy.extract_policy(j_flag)
        np.testing.assert_allclose(t_flag.numpy(), np.asarray(j_flag), **VAL)
        assert_params(tm, gen_params, **WEIGHTS)
        policies.add(tpolicy.extract_policy(t_flag))
    assert all(len(p) == 5 for p in policies)
    if hierarchical:
        assert all((feats[list(p), -1] != 1).all() for p in policies)
    for k, v in tev.state_dict().items():
        assert torch.equal(v, ev_before[k]), k
    assert not any(p.requires_grad for p in tev.parameters())


def soft_pair():
    kw = dict(gcn_nfeat=6, gcn_nhid=12, gcn_nclass=8, dim_touched=6, nn_select=4,
              linear_nhid1=16, linear_nhid2=8)
    jm, tm = jmodels.SoftGenerator(**kw), tmodels.SoftGenerator(**kw, generator=gen())
    return jm, tm, carry(jm, tm, 5)


def test_reinforce_updates_match_jax():
    """Three REINFORCE updates on the same actions and rewards (12 sampled
    rows and 4 replayed, as the trainer appends them): loss, average reward
    and weights after each equal JAX's. The normalised rewards sum to zero,
    so the loss cancels to a small remainder of terms near 15 and a one-ulp
    difference in the rewards' mean (a summation order) moves it by ten
    times that: the rewards are whole numbers (baseline minus a case
    count) over 16 rows, whose mean is exact in either package."""
    jg, tg = graphs()
    jm, tm, params = soft_pair()
    rng = np.random.default_rng(6)
    feats = rng.normal(size=(N, 6)).astype(np.float32)
    tx = j_adam_l2(0.01)
    opt_state = tx.init(params)
    _, jupdate = jreinforce.make_reinforce_episode(jm, tx, jg)
    _, tupdate = treinforce.make_reinforce_episode(tm, adam_l2(tm.parameters(), 0.01), tg)
    for ep in range(3):
        actions = np.stack([rng.choice(N, 4, replace=False) for _ in range(16)])
        rewards = rng.integers(-40, 120, 16).astype(np.float32)
        params, opt_state, j_loss, j_avg = jupdate(params, opt_state, jnp.asarray(feats),
                                                   jnp.asarray(actions), jnp.asarray(rewards))
        t_loss, t_avg = tupdate(torch.from_numpy(feats), torch.from_numpy(actions),
                                torch.from_numpy(rewards))
        np.testing.assert_allclose(float(t_loss), float(j_loss), **VAL)
        np.testing.assert_allclose(float(t_avg), float(j_avg), **VAL)
        assert_params(tm, params, **WEIGHTS)


def test_sample_actions_and_log_probs():
    """``sample_actions`` draws ``[W, NN]`` distinct nodes from the model's
    distribution (a fixed generator repeats them); the log-probs of those
    actions, one policy or a batch, and the replay buffer's, equal JAX's."""
    jg, tg = graphs()
    jm, tm, params = soft_pair()
    feats = np.random.default_rng(7).normal(size=(N, 6)).astype(np.float32)
    sample, _ = treinforce.make_reinforce_episode(tm, adam_l2(tm.parameters(), 0.01), tg)
    actions = sample(torch.from_numpy(feats), torch.Generator().manual_seed(3), 16, 4)
    again = sample(torch.from_numpy(feats), torch.Generator().manual_seed(3), 16, 4)
    assert actions.shape == (16, 4) and torch.equal(actions, again)
    assert all(len(set(row)) == 4 for row in actions.tolist())
    j_probs = jm.apply(params, jnp.asarray(feats), jg)
    with torch.no_grad():
        t_probs = tm(torch.from_numpy(feats), tg)
    np.testing.assert_allclose(t_probs.numpy(), np.asarray(j_probs), **VAL)
    want = [float(jreinforce.policy_log_prob(j_probs, jnp.asarray(a))) for a in actions.numpy()]
    np.testing.assert_allclose(treinforce.policy_log_prob(t_probs, actions).numpy(), want, **VAL)
    np.testing.assert_allclose(float(treinforce.policy_log_prob(t_probs, actions[0])), want[0],
                               **VAL)
    jbuf, tbuf = jpolicy.ReplayBuffer(8), tpolicy.ReplayBuffer(8)
    a = actions[0].tolist()
    np.testing.assert_allclose(
        float(tbuf.get_log_prob(tm, a, torch.from_numpy(feats), tg).detach()),
        float(jbuf.get_log_prob(jm, params, a, jnp.asarray(feats), jg)), **VAL)


@pytest.mark.parametrize("n", [2, 5, 36])
def test_normalize_rewards_uses_the_population_sigma(n):
    """``normalize_rewards`` equals JAX's (``jnp.std``, ddof 0); the
    unbiased σ of ``torch.std``'s default misses JAX's by √(n/(n−1))."""
    r = np.random.default_rng(n).normal(100.0, 30.0, n).astype(np.float32)
    want = np.asarray(jreinforce.normalize_rewards(jnp.asarray(r)))
    got = treinforce.normalize_rewards(torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(got, want, **VAL)
    rt = torch.from_numpy(r)
    unbiased = ((rt - rt.mean()) / (rt.std() + treinforce.EPS)).numpy()
    assert not np.allclose(unbiased, want, **VAL)
    np.testing.assert_allclose(want / unbiased, np.sqrt(n / (n - 1)), rtol=1e-4)
    assert treinforce.EPS == jreinforce.EPS


def test_gumbel_topk_draws_the_law_of_sampling_without_replacement():
    """N = 6, k = 2, 20,000 draws: every draw is 2 distinct nodes, and the
    unordered pairs follow the exact law of two successive renormalised
    categorical draws, P{i, j} = p_i p_j / (1 − p_i) + p_j p_i / (1 − p_j)
    (chi-square, p > 1e-3); so do the inclusion frequencies."""
    probs = np.array([0.05, 0.1, 0.15, 0.2, 0.22, 0.28], np.float32)
    draws = treinforce.gumbel_topk_sample(torch.from_numpy(probs), 2,
                                          torch.Generator().manual_seed(11), width=20_000)
    assert draws.shape == (20_000, 2)
    d = draws.numpy()
    assert (d[:, 0] != d[:, 1]).all()
    pairs = list(itertools.combinations(range(6), 2))
    p = probs.astype(np.float64) / probs.astype(np.float64).sum()
    law = np.array([p[i] * p[j] / (1 - p[i]) + p[j] * p[i] / (1 - p[j]) for i, j in pairs])
    assert abs(law.sum() - 1) < 1e-12
    index = {pair: c for c, pair in enumerate(pairs)}
    counts = np.bincount([index[tuple(sorted(row))] for row in d.tolist()],
                         minlength=len(pairs))
    assert scipy.stats.chisquare(counts, law * len(d)).pvalue > 1e-3
    inclusion = np.array([sum(law[c] for c, pair in enumerate(pairs) if i in pair)
                          for i in range(6)])
    freq = np.bincount(d.ravel(), minlength=6) / len(d)
    np.testing.assert_allclose(freq, inclusion, atol=4 * np.sqrt(inclusion / len(d)).max())
    one = treinforce.gumbel_topk_sample(torch.from_numpy(probs), 3, torch.Generator())
    assert one.shape == (3,) and len(set(one.tolist())) == 3


@pytest.mark.parametrize("probs, nn", [
    ([0.1, 0.3, 0.2, 0.3, 0.2, 0.2], 3),  # a three-way tie at the boundary
    ([0.25, 0.25, 0.25, 0.25], 2),  # all tied
    ([0.5, 0.1, 0.1, 0.1, 0.1, 0.1], 1),  # no tie
    ([0.1, 0.2, 0.2, 0.1, 0.2, 0.2], 2),  # a four-way tie at the top
])
def test_greedy_policy_ties_go_to_the_lower_index(probs, nn):
    want = np.asarray(jreinforce.greedy_policy(jnp.asarray(probs, jnp.float32), nn))
    got = treinforce.greedy_policy(torch.tensor(probs, dtype=torch.float32), nn)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(treinforce.greedy_policy(np.asarray(probs, np.float32), nn),
                                  want)


def test_replay_buffer_matches_jax():
    """The same calls give the same store, minimum and draws from one NumPy
    generator."""
    jbuf, tbuf = jpolicy.ReplayBuffer(10), tpolicy.ReplayBuffer(10)
    for buf in (jbuf, tbuf):
        buf.store_transition(np.array([1, 2, 3]), 5.0)
        buf.store_transition([4, 5, 6], np.float32(-2.0))
        buf.store_transition([7, 8, 9], 3.5)
    assert tbuf.replay_buffer == jbuf.replay_buffer
    assert (tbuf.count, tbuf.min_reward, tbuf.min_reward_idx) == \
        (jbuf.count, jbuf.min_reward, jbuf.min_reward_idx)
    jr, tr = np.random.default_rng(9), np.random.default_rng(9)
    assert [tbuf.get_action_and_reward(tr) for _ in range(6)] == \
        [jbuf.get_action_and_reward(jr) for _ in range(6)]
    for buf in (jbuf, tbuf):
        buf.clear()
    assert (tbuf.count, tbuf.replay_buffer) == (jbuf.count, jbuf.replay_buffer) == (0, {})


def test_sim_cache_matches_jax_and_shares_shards(tmp_path):
    """The same ``evaluate_batch`` calls miss the same policies; a shard
    written by JAX's cache merges into the port's and one of the port's
    into JAX's, each holding tuples of ints to tuples of floats."""
    calls = {"jax": [], "port": []}

    def fake(name):
        def evaluate(policies):
            calls[name].append([tuple(int(i) for i in p) for p in policies])
            return [(float(sum(p)), 0.25 * len(p)) for p in policies]
        return evaluate

    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jc, tc = jpolicy.SimCache(str(jdir)), tpolicy.SimCache(str(tdir))
    batches = [[(1, 2), (3, 4), (1, 2)], [(3, 4), (np.int64(5), 6)], [(5, 6), (1, 2)]]
    for b in batches:
        assert tc.evaluate_batch(b, fake("port")) == jc.evaluate_batch(b, fake("jax"))
    assert calls["port"] == calls["jax"] == [[(1, 2), (3, 4)], [(5, 6)]]
    assert tc.cache == jc.cache and len(tc) == 3
    jc.dump("7")
    tc.dump("8")
    merged = tpolicy.SimCache(str(tdir))
    assert merged.merge_from_disk() == 3  # the port's own shard again
    merged = tpolicy.SimCache(None)
    merged.cache_dir = str(jdir)
    assert merged.merge_from_disk() == 3 and merged.cache == jc.cache
    back = jpolicy.SimCache(str(tdir))
    assert back.cache == tc.cache
    with open(tdir / "sim_cache_8.pkl", "rb") as f:
        shard = pickle.load(f)
    assert all(type(i) is int for k in shard for i in k)
    assert all(type(v) is float for val in shard.values() for v in val)
    assert tpolicy.SimCache(str(tmp_path / "none")).dump("x").endswith("sim_cache_x.pkl")


def test_extract_policy_and_vaccination_vector_match_jax():
    flag = np.zeros((12, 1), np.float32)
    flag[[2, 5, 11]] = 1.0
    assert ttopk.extract_policy(torch.from_numpy(flag)) == jtopk.extract_policy(flag) \
        == ttopk.extract_policy(flag) == (2, 5, 11)
    np.testing.assert_array_equal(ttopk.policy_to_vaccination_vector((2, 5, 11), 12, 40.5),
                                  jtopk.policy_to_vaccination_vector((2, 5, 11), 12, 40.5))
