"""The port's epidemic simulator (``pygcn_tpu_torch.sim``) against the JAX package's.

The same NumPy parameters and visits go through both packages (carried
across by ``pygcn_tpu_torch.convert``). The hour rates agree within 1e-6; in
a regime where every draw has p in {0, 1} or lambda = 0 the whole trajectory
is equal; with real draws the two are held to the same distributions (the
two random generators differ), and the port's samplers to the exact pmfs of
``tests/test_draws.py``. The port's own bits: one seed gives one result, a
paged run the one-shot run's, and each row of a policy batch its run alone.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats
from test_draws import S, _chi2_pval
from test_sim import tiny_world

from pygcn_tpu.sim import model as jmodel
from pygcn_tpu_torch import convert
from pygcn_tpu_torch.sim import draws as tdraws
from pygcn_tpu_torch.sim import model as tmodel
from pygcn_tpu_torch.sim import simulate_policy_batch

torch.set_num_threads(1)

RTOL = ATOL = 1e-6


def to_port(params, visits=None):
    """A JAX ``EpidemicParams`` (and ``VisitSeq``) as the port's, on the CPU."""
    p = convert.epidemic_params_from_fields(convert.fields_of(params), "cpu")
    if visits is None:
        return p
    return p, convert.visit_seq_from_fields(convert.fields_of(visits), "cpu")


def np_of(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# ---------------------------------------------------------------------- #
# hour rates
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("psi", [1500.0, 0.0])
@pytest.mark.parametrize("t", [3, 30])
def test_hour_rates_match_jax(t, psi, clip):
    """Before and after ``vaccination_time`` (24), with POI mixing and the
    uniform-mixing branch (psi == 0), with and without the Poisson clip; a
    home beta large enough that base rates clip too."""
    params, visits, _ = tiny_world(n_cbgs=12, n_pois=5, hours=24, seed=7)
    params = dataclasses.replace(params, home_beta=20.0, psi=psi,
                                 clip_poisson_approximation=clip)
    tparams, tvisits = to_port(params, visits)
    rng = np.random.default_rng(7)
    state = {k: rng.uniform(0, hi, (3, 12)).astype(np.float32)
             for k, hi in (("latent", 30), ("infected", 150), ("removed", 20))}
    ref = jmodel.compute_hour_rates({k: jnp.asarray(v) for k, v in state.items()}, t, params,
                                    visits)
    got = tmodel.compute_hour_rates({k: torch.from_numpy(v) for k, v in state.items()}, t,
                                    tparams, tvisits)
    assert set(got) == set(ref)
    for k in ("base_rates", "poi_rates", "mean_from_poi", "num_sus", "attack", "death_rate"):
        np.testing.assert_allclose(np_of(got[k]), np.asarray(ref[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    for k in ("n_base_clipped", "n_active_pois", "n_poi_clipped"):
        assert int(got[k]) == int(ref[k]), k
    assert int(got["n_base_clipped"]) > 0
    if psi > 0:
        assert int(got["n_poi_clipped"]) > 0


def test_hour_without_visits_matches_jax():
    """An hour whose visit matrix is empty (its row all padding)."""
    rng = np.random.default_rng(2)
    dense = rng.uniform(0, 3.0, (24, 6, 20)).astype(np.float32)
    dense[dense < 2.0] = 0.0
    dense[5] = 0.0
    params, _, _ = tiny_world(hours=24)
    visits = jmodel.VisitSeq.from_dense(dense)
    tparams, tvisits = to_port(params, visits)
    assert tvisits.nnz[5] == 0 < tvisits.nnz[4]
    state = {k: rng.uniform(0, 40, (2, 20)).astype(np.float32)
             for k in ("latent", "infected", "removed")}
    ref = jmodel.compute_hour_rates({k: jnp.asarray(v) for k, v in state.items()}, 5, params,
                                    visits)
    got = tmodel.compute_hour_rates({k: torch.from_numpy(v) for k, v in state.items()}, 5,
                                    tparams, tvisits)
    for k in ref:
        np.testing.assert_allclose(np_of(got[k]), np.asarray(ref[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    assert not got["poi_rates"].any() and int(got["n_active_pois"]) == 0


# ---------------------------------------------------------------------- #
# whole trajectories
# ---------------------------------------------------------------------- #


def deterministic_world(just_compute_r0: bool):
    """Every draw has p in {0, 1} or lambda = 0: attack rates 0, everyone
    latent at t0, latency, infectious and both lag periods 1, confirmation
    rate 1, death rates 0 and 1. Everyone turns infectious in hour 0 and
    recovers in hour 1, when the epidemic dies: the freeze and the monitor
    zeroed on its first hour are on the path."""
    n_cbgs, n_pois, hours = 16, 6, 24
    rng = np.random.default_rng(11)
    visits = rng.uniform(0, 3.0, (hours, n_pois, n_cbgs)).astype(np.float32)
    visits[visits < 2.0] = 0.0
    params = jmodel.EpidemicParams.build(
        poi_areas=rng.uniform(100, 1000, n_pois),
        cbg_sizes=rng.integers(500, 2000, n_cbgs).astype(np.float32),
        total_hours=72, p_sick_at_t0=1.0, vaccination_time=24,
        vaccination_vector=np.zeros(n_cbgs), vaccine_acceptance=np.ones(n_cbgs),
        protection_rate=0.5, poi_psi=1500.0, home_beta=0.005,
        cbg_attack_rates_original=np.zeros(n_cbgs),
        cbg_death_rates_original=np.arange(n_cbgs) % 2,
        latency_period=1.0, infectious_period=1.0, confirmation_rate=1.0,
        confirmation_lag=1.0, death_lag=1.0, just_compute_r0=just_compute_r0,
    )
    return params, jmodel.VisitSeq.from_dense(visits)


@pytest.mark.parametrize("just_compute_r0", [False, True])
def test_deterministic_trajectory_equals_jax(just_compute_r0):
    params, visits = deterministic_world(just_compute_r0)
    ref = jmodel.simulate(params, visits, 3, jax.random.key(0))
    tparams, tvisits = to_port(params, visits)
    got = tmodel.simulate(tparams, tvisits, 3, 0)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(np_of(got[k]), np.asarray(ref[k]), err_msg=k)
    mon = np_of(got["monitor"])
    assert mon[0, 1] > 0 and not mon[1:].any()  # frozen from hour 1 on
    c2 = np_of(got["C2"])
    if just_compute_r0:
        assert not c2.any()
        np.testing.assert_array_equal(np_of(got["cbg_all_affected"])[0],
                                      np_of(tparams.cbg_sizes))
    else:
        np.testing.assert_array_equal(c2[0], np_of(tparams.cbg_sizes))


@pytest.mark.parametrize("approx", [False, True])
def test_distributions_match_jax(approx):
    """tiny_world at 256 seeds: the means of total_affected and of the final
    C2 and D2 totals agree within 5 combined standard errors."""
    params, visits, _ = tiny_world()
    params = dataclasses.replace(params, approx_draws=approx)
    seeds = 256
    ref = jmodel.simulate(params, visits, seeds, jax.random.key(1))
    tparams, tvisits = to_port(params, visits)
    got = tmodel.simulate(tparams, tvisits, seeds, 1)
    for k, reduce in (("total_affected", lambda x: x),
                      ("C2", lambda x: x.sum(-1)), ("D2", lambda x: x.sum(-1))):
        a, b = reduce(np.asarray(ref[k], np.float64)), reduce(np_of(got[k]).astype(np.float64))
        se = np.hypot(a.std() / np.sqrt(seeds), b.std() / np.sqrt(seeds))
        assert abs(a.mean() - b.mean()) <= 5 * se + 1e-9, (k, a.mean(), b.mean(), se)
    assert np_of(got["C2"]).sum() > 0


# ---------------------------------------------------------------------- #
# the port's samplers
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("lam", [0.3, 3.0, 9.9, 10.1, 50.0, 400.0])
def test_poisson_distribution(lam):
    g = torch.Generator().manual_seed(int(lam * 100))
    s = tdraws.poisson(torch.full((S,), lam), g).numpy()
    assert s.dtype == np.float32
    assert abs(s.mean() - lam) < 4 * np.sqrt(lam / S) + 1e-3
    assert abs(s.var() - lam) / lam < 0.05
    lo = int(max(0, lam - 6 * np.sqrt(lam + 1)))
    hi = int(lam + 6 * np.sqrt(lam + 1) + 10)
    ks = np.arange(lo, hi + 1)
    assert _chi2_pval(s, ks, stats.poisson.pmf(ks, lam)) > 1e-4
    assert (s >= 0).all()


@pytest.mark.parametrize("n,p", [
    (5, 0.3), (40, 0.1), (100, 0.5), (1000, 0.002),
    (1000, 0.3), (1000, 0.97), (20000, 0.4), (7, 0.9),
])
def test_binomial_distribution(n, p):
    g = torch.Generator().manual_seed(n * 31 + int(p * 1000))
    s = tdraws.binomial(torch.full((S,), float(n)), torch.full((S,), p), g).numpy()
    m, v = n * p, n * p * (1 - p)
    assert abs(s.mean() - m) < 4 * np.sqrt(v / S) + 1e-3
    assert abs(s.var() - v) / max(v, 1e-6) < 0.06
    assert s.min() >= 0 and s.max() <= n
    sd = max(np.sqrt(v), 1.0)
    lo = int(max(0, m - 6 * sd))
    hi = int(min(n, m + 6 * sd) + 5)
    ks = np.arange(lo, hi + 1)
    assert _chi2_pval(s, ks, stats.binom.pmf(ks, n, p)) > 1e-4


def test_binomial_edge_cases_and_floor():
    g = torch.Generator().manual_seed(0)
    out = tdraws.binomial(torch.tensor([0.0, 10.0, 10.0, 1.0]),
                          torch.tensor([0.5, 0.0, 1.0, 0.5]), g).numpy()
    assert out[0] == 0.0 and out[1] == 0.0 and out[2] == 10.0
    assert out[3] in (0.0, 1.0)
    # float n is floored like the reference's int cast (torch.binomial alone keeps 3.9)
    assert tdraws.binomial(torch.tensor([3.9]), torch.tensor([1.0]), g).item() == 3.0
    # p is clipped to [0, 1]
    out = tdraws.binomial(torch.tensor([6.0, 6.0]), torch.tensor([-0.5, 1.5]), g).numpy()
    assert out.tolist() == [0.0, 6.0]


# ---------------------------------------------------------------------- #
# the port's bits
# ---------------------------------------------------------------------- #


def port_world(hours=48, **kw):
    params, visits, _ = tiny_world(hours=hours, **kw)
    return to_port(params, visits)


def assert_same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_same_seed_same_bits():
    params, visits = port_world()
    o1 = tmodel.simulate(params, visits, 2, 7)
    assert_same(o1, tmodel.simulate(params, visits, 2, 7))
    o3 = tmodel.simulate(params, visits, 2, 8)
    assert not torch.equal(o1["total_affected"], o3["total_affected"])


def test_paged_equals_simulate():
    rng = np.random.default_rng(3)
    dense = rng.uniform(0, 3.0, (72, 6, 20)).astype(np.float32)
    dense[dense < 2.0] = 0.0
    params = port_world(hours=72)[0]
    ref = tmodel.simulate(params, tmodel.VisitSeq.from_dense(dense, "cpu"), 3, 7)
    paged = tmodel.simulate_paged(params, tmodel.HostVisitSeq.from_dense(dense), 3, 7,
                                  page_hours=24)
    assert_same(ref, paged)


@pytest.mark.parametrize("stored,total,page", [(48, 96, 24), (72, 144, 48), (24, 96, 48)])
def test_paged_periodic_wrap(stored, total, page):
    """Pages past the stored horizon wrap (periodic visit reuse): a page may
    start mid-sequence and run over its end, or hold the sequence twice."""
    rng = np.random.default_rng(5)
    dense = rng.uniform(0, 3.0, (stored, 6, 20)).astype(np.float32)
    dense[dense < 2.0] = 0.0
    params = dataclasses.replace(port_world(hours=stored)[0], total_hours=total)
    tiled = np.tile(dense, (total // stored, 1, 1))
    ref = tmodel.simulate(params, tmodel.VisitSeq.from_dense(tiled, "cpu"), 2, 11)
    paged = tmodel.simulate_paged(params, tmodel.HostVisitSeq.from_dense(dense), 2, 11,
                                  page_hours=page)
    assert_same(ref, paged)
    # one-shot simulate reads the stored sequence periodically too
    assert_same(ref, tmodel.simulate(params, tmodel.VisitSeq.from_dense(dense, "cpu"), 2, 11))


def test_page_counts_entries_on_the_host():
    """A page's rows, their entry counts (taken on the host, not read back
    from the device) and its sorted layout equal the whole sequence's rows."""
    rng = np.random.default_rng(9)
    dense = rng.uniform(0, 3.0, (72, 6, 20)).astype(np.float32)
    dense[dense < 2.4] = 0.0
    host = tmodel.HostVisitSeq.from_dense(dense)
    whole = host.to_device("cpu")
    page = host.page(48, 48, "cpu")  # rows 48..71, then 0..23
    assert page.period == 48 and whole.period == 72
    rows = list(range(48, 72)) + list(range(24))
    assert page.nnz == tuple(whole.nnz[r] for r in rows)
    assert whole.nnz == tuple(int(k) for k in (dense != 0).sum((1, 2)))
    for a, b in zip(page.tensors(), whole.tensors()):
        assert torch.equal(a, b[rows])


@pytest.mark.parametrize("page_hours", [36, 0, -24])
def test_paged_rejects_bad_page(page_hours):
    rng = np.random.default_rng(3)
    dense = rng.uniform(0, 3.0, (48, 6, 20)).astype(np.float32)
    params = port_world()[0]
    with pytest.raises(ValueError):
        tmodel.simulate_paged(params, tmodel.HostVisitSeq.from_dense(dense), 2, 0,
                              page_hours=page_hours)


def full(out):
    return out


def row(out, b):
    return {k: v[b] for k, v in out.items()}


def attack_rows(params, fracs):
    return params.attack_orig[None] * torch.tensor(fracs, dtype=torch.float32)[:, None]


def test_policy_batch_rows_equal_solo_runs():
    params, visits = port_world()
    attack = attack_rows(params, [0.4, 1.0, 0.7])
    seeds = [5, 6, 7]
    out = simulate_policy_batch(params, visits, attack, seeds, 2, extract=full)
    solo = [tmodel.simulate(dataclasses.replace(params, attack_vac=attack[b]), visits, 2, s)
            for b, s in enumerate(seeds)]
    for b in range(3):
        assert_same(row(out, b), solo[b])
    # permuting the batch permutes the rows
    perm = [2, 0, 1]
    out_p = simulate_policy_batch(params, visits, attack[perm], [seeds[i] for i in perm], 2)
    default = simulate_policy_batch(params, visits, attack, seeds, 2)
    assert set(default) == {"cases_cbg", "deaths_cbg"}
    for k in default:
        assert torch.equal(out_p[k], default[k][perm]), k
        assert torch.equal(default[k], out["history_" + {"cases_cbg": "C2",
                                                         "deaths_cbg": "D2"}[k]][:, -1])


def test_policy_batch_freezes_per_policy():
    """A policy whose epidemic dies out freezes (monitor zeroed, pending
    confirmations held) while its batch-mate runs on; both rows equal their
    runs alone."""
    params, visits = port_world(hours=48)
    params = dataclasses.replace(params, total_hours=96, vaccination_time=0, home_beta=5.0,
                                 latency_period=2.0, infectious_period=2.0)
    attack = attack_rows(params, [0.0, 1.0])
    out = simulate_policy_batch(params, visits, attack, [3, 4], 2, extract=full)
    for b, s in enumerate([3, 4]):
        solo = tmodel.simulate(dataclasses.replace(params, attack_vac=attack[b]), visits, 2, s)
        assert_same(row(out, b), solo)
    # active POIs are counted every hour until the policy freezes
    dead, alive = (int(out["monitor"][b][:, 1].nonzero().max()) for b in range(2))
    assert dead + 1 < alive < 95


def test_policy_batch_mesh_not_ported():
    params, visits = port_world()
    with pytest.raises(NotImplementedError, match="queue A, item 8"):
        simulate_policy_batch(params, visits, params.attack_orig[None], [0], 2, mesh=object())
