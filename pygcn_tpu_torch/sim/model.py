"""Metapopulation epidemic simulator, on one device.

The port of ``pygcn_tpu/sim/model.py`` (the reference's
``gt-generator/disease_model.py``, ``Model``, lines 5-346). It computes what
that module computes:

- the state is ``[policies, seeds, CBGs]`` float32 tensors; the hour loop is
  a Python loop over hours on the device (records at each block's start), and
  no hour waits on the host: the freeze flag stays a device bool used through
  ``torch.where``;
- the two hourly sparse products (POI infection rates ``V @ density`` and
  CBG cases ``rates @ V``, reference ``disease_model.py:311,319-321``) are a
  gather and a segmented sum over entries pre-sorted by segment
  (``torch.segment_reduce``), once sorted by POI and once by CBG. Each output
  is summed in entry order, so a run repeats its bits on the card, where
  ``index_add_`` would add with atomics in a varying order; the bits feed the
  draws;
- the draws are ``sim.draws`` on one ``torch.Generator`` per policy, seeded
  anew each hour from ``(seed, absolute hour)``: hour ``t``'s draws depend on
  nothing else, so :func:`simulate_paged` gives the bits of :func:`simulate`,
  and a policy's row of a batch the bits of its run alone.

Faithfulness: update order, clipping semantics (rates clipped to 1, POI cases
clipped to susceptibles, NaN→0), the vaccination-time switch of attack rates,
the clipping monitor counters, and the freeze once the epidemic dies
(reference ``disease_model.py:200-206`` stops *all* updates — including
pending confirmations — once ``max(L+I) < 1`` over one policy's seeds and
CBGs) are all reproduced.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from pygcn_tpu_torch.sim import draws

STATE_KEYS = ("latent", "infected", "removed", "cases_to_confirm", "deaths_to_happen",
              "C2", "D2")


def derive_seed(*keys: int) -> int:
    """A 64-bit generator seed that depends only on ``keys`` (non-negative ints)."""
    return int(np.random.SeedSequence([int(k) for k in keys]).generate_state(1, np.uint64)[0])


def _sorted_by(key, *vals):
    """Rows of ``key`` sorted (stably) along the last axis, and ``vals`` in that order."""
    key_s, order = torch.sort(key, dim=1, stable=True)
    return (key_s,) + tuple(torch.gather(v, 1, order) for v in vals)


def _offsets(sorted_key, n_segments: int):
    """[rows, n_segments + 1] start offsets of each segment in each sorted row;
    keys of ``n_segments`` and above lie past the last offset."""
    bounds = torch.arange(n_segments + 1, dtype=sorted_key.dtype, device=sorted_key.device)
    return torch.searchsorted(sorted_key, bounds.expand(sorted_key.shape[0], -1).contiguous())


_TENSOR_FIELDS = ("cbg_idx", "w", "poi_ptr", "poi_by_cbg", "w_by_cbg", "cbg_ptr")


@dataclasses.dataclass(frozen=True)
class VisitSeq:
    """Padded COO sequence of hourly POI×CBG visit matrices, on one device.

    Hour ``t`` uses row ``t % period`` of each [period, E_max] tensor
    (period == total hours for non-periodic data). Each row's entries are
    held sorted (stably) by POI: ``cbg_idx``/``w`` each entry's CBG and
    weight, ``poi_ptr`` [period, n_pois + 1] each POI's first entry;
    ``poi_by_cbg``/``w_by_cbg`` hold the same entries sorted by CBG, with
    ``cbg_ptr`` [period, n_cbgs + 1]. Entries of weight 0 (the padding) add
    nothing to any sum: they are sorted last, past every segment, and row
    ``t`` has ``nnz[t]`` others (counted on the host). Build it with
    :meth:`from_coo` or :meth:`HostVisitSeq.to_device`.
    """

    cbg_idx: torch.Tensor
    w: torch.Tensor
    poi_ptr: torch.Tensor
    poi_by_cbg: torch.Tensor
    w_by_cbg: torch.Tensor
    cbg_ptr: torch.Tensor
    nnz: tuple
    n_pois: int
    n_cbgs: int
    period: int

    @staticmethod
    def from_coo(poi_idx, cbg_idx, w, n_pois: int, n_cbgs: int, device="cuda") -> "VisitSeq":
        """From [period, E_max] padded COO arrays (any order), on ``device``."""
        return HostVisitSeq(np.asarray(poi_idx, np.int32), np.asarray(cbg_idx, np.int32),
                            np.asarray(w, np.float32), int(n_pois), int(n_cbgs)).to_device(device)

    @staticmethod
    def _sorted(poi, cbg, w, nnz: tuple, n_pois: int, n_cbgs: int) -> "VisitSeq":
        """From [period, E_max] COO tensors, sorted on their device (no
        host sync on a CUDA device); ``nnz`` counted on the host."""
        real = w != 0
        key_p, cbg_p, w_p = _sorted_by(torch.where(real, poi, n_pois), cbg, w)
        key_c, poi_c, w_c = _sorted_by(torch.where(real, cbg, n_cbgs), poi, w)
        return VisitSeq(
            cbg_idx=cbg_p, w=w_p, poi_ptr=_offsets(key_p, n_pois), poi_by_cbg=poi_c,
            w_by_cbg=w_c, cbg_ptr=_offsets(key_c, n_cbgs), nnz=nnz, n_pois=n_pois,
            n_cbgs=n_cbgs, period=int(poi.shape[0]),
        )

    @staticmethod
    def from_dense(mats: np.ndarray, device="cuda") -> "VisitSeq":
        """``mats``: [T, M, N] dense hourly visit matrices."""
        return HostVisitSeq.from_dense(mats).to_device(device)

    @staticmethod
    def from_scipy(mats, device="cuda") -> "VisitSeq":
        """``mats``: list of scipy sparse M×N hourly matrices."""
        return HostVisitSeq.from_scipy(mats).to_device(device)

    def tensors(self) -> tuple:
        """The sequence's tensors, in field order."""
        return tuple(getattr(self, f) for f in _TENSOR_FIELDS)

    @property
    def nbytes(self) -> int:
        """Device bytes of the sequence's tensors."""
        return sum(t.numel() * t.element_size() for t in self.tensors())


def _pack_dense(mats: np.ndarray):
    """[T, M, N] dense hourly matrices → padded COO ([T,E] poi/cbg/w, M, N)."""
    t, m, n = mats.shape
    coos = [np.nonzero(mats[i]) for i in range(t)]
    e_max = max(max((len(c[0]) for c in coos), default=1), 1)
    e_max = -(-e_max // 8) * 8
    poi = np.zeros((t, e_max), np.int32)
    cbg = np.zeros((t, e_max), np.int32)
    w = np.zeros((t, e_max), np.float32)
    for i, (pi, ci) in enumerate(coos):
        poi[i, : pi.size] = pi
        cbg[i, : ci.size] = ci
        w[i, : ci.size] = mats[i][pi, ci]
    return poi, cbg, w, m, n


def _pack_scipy(mats):
    """List of scipy sparse M×N hourly matrices → padded COO arrays."""
    t = len(mats)
    m, n = mats[0].shape
    coos = [mm.tocoo() for mm in mats]
    e_max = max(max((c.nnz for c in coos), default=1), 1)
    e_max = -(-e_max // 8) * 8
    poi = np.zeros((t, e_max), np.int32)
    cbg = np.zeros((t, e_max), np.int32)
    w = np.zeros((t, e_max), np.float32)
    for i, c in enumerate(coos):
        poi[i, : c.nnz] = c.row
        cbg[i, : c.nnz] = c.col
        w[i, : c.nnz] = c.data
    return poi, cbg, w, m, n


@dataclasses.dataclass(frozen=True)
class HostVisitSeq:
    """Host-resident (NumPy) padded COO visit sequence, for horizons whose
    ``[T, E_max]`` buffers need not all sit on the device at once: pages of
    hours go to the device in :func:`simulate_paged`."""

    poi_idx: np.ndarray  # [T, E_max] int32
    cbg_idx: np.ndarray
    w: np.ndarray  # [T, E_max] float32
    n_pois: int
    n_cbgs: int

    @staticmethod
    def from_dense(mats: np.ndarray) -> "HostVisitSeq":
        poi, cbg, w, m, n = _pack_dense(np.asarray(mats))
        return HostVisitSeq(poi, cbg, w, m, n)

    @staticmethod
    def from_scipy(mats) -> "HostVisitSeq":
        poi, cbg, w, m, n = _pack_scipy(mats)
        return HostVisitSeq(poi, cbg, w, m, n)

    @functools.cached_property
    def nnz(self) -> np.ndarray:
        """[T] entries of nonzero weight in each stored hour."""
        return np.count_nonzero(self.w, axis=1)

    def to_device(self, device="cuda") -> VisitSeq:
        """The whole horizon as one :class:`VisitSeq` on ``device``, sorted there."""
        cols = [torch.from_numpy(a).to(device) for a in (self.poi_idx, self.cbg_idx, self.w)]
        return VisitSeq._sorted(*cols, tuple(int(k) for k in self.nnz), self.n_pois,
                                self.n_cbgs)

    @functools.cached_property
    def layout(self) -> VisitSeq:
        """The whole stored horizon sorted once on the host (page-locked where
        CUDA is available): :meth:`page` copies rows of it, so a page costs
        the card no sort and, from page-locked memory, the host no wait."""
        v = self.to_device("cpu")
        if torch.cuda.is_available():
            v = dataclasses.replace(v, **{f: getattr(v, f).pin_memory() for f in _TENSOR_FIELDS})
        return v

    def page(self, t0: int, hours: int, device="cuda") -> VisitSeq:
        """:class:`VisitSeq` on ``device`` for absolute hours [t0, t0+hours)
        with period=hours, so the lookup ``t % period`` lands on the local row
        when ``t0`` is a multiple of ``hours``. Hours past the stored horizon
        wrap around (periodic reuse, e.g. one stored week cycling over a
        longer simulation). The rows come from :attr:`layout`, copied to a
        CUDA device with ``non_blocking`` on the current stream."""
        stored = self.w.shape[0]
        runs, t = [], t0
        while t < t0 + hours:  # contiguous runs of stored rows
            start = t % stored
            n = min(t0 + hours - t, stored - start)
            runs.append(slice(start, start + n))
            t += n
        lay, device = self.layout, torch.device(device)
        cols = {f: _joined([getattr(lay, f)[r].to(device, non_blocking=True) for r in runs])
                for f in _TENSOR_FIELDS}
        return VisitSeq(**cols, nnz=tuple(int(k) for r in runs for k in self.nnz[r]),
                        n_pois=self.n_pois, n_cbgs=self.n_cbgs, period=hours)


def _joined(parts):
    return parts[0] if len(parts) == 1 else torch.cat(parts)


@dataclasses.dataclass(frozen=True)
class EpidemicParams:
    """Exogenous parameters (reference ``init_exogenous_variables``,
    ``disease_model.py:24-111``); the tensors sit on the device the
    simulation runs on."""

    poi_factors: torch.Tensor  # ψ·d²/a per POI [M]
    cbg_sizes: torch.Tensor  # populations [N]
    attack_orig: torch.Tensor  # [N]
    attack_vac: torch.Tensor  # post-vaccination [N]
    death_orig: torch.Tensor  # [N]
    death_vac: torch.Tensor  # [N]
    home_beta: float
    p_sick_at_t0: float
    vaccination_time: int
    total_hours: int
    psi: float
    latency_period: float = 96.0
    infectious_period: float = 84.0
    confirmation_rate: float = 0.1
    confirmation_lag: float = 168.0
    death_lag: float = 432.0
    clip_poisson_approximation: bool = True
    # moment-matched Gaussian draws with stochastic rounding (draws.fast_count_draw);
    # False = the reference's exact distributions
    approx_draws: bool = False
    # R0-calibration mode (reference ``disease_model.py:234-258``): new cases
    # are parked in ``removed`` instead of entering ``latent``, so only the
    # initial seeds become infectious; confirmations and deaths are
    # suppressed. As in the JAX package the full new-case computation runs
    # and only the state update is gated (the reference's second gate,
    # ``disease_model.py:305``, is dead code).
    just_compute_r0: bool = False

    @staticmethod
    def build(
        *,
        poi_areas,
        cbg_sizes,
        total_hours: int,
        p_sick_at_t0: float,
        vaccination_time: int,
        vaccination_vector,
        vaccine_acceptance,
        protection_rate: float,
        poi_psi: float,
        home_beta: float,
        cbg_attack_rates_original,
        cbg_death_rates_original,
        poi_dwell_time_correction_factors=None,
        device="cuda",
        **kwargs,
    ) -> "EpidemicParams":
        """Derive rates exactly as the reference does
        (``disease_model.py:50-105``), in NumPy float32: POI factors
        ``ψ·d²/a``, vaccines clipped to ``population × acceptance``,
        post-vaccination attack rates ``α·((1−v/n) + (1−ρ)·v/n)`` clipped ≥0,
        death rates clipped to [0,1] (and — per the reference's 20211013
        change — NOT reduced by vaccination); the tensors go to ``device``."""
        poi_areas = np.asarray(poi_areas, np.float32)
        cbg_sizes = np.asarray(cbg_sizes, np.float32)
        factors = poi_psi / poi_areas
        if poi_dwell_time_correction_factors is not None:
            factors = np.asarray(poi_dwell_time_correction_factors, np.float32) * factors

        v = np.clip(
            np.asarray(vaccination_vector, np.float32),
            None,
            cbg_sizes * np.asarray(vaccine_acceptance, np.float32),
        )
        frac = v / cbg_sizes
        attack_orig = np.asarray(cbg_attack_rates_original, np.float32)
        attack_vac = attack_orig * ((1 - frac) + (1 - protection_rate) * frac)
        attack_vac = np.clip(attack_vac, 0, None)
        death = np.clip(np.asarray(cbg_death_rates_original, np.float32), 0, 1)
        if not ((death >= 0).all() and (death <= 1).all()):
            raise ValueError("death rates must lie in [0, 1]")

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32)).to(device)

        return EpidemicParams(
            poi_factors=t(factors), cbg_sizes=t(cbg_sizes), attack_orig=t(attack_orig),
            attack_vac=t(attack_vac), death_orig=t(death), death_vac=t(death),
            home_beta=float(home_beta), p_sick_at_t0=float(p_sick_at_t0),
            vaccination_time=int(vaccination_time), total_hours=int(total_hours),
            psi=float(poi_psi), **kwargs,
        )


def _visit_product(values, idx, w, ptr):
    """``out[..., s] = Σ_{e in segment s} w[e] · values[..., idx[e]]`` for
    ``values`` [B, S, n_in], over one hour's entries sorted by segment
    (``ptr``: each segment's first entry). Node-major: the B·S columns ride
    as contiguous rows through one gather and one segmented sum, each output
    summed in entry order."""
    b, s, n_in = values.shape
    x = values.reshape(b * s, n_in).t().contiguous()  # [n_in, B·S]
    terms = x.index_select(0, idx) * w[:, None]
    seg = torch.segment_reduce(terms, "sum", offsets=ptr, axis=0, unsafe=True)
    return seg.t().reshape(b, s, -1)


def _policy_sums(x):
    """[B, S, N] → [B, S] sums over N, each policy reduced as a tensor of its
    own, so a policy's sums have the bits of its run alone on any device."""
    return torch.stack([xb.sum(-1) for xb in x])


def _count(mask):
    """Per-policy count of a [B, ...] mask."""
    return mask.flatten(1).sum(1)


def _rates(latent, infected, removed, t: int, params: EpidemicParams, visits: VisitSeq):
    """The hour's deterministic quantities for [B, S, N] state; counters per policy."""
    sizes = params.cbg_sizes
    densities = infected / sizes
    num_sus = torch.clamp(sizes - latent - infected - removed, min=0.0)
    sus_frac = num_sus / sizes
    after_vac = t >= params.vaccination_time
    attack = params.attack_vac if after_vac else params.attack_orig
    death_rate = params.death_vac if after_vac else params.death_orig

    if params.psi > 0:
        base_rates = params.home_beta * attack * densities
    else:
        overall = _policy_sums(infected)[..., None] / sizes.sum()
        base_rates = (overall * params.home_beta).expand(densities.shape)
    base_rates = torch.nan_to_num(base_rates)
    n_base_clipped = _count(base_rates > 1.0)
    base_rates = torch.clamp(base_rates, max=1.0)

    tp = t % visits.period
    e = visits.nnz[tp]
    with torch.profiler.record_function("sim.visit_products"):
        w = visits.w[tp, :e]
        poi_visits = torch.segment_reduce(w[:, None], "sum", offsets=visits.poi_ptr[tp],
                                          axis=0, unsafe=True)
        # state-independent: counted once per seed, as the JAX package's
        # summed per-seed counters
        n_active_pois = (poi_visits > 0).sum() * latent.shape[1]
        poi_rates = params.poi_factors * _visit_product(
            densities, visits.cbg_idx[tp, :e], w, visits.poi_ptr[tp])
        n_poi_clipped = _count(poi_rates > 1.0)
        if params.clip_poisson_approximation:
            poi_rates = torch.clamp(poi_rates, max=1.0)
        mean_from_poi = attack * sus_frac * _visit_product(
            poi_rates, visits.poi_by_cbg[tp, :e], visits.w_by_cbg[tp, :e], visits.cbg_ptr[tp])
    mean_from_poi = torch.nan_to_num(mean_from_poi)
    return {
        "base_rates": base_rates,
        "poi_rates": poi_rates,
        "mean_from_poi": mean_from_poi,
        "num_sus": num_sus,
        "attack": attack,
        "death_rate": death_rate,
        "n_base_clipped": n_base_clipped,
        "n_active_pois": n_active_pois,
        "n_poi_clipped": n_poi_clipped,
    }


def compute_hour_rates(state, t: int, params: EpidemicParams, visits: VisitSeq):
    """Deterministic per-hour infection quantities (reference
    ``get_new_cases`` math, ``disease_model.py:260-345``):

    - ``base_rates``: home infection rates ``β·α(t)·I/n`` (clipped to 1);
    - ``poi_rates``: per-POI rates ``ψd²/a · Σ_c V[p,c]·I_c/n_c`` (clipped);
    - ``mean_from_poi``: per-CBG expected POI-sourced cases
      ``α(t)·s/n · Σ_p V[p,c]·poi_rates[p]``;

    plus num_sus, attack/death rate vectors and the clip counters. State
    tensors may carry leading batch axes (``[..., N]``); the clip counters
    count over ALL axes.
    """
    lead = state["infected"].shape[:-1]
    n = state["infected"].shape[-1]
    s3 = [state[k].reshape(1, -1, n) for k in ("latent", "infected", "removed")]
    r = _rates(*s3, t, params, visits)
    out = {k: r[k].reshape(*lead, r[k].shape[-1])
           for k in ("base_rates", "poi_rates", "mean_from_poi", "num_sus")}
    out.update(attack=r["attack"], death_rate=r["death_rate"],
               n_base_clipped=r["n_base_clipped"].sum(), n_active_pois=r["n_active_pois"],
               n_poi_clipped=r["n_poi_clipped"].sum())
    return out


def _binomial(n, p, approx: bool, generator):
    if not approx:
        return draws.binomial(n, p, generator)
    # n arrives as float state; the reference casts to int before drawing
    n = torch.floor(n)
    p = draws.probability(p, n)
    return draws.fast_count_draw(n * p, n * p * (1.0 - p), n, generator)


def _poisson(lam, approx: bool, generator):
    if approx:
        return draws.fast_count_draw(lam, lam, None, generator)
    return draws.poisson(lam, generator)


def _policy_draws(g, params: EpidemicParams, mean_from_poi, num_sus, base_rates, latent,
                  infected, cases_to_confirm, deaths_to_happen, death_rate):
    """One policy's draws of one hour ([S, N] each), in a fixed order on ``g``."""
    a = params.approx_draws
    d = {"cases_poi_raw": _poisson(mean_from_poi, a, g)}
    cases_poi = torch.minimum(d["cases_poi_raw"], num_sus)
    cases_base = _binomial(num_sus - cases_poi, base_rates, a, g)
    d["new_cases"] = cases_poi + cases_base
    d["new_infectious"] = _binomial(latent, 1.0 / params.latency_period, a, g)
    d["new_removed"] = _binomial(infected, 1.0 / params.infectious_period, a, g)
    if params.just_compute_r0:
        return d
    d["new_confirmed"] = _binomial(cases_to_confirm, 1.0 / params.confirmation_lag, a, g)
    d["add_to_confirm"] = _binomial(d["new_infectious"], params.confirmation_rate, a, g)
    d["new_deaths"] = _binomial(deaths_to_happen, 1.0 / params.death_lag, a, g)
    d["add_deaths"] = _binomial(d["new_infectious"], death_rate, a, g)
    return d


def _hour_update(state, t: int, params: EpidemicParams, visits: VisitSeq, seeds, gens):
    """One hour for all policies and seeds: ``state`` is a dict of [B, S, N]
    tensors. Returns ``(new_state, monitor [B, 5])``, the counters summed over
    each policy's seeds."""
    latent, infected, removed = state["latent"], state["infected"], state["removed"]
    rates = _rates(latent, infected, removed, t, params, visits)
    shape = latent.shape
    per_policy = [rates["mean_from_poi"], rates["num_sus"], rates["base_rates"], latent,
                  infected, state["cases_to_confirm"], state["deaths_to_happen"],
                  rates["death_rate"].expand(shape)]
    with torch.profiler.record_function("sim.draws"):
        rows = []
        for b, (seed, g) in enumerate(zip(seeds, gens)):
            g.manual_seed(derive_seed(seed, 1, t))
            rows.append(_policy_draws(g, params, *(x[b] for x in per_policy)))
        d = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

    monitor = torch.stack([
        rates["n_base_clipped"], rates["n_active_pois"].expand(shape[0]),
        rates["n_poi_clipped"], _count(rates["mean_from_poi"] > 0),
        _count(d["cases_poi_raw"] > rates["num_sus"]),
    ], dim=1)
    new_infectious, new_removed = d["new_infectious"], d["new_removed"]
    if params.just_compute_r0:
        new_state = dict(state)
        new_state.update(latent=latent - new_infectious,
                         infected=infected + new_infectious - new_removed,
                         removed=removed + new_removed + d["new_cases"])
        return new_state, monitor
    return {
        "latent": latent + d["new_cases"] - new_infectious,
        "infected": infected + new_infectious - new_removed,
        "removed": removed + new_removed,
        "cases_to_confirm": state["cases_to_confirm"] + d["add_to_confirm"] - d["new_confirmed"],
        "deaths_to_happen": state["deaths_to_happen"] + d["add_deaths"] - d["new_deaths"],
        "C2": state["C2"] + d["new_confirmed"],
        "D2": state["D2"] + d["new_deaths"],
    }, monitor


def init_state(params: EpidemicParams, num_seeds: int, seed: int,
               generator: Optional[torch.Generator] = None):
    """Binomial latent seeding (reference ``init_endogenous_variables``,
    ``disease_model.py:113-127``): a dict of [num_seeds, N] tensors. The draw
    runs on ``generator`` (a new one on the parameters' device by default),
    seeded from ``seed``."""
    sizes = params.cbg_sizes
    g = generator or torch.Generator(device=sizes.device)
    g.manual_seed(derive_seed(seed, 0))
    p0 = draws.binomial(sizes.expand(num_seeds, -1), params.p_sick_at_t0, g)
    zeros = torch.zeros_like(p0)
    return {"latent": p0, **{k: zeros for k in STATE_KEYS[1:]}}


def _run_blocks(state, over, t0: int, params: EpidemicParams, visits: VisitSeq, seeds, gens,
                verbosity: int, blocks: int, recs: list, monitors: list):
    """Run ``blocks`` recording blocks from absolute hour ``t0``, appending
    each block's start record to ``recs`` and each hour's [B, 5] monitor to
    ``monitors``. ``t0`` must be a multiple of ``visits.period``."""
    for block in range(blocks):
        # record at block start (reference records at loop top, t % 24 == 0)
        recs.append({
            "L": _policy_sums(state["latent"]),
            "I": _policy_sums(state["infected"]),
            "R": _policy_sums(state["removed"]),
            "history_C2": state["C2"],
            "history_D2": state["D2"],
        })
        for h in range(verbosity):
            t = t0 + block * verbosity + h
            new_state, monitor = _hour_update(state, t, params, visits, seeds, gens)
            # freeze a policy once its epidemic has died (reference
            # disease_model.py:200-206), its monitor zeroed from that hour on
            frozen = over[:, None, None]
            state = {k: torch.where(frozen, state[k], new_state[k]) for k in STATE_KEYS}
            over = over | (torch.amax(state["latent"] + state["infected"], dim=(1, 2)) < 1.0)
            monitors.append(torch.where(over[:, None], 0, monitor))
    return state, over


def _finalize(state, recs, monitors, verbosity: int):
    """Batch outputs, the policy axis first (``times`` shared)."""
    all_affected = state["latent"] + state["infected"] + state["removed"]
    out = {k: torch.stack([r[k] for r in recs], dim=1) for k in recs[0]}
    out.update(
        C2=state["C2"], D2=state["D2"], total_affected=_policy_sums(all_affected),
        cbg_all_affected=all_affected, monitor=torch.stack(monitors, dim=1),
        times=torch.arange(len(recs), device=all_affected.device) * verbosity,
    )
    return out


def policy_row(out, b: int):
    """Policy ``b``'s outputs from a batch's outputs."""
    return {k: v if k == "times" else v[b] for k, v in out.items()}


def _pages(visits, params: EpidemicParams, verbosity: int, page_hours: Optional[int]):
    """``(t0, blocks, VisitSeq)`` in hour order over the horizon: ``visits``
    whole, or (``page_hours`` set) a :class:`HostVisitSeq` a page at a time
    on the parameters' device (:func:`_prefetched`)."""
    if params.total_hours % verbosity:
        raise ValueError("total_hours must be a multiple of verbosity")
    if page_hours is None:
        return [(0, params.total_hours // verbosity, visits)]
    page_hours = min(page_hours, params.total_hours)
    if page_hours <= 0 or page_hours % verbosity or params.total_hours % page_hours:
        raise ValueError(
            "page_hours must be a positive multiple of verbosity and divide total_hours"
        )
    t0s = range(0, params.total_hours, page_hours)
    return ((t0, page_hours // verbosity, page)
            for t0, page in _prefetched(visits, t0s, page_hours, params.cbg_sizes.device))


def _prefetched(host: HostVisitSeq, t0s, hours: int, device):
    """``(t0, VisitSeq)`` for the pages of ``hours`` hours at ``t0s``. On a
    CUDA device page k+1's copies (from the host-sorted, page-locked
    :attr:`HostVisitSeq.layout`) are queued on a side stream before page k
    is handed over, so they run while the card runs page k's hours; the
    current stream waits for a page only where it starts. Elsewhere each
    page is built when asked for."""
    device = torch.device(device)
    if device.type != "cuda":
        for t0 in t0s:
            yield t0, host.page(t0, hours, device)
        return
    main, side = torch.cuda.current_stream(device), torch.cuda.Stream(device)

    def queue(t0):
        with torch.cuda.stream(side):
            page = host.page(t0, hours, device)
            ready = side.record_event()
        for t in page.tensors():  # read on the main stream: not reused before it has
            t.record_stream(main)
        return t0, page, ready

    t0s = list(t0s)
    ahead = queue(t0s[0])
    for t0_next in t0s[1:] + [None]:
        t0, page, ready = ahead
        if t0_next is not None:
            ahead = queue(t0_next)
        main.wait_event(ready)
        yield t0, page


def simulate_batch(params: EpidemicParams, visits, attack_vacs: torch.Tensor,
                   seeds: Sequence[int], num_seeds: int, verbosity: int = 24,
                   page_hours: Optional[int] = None):
    """Simulate one policy per row of ``attack_vacs`` ([B, N] post-vaccination
    attack rates), each on its own ``seeds[b]``, all at once, on the
    parameters' device.

    ``visits`` is a :class:`VisitSeq` there, or with ``page_hours`` a
    :class:`HostVisitSeq` sent a page at a time (on CUDA the next page is
    queued before the current one's hours). Returns the
    outputs of :func:`simulate` with a leading policy axis (``times``
    shared)."""
    sizes = params.cbg_sizes
    seeds = [int(s) for s in seeds]
    if attack_vacs.shape != (len(seeds), sizes.shape[0]):
        raise ValueError(f"attack_vacs {tuple(attack_vacs.shape)}: expected "
                         f"({len(seeds)}, {sizes.shape[0]}), one row per seed")
    if (visits.n_pois, visits.n_cbgs) != (params.poi_factors.shape[0], sizes.shape[0]):
        raise ValueError("visits and params disagree on the POI or CBG count")
    pages = _pages(visits, params, verbosity, page_hours)
    gens = [torch.Generator(device=sizes.device) for _ in seeds]
    inits = [init_state(params, num_seeds, s, g) for s, g in zip(seeds, gens)]
    state = {k: torch.stack([i[k] for i in inits]) for k in STATE_KEYS}
    over = torch.zeros(len(seeds), dtype=torch.bool, device=sizes.device)
    p = dataclasses.replace(params, attack_vac=attack_vacs.to(sizes)[:, None, :])
    recs, monitors = [], []
    for t0, blocks, page in pages:
        state, over = _run_blocks(state, over, t0, p, page, seeds, gens, verbosity, blocks,
                                  recs, monitors)
    return _finalize(state, recs, monitors, verbosity)


def simulate(params: EpidemicParams, visits: VisitSeq, num_seeds: int, seed: int,
             verbosity: int = 24):
    """Run the full horizon on the parameters' device; returns the
    reference's outputs as a dict:

    ``times`` [D], ``L``/``I``/``R`` [D, S] (block-start sums),
    ``history_C2``/``history_D2`` [D, S, N] (block-start cumulative),
    ``C2``/``D2`` [S, N] (final), ``total_affected`` [S],
    ``cbg_all_affected`` [S, N], ``monitor`` [T, 5] seed-summed clip counters.
    (Reference returns tuple at ``disease_model.py:222``.) The draws depend
    only on ``seed`` and the hour."""
    out = simulate_batch(params, visits, params.attack_vac[None], [seed], num_seeds, verbosity)
    return policy_row(out, 0)


def simulate_paged(params: EpidemicParams, visits: HostVisitSeq, num_seeds: int, seed: int,
                   verbosity: int = 24, page_hours: int = 168):
    """:func:`simulate` with the visit sequence sent to the device a page of
    ``page_hours`` hours at a time; on a CUDA device each page is copied on
    a side stream while the card runs the page before (:func:`_prefetched`).
    Bit-identical to ``simulate`` on the same seed: absolute
    hours drive both the draws and the vaccination-time switch."""
    out = simulate_batch(params, visits, params.attack_vac[None], [seed], num_seeds, verbosity,
                         page_hours=page_hours)
    return policy_row(out, 0)
