"""Shared pieces for the CLI apps: synthetic worlds and simulator glue.

The port of ``pygcn_tpu/apps/common.py``. The reference scripts all load a
SafeGraph MSA (mobility pickles + census CSVs) that is not distributable;
the apps build a structurally identical synthetic world instead — POI×CBG
visit matrices, co-visitation adjacency, demographics, calibrated epidemic
parameters — from the same NumPy draws as the JAX package, so the two
packages' worlds are equal for one seed. The world's tensors sit on the
device the caller names.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from pygcn_tpu_torch.graph.covisit import average_visits, covisitation_adj
from pygcn_tpu_torch.graph.graph import Graph
from pygcn_tpu_torch.sim import EpidemicParams, VisitSeq, calibration
from pygcn_tpu_torch.sim.model import HostVisitSeq, simulate, simulate_paged


def _spectral_norm(a: np.ndarray, iters: int = 30, seed: int = 0) -> float:
    """Top singular value via power iteration (symmetric a)."""
    v = np.random.default_rng(seed).normal(size=a.shape[0])
    for _ in range(iters):
        v = a @ v
        v /= np.linalg.norm(v) + 1e-30
    return float(v @ (a @ v))


@dataclasses.dataclass
class World:
    """A synthetic MSA-shaped workload."""

    n_cbgs: int
    n_pois: int
    sizes: np.ndarray  # [N] populations
    demographics: np.ndarray  # [N, 4] sizes/elder/income/ew (raw)
    embeddings: np.ndarray  # [N, E]
    visits: VisitSeq
    visits_host: HostVisitSeq  # host copy; enables paged streaming at scale
    adj: np.ndarray  # dense co-visitation adjacency
    graph: Graph
    params: EpidemicParams
    vaccine_acceptance: np.ndarray


def build_synthetic_world(
    n_cbgs: int = 64,
    n_pois: int = 20,
    hours: int = 168,
    total_hours: Optional[int] = None,
    n_embed: int = 8,
    msa_name: str = "SanFrancisco",
    vaccination_time: int = 24,
    vaccination_vector: Optional[np.ndarray] = None,
    protection_rate: float = 1.0,
    seed: int = 0,
    device="cuda",
) -> World:
    """The synthetic world of ``seed`` (the JAX package's, draw for draw),
    with its visits, parameters and graph on ``device``."""
    rng = np.random.default_rng(seed)
    rec = calibration.MSA_TABLE[msa_name]

    sizes = rng.integers(500, 3000, n_cbgs).astype(np.float32)
    elder = rng.uniform(0.05, 0.3, n_cbgs)
    income = rng.uniform(3e4, 1.2e5, n_cbgs)
    ew = rng.uniform(0.1, 0.5, n_cbgs)
    demographics = np.stack([sizes, elder, income, ew], axis=1).astype(np.float32)
    embeddings = rng.normal(size=(n_cbgs, n_embed)).astype(np.float32)

    # Structured mobility: each CBG visits a small "home set" of POIs chosen
    # with Zipf-like POI popularity, so the co-visitation graph has real
    # communities (i.i.d.-uniform visits make it near rank-1 at scale).
    n_home = min(6, n_pois)
    poi_pop = (1.0 - rng.uniform(size=n_pois)) ** (-1.0 / 1.5)
    poi_pop /= poi_pop.sum()
    home_pois = np.stack(
        [rng.choice(n_pois, n_home, replace=False, p=poi_pop) for _ in range(n_cbgs)]
    )
    visits_dense = np.zeros((hours, n_pois, n_cbgs), np.float32)
    rate = sizes / sizes.mean()
    for c in range(n_cbgs):
        v = rng.uniform(0, 3.0, (hours, n_home)) * rate[c]
        v[v < 1.2 * rate[c]] = 0.0
        visits_dense[:, home_pois[c], c] = v
    visits_host = HostVisitSeq.from_dense(visits_dense)
    visits = visits_host.to_device(device)

    avg = average_visits(list(visits_dense))
    adj = covisitation_adj(avg)
    # The reference feeds the RAW co-visitation matrix to its GCN (reference
    # pygcn/utils.py:93-132); per-row normalization oversmooths dense
    # co-visitation graphs in one hop. A SCALAR spectral normalization keeps
    # activations O(1) against standardized targets while the VᵀV diagonal
    # keeps node identity.
    adj_scaled = adj / max(_spectral_norm(adj), 1e-12)
    graph = Graph.from_scipy(sp.csr_matrix(adj_scaled), is_symmetric=True,
                             build_dense=True).to(device)

    total = total_hours or 2 * hours  # periodic visit reuse past one cycle
    if vaccination_vector is None:
        vaccination_vector = np.zeros(n_cbgs)
    acceptance = np.ones(n_cbgs, np.float32)
    params = EpidemicParams.build(
        poi_areas=rng.uniform(100, 1000, n_pois),
        cbg_sizes=sizes,
        total_hours=total,
        # boosted vs the calibrated MSA values so the toy-scale world shows
        # visible dynamics within a short horizon
        p_sick_at_t0=max(rec.p_sick_at_t0, 1e-2),
        vaccination_time=vaccination_time,
        vaccination_vector=vaccination_vector,
        vaccine_acceptance=acceptance,
        protection_rate=protection_rate,
        poi_psi=rec.poi_psi,
        home_beta=max(rec.home_beta, 0.02),
        cbg_attack_rates_original=np.ones(n_cbgs),
        cbg_death_rates_original=np.full(n_cbgs, 0.01 * rec.death_scale),
        confirmation_lag=48.0,
        death_lag=96.0,
        device=device,
    )
    return World(
        n_cbgs=n_cbgs, n_pois=n_pois, sizes=sizes, demographics=demographics,
        embeddings=embeddings, visits=visits, visits_host=visits_host, adj=adj,
        graph=graph, params=params, vaccine_acceptance=acceptance,
    )


def attack_after_vaccination(world: World, vaccination_vectors: np.ndarray) -> np.ndarray:
    """Post-vaccination attack rates ``α·(1 − v/n)`` of each vaccination
    vector (rows of [B, N]), the vaccines clipped to population × acceptance,
    as the JAX apps rebuild them (``common.py:154-158``, ``gt_gen.py:51-56``)."""
    sizes = world.params.cbg_sizes.cpu().numpy()
    frac = np.clip(np.asarray(vaccination_vectors), None,
                   sizes * world.vaccine_acceptance) / sizes
    attack_orig = world.params.attack_orig.cpu().numpy()
    return np.clip(attack_orig * (1 - frac), 0, None).astype(np.float32)


def run_policy_simulation(
    world: World,
    vaccination_vector: np.ndarray,
    num_seeds: int,
    seed: int,
    vaccination_time: Optional[int] = None,
    page_hours: Optional[int] = None,
):
    """One simulator run for a concrete vaccination vector (the apps' analog
    of the reference's ``run_simulation`` glue, ``policy-generator.py:177-208``)
    on the world's device.

    ``page_hours`` switches to paged visits (:func:`simulate_paged`) for
    horizons whose visit buffers need not all sit on the device; results are
    bit-identical."""
    p = world.params
    fields = {"attack_vac": torch.from_numpy(
        attack_after_vaccination(world, vaccination_vector)).to(p.attack_orig.device)}
    if vaccination_time is not None:
        fields["vaccination_time"] = vaccination_time
    params = dataclasses.replace(p, **fields)
    if page_hours:
        return simulate_paged(params, world.visits_host, num_seeds, seed, page_hours=page_hours)
    return simulate(params, world.visits, num_seeds, seed)


def policy_outcomes(out, sizes: np.ndarray):
    """(total_cases, case_rate_std, total_deaths, death_rate_std) from a
    simulate() output, averaged over seeds — the gt-generator's label row
    (reference ``gt-gen-vac-fixed-num-cbgs.py:425-450``). Reads the last
    block-start record, as the JAX package does."""
    cases_cbg = out["history_C2"][-1].cpu().numpy().mean(axis=0)
    deaths_cbg = out["history_D2"][-1].cpu().numpy().mean(axis=0)
    case_rates = cases_cbg / sizes
    death_rates = deaths_cbg / sizes
    return (
        float(cases_cbg.sum()),
        float(case_rates.std()),
        float(deaths_cbg.sum()),
        float(death_rates.std()),
    )


def set_process_title(app_name: str) -> None:
    """Name the process for ops visibility, as the reference's scripts do
    (``pygcn/train.py:4-5``); a no-op when ``setproctitle`` is missing."""
    try:
        import setproctitle

        setproctitle.setproctitle(f"pygcn-tpu-torch@{app_name}")
    except ImportError:
        pass
