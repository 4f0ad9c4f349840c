"""The simulator's hourly visit products timed at SafeGraph width.

A SafeGraph MSA as the JAX package's users run it (``PERF_NOTES.md:167-171``,
``DEMO.md:96-100``): 2943 CBGs, 50,000 POIs, about 600K visit entries an
hour, one week of hourly matrices reused, 40 Monte-Carlo seeds. The real
mobility files are not in the repository, so the visits are a stand-in drawn
in NumPy from a seed (:func:`safegraph_visits`): each (POI, CBG) pair is one
entry, as in a sparse matrix, and POI popularity follows the law of the
repository's synthetic world (``apps/common.py``, ``build_synthetic_world``),
so the busiest POIs are visited by every CBG in about half the hours. That
skew is the synthetic world's, not SafeGraph's: the real one is not measured.

It times with CUDA events (mean of 50 calls after warm-up) the POI-side
product (``V @ density``, a gather and ``torch.segment_reduce`` over entries
sorted by POI), the CBG-side product (``rates @ V``, sorted by CBG), and
beside them ``index_add_`` on the POI side (atomics: its sums change order
from run to run, so the simulator does not use it), and ``--hours`` hours of
the simulator with exact draws. It prints one JSON line, with the card's
name and power limit::

    PYTHONPATH=. python3 pygcn_tpu_torch/apps/time_sim.py

``chip_smoke.py`` builds its SafeGraph-width world from the generator and
parameters here.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

SAFEGRAPH = dict(n_cbgs=2943, n_pois=50_000, entries=600_000, period=168, hours=1512, seeds=40)
ITERS = 50


def safegraph_visits(seed: int = 0, n_cbgs: int = SAFEGRAPH["n_cbgs"],
                     n_pois: int = SAFEGRAPH["n_pois"], entries: int = SAFEGRAPH["entries"],
                     period: int = SAFEGRAPH["period"]):
    """``period`` hours of POI x CBG visits as padded COO ``(poi, cbg, w)``,
    each ``[period, E_max]``, drawn from ``seed``; 0.1-1 visitors an entry.

    POI p's popularity is ``(1 - u_p)^(-1/1.5)``, the synthetic world's law
    (``apps/common.py``). Each hour p has a Poisson number of visiting CBGs,
    at most ``n_cbgs``, with mean proportional to its popularity and capped at
    ``n_cbgs`` (the means summing to ``entries``), from a run of neighbouring
    CBG ids at a random start: every (POI, CBG) pair is one entry."""
    rng = np.random.default_rng(seed)
    pop = (1.0 - rng.uniform(size=n_pois)) ** (-1.0 / 1.5)
    scale = entries / pop.sum()
    for _ in range(100):  # the capped means sum to `entries` (fixed point from below)
        scale *= entries / np.minimum(scale * pop, n_cbgs).sum()
    mean = np.minimum(scale * pop, n_cbgs)
    rows = []
    for _ in range(period):
        k = np.minimum(rng.poisson(mean), n_cbgs)
        poi = np.repeat(np.arange(n_pois, dtype=np.int32), k)
        run = np.arange(poi.size) - np.repeat(np.cumsum(k) - k, k)
        cbg = (np.repeat(rng.integers(0, n_cbgs, n_pois), k) + run) % n_cbgs
        rows.append((poi, cbg.astype(np.int32), rng.uniform(0.1, 1.0, poi.size).astype(np.float32)))
    e_max = -(-max(r[0].size for r in rows) // 8) * 8
    out = [np.zeros((period, e_max), dt) for dt in (np.int32, np.int32, np.float32)]
    for t, row in enumerate(rows):
        for a, v in zip(out, row):
            a[t, : v.size] = v
    return tuple(out)


def safegraph_params(seed: int = 0, device="cuda", **kw):
    """San Francisco's calibration (``sim/calibration.py``) on CBGs of
    600-3000 people and POIs of 1,000-20,000 sq ft, vaccination at day 14."""
    from pygcn_tpu_torch.sim import EpidemicParams, calibration

    c, rec = SAFEGRAPH, calibration.MSA_TABLE["SanFrancisco"]
    rng = np.random.default_rng(seed + 1)
    n = c["n_cbgs"]
    return EpidemicParams.build(
        poi_areas=rng.uniform(1e3, 2e4, c["n_pois"]),
        cbg_sizes=rng.integers(600, 3000, n).astype(np.float32),
        total_hours=c["hours"], p_sick_at_t0=rec.p_sick_at_t0, vaccination_time=24 * 14,
        vaccination_vector=np.zeros(n), vaccine_acceptance=np.ones(n), protection_rate=0.9,
        poi_psi=rec.poi_psi, home_beta=rec.home_beta, cbg_attack_rates_original=np.ones(n),
        cbg_death_rates_original=np.full(n, 0.01 * rec.death_scale), device=device, **kw)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--hours", type=int, default=168, help="hours of the simulator run")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("time_sim times the CUDA device; none is available")

    import dataclasses

    from pygcn_tpu_torch.sim import VisitSeq, simulate
    from pygcn_tpu_torch.sim.model import _visit_product
    from pygcn_tpu_torch.utils.timing import cuda_ms

    c = SAFEGRAPH
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    params = dataclasses.replace(safegraph_params(), total_hours=args.hours)
    gen = torch.Generator(device="cuda").manual_seed(0)
    dens = torch.rand(1, c["seeds"], c["n_cbgs"], generator=gen, device="cuda") * 1e-3
    rates = torch.rand(1, c["seeds"], c["n_pois"], generator=gen, device="cuda")
    v = VisitSeq.from_coo(*safegraph_visits(), c["n_pois"], c["n_cbgs"], "cuda")
    e = v.nnz[0]
    x = dens.reshape(c["seeds"], -1).t().contiguous()
    seg = torch.diff(v.poi_ptr[0])
    poi_of_entry = torch.repeat_interleave(torch.arange(c["n_pois"], device="cuda"), seg)

    def poi_index_add():
        terms = x.index_select(0, v.cbg_idx[0, :e]) * v.w[0, :e, None]
        return torch.zeros(c["n_pois"], c["seeds"], device="cuda").index_add_(
            0, poi_of_entry, terms)

    row = {
        "entries_hour0": e,
        "longest_poi_segment": int(seg.max()),
        "pois_visited_by_every_cbg_hour0": int((seg == c["n_cbgs"]).sum()),
        "longest_cbg_segment": int(torch.diff(v.cbg_ptr[0]).max()),
        "poi_product_ms": cuda_ms(lambda: _visit_product(
            dens, v.cbg_idx[0, :e], v.w[0, :e], v.poi_ptr[0]), iters=ITERS),
        "cbg_product_ms": cuda_ms(lambda: _visit_product(
            rates, v.poi_by_cbg[0, :e], v.w_by_cbg[0, :e], v.cbg_ptr[0]), iters=ITERS),
        "poi_index_add_ms": cuda_ms(poi_index_add, iters=ITERS),
        "sim_hours": args.hours,
        "sim_ms_per_hour": cuda_ms(lambda: simulate(params, v, c["seeds"], 7), iters=1,
                                   warmup=1) / args.hours,
        "card": card,
    }
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
