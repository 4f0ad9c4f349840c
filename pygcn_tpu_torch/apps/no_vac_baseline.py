"""No-vaccination baseline runs (reference ``gt-generator/gt-gen-no-vac.py``, G4).

The port of ``pygcn_tpu/apps/no_vac_baseline.py`` on one CUDA card
(``--device cuda``, the default; ``--device cpu`` when asked). Simulates the
epidemic with an all-zero vaccination vector over many Monte-Carlo seeds and
saves daily per-CBG cumulative cases/deaths as
``cases_cbg_no_vaccination_<msa>_<seeds>seeds.npy`` /
``deaths_cbg_no_vaccination_…`` (reference ``gt-gen-no-vac.py:208-228``),
plus ``avg_array_<msa>.npy`` and ``cbg_sizes_<msa>.npy`` — the inputs the
dynalearn exporter consumes.

Usage::

    python -m pygcn_tpu_torch.apps.no_vac_baseline --out_dir gt --num_seeds 60
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from pygcn_tpu_torch.apps.common import build_synthetic_world, run_policy_simulation


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs a CUDA card")
    ap.add_argument("--msa_name", default="SanFrancisco")
    ap.add_argument("--num_seeds", type=int, default=60)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--n_cbgs", type=int, default=64)
    ap.add_argument("--n_pois", type=int, default=20)
    ap.add_argument("--hours", type=int, default=96)
    ap.add_argument("--quick_test", action="store_true")
    ap.add_argument("--page_hours", type=int, default=0,
                    help="send the visits to the device a page of this many hours "
                         "at a time; must divide the horizon (2 x --hours) and be a "
                         "multiple of 24. 0 = the whole sequence on the device")
    ap.add_argument("--out_dir", required=True)
    args = ap.parse_args(argv)

    from pygcn_tpu_torch.apps.common import set_process_title
    from pygcn_tpu_torch.apps.train_fullgraph import resolve_device

    set_process_title("no_vac_baseline")
    device = resolve_device(args.device)

    if args.quick_test:
        args.num_seeds = 2

    world = build_synthetic_world(
        n_cbgs=args.n_cbgs, n_pois=args.n_pois, hours=args.hours,
        msa_name=args.msa_name, seed=args.seed, device=device,
    )
    out = run_policy_simulation(
        world, np.zeros(world.n_cbgs), args.num_seeds, args.seed,
        page_hours=args.page_hours or None,
    )
    # [D, N] seed-averaged daily cumulative counts
    cases = out["history_C2"].cpu().numpy().mean(axis=1)
    deaths = out["history_D2"].cpu().numpy().mean(axis=1)

    os.makedirs(args.out_dir, exist_ok=True)
    cpath = os.path.join(
        args.out_dir, f"cases_cbg_no_vaccination_{args.msa_name}_{args.num_seeds}seeds.npy"
    )
    dpath = os.path.join(
        args.out_dir, f"deaths_cbg_no_vaccination_{args.msa_name}_{args.num_seeds}seeds.npy"
    )
    np.save(cpath, cases)
    np.save(dpath, deaths)
    # also persist the averaged visit matrix for the exporter
    from pygcn_tpu_torch.graph.covisit import average_visits

    host = world.visits_host
    dense = np.zeros((host.poi_idx.shape[0], world.n_pois, world.n_cbgs), np.float32)
    for t in range(host.poi_idx.shape[0]):
        dense[t][host.poi_idx[t], host.cbg_idx[t]] += host.w[t]
    np.save(os.path.join(args.out_dir, f"avg_array_{args.msa_name}.npy"),
            average_visits(list(dense)))
    np.save(os.path.join(args.out_dir, f"cbg_sizes_{args.msa_name}.npy"), world.sizes)
    print("saved:", cpath, dpath)
    print(f"total cases (seed-avg): {cases[-1].sum():.1f}")
    return cases, deaths


if __name__ == "__main__":
    main()
