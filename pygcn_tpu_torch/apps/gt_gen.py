"""Ground-truth generation CLI.

The port of ``pygcn_tpu/apps/gt_gen.py`` (the reference's
``gt-generator/gt-gen-vac-fixed-num-cbgs*`` family, G5/G6/G7, and the
randombag script, G8) on one CUDA card (``--device cuda``, the default;
``--device cpu`` when asked): build a demographic table, form hybrid quantile
groups, sample vaccination policies (fixed-NN within a group or globally,
with optional safe-distance rejection sampling, or flooded down a random
demographic ranking), score each policy with the epidemic simulator, and
append rows ``[Vaccinated_Idxs, Total_Cases, Case_Rates_STD, Total_Deaths,
Death_Rates_STD]`` to a CSV with incremental flushing (crash-safe partial
results, reference ``gt-gen-vac-fixed-num-cbgs.py:443-450``).

The policies come from the NumPy generator of ``--random_seed``, draw for
draw as in the JAX CLI, so both write the same policy columns. Policies run
on the simulator in device batches — the reference's multiprocessing pool
becomes the batch axis — and policy row ``j`` (row 0 the no-vaccination
baseline) simulates on seed ``derive_seed(random_seed, j)``, which no
policy draw consumes.

``--shards N`` fans each batch out over N ranks (the JAX CLI's ``data``
mesh axis): every rank runs this CLI's host code in lockstep from the same
seeds, simulates its slice of each batch
(``sim.dist.simulate_policy_batch(mesh=...)``) and gets the whole batch
back; rank 0 alone prints and writes the CSV, which equals the unsharded
run's bit for bit. The ranks are those of the process group this process
belongs to (``torchrun``), or N started here (gloo on ``--device cpu``,
one card each on ``cuda``: more than the visible cards are refused).

Usage::

    python -m pygcn_tpu_torch.apps.gt_gen --num_samples 32 --NN 5 \
        --out vac_results.csv
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import dataclasses
import io
import os
from typing import Optional

import numpy as np

import torch

from pygcn_tpu_torch.apps.common import World, attack_after_vaccination, build_synthetic_world
from pygcn_tpu_torch.sim.dist import simulate_policy_batch
from pygcn_tpu_torch.sim.model import derive_seed
from pygcn_tpu_torch.sim.policies import (
    assign_groups,
    get_separators,
    vaccine_distribution_fixed_nn,
)


def batch_policy_outcomes(world: World, vac_vectors: np.ndarray, num_seeds: int, seeds,
                          approx: bool = False, mesh=None, return_cbg: bool = False):
    """Simulate a batch of vaccination vectors, one policy per row with its
    post-vaccination attack rates and its seed from ``seeds``, on the
    world's device; with ``mesh``, fanned out over its ``data`` ranks (every
    rank calls this with the same batch)."""
    p = dataclasses.replace(world.params, approx_draws=approx)
    attack_vacs = torch.from_numpy(attack_after_vaccination(world, vac_vectors)).to(
        p.attack_orig.device)
    out = simulate_policy_batch(p, world.visits, attack_vacs, seeds, num_seeds, mesh=mesh)
    hist_c, hist_d = out["cases_cbg"].cpu().numpy(), out["deaths_cbg"].cpu().numpy()

    rows = []
    deaths_per_cbg = []
    for i in range(vac_vectors.shape[0]):
        cases_cbg = hist_c[i].mean(axis=0)
        deaths_cbg = hist_d[i].mean(axis=0)
        deaths_per_cbg.append(deaths_cbg)
        rows.append(
            (
                float(cases_cbg.sum()),
                float((cases_cbg / world.sizes).std()),
                float(deaths_cbg.sum()),
                float((deaths_cbg / world.sizes).std()),
            )
        )
    if return_cbg:
        return rows, deaths_per_cbg
    return rows


def hybrid_groups(world: World, num_groups: int = 3) -> np.ndarray:
    """3-feature quantile grouping → hybrid group ids
    (reference ``gt-gen-vac-fixed-num-cbgs.py:283-330``)."""
    ids = np.zeros(world.n_cbgs, np.int64)
    for col in (1, 2, 3):  # elder, income, ew
        feat = world.demographics[:, col]
        seps = get_separators(world.sizes, feat, num_groups, normalized=False)
        ids = ids * num_groups + assign_groups(feat, seps)
    return ids


def randombag_features(world: World, s_ratio: float, i_ratio: float) -> dict:
    """The 5 stratification features of the randombag script
    (reference ``gt-gen-vac-randombag.py:407-415``): Elder_Ratio,
    Mean_Household_Income, Essential_Worker_Ratio, Vulnerability, Damage.

    The reference loads precomputed per-CBG infection matrices
    (``3cbg_avg_infect_{same,diff}``, reference ``:355-366``); the synthetic
    world derives the equivalent loads from its own co-visitation matrix
    (diagonal = same-CBG, off-diagonal row sums = cross-CBG, scaled by
    population), then applies the exact Vulnerability/Damage formulas
    (``sim.policies.vulnerability_and_damage``, reference ``:384-390``).
    """
    from pygcn_tpu_torch.sim.policies import vulnerability_and_damage

    adj = np.asarray(world.adj, np.float64)
    diag = np.diag(adj)
    infect_same = diag * world.sizes
    infect_diff = (adj.sum(axis=1) - diag) * world.sizes
    vuln, damage = vulnerability_and_damage(
        infect_same, infect_diff, world.sizes,
        world.params.death_orig.cpu().numpy(), s_ratio, i_ratio,
    )
    return {
        "Age": (world.demographics[:, 1], True),  # ratios: normalized seps
        "Mean_Household_Income": (world.demographics[:, 2], False),
        "Essential_Worker": (world.demographics[:, 3], True),
        "Vulnerability": (vuln, False),
        "Damage": (damage, False),
    }


def randombag_groups(
    world: World,
    feats: dict,
    num_groups: int,
    vaccination_ratio: float,
    target_cbg_num: int = 5,
) -> np.ndarray:
    """Stratified 3^k hybrid bags with small-group merging
    (reference ``gt-gen-vac-randombag.py:422-466``): per-feature quantile
    codes combine base-``num_groups``; groups whose population is below the
    vaccination budget or with fewer than ``target_cbg_num`` CBGs merge into
    the next group (the last merges backward)."""
    ids = np.zeros(world.n_cbgs, np.int64)
    for feat, normalized in feats.values():
        seps = get_separators(world.sizes, feat, num_groups, normalized=normalized)
        ids = ids * num_groups + assign_groups(feat, seps)

    target_pop = world.sizes.sum() * vaccination_ratio
    max_group_idx = num_groups ** len(feats)
    for i in range(max_group_idx):
        m = ids == i
        if not m.any():
            continue
        if world.sizes[m].sum() < target_pop or m.sum() < target_cbg_num:
            ids[m] = max_group_idx - 2 if i == max_group_idx - 1 else i + 1
    return ids


def gini_equity_columns(
    world: World,
    deaths_cbg: np.ndarray,
    gini_quantiles: dict,
    novac: Optional[dict] = None,
) -> dict:
    """Equity metrics for one policy (reference ``gt-gen-vac-randombag.py:
    129-165``): overall fatality rate plus the Gini coefficient of per-
    quantile-group death RATES for each demographic feature, absolute and
    relative to the no-vaccination baseline."""
    from pygcn_tpu_torch.sim.policies import gini

    out = {"Fatality_Rate_Abs": float(deaths_cbg.sum() / world.sizes.sum())}
    for feat, groups in gini_quantiles.items():
        rates = np.array([
            deaths_cbg[groups == g].sum() / world.sizes[groups == g].sum()
            for g in range(groups.max() + 1)
        ])
        out[f"{feat}_Gini_Abs"] = float(gini(rates))
    if novac is not None:
        out["Fatality_Rate_Rel"] = (
            (out["Fatality_Rate_Abs"] - novac["Fatality_Rate_Abs"])
            / novac["Fatality_Rate_Abs"]
        )
        for feat in gini_quantiles:
            base = novac[f"{feat}_Gini_Abs"]
            out[f"{feat}_Gini_Rel"] = (out[f"{feat}_Gini_Abs"] - base) / base
    else:
        out["Fatality_Rate_Rel"] = 0.0
        for feat in gini_quantiles:
            out[f"{feat}_Gini_Rel"] = 0.0
    return out


def run_randombag(args, world: World, mesh=None, writes: bool = True):
    """The G8 stratified-randombag mode (reference
    ``gt-gen-vac-randombag.py:490-545``): for every non-empty hybrid bag,
    draw ``num_groupwise`` policies by flooding the vaccination budget down a
    random permutation of the bag's CBGs, simulate, and append rows with the
    standard outcome columns plus Gini equity columns, flushed incrementally."""
    from pygcn_tpu_torch.sim.policies import vaccine_distribution_flood

    feats = randombag_features(world, args.s_ratio, args.i_ratio)
    bag_ids = randombag_groups(
        world, feats, args.randombag_groups, args.vaccination_ratio
    )
    bags = np.unique(bag_ids)
    print(f"randombag: {bags.size} non-empty bags after merging "
          f"(of {args.randombag_groups ** len(feats)})")

    # Gini quantile groups over the 3 demographic features
    # (reference demo_feat_list :82, NUM_GROUPS_FOR_GINI :45)
    gini_quantiles = {}
    for feat in ("Age", "Mean_Household_Income", "Essential_Worker"):
        vals, normalized = feats[feat]
        seps = get_separators(world.sizes, vals, args.gini_groups, normalized=normalized)
        gini_quantiles[feat] = assign_groups(vals, seps)

    fields = [
        "Vaccinated_Idxs", "Total_Cases", "Case_Rates_STD", "Total_Deaths",
        "Death_Rates_STD", "Hybrid_Group", "Fatality_Rate_Abs", "Fatality_Rate_Rel",
        "Age_Gini_Abs", "Age_Gini_Rel",
        "Mean_Household_Income_Gini_Abs", "Mean_Household_Income_Gini_Rel",
        "Essential_Worker_Gini_Abs", "Essential_Worker_Gini_Rel",
    ]
    rng = np.random.default_rng(args.random_seed)
    new_file, fh = open_rows(args.out, mesh, writes)
    writer = csv.DictWriter(fh, fieldnames=fields)

    # no-vaccination baseline: row 0 and the reference point for *_Rel
    rows, deaths = batch_policy_outcomes(
        world, np.zeros((1, world.n_cbgs)), args.num_seeds, [derive_seed(args.random_seed, 0)],
        args.approx, mesh=mesh, return_cbg=True,
    )
    novac = gini_equity_columns(world, deaths[0], gini_quantiles, novac=None)
    if new_file:
        writer.writeheader()
        writer.writerow({"Vaccinated_Idxs": "[]", "Hybrid_Group": -1,
                         **dict(zip(fields[1:5], rows[0])), **novac})
        fh.flush()

    pending = []  # (bag, vaccinated_idxs, vector)
    n = world.n_cbgs
    for bag in bags:
        members = bag_ids == bag
        for _ in range(args.num_groupwise):
            # random permutation ranks; other bags get an ineligible rank
            # (reference :496-503)
            perm = rng.permutation(n).astype(np.float64)
            perm[~members] = n + 1
            vec = vaccine_distribution_flood(
                world.sizes, args.vaccination_ratio, perm,
                ascending=True, execution_ratio=1.0,
            )
            pending.append((int(bag), np.nonzero(vec)[0], vec))

    done = 0
    while done < len(pending):
        chunk = pending[done : done + args.batch]
        seeds = [derive_seed(args.random_seed, 1 + done + i) for i in range(len(chunk))]
        rows, deaths = batch_policy_outcomes(
            world, np.stack([c[2] for c in chunk]), args.num_seeds, seeds,
            args.approx, mesh=mesh, return_cbg=True,
        )
        for (bag, idxs, _), r, d in zip(chunk, rows, deaths):
            writer.writerow({
                "Vaccinated_Idxs": "[" + ", ".join(map(str, idxs.tolist())) + "]",
                "Hybrid_Group": bag,
                **dict(zip(fields[1:5], r)),
                **gini_equity_columns(world, d, gini_quantiles, novac=novac),
            })
        fh.flush()
        done += len(chunk)
        print(f"{done}/{len(pending)} randombag samples written", flush=True)

    fh.close()
    print("done:", args.out)


def open_rows(path: str, mesh, writes: bool):
    """``(new_file, fh)``: whether ``path`` is new (rank 0's answer on every
    rank, taken before any rank writes) and the handle rows go to — the file,
    opened for appending, on the rank that writes, else a buffer nothing
    reads."""
    from pygcn_tpu_torch.parallel.launcher import rank0_value

    new_file = rank0_value(not os.path.exists(path), mesh)
    return new_file, (open(path, "a", newline="") if writes else io.StringIO())


def sample_policy(
    rng: np.random.Generator,
    world: World,
    nn: int,
    grouping: bool,
    group_ids: np.ndarray,
) -> np.ndarray:
    if grouping:
        g = rng.choice(np.unique(group_ids))
        members = np.nonzero(group_ids == g)[0]
        if members.size < nn:
            members = np.arange(world.n_cbgs)
        return rng.choice(members, nn, replace=False)
    return rng.choice(world.n_cbgs, nn, replace=False)


def policy_point(world: World, idxs: np.ndarray) -> np.ndarray:
    """3-dim demographic average of the chosen CBGs (safe-distance space,
    reference ``…-crossgroup-safedistance.py:208-237``)."""
    d = world.demographics[idxs][:, 1:4]
    return d.mean(axis=0)


def check_safety(point, accepted, safe_distance: float, metric: str = "l2") -> bool:
    if not accepted:
        return True
    pts = np.stack(accepted)
    if metric == "l2":
        dist = np.sqrt(((pts - point) ** 2).sum(axis=1))
    elif metric == "l1":
        dist = np.abs(pts - point).sum(axis=1)
    else:  # single-dim: max per-dimension gap
        dist = np.abs(pts - point).max(axis=1)
    return bool((dist >= safe_distance).all())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs a CUDA card")
    ap.add_argument("--msa_name", default="SanFrancisco")
    ap.add_argument("--synthetic", action="store_true", default=True)
    ap.add_argument("--num_samples", type=int, default=32)
    ap.add_argument("--NN", type=int, default=5, help="CBGs vaccinated per policy")
    ap.add_argument("--vaccination_ratio", type=float, default=0.01)
    ap.add_argument("--vaccination_time", type=int, default=1, help="in days")
    ap.add_argument("--num_seeds", type=int, default=8)
    ap.add_argument("--proportional", action="store_true", default=True)
    ap.add_argument("--distribution", choices=["fixed_nn", "flood"], default="fixed_nn",
                    help="fixed_nn: budget split over NN sampled CBGs (G5-G7); "
                         "flood: water-flood by a randomly-weighted demographic "
                         "ranking (the randombag script's scheme, G8)")
    ap.add_argument("--grouping", action="store_true",
                    help="sample within hybrid demographic groups (G6 --grouping)")
    ap.add_argument("--randombag", action="store_true",
                    help="G8 stratified-randombag mode: 5-feature 3^5 hybrid "
                         "bags (incl. Vulnerability/Damage) with small-group "
                         "merging, flood distribution per bag, Gini equity "
                         "columns (reference gt-gen-vac-randombag.py)")
    ap.add_argument("--num_groupwise", type=int, default=5,
                    help="randombag policies per bag (reference :73)")
    ap.add_argument("--randombag_groups", type=int, default=3,
                    help="quantiles per feature (reference NUM_GROUPS_FOR_RANDOMBAG)")
    ap.add_argument("--gini_groups", type=int, default=5,
                    help="quantiles for the Gini equity table (reference "
                         "NUM_GROUPS_FOR_GINI)")
    ap.add_argument("--s_ratio", type=float, default=0.9,
                    help="S fraction snapshot for the Damage feature (the "
                         "reference loads SEIR_at_30d)")
    ap.add_argument("--i_ratio", type=float, default=0.01,
                    help="I fraction snapshot for the Damage feature")
    ap.add_argument("--safe_distance", type=float, default=0.0,
                    help="rejection-sampling distance in demographic space (G7)")
    ap.add_argument("--safe_metric", choices=["l2", "l1", "single"], default="l2")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--n_cbgs", type=int, default=64)
    ap.add_argument("--n_pois", type=int, default=20)
    ap.add_argument("--hours", type=int, default=48)
    ap.add_argument("--random_seed", type=int, default=42)
    ap.add_argument("--quick_test", action="store_true")
    ap.add_argument("--approx", action="store_true",
                    help="hybrid fast count sampling (see sim.model.approx_draws)")
    ap.add_argument("--shards", type=int, default=0,
                    help="fan each batch of policies out over N ranks (the reference's "
                         "multiprocessing pool as a mesh data axis); see above")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    mesh = None
    if args.shards:
        from pygcn_tpu_torch.parallel.launcher import shard_mesh

        mesh, result = shard_mesh(args.shards, args.device, argv, main)
        if mesh is None or mesh.coords is None:  # ranks started here, or outside the mesh
            return result
    writes = mesh is None or mesh.rank == 0
    with contextlib.redirect_stdout(io.StringIO()) if not writes else contextlib.nullcontext():
        return _run(args, mesh, writes)


def _run(args, mesh, writes: bool):
    from pygcn_tpu_torch.apps.common import set_process_title
    from pygcn_tpu_torch.utils.device import resolve_device

    set_process_title("gt_gen")
    device = resolve_device(args.device)

    if args.quick_test:
        args.num_seeds = 2
        args.num_samples = min(args.num_samples, 4)

    world = build_synthetic_world(
        n_cbgs=args.n_cbgs, n_pois=args.n_pois, hours=args.hours,
        msa_name=args.msa_name, vaccination_time=24 * args.vaccination_time,
        seed=args.random_seed, device=device,
    )
    if args.randombag:
        if args.quick_test:
            args.num_groupwise = 1
        return run_randombag(args, world, mesh, writes)

    group_ids = hybrid_groups(world)
    from pygcn_tpu_torch.data.features import standardize

    standardized_demo = standardize(world.demographics)
    rng = np.random.default_rng(args.random_seed)

    fields = ["Vaccinated_Idxs", "Total_Cases", "Case_Rates_STD", "Total_Deaths", "Death_Rates_STD"]
    new_file, fh = open_rows(args.out, mesh, writes)
    writer = csv.DictWriter(fh, fieldnames=fields)
    if new_file:
        writer.writeheader()
        # row 0: no-vaccination baseline
        rows = batch_policy_outcomes(world, np.zeros((1, world.n_cbgs)), args.num_seeds,
                                     [derive_seed(args.random_seed, 0)], args.approx, mesh=mesh)
        writer.writerow(dict(zip(fields, ["[]"] + list(rows[0]))))
        fh.flush()

    accepted_points = []
    done = 0
    while done < args.num_samples:
        batch_policies = []
        attempts = 0
        while len(batch_policies) < min(args.batch, args.num_samples - done):
            attempts += 1
            if attempts > 200 * args.batch:
                print("rejection sampling stalled; relaxing safe distance")
                accepted_points.clear()
                attempts = 0
            idxs = sample_policy(rng, world, args.NN, args.grouping, group_ids)
            if args.safe_distance > 0:
                pt = policy_point(world, idxs)
                if not check_safety(pt, accepted_points, args.safe_distance, args.safe_metric):
                    continue
                accepted_points.append(pt)
            batch_policies.append(np.sort(idxs))

        if args.distribution == "flood":
            from pygcn_tpu_torch.sim.policies import vaccine_distribution_flood

            # G8-style: rank CBGs by a random mixture of demographic features
            # and flood the budget down the ranking
            vectors = []
            for p in batch_policies:
                wgt = rng.dirichlet(np.ones(3))
                feature = (standardized_demo[:, 1:4] * wgt).sum(axis=1)
                vectors.append(vaccine_distribution_flood(
                    world.sizes, args.vaccination_ratio, feature,
                    ascending=bool(rng.integers(0, 2)), execution_ratio=1.0,
                ))
            vectors = np.stack(vectors)
            batch_policies = [np.nonzero(v)[0][: args.NN] for v in vectors]
        else:
            vectors = np.stack([
                vaccine_distribution_fixed_nn(
                    world.sizes, args.vaccination_ratio, args.NN,
                    proportional=args.proportional, target_idxs=p,
                )
                for p in batch_policies
            ])
        seeds = [derive_seed(args.random_seed, 1 + done + i) for i in range(len(vectors))]
        rows = batch_policy_outcomes(world, vectors, args.num_seeds, seeds, args.approx,
                                     mesh=mesh)
        for p, r in zip(batch_policies, rows):
            writer.writerow(dict(zip(
                fields, ["[" + ", ".join(map(str, p.tolist())) + "]"] + list(r)
            )))
        fh.flush()  # incremental flush: crash keeps partial results
        done += len(batch_policies)
        print(f"{done}/{args.num_samples} samples written", flush=True)

    fh.close()
    print("done:", args.out)


if __name__ == "__main__":
    main()
