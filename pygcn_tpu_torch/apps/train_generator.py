"""Differentiable policy-generator trainer (reference ``policy-generator.py``,
E6, and ``hierarchical-policy-generator.py``, E7, via ``--hierarchical``).

The port of ``pygcn_tpu/apps/train_generator.py`` on one CUDA card
(``--device cuda``, the default; ``--device cpu`` when asked). Loads a frozen
trained evaluator (an ``evaluator.pkl`` of either package's
``train_evaluator``), optimizes a (Hierarchical)TopKGenerator by
backpropagating the evaluator's prediction into the generator through the
straight-through top-K flag, collects the distinct policies encountered, and
finally validates the last ``--max_validate`` of them with the real epidemic
simulator (reference ``policy-generator.py:384-438``). A policy simulates on
the seed ``derive_seed(seed, *policy)``, so the same policy always gets the
same outcome. The flag reaches the host once an epoch. Writes
``metrics.jsonl`` and ``policies.pkl`` (the results and the generator's
weights as the JAX-shaped tree of NumPy arrays).

Usage::

    python -m pygcn_tpu_torch.apps.train_generator --evaluator eval_run/evaluator.pkl \
        --out_dir gen_run --epochs 50
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
import torch

from pygcn_tpu_torch.apps.common import (build_synthetic_world, policy_outcomes,
                                         run_policy_simulation, set_process_title)
from pygcn_tpu_torch.data.features import centrality_features, generator_features, standardize
from pygcn_tpu_torch.policy import extract_policy, make_generator_train_step
from pygcn_tpu_torch.policy.topk import policy_to_vaccination_vector
from pygcn_tpu_torch.sim.model import derive_seed
from pygcn_tpu_torch.train.checkpoint import load_evaluator, model_params
from pygcn_tpu_torch.train.optim import adam_l2
from pygcn_tpu_torch.utils.device import resolve_device
from pygcn_tpu_torch.utils.logging import MetricsLogger


def generator_inputs(world, hierarchical: bool = False, num_groups: int = 3):
    """The generator's features (demographics + embeddings + centralities,
    tiled ×2, and with ``hierarchical`` the income group id last), their
    ``dim_touched``, and the evaluator's block (the same without the tiling
    and the group)."""
    from pygcn_tpu_torch.sim.policies import assign_groups, get_separators

    cent = centrality_features(world.adj)
    base = np.concatenate([standardize(world.demographics), standardize(world.embeddings)],
                          axis=1)
    gen_feats, dim_touched = generator_features(base, cent)
    if hierarchical:
        # last feature dim = demographic group id (reference
        # hierarchical-policy-generator.py:132-137)
        feat = world.demographics[:, 2]  # income
        seps = get_separators(world.sizes, feat, num_groups, normalized=False)
        groups = assign_groups(feat, seps).astype(np.float32)
        gen_feats = np.concatenate([gen_feats, groups[:, None]], axis=1)
    # evaluator feature base (duplicated block layout minus the flag,
    # reference policy-generator.py:398-399)
    eval_block = np.concatenate([base, cent], axis=1)
    return gen_feats, dim_touched, eval_block


def evaluator_base(evaluator, eval_block: np.ndarray) -> np.ndarray:
    """The evaluator's input minus its trailing flag: the block once or
    twice, as the evaluator's width says; the world's block is checked only
    by width."""
    needed = evaluator.dim_touched + (evaluator.linear_nin - evaluator.gcn_nclass + 1) - 1
    if needed == 2 * eval_block.shape[1]:
        return np.concatenate([eval_block, eval_block], axis=1)
    if needed == eval_block.shape[1]:
        return eval_block
    raise ValueError(
        f"evaluator expects {needed} base feature dims, world provides "
        f"{eval_block.shape[1]} (or doubled)"
    )


def make_generator(n_features: int, dim_touched: int, hidden: int, nn_select: int, seed: int,
                   hierarchical: bool = False, target_group: int = 0, impl: str = "auto",
                   device="cuda"):
    """The (Hierarchical)TopKGenerator at the CLI's widths (GCN ``hidden``
    wide, head 64 → 8 → 1), its weights drawn from the generator of ``seed``."""
    from pygcn_tpu_torch.nn.models import HierarchicalGenerator, TopKGenerator

    common = dict(
        gcn_nfeat=dim_touched, gcn_nhid=hidden, gcn_nclass=hidden,
        dim_touched=dim_touched, nn_select=nn_select,
        linear_nhid1=64, linear_nhid2=8, linear_nout=1, impl=impl,
        generator=torch.Generator().manual_seed(seed),
    )
    extra = n_features - dim_touched - (1 if hierarchical else 0)
    if hierarchical:
        model = HierarchicalGenerator(linear_nin=hidden + extra, target_group=target_group,
                                      **common)
    else:
        model = TopKGenerator(linear_nin=hidden + extra, **common)
    return model.to(device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs a CUDA card")
    ap.add_argument("--evaluator", required=True, help="evaluator.pkl from train_evaluator")
    ap.add_argument("--hierarchical", action="store_true",
                    help="mask a target demographic group out of the policy (E7)")
    ap.add_argument("--target_group", type=int, default=0)
    ap.add_argument("--num_groups", type=int, default=3)
    ap.add_argument("--msa_name", default="SanFrancisco")
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--weight_decay", type=float, default=5e-4)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--NN", type=int, default=5)
    ap.add_argument("--vaccination_ratio", type=float, default=0.01)
    ap.add_argument("--num_seeds", type=int, default=8)
    ap.add_argument("--quicktest", action="store_true")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--n_cbgs", type=int, default=64)
    ap.add_argument("--n_pois", type=int, default=20)
    ap.add_argument("--hours", type=int, default=96)
    ap.add_argument("--max_validate", type=int, default=8)
    ap.add_argument("--out_dir", required=True)
    args = ap.parse_args(argv)

    set_process_title("train_generator")
    device = resolve_device(args.device)

    if args.quicktest:
        args.num_seeds = 2
        args.epochs = min(args.epochs, 5)

    os.makedirs(args.out_dir, exist_ok=True)
    world = build_synthetic_world(
        n_cbgs=args.n_cbgs, n_pois=args.n_pois, hours=args.hours,
        msa_name=args.msa_name, seed=args.seed, device=device,
    )
    evaluator, _ = load_evaluator(args.evaluator, device)
    gen_feats, dim_touched, eval_block = generator_inputs(world, args.hierarchical,
                                                          args.num_groups)
    eval_base = evaluator_base(evaluator, eval_block)
    generator = make_generator(gen_feats.shape[1], dim_touched, args.hidden, args.NN, args.seed,
                               args.hierarchical, args.target_group, device=device)
    opt = adam_l2(generator.parameters(), args.lr, args.weight_decay)
    step = make_generator_train_step(generator, evaluator, opt, world.graph,
                                     torch.from_numpy(eval_base).to(device))

    logger = MetricsLogger(os.path.join(args.out_dir, "metrics.jsonl"))
    gen_feats_t = torch.from_numpy(gen_feats).to(device)
    policy_list = []
    for epoch in range(args.epochs):
        loss, vac_flag = step(gen_feats_t)
        # the epoch's one host sync: the loss and the flag in one copy
        host = torch.cat([loss.reshape(1), vac_flag[:, 0]]).cpu().numpy()
        policy = extract_policy(host[1:])
        if policy not in policy_list:
            policy_list.append(policy)
        logger.log(epoch, train_loss=host[0], n_policies=len(policy_list))

    # final: score distinct policies with the real simulator
    num_vaccines_per_cbg = world.sizes.sum() * args.vaccination_ratio / args.NN
    results = []
    for policy in policy_list[-args.max_validate:]:
        v = policy_to_vaccination_vector(policy, world.n_cbgs, num_vaccines_per_cbg)
        out = run_policy_simulation(world, v, args.num_seeds, derive_seed(args.seed, *policy))
        cases, case_std, deaths, death_std = policy_outcomes(out, world.sizes)
        results.append({"policy": list(policy), "total_cases": cases,
                        "case_rates_std": case_std})
        print(f"policy {policy}: total_cases={cases:.1f} case_std={case_std:.5f}")

    with open(os.path.join(args.out_dir, "policies.pkl"), "wb") as f:
        pickle.dump({"results": results, "gen_params": model_params(generator)}, f)
    logger.close()
    return results


if __name__ == "__main__":
    main()
