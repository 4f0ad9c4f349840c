"""REINFORCE policy trainer (reference ``rl-policy-generator.py``, E8).

The port of ``pygcn_tpu/apps/train_rl.py`` on one CUDA card (``--device
cuda``, the default; ``--device cpu`` when asked). Per episode: sample
``--epoch_width`` policies from the SoftGenerator's attention distribution
(Gumbel-top-k without replacement, from a ``torch.Generator`` of ``--seed``),
evaluate each with the epidemic simulator through the persistent memo-cache
(misses run as **one batch on the device** through ``gt_gen``'s
``batch_policy_outcomes`` — the reference's multiprocessing pool becomes a
batch axis), reward = random-policy baseline − total cases, push the top-2
into the replay buffer, replay ``--replay_width`` stored actions, and apply
the normalized-reward REINFORCE update with max-avg-reward checkpointing
(reference ``rl-policy-generator.py:324-417, 550-604``). Ends with greedy
top-K extraction + simulator validation (:629-659).

A policy simulates on the seed ``derive_seed(seed, *policy)``, so the cache
memoizes a function of the policy alone and a rerun in the same
``--out_dir`` (whose cache shards it merges) simulates only the policies it
has not seen. The random baseline and the replay picks come from
``np.random.default_rng(seed)`` in the JAX CLI's call order, so both take
the same baseline policies. ``checkpoint_rl.pkl`` keeps the parameters as
the JAX-shaped tree of NumPy arrays. ``metrics.jsonl`` gets a record an
episode (loss, average reward, cache size, the episode's seconds, and the
simulator's seconds and misses in it) and a last one with the greedy policy,
its cases, the baseline, and the baseline batch's seconds and misses.

``--shards N`` fans each miss batch out over N ranks
(``gt_gen.batch_policy_outcomes(mesh=...)``): every rank runs this CLI in
lockstep from the same seeds, rank 0's sampled policies are handed to all
(so the ranks' caches and miss batches agree whatever the card's rounding),
every rank keeps the same cache in memory, and rank 0 alone prints and
writes the cache shards, the checkpoint and ``metrics.jsonl``. The ranks
are those of the process group this process belongs to (``torchrun``), or
N started here, as ``gt_gen --shards`` starts them.

Usage::

    python -m pygcn_tpu_torch.apps.train_rl --out_dir rl_run --episodes 5
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import pickle
import time

import numpy as np
import torch

from pygcn_tpu_torch.apps.common import build_synthetic_world, set_process_title
from pygcn_tpu_torch.apps.gt_gen import batch_policy_outcomes
from pygcn_tpu_torch.data.features import centrality_features, generator_features, standardize
from pygcn_tpu_torch.parallel.launcher import rank0_value
from pygcn_tpu_torch.policy import ReplayBuffer, SimCache, make_reinforce_episode
from pygcn_tpu_torch.policy.reinforce import greedy_policy
from pygcn_tpu_torch.sim.model import derive_seed
from pygcn_tpu_torch.train.checkpoint import model_params
from pygcn_tpu_torch.train.optim import adam_l2
from pygcn_tpu_torch.utils.device import resolve_device
from pygcn_tpu_torch.utils.logging import MetricsLogger


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs a CUDA card")
    ap.add_argument("--msa_name", default="SanFrancisco")
    ap.add_argument("--episodes", type=int, default=10)
    ap.add_argument("--epoch_width", type=int, default=32,
                    help="policies sampled per episode (reference: 1000)")
    ap.add_argument("--replay_width", type=int, default=4)
    ap.add_argument("--replay_capacity", type=int, default=100)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--NN", type=int, default=5)
    ap.add_argument("--vaccination_ratio", type=float, default=0.01)
    ap.add_argument("--num_seeds", type=int, default=4)
    ap.add_argument("--quicktest", action="store_true")
    ap.add_argument("--approx", action="store_true",
                    help="fast count sampling for the simulation oracle")
    ap.add_argument("--shards", type=int, default=0,
                    help="fan the simulator's miss batches out over N ranks (the reference's "
                         "multiprocessing pool as a mesh data axis); see above")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--n_cbgs", type=int, default=64)
    ap.add_argument("--n_pois", type=int, default=20)
    ap.add_argument("--hours", type=int, default=96)
    ap.add_argument("--save_checkpoint", action="store_true", default=True)
    ap.add_argument("--out_dir", required=True)
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
    set_process_title("train_rl")
    device = resolve_device(args.device)

    from pygcn_tpu_torch.nn.models import SoftGenerator
    from pygcn_tpu_torch.sim.policies import vaccine_distribution_fixed_nn

    if args.quicktest:
        args.num_seeds = 2
        args.episodes = min(args.episodes, 3)
        args.epoch_width = min(args.epoch_width, 8)

    os.makedirs(args.out_dir, exist_ok=True)
    world = build_synthetic_world(
        n_cbgs=args.n_cbgs, n_pois=args.n_pois, hours=args.hours,
        msa_name=args.msa_name, seed=args.seed, device=device,
    )
    cent = centrality_features(world.adj)
    base = np.concatenate([standardize(world.demographics), standardize(world.embeddings)], axis=1)
    gen_feats, dim_touched = generator_features(base, cent, tile=1)
    gen_feats_t = torch.from_numpy(gen_feats).to(device)

    model = SoftGenerator(
        gcn_nfeat=dim_touched, gcn_nhid=args.hidden, gcn_nclass=args.hidden,
        dim_touched=dim_touched, nn_select=args.NN,
        linear_nhid1=64, linear_nhid2=8, generator=torch.Generator().manual_seed(args.seed),
    ).to(device)
    opt = adam_l2(model.parameters(), args.lr)
    sample_actions, update = make_reinforce_episode(model, opt, world.graph)

    cache = SimCache(args.out_dir)
    replay = ReplayBuffer(args.replay_capacity)
    rng = np.random.default_rng(args.seed)
    draws = torch.Generator(device=device).manual_seed(args.seed)

    sim = {"s": 0.0, "misses": 0}  # the simulator's seconds and policies so far

    def simulate_policies(policies):
        """Batched, memoized simulator evaluation → [(total_cases, case_std)]."""
        def evaluate(missing):
            t0 = time.perf_counter()
            vectors = np.stack([
                vaccine_distribution_fixed_nn(
                    world.sizes, args.vaccination_ratio, args.NN,
                    proportional=True, target_idxs=list(p),
                )
                for p in missing
            ])
            seeds = [derive_seed(args.seed, *p) for p in missing]
            rows = batch_policy_outcomes(world, vectors, args.num_seeds, seeds, args.approx,
                                         mesh=mesh)
            sim["s"] += time.perf_counter() - t0
            sim["misses"] += len(missing)
            return [(r[0], r[1]) for r in rows]

        return cache.evaluate_batch(policies, evaluate)

    # reward baseline: random policies (reference hardcodes 7280 for its MSA,
    # rl-policy-generator.py:541 — here it's measured on the synthetic world)
    rand_policies = [tuple(sorted(rng.choice(world.n_cbgs, args.NN, replace=False)))
                     for _ in range(8)]
    baseline = float(np.mean([c for c, _ in simulate_policies(rand_policies)]))
    print(f"random-policy baseline cases: {baseline:.1f}")
    baseline_sim = dict(sim)

    logger = MetricsLogger(os.path.join(args.out_dir, "metrics.jsonl") if writes else None)
    ckpt_path = os.path.join(args.out_dir, "checkpoint_rl.pkl")
    max_avg_reward = -np.inf
    for episode in range(args.episodes):
        t0, sim0 = time.perf_counter(), dict(sim)
        actions = rank0_value(
            sample_actions(gen_feats_t, draws, args.epoch_width, args.NN).cpu().numpy(), mesh)
        policies = [tuple(sorted(a.tolist())) for a in actions]
        outcomes = simulate_policies(policies)
        rewards = np.array([baseline - c for c, _ in outcomes], np.float32)

        # top-2 into replay (reference :565-573)
        for i in np.argsort(rewards)[-2:]:
            replay.store_transition(actions[i].tolist(), float(rewards[i]))
        # replay extra samples under the current policy (reference :574-579)
        replay_actions, replay_rewards = [], []
        for _ in range(min(args.replay_width, replay.count)):
            a, r = replay.get_action_and_reward(rng)
            replay_actions.append(a)
            replay_rewards.append(r)
        if replay_actions:
            actions = np.concatenate([actions, np.asarray(replay_actions)], axis=0)
            rewards = np.concatenate([rewards, np.asarray(replay_rewards, np.float32)])

        loss, avg_reward = update(gen_feats_t, torch.from_numpy(actions).to(device),
                                  torch.from_numpy(rewards).to(device))
        avg_reward = float(avg_reward)
        logger.log(episode, loss=loss, avg_reward=avg_reward, cache=len(cache),
                   episode_s=time.perf_counter() - t0, sim_s=sim["s"] - sim0["s"],
                   misses=sim["misses"] - sim0["misses"])
        if episode == 0 or avg_reward > max_avg_reward:
            max_avg_reward = avg_reward
            if args.save_checkpoint and writes:
                with open(ckpt_path, "wb") as f:
                    pickle.dump({
                        "episode": episode,
                        "params": model_params(model),
                        "avg_rewards": avg_reward,
                    }, f)
        if writes:
            cache.dump(str(args.seed))

    # final greedy policy + validation (reference :629-659)
    with torch.no_grad():
        probs = model(gen_feats_t, world.graph)
    best = rank0_value(sorted(greedy_policy(probs, args.NN).tolist()), mesh)
    (final_cases, final_std), = simulate_policies([tuple(best)])
    print(f"greedy policy {best}: cases={final_cases:.1f} (baseline {baseline:.1f})")
    logger.log(args.episodes, greedy=best, final_cases=final_cases, baseline=baseline,
               baseline_sim_s=baseline_sim["s"], baseline_misses=baseline_sim["misses"])
    logger.close()
    return final_cases, baseline


if __name__ == "__main__":
    main()
