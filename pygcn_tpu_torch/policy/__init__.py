"""Policy generators: the top-K generator's train step against a frozen
evaluator, REINFORCE for the soft generator, and the simulation cache."""

from pygcn_tpu_torch.policy.topk import extract_policy, make_generator_train_step
from pygcn_tpu_torch.policy.reinforce import (
    ReplayBuffer,
    gumbel_topk_sample,
    make_reinforce_episode,
    normalize_rewards,
)
from pygcn_tpu_torch.policy.cache import SimCache

__all__ = [
    "make_generator_train_step",
    "extract_policy",
    "ReplayBuffer",
    "gumbel_topk_sample",
    "normalize_rewards",
    "make_reinforce_episode",
    "SimCache",
]
