"""REINFORCE policy training for the SoftGenerator.

The port of ``pygcn_tpu/policy/reinforce.py`` (the core of the reference's
``rl-policy-generator.py``):

- sampling NN nodes *without replacement* from the attention distribution
  (reference ``torch.multinomial(..., replacement=False)`` at :332) is a
  **Gumbel-top-k** draw from an explicit ``torch.Generator``, a whole batch
  of policies at once — the two samplers define the same distribution;
- log-probs are the sum of per-action categorical log-probs under the current
  policy (the reference's bookkeeping at :333-336) and are *recomputed inside
  the update* from the current parameters, not kept from sampling;
- ``finish_episode`` semantics (:373-417): rewards normalized
  ``(r−μ)/(σ+eps)`` with the population σ, loss ``Σ −logπ·R``, one
  optimizer step;
- the replay buffer mirrors reference ``utils.ReplayBuffer``
  (``pygcn/utils.py:481-522``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

EPS = np.finfo(np.float32).eps.item()


def gumbel_topk_sample(probs: torch.Tensor, k: int, generator: torch.Generator,
                       width: Optional[int] = None) -> torch.Tensor:
    """k distinct indices ~ successive renormalized categorical draws:
    ``log(clip(p, 1e-30)) + Gumbel``, top k. ``probs`` ``[N]`` → ``[k]``, or
    ``[width, k]`` rows drawn independently when ``width`` is given. The
    generator lies on ``probs``' device."""
    shape = probs.shape if width is None else (width,) + tuple(probs.shape)
    tiny = torch.finfo(probs.dtype).tiny
    u = torch.rand(shape, generator=generator, device=probs.device, dtype=probs.dtype)
    gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    return torch.topk(torch.log(probs.clamp_min(1e-30)) + gumbel, k, dim=-1).indices


def policy_log_prob(probs: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """Σ log p(a) over the action set (reference :333-336 — fixed-distribution
    log-probs, not the without-replacement chain rule); ``actions`` ``[k]`` →
    a scalar, ``[W, k]`` → ``[W]``."""
    return torch.log(probs.clamp_min(1e-30))[actions].sum(dim=-1)


def normalize_rewards(rewards: torch.Tensor) -> torch.Tensor:
    """``(r − mean) / (σ + eps)`` with the population σ (ddof 0), as
    ``jnp.std``; torch's default unbiased σ would scale every gradient by
    √(n/(n−1))."""
    return (rewards - rewards.mean()) / (rewards.std(correction=0) + EPS)


def make_reinforce_episode(model, optimizer: torch.optim.Optimizer, graph):
    """The two pieces of one REINFORCE episode, ``(sample_actions, update)``:

    - ``sample_actions(feats, generator, width, nn)`` → ``actions`` ``[W, NN]``
      distinct-node policies drawn from the current attention distribution;
    - ``update(feats, actions, rewards)`` → ``(loss, avg_reward)`` on the
      device: recomputes log-probs under the current policy, applies the
      normalized-reward REINFORCE loss and one step of ``optimizer`` (over
      ``model``'s parameters). The loss is the one before the step.
    """

    @torch.no_grad()
    def sample_actions(feats, generator: torch.Generator, width: int, nn: int):
        return gumbel_topk_sample(model(feats, graph), nn, generator, width=width)

    def update(feats, actions, rewards):
        rewards_norm = normalize_rewards(rewards)
        optimizer.zero_grad(set_to_none=True)
        logp = policy_log_prob(model(feats, graph), actions)
        loss = -(logp * rewards_norm).sum()
        loss.backward()
        optimizer.step()
        return loss.detach(), rewards.mean()

    return sample_actions, update


class ReplayBuffer:
    """Reference-semantics replay store (``pygcn/utils.py:481-522``):
    ``{count: [action index list, reward]}`` with min-reward tracking,
    uniform sampling, and current-policy log-prob recomputation."""

    def __init__(self, capacity: int):
        self.replay_buffer = {}
        self.count = 0
        self.capacity = capacity
        self.min_reward = np.inf
        self.min_reward_idx = 0

    def store_transition(self, action_idxs, reward: float) -> None:
        self.replay_buffer[self.count] = [list(map(int, action_idxs)), float(reward)]
        if reward < self.min_reward:
            self.min_reward = reward
            self.min_reward_idx = self.count
        self.count += 1

    def clear(self) -> None:
        self.replay_buffer = {}
        self.count = 0

    def get_action_and_reward(self, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        idx = int(rng.integers(0, self.count))
        actions, reward = self.replay_buffer[idx]
        return actions, reward

    def get_log_prob(self, model, actions, feats, graph):
        """Σ log π(a) of a stored action set under the *current* policy."""
        probs = model(feats, graph)
        return policy_log_prob(probs, torch.as_tensor(actions, device=probs.device))


def greedy_policy(probs, nn: int) -> np.ndarray:
    """Final greedy top-K extraction from the attention scores
    (reference ``rl-policy-generator.py:629-659``): a stable descending
    sort, so that among equal scores the lower index comes first, as in
    ``lax.top_k`` (``torch.topk`` promises no order among ties)."""
    probs = torch.as_tensor(probs).detach()
    return torch.sort(probs, descending=True, stable=True).indices[:nn].cpu().numpy()
