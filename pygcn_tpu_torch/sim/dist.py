"""Policy-batch fan-out of the simulator, on one device.

The reference evaluates independent vaccination policies in a
``multiprocessing.Pool`` of CPU simulator workers (reference
``pygcn/rl-policy-generator.py:308-321``); the JAX package vmaps them, and
shards the batch over a device mesh (``pygcn_tpu/sim/dist.py``). Here the
policy batch is the leading axis of every state tensor on one device.

Determinism: each policy's result depends only on its own ``(attack_vac,
seed)`` pair (its draws run on a generator of its own, and every sum it
reads is taken over its own rows), so a row of the batch has the bits of
that policy run alone, wherever it sits in the batch.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from pygcn_tpu_torch.sim.model import EpidemicParams, VisitSeq, policy_row, simulate_batch


def _default_extract(out):
    """The final recorded cumulative case/death fields the gt scripts
    consume (reference ``gt-gen-vac-fixed-num-cbgs.py:425-450``)."""
    return {"cases_cbg": out["history_C2"][-1], "deaths_cbg": out["history_D2"][-1]}


def simulate_policy_batch(
    params: EpidemicParams,
    visits: VisitSeq,
    attack_vacs: torch.Tensor,
    seeds: Sequence[int],
    num_seeds: int,
    *,
    verbosity: int = 24,
    extract: Optional[Callable] = None,
    mesh=None,
):
    """Simulate a batch of policies — one row of ``attack_vacs`` ([B, N]
    post-vaccination attack rates, the only per-policy parameter) and one
    seed per policy — on the parameters' device.

    Returns ``extract``'s dict of tensors (default: ``cases_cbg`` and
    ``deaths_cbg``, [S, N] each) with a leading B axis. A device mesh is not
    ported yet."""
    if mesh is not None:
        raise NotImplementedError(
            "simulate_policy_batch(mesh=...): sharding the policy batch over "
            "devices is not ported yet (queue A, item 8)")
    extract = extract or _default_extract
    out = simulate_batch(params, visits, attack_vacs, seeds, num_seeds, verbosity)
    rows = [extract(policy_row(out, b)) for b in range(len(seeds))]
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
