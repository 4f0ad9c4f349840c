"""Policy-batch fan-out of the simulator, on one device or over the ranks
of a mesh.

The reference evaluates independent vaccination policies in a
``multiprocessing.Pool`` of CPU simulator workers (reference
``pygcn/rl-policy-generator.py:308-321``); the JAX package vmaps them, and
shards the batch over a device mesh (``pygcn_tpu/sim/dist.py``). Here the
policy batch is the leading axis of every state tensor on one device; with
a ``mesh``, each rank of its ``data`` axis simulates a contiguous slice of
the batch and one ``all_gather`` a field hands every rank the whole batch.

Determinism: each policy's result depends only on its own ``(attack_vac,
seed)`` pair (its draws run on a generator of its own, and every sum it
reads is taken over its own rows), so a row of the batch has the bits of
that policy run alone, wherever it sits in the batch.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

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
    axis_name: str = "data",
):
    """Simulate a batch of policies — one row of ``attack_vacs`` ([B, N]
    post-vaccination attack rates, the only per-policy parameter) and one
    seed per policy — on the parameters' device.

    Returns ``extract``'s dict of tensors (default: ``cases_cbg`` and
    ``deaths_cbg``, [S, N] each) with a leading B axis. With ``mesh``, every
    rank of its ``axis_name`` axis calls this with the same batch: the batch
    is padded with repeats of row 0 to a multiple of the axis, each rank
    simulates its contiguous slice, and every rank gets the whole batch,
    trimmed to B, on the parameters' device. Each row has the bits of its
    policy run alone, so the result equals the unsharded one bit for bit."""
    extract = extract or _default_extract
    seeds = [int(s) for s in seeds]
    b = len(seeds)
    if mesh is None:
        return _simulate_rows(params, visits, attack_vacs, seeds, num_seeds, verbosity, extract)
    n, c = mesh.size(axis_name), mesh.coord(axis_name)
    pad = (-b) % n
    if pad:
        attack_vacs = torch.cat([attack_vacs, attack_vacs[:1].expand(pad, -1)])
        seeds = seeds + [seeds[0]] * pad
    per = (b + pad) // n
    local = _simulate_rows(params, visits, attack_vacs[c * per:(c + 1) * per],
                           seeds[c * per:(c + 1) * per], num_seeds, verbosity, extract)
    return {k: _gather_rows(v, mesh, axis_name)[:b] for k, v in local.items()}


def _simulate_rows(params, visits, attack_vacs, seeds, num_seeds, verbosity, extract):
    out = simulate_batch(params, visits, attack_vacs, seeds, num_seeds, verbosity)
    rows = [extract(policy_row(out, i)) for i in range(len(seeds))]
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


def _gather_rows(t: torch.Tensor, mesh, axis_name: str) -> torch.Tensor:
    """Every rank's ``t`` of the axis, concatenated in rank order (sent
    through the mesh's device; ``t`` itself without a process group)."""
    if not dist.is_initialized():
        return t
    send = t.contiguous().to(mesh.device)
    parts = [torch.empty_like(send) for _ in range(mesh.size(axis_name))]
    dist.all_gather(parts, send, group=mesh.group(axis_name))
    return torch.cat(parts).to(t.device)
