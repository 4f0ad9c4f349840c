"""Data-parallel neighbourhood-sampled training over the ranks of a ``data``
mesh axis.

The port of ``pygcn_tpu/parallel/dp_sampled.py``. The global seed batch is
split over G ranks; each rank samples its shard's neighbourhood on the host
and runs the single-device sampled forward and backward on it, and one
all-reduce averages the loss and the gradients before Adam, the same on
every rank (JAX's ``pmean`` inside its ``shard_map``).

- :class:`ShardedNeighborSampler` splits a global batch into G shards and
  samples them from the sampler's counter stream: shard ``g`` of group call
  ``c`` draws from counter ``(c·G + g)·L`` (L layers), the counters both of
  JAX's paths consume, so its blocks equal JAX's shard ``g`` bit for bit on
  the rows JAX does not pad. ``shards=[g]`` samples rank ``g``'s shard alone
  while the stream still advances by ``G·L`` a call.
- The features are replicated (each rank gathers its input rows on its
  device), or, with ``feature_sharded``, row-sharded over the ranks
  (:func:`shard_feature_rows`): every rank then gathers all ranks' input
  node ids (:func:`gather_input_nodes`), builds the same host plan
  (:func:`build_fetch_plan`) and fetches its rows with one
  ``all_to_all_single`` of uneven splits (:func:`fetch_rows`): each remote
  row moves once, a rank's own rows never leave it.

JAX pads every node set to a power of two and stacks the shards into one
pytree so that its jitted step compiles O(log) times; eager PyTorch compiles
nothing and each rank holds its own shard, so neither the padding, nor
``stack_shard_batches``, nor the pre-pad lengths ``n_valid`` are ported:
the port's blocks are JAX's unpadded prefix, and its fetch moves no pad row.
No hand-written kernel runs on this path, as no Pallas kernel runs on
JAX's: gathers, sums over K and Adam.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.profiler import record_function

from pygcn_tpu_torch.ops.sampling import NeighborSampler, SampledBatch, SampledBlock
from pygcn_tpu_torch.parallel.dist_gcn import reduce_gradients
from pygcn_tpu_torch.parallel.mesh import Mesh


class ShardedNeighborSampler:
    """``sample_fn`` for ``iter_sampled_batches`` over ``n_shards`` shards:
    each call splits a global seed batch into equal shards and returns a
    :class:`SampledBatch` for each shard of ``shards`` (default all), in
    that order. The global batch must divide by ``n_shards``.

    Every call takes ``n_shards · L`` counters from the sampler's stream
    and shard ``g`` draws from ``base + g·L`` with a dedup table of its own,
    so a shard's blocks do not depend on which shards a process samples,
    on ``workers`` or on the completion order: ``workers > 1`` samples the
    shards of ``shards`` on a thread pool (the native sampler releases the
    GIL), which pays only when one process samples several shards.

    ``align_shard_size`` routes each seed to the shard that owns its
    feature rows (owner ``seed // align_shard_size``, the row split of
    :func:`shard_feature_rows`): the seeds are sorted by owner, stably, and
    cut into equal contiguous shards, so a shard whose seeds overflow spills
    into the next. The global gradient is the same for any routing; on a
    locality-ordered graph most sampled neighbours then lie in the rank's
    own rows and the fetch moves fewer.
    """

    def __init__(self, sampler: NeighborSampler, n_shards: int, workers: int = 0,
                 align_shard_size: Optional[int] = None,
                 shards: Optional[Sequence[int]] = None):
        self.sampler = sampler
        self.n_shards = int(n_shards)
        self.align_shard_size = align_shard_size
        self.shards = tuple(range(self.n_shards)) if shards is None else tuple(
            int(g) for g in shards)
        if any(not 0 <= g < self.n_shards for g in self.shards):
            raise ValueError(f"shards {self.shards} outside 0..{self.n_shards - 1}")
        self._scratches = {g: sampler.make_scratch() for g in self.shards}
        self._pool = None
        if workers > 1 and len(self.shards) > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(min(workers, len(self.shards)),
                                            thread_name_prefix="shard-sampler")

    def split(self, seeds: np.ndarray) -> np.ndarray:
        """The global batch as ``[n_shards, B / n_shards]`` shard seeds."""
        seeds = np.asarray(seeds, np.int64)
        if seeds.size % self.n_shards:
            raise ValueError(f"global batch {seeds.size} not divisible by "
                             f"{self.n_shards} shards")
        if self.align_shard_size is not None:
            owner = np.minimum(seeds // self.align_shard_size, self.n_shards - 1)
            seeds = seeds[np.argsort(owner, kind="stable")]
        return seeds.reshape(self.n_shards, -1)

    def __call__(self, seeds: np.ndarray) -> List[SampledBatch]:
        shard_seeds = self.split(seeds)
        n_layers = len(self.sampler.fanouts)
        base = self.sampler.n_draws
        self.sampler.n_draws = base + self.n_shards * n_layers

        def one(g: int) -> SampledBatch:
            blocks_np, input_nodes = self.sampler.sample_np(
                shard_seeds[g], draw_base=base + g * n_layers, scratch=self._scratches[g])
            return SampledBatch(
                blocks=[SampledBlock(*(torch.from_numpy(a) for a in t)) for t in blocks_np],
                input_nodes=input_nodes, output_nodes=shard_seeds[g])

        if self._pool is None:
            return [one(g) for g in self.shards]
        return list(self._pool.map(one, self.shards))


@dataclasses.dataclass(frozen=True)
class FetchPlan:
    """Where each rank's input rows come from, when rank ``o`` owns feature
    rows ``[o·S, (o+1)·S)``. Every rank holds the whole plan.

    - ``send_idx[o]``: the local rows owner ``o`` sends, to each other
      requester in rank order;
    - ``send_counts[o, r]``: how many of them go to requester ``r`` (0 on
      the diagonal: a rank's own rows never leave it);
    - ``loc_idx[r]``: requester ``r``'s own rows, gathered locally;
    - ``inv_perm[r]``: where each of ``r``'s input nodes lies in
      ``concat(received rows, in owner order; own rows)``.
    """

    send_idx: List[np.ndarray]
    send_counts: np.ndarray
    loc_idx: List[np.ndarray]
    inv_perm: List[np.ndarray]


def build_fetch_plan(input_nodes: Sequence[np.ndarray], shard_size: int) -> FetchPlan:
    """The host plan for a row-sharded feature store from every rank's
    ``input_nodes`` (rank order, lengths free)."""
    g_count = len(input_nodes)
    counts = np.zeros((g_count, g_count), np.int64)  # [requester, owner]
    req = [[None] * g_count for _ in range(g_count)]  # req[r][o]: local rows r needs from o
    loc_idx, inv_perm = [], []
    for r, nodes in enumerate(input_nodes):
        nodes = np.asarray(nodes, np.int64)
        owner = nodes // shard_size
        if nodes.size and owner.max() >= g_count:
            raise ValueError(f"node id {nodes.max()} outside {g_count} shards x {shard_size}")
        local = nodes % shard_size
        # a stable sort of small integers: NumPy's radix sort, linear in the ids
        order = np.argsort(owner.astype(np.int16 if g_count < 2**15 else np.int64),
                           kind="stable")
        so, lo = owner[order], local[order]
        counts[r] = np.bincount(owner, minlength=g_count)
        starts = np.concatenate([[0], np.cumsum(counts[r])[:-1]])
        pos = np.arange(nodes.size) - starts[so]
        remote = counts[r].copy()
        remote[r] = 0
        offset = np.concatenate([[0], np.cumsum(remote)[:-1]])  # in the received rows
        dest = np.where(so == r, remote.sum() + pos, offset[so] + pos)
        perm = np.empty(nodes.size, np.int64)
        perm[order] = dest
        inv_perm.append(perm)
        loc_idx.append(lo[so == r])
        for o in range(g_count):
            req[r][o] = lo[so == o]
    send_counts = counts.T.copy()
    np.fill_diagonal(send_counts, 0)
    send_idx = [np.concatenate([req[r][o] for r in range(g_count) if r != o]
                               + [np.zeros(0, np.int64)]) for o in range(g_count)]
    return FetchPlan(send_idx, send_counts, loc_idx, inv_perm)


def fetch_plan_stats(plan: FetchPlan, input_nodes: Sequence[np.ndarray],
                     shard_size: int) -> dict:
    """``local_frac``: the share of input rows a rank owns (JAX's, on the
    same nodes); ``rows_over_ici``: the rows the fetch moves between ranks,
    each remote row once; ``k_remote``: the longest list one owner sends one
    requester. JAX pads every list to ``K = pow2(max(1, k_remote))`` and
    moves ``G·(G−1)·K`` rows, at least the port's count."""
    own = sum(int((np.asarray(n) // shard_size == r).sum()) for r, n in enumerate(input_nodes))
    total = sum(len(n) for n in input_nodes)
    return {"local_frac": own / max(1, total),
            "k_remote": int(plan.send_counts.max()) if plan.send_counts.size else 0,
            "rows_over_ici": int(plan.send_counts.sum())}


def shard_feature_rows(mesh: Mesh, x, axis: str = "data"):
    """``(x_shard, S)``: this rank's block of rows ``[S, F]`` of the
    features (host ``x`` zero-padded to ``G·S`` rows) on its device; the
    whole matrix is never placed on one device."""
    x = np.asarray(x)
    g, c = mesh.size(axis), mesh.coord(axis)
    s = -(-x.shape[0] // g)
    block = x[c * s:(c + 1) * s]
    if block.shape[0] < s:
        block = np.concatenate([block, np.zeros((s - block.shape[0],) + x.shape[1:], x.dtype)])
    return torch.from_numpy(np.ascontiguousarray(block)).to(mesh.device), s


def gather_input_nodes(input_nodes: np.ndarray, mesh: Mesh, axis: str = "data") -> list:
    """Every rank's ``input_nodes``, in rank order (a collective: one
    ``all_gather`` of the lengths, one of the ids padded to the longest)."""
    if not dist.is_initialized():
        return [np.asarray(input_nodes, np.int64)]
    group, g = mesh.group(axis), mesh.size(axis)
    ids = torch.as_tensor(np.asarray(input_nodes, np.int64), device=mesh.device)
    n = torch.tensor([ids.numel()], dtype=torch.int64, device=mesh.device)
    lengths = [torch.empty_like(n) for _ in range(g)]
    dist.all_gather(lengths, n, group=group)
    lengths = [int(t.item()) for t in lengths]
    padded = torch.zeros(max(lengths), dtype=torch.int64, device=mesh.device)
    padded[:ids.numel()] = ids
    parts = [torch.empty_like(padded) for _ in range(g)]
    dist.all_gather(parts, padded, group=group)
    return [p[:k].cpu().numpy() for p, k in zip(parts, lengths)]


def fetch_rows(plan: FetchPlan, x_shard: torch.Tensor, mesh: Mesh,
               axis: str = "data") -> torch.Tensor:
    """This rank's input rows, in sampling order, from the row-sharded
    store: its own rows by a local ``index_select``, the rest by one
    ``all_to_all_single`` (every rank calls it, with no row to send or
    receive too). The features carry no gradient, so neither does this."""
    g = mesh.coord(axis)
    dev = x_shard.device

    def idx(a):
        return torch.from_numpy(a).to(dev)

    send = x_shard.index_select(0, idx(plan.send_idx[g]))
    out_sizes = plan.send_counts[:, g].tolist()
    recv = x_shard.new_empty((sum(out_sizes), x_shard.shape[1]))
    if dist.is_initialized():
        dist.all_to_all_single(recv, send, output_split_sizes=out_sizes,
                               input_split_sizes=plan.send_counts[g].tolist(),
                               group=mesh.group(axis))
    rows = torch.cat([recv, x_shard.index_select(0, idx(plan.loc_idx[g]))])
    return rows.index_select(0, idx(plan.inv_perm[g]))


def make_dp_sampled_step(mesh: Mesh, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                         loss: str = "xent", axis: str = "data",
                         feature_sharded: bool = False) -> Callable:
    """A data-parallel train step of a sampled model (``model(blocks,
    x_input) -> [b, C]``, e.g. ``apps/train_sampled``'s ``SampledGCN``) on
    this rank's shard of the global batch.

    Replicated features: ``step(blocks, input_nodes, x_full, y) -> loss``,
    ``input_nodes`` the ids on the device and ``x_full`` the whole matrix
    there. ``feature_sharded``: ``step(blocks, plan, x_shard, y) -> loss``
    with the :func:`build_fetch_plan` of every rank's input nodes and this
    rank's rows from :func:`shard_feature_rows`.

    ``loss='xent'``: the mean NLL of the log-softmax over the rank's seeds
    (integer labels); ``'mse'``: the mean squared error of the squeezed
    output. The loss and the gradients are averaged over the ``axis`` group
    in one flat all-reduce, then the optimizer steps, the same on every
    rank. Returns the global mean loss before the update."""
    if loss not in ("xent", "mse"):
        raise ValueError(f"unknown loss {loss!r}")
    group, g_count = mesh.group(axis), mesh.size(axis)
    params = [p for p in model.parameters() if p.requires_grad]

    def update(blocks, x_in: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        out = model(blocks, x_in)
        if loss == "mse":
            local = torch.mean((out[:, 0] - y) ** 2)
        else:
            local = F.nll_loss(F.log_softmax(out, dim=1), y)
        local = local / g_count
        local.backward()
        total = reduce_gradients(params, local, group)
        optimizer.step()
        return total

    def step(blocks, nodes_or_plan, x, y: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        with record_function("sampled.feature_gather"):  # a profiler range
            if feature_sharded:
                x_in = fetch_rows(nodes_or_plan, x, mesh, axis)
            else:
                x_in = x.index_select(0, nodes_or_plan)
        return update(blocks, x_in, y)

    return step
