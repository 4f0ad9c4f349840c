"""Layered neighbourhood sampling (GraphSAGE-style) for minibatch training.

The port of ``pygcn_tpu/ops/sampling.py``, the path of ``BASELINE.json``'s
"Reddit with neighborhood sampling" configuration:

- sampling is host work over a CSR adjacency (:class:`NeighborSampler`: the
  native :func:`~pygcn_tpu_torch.utils.native.sample_layer` and
  :func:`~pygcn_tpu_torch.utils.native.unique_inverse`, or their NumPy
  fallbacks, with the same bits), overlapped with the device's steps by one
  producer thread (:func:`iter_sampled_batches`);
- each sampled layer is a fixed-fanout block: ``cols [m, K]`` indexes the
  previous layer's node set, so aggregation on the device is an
  ``index_select`` and a weighted sum over K (:func:`aggregate_block`), and
  the attention forwards softmax over the K slots of a row;
- ``mode='gcn'`` weights are the normalised edge weights scaled by
  ``deg / K``, so a sampled sum estimates the full ``A_hat @ h`` row without
  bias.

The JAX package pads every node set to a power of two so that its jitted
step compiles O(log) times; eager PyTorch compiles nothing, so the port
samples without padding (``input_nodes`` holds the real nodes only). Its
GAT and GATv2 forwards compute the ``[m, K, H]`` logits directly, where the
JAX package replicates them over each head's F lanes to fill the TPU's
128-lane vregs. Nothing here launches a hand-written kernel: the JAX path
reaches no Pallas kernel either (gathers and reductions left to XLA).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, List, Optional, Sequence

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from pygcn_tpu_torch.utils import native


@dataclasses.dataclass(frozen=True)
class SampledBlock:
    """One message-passing layer's sampled neighbourhood."""

    cols: torch.Tensor  # [m, K] int32 indices into the previous layer's nodes
    weights: torch.Tensor  # [m, K] float32 aggregation weights (0: no edge)
    self_idx: torch.Tensor  # [m] int32 index of each output node in the input set

    def to(self, device, non_blocking: bool = False) -> "SampledBlock":
        return SampledBlock(*(t.to(device, non_blocking=non_blocking)
                              for t in (self.cols, self.weights, self.self_idx)))

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.cols, self.weights, self.self_idx))


@dataclasses.dataclass(frozen=True)
class SampledBatch:
    blocks: List[SampledBlock]  # innermost layer first
    input_nodes: np.ndarray  # [n_in] int64 global ids feeding layer 0
    output_nodes: np.ndarray  # [B] int64 global ids of the last layer (the seeds)


def aggregate_block(block: SampledBlock, h: torch.Tensor) -> torch.Tensor:
    """``[n_in, F] -> [m, F]``: the weighted sum over the K sampled neighbours."""
    m, k = block.cols.shape
    gathered = h.index_select(0, block.cols.reshape(-1)).view(m, k, h.shape[1])
    return (gathered * block.weights.unsqueeze(-1)).sum(1)


class NeighborSampler:
    """Uniform fixed-fanout sampler over a CSR adjacency.

    ``mode='mean'`` averages the sampled neighbours (SAGE-mean);
    ``mode='gcn'`` scales the normalised edge weights by ``deg / K``. Every
    call of :meth:`sample_np` takes ``len(fanouts)`` draw counters, one per
    layer, from a sequential stream (``n_draws``); a layer drawn at counter
    ``d`` uses the stream ``_mix64(_mix64(seed) ^ d)``, so the blocks depend
    on the seed and the counter only.
    """

    def __init__(self, adj: sp.spmatrix, fanouts: Sequence[int], mode: str = "gcn",
                 seed: int = 0):
        csr = adj.tocsr()
        self.indptr = csr.indptr.astype(np.int64, copy=False)
        self.indices = csr.indices.astype(np.int64, copy=False)
        self.data = csr.data.astype(np.float32, copy=False)
        self.n = csr.shape[0]
        self.fanouts = list(fanouts)
        self.mode = mode
        self.seed = int(seed)
        self.n_draws = 0  # the sequential draw counter (JAX: ``_n_draws``)
        # dense rank table of the native bounded unique, allocated at first
        # use and reused (it comes back zeroed) by the sequential calls
        self._uniq_scratch: Optional[np.ndarray] = None

    def _sample_layer(self, out_nodes: np.ndarray, k: int, draw: int):
        # hash the full 64-bit seed before mixing in the counter, so seeds
        # that differ only in high bits get distinct streams
        base = native._mix64(native._mix64(self.seed & native._M64) ^ draw)
        return native.sample_layer(self.indptr, self.indices, self.data, out_nodes, k, base,
                                   mode=self.mode)

    def make_scratch(self) -> Optional[np.ndarray]:
        """A dedup table of one's own, for concurrent :meth:`sample_np` calls."""
        return np.zeros(self.n, np.int32) if native.available() else None

    def sample(self, seeds: np.ndarray) -> SampledBatch:
        """A layered minibatch for ``seeds``, its blocks as CPU tensors
        (views of the sampled NumPy arrays; :meth:`SampledBlock.to` moves them)."""
        blocks_np, input_nodes = self.sample_np(seeds)
        blocks = [SampledBlock(*(torch.from_numpy(a) for a in triple)) for triple in blocks_np]
        return SampledBatch(blocks=blocks, input_nodes=input_nodes,
                            output_nodes=np.asarray(seeds, np.int64))

    def sample_np(self, seeds: np.ndarray, draw_base: Optional[int] = None, scratch=None):
        """Host core of :meth:`sample`: ``(blocks, input_nodes)``, ``blocks``
        an innermost-first list of ``(cols [m, K] int32, weights [m, K]
        float32, self_idx [m] int32)`` NumPy triples.

        The call takes its ``len(fanouts)`` draw counters from the sequential
        stream, or, with ``draw_base``, from ``draw_base`` on: concurrent
        callers pass their own ``draw_base`` and ``scratch``
        (:meth:`make_scratch`) and get the same blocks in any order, leaving
        the stream untouched.
        """
        sequential = draw_base is None
        if sequential:
            draw_base = self.n_draws
            self.n_draws += len(self.fanouts)
        if scratch is None:
            if self._uniq_scratch is None and native.available():
                self._uniq_scratch = np.zeros(self.n, np.int32)
            if not sequential and self._uniq_scratch is not None:
                raise ValueError(
                    "concurrent sample_np calls must pass their own scratch "
                    "(make_scratch()): the shared table is not thread-safe")
            scratch = self._uniq_scratch
        out_nodes = np.asarray(seeds, np.int64)
        blocks = []
        # the outermost layer (the seeds' own) first, inwards
        for li, k in enumerate(reversed(self.fanouts)):
            cols_global, weights = self._sample_layer(out_nodes, k, draw_base + li)
            # one relabel for the layer's own nodes and their picks, in that
            # order: the node set's ids are sorted, so it is the same set and
            # the same order whichever path ran
            need = np.concatenate([out_nodes, cols_global.reshape(-1)])
            in_nodes, inverse = native.unique_inverse(need, self.n, scratch)
            self_idx = inverse[: out_nodes.size]
            cols_local = inverse[out_nodes.size:].reshape(cols_global.shape)
            blocks.append((cols_local.astype(np.int32), weights.astype(np.float32, copy=False),
                           self_idx.astype(np.int32)))
            out_nodes = in_nodes
        return blocks[::-1], out_nodes


def iter_sampled_batches(sampler: NeighborSampler, seed_batches, prefetch: int = 2,
                         sample_fn: Optional[Callable] = None):
    """Yield ``(seeds, batch)`` with host sampling overlapped.

    One producer thread runs ``sample_fn`` (default :meth:`NeighborSampler.sample`)
    up to ``prefetch`` batches ahead of the consumer; one producer keeps the
    sampler's stream the serial loop's, and the native calls release the
    GIL, so the overlap is real. The producer does host work only: the
    consumer makes every CUDA call, the copy of the blocks to the device
    included. An exception in the producer is raised in the consumer; a
    consumer that stops early stops the producer within one batch.
    ``prefetch=0`` is the serial loop.
    """
    if sample_fn is None:
        sample_fn = sampler.sample
    seed_batches = list(seed_batches)
    if prefetch <= 0:
        for seeds in seed_batches:
            yield seeds, sample_fn(seeds)
        return

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    end = object()
    stop = threading.Event()

    def produce():
        try:
            for seeds in seed_batches:
                if stop.is_set():
                    return
                q.put((seeds, sample_fn(seeds)))
        except BaseException as e:  # handed to the consumer
            q.put(e)
            return
        q.put(end)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        # an early exit: stop the producer (it checks between batches) and
        # drain the queue so that a put it blocks in returns
        stop.set()
        while t.is_alive():
            try:
                q.get_nowait()
            except queue.Empty:
                t.join(timeout=0.05)


def sampled_gcn_forward(params_list, blocks: Sequence[SampledBlock], x_input: torch.Tensor,
                        activation=torch.relu, final_activation=None) -> torch.Tensor:
    """GCN layers over sampled blocks (layer ``i`` consumes ``blocks[i]``).

    ``params_list``: per layer a mapping with ``w [F_in, F_out]`` and an
    optional ``b``. As in ``GraphConv``, ``x @ W`` first, then the weighted
    aggregation, then the bias and the activation (none after the last
    layer unless ``final_activation``). The JAX function takes the batch;
    this one takes its blocks.
    """
    h = x_input
    n_layers = len(params_list)
    for i, (p, block) in enumerate(zip(params_list, blocks)):
        h = aggregate_block(block, h @ p["w"])
        if "b" in p:
            h = h + p["b"]
        act = activation if i < n_layers - 1 else final_activation
        if act is not None:
            h = act(h)
    return h


def _slot_softmax(e: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Softmax of ``e [m, K, H]`` over K among the ``valid [m, K, 1]`` slots;
    a row with no valid slot gets all zeros. The row max is taken without
    a gradient: the shift cancels in the softmax, and a row of -inf keeps
    no path for a 0 * inf in the backward."""
    e = e.masked_fill(~valid, float("-inf"))
    emax = e.detach().amax(1, keepdim=True)
    emax = torch.where(torch.isfinite(emax), emax, torch.zeros_like(emax))
    ex = torch.exp(e - emax) * valid
    return ex / ex.sum(1, keepdim=True).clamp_min(1e-16)


def _attend(g: torch.Tensor, alpha: torch.Tensor, own: torch.Tensor,
            valid: torch.Tensor) -> torch.Tensor:
    """``sum_K alpha * g`` over the gathered messages ``g [m, K, H, F']``,
    as ``[m, H*F']``; a row with no valid slot keeps ``own``, its own
    transform."""
    m = g.shape[0]
    out = (g * alpha.unsqueeze(-1)).sum(1).reshape(m, -1)
    return torch.where(valid.any(1), out, own)


def _stack_output(out: torch.Tensor, p, is_last: bool, heads: int, fo: int, final_activation):
    """Inner layers: heads concatenated, bias, ELU; the last: the head mean and the bias."""
    if not is_last:
        if "b" in p:
            out = out + p["b"]
        return F.elu(out)
    h = out.view(-1, heads, fo).mean(1)
    if "b" in p:
        h = h + p["b"]
    return final_activation(h) if final_activation is not None else h


def sampled_gat_forward(params_list, blocks: Sequence[SampledBlock], x_input: torch.Tensor,
                        negative_slope: float = 0.2, final_activation=None) -> torch.Tensor:
    """GAT over sampled neighbourhoods: per output node, a softmax over its K
    sampled slots (duplicates of a pick each keep their own slot).

    ``params_list``: per layer ``w [F_in, H*F']``, ``a_src``/``a_dst``
    ``[H, F']`` and an optional ``b``; heads concatenated and ELU on inner
    layers, the head mean on the last. Slots of weight 0 (no edge) are
    masked out; a node with none keeps its own transform.
    """
    h = x_input
    n_layers = len(params_list)
    for i, (p, block) in enumerate(zip(params_list, blocks)):
        heads, fo = p["a_src"].shape
        m, k = block.cols.shape
        s2 = h @ p["w"]  # [n_in, H*F']
        s3 = s2.view(-1, heads, fo)
        lsrc = (s3 * p["a_src"]).sum(-1)  # [n_in, H]
        ldst = (s3 * p["a_dst"]).sum(-1)
        e = F.leaky_relu(lsrc.index_select(0, block.cols.reshape(-1)).view(m, k, heads)
                         + ldst.index_select(0, block.self_idx).unsqueeze(1), negative_slope)
        valid = (block.weights > 0).unsqueeze(-1)  # [m, K, 1]
        g = s2.index_select(0, block.cols.reshape(-1)).view(m, k, heads, fo)
        out = _attend(g, _slot_softmax(e, valid), s2.index_select(0, block.self_idx), valid)
        h = _stack_output(out, p, i == n_layers - 1, heads, fo, final_activation)
    return h


def sampled_gatv2_forward(params_list, blocks: Sequence[SampledBlock], x_input: torch.Tensor,
                          negative_slope: float = 0.2, final_activation=None) -> torch.Tensor:
    """GATv2 over sampled neighbourhoods: the logit of slot ``(v, u)`` is
    ``a . leaky_relu(s_l[u] + s_r[v])`` per head, with the masking and
    stacking of :func:`sampled_gat_forward`.

    ``params_list``: per layer ``w_l [F_in, H*F']`` (the source transform,
    also the aggregated message), an optional ``w_r`` (the receiver's; tied
    to ``w_l`` when absent), ``a [H, F']`` and an optional ``b``.
    """
    h = x_input
    n_layers = len(params_list)
    for i, (p, block) in enumerate(zip(params_list, blocks)):
        heads, fo = p["a"].shape
        m, k = block.cols.shape
        s_l = h @ p["w_l"]  # [n_in, H*F']
        s_r = h @ p["w_r"] if "w_r" in p else s_l
        g = s_l.index_select(0, block.cols.reshape(-1)).view(m, k, heads, fo)
        d = s_r.index_select(0, block.self_idx).view(m, 1, heads, fo)
        e = (F.leaky_relu(g + d, negative_slope) * p["a"]).sum(-1)  # [m, K, H]
        valid = (block.weights > 0).unsqueeze(-1)
        out = _attend(g, _slot_softmax(e, valid), s_l.index_select(0, block.self_idx), valid)
        h = _stack_output(out, p, i == n_layers - 1, heads, fo, final_activation)
    return h
