"""The graph's partition over ranks, and node orderings for locality.

Host-side NumPy/SciPy, copied from ``pygcn_tpu/parallel/partition.py``.

:func:`build_dist_plan` row-partitions a graph over ``n_shards`` ranks: shard
*i* owns a contiguous node range (rows of A, X and Y), and every edge lives
on the shard that owns its receiver. Edges split into **local** edges (the
sender is owned too), aggregated from the resident rows, and **remote**
edges, whose senders' rows arrive by one all-to-all (the halo exchange):
each shard ships every peer the unique rows that peer needs
(``send_idx``), once, however many edges name them. The plan is built once
per graph and its arrays are static; :meth:`DistPlan.shard` hands one rank
its row of every array as tensors on its device.

:func:`locality_order`, :func:`reorder_graph` and :func:`reorder_dataset`
order a graph community by community: contiguous row shards then own
communities and ship less, and the hybrid layout's 128×128 tiles fill
(``ops/hybrid.py``); a shuffled real-world graph has almost none.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from pygcn_tpu_torch.graph.graph import Graph
from pygcn_tpu_torch.utils.logging import span


def _pad_to(x: int, m: int) -> int:
    return max(m, -(-x // m) * m)


@dataclasses.dataclass(frozen=True)
class PlanShard:
    """One rank's row of a :class:`DistPlan`, as tensors on its device."""

    loc_s: torch.Tensor  # [E_loc] int64, shard-local senders
    loc_r: torch.Tensor  # [E_loc] int64, shard-local receivers
    loc_w: torch.Tensor  # [E_loc]
    rem_h: torch.Tensor  # [E_rem] int64, rows of the incoming halo table
    rem_r: torch.Tensor  # [E_rem] int64
    rem_w: torch.Tensor  # [E_rem]
    send_idx: torch.Tensor  # [P, halo] int64: the local rows this rank ships to each peer
    loc_ell: Optional[tuple]  # (cols, vals, rows) per bucket, flat; or None
    rem_ell: Optional[tuple]
    n_shards: int
    shard_size: int

    @property
    def n_nodes_padded(self) -> int:
        return self.n_shards * self.shard_size


@dataclasses.dataclass(frozen=True)
class DistPlan:
    """Per-shard static index plan, host NumPy with a leading shard axis.

    The fields of ``pygcn_tpu.parallel.partition.DistPlan``, array for array,
    and ``halo_counts``: ``[P, P]``, the rows shard *i* receives from shard
    *o* (the boundary rows; ``halo`` pads their maximum)."""

    # local edges: senders/receivers in shard-local coordinates
    loc_s: np.ndarray  # [P, E_loc]
    loc_r: np.ndarray  # [P, E_loc]
    loc_w: np.ndarray  # [P, E_loc]
    # remote edges: sender indexes the flattened incoming halo table
    rem_h: np.ndarray  # [P, E_rem]
    rem_r: np.ndarray  # [P, E_rem]
    rem_w: np.ndarray  # [P, E_rem]
    # send_idx[o, i, k]: k-th local row shard o ships to shard i
    send_idx: np.ndarray  # [P, P, halo]
    # optional stacked per-shard ELL layouts (ops/ell.build_ell_stacked)
    loc_ell: Optional[tuple]  # (cols, vals, rows) tuples of [P, ...] arrays, or None
    rem_ell: Optional[tuple]
    n_shards: int
    shard_size: int  # nodes per shard (padded)
    halo: int  # halo slots per (src, dst) pair
    n_nodes: int  # true node count
    halo_counts: np.ndarray  # [P, P] int64: rows shard i receives from shard o

    @property
    def n_nodes_padded(self) -> int:
        return self.n_shards * self.shard_size

    @property
    def halo_rows(self) -> int:
        """Boundary rows the whole exchange moves (0 on one shard)."""
        return int(self.halo_counts.sum())

    def shard(self, rank: int, device) -> PlanShard:
        """Rank ``rank``'s row of every array, on ``device``. Edge and
        ``send_idx`` indices become int64 (``scatter_reduce``'s index type);
        the ELL arrays keep int32."""

        def row(a, dtype=None):
            t = torch.from_numpy(np.ascontiguousarray(a[rank]))
            return t.to(device=device, dtype=dtype)

        def ell(layout):
            if layout is None:
                return None
            return tuple(tuple(row(a) for a in arrays) for arrays in layout)

        return PlanShard(
            loc_s=row(self.loc_s, torch.int64), loc_r=row(self.loc_r, torch.int64),
            loc_w=row(self.loc_w), rem_h=row(self.rem_h, torch.int64),
            rem_r=row(self.rem_r, torch.int64), rem_w=row(self.rem_w),
            send_idx=row(self.send_idx, torch.int64), loc_ell=ell(self.loc_ell),
            rem_ell=ell(self.rem_ell), n_shards=self.n_shards, shard_size=self.shard_size)


def build_dist_plan(graph: Graph, n_shards: int, *, align: int = 8,
                    build_ell: bool = True) -> DistPlan:
    """Partition ``graph``'s rows into ``n_shards`` contiguous ranges of
    ``shard_size`` nodes (a multiple of ``align``) and plan the halo
    exchange; with ``build_ell`` (the default) also the stacked per-shard ELL
    layouts of the local and remote edges. Padding edges carry weight 0."""
    e = graph.n_edges
    senders = graph.senders[:e].cpu().numpy().astype(np.int64)
    receivers = graph.receivers[:e].cpu().numpy().astype(np.int64)
    weights = graph.weights[:e].cpu().numpy()

    shard_size = _pad_to(-(-graph.n_nodes // n_shards), align)
    owner_s = senders // shard_size
    owner_r = receivers // shard_size

    loc_s, loc_r, loc_w = [], [], []
    rem_h = []
    halo_sets: list[list[np.ndarray]] = []  # halo_sets[i][o]: unique senders i needs from o

    for i in range(n_shards):
        mine = owner_r == i
        s_i, r_i, w_i = senders[mine], receivers[mine] - i * shard_size, weights[mine]
        local = owner_s[mine] == i
        loc_s.append(s_i[local] - i * shard_size)
        loc_r.append(r_i[local])
        loc_w.append(w_i[local])

        rs, rr, rw = s_i[~local], r_i[~local], w_i[~local]
        ro = rs // shard_size
        halo_sets.append([np.unique(rs[ro == o]) for o in range(n_shards)])
        rem_h.append((rs, rr, rw, ro))

    halo_counts = np.asarray([[u.size for u in per_owner] for per_owner in halo_sets],
                             np.int64).reshape(n_shards, n_shards)
    halo = _pad_to(int(halo_counts.max(initial=0)), align)

    # send_idx[o][i]: local rows o ships to i (= halo_sets[i][o], o-local coords)
    send_idx = np.zeros((n_shards, n_shards, halo), np.int32)
    for i in range(n_shards):
        for o in range(n_shards):
            u = halo_sets[i][o]
            send_idx[o, i, : u.size] = u - o * shard_size

    # remote senders index the incoming halo table: slot o*halo + position
    e_rem = _pad_to(max((t[0].size for t in rem_h), default=1), align)
    rem_h_arr = np.zeros((n_shards, e_rem), np.int32)
    rem_r_arr = np.zeros((n_shards, e_rem), np.int32)
    rem_w_arr = np.zeros((n_shards, e_rem), weights.dtype)
    for i, (rs, rr, rw, ro) in enumerate(rem_h):
        pos = np.empty(rs.size, np.int64)
        for o in range(n_shards):
            m = ro == o
            pos[m] = o * halo + np.searchsorted(halo_sets[i][o], rs[m])
        rem_h_arr[i, : rs.size] = pos
        rem_r_arr[i, : rr.size] = rr
        rem_w_arr[i, : rw.size] = rw

    e_loc = _pad_to(max((a.size for a in loc_s), default=1), align)
    loc_s_arr = np.zeros((n_shards, e_loc), np.int32)
    loc_r_arr = np.zeros((n_shards, e_loc), np.int32)
    loc_w_arr = np.zeros((n_shards, e_loc), weights.dtype)
    for i in range(n_shards):
        loc_s_arr[i, : loc_s[i].size] = loc_s[i]
        loc_r_arr[i, : loc_r[i].size] = loc_r[i]
        loc_w_arr[i, : loc_w[i].size] = loc_w[i]

    loc_ell = rem_ell = None
    if build_ell:
        from pygcn_tpu_torch.ops.ell import build_ell_stacked

        def shard_mats(s_arr, r_arr, w_arr, n_cols):
            mats = []
            for i in range(n_shards):
                keep = w_arr[i] != 0
                mats.append(sp.csr_matrix(
                    (w_arr[i][keep], (r_arr[i][keep].astype(np.int64),
                                      s_arr[i][keep].astype(np.int64))),
                    shape=(shard_size, n_cols)))
            return mats

        lc, lv, lr, _ = build_ell_stacked(shard_mats(loc_s_arr, loc_r_arr, loc_w_arr,
                                                     shard_size))
        rc, rv, rr, _ = build_ell_stacked(shard_mats(rem_h_arr, rem_r_arr, rem_w_arr,
                                                     n_shards * halo))
        loc_ell = (lc, lv, lr)
        rem_ell = (rc, rv, rr)

    return DistPlan(
        loc_s=loc_s_arr, loc_r=loc_r_arr, loc_w=loc_w_arr,
        rem_h=rem_h_arr, rem_r=rem_r_arr, rem_w=rem_w_arr,
        send_idx=send_idx, loc_ell=loc_ell, rem_ell=rem_ell,
        n_shards=n_shards, shard_size=shard_size, halo=halo, n_nodes=graph.n_nodes,
        halo_counts=halo_counts,
    )


def locality_order(graph: Graph, method: str = "auto") -> np.ndarray:
    """Node ordering for locality; returns ``perm`` with ``perm[new_id] = old_id``.

    ``'louvain'`` orders nodes community by community (networkx, imported
    only here; chosen automatically below 1M edges); ``'lp'`` is the native
    weighted label propagation with a BFS inside each community (the scale
    path, chosen above 1M edges when graphkit loads); ``'bfs'`` keeps
    neighbourhoods contiguous and needs only SciPy.
    """
    with span("pipeline.locality_order"):
        return _locality_order(graph, method)


def _locality_order(graph: Graph, method: str) -> np.ndarray:
    from pygcn_tpu_torch.utils import native

    if method == "auto":
        if graph.n_edges < 1_000_000:
            method = "louvain"
        else:
            method = "lp" if native.available() else "bfs"
    if method == "louvain":
        import networkx as nx

        a = graph.to_scipy().tocsr()
        g_nx = nx.from_scipy_sparse_array(a)
        comms = nx.community.louvain_communities(g_nx, seed=0)
        comms = sorted(comms, key=len, reverse=True)
        return np.asarray([n for c in comms for n in sorted(c)], np.int64)
    if method == "lp":
        import scipy.sparse.csgraph as csgraph

        a = graph.to_scipy().tocsr()
        labels = native.label_propagation(a.indptr, a.indices, a.data)
        # communities largest first; within each, a BFS of the induced
        # subgraph, so that 128-node id ranges share neighbourhoods
        _, inv, counts = np.unique(labels, return_inverse=True, return_counts=True)
        order = []
        for comm in np.argsort(-counts, kind="stable"):
            nodes = np.nonzero(inv == comm)[0]
            if nodes.size <= 2:
                order.append(nodes)
                continue
            sub = a[nodes][:, nodes]
            seen = np.zeros(nodes.size, bool)
            sub_order = []
            deg = np.asarray((sub != 0).sum(axis=1)).ravel()
            while len(sub_order) < nodes.size:
                seeds = np.nonzero(~seen)[0]
                start = seeds[np.argmax(deg[seeds])]
                hit = csgraph.breadth_first_order(
                    sub, int(start), directed=False, return_predecessors=False
                )
                hit = hit[~seen[hit]]
                seen[hit] = True
                sub_order.extend(hit.tolist())
            order.append(nodes[np.asarray(sub_order)])
        return np.concatenate(order).astype(np.int64)
    if method != "bfs":
        raise ValueError(f"unknown locality_order method {method!r}")

    import scipy.sparse.csgraph as csgraph

    a = graph.to_scipy().tocsr()
    deg = np.asarray((a != 0).sum(axis=1)).ravel()
    visited = np.zeros(graph.n_nodes, bool)
    order = []
    while len(order) < graph.n_nodes:
        seeds = np.nonzero(~visited)[0]
        start = seeds[np.argmax(deg[seeds])]
        nodes = csgraph.breadth_first_order(a, int(start), directed=False,
                                            return_predecessors=False)
        nodes = nodes[~visited[nodes]]
        visited[nodes] = True
        order.extend(nodes.tolist())
    return np.asarray(order, np.int64)


def reorder_graph(graph: Graph, perm: np.ndarray) -> tuple:
    """Relabel nodes by ``perm`` (``perm[new_id] = old_id``).

    Returns ``(new_graph, inv)`` with ``inv[old_id] = new_id``. The new graph
    has the source graph's layout set and build hyperparameters, so the
    auto-policy does not build layouts the caller skipped.
    """
    inv = np.empty(graph.n_nodes, np.int64)
    inv[perm] = np.arange(graph.n_nodes)
    e = graph.n_edges
    senders = inv[graph.senders[:e].cpu().numpy()]
    receivers = inv[graph.receivers[:e].cpu().numpy()]
    weights = graph.weights[:e].cpu().numpy()
    new_graph = Graph.from_coo(
        senders, receivers, weights, n_nodes=graph.n_nodes,
        is_symmetric=graph.is_symmetric,
        build_dense=graph.dense is not None,
        build_bcsr=graph.bcsr is not None,
        build_ell=graph.ell is not None,
        build_hybrid=graph.hybrid is not None,
        build_panel=graph.panel is not None,
        build_colpanel=graph.colpanel is not None,
        **dict(graph.build_meta),
    )
    return new_graph, inv


def reorder_dataset(data, perm: np.ndarray):
    """Relabel a node-classification dataset by ``perm``: the graph through
    :func:`reorder_graph`, and features, labels and splits to match."""
    from pygcn_tpu_torch.graph.datasets import NodeClassificationData

    new_graph, inv = reorder_graph(data.graph, perm)
    return NodeClassificationData(
        graph=new_graph,
        features=np.asarray(data.features)[perm],
        labels=np.asarray(data.labels)[perm],
        idx_train=inv[np.asarray(data.idx_train)],
        idx_val=inv[np.asarray(data.idx_val)],
        idx_test=inv[np.asarray(data.idx_test)],
        n_classes=data.n_classes,
    )
