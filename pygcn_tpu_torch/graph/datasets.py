"""Dataset builders for the full-graph GCN path.

Synthetic generators at arbitrary scale, copied from
``pygcn_tpu/graph/datasets.py`` with the NumPy ``default_rng`` call order kept
exactly, so the same seed gives the same arrays in both packages:

- ``community_classification`` — the clustered, learnable arxiv-scale
  workload (``train_fullgraph --clustered``) over ``community_graph``.
- ``chung_lu_graph`` — power-law degree graphs for throughput runs.

Graphs come back as :class:`~pygcn_tpu_torch.graph.graph.Graph` on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp

from pygcn_tpu_torch.graph.graph import Graph
from pygcn_tpu_torch.graph.transform import (
    row_normalize,
    row_normalize_dense,
    sym_normalize,
    symmetrize_max,
)


@dataclasses.dataclass
class NodeClassificationData:
    graph: Graph
    features: np.ndarray  # [N, F] float32, normalized
    labels: np.ndarray  # [N] int32
    idx_train: np.ndarray
    idx_val: np.ndarray
    idx_test: np.ndarray
    n_classes: int


def _finalize(
    adj: sp.spmatrix,
    features: np.ndarray,
    labels: np.ndarray,
    idx_train,
    idx_val,
    idx_test,
    *,
    adj_norm: str = "sym",
    normalize_features: bool = True,
    is_symmetric: Optional[bool] = None,
    **graph_kwargs,
) -> NodeClassificationData:
    if adj_norm == "sym":
        a = sym_normalize(symmetrize_max(adj))
    elif adj_norm == "row":
        adj = symmetrize_max(adj)
        a = row_normalize(adj + sp.eye(adj.shape[0], dtype=adj.dtype))
    elif adj_norm == "none":  # adjacency already normalized (e.g. npz dumps)
        a = adj.tocoo()
    else:
        raise ValueError(f"unknown adj_norm {adj_norm!r}")
    # "none" may carry an asymmetric matrix → build transpose layouts unless
    # the caller vouches for symmetry (e.g. the npz dump's marker)
    if is_symmetric is None:
        is_symmetric = adj_norm == "sym"
    graph = Graph.from_scipy(a, is_symmetric=is_symmetric, **graph_kwargs)
    if normalize_features:
        features = row_normalize_dense(features)
    return NodeClassificationData(
        graph=graph,
        features=features.astype(np.float32),
        labels=labels.astype(np.int32),
        idx_train=np.asarray(idx_train, np.int32),
        idx_val=np.asarray(idx_val, np.int32),
        idx_test=np.asarray(idx_test, np.int32),
        n_classes=int(labels.max()) + 1,
    )


def community_graph(
    n: int,
    avg_degree: float,
    *,
    community_size: int = 256,
    p_in: float = 0.7,
    power: float = 2.2,
    seed: int = 0,
    shuffle: bool = True,
    return_communities: bool = False,
):
    """Degree-corrected planted-partition graph (arxiv/products-like).

    Real-world graphs cluster: a fraction ``p_in`` of edges falls inside
    communities of ~``community_size`` nodes, the rest follows a power-law
    (Chung-Lu) background — the regime where the hybrid BCSR+ELL layout pays
    (PERF_NOTES.md). ``shuffle=True`` randomly relabels nodes so benchmarks
    must recover the structure via ``locality_order`` the way a real
    arbitrarily-labeled dataset would.
    """
    rng = np.random.default_rng(seed)
    e = int(n * avg_degree)
    e_in = int(e * p_in)
    n_comm = max(1, n // community_size)
    # community sizes ~ uniform around community_size (node i -> comm i//size)
    comm_of = np.minimum(np.arange(n) // community_size, n_comm - 1)
    comm_start = np.searchsorted(comm_of, np.arange(n_comm))
    comm_end = np.append(comm_start[1:], n)

    # within-community edges: community picked proportional to its size
    sizes = comm_end - comm_start
    c = rng.choice(n_comm, e_in, p=sizes / sizes.sum())
    src_in = comm_start[c] + (rng.uniform(size=e_in) * sizes[c]).astype(np.int64)
    dst_in = comm_start[c] + (rng.uniform(size=e_in) * sizes[c]).astype(np.int64)

    # background: Chung-Lu power-law endpoints
    w = (1.0 - rng.uniform(size=n)) ** (-1.0 / (power - 1.0))
    p = w / w.sum()
    e_bg = e - e_in
    src_bg = rng.choice(n, e_bg, p=p)
    dst_bg = rng.choice(n, e_bg, p=p)

    src = np.concatenate([src_in, src_bg])
    dst = np.concatenate([dst_in, dst_bg])
    mask = src != dst
    src, dst = src[mask], dst[mask]
    comm_out = comm_of
    if shuffle:
        relabel = rng.permutation(n)
        src, dst = relabel[src], relabel[dst]
        comm_out = np.empty(n, np.int64)
        comm_out[relabel] = comm_of
    m = sp.coo_matrix((np.ones(src.size, np.float32), (src, dst)), shape=(n, n))
    m.sum_duplicates()
    m = m.tocoo()
    if return_communities:
        return m, comm_out
    return m


def community_classification(
    n: int = 169_343,
    avg_degree: float = 13.3,
    n_classes: int = 40,
    feat_dim: int = 128,
    *,
    community_size: int = 256,
    p_in: float = 0.7,
    label_noise: float = 0.05,
    feat_noise: float = 3.0,
    train_frac: float = 0.05,
    n_val: int = 5000,
    n_test: int = 20000,
    seed: int = 0,
    adj_norm: str = "sym",
    **graph_kwargs,
) -> NodeClassificationData:
    """Arxiv-scale LEARNABLE classification over the clustered benchmark
    graph: each ~``community_size``-node community draws one class, a
    ``label_noise`` fraction of nodes flip to a random class, and features
    are a class prototype drowned in ``feat_noise``-σ Gaussian noise — so a
    per-node MLP is weak (SNR << 1) while neighborhood aggregation over
    mostly-same-class communities recovers the signal. Node ids arrive
    SHUFFLED (real-dataset regime): locality ordering + the hybrid layout
    are part of the honest pipeline, as in ``bench.py``. This is the
    convergence workload for the full-graph flagship (the reference's
    semi-supervised setting at BASELINE's arxiv scale; cora analog at
    reference ``pygcn/utils.py:343-383``)."""
    rng = np.random.default_rng(seed)
    adj, comm = community_graph(
        n, avg_degree, community_size=community_size, p_in=p_in,
        seed=seed, shuffle=True, return_communities=True,
    )
    n_comm = int(comm.max()) + 1
    class_of_comm = rng.integers(0, n_classes, n_comm)
    labels = class_of_comm[comm].astype(np.int32)
    flip = rng.uniform(size=n) < label_noise
    labels[flip] = rng.integers(0, n_classes, int(flip.sum()))

    proto = rng.normal(size=(n_classes, feat_dim)).astype(np.float32)
    proto /= np.linalg.norm(proto, axis=1, keepdims=True)
    features = proto[labels] + feat_noise * rng.normal(
        size=(n, feat_dim)).astype(np.float32)

    order = rng.permutation(n)
    n_train = max(n_classes, int(n * train_frac))
    n_val = min(n_val, max(1, (n - n_train) // 3))
    n_test = min(n_test, n - n_train - n_val)
    idx_train = order[:n_train]
    idx_val = order[n_train : n_train + n_val]
    idx_test = order[n_train + n_val : n_train + n_val + n_test]
    return _finalize(
        adj, features, labels, idx_train, idx_val, idx_test,
        adj_norm=adj_norm, normalize_features=False, **graph_kwargs,
    )


def chung_lu_graph(
    n: int,
    avg_degree: float,
    *,
    power: float = 2.2,
    seed: int = 0,
    weighted: bool = False,
) -> sp.coo_matrix:
    """Power-law random graph (Chung-Lu): endpoint prob ∝ w_i, w ~ Pareto."""
    rng = np.random.default_rng(seed)
    w = (1.0 - rng.uniform(size=n)) ** (-1.0 / (power - 1.0))
    p = w / w.sum()
    e = int(n * avg_degree)
    src = rng.choice(n, e, p=p)
    dst = rng.choice(n, e, p=p)
    mask = src != dst
    src, dst = src[mask], dst[mask]
    vals = rng.uniform(0.5, 1.5, src.size).astype(np.float32) if weighted else np.ones(src.size, np.float32)
    m = sp.coo_matrix((vals, (src, dst)), shape=(n, n))
    m.sum_duplicates()
    return m.tocoo()
