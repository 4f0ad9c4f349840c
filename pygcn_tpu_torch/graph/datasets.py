"""Dataset loaders and builders for the node-classification paths.

Copied from ``pygcn_tpu/graph/datasets.py`` with the NumPy ``default_rng``
call order kept exactly, so the same files and seeds give the same arrays in
both packages:

- ``load_planetoid`` — the Cora/Citeseer/Pubmed text format (``.content`` +
  ``.cites``), with the reference's preprocessing; ``load_planetoid_structure``
  — the real ``.cites`` structure with synthetic features and labels;
- ``load_npz_dataset``/``save_npz_dataset`` — the single-file interchange
  format (``train_fullgraph --npz``);
- ``sbm_classification`` — the synthetic Planetoid stand-in of
  ``apps/train_cora``;
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


def load_planetoid(
    content_path: str,
    cites_path: str,
    *,
    adj_norm: str = "sym",
    splits: Optional[tuple] = None,
    **graph_kwargs,
) -> NodeClassificationData:
    """Load a Cora-format dataset (``<id> <feat…> <label>`` + ``<cited> <citing>``)."""
    raw = np.genfromtxt(content_path, dtype=str)
    ids = raw[:, 0]
    features = raw[:, 1:-1].astype(np.float32)
    label_names = raw[:, -1]
    classes = {c: i for i, c in enumerate(sorted(set(label_names)))}
    labels = np.array([classes[c] for c in label_names], np.int32)

    idx_map = {j: i for i, j in enumerate(ids)}
    edges_raw = np.genfromtxt(cites_path, dtype=str)
    edges = np.array(
        [[idx_map[a], idx_map[b]] for a, b in edges_raw if a in idx_map and b in idx_map],
        np.int64,
    )
    n = len(ids)
    adj = sp.coo_matrix(
        (np.ones(len(edges), np.float32), (edges[:, 0], edges[:, 1])), shape=(n, n)
    )

    if splits is None:
        splits = (range(140), range(200, 500), range(500, 1500))
    idx_train, idx_val, idx_test = (np.asarray(list(s)) for s in splits)
    return _finalize(
        adj, features, labels, idx_train, idx_val, idx_test,
        adj_norm=adj_norm, **graph_kwargs,
    )


def load_planetoid_structure(
    cites_path: str,
    *,
    n_classes: int = 7,
    feat_dim: int = 256,
    seed: int = 0,
    adj_norm: str = "sym",
    splits: Optional[tuple] = None,
    **graph_kwargs,
) -> NodeClassificationData:
    """Real citation-graph structure with synthetic features and labels, for
    a dataset whose ``.content`` file is missing (the reference ships
    ``cora.cites`` but not ``cora.content``).

    Parses the edge list (``native.parse_edge_list``: graphkit when built,
    NumPy otherwise), maps node ids in first-appearance order over the file,
    applies the reference preprocessing, and draws labels from the real
    structure (label-propagation communities folded into ``n_classes`` by
    size rank) with class-indicator noise features and seeded splits of the
    reference's sizes (140/300/1000). Accuracy on it is not comparable to
    real-Cora numbers.
    """
    from pygcn_tpu_torch.utils import native

    cited, citing = native.parse_edge_list(cites_path)

    interleaved = np.stack([cited, citing], 1).ravel()
    uniq, first = np.unique(interleaved, return_index=True)
    # rank each unique id by first appearance in the file
    first_order = np.argsort(np.argsort(first))
    src = first_order[np.searchsorted(uniq, cited)]
    dst = first_order[np.searchsorted(uniq, citing)]
    n = uniq.size
    adj = sp.coo_matrix((np.ones(src.size, np.float32), (src, dst)), shape=(n, n))

    sym = symmetrize_max(adj).tocsr()
    comm = native.label_propagation(sym.indptr, sym.indices, sym.data, max_iters=20)
    _, comm_ids, counts = np.unique(comm, return_inverse=True, return_counts=True)
    size_rank = np.argsort(np.argsort(-counts, kind="stable"), kind="stable")
    labels = (size_rank[comm_ids] % n_classes).astype(np.int32)

    rng = np.random.default_rng(seed)
    proto = rng.uniform(0.02, 0.08, (n_classes, feat_dim))
    slice_w = max(1, feat_dim // n_classes)
    for c in range(n_classes):
        proto[c, c * slice_w : (c + 1) * slice_w] = 0.35
    features = (rng.uniform(size=(n, feat_dim)) < proto[labels]).astype(np.float32)

    if splits is None:
        # the reference's sizes from a seeded permutation: the cites file
        # lists papers community by community
        perm = rng.permutation(n)
        splits = (perm[:140], perm[200:500], perm[500:1500])
    idx_train, idx_val, idx_test = (np.asarray(list(s)) for s in splits)
    return _finalize(
        adj, features, labels, idx_train, idx_val, idx_test,
        adj_norm=adj_norm, **graph_kwargs,
    )


def load_npz_dataset(
    path: str,
    *,
    adj_norm: str = "auto",
    normalize_features: Optional[bool] = None,
    **graph_kwargs,
) -> NodeClassificationData:
    """Load a node-classification dataset from one ``.npz`` file.

    Keys: ``edge_index`` [2, E] (row 0 the receiver, row 1 the sender of the
    aggregation operator A), ``features`` [N, F], ``labels`` [N]; optional
    ``edge_weight`` [E], ``idx_train``/``idx_val``/``idx_test`` (default:
    Planetoid-style splits scaled to N) and :func:`save_npz_dataset`'s
    markers ``normalized`` and ``is_symmetric``. ``adj_norm='auto'`` loads a
    file marked ``normalized`` as it is and normalizes others with ``'sym'``;
    ``normalize_features=None`` follows the same marker.
    """
    with np.load(path) as z:
        edge_index = np.asarray(z["edge_index"], np.int64)
        features = np.asarray(z["features"], np.float32)
        labels = np.asarray(z["labels"], np.int32)
        n = features.shape[0]
        weight = (
            np.asarray(z["edge_weight"], np.float32)
            if "edge_weight" in z
            else np.ones(edge_index.shape[1], np.float32)
        )
        pre_normalized = bool(z["normalized"]) if "normalized" in z else False
        is_symmetric = bool(z["is_symmetric"]) if "is_symmetric" in z else False
        if "idx_train" in z:
            idx_train = np.asarray(z["idx_train"], np.int64)
            idx_val = np.asarray(z["idx_val"], np.int64)
            idx_test = np.asarray(z["idx_test"], np.int64)
        else:
            n_train = min(140, n // 5)
            n_val = min(300, n // 5)
            n_test = min(1000, n - n_train - n_val)
            idx_train = np.arange(n_train)
            idx_val = np.arange(n_train, n_train + n_val)
            idx_test = np.arange(n - n_test, n)
    if adj_norm == "auto":
        adj_norm = "none" if pre_normalized else "sym"
    if normalize_features is None:
        normalize_features = not pre_normalized
    adj = sp.coo_matrix((weight, (edge_index[0], edge_index[1])), shape=(n, n))
    return _finalize(
        adj, features, labels, idx_train, idx_val, idx_test,
        adj_norm=adj_norm, normalize_features=normalize_features,
        is_symmetric=(True if (adj_norm == "none" and is_symmetric) else None),
        **graph_kwargs,
    )


def save_npz_dataset(path: str, data: NodeClassificationData) -> None:
    """Write :func:`load_npz_dataset`'s format: the already-normalized
    operator's COO edges (row 0 receivers), features, labels and splits, with
    the ``normalized`` and ``is_symmetric`` markers. Uncompressed, unlike the
    JAX package's file (both loaders read either): compressing an
    ogbn-products-sized dataset (63M edges, 2.45M x 128 features) took two
    minutes of host time on the card's machine."""
    coo = data.graph.to_scipy()
    csr = coo.tocsr()
    is_symmetric = (csr != csr.T).nnz == 0
    np.savez(
        path,
        edge_index=np.vstack([coo.row, coo.col]).astype(np.int64),
        edge_weight=coo.data.astype(np.float32),
        features=data.features,
        labels=data.labels,
        idx_train=data.idx_train,
        idx_val=data.idx_val,
        idx_test=data.idx_test,
        normalized=np.bool_(True),
        is_symmetric=np.bool_(is_symmetric),
    )


def sbm_classification(
    n: int = 600,
    n_classes: int = 4,
    feat_dim: int = 64,
    avg_degree: float = 8.0,
    homophily: float = 0.9,
    train_per_class: int = 20,
    n_val: int = 100,
    n_test: int = 200,
    seed: int = 0,
    *,
    adj_norm: str = "sym",
    feature_signal: float = 0.35,
    **graph_kwargs,
) -> NodeClassificationData:
    """Planetoid-shaped synthetic data: a stochastic-block-model graph whose
    edge homophily is exactly ``homophily``, with class-signal sparse binary
    features (rate ``feature_signal`` on each class's slice of dimensions,
    0.02-0.08 elsewhere)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n).astype(np.int32)

    e_target = int(n * avg_degree / 2)
    # each edge is same-class with probability h: same-class partners are
    # drawn within the source's class through the label-sorted node table
    by_label = np.argsort(labels, kind="stable")
    counts = np.bincount(labels, minlength=n_classes)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    n_cand = int(1.1 * e_target) + 16
    src = rng.integers(0, n, n_cand)
    is_same = rng.uniform(size=n_cand) < homophily
    c = labels[src]
    within = (offsets[c] + rng.integers(0, np.maximum(counts[c], 1))).astype(
        np.int64)
    dst = np.where(is_same, by_label[within], rng.integers(0, n, n_cand))
    keep = src != dst
    src, dst = src[keep][:e_target], dst[keep][:e_target]
    adj = sp.coo_matrix((np.ones(src.size, np.float32), (src, dst)), shape=(n, n))

    proto = rng.uniform(0.02, 0.08, (n_classes, feat_dim))
    slice_w = feat_dim // n_classes
    for c in range(n_classes):
        proto[c, c * slice_w : (c + 1) * slice_w] = feature_signal
    features = (rng.uniform(size=(n, feat_dim)) < proto[labels]).astype(np.float32)

    order = rng.permutation(n)
    idx_train = np.concatenate(
        [order[labels[order] == c][:train_per_class] for c in range(n_classes)]
    )
    rest = np.setdiff1d(order, idx_train, assume_unique=False)
    idx_val, idx_test = rest[:n_val], rest[n_val : n_val + n_test]
    return _finalize(
        adj, features, labels, idx_train, idx_val, idx_test,
        adj_norm=adj_norm, **graph_kwargs,
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
