"""Node orderings for locality, and relabelling a graph or dataset by one.

Host-side NumPy/SciPy, copied from ``pygcn_tpu/parallel/partition.py``
(``locality_order``, ``reorder_graph``, ``reorder_dataset``). Ordering a graph
community by community is what fills the hybrid layout's 128×128 tiles
(``ops/hybrid.py``): a shuffled real-world graph has almost none.
"""

from __future__ import annotations

import numpy as np

from pygcn_tpu_torch.graph.graph import Graph


def locality_order(graph: Graph, method: str = "auto") -> np.ndarray:
    """Node ordering for locality; returns ``perm`` with ``perm[new_id] = old_id``.

    ``'louvain'`` orders nodes community by community (networkx, imported
    only here; chosen automatically below 1M edges); ``'lp'`` is the native
    weighted label propagation with a BFS inside each community (the scale
    path, chosen above 1M edges when graphkit loads); ``'bfs'`` keeps
    neighbourhoods contiguous and needs only SciPy.
    """
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
