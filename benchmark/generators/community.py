"""The ``clustered`` traffic: a degree-corrected planted-partition graph with
community classes.

``graph`` is a frozen copy of the port's ``graph/datasets.py``
``community_graph`` (the NumPy ``default_rng`` call order kept), so a mix's
``graph_seed`` gives the graph the port's ``train_fullgraph --clustered``
builds at that seed. ``node_data`` follows ``community_classification``:
each community draws one class, a ``label_noise`` share of the nodes flips
to a random class, and the features are a class prototype under
``feat_noise`` Gaussian noise; here they are drawn on the run's device from
``--seed`` instead, so the structure (and with it the work) stays fixed while
the values change with the seed.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from benchmark.generators import NodeData, train_mask


def graph(mix: dict):
    """``(adjacency, communities)``: the raw directed adjacency as a SciPy
    COO matrix in the generator's (shuffled) ids, duplicates summed, no self
    loops; ``communities[i]`` is node i's community."""
    n, avg_degree = mix["n_nodes"], mix["avg_degree"]
    community_size, p_in, power = mix["community_size"], mix["p_in"], mix["power"]
    rng = np.random.default_rng(mix["graph_seed"])
    e = int(n * avg_degree)
    e_in = int(e * p_in)
    n_comm = max(1, n // community_size)
    comm_of = np.minimum(np.arange(n) // community_size, n_comm - 1)
    comm_start = np.searchsorted(comm_of, np.arange(n_comm))
    comm_end = np.append(comm_start[1:], n)

    sizes = comm_end - comm_start
    c = rng.choice(n_comm, e_in, p=sizes / sizes.sum())
    src_in = comm_start[c] + (rng.uniform(size=e_in) * sizes[c]).astype(np.int64)
    dst_in = comm_start[c] + (rng.uniform(size=e_in) * sizes[c]).astype(np.int64)

    w = (1.0 - rng.uniform(size=n)) ** (-1.0 / (power - 1.0))
    p = w / w.sum()
    e_bg = e - e_in
    src_bg = rng.choice(n, e_bg, p=p)
    dst_bg = rng.choice(n, e_bg, p=p)

    src = np.concatenate([src_in, src_bg])
    dst = np.concatenate([dst_in, dst_bg])
    keep = src != dst
    src, dst = src[keep], dst[keep]
    comm_out = comm_of
    if mix["shuffle"]:
        relabel = rng.permutation(n)
        src, dst = relabel[src], relabel[dst]
        comm_out = np.empty(n, np.int64)
        comm_out[relabel] = comm_of
    m = sp.coo_matrix((np.ones(src.size, np.float32), (src, dst)), shape=(n, n))
    m.sum_duplicates()
    return m.tocoo(), comm_out


def node_data(mix: dict, communities, n_features: int, n_classes: int, seed: int,
              device) -> NodeData:
    """Features, labels and the training mask on ``device``, from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n = int(communities.shape[0])
    comm = torch.as_tensor(communities, device=device)
    n_comm = int(communities.max()) + 1
    class_of_comm = torch.randint(0, n_classes, (n_comm,), generator=gen, device=device)
    labels = class_of_comm[comm]
    flip = torch.rand(n, generator=gen, device=device) < mix["label_noise"]
    noise_labels = torch.randint(0, n_classes, (n,), generator=gen, device=device)
    labels = torch.where(flip, noise_labels, labels)
    proto = torch.randn(n_classes, n_features, generator=gen, device=device)
    proto /= torch.linalg.vector_norm(proto, dim=1, keepdim=True)
    x = torch.randn(n, n_features, generator=gen, device=device)
    x = proto[labels] + mix["feat_noise"] * x
    return NodeData(x, labels, train_mask(mix, n, n_classes, gen, device))
