"""The ``powerlaw`` traffic: a Chung-Lu power-law graph with no communities.

``graph`` is a frozen copy of the port's ``graph/datasets.py``
``chung_lu_graph`` (the NumPy ``default_rng`` call order kept), drawn from
the mix's ``graph_seed``. ``node_data`` draws N(0, 1) features, uniform
labels and the training mask on the run's device from ``--seed``.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from benchmark.generators import NodeData, train_mask


def graph(mix: dict):
    """``(adjacency, None)``: the raw directed adjacency as a SciPy COO
    matrix, duplicates summed, no self loops."""
    n, avg_degree, power = mix["n_nodes"], mix["avg_degree"], mix["power"]
    rng = np.random.default_rng(mix["graph_seed"])
    w = (1.0 - rng.uniform(size=n)) ** (-1.0 / (power - 1.0))
    p = w / w.sum()
    e = int(n * avg_degree)
    src = rng.choice(n, e, p=p)
    dst = rng.choice(n, e, p=p)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    vals = (rng.uniform(0.5, 1.5, src.size).astype(np.float32) if mix["weighted"]
            else np.ones(src.size, np.float32))
    m = sp.coo_matrix((vals, (src, dst)), shape=(n, n))
    m.sum_duplicates()
    return m.tocoo(), None


def node_data(mix: dict, aux, n_features: int, n_classes: int, seed: int,
              device) -> NodeData:
    """Features, labels and the training mask on ``device``, from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n = mix["n_nodes"]
    x = torch.randn(n, n_features, generator=gen, device=device)
    labels = torch.randint(0, n_classes, (n,), generator=gen, device=device)
    return NodeData(x, labels, train_mask(mix, n, n_classes, gen, device))
