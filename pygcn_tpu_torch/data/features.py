"""Node-feature assembly for the simulator, the evaluator and the generators.

The port of ``pygcn_tpu/data/features.py``, host-side NumPy/SciPy as in JAX:

- ``standardize``: StandardScaler-style columns, fit on all data
  (``pygcn/utils.py:280-287``);
- ``centrality_features``: degree, closeness, betweenness and mobility level
  (adjacency row sums), standardised (``pygcn/gnn-over-mlp.py:174-209``).
  Where JAX calls networkx, closeness here is
  ``scipy.sparse.csgraph.shortest_path`` over the unweighted graph and
  betweenness is Brandes' accumulation over the same BFS levels, batched
  over sources in NumPy, with networkx's pivot choice and rescaling;
- ``assemble_evaluator_features``: the four assembly modes over
  (demographics + embeddings) × with/without the original-feature copy,
  giving ``dim_touched`` (``pygcn/gnn-over-mlp.py:218-237``);
- ``generator_features``: the policy scripts' doubled feature block.
"""

from __future__ import annotations

import random
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import shortest_path

# sources of one batched BFS (rows of the [S, N] level arrays)
SOURCE_CHUNK = 256


def standardize(x: np.ndarray) -> np.ndarray:
    """Column-wise (x - mean)/std, std 0 → leave centered values (sklearn
    StandardScaler semantics)."""
    x = np.asarray(x, np.float64)
    mean = x.mean(axis=0, keepdims=True)
    std = x.std(axis=0, keepdims=True)
    std = np.where(std == 0, 1.0, std)
    return ((x - mean) / std).astype(np.float32)


def closeness(adj: sp.csr_matrix) -> np.ndarray:
    """networkx's ``closeness_centrality`` (Wasserman–Faust form) over the
    unweighted undirected graph of ``adj``'s nonzeros: for each node,
    ``(r - 1) / Σd · (r - 1) / (n - 1)`` over the ``r`` nodes it reaches
    (itself included) at hop distances ``d``; 0 where it reaches none."""
    n = adj.shape[0]
    out = np.zeros(n)
    for start in range(0, n, SOURCE_CHUNK):
        d = shortest_path(adj, directed=False, unweighted=True,
                          indices=np.arange(start, min(start + SOURCE_CHUNK, n)))
        reached = np.isfinite(d)
        r = reached.sum(axis=1).astype(np.float64)
        tot = np.where(reached, d, 0.0).sum(axis=1)
        ok = (tot > 0) & (n > 1)
        c = np.where(ok, (r - 1.0) / np.where(ok, tot, 1.0), 0.0)
        out[start:start + d.shape[0]] = np.where(ok, c * ((r - 1.0) / max(n - 1, 1)), 0.0)
    return out


def betweenness(adj: sp.csr_matrix, k: Optional[int] = None, seed: int = 0) -> np.ndarray:
    """networkx's ``betweenness_centrality(G, k, normalized=False, seed)``
    over the unweighted undirected graph of ``adj``'s nonzeros: Brandes'
    dependencies from every source, or from ``k`` pivots drawn as networkx
    draws them (``random.Random(seed).sample``), batched over sources level
    by level, then networkx's rescaling for undirected graphs without
    endpoints (its 3.6 rule: sampled pivots by ``(n-1) / (2(k-1))``, the
    other nodes by ``(n-1) / (2k)``)."""
    n = adj.shape[0]
    a = (adj != 0).astype(np.float64).tocsr()
    a.setdiag(0)
    a.eliminate_zeros()
    if k is not None and k == n:
        k = None
    sources = np.arange(n) if k is None else np.array(random.Random(seed).sample(range(n), k))
    bet = np.zeros(n)
    for start in range(0, len(sources), SOURCE_CHUNK):
        bet += _dependencies(a, sources[start:start + SOURCE_CHUNK])
    big_n = n - 1
    if big_n < 2:
        return bet
    if k is None:
        return bet * (big_n / (big_n * 2))
    scale = np.full(n, big_n / (k * 2))
    scale[sources] = big_n / ((k - 1) * 2) if k > 1 else np.nan
    return bet * scale


def _dependencies(a: sp.csr_matrix, sources: np.ndarray) -> np.ndarray:
    """Σ over ``sources`` of Brandes' dependency of each node (the source
    itself excluded): a BFS from every source at once counts shortest paths
    ``sigma`` level by level, then the levels are walked back,
    ``delta[v] = sigma[v] · Σ_w (1 + delta[w]) / sigma[w]`` over neighbours
    ``w`` one level further."""
    s, n = len(sources), a.shape[0]
    rows = np.arange(s)
    sigma = np.zeros((s, n))
    sigma[rows, sources] = 1.0
    seen = sigma > 0
    levels = [seen.copy()]
    frontier = sigma.copy()
    while True:
        paths = (a @ frontier.T).T  # a is symmetric
        new = ~seen & (paths > 0)
        if not new.any():
            break
        sigma[new] = paths[new]
        seen |= new
        levels.append(new)
        frontier = np.where(new, sigma, 0.0)
    delta = np.zeros((s, n))
    for d in range(len(levels) - 1, 0, -1):
        w = levels[d]
        coeff = np.where(w, (1.0 + delta) / np.where(w, sigma, 1.0), 0.0)
        back = (a @ coeff.T).T
        v = levels[d - 1]
        delta[v] = sigma[v] * back[v]
    delta[rows, sources] = 0.0
    return delta.sum(axis=0)


def centrality_features(
    adj: np.ndarray,
    normalize: bool = True,
    betweenness_samples: Optional[int] = None,
    max_neighbors: Optional[int] = None,
    seed: int = 0,
) -> np.ndarray:
    """[N, 4]: degree, closeness, betweenness, mobility level.

    Degree counts the nonzeros of each row (the diagonal included); the
    path centralities treat the graph as unweighted. Co-visitation graphs
    are dense, so above 1000 nodes the path centralities default to each
    node's ``max_neighbors`` = 20 strongest edges (the same
    ``np.argpartition`` call as JAX, so ties keep the same edges) with 64
    sampled betweenness pivots.
    """
    adj = np.asarray(adj)
    n = adj.shape[0]
    deg = np.count_nonzero(adj, axis=1).astype(np.float64)
    mob = adj.sum(axis=1).astype(np.float64)

    if n > 1000 and max_neighbors is None:
        max_neighbors = 20
    if betweenness_samples is None and n > 1000:
        betweenness_samples = 64
    if max_neighbors is not None and max_neighbors < n:
        # keep each node's strongest edges only for the path centralities
        sparse = np.zeros_like(adj)
        top = np.argpartition(-adj, max_neighbors, axis=1)[:, :max_neighbors]
        rows = np.arange(n)[:, None]
        sparse[rows, top] = adj[rows, top]
        path_adj = np.maximum(sparse, sparse.T)
    else:
        path_adj = adj
    graph = sp.csr_matrix(path_adj != 0, dtype=np.float64)

    clo = closeness(graph)
    k = betweenness_samples if betweenness_samples is not None and betweenness_samples < n \
        else None
    bet = betweenness(graph, k, seed)

    feats = [deg, clo, bet, mob]
    if normalize:
        feats = [standardize(f.reshape(-1, 1)).squeeze(1) for f in feats]
    return np.stack(feats, axis=1).astype(np.float32)


def assemble_evaluator_features(
    node_feats: np.ndarray,
    centrality: np.ndarray,
    with_pretrained_embed: bool,
    with_original_feat: bool,
) -> Tuple[np.ndarray, int]:
    """The evaluator's input ``[B, N, F]`` and ``dim_touched``.

    ``node_feats``: [B, N, 4 demo + E embed + 1 vac_flag] (the predictor
    layout, reference ``pygcn/utils.py:301-311``); ``centrality``: [N, 4].
    The four modes of ``pygcn/gnn-over-mlp.py:218-237``: with or without the
    pretrained embeddings, and optionally the non-flag block twice, so the
    GCN sees the first copy (``dim_touched``) and the MLP head also the raw
    one.
    """
    b = node_feats.shape[0]
    cent = np.broadcast_to(centrality[None], (b,) + centrality.shape)
    vac_flag = node_feats[:, :, -1:]
    base = node_feats[:, :, :-1] if with_pretrained_embed else node_feats[:, :, :4]

    block = np.concatenate([base, cent], axis=2)
    if with_original_feat:
        out = np.concatenate([block, block, vac_flag], axis=2)
        dim_touched = block.shape[2]
    else:
        out = np.concatenate([block, vac_flag], axis=2)
        dim_touched = out.shape[2] - 1
    return out.astype(np.float32), dim_touched


def generator_features(
    gen_node_feats: np.ndarray, centrality: np.ndarray, tile: int = 2
) -> Tuple[np.ndarray, int]:
    """Generator-mode features: [N, F] demographics+embeddings + centralities,
    tiled ×2 (the policy scripts duplicate the feature block, reference
    ``pygcn/policy-generator.py:294-343``); returns (feats, dim_touched)."""
    block = np.concatenate([gen_node_feats, centrality], axis=1)
    out = np.concatenate([block] * tile, axis=1)
    return out.astype(np.float32), block.shape[1]
