"""Co-visitation CBG-CBG adjacency construction (NumPy).

The port's own copy of ``pygcn_tpu/graph/covisit.py``. The reference builds
``adj[i,j] = Σ_p avg[p,i]·avg[p,j]`` with an O(N²·P) Python double loop over
the hour-averaged POI×CBG visit matrix (``pygcn/utils.py:124-129``). That is
exactly ``A = VᵀV`` — here it is a single (optionally sparse) matmul, with the
same ``.npy`` caching protocol.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import scipy.sparse as sp


def average_visits(poi_cbg_visits: Sequence) -> np.ndarray:
    """Mean over hourly POI×CBG matrices (dense or scipy sparse)."""
    total = None
    for m in poi_cbg_visits:
        arr = m.toarray() if sp.issparse(m) else np.asarray(m)
        total = arr.copy() if total is None else total + arr
    return total / len(poi_cbg_visits)


def covisitation_adj(avg_visits: np.ndarray) -> np.ndarray:
    """``A = VᵀV``: weighted dense co-visitation adjacency with implicit
    self-loops (diagonal = Σ_p v²)."""
    v = np.asarray(avg_visits, np.float64)
    return (v.T @ v).astype(np.float32)


def load_or_build_adj(
    msa_name: str,
    output_root: str,
    poi_cbg_visits: Optional[Sequence] = None,
) -> np.ndarray:
    """Cached adjacency protocol (reference ``load_adj``,
    ``pygcn/utils.py:93-132``): reuse ``adj_<msa>.npy`` / ``avg_array_<msa>.npy``
    when present, else build and cache both."""
    adj_path = os.path.join(output_root, f"adj_{msa_name}.npy")
    if os.path.exists(adj_path):
        return np.load(adj_path)

    avg_path = os.path.join(output_root, f"avg_array_{msa_name}.npy")
    if os.path.exists(avg_path):
        avg = np.load(avg_path)
    else:
        if poi_cbg_visits is None:
            raise FileNotFoundError(
                f"no cached adjacency at {adj_path} and no visit matrices given"
            )
        avg = average_visits(poi_cbg_visits)
        os.makedirs(output_root, exist_ok=True)
        np.save(avg_path, avg)

    adj = covisitation_adj(avg)
    np.save(adj_path, adj)
    return adj
