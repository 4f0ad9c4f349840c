"""Host-side graph normalizations (SciPy; preprocessing, not the compute path).

These are pure functions over ``scipy.sparse`` matrices, mirroring the math the
reference applies to its adjacencies:

- ``symmetrize_max``: ``A + A^T∘(A^T>A) − A∘(A^T>A)`` — elementwise max of A and
  A^T for non-negative weights (reference ``pygcn/utils.py:365``).
- ``row_normalize``: ``D⁻¹ M`` with ``inf → 0`` (reference ``pygcn/utils.py:390-397``).
- ``sym_normalize``: ``D^{-1/2} (A + I) D^{-1/2}`` — the Kipf GCN propagation
  matrix (the upstream convention the reference's Cora path used).
- ``add_self_loops``: ``A + c·I``.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def symmetrize_max(adj: sp.spmatrix) -> sp.csr_matrix:
    """Elementwise max(A, A^T) via the reference's masked-sum identity."""
    adj = adj.tocsr()
    adj_t = adj.T.tocsr()
    mask = (adj_t > adj).astype(adj.dtype)
    return (adj + adj_t.multiply(mask) - adj.multiply(mask)).tocsr()


def add_self_loops(adj: sp.spmatrix, weight: float = 1.0) -> sp.csr_matrix:
    return (adj.tocsr() + weight * sp.eye(adj.shape[0], dtype=adj.dtype, format="csr")).tocsr()


def row_normalize(mat: sp.spmatrix) -> sp.csr_matrix:
    """D⁻¹ M row scaling; rows with zero sum stay zero."""
    mat = mat.tocsr()
    rowsum = np.asarray(mat.sum(axis=1)).ravel()
    with np.errstate(divide="ignore"):
        inv = np.power(rowsum, -1.0)
    inv[np.isinf(inv)] = 0.0
    return sp.diags(inv).dot(mat).tocsr()


def row_normalize_dense(mat: np.ndarray) -> np.ndarray:
    """Dense variant of :func:`row_normalize` for feature matrices."""
    rowsum = mat.sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore"):
        inv = np.where(rowsum == 0, 0.0, 1.0 / rowsum)
    return mat * inv


def sym_normalize(adj: sp.spmatrix, add_loops: bool = True) -> sp.csr_matrix:
    """Kipf propagation matrix ``D^{-1/2} (A + I) D^{-1/2}``."""
    a = add_self_loops(adj) if add_loops else adj.tocsr()
    deg = np.asarray(a.sum(axis=1)).ravel()
    with np.errstate(divide="ignore"):
        d_inv_sqrt = np.power(deg, -0.5)
    d_inv_sqrt[np.isinf(d_inv_sqrt)] = 0.0
    d = sp.diags(d_inv_sqrt)
    return (d @ a @ d).tocsr()
