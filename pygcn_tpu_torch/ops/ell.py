"""Bucketed-ELL SpMM — the gather path for edges off the dense tiles.

Rows are binned into power-of-two degree buckets; each bucket stores a dense
``[Nb, K]`` column/value block, so aggregation is a gather, a multiply, a
length-K sum and one ``index_add_`` of ``Nb`` partial rows (not one per edge).
Rows wider than the largest K are split into virtual rows that the
``index_add_`` merges. The layout is built by the repo's native graphkit
library when it loads, else by NumPy, giving the same buckets either way.

Backward uses the prebuilt transpose layout (symmetric graphs reuse the
forward one) through :class:`torch.autograd.Function`, so autograd never
differentiates the gather itself.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import scipy.sparse as sp
import torch

from pygcn_tpu_torch.graph.graph import tree_to


@dataclasses.dataclass(frozen=True)
class ELL:
    """Per-bucket ``(cols [Nb, K], vals [Nb, K], rows [Nb])`` blocks."""

    cols: Tuple[torch.Tensor, ...]  # int32
    vals: Tuple[torch.Tensor, ...]  # float32
    rows: Tuple[torch.Tensor, ...]  # int32, the (real) row of each virtual row
    ks: Tuple[int, ...]
    n_rows: int

    def to(self, device) -> "ELL":
        return tree_to(self, device)


def build_ell(mat: sp.spmatrix, ks: Tuple[int, ...] = (4, 8, 16, 32, 64, 128, 256)) -> ELL:
    csr = mat.tocsr()
    n = csr.shape[0]
    indptr, indices, data = csr.indptr, csr.indices, csr.data.astype(np.float32)

    from pygcn_tpu_torch.utils import native

    built = native.build_ell_layout(indptr, indices, data, ks)
    if built is not None:
        cols, vals, rows = built
        return ELL(
            cols=tuple(torch.from_numpy(c) for c in cols),
            vals=tuple(torch.from_numpy(v) for v in vals),
            rows=tuple(torch.from_numpy(r) for r in rows),
            ks=tuple(ks),
            n_rows=n,
        )
    deg = np.diff(indptr).astype(np.int64)
    kmax = ks[-1]

    # virtual rows: rows wider than kmax split into ceil(deg/kmax) chunks
    n_chunks = np.maximum(1, -(-deg // kmax))
    vrow_row = np.repeat(np.arange(n, dtype=np.int64), n_chunks)
    first = np.concatenate([[0], np.cumsum(n_chunks)[:-1]])
    chunk_ofs = np.arange(vrow_row.size) - np.repeat(first, n_chunks)
    vstart = indptr[vrow_row] + chunk_ofs * kmax
    vlen = np.minimum(deg[vrow_row] - chunk_ofs * kmax, kmax)
    bucket = np.searchsorted(ks, np.maximum(vlen, 1))

    cols_out, vals_out, rows_out = [], [], []
    for j, k in enumerate(ks):
        sel = np.nonzero(bucket == j)[0]
        if sel.size == 0:
            cols_out.append(torch.zeros((1, k), dtype=torch.int32))
            vals_out.append(torch.zeros((1, k), dtype=torch.float32))
            rows_out.append(torch.zeros(1, dtype=torch.int32))
            continue
        offs = np.arange(k)
        idx = vstart[sel][:, None] + offs
        valid = offs < vlen[sel][:, None]
        idx = np.minimum(idx, max(len(indices) - 1, 0))
        cols = np.where(valid, indices[idx] if len(indices) else 0, 0)
        vals = np.where(valid, data[idx] if len(data) else 0.0, 0.0)
        cols_out.append(torch.from_numpy(cols.astype(np.int32)))
        vals_out.append(torch.from_numpy(vals.astype(np.float32)))
        rows_out.append(torch.from_numpy(vrow_row[sel].astype(np.int32)))

    return ELL(cols=tuple(cols_out), vals=tuple(vals_out), rows=tuple(rows_out),
               ks=tuple(ks), n_rows=n)


def ell_spmm_raw(ell: ELL, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` for ``x`` of shape ``[n_cols, H]`` (no autograd of its own)."""
    h = x.shape[1]
    out = torch.zeros((ell.n_rows, h), dtype=x.dtype, device=x.device)
    for cols, vals, rows in zip(ell.cols, ell.vals, ell.rows):
        nb, k = cols.shape
        g = x.index_select(0, cols.reshape(-1)).view(nb, k, h)
        out.index_add_(0, rows, (g * vals[..., None]).sum(dim=1))
    return out


class ELLSpMM(torch.autograd.Function):
    """``A @ x`` with backward ``A^T @ g`` running the transpose layout."""

    @staticmethod
    def forward(ctx, x, ell, ell_t):
        ctx.ell_t = ell_t
        return ell_spmm_raw(ell, x)

    @staticmethod
    def backward(ctx, g):
        return ell_spmm_raw(ctx.ell_t, g), None, None


def ell_spmm_pair(ell: ELL, ell_t: ELL, x: torch.Tensor) -> torch.Tensor:
    return ELLSpMM.apply(x, ell, ell_t)
