"""Bucketed-ELL SpMM — the gather path for edges off the dense tiles.

Rows are binned into power-of-two degree buckets; each bucket stores a dense
``[Nb, K]`` column/value block, padded at the end of each virtual row with
column 0 and value 0. Rows wider than the largest K are split into virtual
rows. The layout is built by the repo's native graphkit library when it
loads, else by NumPy, giving the same buckets either way.

:func:`ell_spmm_raw` picks the product by the device of ``x``: on the CPU
the plain version (per bucket a gather, a multiply, a length-K sum and one
``index_add_`` of ``Nb`` partial rows, which also merges split rows); on a
CUDA device kernel E1 (``ops/cuda/ell_spmm.py``), which sums each virtual
row in one pass.

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
from pygcn_tpu_torch.ops.cuda.ell_spmm import ell_spmm_cuda


@dataclasses.dataclass(frozen=True)
class ELL:
    """Per-bucket ``(cols [Nb, K], vals [Nb, K], rows [Nb], lens [Nb])``
    blocks: virtual row ``i`` holds its edges in slots ``0 .. lens[i] - 1``.

    ``cache`` holds what a kernel derives once from this layout (kernel E1's
    work items). It is not a constructor argument, so every new layout
    (:meth:`to`, :func:`build_ell`) starts empty.
    """

    cols: Tuple[torch.Tensor, ...]  # int32
    vals: Tuple[torch.Tensor, ...]  # float32
    rows: Tuple[torch.Tensor, ...]  # int32, the (real) row of each virtual row
    lens: Tuple[torch.Tensor, ...]  # int32, each virtual row's edges (its valid slots)
    ks: Tuple[int, ...]
    n_rows: int
    cache: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                    compare=False)

    def to(self, device) -> "ELL":
        return tree_to(self, device)


def build_ell(mat: sp.spmatrix, ks: Tuple[int, ...] = (4, 8, 16, 32, 64, 128, 256)) -> ELL:
    csr = mat.tocsr()
    n = csr.shape[0]
    indptr, indices, data = csr.indptr, csr.indices, csr.data.astype(np.float32)

    from pygcn_tpu_torch.utils import native

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
    # each bucket's virtual rows in order (the native builder's order too); a
    # bucket without any holds one row of padding
    sels = [np.nonzero(bucket == j)[0] for j in range(len(ks))]
    lens = tuple(torch.from_numpy(vlen[sel].astype(np.int32)) if sel.size
                 else torch.zeros(1, dtype=torch.int32) for sel in sels)

    built = native.build_ell_layout(indptr, indices, data, ks)
    if built is not None:
        cols, vals, rows = built
        return ELL(
            cols=tuple(torch.from_numpy(c) for c in cols),
            vals=tuple(torch.from_numpy(v) for v in vals),
            rows=tuple(torch.from_numpy(r) for r in rows),
            lens=lens,
            ks=tuple(ks),
            n_rows=n,
        )

    cols_out, vals_out, rows_out = [], [], []
    for sel, k in zip(sels, ks):
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

    return ELL(cols=tuple(cols_out), vals=tuple(vals_out), rows=tuple(rows_out), lens=lens,
               ks=tuple(ks), n_rows=n)


def ell_spmm_plain(ell: ELL, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` in plain PyTorch, bucket by bucket."""
    h = x.shape[1]
    out = torch.zeros((ell.n_rows, h), dtype=x.dtype, device=x.device)
    for cols, vals, rows in zip(ell.cols, ell.vals, ell.rows):
        nb, k = cols.shape
        g = x.index_select(0, cols.reshape(-1)).view(nb, k, h)
        out.index_add_(0, rows, (g * vals[..., None]).sum(dim=1))
    return out


def ell_spmm_raw(ell: ELL, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` for ``x`` of shape ``[n_cols, H]`` (no autograd of its own):
    the plain version for a CPU ``x``, kernel E1 for a CUDA one (f32 only:
    it raises on any other dtype)."""
    if x.device.type == "cpu":
        return ell_spmm_plain(ell, x)
    if x.device.type == "cuda":
        return ell_spmm_cuda(ell, x)
    raise ValueError(f"ell_spmm runs on cpu (plain) or cuda (kernel E1), not {x.device}")


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


def build_ell_stacked(mats, ks: Tuple[int, ...] = (4, 8, 16, 32, 64, 128, 256)):
    """Shard-uniform ELL layouts of equally shaped sparse matrices, one per
    shard of a distributed plan (``parallel/partition.py``), as host NumPy:
    per bucket ``cols``/``vals`` flat ``[P, Nb_max·K]`` and ``rows``
    ``[P, Nb_max]``, each shard's blocks zero-padded to the largest block
    count. Returns ``(cols, vals, rows, n_rows)``, the buckets as tuples."""
    built = [build_ell(m, ks) for m in mats]
    n_rows = built[0].n_rows
    cols_out, vals_out, rows_out = [], [], []
    for j, k in enumerate(ks):
        nb_max = max(e.rows[j].shape[0] for e in built)
        cols = np.zeros((len(mats), nb_max * k), np.int32)
        vals = np.zeros((len(mats), nb_max * k), np.float32)
        rows = np.zeros((len(mats), nb_max), np.int32)
        for p, e in enumerate(built):
            nb = e.rows[j].shape[0]
            cols[p, : nb * k] = e.cols[j].numpy().reshape(-1)
            vals[p, : nb * k] = e.vals[j].numpy().reshape(-1)
            rows[p, :nb] = e.rows[j].numpy()
        cols_out.append(cols)
        vals_out.append(vals)
        rows_out.append(rows)
    return tuple(cols_out), tuple(vals_out), tuple(rows_out), n_rows


def ell_apply_arrays(cols, vals, rows, n_rows: int, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` from one shard's flat per-bucket arrays (``cols``/``vals``
    ``[Nb·K]``, ``rows`` ``[Nb]``, as :func:`build_ell_stacked` stacks them):
    a gather, a sum over K and one ``index_add`` of the partial rows. Padding
    blocks carry value 0 and add nothing. Autograd differentiates it (the
    gather's gradient is a scatter into ``x``)."""
    partials, vrows = [], []
    for c, v, r in zip(cols, vals, rows):
        nb = r.shape[0]
        k = c.shape[0] // nb
        g = x.index_select(0, c).view(nb, k, x.shape[1])
        partials.append((g * v.view(nb, k, 1)).sum(dim=1))
        vrows.append(r)
    out = x.new_zeros((n_rows, x.shape[1]))
    return out.index_add(0, torch.cat(vrows), torch.cat(partials))
