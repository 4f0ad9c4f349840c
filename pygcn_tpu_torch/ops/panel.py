"""Diagonal-panel ELL — per-panel blocks for community-local edges.

The port of ``pygcn_tpu/ops/panel.py``. The node range is cut into
contiguous panels; each panel stores the diagonal block
``A[s:s+w, s:s+w]`` as a bucketed ELL (``ops/ell.py``) with panel-local ids,
and one global ELL holds every off-diagonal edge. On a locality-ordered graph
most edges lie near the diagonal, so most gathers read a panel's slice of
``x``. ``panel_spmm_raw`` adds each panel's product into its rows of the
residual product. As in ``ops/colpanel.py``, a bucket that repeats a row
(one wider than the widest bucket) sums its virtual rows by
``segment_reduce`` before its one add per row, so the product repeats its
bits on the card. Backward uses the transpose layout (symmetric graphs reuse
the forward one: each diagonal block of a symmetric matrix is symmetric).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import scipy.sparse as sp
import torch

from pygcn_tpu_torch.graph.graph import tree_to
from pygcn_tpu_torch.ops.colpanel import bucket_partial, merge_add, merge_of
from pygcn_tpu_torch.ops.ell import ELL, build_ell


@dataclasses.dataclass(frozen=True)
class PanelELL:
    panels: Tuple[ELL, ...]
    starts: Tuple[int, ...]
    residual: ELL  # off-diagonal edges, global coordinates
    n_rows: int
    diag_edges: int  # edges routed through panels (diagnostics)
    # per ELL (the panels', then the residual's), per bucket: None, or the
    # (lengths, urows) of a bucket that repeats rows (ops/colpanel.merge_of)
    merges: Tuple[tuple, ...]

    def to(self, device) -> "PanelELL":
        return tree_to(self, device)


def build_panel_ell(mat: sp.spmatrix, panel_width: int = 65536,
                    ks: Tuple[int, ...] = (4, 8, 16, 32, 64, 128, 256)) -> PanelELL:
    coo = mat.tocoo()
    n = coo.shape[0]
    pr = coo.row // panel_width
    pc = coo.col // panel_width
    diag = pr == pc
    n_panels = max(1, -(-n // panel_width))

    rows_d, cols_d, data_d = coo.row[diag], coo.col[diag], coo.data[diag]
    order = np.argsort(pr[diag], kind="stable")
    rows_d, cols_d, data_d = rows_d[order], cols_d[order], data_d[order]
    bounds = np.searchsorted(pr[diag][order], np.arange(n_panels + 1))
    panels, starts = [], []
    for p in range(n_panels):
        s = p * panel_width
        w = min(panel_width, n - s)
        lo, hi = bounds[p], bounds[p + 1]
        sub = sp.csr_matrix((data_d[lo:hi], (rows_d[lo:hi] - s, cols_d[lo:hi] - s)),
                            shape=(w, w))
        panels.append(build_ell(sub, ks))
        starts.append(s)

    rest = sp.csr_matrix((coo.data[~diag], (coo.row[~diag], coo.col[~diag])), shape=(n, n))
    residual = build_ell(rest, ks)
    merges = tuple(tuple(merge_of(r.numpy()) for r in e.rows) for e in panels + [residual])
    return PanelELL(panels=tuple(panels), starts=tuple(starts), residual=residual,
                    n_rows=n, diag_edges=int(diag.sum()), merges=merges)


def _ell_product(ell: ELL, merges, x: torch.Tensor) -> torch.Tensor:
    out = torch.zeros((ell.n_rows, x.shape[1]), dtype=x.dtype, device=x.device)
    for cols, vals, rows, merge in zip(ell.cols, ell.vals, ell.rows, merges):
        merge_add(out, rows, merge, bucket_partial(x, cols, vals))
    return out


def panel_spmm_raw(pe: PanelELL, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` (no autograd of its own)."""
    out = _ell_product(pe.residual, pe.merges[-1], x)
    for ell_p, merges, s in zip(pe.panels, pe.merges, pe.starts):
        w = ell_p.n_rows
        out[s:s + w] += _ell_product(ell_p, merges, x[s:s + w])
    return out


class PanelSpMM(torch.autograd.Function):
    """``A @ x`` with backward ``A^T @ g`` on the transpose layout."""

    @staticmethod
    def forward(ctx, x, pe, pe_t):
        ctx.pe_t = pe_t
        return panel_spmm_raw(pe, x)

    @staticmethod
    def backward(ctx, g):
        return panel_spmm_raw(ctx.pe_t, g.contiguous()), None, None


def panel_spmm_pair(pe: PanelELL, pe_t: PanelELL, x: torch.Tensor) -> torch.Tensor:
    return PanelSpMM.apply(x, pe, pe_t)
