"""Hybrid BCSR + ELL SpMM — dense tiles on kernel B1, the rest on the ELL gather.

``build_hybrid`` routes every ``tm×tk`` tile holding at least
``min_edges_per_tile`` edges to a BCSR layout and the remaining edges to a
bucketed ELL; ``hybrid_spmm_raw`` adds the two partial products. On graphs
with community structure (after locality ordering) most edges fall on such
tiles. Symmetric graphs reuse the forward layout in the backward; asymmetric
graphs prebuild the transpose.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from pygcn_tpu_torch.graph.graph import BCSR, _build_bcsr, tree_to
from pygcn_tpu_torch.ops.cuda.bcsr_spmm import bcsr_spmm
from pygcn_tpu_torch.ops.ell import ELL, build_ell, ell_spmm_raw


@dataclasses.dataclass(frozen=True)
class HybridLayout:
    bcsr: Optional[BCSR]  # None when no tile is dense enough
    ell: ELL  # residual edges (all edges if bcsr is None)
    n_rows: int
    tile_edges: int  # edges routed to BCSR (diagnostics)

    def to(self, device) -> "HybridLayout":
        return tree_to(self, device)


def build_hybrid(
    mat: sp.spmatrix,
    tile: Tuple[int, int] = (128, 128),
    min_edges_per_tile: int = 128,
    ks: Tuple[int, ...] = (4, 8, 16, 32, 64, 128, 256),
    tile_budget_bytes: Optional[int] = None,
    residual: str = "ell",
    tile_dtype=None,
) -> HybridLayout:
    """Route tiles with ≥ ``min_edges_per_tile`` edges to BCSR, the rest to ELL.

    ``tile_budget_bytes`` caps the tile memory (``tm*tk`` f32 values a tile):
    when the qualifying tiles exceed it, the densest are kept and the rest
    spill to the ELL side. ``tile_dtype`` (``"bfloat16"`` or a torch dtype) stores the
    tiles in that type; kernel B1 then rounds x to it and sums in f32.
    """
    if residual == "colpanel":
        raise NotImplementedError("column-panel residual not ported yet")
    if residual != "ell":
        raise ValueError(f"unknown residual layout {residual!r}")
    coo = mat.tocoo()
    n = coo.shape[0]
    tm, tk = tile
    n_block_cols = -(-coo.shape[1] // tk)

    tile_ids = (coo.row // tm).astype(np.int64) * n_block_cols + coo.col // tk
    uniq, inverse, counts = np.unique(tile_ids, return_inverse=True, return_counts=True)
    qualifies = counts >= min_edges_per_tile
    if tile_budget_bytes is not None:
        max_tiles = max(0, tile_budget_bytes // (tm * tk * 4))
        if int(qualifies.sum()) > max_tiles:
            order = np.argsort(-counts)  # densest first
            keep = np.zeros_like(qualifies)
            keep[order[qualifies[order]][:max_tiles]] = True
            qualifies = keep
    dense_tile = qualifies[inverse]

    tile_edges = int(dense_tile.sum())
    bcsr = None
    if tile_edges:
        dense_part = sp.coo_matrix(
            (coo.data[dense_tile], (coo.row[dense_tile], coo.col[dense_tile])),
            shape=coo.shape,
        )
        bcsr = _build_bcsr(dense_part, tile)
        if tile_dtype is not None:
            dt = tile_dtype if isinstance(tile_dtype, torch.dtype) else getattr(torch, tile_dtype)
            bcsr = dataclasses.replace(bcsr, data=bcsr.data.to(dt))
        rest_mask = ~dense_tile
    else:
        rest_mask = np.ones(coo.nnz, bool)

    rest = sp.csr_matrix(
        (coo.data[rest_mask], (coo.row[rest_mask], coo.col[rest_mask])), shape=coo.shape
    )
    return HybridLayout(bcsr=bcsr, ell=build_ell(rest, ks), n_rows=n, tile_edges=tile_edges)


def hybrid_spmm_raw(h: HybridLayout, x: torch.Tensor) -> torch.Tensor:
    """ELL half plus (when there are tiles) the B1 half."""
    out = ell_spmm_raw(h.ell, x)
    if h.bcsr is not None:
        out = out + bcsr_spmm(h.bcsr, x, n_rows=h.n_rows)
    return out


class HybridSpMM(torch.autograd.Function):
    """``A @ x`` with backward ``A^T @ g`` on the transpose layout."""

    @staticmethod
    def forward(ctx, x, h, h_t):
        ctx.h_t = h_t
        return hybrid_spmm_raw(h, x)

    @staticmethod
    def backward(ctx, g):
        return hybrid_spmm_raw(ctx.h_t, g.contiguous()), None, None


def hybrid_spmm_pair(h: HybridLayout, h_t: HybridLayout, x: torch.Tensor) -> torch.Tensor:
    return HybridSpMM.apply(x, h, h_t)
