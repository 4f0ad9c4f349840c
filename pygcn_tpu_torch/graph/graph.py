"""Graph containers for the PyTorch/CUDA sparse engine.

A :class:`Graph` holds a weighted sparse adjacency in up to six physical
layouts, each feeding a different SpMM implementation (``ops/spmm.py``):

- **COO** (``senders``/``receivers``/``weights``, receiver-sorted, zero-padded
  to a multiple of ``EDGE_PAD``) → ``index_select`` + ``index_add_``. Always
  present.
- **dense** (``[N, N]``) → ``torch.mm``; built for small graphs.
- **BCSR** (nonzero ``tm×tk`` tiles + tile coordinates) → kernel B1
  (``ops/cuda/bcsr_spmm.py``).
- **ELL** / **hybrid** (BCSR tiles for dense regions + ELL for the rest) →
  ``ops/ell.py`` / ``ops/hybrid.py``.
- **panel** (diagonal blocks + an off-diagonal ELL) / **colpanel** (one
  bucketed ELL per sender range) → ``ops/panel.py`` / ``ops/colpanel.py``;
  the column panels are the auto-policy's layout above a million nodes.

Construction runs on the host with NumPy/SciPy; the stored arrays are CPU
torch tensors, moved to the card with :meth:`Graph.to`. Every builder mirrors
``pygcn_tpu/graph/graph.py`` array for array, so the same COO gives the same
layouts in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from pygcn_tpu_torch.utils.logging import span

# Edge buffers are padded to a multiple of this (kept from the JAX package so
# both build identical COO arrays).
EDGE_PAD = 512

# Layout-by-scale policy of the JAX package: dense up to ``dense_max_nodes``,
# hybrid BCSR+ELL in the mid band, column panels (and no ELL or hybrid) above
# this many rows. ``Graph.from_coo`` reads it when called, so it can be lowered.
COLPANEL_MIN_NODES = 1_000_000


def tree_to(obj, device, _moved=None):
    """Move every tensor of a (nested) layout dataclass to ``device``.

    An object reached twice is moved once and stays shared: a symmetric
    graph's ``hybrid_t`` and ``ell_t`` are its ``hybrid`` and ``ell``.
    """
    if _moved is None:
        _moved = {}
    if id(obj) in _moved:
        return _moved[id(obj)]
    if isinstance(obj, torch.Tensor):
        out = obj.to(device)
    elif isinstance(obj, (tuple, list)):
        out = type(obj)(tree_to(o, device, _moved) for o in obj)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = dataclasses.replace(
            obj, **{f.name: tree_to(getattr(obj, f.name), device, _moved)
                    for f in dataclasses.fields(obj) if f.init}
        )
    else:
        return obj
    _moved[id(obj)] = out
    return out


@dataclasses.dataclass(frozen=True)
class BCSR:
    """Block-sparse CSR: only nonzero ``tm×tk`` tiles are materialized.

    ``data[i]`` is the dense tile at block coordinates
    ``(block_rows[i], block_cols[i])``; tiles are sorted by block row, and
    ``block_row_ptr`` delimits each block row's tile run (CSR over tiles).

    ``cache`` holds what a kernel derives once from this tile set (kernel
    B1's work schedule). It is not a constructor argument, so every new tile
    set (``dataclasses.replace``, :meth:`to`, the builders) starts empty and
    never reads another set's entries.
    """

    data: torch.Tensor  # [T, tm, tk] float32 or bfloat16
    block_rows: torch.Tensor  # [T] int32
    block_cols: torch.Tensor  # [T] int32
    block_row_ptr: torch.Tensor  # [n_block_rows + 1] int32
    tm: int
    tk: int
    n_block_rows: int
    n_block_cols: int
    cache: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                    compare=False)

    def to(self, device) -> "BCSR":
        return tree_to(self, device)


@dataclasses.dataclass(frozen=True)
class Graph:
    """A weighted directed graph with ``n_nodes`` nodes.

    ``receivers`` are the destination rows of the adjacency: an SpMM
    ``y = A @ x`` computes ``y[r] += w * x[s]`` for each edge ``(s, r, w)``.
    Edge arrays are padded; padding edges have weight 0 and endpoints 0.
    """

    senders: torch.Tensor  # [E_pad] int32 (column indices of A)
    receivers: torch.Tensor  # [E_pad] int32 (row indices of A), sorted
    weights: torch.Tensor  # [E_pad] float
    dense: Optional[torch.Tensor]  # [N, N] or None
    bcsr: Optional[BCSR]
    bcsr_t: Optional[BCSR]  # BCSR of A^T (backward SpMM)
    ell: Optional[object]  # ops/ell.py ELL
    ell_t: Optional[object]
    hybrid: Optional[object]  # ops/hybrid.py HybridLayout
    hybrid_t: Optional[object]
    n_nodes: int
    n_edges: int  # true edge count, before padding
    is_symmetric: bool
    # Layout-shaping build kwargs, so ``transpose()`` rebuilds with the same
    # hyperparameters the caller chose.
    build_meta: tuple = ()
    panel: Optional[object] = None  # ops/panel.py PanelELL
    panel_t: Optional[object] = None
    colpanel: Optional[object] = None  # ops/colpanel.py ColPanelELL
    colpanel_t: Optional[object] = None

    @staticmethod
    def from_coo(
        senders,
        receivers,
        weights=None,
        *,
        n_nodes: int,
        is_symmetric: bool = False,
        build_dense: Optional[bool] = None,
        build_bcsr: Optional[bool] = None,
        build_ell: Optional[bool] = None,
        build_hybrid: Optional[bool] = None,
        build_panel: bool = False,
        build_colpanel: Optional[bool] = None,
        panel_width: int = 65536,
        hybrid_min_edges_per_tile: int = 128,
        hybrid_tile_budget_bytes: Optional[int] = 512 * 1024**2,
        hybrid_residual: str = "ell",
        hybrid_tile_dtype=None,
        ell_ks: tuple[int, ...] = (4, 8, 16, 32, 64, 128, 256),
        tile: tuple[int, int] = (128, 128),
        bcsr_budget_bytes: int = 2 * 1024**3,
        dense_max_nodes: int = 8192,
        colpanel_min_nodes: Optional[int] = None,
        dtype=np.float32,
    ) -> "Graph":
        """Build a :class:`Graph` from host-side COO arrays.

        Unset build flags follow the JAX package's layout-by-scale policy:
        dense up to ``dense_max_nodes``, hybrid BCSR+ELL above, column panels
        (no ELL, no hybrid) above ``colpanel_min_nodes`` (default
        :data:`COLPANEL_MIN_NODES`). ``build_bcsr`` defaults to whether the
        tiles fit ``bcsr_budget_bytes``. Every flag is an explicit override.
        """
        senders = np.asarray(senders, dtype=np.int64)
        receivers = np.asarray(receivers, dtype=np.int64)
        if weights is None:
            weights = np.ones(senders.shape[0], dtype=dtype)
        weights = np.asarray(weights, dtype=dtype)
        if senders.shape != receivers.shape or senders.shape != weights.shape:
            raise ValueError("senders/receivers/weights must have equal shapes")
        n_edges = int(senders.shape[0])

        # Receiver-major sort: sorted segments for the COO path and a cheap
        # pass for the CSR/BCSR derivations. One stable sort on a combined key
        # orders as np.lexsort((senders, receivers)) does (ties keep their
        # input order); edges that arrive sorted (a scipy matrix's COO, a
        # saved graph) are not moved.
        key = receivers * np.int64(n_nodes) + senders
        if np.any(key[1:] < key[:-1]):
            order = np.argsort(key, kind="stable")
            senders = senders[order]
            receivers = receivers[order]
            weights = weights[order]
        del key

        e_pad = max(EDGE_PAD, -(-n_edges // EDGE_PAD) * EDGE_PAD)
        pad = e_pad - n_edges
        if pad:
            senders = np.concatenate([senders, np.zeros(pad, np.int64)])
            receivers = np.concatenate([receivers, np.zeros(pad, np.int64)])
            weights = np.concatenate([weights, np.zeros(pad, dtype)])

        coo = sp.coo_matrix(
            (weights[:n_edges], (receivers[:n_edges], senders[:n_edges])),
            shape=(n_nodes, n_nodes),
            dtype=dtype,
        )

        with span("pipeline.layouts"):
            if build_dense is None:
                build_dense = n_nodes <= dense_max_nodes
            dense = torch.from_numpy(coo.toarray()) if build_dense else None

            if colpanel_min_nodes is None:
                colpanel_min_nodes = COLPANEL_MIN_NODES
            if build_colpanel is None:
                build_colpanel = (not build_dense) and n_nodes > colpanel_min_nodes
            if build_hybrid is None:
                build_hybrid = not build_dense and not build_colpanel

            if build_bcsr is None:
                build_bcsr = _bcsr_fits(coo, tile, bcsr_budget_bytes)
            bcsr = _build_bcsr(coo, tile) if build_bcsr else None
            bcsr_t = None
            if build_bcsr and not is_symmetric:
                bcsr_t = _build_bcsr(coo.T.tocoo(), tile)

            if build_ell is None:
                build_ell = not build_dense and not build_colpanel
            ell = ell_t = None
            if build_ell:
                from pygcn_tpu_torch.ops.ell import build_ell as _mk_ell

                ell = _mk_ell(coo, ell_ks)
                ell_t = ell if is_symmetric else _mk_ell(coo.T.tocsr(), ell_ks)

            hybrid = hybrid_t = None
            if build_hybrid:
                from pygcn_tpu_torch.ops.hybrid import build_hybrid as _mk_hybrid

                kw = dict(tile_budget_bytes=hybrid_tile_budget_bytes, residual=hybrid_residual,
                          panel_width=panel_width, tile_dtype=hybrid_tile_dtype)
                hybrid = _mk_hybrid(coo, tile, hybrid_min_edges_per_tile, ell_ks, **kw)
                hybrid_t = hybrid if is_symmetric else _mk_hybrid(
                    coo.T.tocoo(), tile, hybrid_min_edges_per_tile, ell_ks, **kw)

            panel = panel_t = None
            if build_panel:
                from pygcn_tpu_torch.ops.panel import build_panel_ell

                panel = build_panel_ell(coo, panel_width, ell_ks)
                panel_t = panel if is_symmetric else build_panel_ell(
                    coo.T.tocoo(), panel_width, ell_ks)

            colpanel = colpanel_t = None
            if build_colpanel:
                from pygcn_tpu_torch.ops.colpanel import (COLPANEL_KS, build_col_panel_ell,
                                                          share_structure)

                # the column panels take their own fine bucket ladder, as in JAX;
                # a transpose equal but in its values holds the forward's arrays
                colpanel = build_col_panel_ell(coo, panel_width, COLPANEL_KS)
                colpanel_t = colpanel if is_symmetric else share_structure(
                    build_col_panel_ell(coo.T.tocsr(), panel_width, COLPANEL_KS), colpanel)

        build_meta = (
            ("panel_width", panel_width),
            ("hybrid_min_edges_per_tile", hybrid_min_edges_per_tile),
            ("hybrid_tile_budget_bytes", hybrid_tile_budget_bytes),
            ("hybrid_residual", hybrid_residual),
            ("hybrid_tile_dtype", hybrid_tile_dtype),
            ("ell_ks", tuple(ell_ks)),
            ("tile", tuple(tile)),
            ("bcsr_budget_bytes", bcsr_budget_bytes),
            ("dense_max_nodes", dense_max_nodes),
        )

        return Graph(
            senders=torch.from_numpy(senders.astype(np.int32)),
            receivers=torch.from_numpy(receivers.astype(np.int32)),
            weights=torch.from_numpy(weights),
            dense=dense,
            bcsr=bcsr,
            bcsr_t=bcsr_t,
            ell=ell,
            ell_t=ell_t,
            hybrid=hybrid,
            hybrid_t=hybrid_t,
            n_nodes=int(n_nodes),
            n_edges=n_edges,
            is_symmetric=bool(is_symmetric),
            build_meta=build_meta,
            panel=panel,
            panel_t=panel_t,
            colpanel=colpanel,
            colpanel_t=colpanel_t,
        )

    @staticmethod
    def from_scipy(mat: sp.spmatrix, **kwargs) -> "Graph":
        coo = mat.tocoo()
        return Graph.from_coo(coo.col, coo.row, coo.data, n_nodes=coo.shape[0], **kwargs)

    def to(self, device) -> "Graph":
        """This graph with every layout tensor on ``device``."""
        return tree_to(self, device)

    @property
    def device(self) -> torch.device:
        return self.senders.device

    def transpose(self) -> "Graph":
        """A^T as a new Graph (host-side reshuffle)."""
        if self.is_symmetric:
            return self
        e = self.n_edges
        return Graph.from_coo(
            self.receivers[:e].cpu().numpy(),
            self.senders[:e].cpu().numpy(),
            self.weights[:e].cpu().numpy(),
            n_nodes=self.n_nodes,
            build_dense=self.dense is not None,
            build_bcsr=self.bcsr is not None,
            build_ell=self.ell is not None,
            build_hybrid=self.hybrid is not None,
            build_panel=self.panel is not None,
            build_colpanel=self.colpanel is not None,
            **dict(self.build_meta),
        ).to(self.device)

    def to_scipy(self) -> sp.coo_matrix:
        e = self.n_edges
        return sp.coo_matrix(
            (
                self.weights[:e].cpu().numpy(),
                (self.receivers[:e].cpu().numpy(), self.senders[:e].cpu().numpy()),
            ),
            shape=(self.n_nodes, self.n_nodes),
        )

    @property
    def e_pad(self) -> int:
        return int(self.senders.shape[0])


# ---------------------------------------------------------------------- #
# BCSR construction
# ---------------------------------------------------------------------- #


def _bcsr_fits(coo: sp.coo_matrix, tile, budget_bytes: int) -> bool:
    if coo.nnz == 0:
        return False
    tm, tk = tile
    tile_ids = (coo.row // tm).astype(np.int64) * (-(-coo.shape[1] // tk)) + coo.col // tk
    return np.unique(tile_ids).size * tm * tk * 4 <= budget_bytes


def _build_bcsr(coo: sp.coo_matrix, tile: tuple[int, int]) -> BCSR:
    """Materialize the nonzero tiles of ``coo`` (row-major tile order).

    Duplicate entries are summed. Every empty block row gets one all-zero tile
    at block column 0, as the JAX builder does for its kernel; the CUDA kernel
    does not rely on it (a row with no tiles writes zeros there too).
    """
    tm, tk = tile
    n, m = coo.shape
    n_block_rows = -(-n // tm)
    n_block_cols = -(-m // tk)

    br = (coo.row // tm).astype(np.int64)
    bc = (coo.col // tk).astype(np.int64)
    tile_ids = br * n_block_cols + bc
    uniq = np.unique(tile_ids)
    empty_rows = np.setdiff1d(np.arange(n_block_rows, dtype=np.int64), uniq // n_block_cols)
    if empty_rows.size:
        uniq = np.sort(np.concatenate([uniq, empty_rows * n_block_cols]))
    inverse = np.searchsorted(uniq, tile_ids)

    data = np.zeros((uniq.size, tm, tk), dtype=coo.data.dtype)
    np.add.at(data, (inverse, coo.row % tm, coo.col % tk), coo.data)

    block_rows = (uniq // n_block_cols).astype(np.int32)
    block_cols = (uniq % n_block_cols).astype(np.int32)
    block_row_ptr = np.zeros(n_block_rows + 1, dtype=np.int32)
    np.add.at(block_row_ptr, block_rows + 1, 1)
    block_row_ptr = np.cumsum(block_row_ptr).astype(np.int32)

    return BCSR(
        data=torch.from_numpy(data),
        block_rows=torch.from_numpy(block_rows),
        block_cols=torch.from_numpy(block_cols),
        block_row_ptr=torch.from_numpy(block_row_ptr),
        tm=tm,
        tk=tk,
        n_block_rows=n_block_rows,
        n_block_cols=n_block_cols,
    )


def drop_zero_tiles(bcsr: BCSR) -> BCSR:
    """``bcsr`` without its all-zero tiles, such as the padding tile that
    :func:`_build_bcsr` gives each empty block row: those rows then own no tile
    at all, a case every kernel over BCSR tiles must handle too."""
    keep = bcsr.data.reshape(bcsr.data.shape[0], -1).ne(0).any(dim=1)
    counts = torch.bincount(bcsr.block_rows[keep].long(), minlength=bcsr.n_block_rows)
    ptr = torch.cat([counts.new_zeros(1), counts.cumsum(0)]).to(torch.int32)
    return dataclasses.replace(bcsr, data=bcsr.data[keep], block_rows=bcsr.block_rows[keep],
                               block_cols=bcsr.block_cols[keep], block_row_ptr=ptr)
