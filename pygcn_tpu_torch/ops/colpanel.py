"""Column-panel ELL — the SpMM layout for graphs above a million nodes.

The port of ``pygcn_tpu/ops/colpanel.py``. Edges are grouped by sender range,
``col // panel_width``, into per-panel bucketed-ELL blocks whose column ids
are panel-local, so every gather of a bucket reads the panel's slice
``x[s:s+w]`` (a view, no copy). Rows with no edge in a panel are compacted
away, so a row has one virtual row per panel it touches (more only when it
has more than the largest bucket width of edges there), and every virtual
row's partial lands on its global row by ``index_add_``.

Inside one bucket the virtual rows are sorted by row, and unique except for
rows split across the widest bucket. A bucket with unique rows adds once per
output row; a bucket that repeats rows sums each row's virtual rows by
``torch.segment_reduce`` first (the ``merge`` pair stored with the bucket). So
each output row receives its adds in panel and bucket order, and the product
gives the same bits on every run.

The JAX layout stores ``cols``/``vals`` flat, ``[nb*k]``, against the TPU's
tile padding; here they are ``[nb, k]``, the same arrays after a reshape.
Backward uses the transpose layout through :class:`torch.autograd.Function`
(symmetric graphs pass the forward layout twice).

Every product runs inside the span ``spmm.colpanel`` (forward and backward
alike), and ``bucket_products`` counts the bucket products it runs: one per
live bucket, or per row chunk of a live bucket over the chunk budget.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from pygcn_tpu_torch.graph.graph import tree_to
from pygcn_tpu_torch.ops.ell import build_ell
from pygcn_tpu_torch.utils.logging import span

# Fine bucket ladder (the JAX package's): a row's edges split across the
# panels it touches, so per-panel degrees are small and most slots land in
# the narrow buckets.
COLPANEL_KS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256)

# Bound on one bucket's gathered ``[rows·k, H]`` transient, in elements: a
# wider bucket runs in row chunks. 1 GiB of f32, two of which (the gather and
# its weighted copy) coexist: small beside an 80 GB card, and above every
# bucket of the ogbn-products graph at H = 128, which therefore runs unchunked.
COLPANEL_CHUNK_BUDGET_ELEMS = 1 << 28

# Bucket products (row chunks of live buckets) run since import (or since a
# caller reset it to 0).
bucket_products = 0


@dataclasses.dataclass(frozen=True)
class PanelBuckets:
    """One panel's buckets: ``cols [nb, k]`` (panel-local), ``vals [nb, k]``,
    ``rows [nb]`` (global); per bucket ``merge``, None when its rows are
    unique, else ``(lengths, urows)``, the run lengths of its sorted rows and
    the row of each run; and ``live``, False for the one-row all-zero
    placeholder ``build_ell`` gives a width no row has, which the products
    skip."""

    cols: Tuple[torch.Tensor, ...]  # int32
    vals: Tuple[torch.Tensor, ...]  # float32
    rows: Tuple[torch.Tensor, ...]  # int32
    ks: Tuple[int, ...]
    merge: Tuple[Optional[Tuple[torch.Tensor, torch.Tensor]], ...]
    live: Tuple[bool, ...]


@dataclasses.dataclass(frozen=True)
class ColPanelELL:
    panels: Tuple[PanelBuckets, ...]
    starts: Tuple[int, ...]
    widths: Tuple[int, ...]
    n_rows: int
    n_vrows: int  # virtual rows across panels (diagnostics)

    def to(self, device) -> "ColPanelELL":
        return tree_to(self, device)


def merge_of(rows: np.ndarray):
    """``None`` for a bucket of unique rows, else its ``(lengths, urows)``."""
    if rows.size < 2 or np.all(rows[1:] > rows[:-1]):
        return None
    if np.any(rows[1:] < rows[:-1]):
        raise ValueError("bucket rows must be sorted (build_ell's row-major order)")
    urows, lengths = np.unique(rows, return_counts=True)
    return (torch.from_numpy(lengths.astype(np.int64)), torch.from_numpy(urows.astype(np.int32)))


def build_col_panel_ell(mat: sp.spmatrix, panel_width: int = 65536,
                        ks: Tuple[int, ...] = COLPANEL_KS) -> ColPanelELL:
    """Per sender panel ``[s, s + w)``, a bucketed ELL of the rows with an edge
    there; panels without an edge are skipped."""
    csc = mat.tocsc()
    n_rows, n_cols = csc.shape
    n_panels = max(1, -(-n_cols // panel_width))
    panels, starts, widths = [], [], []
    n_vrows = 0
    for p in range(n_panels):
        s = p * panel_width
        w = min(panel_width, n_cols - s)
        sub = csc[:, s:s + w].tocsr()
        # rows with no edge in this panel are compacted away first: build_ell
        # gives every row a slot, which would make n_rows * n_panels vrows
        nz = np.flatnonzero(np.diff(sub.indptr))
        if nz.size == 0:
            continue
        ell = build_ell(sub[nz], ks)
        rmap = nz.astype(np.int32)
        rows = [rmap[r.numpy()] for r in ell.rows]
        panels.append(PanelBuckets(
            cols=ell.cols, vals=ell.vals, rows=tuple(torch.from_numpy(r) for r in rows),
            ks=ell.ks, merge=tuple(merge_of(r) for r in rows),
            live=tuple(bool(v.shape[0] > 1 or v.any()) for v in ell.vals)))
        n_vrows += sum(r.size for r in rows)
        starts.append(s)
        widths.append(w)
    return ColPanelELL(panels=tuple(panels), starts=tuple(starts), widths=tuple(widths),
                       n_rows=n_rows, n_vrows=n_vrows)


def buckets(pe: ColPanelELL):
    """``(start, width, cols, vals, rows, merge)`` of every live bucket, in
    panel and bucket order."""
    for fb, s, w in zip(pe.panels, pe.starts, pe.widths):
        for cols, vals, rows, merge, live in zip(fb.cols, fb.vals, fb.rows, fb.merge, fb.live):
            if live:
                yield s, w, cols, vals, rows, merge


def row_chunks(nb: int, slots_per_row: int, budget: int):
    """Row slices of a bucket of ``nb`` rows whose per-row transient holds
    ``slots_per_row`` elements, each slice under ``budget`` elements."""
    per = max(1, budget // max(1, slots_per_row))
    return [slice(lo, min(nb, lo + per)) for lo in range(0, nb, per)]


def merge_add(out: torch.Tensor, rows: torch.Tensor, merge, part: torch.Tensor) -> torch.Tensor:
    """``out[rows] += part`` with one add per output row (``merge``: the
    bucket's run lengths and rows when its rows repeat). In place; returns
    ``out``."""
    if merge is not None:
        lengths, rows = merge
        part = torch.segment_reduce(part, "sum", lengths=lengths, axis=0)
    return out.index_add_(0, rows, part)


def col_panel_spmm_raw(pe: ColPanelELL, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` for ``x [n_cols, H]`` (no autograd of its own)."""
    global bucket_products
    h = x.shape[1]
    with span("spmm.colpanel"):
        out = torch.zeros((pe.n_rows, h), dtype=x.dtype, device=x.device)
        for s, w, cols, vals, rows, merge in buckets(pe):
            nb, k = cols.shape
            parts = [bucket_partial(x[s:s + w], cols[sl], vals[sl])
                     for sl in row_chunks(nb, k * h, COLPANEL_CHUNK_BUDGET_ELEMS)]
            bucket_products += len(parts)
            merge_add(out, rows, merge, parts[0] if len(parts) == 1 else torch.cat(parts))
    return out


def bucket_partial(xs: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Per-virtual-row partials ``[nb, H]`` of one bucket (or row chunk)."""
    nb, k = cols.shape
    g = xs.index_select(0, cols.reshape(-1)).view(nb, k, xs.shape[1])
    return (g * vals[..., None]).sum(dim=1)


class ColPanelSpMM(torch.autograd.Function):
    """``A @ x`` with backward ``A^T @ g`` on the transpose layout."""

    @staticmethod
    def forward(ctx, x, pe, pe_t):
        ctx.pe_t = pe_t
        return col_panel_spmm_raw(pe, x)

    @staticmethod
    def backward(ctx, g):
        return col_panel_spmm_raw(ctx.pe_t, g.contiguous()), None, None


def col_panel_spmm_pair(pe: ColPanelELL, pe_t: ColPanelELL, x: torch.Tensor) -> torch.Tensor:
    return ColPanelSpMM.apply(x, pe, pe_t)
