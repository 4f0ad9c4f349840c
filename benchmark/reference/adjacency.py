"""The propagation matrix of Kipf & Welling, worked out in plain PyTorch from
a raw edge list: ``D^-1/2 (max(A, A^T) + I) D^-1/2`` as receiver, sender and
weight arrays, duplicates merged. Independent of the program under test."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Adjacency:
    """``y[rows[e]] += weights[e] * x[cols[e]]`` over the edges ``e``."""

    rows: torch.Tensor  # int64 receivers
    cols: torch.Tensor  # int64 senders
    weights: torch.Tensor  # in the reference's dtype
    n: int

    def spmm(self, x: torch.Tensor) -> torch.Tensor:
        """``A @ x`` for ``x [n, d]``, differentiable in ``x``."""
        msg = x.index_select(0, self.cols) * self.weights[:, None]
        return x.new_zeros((self.n, x.shape[1])).index_add_(0, self.rows, msg)


def _merge(keys: torch.Tensor, vals: torch.Tensor, reduce: str):
    """Unique ``keys`` (sorted) and ``vals`` reduced over each key."""
    uniq, inv = torch.unique(keys, return_inverse=True)
    out = vals.new_zeros(uniq.shape[0])
    if reduce == "amax":
        out = out.scatter_reduce(0, inv, vals, "amax", include_self=False)
    else:
        out = out.index_add(0, inv, vals)
    return uniq, out


def normalized(rows, cols, vals, n: int, device, dtype=torch.float32) -> Adjacency:
    """The Kipf propagation matrix of the raw adjacency ``A[rows, cols] =
    vals`` (``n`` nodes), on ``device``, worked out in ``dtype``."""
    r = torch.as_tensor(rows, dtype=torch.int64, device=device)
    c = torch.as_tensor(cols, dtype=torch.int64, device=device)
    v = torch.as_tensor(vals, dtype=dtype, device=device)
    keys, w = _merge(torch.cat([r * n + c, c * n + r]), torch.cat([v, v]), "amax")
    loops = torch.arange(n, device=device)
    keys, w = _merge(torch.cat([keys, loops * n + loops]),
                     torch.cat([w, torch.ones(n, dtype=dtype, device=device)]), "sum")
    r, c = keys // n, keys % n
    deg = torch.zeros(n, dtype=dtype, device=device).index_add_(0, r, w)
    d = torch.where(deg > 0, deg.rsqrt(), torch.zeros_like(deg))
    return Adjacency(r, c, d[r] * w * d[c], n)
