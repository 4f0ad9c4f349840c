"""The Kipf propagation matrix of ``adjacency.py`` with a product that runs
over blocks of edges, for graphs whose gathered ``[E, d]`` would not fit the
card: ``Adjacency.spmm`` gathers every edge's operand row at once, 258 GB at
126M edges, 256 columns and float64. Each block gathers at most
``BLOCK_BYTES`` and adds its weighted rows into the output; the gradient is
the same product over the transpose (receivers and senders swapped). Plain
PyTorch, independent of the program under test."""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference import adjacency

# the most one block's gathered rows may hold
BLOCK_BYTES = 2 * 10**9


@dataclasses.dataclass
class BlockedAdjacency:
    """``y[rows[e]] += weights[e] * x[cols[e]]`` over the edges ``e``, a
    block of edges at a time."""

    rows: torch.Tensor  # int64 receivers
    cols: torch.Tensor  # int64 senders
    weights: torch.Tensor  # in the reference's dtype
    n: int
    block_bytes: int = BLOCK_BYTES

    def spmm(self, x: torch.Tensor) -> torch.Tensor:
        """``A @ x`` for ``x [n, d]``, differentiable in ``x``."""
        return _BlockedSpMM.apply(x, self)

    def block_edges(self, x: torch.Tensor) -> int:
        """Edges a block holds: its gathered ``[block, d]`` in ``x``'s dtype
        within ``block_bytes``, at least one."""
        return max(1, self.block_bytes // (x.element_size() * max(1, x.shape[1])))


def product(rows, cols, weights, n: int, x: torch.Tensor, block: int) -> torch.Tensor:
    """``y[rows[e]] += weights[e] * x[cols[e]]``, ``block`` edges at a time."""
    out = x.new_zeros((n, x.shape[1]))
    for lo in range(0, rows.shape[0], block):
        hi = lo + block
        out.index_add_(0, rows[lo:hi], x.index_select(0, cols[lo:hi]) * weights[lo:hi, None])
    return out


class _BlockedSpMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, adj):
        ctx.adj = adj
        return product(adj.rows, adj.cols, adj.weights, adj.n, x, adj.block_edges(x))

    @staticmethod
    def backward(ctx, g):
        adj = ctx.adj
        return product(adj.cols, adj.rows, adj.weights, adj.n, g, adj.block_edges(g)), None


def normalized(rows, cols, vals, n: int, device, dtype=torch.float32,
               block_bytes: int = BLOCK_BYTES) -> BlockedAdjacency:
    """``adjacency.normalized``'s matrix with the blocked product."""
    a = adjacency.normalized(rows, cols, vals, n, device, dtype)
    return BlockedAdjacency(a.rows, a.cols, a.weights, a.n, block_bytes)
