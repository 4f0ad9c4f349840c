"""The work a step needs, counted from the model's shapes and the graph's
edges: the operations of a whole step (for ``step_mfu``) and the bytes and
operations of each tile-kernel launch (for the rooflines).

The tile counts take the work from the graph, not from how a layout stores
it: per tile-routed edge 8 bytes (an f32 value and an int32 index), the
operand rows under those edges and the output rows, each moved once; 2
operations per tile edge and column for a product. The GAT kernels' per-edge
operations per head (F the head's width):

- forward (B3, B4): the logit's add and leaky ReLU, the running max, the
  shifted exponential, the denominator's add and 2F for the weighted sum:
  ``2F + 6``;
- the receiver-side backward (B5, B5s): the logit, the exponential, 2F for
  ``s_u · dnum_v``, the ``dden`` add, the product with p, leaky' and the sum:
  ``2F + 8``;
- the sender-side backward (B6, B6s): that and 2F more for ``ds``: ``4F + 8``.

Whole-step operations: every GEMM forward and backward (2 per multiply-add),
the sparse products at 2 per edge and column, the attention at the counts
above on every edge, the per-node logits (2HF each), and the evaluation
forward. Elementwise passes (bias, activations, softmax over classes, Adam)
are not counted.
"""

from __future__ import annotations

import dataclasses

GAT_EDGE_OPS = {"fwd": lambda f: 2 * f + 6, "bwd_recv": lambda f: 2 * f + 8,
                "bwd_send": lambda f: 4 * f + 8}


@dataclasses.dataclass(frozen=True)
class TileEdges:
    """The edges a layout routed to the tile kernels: how many, and how many
    distinct senders (operand rows) and receivers (output rows) they have."""

    edges: int
    senders: int
    receivers: int


def spmm_tile_work(t: TileEdges, width: int, transpose: bool = False) -> tuple:
    """``(bytes, operations)`` of one product over the tile edges at
    ``width`` columns; ``transpose`` reads the receivers and writes the
    senders (a backward product)."""
    src, dst = (t.receivers, t.senders) if transpose else (t.senders, t.receivers)
    return t.edges * 8 + 4 * width * (src + dst), 2 * t.edges * width


def gat_tile_work(t: TileEdges, kind: str, h: int, f: int) -> tuple:
    """``(bytes, operations)`` of one tile-attention launch of ``kind``
    (``fwd``, ``bwd_recv`` or ``bwd_send``) at ``h`` heads of ``f``: the
    operand rows under the tile edges and the outputs, each once.

    - fwd reads ``s`` and the source logit of each sender (``hf + h``) and
      the receiver logit (``h``), and writes each receiver's partial
      numerator, denominator and max (``hf + 2h``);
    - bwd_recv reads the senders' ``s`` and logits (``hf + h``) and each
      receiver's logit, max, denominator and output gradient (``3h + hf``),
      and writes the receiver logit's gradient (``h``);
    - bwd_send reads the same, walking the senders, and writes each sender's
      ``ds`` and source logit gradient (``hf + h``).
    """
    hf = h * f
    s, r = t.senders, t.receivers
    rows = {"fwd": s * (hf + h) + r * h + r * (hf + 2 * h),
            "bwd_recv": s * (hf + h) + r * (3 * h + hf) + r * h,
            "bwd_send": s * (hf + h) + r * (3 * h + hf) + s * (hf + h)}[kind]
    return t.edges * 8 + 4 * rows, t.edges * h * GAT_EDGE_OPS[kind](f)


def least_seconds(nbytes: float, ops: float, peak: dict) -> tuple:
    """``(seconds, bound)``: the larger of bytes over the peak bandwidth and
    operations over the f32 peak, and which of the two it is."""
    t_bytes, t_ops = nbytes / peak["hbm_bytes_per_s"], ops / peak["f32_flops_per_s"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gemm_ops(n: int, d_in: int, d_out: int) -> int:
    return 2 * n * d_in * d_out
