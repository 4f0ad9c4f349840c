"""The port's GAT (``nn/gat.GAT``, v1 layers) as a benchmark model: its
leaves, the work of a step and the tile-attention launches of a step.

A configuration names this file by ``"model": "gat"``. Its keys:
``in_features``, ``heads``, ``hidden_per_head``, ``out_heads``,
``out_channels``, ``negative_slope``.
"""

from __future__ import annotations

import math

from benchmark.work import GAT_EDGE_OPS, gemm_ops

ATTENTION = True


def layers(config: dict) -> list:
    """``(name, in, heads, width)`` of the two layers."""
    h, f = config["heads"], config["hidden_per_head"]
    return [("gat1", config["in_features"], h, f),
            ("gat2", h * f, config["out_heads"], config["out_channels"])]


def build(config: dict, generator):
    """The port's model on the host; the benchmark then loads its own leaves."""
    from pygcn_tpu_torch.nn.gat import GAT

    return GAT(config["in_features"], config["hidden_per_head"], config["out_channels"],
               heads=config["heads"], out_heads=config["out_heads"],
               negative_slope=config["negative_slope"], generator=generator)


def leaves(config: dict) -> list:
    """``(name, shape, bound)`` of each leaf, in the port's order, at the
    port's init bounds (``sqrt(6 / out)``; ``1 / sqrt(out)`` for a bias)."""
    out = []
    for i, (name, fi, h, f) in enumerate(layers(config)):
        b_out = h * f if i == 0 else f  # the output layer averages its heads
        out += [(f"{name}.w", (fi, h * f), math.sqrt(6.0 / (h * f))),
                (f"{name}.a_src", (h, f), math.sqrt(6.0 / f)),
                (f"{name}.a_dst", (h, f), math.sqrt(6.0 / f)),
                (f"{name}.b", (b_out,), 1.0 / math.sqrt(b_out))]
    return out


def layouts(graph) -> dict:
    """The port's attention layouts (the edge map; on the hybrid layout the
    transposed tiles of kernels B3/B5/B6), built on the host."""
    from pygcn_tpu_torch.apps.train_fullgraph import _gat_layouts

    return _gat_layouts(graph, False)


def step_ops(config: dict, n_nodes: int, n_edges: int) -> int:
    """Operations of one training step and one evaluation forward."""
    fwd = bwd = 0
    for i, (_, fi, h, f) in enumerate(layers(config)):
        fwd += gemm_ops(n_nodes, fi, h * f) + 2 * 2 * n_nodes * h * f
        fwd += n_edges * h * GAT_EDGE_OPS["fwd"](f)
        bwd += gemm_ops(n_nodes, fi, h * f) + 2 * 2 * 2 * n_nodes * h * f
        bwd += n_edges * h * (GAT_EDGE_OPS["bwd_recv"](f) + GAT_EDGE_OPS["bwd_send"](f))
        if i:  # the features need no gradient
            bwd += gemm_ops(n_nodes, fi, h * f)
    return 2 * fwd + bwd


def tile_launches(config: dict) -> list:
    """The tile-attention launches of one step and its evaluation forward,
    as ``(kind, heads, width)``."""
    shapes = [(h, f) for _, _, h, f in layers(config)]
    return ([("fwd", h, f) for h, f in shapes]
            + [(k, h, f) for h, f in shapes for k in ("bwd_recv", "bwd_send")]
            + [("fwd", h, f) for h, f in shapes])
