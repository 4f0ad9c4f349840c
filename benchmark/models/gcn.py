"""The port's GCN (``apps/train_fullgraph.GCN``) as a benchmark model: its
leaves, the work of a step and the tile launches of a step.

A configuration names this file by ``"model": "gcn"``. Its keys:
``in_features``, ``hidden_channels``, ``num_layers``, ``out_channels``.
"""

from __future__ import annotations

import math

from benchmark.work import gemm_ops

ATTENTION = False


def dims(config: dict) -> list:
    hidden = [config["hidden_channels"]] * (config["num_layers"] - 1)
    return [config["in_features"], *hidden, config["out_channels"]]


def build(config: dict, generator):
    """The port's model on the host; the benchmark then loads its own leaves."""
    from pygcn_tpu_torch.apps.train_fullgraph import GCN

    return GCN(dims(config), generator=generator)


def leaves(config: dict) -> list:
    """``(name, shape, bound)`` of each leaf, in the port's order: the port's
    init bounds (``sqrt(6 / out)`` for a weight, ``1 / sqrt(out)`` for a
    bias)."""
    out = []
    d = dims(config)
    for i, (fi, fo) in enumerate(zip(d[:-1], d[1:])):
        out += [(f"layers.{i}.weight", (fi, fo), math.sqrt(6.0 / fo)),
                (f"layers.{i}.bias", (fo,), 1.0 / math.sqrt(fo))]
    return out


def layouts(graph) -> dict:
    """The forward's extra arguments: none."""
    return {}


def step_ops(config: dict, n_nodes: int, n_edges: int) -> int:
    """Operations of one training step and one evaluation forward."""
    d = dims(config)
    fwd = sum(gemm_ops(n_nodes, fi, fo) + 2 * n_edges * fo for fi, fo in zip(d[:-1], d[1:]))
    # backward: each product's A^T g, each weight's gradient, and each
    # layer's input gradient but the first's (the features need none)
    bwd = sum(2 * n_edges * fo + gemm_ops(n_nodes, fi, fo) for fi, fo in zip(d[:-1], d[1:]))
    bwd += sum(gemm_ops(n_nodes, fi, fo) for fi, fo in zip(d[1:-1], d[2:]))
    return 2 * fwd + bwd


def tile_launches(config: dict) -> list:
    """The tile products of one step and its evaluation forward, as
    ``(width, transpose)``: each layer's product forward, its gradient
    backward, and the evaluation's forward."""
    widths = dims(config)[1:]
    return ([(w, False) for w in widths] + [(w, True) for w in widths]
            + [(w, False) for w in widths])
