"""Node-classification models built from ``GraphConv``.

The port of ``pygcn_tpu/nn/models.py``'s ``KipfGCN``; the evaluator's
models of that file (``GCN3``, ``GCNOverMLP`` and the generators) are not
ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pygcn_tpu_torch.graph.graph import Graph
from pygcn_tpu_torch.nn.layers import GraphConv, dropout


class KipfGCN(nn.Module):
    """The classic 2-layer Kipf GCN for semi-supervised node classification
    (the BASELINE Cora configuration: hidden 16, dropout 0.5):
    ``dropout → gc1 → relu → dropout → gc2 → log_softmax``.

    Dropout runs in training mode when :meth:`forward` gets a
    ``dropout_generator`` (on the input's device), as the JAX model drops
    only when it gets a key; in eval mode, or without a generator, nothing
    is dropped.
    """

    def __init__(self, nfeat: int, nhid: int, nclass: int, dropout: float = 0.5, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout = dropout
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.gc1 = GraphConv(nfeat, nhid, generator=g)
        self.gc2 = GraphConv(nhid, nclass, generator=g)

    def forward(self, x: torch.Tensor, graph: Graph,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        gen = dropout_generator if self.training else None
        x = dropout(x, self.dropout, gen)
        x = torch.relu(self.gc1(x, graph))
        x = dropout(x, self.dropout, gen)
        return F.log_softmax(self.gc2(x, graph), dim=1)
