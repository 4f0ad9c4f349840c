"""GraphSAGE and SGC as ``nn.Module``\\ s.

The port of ``pygcn_tpu/nn/sage.py``:

- **SAGE-mean** (Hamilton et al. 2017): ``out = x @ W_self + agg(x) @ W_nb + b``,
  a self and a neighbour transform over whatever propagation the graph
  carries (a row-normalised adjacency gives the paper's mean aggregator);
- **SGC** (Wu et al. 2019): ``A_hat^K x`` computed once
  (:func:`sgc_propagate`), then one linear layer.

Both reuse ``ops.spmm.spmm``, which runs kernel B1 (or B2 with
``BCSR_STREAM``) on the hybrid layout's tiles. Weights are drawn from an
explicit ``torch.Generator`` with the GraphConv bounds of ``nn/init.py``;
tests that need the JAX package's weights carry them across with
``pygcn_tpu_torch.convert``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pygcn_tpu_torch.graph.graph import Graph
from pygcn_tpu_torch.nn import init as tinit
from pygcn_tpu_torch.ops.spmm import spmm


class SAGEConv(nn.Module):
    """SAGE-mean layer: ``x @ w_self + spmm(x) @ w_nb + b``; weights ``[in, out]``."""

    def __init__(self, in_features: int, out_features: int, *, generator: torch.Generator):
        super().__init__()
        self.w_self = nn.Parameter(tinit.graphconv_weight(in_features, out_features, generator))
        self.w_nb = nn.Parameter(tinit.graphconv_weight(in_features, out_features, generator))
        self.b = nn.Parameter(tinit.graphconv_bias(out_features, generator))

    def forward(self, x: torch.Tensor, graph: Graph) -> torch.Tensor:
        return x @ self.w_self + spmm(graph, x) @ self.w_nb + self.b


class SAGE(nn.Module):
    """2-layer SAGE-mean node classifier: ``relu(sage1) → sage2 → log_softmax``."""

    def __init__(self, nfeat: int, nhid: int, nclass: int, *, generator: torch.Generator):
        super().__init__()
        self.sage1 = SAGEConv(nfeat, nhid, generator=generator)
        self.sage2 = SAGEConv(nhid, nclass, generator=generator)

    def forward(self, x: torch.Tensor, graph: Graph) -> torch.Tensor:
        x = torch.relu(self.sage1(x, graph))
        return F.log_softmax(self.sage2(x, graph), dim=1)


def sgc_propagate(graph: Graph, x: torch.Tensor, k: int = 2) -> torch.Tensor:
    """``A_hat^K x``: SGC's whole graph computation, run once."""
    for _ in range(k):
        x = spmm(graph, x)
    return x


class SGC(nn.Module):
    """SGC head: one linear layer over :func:`sgc_propagate`'s output, then
    log-softmax; training never touches the graph."""

    def __init__(self, nfeat: int, nclass: int, *, generator: torch.Generator):
        super().__init__()
        self.w = nn.Parameter(tinit.graphconv_weight(nfeat, nclass, generator))
        self.b = nn.Parameter(tinit.graphconv_bias(nclass, generator))

    def forward(self, x_propagated: torch.Tensor) -> torch.Tensor:
        return F.log_softmax(x_propagated @ self.w + self.b, dim=1)
