"""GIN and APPNP as ``nn.Module``\\ s.

The port of ``pygcn_tpu/nn/gin.py``:

- **GIN** (Xu et al. 2019): ``h = MLP((1 + eps)·x + spmm(x))`` with a
  learnable ``eps`` (starting at 0) and a 2-layer MLP per convolution. Its
  canonical sum aggregator wants raw edge weights; over a normalised
  adjacency it runs as a degree-weighted variant.
- **APPNP** (Gasteiger et al. 2019): an MLP predicts per-node logits ``h``,
  then K steps of personalised-PageRank propagation
  ``z ← (1−α)·spmm(z) + α·h`` (:func:`appnp_propagate`; the JAX package's
  ``lax.scan`` becomes a Python loop).

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


class MLP2(nn.Module):
    """``relu(x @ w1 + b1) @ w2 + b2``, the JAX package's ``_mlp2``."""

    def __init__(self, nin: int, nhid: int, nout: int, *, generator: torch.Generator):
        super().__init__()
        self.w1 = nn.Parameter(tinit.graphconv_weight(nin, nhid, generator))
        self.b1 = nn.Parameter(tinit.graphconv_bias(nhid, generator))
        self.w2 = nn.Parameter(tinit.graphconv_weight(nhid, nout, generator))
        self.b2 = nn.Parameter(tinit.graphconv_bias(nout, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(x @ self.w1 + self.b1) @ self.w2 + self.b2


class GINConv(nn.Module):
    """GIN layer: ``mlp((1 + eps)·x + spmm(x))``; ``hidden_features`` 0 means
    ``out_features``."""

    def __init__(self, in_features: int, out_features: int, hidden_features: int = 0, *,
                 generator: torch.Generator):
        super().__init__()
        self.mlp = MLP2(in_features, hidden_features or out_features, out_features,
                        generator=generator)
        self.eps = nn.Parameter(torch.zeros(()))

    def forward(self, x: torch.Tensor, graph: Graph) -> torch.Tensor:
        return self.mlp(spmm(graph, x) + (1.0 + self.eps) * x)


class GIN(nn.Module):
    """2-layer GIN node classifier: ``relu(gin1) → gin2 → log_softmax``."""

    def __init__(self, nfeat: int, nhid: int, nclass: int, *, generator: torch.Generator):
        super().__init__()
        self.gin1 = GINConv(nfeat, nhid, generator=generator)
        self.gin2 = GINConv(nhid, nclass, hidden_features=nhid, generator=generator)

    def forward(self, x: torch.Tensor, graph: Graph) -> torch.Tensor:
        x = torch.relu(self.gin1(x, graph))
        return F.log_softmax(self.gin2(x, graph), dim=1)


def appnp_propagate(graph: Graph, h: torch.Tensor, k: int, alpha: float) -> torch.Tensor:
    """K personalised-PageRank steps ``z ← (1−α)·spmm(z) + α·h``, from ``z = h``."""
    z = h
    for _ in range(k):
        z = (1.0 - alpha) * spmm(graph, z) + alpha * h
    return z


class APPNP(nn.Module):
    """Predict-then-propagate node classifier: a 2-layer MLP, then
    :func:`appnp_propagate` (K = 10, α = 0.1), then log-softmax."""

    def __init__(self, nfeat: int, nhid: int, nclass: int, k: int = 10, alpha: float = 0.1, *,
                 generator: torch.Generator):
        super().__init__()
        self.mlp = MLP2(nfeat, nhid, nclass, generator=generator)
        self.k, self.alpha = k, alpha

    def forward(self, x: torch.Tensor, graph: Graph) -> torch.Tensor:
        z = appnp_propagate(graph, self.mlp(x), self.k, self.alpha)
        return F.log_softmax(z, dim=1)
