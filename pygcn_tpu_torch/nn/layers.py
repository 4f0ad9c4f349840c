"""Graph convolution as an ``nn.Module``, and the models' dropout.

Mirrors ``pygcn_tpu/nn/layers.py:GraphConv`` and the reference's
``GraphConvolution`` (``pygcn/layers.py:7-38``): ``out = A @ (x @ W) + b``.
``x @ W`` is a plain ``torch.matmul``; the SpMM goes through
``ops.spmm.spmm``, which picks the graph's layout. :func:`dropout` is the
JAX package's ``_maybe_dropout`` (``pygcn_tpu/nn/models.py``) on an explicit
``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from pygcn_tpu_torch.graph.graph import Graph
from pygcn_tpu_torch.nn import init as tinit
from pygcn_tpu_torch.ops.spmm import spmm


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Keep each value with probability ``1 - rate``, scaled by ``1 / keep``,
    the rest zero: one uniform draw per value from ``generator`` (which must
    live on ``x``'s device). ``x`` itself without a generator or at
    ``rate <= 0``, as the JAX models do without a dropout key."""
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    kept = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(kept, x / keep, 0.0)


class GraphConv(nn.Module):
    """One GCN layer. ``weight`` is stored ``[in, out]`` as in the reference."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 impl: str = "auto", generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.impl = impl
        self.weight = nn.Parameter(tinit.graphconv_weight(in_features, out_features, g))
        self.bias = nn.Parameter(tinit.graphconv_bias(out_features, g)) if bias else None

    def forward(self, x: torch.Tensor, graph: Graph) -> torch.Tensor:
        out = spmm(graph, torch.matmul(x, self.weight), impl=self.impl)
        if self.bias is not None:
            out = out + self.bias
        return out
