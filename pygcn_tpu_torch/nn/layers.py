"""Core layers as ``nn.Module``\\ s: graph convolution, dense stacks,
pooling and attention scoring, and the models' dropout.

The port of ``pygcn_tpu/nn/layers.py``. :class:`GraphConv` is the
reference's ``GraphConvolution`` (``pygcn/layers.py:7-38``):
``out = A @ (x @ W) + b``; ``x @ W`` is a plain ``torch.matmul`` and the SpMM
goes through ``ops.spmm.spmm``, which picks the graph's layout. The dense
stacks (:class:`MLP3` and its generator variants, :class:`PoolKeyMLP`) store
their weights ``[in, out]`` as the JAX trees do, with ``torch.nn.Linear``'s
init bounds, drawn from an explicit ``torch.Generator``.
:func:`batch_standardize` is the reference's fresh-BatchNorm quirk.
:func:`dropout` is the JAX package's ``_maybe_dropout``
(``pygcn_tpu/nn/models.py``) on an explicit ``torch.Generator``.
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


def batch_standardize(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Standardise each feature over the node axis (``-2``) with the biased
    variance: the reference builds a *fresh* ``nn.BatchNorm1d`` on every
    forward call (``pygcn/models.py:41-45``), so its affine parameters stay
    at 1 and 0 and no running statistics survive. Batched ``[B, N, H]``
    inputs are standardised per sample."""
    mean = x.mean(dim=-2, keepdim=True)
    var = x.var(dim=-2, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps)


class Dense(nn.Module):
    """Affine layer ``x @ weight + bias``, ``weight`` stored ``[in, out]``,
    with ``torch.nn.Linear``'s default init."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *,
                 generator: torch.Generator):
        super().__init__()
        self.weight = nn.Parameter(tinit.linear_weight(in_features, out_features, generator))
        self.bias = nn.Parameter(tinit.linear_bias(in_features, out_features, generator)) \
            if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.matmul(x, self.weight)
        return out if self.bias is None else out + self.bias


class MLP3(nn.Module):
    """Three dense layers, ReLU after the first two, a linear head: the
    reference's ``LinearLayers``/``MLPLayers`` (``pygcn/models.py:180-217``)."""

    def __init__(self, nin: int, nhid1: int, nhid2: int, nout: int = 1, bias: bool = True, *,
                 generator: torch.Generator):
        super().__init__()
        self.linear1 = Dense(nin, nhid1, bias, generator=generator)
        self.linear2 = Dense(nhid1, nhid2, bias, generator=generator)
        self.linear3 = Dense(nhid2, nout, bias, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.linear1(x))
        x = torch.relu(self.linear2(x))
        return self.linear3(x)


class GeneratorMLP3(MLP3):
    """:class:`MLP3` with :func:`batch_standardize` after each hidden ReLU:
    the reference's ``GeneratorMLPLayers`` (``pygcn/models.py:220-241``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = batch_standardize(torch.relu(self.linear1(x)))
        x = batch_standardize(torch.relu(self.linear2(x)))
        return self.linear3(x)


class SoftmaxMLP3(GeneratorMLP3):
    """:class:`GeneratorMLP3` with a softmax over the node axis (0): the
    reference's ``SoftGeneratorMLP`` (``pygcn/models.py:244-264``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(super().forward(x), dim=0)


def masked_mean_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over the nodes whose flag (the last feature, 0 or 1) is set:
    ``[..., N, F]`` → ``[..., F - 1]``. Features are zeroed where the flag is
    0, summed over nodes and divided by the sample's flag count (at least 1).
    The reference's ``PoolLayer`` (``pygcn/models.py:267-286``) divides every
    sample by sample 0's count; the samples share one count by construction,
    so the per-sample divisor gives the same values."""
    flag = x[..., -1]
    masked = x * flag[..., None]
    count = torch.clamp(torch.count_nonzero(flag, dim=-1), min=1)
    return masked[..., :-1].sum(dim=-2) / count[..., None]


class PoolKeyMLP(nn.Module):
    """Mean over nodes, then three dense layers back to ``nin``: a key
    vector ``[1, nin]``. The reference's ``SoftGeneratorPoolMLP``
    (``pygcn/models.py:289-312``)."""

    def __init__(self, nin: int, nhid1: int, nhid2: int, bias: bool = True, *,
                 generator: torch.Generator):
        super().__init__()
        self.linear1 = Dense(nin, nhid1, bias, generator=generator)
        self.linear2 = Dense(nhid1, nhid2, bias, generator=generator)
        self.linear3 = Dense(nhid2, nin, bias, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.mean(dim=0, keepdim=True)
        x = torch.relu(self.linear1(x))
        x = torch.relu(self.linear2(x))
        return self.linear3(x)


def attention_scores(key_vec: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``softmax_n(Σ_f key[f]·x[n, f])`` over the nodes: the reference's
    ``SoftGeneratorAttention`` (``pygcn/models.py:316-329``)."""
    return torch.softmax((key_vec * x).sum(dim=1), dim=0)
