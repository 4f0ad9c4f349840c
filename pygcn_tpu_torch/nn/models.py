"""The model zoo as ``nn.Module``\\ s: the port of ``pygcn_tpu/nn/models.py``.

- :class:`KipfGCN`, the 2-layer node classifier of the Cora CLI;
- the evaluator's models: :class:`GCN3` (the reference's ``GCN``),
  :class:`GCNOverMLP` (the surrogate evaluator), :class:`GCNRegressor` (the
  legacy trainer's) and :class:`PoolMLPModel` (the no-GCN baseline);
- the policy generators: :class:`GeneratorGCN3`, :class:`TopKGenerator`
  with :func:`topk_flag_straight_through`, :class:`HierarchicalGenerator`
  and :class:`SoftGenerator`;
- :func:`get_model`, the reference's name → model dispatch, with the GAT,
  GATv2, SAGE, GIN and APPNP entries over ``nn/gat.py``, ``nn/sage.py`` and
  ``nn/gin.py``.

A batch of policy samples ``[B, N, F]`` runs through the GCN layers at once:
every SpMM folds it into one ``[N, B·H]`` product (``ops/spmm.py``), where
the JAX package ``vmap``\\ s over samples and the reference loops. Weights
are drawn from an explicit ``torch.Generator``; each model takes the
``impl`` of its graph convolutions, as the JAX model does. Tests that need
the JAX package's weights carry them across with ``pygcn_tpu_torch.convert``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pygcn_tpu_torch.graph.graph import Graph
from pygcn_tpu_torch.nn.layers import (MLP3, GeneratorMLP3, GraphConv, PoolKeyMLP,
                                       attention_scores, batch_standardize, dropout,
                                       masked_mean_pool)


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


class GCN3(nn.Module):
    """3-layer GCN backbone, ``bs(relu(gc1)) → bs(relu(gc2)) → relu(gc3)``
    with ``bs`` = :func:`batch_standardize`: the reference's ``GCN``
    (``pygcn/models.py:17-71``), raw ReLU output. Dropout is defined but off
    in the reference; here it runs when :meth:`forward` gets a
    ``dropout_generator``, as the JAX model drops only when it gets a key."""

    def __init__(self, nfeat: int, nhid: int, nclass: int, dropout: float = 0.0,
                 impl: str = "auto", *, generator: torch.Generator):
        super().__init__()
        self.dropout = dropout
        self.gc1 = GraphConv(nfeat, nhid, impl=impl, generator=generator)
        self.gc2 = GraphConv(nhid, nhid, impl=impl, generator=generator)
        self.gc3 = GraphConv(nhid, nclass, impl=impl, generator=generator)

    def forward(self, x: torch.Tensor, graph: Graph,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = batch_standardize(torch.relu(self.gc1(x, graph)))
        x = dropout(x, self.dropout, dropout_generator)
        x = batch_standardize(torch.relu(self.gc2(x, graph)))
        x = dropout(x, self.dropout, dropout_generator)
        return torch.relu(self.gc3(x, graph))


class GeneratorGCN3(GCN3):
    """3-layer GCN with plain ReLUs, no standardisation: the reference's
    ``GeneratorGCN`` / ``SoftGeneratorGCN`` (``pygcn/models.py:74-177``)."""

    def forward(self, x: torch.Tensor, graph: Graph,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = torch.relu(self.gc1(x, graph))
        x = torch.relu(self.gc2(x, graph))
        return torch.relu(self.gc3(x, graph))


class GCNOverMLP(nn.Module):
    """The surrogate evaluator: :class:`GCN3` on the first ``dim_touched``
    features, the untouched ones (the vaccination flag last) concatenated
    back, :func:`masked_mean_pool`, then :class:`MLP3`. The reference's
    ``GCN_OVER_MLP`` (``pygcn/models.py:333-355``).

    ``x`` ``[B, N, F]`` → ``[B, linear_nout]``; the batch goes through each
    SpMM as one ``[N, B·H]`` product and is standardised per sample."""

    def __init__(self, gcn_nfeat: int, gcn_nhid: int, gcn_nclass: int, dim_touched: int,
                 linear_nin: int, linear_nhid1: int, linear_nhid2: int, linear_nout: int = 1,
                 impl: str = "auto", *, generator: torch.Generator):
        super().__init__()
        self.gcn_nfeat, self.gcn_nhid, self.gcn_nclass = gcn_nfeat, gcn_nhid, gcn_nclass
        self.dim_touched = dim_touched
        self.linear_nin, self.linear_nhid1 = linear_nin, linear_nhid1
        self.linear_nhid2, self.linear_nout = linear_nhid2, linear_nout
        self.gcn = GCN3(gcn_nfeat, gcn_nhid, gcn_nclass, impl=impl, generator=generator)
        self.mlp = MLP3(linear_nin, linear_nhid1, linear_nhid2, linear_nout, generator=generator)

    def forward(self, x: torch.Tensor, graph: Graph) -> torch.Tensor:
        d = self.dim_touched
        return self.head(self.gcn(x[:, :, :d], graph), x[:, :, d:])

    def head(self, g: torch.Tensor, untouched: torch.Tensor) -> torch.Tensor:
        """The pool and the MLP on the GCN's output ``g`` and the untouched
        features (the flag last): what the input's flag reaches."""
        return self.mlp(masked_mean_pool(torch.cat([g, untouched], dim=2)))


def topk_flag_straight_through(scores: torch.Tensor, nn_select: int) -> torch.Tensor:
    """Differentiable top-K selection through the reference's reciprocal
    mask (``pygcn/models.py:373-377``): ``scores [N, 1]`` → a flag ``[N, 1]``,
    1 at the entries strictly above the (NN+1)-th largest score and 0
    elsewhere, whose gradient is ``1 / score`` (the score detached) on the
    selected entries."""
    s = scores[:, 0]
    thresh = torch.topk(s, nn_select + 1).values[-1]
    mask = torch.where(s > thresh, 1.0 / s.detach(), torch.zeros_like(s))
    return (s * mask)[:, None]


class TopKGenerator(nn.Module):
    """Differentiable top-K vaccination-policy generator: the reference's
    ``Generator`` (``pygcn/models.py:358-379``). :class:`GeneratorGCN3` on the
    first ``dim_touched`` features, the rest concatenated back, a
    :class:`GeneratorMLP3` score per node, then
    :func:`topk_flag_straight_through`. ``x`` is one sample ``[N, F]``."""

    def __init__(self, gcn_nfeat: int, gcn_nhid: int, gcn_nclass: int, dim_touched: int,
                 nn_select: int, linear_nin: int, linear_nhid1: int, linear_nhid2: int,
                 linear_nout: int = 1, impl: str = "auto", *, generator: torch.Generator):
        super().__init__()
        self.dim_touched, self.nn_select = dim_touched, nn_select
        self.gcn = GeneratorGCN3(gcn_nfeat, gcn_nhid, gcn_nclass, impl=impl, generator=generator)
        self.mlp = GeneratorMLP3(linear_nin, linear_nhid1, linear_nhid2, linear_nout,
                                 generator=generator)

    def scores(self, x: torch.Tensor, graph: Graph) -> torch.Tensor:
        d = self.dim_touched
        return self.mlp(torch.cat([self.gcn(x[:, :d], graph), x[:, d:]], dim=1))

    def forward(self, x: torch.Tensor, graph: Graph) -> torch.Tensor:
        return topk_flag_straight_through(self.scores(x, graph), self.nn_select)


class HierarchicalGenerator(nn.Module):
    """Top-K generator that never selects a target demographic group: the
    reference's ``Hierarchical_Generator`` (``pygcn/models.py:382-408``). The
    last feature is a group id; the scores of ``target_group`` are set to
    the minimum score before the top-K. Its head is the plain
    :class:`MLP3`, as in the reference."""

    def __init__(self, gcn_nfeat: int, gcn_nhid: int, gcn_nclass: int, dim_touched: int,
                 nn_select: int, linear_nin: int, linear_nhid1: int, linear_nhid2: int,
                 linear_nout: int = 1, target_group: int = 0, impl: str = "auto", *,
                 generator: torch.Generator):
        super().__init__()
        self.dim_touched, self.nn_select, self.target_group = dim_touched, nn_select, target_group
        self.gcn = GeneratorGCN3(gcn_nfeat, gcn_nhid, gcn_nclass, impl=impl, generator=generator)
        self.mlp = MLP3(linear_nin, linear_nhid1, linear_nhid2, linear_nout, generator=generator)

    def forward(self, x: torch.Tensor, graph: Graph) -> torch.Tensor:
        d = self.dim_touched
        scores = self.mlp(torch.cat([self.gcn(x[:, :d], graph), x[:, d:-1]], dim=1))
        scores = torch.where(x[:, -1:] == self.target_group, scores.min(), scores)
        return topk_flag_straight_through(scores, self.nn_select)


class SoftGenerator(nn.Module):
    """Stochastic policy: :class:`GeneratorGCN3`, a pooled key vector
    (:class:`PoolKeyMLP`) and :func:`attention_scores`, a categorical
    distribution ``[N]`` over the nodes. The reference's ``SoftGenerator``
    (``pygcn/models.py:412-436``); the key's width follows ``gcn_nclass``,
    where the reference fixes it at 32 (``:417``)."""

    def __init__(self, gcn_nfeat: int, gcn_nhid: int, gcn_nclass: int, dim_touched: int,
                 nn_select: int, linear_nhid1: int, linear_nhid2: int, impl: str = "auto", *,
                 generator: torch.Generator):
        super().__init__()
        self.dim_touched, self.nn_select = dim_touched, nn_select
        self.gcn = GeneratorGCN3(gcn_nfeat, gcn_nhid, gcn_nclass, impl=impl, generator=generator)
        self.pool_mlp = PoolKeyMLP(gcn_nclass, linear_nhid1, linear_nhid2, generator=generator)

    def forward(self, x: torch.Tensor, graph: Graph) -> torch.Tensor:
        g = self.gcn(x[:, :self.dim_touched], graph)
        return attention_scores(self.pool_mlp(g), g)


class GCNRegressor(nn.Module):
    """:class:`GCN3`, the mean over nodes, then :class:`MLP3`: the factory's
    ``'GCN'`` pipeline as the legacy trainer uses it (reference
    ``pygcn/train.py:147-161``; the factory itself passes six arguments to a
    five-argument constructor, ``pygcn/models.py:444``). ``x [N, F]`` →
    ``[linear_nout]``, or a batch ``[B, N, F]`` → ``[B, linear_nout]``."""

    def __init__(self, gcn_nfeat: int, gcn_nhid: int, gcn_nclass: int, linear_nin: int,
                 linear_nhid1: int, linear_nhid2: int, linear_nout: int = 1,
                 impl: str = "auto", *, generator: torch.Generator):
        super().__init__()
        self.gcn = GCN3(gcn_nfeat, gcn_nhid, gcn_nclass, impl=impl, generator=generator)
        self.mlp = MLP3(linear_nin, linear_nhid1, linear_nhid2, linear_nout, generator=generator)

    def forward(self, x: torch.Tensor, graph: Graph) -> torch.Tensor:
        return self.mlp(self.gcn(x, graph).mean(dim=-2))


class PoolMLPModel(nn.Module):
    """:func:`masked_mean_pool`, then :class:`MLP3`: the factory's ``'MLP'``
    pipeline, the no-GCN baseline (reference ``pygcn/models.py:447-451``,
    used by ``pygcn/mlp.py``). ``x [B, N, F]`` → ``[B, linear_nout]``."""

    def __init__(self, linear_nin: int, linear_nhid1: int, linear_nhid2: int,
                 linear_nout: int = 1, *, generator: torch.Generator):
        super().__init__()
        self.mlp = MLP3(linear_nin, linear_nhid1, linear_nhid2, linear_nout, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(masked_mean_pool(x))


def get_model(config, model_name: str = "GCN", *, generator: torch.Generator) -> nn.Module:
    """Name → model, as the reference's ``get_model``
    (``pygcn/models.py:440-460``), with ``'KipfGCN'`` and the GAT, GATv2,
    SAGE, GIN and APPNP node classifiers besides. ``config`` carries the
    widths (``utils.config.Config``'s names, ``NN`` for the generators)."""
    c = config
    gcn = (c.gcn_nfeat, c.gcn_nhid, c.gcn_nclass)
    mlp = (c.linear_nin, c.linear_nhid1, c.linear_nhid2)
    kw = {"generator": generator}
    if model_name == "GCN":
        return GCNRegressor(*gcn, *mlp, c.linear_nout, **kw)
    if model_name == "MLP":
        return PoolMLPModel(*mlp, c.linear_nout, **kw)
    if model_name == "GNN_OVER_MLP":
        return GCNOverMLP(*gcn, c.dim_touched, *mlp, c.linear_nout, **kw)
    if model_name == "Generator":
        return TopKGenerator(*gcn, c.dim_touched, c.NN, *mlp, c.linear_nout, **kw)
    if model_name == "Hierarchical_Generator":
        return HierarchicalGenerator(*gcn, c.dim_touched, c.NN, *mlp, c.linear_nout, **kw)
    if model_name == "SoftGenerator":
        return SoftGenerator(*gcn, c.dim_touched, c.NN, c.linear_nhid1, c.linear_nhid2, **kw)
    if model_name == "KipfGCN":
        return KipfGCN(*gcn, **kw)
    if model_name in ("GAT", "GATv2"):
        from pygcn_tpu_torch.nn.gat import GAT

        return GAT(*gcn, v2=model_name == "GATv2", **kw)
    if model_name == "SAGE":
        from pygcn_tpu_torch.nn.sage import SAGE

        return SAGE(*gcn, **kw)
    if model_name in ("GIN", "APPNP"):
        from pygcn_tpu_torch.nn import gin

        return getattr(gin, model_name)(*gcn, **kw)
    raise ValueError(f"unknown model {model_name!r}")
