"""Distributed SAGE and APPNP over the graph axis.

The port of ``pygcn_tpu/parallel/dist_sage.py``. Their layers are the
single-device models' (``nn/sage.SAGEConv``, ``nn/gin.MLP2``), so the state
dicts and, from one generator, the weights are those of ``nn.sage.SAGE`` and
``nn.gin.APPNP``:

- :class:`DistSAGE`: the self transform ``x @ W_self`` is shard-local (no
  communication); only the neighbour aggregation rides the halo exchange.
- :class:`DistAPPNP`: the MLP is shard-local; the K personalised-PageRank
  steps (JAX's ``lax.scan``) are a loop of K distributed SpMMs, so a
  training step runs K halo exchanges forward and K back.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from pygcn_tpu_torch.nn.gin import MLP2
from pygcn_tpu_torch.nn.sage import SAGEConv
from pygcn_tpu_torch.parallel.dist_spmm import DistModule, seeded
from pygcn_tpu_torch.parallel.mesh import Mesh


class DistSAGE(DistModule):
    """2-layer SAGE-mean classifier; parameters as ``nn.sage.SAGE``'s."""

    def __init__(self, mesh: Mesh, plan, nfeat: int, nhid: int, nclass: int,
                 axis: str = "graph", *, generator: Optional[torch.Generator] = None):
        super().__init__(mesh, plan, axis)
        g = seeded(generator)
        self.sage1 = SAGEConv(nfeat, nhid, generator=g)
        self.sage2 = SAGEConv(nhid, nclass, generator=g)

    def _layer(self, conv: SAGEConv, h: torch.Tensor) -> torch.Tensor:
        return h @ conv.w_self + self.spmm(h) @ conv.w_nb + conv.b

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self._layer(self.sage1, x))
        return F.log_softmax(self._layer(self.sage2, h), dim=1)


class DistAPPNP(DistModule):
    """Predict-then-propagate classifier; parameters as ``nn.gin.APPNP``'s."""

    def __init__(self, mesh: Mesh, plan, nfeat: int, nhid: int, nclass: int, k: int = 10,
                 alpha: float = 0.1, axis: str = "graph", *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(mesh, plan, axis)
        self.mlp = MLP2(nfeat, nhid, nclass, generator=seeded(generator))
        self.k, self.alpha = k, alpha

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.mlp(x)
        z = h
        for _ in range(self.k):
            z = (1.0 - self.alpha) * self.spmm(z) + self.alpha * h
        return F.log_softmax(z, dim=1)
