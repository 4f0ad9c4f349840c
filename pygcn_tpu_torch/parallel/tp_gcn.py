"""Tensor-parallel GCN over a 2-D ``graph × model`` mesh.

The port of ``pygcn_tpu/parallel/tp_gcn.py``. Weights are split
Megatron-style in column/row pairs while activations stay row-sharded over
``"graph"`` (each rank its ``[S, ·]`` block, through the halo-exchange SpMM
of ``dist_spmm.py``):

- **col layer** (even): rank ``c`` of the model line holds ``W[:, c·H/tp:
  (c+1)·H/tp]`` and that slice of the bias. The local product gives a
  column-sharded activation with no communication, and the SpMM runs on the
  column shard (every step of it is column-wise independent, so the halo
  exchange moves only ``H/tp`` columns).
- **row layer** (odd): rank ``c`` holds ``W[c·H/tp:(c+1)·H/tp, :]`` and the
  whole bias. The SpMM runs on the column-sharded input, the product
  contracts this rank's rows, and one all-reduce over the model line makes
  the activation replicated; the bias follows.
- The last layer keeps a replicated weight: ``rowfull`` after a col layer
  (the row layer's shape, each rank multiplying by its rows of the whole
  weight), ``full`` otherwise (the SpMM on replicated columns).

JAX's GSPMD derives the backward; here the two collectives carry it
(``dist_spmm.py``'s convention: every rank of the model line holds the
whole loss). A col layer's input passes through Megatron's ``f`` (identity
forward, all-reduce backward), the row layer's all-reduce is ``g``
(identity backward), and the ``rowfull`` weight's rows are taken by
``split_to_group``, whose backward gathers every rank's row block, so the
replicated weight gets its whole gradient on every rank. Replicated biases
get theirs whole and are not summed. :func:`make_dist_classifier_step`
then trains it unchanged: its all-reduce runs over the ``graph`` line only.
Clipping by the global norm: :meth:`TPDistGCN.clip_grad_norm_`, which that
step calls when the optimizer clips.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from pygcn_tpu_torch.nn import init as tinit
from pygcn_tpu_torch.parallel.dist_spmm import (DistModule, copy_to_group, reduce_from_group,
                                                seeded, split_to_group)
from pygcn_tpu_torch.parallel.mesh import Mesh


def tp_modes(n_layers: int) -> List[str]:
    """Each layer's mode: ``col``/``row`` alternate; the last layer is
    ``rowfull`` after a col layer, ``full`` otherwise."""
    return [("col" if i % 2 == 0 else "row") if i < n_layers - 1 else
            ("rowfull" if i % 2 == 1 else "full") for i in range(n_layers)]


def shard_layer(w: torch.Tensor, b: torch.Tensor, mode: str, coord: int, tp: int):
    """The whole layer ``(w [F, H], b [H])`` → what model rank ``coord`` of
    ``tp`` holds in ``mode``."""
    if mode == "col":
        k = w.shape[1] // tp
        return w[:, coord * k:(coord + 1) * k], b[coord * k:(coord + 1) * k]
    if mode == "row":
        k = w.shape[0] // tp
        return w[coord * k:(coord + 1) * k], b
    return w, b


class _Layer(nn.Module):
    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.weight = nn.Parameter(w.contiguous())
        self.bias = nn.Parameter(b.contiguous())


class TPDistGCN(DistModule):
    """N-layer GCN with tensor-parallel weights over ``graph × model``:
    ``dims = [f_in, h1, ..., f_out]``, ReLU between layers and an optional
    ``final_activation``. Hidden widths that a col layer splits must divide
    by the model axis's size.

    The weights come from one generator in :class:`DistGCN`'s order (each
    layer's weight, then its bias), and each rank keeps its share, so one
    seed gives the same model at any TP degree; at TP = 1 the state dicts
    (``layers.<i>.weight``, ``layers.<i>.bias``) are :class:`DistGCN`'s.
    :meth:`forward` takes this rank's ``[S, f_in]`` rows (:meth:`shard_x`)
    and returns its ``[S, f_out]`` rows, the same on every rank of its
    model line."""

    def __init__(self, mesh: Mesh, plan, dims: Sequence[int],
                 final_activation: Optional[Callable] = None, axis_graph: str = "graph",
                 axis_model: str = "model", *, generator: Optional[torch.Generator] = None):
        super().__init__(mesh, plan, axis_graph)
        self.axis_model = axis_model
        self.dims = list(dims)
        self.final_activation = final_activation
        tp, c = mesh.size(axis_model), mesh.coord(axis_model)
        self.modes = tp_modes(len(self.dims) - 1)
        for i, mode in enumerate(self.modes):
            if mode == "col" and self.dims[i + 1] % tp != 0:
                raise ValueError(f"layer {i} output dim {self.dims[i + 1]} not divisible by "
                                 f"model-axis size {tp}")
        g = seeded(generator)
        layers = []
        for (fi, fo), mode in zip(zip(self.dims[:-1], self.dims[1:]), self.modes):
            w = tinit.graphconv_weight(fi, fo, g)
            layers.append(_Layer(*shard_layer(w, tinit.graphconv_bias(fo, g), mode, c, tp)))
        self.layers = nn.ModuleList(layers)
        self.to(mesh.device)

    @property
    def model_group(self):
        return self.mesh.group(self.axis_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        group = self.model_group
        h = x
        for i, (layer, mode) in enumerate(zip(self.layers, self.modes)):
            if mode == "col":
                h = self.spmm(copy_to_group(h, group) @ layer.weight) + layer.bias
            elif mode == "row":
                h = reduce_from_group(self.spmm(h) @ layer.weight, group) + layer.bias
            elif mode == "rowfull":
                rows = split_to_group(layer.weight, group)
                h = reduce_from_group(self.spmm(h) @ rows, group) + layer.bias
            else:
                h = self.spmm(h @ layer.weight) + layer.bias
            if i < len(self.layers) - 1:
                h = torch.relu(h)
            elif self.final_activation is not None:
                h = self.final_activation(h)
        return h

    def split_dims(self) -> List[Optional[int]]:
        """Per parameter, in ``parameters()``' order: the dimension split
        over the model axis (a col layer's weight 1 and bias 0, a row
        layer's weight 0), ``None`` for a replicated one."""
        split = {"col": [1, 0], "row": [0, None]}
        return [d for mode in self.modes for d in split.get(mode, [None, None])]

    @torch.no_grad()
    def clip_grad_norm_(self, max_norm: float) -> torch.Tensor:
        """Scale every ``.grad`` by ``max_norm / (norm + 1e-6)`` when that is
        below 1, ``norm`` the global norm of the whole model's gradient:
        the shards' squares summed over the model line, the replicated
        leaves counted once (``clip_grad_norm_``'s rule on the global
        tree). Returns the norm. Every rank of the model line calls it."""
        params = list(self.parameters())
        sq = {split: torch.zeros((), device=params[0].device) for split in (True, False)}
        for p, dim in zip(params, self.split_dims()):
            if p.grad is not None:
                sq[dim is not None] = sq[dim is not None] + p.grad.float().pow(2).sum()
        if dist.is_initialized():
            dist.all_reduce(sq[True], op=dist.ReduceOp.SUM, group=self.model_group)
        norm = (sq[True] + sq[False]).sqrt()
        coef = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
        for p in params:
            if p.grad is not None:
                p.grad.mul_(coef.to(p.grad.dtype))
        return norm
