"""Kipf & Welling's GCN in plain PyTorch: ``h' = Â (h W) + b``, ReLU between
the layers, log-softmax at the end. ``params`` holds the benchmark's leaves
by name (``layers.<i>.weight [in, out]``, ``layers.<i>.bias [out]``);
``matmul`` lets the control run the dense products in a lower precision."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.adjacency import Adjacency, normalized


def adjacency(rows, cols, vals, n: int, device, dtype=torch.float32) -> Adjacency:
    return normalized(rows, cols, vals, n, device, dtype)


def forward(config: dict, params: dict, adj: Adjacency, x: torch.Tensor,
            matmul=torch.matmul) -> torch.Tensor:
    h = x
    n_layers = config["num_layers"]
    for i in range(n_layers):
        h = adj.spmm(matmul(h, params[f"layers.{i}.weight"])) + params[f"layers.{i}.bias"]
        if i < n_layers - 1:
            h = torch.relu(h)
    return F.log_softmax(h, dim=1)
