"""Traffic generators: one module per mix family, named by a mix file's
``"generator"`` key. Each has ``graph(mix)`` (host, from the mix's fixed
``graph_seed``) and ``node_data(mix, aux, n_features, n_classes, seed,
device)`` (on the device, from ``--seed``)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class NodeData:
    """A run's node inputs in the generator's ids: features ``[N, F]``
    float32, labels ``[N]`` int64 and the training mask ``[N]`` float32."""

    x: torch.Tensor
    labels: torch.Tensor
    mask: torch.Tensor


def train_mask(mix: dict, n: int, n_classes: int, gen: torch.Generator, device) -> torch.Tensor:
    """A float mask of exactly ``max(n_classes, int(n * train_frac))`` nodes,
    drawn from ``gen``: every seed trains on as many nodes."""
    n_train = max(n_classes, int(n * mix["train_frac"]))
    mask = torch.zeros(n, device=device)
    mask[torch.randperm(n, generator=gen, device=device)[:n_train]] = 1.0
    return mask
