"""A named mesh of ranks over ``torch.distributed``.

The port of ``pygcn_tpu/parallel/mesh.py``. JAX runs one SPMD program over a
``jax.sharding.Mesh`` of devices; here one process per rank runs the same
program, each on its own device (one card per rank over NCCL, or the CPU
over gloo), and the collectives name the process group of a mesh axis.

Axis conventions, as in the JAX package: ``"graph"`` partitions nodes and
edges (the graph-parallel axis); ``"data"`` batches; ``"model"`` splits
weights; ``"pipe"`` and ``"expert"`` the pipeline and expert axes. Ranks lie
on the mesh in row-major order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def require_devices(n: int, have: int) -> None:
    """Refuse a mesh of ``n`` devices where only ``have`` exist, with the JAX
    package's message."""
    if n > have:
        raise ValueError(f"mesh needs {n} devices, have {have}")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The axes, this rank's coordinates on them, its device and the
    process group of each axis (``None``: the default group)."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    rank: int
    coords: Optional[Tuple[int, ...]]  # None for a rank outside the mesh
    device: torch.device
    groups: Dict[str, object]

    def size(self, axis: str = "graph") -> int:
        return self.shape[self.axis_names.index(axis)]

    def coord(self, axis: str = "graph") -> int:
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str = "graph"):
        return self.groups.get(axis)

    def group_all(self):
        """The process group of every rank of the mesh (``None``: the
        default group)."""
        if "*" in self.groups:
            return self.groups["*"]
        return self.groups.get(self.axis_names[0]) if len(self.shape) == 1 else None


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str] = ("graph",),
              device=None) -> Mesh:
    """A mesh of ``prod(axis_sizes)`` ranks of the default process group
    (one rank, 0, when none is initialised). Raises ``ValueError`` when the
    mesh needs more ranks than there are.

    ``device`` defaults to this rank's current card under NCCL, else the
    CPU. A 1-D mesh over every rank uses
    the default group; any other shape makes one group per line of each axis
    and, for a mesh of several axes on part of the ranks, one of the whole
    mesh (every rank must call this, in the same order, as ``new_group``
    asks)."""
    sizes = tuple(int(s) for s in axis_sizes)
    names = tuple(axis_names)
    if len(sizes) != len(names):
        raise ValueError(f"{len(sizes)} axis sizes for {len(names)} axis names")
    n = int(np.prod(sizes))
    initialised = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialised else 1
    rank = dist.get_rank() if initialised else 0
    require_devices(n, world)
    if device is None:
        nccl = initialised and dist.get_backend() == "nccl"
        device = torch.device("cuda", torch.cuda.current_device()) if nccl else "cpu"
    groups = {}
    if initialised and not (len(sizes) == 1 and n == world):
        ranks = np.arange(n).reshape(sizes)
        for ax, name in enumerate(names):
            for line in np.moveaxis(ranks, ax, -1).reshape(-1, sizes[ax]).tolist():
                group = dist.new_group(ranks=line)
                if rank in line:
                    groups[name] = group
        if len(sizes) > 1 and n < world:
            groups["*"] = dist.new_group(ranks=list(range(n)))
    coords = tuple(int(c) for c in np.unravel_index(rank, sizes)) if rank < n else None
    return Mesh(names, sizes, rank, coords, torch.device(device), groups)
