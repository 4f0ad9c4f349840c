"""Sharded checkpoints over ``torch.distributed.checkpoint`` (DCP): each
rank writes its own rows, saves run in the background, and a restore lands
in a target sharding, on a mesh of another size too (elastic resume: save
on 4 ranks, restore on 2).

The port of ``pygcn_tpu/train/checkpoint_orbax.py`` (``OrbaxCheckpointer``),
with the same small API::

    ckptr = DistCheckpointer(mesh)                  # async by default
    ckptr.save(path, {"params": params, "opt": opt_state, "epoch": epoch})
    state = ckptr.restore(path, like=specs_or_concrete_tree)
    ckptr.wait()                                    # join a pending save

The pickle checkpoints of ``checkpoint.py`` gather everything to one host,
as the reference's ``save_checkpoint_state`` does; this is the scale path.

A tree is a dict of nested dicts and lists whose leaves are:

- a ``DTensor`` sharded along one dimension (``Shard(dim)``) over one axis
  of a port :class:`~pygcn_tpu_torch.parallel.mesh.Mesh`
  (:func:`shard_leaf` builds it from this rank's block); DCP writes each
  rank's block with its offsets, once however many lines of the mesh hold
  it;
- a plain tensor, replicated on every rank of the mesh (written once);
- any other picklable value (an epoch, a learning rate).

Resharding goes through DTensor over ``DeviceMesh.from_group`` of the port
mesh's own process groups: a JAX ``NamedSharding`` maps onto a ``DTensor``
placement, so the sharding travels with the leaf as it does in JAX, and
DCP's planner reads any saved layout into any target one by offsets, with
no gather to one rank. The checkpointer's collectives (DCP's plan
exchange) run on a gloo group of its own, over the mesh's ranks: DCP's
background save needs a CPU backend, and on a group of its own its
collectives cannot interleave with the training step's.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

from pygcn_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """A leaf to restore: its global shape and dtype, and its target
    placement on ``mesh``: split along ``dim`` over ``axis`` (replicated
    over the other axes), or replicated on every rank when ``axis`` is
    ``None``. JAX's ``ShapeDtypeStruct(shape, dtype, sharding=...)``."""

    shape: tuple
    dtype: torch.dtype
    mesh: Mesh
    axis: Optional[str] = None
    dim: int = 0


def device_mesh(mesh: Mesh, axis: str):
    """The 1-D ``DeviceMesh`` of this rank's line of ``axis``."""
    from torch.distributed.device_mesh import DeviceMesh

    group = mesh.group(axis)
    return DeviceMesh.from_group(group if group is not None else dist.group.WORLD,
                                 mesh.device.type)


def _block_rows(n: int, parts: int, i: int) -> int:
    """The rows of block ``i`` of ``n`` rows in ``parts`` blocks,
    ``torch.chunk``'s split (DTensor's ``Shard``): ceil-sized, the last
    ones short or empty."""
    per = -(-n // parts)
    return min(per, n - min(i * per, n))


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def shard_leaf(local: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0,
               shape: Optional[tuple] = None):
    """This rank's block of a leaf split along ``dim`` over ``axis``, as
    the ``DTensor`` of the whole leaf (``shape``: the global shape; by
    default ``local``'s with ``dim`` times the axis's size). The blocks
    must follow ``torch.chunk``'s split. Without a process group, the
    block is the whole leaf and stays a plain tensor."""
    if not dist.is_initialized():
        return local
    from torch.distributed.tensor import DTensor, Shard

    if shape is None:
        shape = list(local.shape)
        shape[dim] *= mesh.size(axis)
    shape = tuple(shape)
    return DTensor.from_local(local, device_mesh(mesh, axis), [Shard(dim)], run_check=False,
                              shape=torch.Size(shape), stride=_contiguous_stride(shape))


def _empty_leaf(spec: ShardSpec):
    if spec.axis is None or not dist.is_initialized():
        return torch.empty(spec.shape, dtype=spec.dtype, device=spec.mesh.device)
    local_shape = list(spec.shape)
    local_shape[spec.dim] = _block_rows(spec.shape[spec.dim], spec.mesh.size(spec.axis),
                                        spec.mesh.coord(spec.axis))
    local = torch.empty(local_shape, dtype=spec.dtype, device=spec.mesh.device)
    return shard_leaf(local, spec.mesh, spec.axis, spec.dim, spec.shape)


def _like_leaf(x):
    """An empty leaf with ``x``'s global shape, dtype and placement (a
    ``ShardSpec``, a ``DTensor``, a tensor), or ``x`` itself (a value DCP
    replaces on load)."""
    if isinstance(x, ShardSpec):
        return _empty_leaf(x)
    if isinstance(x, torch.Tensor):
        from torch.distributed.tensor import DTensor

        if isinstance(x, DTensor):
            return DTensor.from_local(torch.empty_like(x.to_local()), x.device_mesh,
                                      x.placements, run_check=False, shape=x.shape,
                                      stride=x.stride())
        return torch.empty_like(x)
    return x


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


def _unflatten(flat: dict, paths: dict) -> dict:
    """DCP's flat ``{fqn: value}`` back into nested dicts and lists, by the
    key paths its metadata keeps."""
    tree: dict = {}
    for fqn, value in flat.items():
        path = paths.get(fqn, (fqn,))
        node = tree
        for key, nxt in zip(path[:-1], path[1:]):
            if isinstance(node, list):
                while len(node) <= key:
                    node.append(None)
                if node[key] is None:
                    node[key] = [] if isinstance(nxt, int) else {}
                node = node[key]
            else:
                node = node.setdefault(key, [] if isinstance(nxt, int) else {})
        if isinstance(node, list):
            while len(node) <= path[-1]:
                node.append(None)
        node[path[-1]] = value
    return tree


def state_tree(model, optimizer=None, mesh: Optional[Mesh] = None, axis: Optional[str] = None,
               split_dims=None) -> dict:
    """A model's parameters by name and, with ``optimizer``, each one's
    optimizer state (Adam's ``exp_avg``, ``exp_avg_sq``, ``step``), copied
    into a checkpoint tree ``{"params": ..., "opt": ...}``. ``split_dims``
    (per parameter, in ``parameters()``' order: the dimension split over
    ``axis`` of ``mesh``, or ``None``; e.g. ``TPDistGCN.split_dims()``)
    makes the split parameters, and their state of the same shape,
    ``DTensor``s over that axis; the rest stay replicated."""
    names = [k for k, _ in model.named_parameters()]
    dims = dict(zip(names, split_dims if split_dims is not None else [None] * len(names)))

    def leaf(name, t, like):
        t = t.detach().clone()
        if dims[name] is None or t.shape != like.shape:
            return t
        return shard_leaf(t, mesh, axis, dims[name])

    tree = {"params": {k: leaf(k, p, p) for k, p in model.named_parameters()}}
    if optimizer is not None:
        tree["opt"] = {k: {s: leaf(k, v, p) for s, v in optimizer.state[p].items()}
                       for k, p in model.named_parameters()}
    return tree


def load_state_tree(model, tree: dict, optimizer=None) -> None:
    """Copy a restored :func:`state_tree` into ``model`` (this rank's blocks
    of the split leaves) and, with ``optimizer``, into its state."""
    from torch.distributed.tensor import DTensor

    def local(t):
        return t.to_local() if isinstance(t, DTensor) else t

    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(local(tree["params"][name]))
            if optimizer is not None:
                optimizer.state[p] = {s: local(v).clone()
                                      for s, v in tree["opt"][name].items()}


class DistCheckpointer:
    """DCP save and restore over the ranks of ``mesh`` (``None``: every rank
    of the default group; without a process group, this process alone).

    Every rank of the default group constructs it, in the same order (it
    makes a process group, as ``make_mesh`` does); every rank of ``mesh``
    calls :meth:`save` and :meth:`restore`. ``async_save=True`` (the
    default) returns from ``save`` once the leaves are copied to host
    memory, the files written in a background thread; call :meth:`wait`
    before reading the checkpoint elsewhere or exiting. A new save waits
    for the pending one first."""

    def __init__(self, mesh: Optional[Mesh] = None, async_save: bool = True):
        self.async_save = async_save
        self._pending = None
        self._group = None
        if dist.is_initialized():
            n = dist.get_world_size() if mesh is None else math.prod(mesh.shape)
            self._group = dist.new_group(list(range(n)), backend="gloo")

    @property
    def _no_dist(self) -> bool:
        return self._group is None

    def save(self, path: str, tree: dict) -> None:
        """Save a dict of (possibly sharded) leaves at ``path`` (a
        directory; an existing checkpoint there is overwritten)."""
        import torch.distributed.checkpoint as dcp

        self.wait()
        kw = dict(storage_writer=dcp.FileSystemWriter(os.path.abspath(path), overwrite=True),
                  process_group=self._group, no_dist=self._no_dist)
        if self.async_save:
            res = dcp.async_save(dict(tree), **kw)
            self._pending = getattr(res, "upload_completion", res)
        else:
            dcp.save(dict(tree), **kw)

    def restore(self, path: str, like: Optional[Any] = None) -> dict:
        """Restore; ``like`` gives each leaf's global shape, dtype and target
        placement: a tree of :class:`ShardSpec` (the mesh may differ from
        the saving run's) or a concrete tree of the kind saved. With
        ``like=None`` every leaf comes back whole, on the CPU."""
        import torch.distributed.checkpoint as dcp

        self.wait()
        path = os.path.abspath(path)
        if like is None:
            meta = dcp.FileSystemReader(path).read_metadata()
            flat = {fqn: (torch.empty(tuple(m.size), dtype=m.properties.dtype)
                          if hasattr(m, "size") else None)
                    for fqn, m in meta.state_dict_metadata.items()}
            dcp.load(flat, checkpoint_id=path, process_group=self._group,
                     no_dist=self._no_dist)
            return _unflatten(flat, meta.planner_data or {})
        target = _map_tree(_like_leaf, like)
        dcp.load(target, checkpoint_id=path, process_group=self._group, no_dist=self._no_dist)
        return target

    def wait(self) -> None:
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def close(self) -> None:
        self.wait()
