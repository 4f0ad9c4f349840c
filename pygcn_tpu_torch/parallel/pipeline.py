"""Pipeline parallelism: GPipe microbatch streaming over a ``pipe`` axis.

The port of ``pygcn_tpu/parallel/pipeline.py``. Rank ``d`` of the ``pipe``
line holds ``L`` consecutive stages (stage grouping: ``L·S`` stages on
``S`` ranks) and runs microbatch ``m`` at tick ``m + d``: it receives the
microbatch from rank ``d - 1`` (rank 0 takes it from the input), runs its
stages and sends the result to rank ``d + 1``; the last rank keeps it. All
``M`` microbatches leave the pipe after ``M + S - 1`` ticks, the GPipe
schedule with its ``(S - 1) / (M + S - 1)`` fill and drain.

JAX runs every tick on every device under one ``lax.scan`` with a cyclic
``ppermute`` (``pipeline.py:84``) and gets the reverse schedule from
transposing them. Here the ``ppermute`` is point-to-point ``isend``/``recv``
inside one autograd function, :class:`_GPipe`, whose backward is the
reverse schedule written out: microbatches in reverse order, each rank
receiving its outputs' gradient from rank ``d + 1``, running its stages'
backward and sending its inputs' gradient to rank ``d - 1``. A rank
computes only its live ticks (JAX also computes fill and drain ticks whose
results it drops). The order of the point-to-point calls is the same on
every rank, as NCCL needs.

The output, JAX's last stage's block on every device, is broadcast from
the last rank. Under ``dist_spmm.py``'s convention (every rank holds the
whole loss) the broadcast's backward takes the last rank's gradient alone,
and the input's gradient, which only rank 0's stages produce, is broadcast
from rank 0: so the replicated layers around the pipe (``pre`` and
``head`` of :class:`PipelinedDeepGCN`) get their whole gradient on every
rank and need no reduction.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from pygcn_tpu_torch.nn import init as tinit
from pygcn_tpu_torch.parallel.mesh import Mesh


def stack_stage_params(stage_params: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Stack S per-stage dicts (same keys and shapes) on a new leading axis."""
    return {k: torch.stack([torch.as_tensor(p[k]) for p in stage_params])
            for k in stage_params[0]}


def local_stages(stacked: Dict[str, torch.Tensor], mesh: Mesh, axis: str = "pipe"):
    """This rank's ``L`` consecutive stages of the whole stack (leaves
    ``[L·S, ...]`` → ``[L, ...]``); the stage count must be a multiple of
    the axis's size ``S``."""
    s = mesh.size(axis)
    n = next(iter(stacked.values())).shape[0]
    if n % s:
        raise ValueError(f"stacked stage count {n} must be a multiple of the '{axis}' mesh "
                         f"axis size {s}")
    per, d = n // s, mesh.coord(axis)
    return {k: v[d * per:(d + 1) * per] for k, v in stacked.items()}


def _global_rank(group, i: int) -> int:
    return dist.get_global_rank(group, i) if group is not None else i


class _GPipe(torch.autograd.Function):
    """``(x [M, mb, ...], *leaves) -> y [M, mb, ...]`` through every stage
    of the pipe; ``leaves`` are this rank's stacked parameters, in
    ``keys``' order."""

    @staticmethod
    def forward(ctx, pipe, keys, x, *leaves):
        d, s, group = pipe.coord, pipe.size, pipe.group
        params = dict(zip(keys, leaves))
        inputs, outputs = [], []
        y = torch.empty_like(x)
        sends = []
        for m in range(x.shape[0]):
            if d == 0:
                h = x[m].detach()
            else:
                h = torch.empty_like(x[m])
                dist.recv(h, _global_rank(group, d - 1), group=group)
            h.requires_grad_(True)
            with torch.enable_grad():
                out = pipe.run_stages(params, h)
            inputs.append(h)
            outputs.append(out)
            if d < s - 1:
                sends.append(dist.isend(out.detach().contiguous(), _global_rank(group, d + 1),
                                        group=group))
            else:
                y[m] = out.detach()
        for w in sends:
            w.wait()
        if s > 1:
            dist.broadcast(y, _global_rank(group, s - 1), group=group)
        ctx.pipe, ctx.leaves = pipe, leaves
        ctx.inputs, ctx.outputs = inputs, outputs
        return y

    @staticmethod
    def backward(ctx, gy):
        pipe = ctx.pipe
        d, s, group = pipe.coord, pipe.size, pipe.group
        leaves = ctx.leaves
        grads = [torch.zeros_like(p) for p in leaves]
        gx = torch.zeros_like(gy)
        sends = []
        for m in reversed(range(len(ctx.outputs))):
            out = ctx.outputs[m]
            if d == s - 1:
                g = gy[m].contiguous()
            else:
                g = torch.empty_like(out)
                dist.recv(g, _global_rank(group, d + 1), group=group)
            need = [ctx.inputs[m]] + [p for p in leaves if p.requires_grad]
            got = iter(torch.autograd.grad(out, need, g, allow_unused=True))
            g_in = next(got)
            for i, p in enumerate(leaves):
                if p.requires_grad:
                    gp = next(got)
                    if gp is not None:
                        grads[i] += gp
            if g_in is None:
                g_in = torch.zeros_like(ctx.inputs[m])
            if d > 0:
                sends.append(dist.isend(g_in.contiguous(), _global_rank(group, d - 1),
                                        group=group))
            else:
                gx[m] = g_in
        for w in sends:
            w.wait()
        ctx.inputs = ctx.outputs = None
        if not ctx.needs_input_grad[2]:  # the same on every rank: x is replicated
            return (None, None, None, *grads)
        if s > 1:
            dist.broadcast(gx, _global_rank(group, 0), group=group)
        return (None, None, gx, *grads)


class _Pipe:
    """What :class:`_GPipe` needs of the mesh and the stage function."""

    def __init__(self, mesh: Mesh, stage_fn: Callable, axis: str):
        self.stage_fn = stage_fn
        self.size = mesh.size(axis)
        self.coord = mesh.coord(axis)
        self.group = mesh.group(axis)
        if self.size > 1 and not dist.is_initialized():
            raise ValueError(f"a '{axis}' axis of {self.size} ranks needs a process group")

    def run_stages(self, params: Dict[str, torch.Tensor], h: torch.Tensor) -> torch.Tensor:
        n_local = next(iter(params.values())).shape[0]
        for j in range(n_local):
            h = self.stage_fn({k: v[j] for k, v in params.items()}, h)
        return h


def make_gpipe(mesh: Mesh, stage_fn: Callable, axis: str = "pipe"):
    """Build ``apply(local_params, x) -> y`` running the stages over ``axis``.

    - ``stage_fn(params, h) -> h`` preserves ``h``'s shape and dtype
      (homogeneous stages); ``params`` is one stage's dict of tensors.
    - ``local_params``: this rank's ``L`` consecutive stages, each leaf
      ``[L, ...]`` (:func:`local_stages` of :func:`stack_stage_params`,
      which refuses a stage count that is not a multiple of the axis).
    - ``x``: ``[M, mb, ...]`` microbatches, the same on every rank.
    - returns ``[M, mb, ...]`` on every rank: each microbatch through all
      ``L·S`` stages in order, the same as ``for p in stages: h =
      stage_fn(p, h)``. Every rank of the axis calls it, with the same
      ``M``."""
    pipe = _Pipe(mesh, stage_fn, axis)

    def apply(local_params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        keys = tuple(local_params)
        return _GPipe.apply(pipe, keys, x, *(local_params[k] for k in keys))

    return apply


class PipelinedDeepGCN(nn.Module):
    """Deep GCN with its ``H -> H`` middle layers pipeline-parallel.

    ``pre`` (``F -> H``) and ``head`` (``H -> C``) GraphConv layers run
    replicated; the ``n_stages`` middle layers (default one per ``pipe``
    rank; a multiple of it groups them) stream microbatches. The adjacency
    is dense ``[N, N]`` and replicated; its products stay ``torch.matmul``,
    as JAX's are plain XLA. Batch semantics are per-sample GCN over a
    shared graph (the evaluator's inner loop).

    Parameters, under JAX's names: ``pre.w``, ``pre.b``, ``stages.w``
    (this rank's ``[L, H, H]``), ``stages.b`` (``[L, H]``), ``head.w``,
    ``head.b``. From one generator: the whole model's layers in order
    (``pre``, every stage, ``head``; each weight then its bias, with
    GraphConv's bounds), each rank keeping its stages."""

    def __init__(self, mesh: Mesh, adj, f_in: int, hidden: int, n_out: int,
                 axis: str = "pipe", n_stages: Optional[int] = None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mesh, self.axis = mesh, axis
        self.n_stages = mesh.size(axis) if n_stages is None else int(n_stages)
        self.f_in, self.hidden, self.n_out = f_in, hidden, n_out
        self.register_buffer("adj", torch.as_tensor(adj, dtype=torch.float32), persistent=False)
        g = generator if generator is not None else torch.Generator().manual_seed(0)

        def layer(fi, fo):
            return {"w": tinit.graphconv_weight(fi, fo, g), "b": tinit.graphconv_bias(fo, g)}

        pre = layer(f_in, hidden)
        stages = stack_stage_params([layer(hidden, hidden) for _ in range(self.n_stages)])
        head = layer(hidden, n_out)
        self.pre = nn.ParameterDict(pre)
        self.stages = nn.ParameterDict(local_stages(stages, mesh, axis))
        self.head = nn.ParameterDict(head)
        self._gpipe = make_gpipe(mesh, self._stage, axis)
        self.to(mesh.device)

    def _conv(self, p, h: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.adj, h @ p["w"]) + p["b"]

    def _stage(self, p, h: torch.Tensor) -> torch.Tensor:  # h: [mb, N, H]
        return torch.relu(self._conv(p, h))

    def forward(self, x: torch.Tensor, microbatch: int) -> torch.Tensor:
        """``x``: ``[B, N, F]`` with ``B % microbatch == 0`` → ``[B, N, n_out]``."""
        b, n, _ = x.shape
        if b % microbatch:
            raise ValueError(f"batch {b} not divisible by microbatch {microbatch}")
        h = torch.relu(self._conv(self.pre, x))
        mbs = h.reshape(b // microbatch, microbatch, n, self.hidden)
        h = self._gpipe(dict(self.stages), mbs).reshape(b, n, self.hidden)
        return self._conv(self.head, h)

    def forward_unpipelined(self, x: torch.Tensor) -> torch.Tensor:
        """The same model as a plain loop over this rank's stages (at a
        ``pipe`` axis of one rank: every stage), for reference."""
        h = torch.relu(self._conv(self.pre, x))
        for j in range(self.stages["w"].shape[0]):
            h = self._stage({k: v[j] for k, v in self.stages.items()}, h)
        return self._conv(self.head, h)
