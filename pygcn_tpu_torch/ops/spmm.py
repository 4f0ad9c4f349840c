"""SpMM / SDDMM — the sparse matmul engine.

``spmm(graph, x)`` computes ``A @ x`` with one of five implementations:

- ``"dense"``   — ``torch.mm`` on the densified adjacency (small graphs).
- ``"segment"`` — ``index_select`` over COO senders + ``index_add_`` into
  receivers; the general fallback. Autograd differentiates it directly
  (gather and scatter-add are each other's transpose).
- ``"ell"``     — bucketed ELL (``ops/ell.py``).
- ``"hybrid"``  — BCSR tiles on kernel B1 + ELL residual (``ops/hybrid.py``);
  the auto choice for graphs too large to densify.
- ``"bcsr"``    — kernel B1 alone over ``graph.bcsr`` (``ops/cuda/bcsr_spmm.py``).

The ELL, hybrid and BCSR paths pair the forward with the transpose layout in
an ``autograd.Function``. ``panel``/``colpanel`` are not ported yet.
"""

from __future__ import annotations

import torch

from pygcn_tpu_torch.graph.graph import Graph

_NOT_PORTED = ("panel", "colpanel")


def _transpose_layout(graph: Graph, fwd, t, name: str):
    """The transpose layout for the backward/``spmm_t`` direction.

    A symmetric graph reuses the forward layout. An asymmetric graph must
    carry a prebuilt transpose: reusing the forward layout would compute
    ``A @ g`` where the gradient needs ``A^T @ g`` — wrong, with no error.
    """
    if graph.is_symmetric:
        return t if t is not None else fwd
    if t is None:
        raise ValueError(
            f"asymmetric graph has a forward {name} layout but no transpose "
            f"{name} layout ({name}_t); the backward SpMM would be wrong. "
            f"Build both (Graph.from_coo does) or mark the graph symmetric."
        )
    return t


def _resolve_impl(graph: Graph, impl: str) -> str:
    if impl in _NOT_PORTED:
        raise NotImplementedError(f"spmm impl {impl!r} not ported yet")
    if impl != "auto":
        return impl
    if graph.dense is not None:
        return "dense"
    if graph.hybrid is not None and graph.hybrid_t is not None:
        return "hybrid"
    if graph.ell is not None and graph.ell_t is not None:
        return "ell"
    if graph.bcsr is not None and (graph.is_symmetric or graph.bcsr_t is not None):
        return "bcsr"
    return "segment"


def _fold(fn, graph: Graph, x: torch.Tensor, impl: str) -> torch.Tensor:
    """Run ``fn`` on a batch ``[B, N, H]`` folded into one ``[N, B·H]`` product."""
    b, n, h = x.shape
    out = fn(graph, x.movedim(0, 1).reshape(n, b * h), impl)
    return out.reshape(n, b, h).movedim(1, 0)


def spmm(graph: Graph, x: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """``A @ x`` for ``x`` of shape ``[n_nodes, H]``, ``[n_nodes]`` or ``[B, n_nodes, H]``."""
    if x.dim() == 3:
        return _fold(spmm, graph, x, impl)
    impl = _resolve_impl(graph, impl)
    squeeze = x.dim() == 1
    if squeeze:
        x = x[:, None]
    if impl == "dense":
        if graph.dense is None:
            raise ValueError("graph has no dense layout; build with build_dense=True")
        out = torch.mm(graph.dense, x)
    elif impl == "segment":
        out = _spmm_segment(graph, x, graph.senders, graph.receivers)
    elif impl == "ell":
        if graph.ell is None:
            raise ValueError("graph has no ELL layout; build with build_ell=True")
        from pygcn_tpu_torch.ops.ell import ell_spmm_pair

        out = ell_spmm_pair(graph.ell, _transpose_layout(graph, graph.ell, graph.ell_t, "ell"), x)
    elif impl == "hybrid":
        if graph.hybrid is None:
            raise ValueError("graph has no hybrid layout; build with build_hybrid=True")
        from pygcn_tpu_torch.ops.hybrid import hybrid_spmm_pair

        out = hybrid_spmm_pair(
            graph.hybrid, _transpose_layout(graph, graph.hybrid, graph.hybrid_t, "hybrid"),
            x.contiguous(),
        )
    elif impl == "bcsr":
        if graph.bcsr is None:
            raise ValueError("graph has no BCSR layout; build with build_bcsr=True")
        _transpose_layout(graph, graph.bcsr, graph.bcsr_t, "bcsr")
        from pygcn_tpu_torch.ops.cuda.bcsr_spmm import BCSRSpMM

        out = BCSRSpMM.apply(x, graph, False)
    else:
        raise ValueError(f"unknown spmm impl {impl!r}")
    return out[:, 0] if squeeze else out


def spmm_t(graph: Graph, x: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """``A^T @ x`` — the transpose product (backward direction)."""
    if graph.is_symmetric:
        return spmm(graph, x, impl)
    if x.dim() == 3:
        return _fold(spmm_t, graph, x, impl)
    impl = _resolve_impl(graph, impl)
    if impl in ("ell", "hybrid") and getattr(graph, impl) is None:
        raise ValueError(f"graph has no {impl} layout; build with build_{impl}=True")
    squeeze = x.dim() == 1
    if squeeze:
        x = x[:, None]
    if impl == "dense":
        if graph.dense is None:
            raise ValueError("graph has no dense layout; build with build_dense=True")
        out = torch.mm(graph.dense.T, x)
    elif impl == "segment":
        out = _spmm_segment(graph, x, graph.receivers, graph.senders)
    elif impl == "ell":
        from pygcn_tpu_torch.ops.ell import ell_spmm_pair

        out = ell_spmm_pair(_transpose_layout(graph, graph.ell, graph.ell_t, "ell"), graph.ell, x)
    elif impl == "hybrid":
        from pygcn_tpu_torch.ops.hybrid import hybrid_spmm_pair

        out = hybrid_spmm_pair(
            _transpose_layout(graph, graph.hybrid, graph.hybrid_t, "hybrid"), graph.hybrid,
            x.contiguous(),
        )
    elif impl == "bcsr":
        if graph.bcsr is None or graph.bcsr_t is None:
            raise ValueError("graph has no transpose BCSR layout")
        from pygcn_tpu_torch.ops.cuda.bcsr_spmm import BCSRSpMM

        out = BCSRSpMM.apply(x, graph, True)
    else:
        raise ValueError(f"unknown spmm impl {impl!r}")
    return out[:, 0] if squeeze else out


def _spmm_segment(graph: Graph, x: torch.Tensor, src: torch.Tensor,
                  dst: torch.Tensor) -> torch.Tensor:
    msg = x.index_select(0, src) * graph.weights[:, None]
    out = torch.zeros((graph.n_nodes, x.shape[1]), dtype=msg.dtype, device=x.device)
    return out.index_add(0, dst, msg)


def sddmm(graph: Graph, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per true edge ``(s, r)``: ``<a[r], b[s]>``; ``[E_pad]``, padding entries 0.

    The gradient of ``spmm`` with respect to the edge weights.
    """
    vals = (a.index_select(0, graph.receivers) * b.index_select(0, graph.senders)).sum(-1)
    mask = torch.arange(graph.e_pad, device=vals.device) < graph.n_edges
    return torch.where(mask, vals, torch.zeros_like(vals))
