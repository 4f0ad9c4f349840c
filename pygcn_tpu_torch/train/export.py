"""AOT model export for serving — ``torch.export`` artifacts.

The port of ``pygcn_tpu/train/export.py``. The reference ships trained
models by pickling the whole torch module (``gnn-over-mlp.py:489``) and
unpickling it in the policy scripts — which requires the exact model code at
load time. The serving artifact here is instead the *traced program*:
``torch.export`` captures a module's forward (its weights, and whatever it
holds as buffers — the serving forward holds the dense adjacency) as an
ATen graph whose bytes reload and execute WITHOUT any ``pygcn_tpu_torch``
model code. Shapes are static (fixed serving batch), so the loaded program
never changes shape per request.

Two differences from the JAX artifact: it holds tensors on the device it
was exported on (there is no counterpart of ``jax.export``'s
``platforms=``), and only a forward that ``torch.export`` can trace exports —
a graph convolution on ``impl="bcsr"`` calls kernel B1 through ctypes and is
refused (:func:`export_forward`), as is a forward that syncs to the host.
"""

from __future__ import annotations

import io
import pickle
from typing import Any, Callable, Sequence

import torch

from pygcn_tpu_torch.train.checkpoint import load_plain_pickle

MAGIC = "pygcn_tpu_torch-export-v1"
# graph-convolution routes that trace: torch.mm on the dense adjacency
TRACEABLE_IMPLS = ("auto", "dense")


def export_forward(module: torch.nn.Module, example_args: Sequence) -> bytes:
    """Serialize ``module``'s forward traced at ``example_args`` (tensors on
    the device to serve on) to ``torch.export.save`` bytes. Raises
    ``ValueError`` for a module with a graph convolution on a layout other
    than the dense one."""
    untraceable = sorted({m.impl for m in module.modules()
                          if isinstance(getattr(m, "impl", None), str)
                          and m.impl not in TRACEABLE_IMPLS})
    if untraceable:
        raise ValueError(
            f"cannot export a forward on impl={untraceable}: those layouts run hand-written "
            "CUDA kernels through ctypes, which torch.export cannot trace; export the "
            "dense route (impl='dense' or 'auto' on a graph with a dense layout)")
    program = torch.export.export(module, tuple(example_args))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def deserialize_forward(blob: bytes) -> Callable:
    """Rehydrate a serialized forward; returns a callable of the original
    example-arg structure — a module of ATen calls, no model source needed."""
    return torch.export.load(io.BytesIO(blob)).module()


def save_artifact(path: str, module: torch.nn.Module, example_args: Sequence,
                  meta: dict | None = None) -> None:
    """Write a self-contained serving artifact: the exported program and
    metadata, in one pickle of plain types."""
    blob = export_forward(module, example_args)
    with open(path, "wb") as f:
        pickle.dump({"magic": MAGIC, "program": blob, "meta": meta or {}}, f)


def load_artifact(path: str) -> tuple[Callable, dict[str, Any]]:
    """Load a serving artifact → (callable, meta)."""
    d = load_plain_pickle(path)
    if not isinstance(d, dict) or d.get("magic") != MAGIC:
        raise ValueError(f"{path} is not a pygcn_tpu_torch export artifact")
    return deserialize_forward(d["program"]), d["meta"]
