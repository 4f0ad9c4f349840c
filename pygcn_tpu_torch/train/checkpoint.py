"""Checkpoints: parameters, Adam state and scheduler state in one file.

The port of ``pygcn_tpu/train/checkpoint.py`` (the reference's
``save_checkpoint_state``/``get_checkpoint_state``, ``pygcn/utils.py:458-478``):
one pickle of ``{"format", "epoch", "params", "opt_state",
"scheduler_state"}`` plus an optional ``"extra"`` slot for loop state. The
JAX package pickles optax's state classes, which only a process with JAX can
read; this format holds nothing but dicts, lists, strings, ints, floats,
``None`` and NumPy arrays, so any process with NumPy reads it:

- ``params``: the JAX-shaped tree of the model's weights
  (``convert.state_dict_to_evaluator_params``: ``{"gcn": {"gc1": {"w",
  "b"}}, ...}``);
- ``opt_state``: torch Adam's state as ``{"step", "exp_avg", "exp_avg_sq",
  "lr"}``, the two moments as trees of the same shape.

:func:`load_checkpoint` refuses any pickled class outside NumPy, so reading
a file never imports another framework. Files are written to a temporary
name and renamed, so a crash mid-write leaves the last complete one.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict

import torch

from pygcn_tpu_torch.convert import (
    evaluator_leaf_key,
    evaluator_params_to_state_dict,
    state_dict_to_evaluator_params,
    tree_to_state_dict,
)

FORMAT = "pygcn_tpu_torch/1"


class _PlainUnpickler(pickle.Unpickler):
    """Unpickles plain types and NumPy arrays; refuses every other class."""

    def find_class(self, module, name):
        if module.split(".")[0] == "numpy":
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"refusing {module}.{name}: a port checkpoint or evaluator.pkl holds only "
            "dicts, numbers, strings and NumPy arrays")


def load_plain_pickle(path: str):
    """Read a pickle of plain types and NumPy arrays (a checkpoint, an
    ``evaluator.pkl``); raises ``pickle.UnpicklingError`` on anything else."""
    with open(path, "rb") as f:
        return _PlainUnpickler(f).load()


def save_checkpoint_state(
    params,
    epoch: int,
    opt_state,
    scheduler_state: Dict[str, Any],
    savepath: str,
    *,
    extra: Dict[str, Any] | None = None,
) -> None:
    """``extra`` is an explicit top-level slot for loop state beyond the
    reference's four fields (best-metric watermarks, early-stop counters):
    consumers check for the key, never sniff ``scheduler_state``."""
    payload = {
        "format": FORMAT,
        "epoch": int(epoch),
        "params": params,
        "opt_state": opt_state,
        "scheduler_state": scheduler_state,
    }
    if extra is not None:
        payload["extra"] = extra
    tmp = savepath + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, savepath)


def get_checkpoint_state(path: str):
    """Returns ``(params, epoch, opt_state, scheduler_state)``."""
    payload = load_checkpoint(path)
    return (payload["params"], payload["epoch"], payload["opt_state"],
            payload["scheduler_state"])


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The full payload, the optional ``extra`` slot included (absent: a
    best-metric checkpoint). Raises ``ValueError`` for a file of another
    format (a JAX checkpoint is refused while it is read)."""
    payload = load_plain_pickle(path)
    if not isinstance(payload, dict) or payload.get("format") != FORMAT:
        raise ValueError(f"{path} is not a checkpoint of format {FORMAT!r}")
    return payload


def model_params(model: torch.nn.Module) -> dict:
    """The model's weights as the JAX-shaped tree of NumPy arrays."""
    return state_dict_to_evaluator_params(model.state_dict())


def load_model_params(model: torch.nn.Module, params) -> None:
    """Copy a JAX-shaped tree (:func:`model_params`) into the model."""
    model.load_state_dict(evaluator_params_to_state_dict(params))


def load_evaluator(path: str, device, impl: str = "auto"):
    """``(evaluator, record)``: the frozen ``GCNOverMLP`` of an
    ``evaluator.pkl`` (either package's ``train_evaluator``: both keep
    ``params`` as the JAX-shaped tree) on ``device``, its graph convolutions
    on ``impl``, and the file's record."""
    from pygcn_tpu_torch.nn.models import GCNOverMLP

    ev = load_plain_pickle(path)
    evaluator = GCNOverMLP(**ev["model_config"], impl=impl,
                           generator=torch.Generator().manual_seed(0))
    load_model_params(evaluator, ev["params"])
    return evaluator.to(device).requires_grad_(False), ev


def _named_params(opt: torch.optim.Optimizer, model: torch.nn.Module):
    names = {p: name for name, p in model.named_parameters()}
    return [(names[p], p) for group in opt.param_groups for p in group["params"]]


def adam_state(opt: torch.optim.Optimizer, model: torch.nn.Module) -> dict:
    """``{"step", "exp_avg", "exp_avg_sq", "lr"}`` of a torch Adam over
    ``model``'s parameters; the moments as JAX-shaped trees (zeros before
    the first step)."""
    named = _named_params(opt, model)
    moments = {}
    step = 0
    for key in ("exp_avg", "exp_avg_sq"):
        moments[key] = state_dict_to_evaluator_params({
            name: opt.state[p][key] if p in opt.state else torch.zeros_like(p)
            for name, p in named})
    if named and named[0][1] in opt.state:
        step = int(opt.state[named[0][1]]["step"])
    return {"step": step, **moments, "lr": float(opt.param_groups[0]["lr"])}


def load_adam_state(opt: torch.optim.Optimizer, model: torch.nn.Module, state: dict) -> None:
    """Restore :func:`adam_state`'s output into ``opt`` (moments, step and
    learning rate)."""
    # the moments by the JAX names they were saved under
    moments = {key: tree_to_state_dict(state[key]) for key in ("exp_avg", "exp_avg_sq")}
    sd = opt.state_dict()
    sd["state"] = {
        i: {"step": torch.tensor(float(state["step"]), dtype=torch.float32),
            **{key: moments[key][evaluator_leaf_key(name)] for key in moments}}
        for i, (name, _) in enumerate(_named_params(opt, model))
    }
    for group in sd["param_groups"]:
        group["lr"] = float(state["lr"])
    opt.load_state_dict(sd)

