"""Carry ``train_fullgraph``'s GCN weights between the JAX package and the port.

The JAX trainer keeps its GCN as a list of layers, ``[{"w": [in, out],
"b": [out]}, ...]``; the port's :class:`~pygcn_tpu_torch.apps.train_fullgraph.GCN`
keeps the same arrays as ``layers.<i>.weight`` (``[in, out]``) and
``layers.<i>.bias``. The two random generators differ, so tests start both
packages from one set of weights carried across here. Arrays go through
NumPy; nothing of JAX is imported.
"""

from __future__ import annotations

import numpy as np
import torch


def params_to_state_dict(params) -> dict:
    """JAX-side param list (arrays of any kind NumPy can read) → port state dict."""
    state = {}
    for i, layer in enumerate(params):
        state[f"layers.{i}.weight"] = torch.from_numpy(
            np.array(layer["w"], dtype=np.float32))
        state[f"layers.{i}.bias"] = torch.from_numpy(
            np.array(layer["b"], dtype=np.float32))
    return state


def state_dict_to_params(state) -> list:
    """Port state dict (or a module's ``state_dict()``) → JAX-side param list of NumPy arrays."""
    n_layers = len({k.split(".")[1] for k in state if k.startswith("layers.")})
    return [
        {"w": state[f"layers.{i}.weight"].detach().cpu().numpy().copy(),
         "b": state[f"layers.{i}.bias"].detach().cpu().numpy().copy()}
        for i in range(n_layers)
    ]
