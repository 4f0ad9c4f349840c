"""Carry ``train_fullgraph``'s weights between the JAX package and the port.

The JAX trainer keeps its GCN as a list of layers, ``[{"w": [in, out],
"b": [out]}, ...]``; the port's :class:`~pygcn_tpu_torch.apps.train_fullgraph.GCN`
keeps the same arrays as ``layers.<i>.weight`` (``[in, out]``) and
``layers.<i>.bias``. Its GAT is the tree ``{"gat1" | "gat2": {"w", "a_src",
"a_dst", "b"}}`` that ``pygcn_tpu.nn.gat.GAT.init`` returns, and with
``v2=True`` ``{"gat1" | "gat2": {"w_l", "a", "w_r", "b"}}`` (no ``w_r`` when
a layer shares its weights); the port's :class:`~pygcn_tpu_torch.nn.gat.GAT`
keeps the same arrays under ``gat1.w``, ``gat1.a_src``, ``gat1.w_l`` and so
on. The SAGE, GIN and APPNP trees of ``pygcn_tpu.nn.sage`` and
``pygcn_tpu.nn.gin`` (``{"sage1": {"w_self", "w_nb", "b"}, ...}``,
``{"gin1": {"mlp": {"w1", "b1", "w2", "b2"}, "eps"}, ...}``,
``{"mlp": {...}}``) map onto the state dicts of
:mod:`pygcn_tpu_torch.nn.sage` and :mod:`pygcn_tpu_torch.nn.gin` by joining
their keys with dots (:func:`tree_to_state_dict`). ``KipfGCN``'s tree
``{"gc1" | "gc2": {"w", "b"}}`` maps onto
:class:`~pygcn_tpu_torch.nn.models.KipfGCN`'s ``gc1.weight``, ``gc1.bias``
and so on (:func:`kipf_params_to_state_dict`). The two random generators
differ, so tests start both packages from one set of weights carried across
here. The simulator's inputs cross the same way: :func:`fields_of` reads any
of the JAX package's dataclasses (``EpidemicParams``, ``VisitSeq``,
``HostVisitSeq``) into NumPy arrays and meta fields, and
:func:`epidemic_params_from_fields`, :func:`visit_seq_from_fields` and
:func:`host_visit_seq_from_fields` build the port's. Arrays go through NumPy;
nothing of JAX is imported.
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


GAT_LAYERS = ("gat1", "gat2")
# v1 and v2 names; each tree or state dict holds the ones its layers have
GAT_PARAMS = ("w", "a_src", "a_dst", "w_l", "w_r", "a", "b")


def gat_params_to_state_dict(params) -> dict:
    """JAX-side GAT or GATv2 param tree → state dict of :class:`~pygcn_tpu_torch.nn.gat.GAT`."""
    return {f"{layer}.{name}": torch.from_numpy(np.array(params[layer][name], dtype=np.float32))
            for layer in GAT_LAYERS for name in GAT_PARAMS if name in params[layer]}


def state_dict_to_gat_params(state) -> dict:
    """GAT state dict → JAX-side param tree of NumPy arrays."""
    return {layer: {name: state[f"{layer}.{name}"].detach().cpu().numpy().copy()
                    for name in GAT_PARAMS if f"{layer}.{name}" in state}
            for layer in GAT_LAYERS}


def tree_to_state_dict(params, prefix: str = "") -> dict:
    """A nested JAX-side param tree (dicts of arrays: SAGE, GIN, APPNP) →
    state dict, each key the path of dict keys joined by dots."""
    state = {}
    for name, value in params.items():
        if isinstance(value, dict):
            state.update(tree_to_state_dict(value, f"{prefix}{name}."))
        else:
            state[f"{prefix}{name}"] = torch.from_numpy(np.array(value, dtype=np.float32))
    return state


def state_dict_to_tree(state) -> dict:
    """State dict → the nested JAX-side param tree of NumPy arrays
    (:func:`tree_to_state_dict`'s inverse)."""
    tree = {}
    for key, value in state.items():
        *path, leaf = key.split(".")
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = value.detach().cpu().numpy().copy()
    return tree


KIPF_LAYERS = ("gc1", "gc2")


def kipf_params_to_state_dict(params) -> dict:
    """JAX-side ``KipfGCN`` tree ``{"gc1", "gc2"}`` of ``{"w", "b"}`` → state
    dict of :class:`~pygcn_tpu_torch.nn.models.KipfGCN`."""
    state = {}
    for layer in KIPF_LAYERS:
        state[f"{layer}.weight"] = torch.from_numpy(np.array(params[layer]["w"], np.float32))
        state[f"{layer}.bias"] = torch.from_numpy(np.array(params[layer]["b"], np.float32))
    return state


def state_dict_to_kipf_params(state) -> dict:
    """``KipfGCN`` state dict → the JAX-side tree of NumPy arrays."""
    return {layer: {"w": state[f"{layer}.weight"].detach().cpu().numpy().copy(),
                    "b": state[f"{layer}.bias"].detach().cpu().numpy().copy()}
            for layer in KIPF_LAYERS}


def fields_of(obj) -> dict:
    """Every field of a dataclass (the JAX package's ``EpidemicParams``,
    ``VisitSeq`` or ``HostVisitSeq``) by name: arrays as NumPy arrays, the
    meta fields as they are."""
    import dataclasses

    return {f.name: np.asarray(v) if hasattr(v, "shape") else v
            for f in dataclasses.fields(obj) for v in (getattr(obj, f.name),)}


def epidemic_params_from_fields(fields: dict, device="cuda"):
    """JAX ``EpidemicParams`` fields (:func:`fields_of`) → the port's, on ``device``."""
    from pygcn_tpu_torch.sim.model import EpidemicParams

    return EpidemicParams(**{
        k: torch.from_numpy(np.array(v, np.float32)).to(device) if isinstance(v, np.ndarray)
        else v for k, v in fields.items()})


def host_visit_seq_from_fields(fields: dict):
    """JAX ``HostVisitSeq`` (or ``VisitSeq``) fields → the port's ``HostVisitSeq``."""
    from pygcn_tpu_torch.sim.model import HostVisitSeq

    poi = np.array(fields["poi_idx"], np.int32)
    if fields.get("period", poi.shape[0]) != poi.shape[0]:
        raise ValueError(f"period {fields['period']} != {poi.shape[0]} rows")
    return HostVisitSeq(poi, np.array(fields["cbg_idx"], np.int32),
                        np.array(fields["w"], np.float32), int(fields["n_pois"]),
                        int(fields["n_cbgs"]))


def visit_seq_from_fields(fields: dict, device="cuda"):
    """JAX ``VisitSeq`` fields → the port's ``VisitSeq`` on ``device``."""
    return host_visit_seq_from_fields(fields).to_device(device)
