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
and so on (:func:`kipf_params_to_state_dict`). Any tree of
``pygcn_tpu/nn/models.py``'s evaluator and generator models (``{"gcn":
{"gc1": {"w", "b"}, ...}, "mlp": {"linear1": {"w", "b"}, ...}}``, and
``pool_mlp``) maps onto the state dicts of
:mod:`pygcn_tpu_torch.nn.models` with ``w`` as ``weight`` and ``b`` as
``bias`` (:func:`evaluator_params_to_state_dict`); the port's
``evaluator.pkl`` and checkpoints keep their weights in that tree. The
sampled trainer's lists (``pygcn_tpu/apps/train_sampled.py``: per layer
``{"w", "b"}`` for the GCN, ``{"w", "a_src", "a_dst", "b"}`` for the GAT,
``{"w_l", "w_r", "a", "b"}`` for GATv2) map onto ``layers.<i>.<name>`` of
the port's ``SampledGCN``, ``SampledGAT`` and ``SampledGATv2``, under the
same names (:func:`sampled_params_to_state_dict`). The distributed models of
``pygcn_tpu/parallel`` keep the same trees (``DistGCN`` the list, ``DistSAGE``
and ``DistAPPNP`` SAGE's and APPNP's, ``DistGAT`` the GAT's, v1 and v2), and
the port's ``pygcn_tpu_torch/parallel`` models keep the single-device state
dicts, so the functions above carry them too. The model axes' trees
(``TPDistGCN``'s list, ``PipelinedDeepGCN``'s ``{"pre", "stages",
"head"}``, ``ExpertParallelMLP``'s ``{"gate", "w1", "b1", "w2", "b2"}``)
map onto one rank's state dict by its coordinate on the axis, each keeping
its share (:func:`tp_params_to_state_dict`,
:func:`pipeline_params_to_state_dict`, :func:`moe_params_to_state_dict`),
and the line's state dicts back onto the whole tree. The two random generators
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


# leaf names of the evaluator trees (JAX) and of the port's layers
EVALUATOR_LEAVES = {"w": "weight", "b": "bias"}


def _rename_leaf(key: str, names: dict) -> str:
    head, _, leaf = key.rpartition(".")
    leaf = names.get(leaf, leaf)
    return f"{head}.{leaf}" if head else leaf


def evaluator_params_to_state_dict(params) -> dict:
    """A JAX-side tree of ``pygcn_tpu/nn/models.py`` (``GCN3``,
    ``GCNOverMLP``, ``GCNRegressor``, ``PoolMLPModel``, the generators) →
    state dict of the port's model: keys joined by dots, ``w``/``b`` as
    ``weight``/``bias``."""
    return {_rename_leaf(k, EVALUATOR_LEAVES): v for k, v in tree_to_state_dict(params).items()}


def evaluator_leaf_key(key: str) -> str:
    """A key of the port's state dict under the JAX tree's leaf names
    (``weight``/``bias`` as ``w``/``b``; other names unchanged)."""
    return _rename_leaf(key, {v: k for k, v in EVALUATOR_LEAVES.items()})


def state_dict_to_evaluator_params(state) -> dict:
    """The port's state dict (or named parameters) → the JAX-side tree of
    NumPy arrays (:func:`evaluator_params_to_state_dict`'s inverse)."""
    return state_dict_to_tree({evaluator_leaf_key(k): v for k, v in state.items()})


def sampled_params_to_state_dict(params) -> dict:
    """JAX-side sampled param list (``[{"w", "b", ...}, ...]``) → state dict
    of the port's sampled models: ``layers.<i>.<name>``, names unchanged."""
    return tree_to_state_dict({"layers": {str(i): p for i, p in enumerate(params)}})


def state_dict_to_sampled_params(state) -> list:
    """A sampled model's state dict → the JAX-side param list of NumPy arrays
    (:func:`sampled_params_to_state_dict`'s inverse)."""
    layers = state_dict_to_tree(state)["layers"]
    return [layers[str(i)] for i in range(len(layers))]


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


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def tp_params_to_state_dict(params, coord: int, tp: int) -> dict:
    """JAX ``TPDistGCN``'s whole param list (``[{"w", "b"}, ...]``, as
    ``init`` returns it) → the state dict of the port's ``TPDistGCN`` rank
    at model coordinate ``coord`` of ``tp``: each layer's share in its mode
    (``parallel/tp_gcn.py``)."""
    from pygcn_tpu_torch.parallel.tp_gcn import shard_layer, tp_modes

    state = {}
    for i, (layer, mode) in enumerate(zip(params, tp_modes(len(params)))):
        w, b = shard_layer(_f32(layer["w"]), _f32(layer["b"]), mode, coord, tp)
        state[f"layers.{i}.weight"], state[f"layers.{i}.bias"] = w.contiguous(), b.contiguous()
    return state


def tp_state_dicts_to_params(states) -> list:
    """The state dicts of one model line's ranks, in model-coordinate order
    → JAX's whole param list of NumPy arrays (:func:`tp_params_to_state_dict`'s
    inverse)."""
    from pygcn_tpu_torch.parallel.tp_gcn import tp_modes

    lines = [state_dict_to_params(s) for s in states]
    out = []
    for i, mode in enumerate(tp_modes(len(lines[0]))):
        ws = [line[i]["w"] for line in lines]
        bs = [line[i]["b"] for line in lines]
        if mode == "col":
            out.append({"w": np.concatenate(ws, axis=1), "b": np.concatenate(bs)})
        elif mode == "row":
            out.append({"w": np.concatenate(ws, axis=0), "b": bs[0]})
        else:
            out.append({"w": ws[0], "b": bs[0]})
    return out


def pipeline_params_to_state_dict(params, coord: int, n_ranks: int) -> dict:
    """JAX ``PipelinedDeepGCN``'s tree ``{"pre", "stages", "head"}`` (the
    stages stacked) → the state dict of the port's model on ``pipe`` rank
    ``coord`` of ``n_ranks``: ``pre`` and ``head`` whole, this rank's
    consecutive stages of ``stages``."""
    stages = {k: np.asarray(v) for k, v in params["stages"].items()}
    per = next(iter(stages.values())).shape[0] // n_ranks
    return tree_to_state_dict({
        "pre": params["pre"], "head": params["head"],
        "stages": {k: v[coord * per:(coord + 1) * per] for k, v in stages.items()}})


def state_dicts_to_pipeline_params(states) -> dict:
    """The ``pipe`` line's state dicts, in rank order → JAX's tree of NumPy
    arrays, the stages stacked again."""
    trees = [state_dict_to_tree(s) for s in states]
    return {"pre": trees[0]["pre"], "head": trees[0]["head"],
            "stages": {k: np.concatenate([t["stages"][k] for t in trees])
                       for k in trees[0]["stages"]}}


MOE_EXPERT_LEAVES = ("w1", "b1", "w2", "b2")


def moe_params_to_state_dict(params, coord: int, n_ranks: int) -> dict:
    """JAX ``ExpertParallelMLP``'s tree → the state dict of the port's
    layer on ``expert`` rank ``coord`` of ``n_ranks``: the gate whole, this
    rank's experts' slices of ``w1``, ``b1``, ``w2``, ``b2``."""
    per = np.asarray(params["w1"]).shape[0] // n_ranks
    state = {"gate": _f32(params["gate"])}
    for k in MOE_EXPERT_LEAVES:
        state[k] = _f32(np.asarray(params[k])[coord * per:(coord + 1) * per])
    return state


def state_dicts_to_moe_params(states) -> dict:
    """The ``expert`` line's state dicts, in rank order → JAX's tree of
    NumPy arrays."""
    trees = [state_dict_to_tree(s) for s in states]
    out = {"gate": trees[0]["gate"]}
    for k in MOE_EXPERT_LEAVES:
        out[k] = np.concatenate([t[k] for t in trees])
    return out


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
