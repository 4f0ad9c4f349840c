"""The port's 2-layer GAT and GATv2 against the JAX package's, and the GAT CLI.

One small clustered dataset (512 nodes, 16 features, 4 classes) is built by
both packages from one seed with the ELL and hybrid layouts, and a tile
threshold of 500 edges that sends half of the 16 tiles to the ELL side, so
that tiles and a residual both exist. JAX-initialised weights
go through ``pygcn_tpu_torch.convert``; both packages then agree on the
log-probs (1e-5) and on every gradient and 3 Adam steps (1e-4), on each of
the three attention paths. Each case runs for GAT v1 and for GATv2
(``v2=True``). JAX's tile kernels run their Pallas bodies in interpret mode;
the port runs the kernels' plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pygcn_tpu.graph.datasets as jds
from pygcn_tpu.nn.gat import GAT as JGAT
from pygcn_tpu.nn.gat import GATv2Conv as JGATv2Conv
from pygcn_tpu.ops.gat import build_edge_map as j_edge_map
from pygcn_tpu.ops.gat import build_gat_tiles_t as j_tiles_t
from pygcn_tpu.train import adam_l2 as j_adam_l2

import pygcn_tpu_torch.graph.datasets as tds
from pygcn_tpu_torch import convert
from pygcn_tpu_torch.apps import train_fullgraph as tapp
from pygcn_tpu_torch.nn.gat import GAT as TGAT
from pygcn_tpu_torch.nn.gat import GATv2Conv as TGATv2Conv
from pygcn_tpu_torch.ops.gat import build_edge_map as t_edge_map
from pygcn_tpu_torch.ops.gat import build_gat_tiles_t as t_tiles_t
from pygcn_tpu_torch.train.optim import adam_l2 as t_adam_l2

torch.set_num_threads(1)

DATA_KW = dict(n=512, avg_degree=8.0, n_classes=4, feat_dim=16, seed=3, build_dense=False,
               build_ell=True, build_hybrid=True, hybrid_min_edges_per_tile=500)
NHID, HEADS = 4, 2
LR, WD, STEPS = 0.01, 5e-4, 3
PATHS = ["coo", "ell", "hybrid"]
V2 = pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])

_DATA = {}


def datasets():
    if not _DATA:
        jd, td = jds.community_classification(**DATA_KW), tds.community_classification(**DATA_KW)
        assert td.graph.hybrid.bcsr is not None and td.graph.hybrid.bcsr.data.shape[0] <= 16
        assert 0 < td.graph.hybrid.tile_edges == jd.graph.hybrid.tile_edges < td.graph.n_edges
        _DATA["j"], _DATA["t"] = jd, td
    return _DATA["j"], _DATA["t"]


def fwd_kwargs(path, graph, edge_map, tiles_t):
    if path == "hybrid":
        return {"hybrid_tiles": True, "tiles_t": tiles_t(graph)}
    if path == "ell":
        return {"edge_map": edge_map(graph)}
    return {}


def jax_model(data, path, v2):
    kw = fwd_kwargs(path, data.graph, j_edge_map, j_tiles_t)
    model = JGAT(nfeat=16, nhid=NHID, nclass=4, heads=HEADS, v2=v2)
    x = jnp.asarray(data.features)
    labels = jnp.asarray(data.labels)
    mask = jnp.zeros(data.graph.n_nodes, jnp.float32).at[jnp.asarray(data.idx_train)].set(1.0)

    def loss_fn(params):
        logp = model.apply(params, x, data.graph, **kw)
        per_node = -jnp.take_along_axis(logp, labels[:, None], axis=1)[:, 0]
        return (per_node * mask).sum() / mask.sum(), logp

    return model, loss_fn


def torch_setup(data, params, path, v2):
    kw = fwd_kwargs(path, data.graph, t_edge_map, t_tiles_t)
    model = TGAT(16, NHID, 4, heads=HEADS, v2=v2, generator=torch.Generator().manual_seed(0))
    model.load_state_dict(convert.gat_params_to_state_dict(params))
    x = torch.from_numpy(data.features)
    labels = torch.from_numpy(data.labels.astype(np.int64))
    mask = torch.zeros(data.graph.n_nodes)
    mask[torch.from_numpy(data.idx_train.astype(np.int64))] = 1.0
    return model, x, labels, mask, kw


@V2
@pytest.mark.parametrize("path", PATHS)
def test_gat_log_probs_and_gradients_match_jax(path, v2):
    jd, td = datasets()
    model, loss_fn = jax_model(jd, path, v2)
    params = model.init(jax.random.key(1))
    (j_loss, j_logp), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    t_model, x, labels, mask, kw = torch_setup(td, params, path, v2)
    logp = t_model(x, td.graph, **kw)
    loss = tapp.masked_nll(logp, labels, mask)
    loss.backward()
    np.testing.assert_allclose(logp.detach().numpy(), np.asarray(j_logp), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-5, atol=1e-5)
    t_grads = convert.state_dict_to_gat_params(
        {n: p.grad for n, p in t_model.named_parameters()})
    for layer in convert.GAT_LAYERS:
        assert set(t_grads[layer]) == set(j_grads[layer])
        for name in j_grads[layer]:
            np.testing.assert_allclose(t_grads[layer][name], np.asarray(j_grads[layer][name]),
                                       rtol=1e-4, atol=1e-4, err_msg=f"{layer}.{name}")


@V2
def test_gat_three_adam_steps_match_jax(v2):
    """The JAX trainer's GAT step (``pygcn_tpu/apps/train_fullgraph.py:302-312``)
    against the port's ``train_step`` on the tile-attention path."""
    jd, td = datasets()
    model, loss_fn = jax_model(jd, "hybrid", v2)
    params = model.init(jax.random.key(2))
    tx = j_adam_l2(LR, WD)

    @jax.jit
    def step(params, opt_state):
        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    t_model, x, labels, mask, kw = torch_setup(td, params, "hybrid", v2)
    opt = t_adam_l2(t_model.parameters(), LR, WD)
    opt_state = tx.init(params)
    j_losses, t_losses = [], []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state)
        j_losses.append(float(loss))
        t_losses.append(float(tapp.train_step(t_model, opt, x, labels, mask, td.graph, **kw)))
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4, atol=1e-4)
    assert j_losses[-1] < j_losses[0]
    final = convert.state_dict_to_gat_params(t_model.state_dict())
    for layer in convert.GAT_LAYERS:
        for name in params[layer]:
            np.testing.assert_allclose(final[layer][name], np.asarray(params[layer][name]),
                                       rtol=1e-4, atol=1e-4, err_msg=f"{layer}.{name}")


@V2
def test_gat_convert_round_trip_and_init_bounds(v2):
    params = JGAT(nfeat=16, nhid=NHID, nclass=4, heads=HEADS, v2=v2).init(jax.random.key(5))
    model = TGAT(16, NHID, 4, heads=HEADS, v2=v2, generator=torch.Generator().manual_seed(0))
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    if v2:
        assert shapes == {"gat1.w_l": (16, 8), "gat1.a": (2, 4), "gat1.w_r": (16, 8),
                          "gat1.b": (8,), "gat2.w_l": (8, 4), "gat2.a": (1, 4),
                          "gat2.w_r": (8, 4), "gat2.b": (4,)}
    else:
        assert shapes == {"gat1.w": (16, 8), "gat1.a_src": (2, 4), "gat1.a_dst": (2, 4),
                          "gat1.b": (8,), "gat2.w": (8, 4), "gat2.a_src": (1, 4),
                          "gat2.a_dst": (1, 4), "gat2.b": (4,)}
    for name, p in model.state_dict().items():  # GraphConv bounds, as the JAX init
        fan = p.shape[-1]
        bound = 1 / np.sqrt(fan) if name.endswith(".b") else np.sqrt(6 / fan)
        assert p.abs().max() <= bound, name
        if name.split(".")[1] in ("w", "w_l", "w_r"):
            assert p.std() > 0.3 * bound / np.sqrt(3), name
    model.load_state_dict(convert.gat_params_to_state_dict(params))
    back = convert.state_dict_to_gat_params(model.state_dict())
    for layer in convert.GAT_LAYERS:
        assert set(back[layer]) == set(params[layer])
        for name, v in params[layer].items():
            np.testing.assert_array_equal(back[layer][name], np.asarray(v))


def test_gatv2_share_weights_matches_jax():
    """``GATv2Conv(share_weights=True)`` ties ``W_r = W_l``: no ``w_r``
    parameter, in the port's module and in the converted tree, and values
    and gradients as JAX's on the tile-attention path."""
    jd, td = datasets()
    j_conv = JGATv2Conv(16, NHID, heads=HEADS, share_weights=True)
    params = j_conv.init(jax.random.key(7))
    assert "w_r" not in params
    t_conv = TGATv2Conv(16, NHID, HEADS, share_weights=True,
                        generator=torch.Generator().manual_seed(0))
    state = convert.gat_params_to_state_dict({"gat1": params, "gat2": params})
    assert set(state) == {f"{layer}.{k}" for layer in convert.GAT_LAYERS
                          for k in ("w_l", "a", "b")}
    t_conv.load_state_dict({k[len("gat1."):]: v for k, v in state.items()
                            if k.startswith("gat1.")})
    rng = np.random.default_rng(8)
    x = rng.normal(size=jd.features.shape).astype(np.float32)
    cot = rng.normal(size=(jd.graph.n_nodes, NHID * HEADS)).astype(np.float32)
    jt = j_tiles_t(jd.graph)

    def j_loss(p):
        out = j_conv.apply(p, jnp.asarray(x), jd.graph, hybrid_tiles=True, tiles_t=jt)
        return (out * cot).sum(), out

    (_, j_out), j_grads = jax.value_and_grad(j_loss, has_aux=True)(params)
    t_out = t_conv(torch.from_numpy(x), td.graph, hybrid_tiles=True, tiles_t=t_tiles_t(td.graph))
    (t_out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out), rtol=1e-5, atol=1e-5)
    for name, p in t_conv.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(j_grads[name]), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_gat_options_not_ported_raise(monkeypatch):
    """Attention above the column-panel threshold, once refused here, is
    ported: with the threshold lowered so that a small graph meets it, the
    GAT's data carries the column panels and no ELL or hybrid layout
    (``tests/test_torch_gat_colpanel.py`` holds the path against JAX).
    (Dropout, refused here before, is ported: ``tests/test_torch_cora.py``
    holds it.)"""
    monkeypatch.setattr(tapp, "COLPANEL_MIN_NODES", 100)
    g = tapp.clustered_dataset(400, 8.0, 4, 16, 0, attention=True).graph
    assert g.colpanel is not None and g.ell is None and g.hybrid is None


@pytest.mark.parametrize("model", ["gat", "gatv2"])
def test_cli_gat_clustered_learns(model):
    """``--model gat|gatv2 --clustered`` on the CPU at the sizes of the GCN CLI
    test: the tile-attention path is taken and the run learns."""
    r = tapp.main(["--clustered", "--model", model, "--device", "cpu", "--n_nodes", "800",
                   "--avg_degree", "8", "--feat_dim", "16", "--hidden", "8", "--gat_heads", "2",
                   "--n_classes", "4", "--max_epochs", "30", "--patience", "10", "--seed", "3"])
    assert r["hybrid_tiles"] and r["tiles_t"] is not None and r["edge_map"] is not None
    assert r["tile_frac"] > 0 and r["steps"] == r["epochs"] + 1
    assert r["val"] > 0.5 and np.isfinite(r["test"]), r["val"]


@pytest.mark.parametrize("model", ["gat", "gatv2"])
def test_cli_gat_default_device_raises_without_cuda(monkeypatch, model):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapp.main(["--clustered", "--model", model, "--n_nodes", "800", "--max_epochs", "1"])
