"""SAGE, SGC, GIN and APPNP: the port against the JAX package, and their CLI.

Layers: the asymmetric 300-node graph of ``tests/test_torch_spmm.py`` laid
out three ways (dense, ELL, hybrid; each is what ``spmm``'s auto choice
takes in both packages), the same NumPy input and JAX-initialised weights
carried across by ``pygcn_tpu_torch.convert``; values agree to 1e-5 and the
VJP of a fixed cotangent, weights included, to 1e-4. Models: the small
clustered dataset of ``tests/test_torch_train_fullgraph.py`` on its hybrid
layout (JAX's tile half runs B1's Pallas body in interpret mode, the port's
its plain version); log-probs agree to 1e-5, the gradients (GIN's ``eps``
included), 3 Adam steps' losses and the final weights to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_spmm import N, coo
from test_torch_train_fullgraph import CLI_SMALL, DATA_KW, LR, STEPS, WD

import pygcn_tpu.graph.datasets as jds
from pygcn_tpu.graph.graph import Graph as JGraph
from pygcn_tpu.nn import gin as jgin
from pygcn_tpu.nn import sage as jsage
from pygcn_tpu.ops.spmm import _resolve_impl as j_resolve
from pygcn_tpu.train import adam_l2 as j_adam_l2

import pygcn_tpu_torch.graph.datasets as tds
from pygcn_tpu_torch import convert
from pygcn_tpu_torch.apps import train_fullgraph as tapp
from pygcn_tpu_torch.graph.graph import Graph as TGraph
from pygcn_tpu_torch.nn import gin as tgin
from pygcn_tpu_torch.nn import sage as tsage
from pygcn_tpu_torch.ops.spmm import _resolve_impl as t_resolve
from pygcn_tpu_torch.train.optim import adam_l2 as t_adam_l2

torch.set_num_threads(1)

VAL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
LAYOUTS = {"dense": dict(build_dense=True),
           "ell": dict(build_dense=False, build_hybrid=False),
           "hybrid": dict(build_dense=False, build_hybrid=True, hybrid_min_edges_per_tile=24)}

_GRAPHS = {}


def layout_graphs(layout):
    if layout not in _GRAPHS:
        s, d, w = coo()
        kw = dict(n_nodes=N, **LAYOUTS[layout])
        jg, tg = JGraph.from_coo(s, d, w, **kw), TGraph.from_coo(s, d, w, **kw)
        assert t_resolve(tg, "auto") == j_resolve(jg, "auto") == layout
        _GRAPHS[layout] = (jg, tg)
    return _GRAPHS[layout]


def _layer(name, fi=12, fo=8):
    """(JAX module, its params, the port's module with those weights, or
    (None, None, fn pair) for the graph-only functions)."""
    gen = torch.Generator().manual_seed(0)
    if name == "sage_conv":
        jm, tm = jsage.SAGEConv(fi, fo), tsage.SAGEConv(fi, fo, generator=gen)
    elif name == "gin_conv":
        jm, tm = jgin.GINConv(fi, fo, hidden_features=6), tgin.GINConv(fi, fo, 6, generator=gen)
    else:
        return None, None, None
    params = jm.init(jax.random.key(7))
    if name == "gin_conv":
        params["eps"] = jnp.asarray(0.3, jnp.float32)  # off its 0 start, so it is felt
    tm.load_state_dict(convert.tree_to_state_dict(params))
    return jm, params, tm


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", ["sage_conv", "gin_conv", "sgc_propagate", "appnp_propagate"])
def test_layer_matches_jax(name, layout):
    jg, tg = layout_graphs(layout)
    rng = np.random.default_rng(len(name))
    x = rng.standard_normal((N, 12)).astype(np.float32)
    jm, params, tm = _layer(name)
    if jm is not None:
        j_fn = lambda p, v: jm.apply(p, v, jg)
        t_fn = tm
    elif name == "sgc_propagate":
        params = {}
        j_fn = lambda p, v: jsage.sgc_propagate(jg, v, k=2)
        t_fn = lambda v, g: tsage.sgc_propagate(g, v, k=2)
    else:
        params = {}
        j_fn = lambda p, v: jgin.appnp_propagate(jg, v, 3, 0.1)
        t_fn = lambda v, g: tgin.appnp_propagate(g, v, 3, 0.1)
    y_j, vjp = jax.vjp(jax.jit(j_fn), params, jnp.asarray(x))
    cot = rng.standard_normal(y_j.shape).astype(np.float32)
    dp_j, dx_j = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_(True)
    y_t = t_fn(xt, tg)
    y_t.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), **VAL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), **GRAD)
    if tm is not None:
        grads = convert.tree_to_state_dict(dp_j)
        assert set(grads) == {k for k, _ in tm.named_parameters()}
        for k, p in tm.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), grads[k].numpy(), err_msg=k, **GRAD)


MODELS = {"sage": (jsage.SAGE, tsage.SAGE), "gin": (jgin.GIN, tgin.GIN),
          "appnp": (jgin.APPNP, tgin.APPNP), "sgc": (jsage.SGC, tsage.SGC)}
NHID = 8

_DATA = {}


def datasets():
    if not _DATA:
        jd, td = jds.community_classification(**DATA_KW), tds.community_classification(**DATA_KW)
        assert t_resolve(td.graph, "auto") == "hybrid" and td.graph.hybrid.bcsr is not None
        _DATA["j"], _DATA["t"] = jd, td
    return _DATA["j"], _DATA["t"]


def _models(name):
    """The JAX model, its params, and the port's model with those weights."""
    jcls, tcls = MODELS[name]
    nf, nc = DATA_KW["feat_dim"], DATA_KW["n_classes"]
    gen = torch.Generator().manual_seed(0)
    jm, tm = ((jcls(nf, nc), tcls(nf, nc, generator=gen)) if name == "sgc"
              else (jcls(nf, NHID, nc), tcls(nf, NHID, nc, generator=gen)))
    params = jm.init(jax.random.key(11))
    tm.load_state_dict(convert.tree_to_state_dict(params))
    return jm, params, tm


def _jax_run(name, jm, params, data):
    """Log-probs and gradients at ``params``, then the losses and weights of
    ``STEPS`` Adam steps, as ``pygcn_tpu/apps/train_fullgraph.py`` steps."""
    graph = data.graph
    x = jnp.asarray(data.features)
    if name == "sgc":
        x = jsage.sgc_propagate(graph, x)
    labels = jnp.asarray(data.labels)
    mask = jnp.zeros(graph.n_nodes, jnp.float32).at[jnp.asarray(data.idx_train)].set(1.0)

    def loss_fn(p):
        logp = jm.apply(p, x) if name == "sgc" else jm.apply(p, x, graph)
        per_node = -jnp.take_along_axis(logp, labels[:, None], axis=1)[:, 0]
        return (per_node * mask).sum() / mask.sum(), logp

    (_, logp), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    tx = j_adam_l2(LR, WD)
    opt_state = tx.init(params)

    @jax.jit
    def step(p, s):
        (loss, _), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, s = tx.update(g, s, p)
        return optax.apply_updates(p, updates), s, loss

    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state)
        losses.append(float(loss))
    return logp, grads, losses, params


def _torch_run(name, tm, data):
    graph = data.graph
    x = torch.from_numpy(data.features)
    if name == "sgc":
        x = tsage.sgc_propagate(graph, x)
    labels = torch.from_numpy(data.labels.astype(np.int64))
    mask = torch.zeros(graph.n_nodes)
    mask[torch.from_numpy(data.idx_train.astype(np.int64))] = 1.0

    def forward():
        return tm(x) if name == "sgc" else tm(x, graph)

    logp = forward()
    tapp.masked_nll(logp, labels, mask).backward()
    grads = {k: p.grad.clone() for k, p in tm.named_parameters()}
    opt = t_adam_l2(tm.parameters(), LR, WD)
    losses = []
    for _ in range(STEPS):
        opt.zero_grad(set_to_none=True)
        loss = tapp.masked_nll(forward(), labels, mask)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    return logp.detach(), grads, losses, tm


@pytest.mark.parametrize("name", list(MODELS))
def test_model_and_three_adam_steps_match_jax(name):
    jd, td = datasets()
    jm, params, tm = _models(name)
    j_logp, j_grads, j_losses, j_final = _jax_run(name, jm, params, jd)
    t_logp, t_grads, t_losses, tm = _torch_run(name, tm, td)
    np.testing.assert_allclose(t_logp.numpy(), np.asarray(j_logp), **VAL)
    j_grads = convert.tree_to_state_dict(j_grads)
    assert set(t_grads) == set(j_grads)
    for k, g in t_grads.items():
        np.testing.assert_allclose(g.numpy(), j_grads[k].numpy(), err_msg=k, **GRAD)
    if name == "gin":
        assert float(t_grads["gin1.eps"].abs()) > 0 and float(t_grads["gin2.eps"].abs()) > 0
    np.testing.assert_allclose(t_losses, j_losses, **GRAD)
    assert j_losses[-1] < j_losses[0]
    final = convert.tree_to_state_dict(j_final)
    for k, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), final[k].numpy(), err_msg=k, **GRAD)


@pytest.mark.parametrize("name", list(MODELS))
def test_convert_round_trip_and_init_bounds(name):
    jm, params, tm = _models(name)
    back = convert.state_dict_to_tree(tm.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for b, p in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(b, np.asarray(p))
    fresh = MODELS[name][1](*((16, 4) if name == "sgc" else (16, NHID, 4)),
                            generator=torch.Generator().manual_seed(1))
    for k, p in fresh.named_parameters():
        if k.endswith("eps"):
            assert p.shape == () and float(p.detach()) == 0.0
            continue
        fo = p.shape[-1]
        bound = np.sqrt(6.0 / fo) if p.dim() == 2 else 1.0 / np.sqrt(fo)
        assert p.abs().max() <= bound and p.std() > 0.3 * bound / np.sqrt(3), k


@pytest.mark.parametrize("model", ["sage", "gin", "appnp"])
def test_cli_clustered_learns(model):
    """``--model sage|gin|appnp --clustered`` on the CPU at the sizes of the
    GCN CLI test: the hybrid layout has tiles and the run learns."""
    r = tapp.main(["--clustered", *CLI_SMALL, "--model", model, "--max_epochs", "40",
                   "--patience", "6"])
    assert r["val"] > 0.5 and np.isfinite(r["test"]), r
    assert r["tile_frac"] > 0 and r["steps"] == r["epochs"] + 1
