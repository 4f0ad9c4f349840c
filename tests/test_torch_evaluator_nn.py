"""The evaluator's layers and models in the port against the JAX package.

Every case of ``tests/test_nn_parity.py`` (GraphConv, the fresh-BatchNorm
standardisation, GCN3, MLP3 and its generator variants, the masked pool,
the pooled key and its attention, the top-K flag, the evaluator
``GCNOverMLP`` on a batch) is held here against the JAX function on the
same NumPy inputs with the weights carried by ``pygcn_tpu_torch.convert``;
then ``get_model`` for every name, five training steps of the evaluator
(Adam, L2, clipping at 0.1) against a JAX step built as the JAX trainer
builds it, and the ``--bf16`` step. Tolerances: values 1e-5, gradients and
Adam steps 1e-4, the bf16 loss 2e-2 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pygcn_tpu.graph import Graph as JGraph
from pygcn_tpu.graph import sym_normalize, symmetrize_max
from pygcn_tpu.nn import layers as jlayers
from pygcn_tpu.nn import models as jmodels
from pygcn_tpu.train import adam_l2 as j_adam_l2
from pygcn_tpu_torch import convert
from pygcn_tpu_torch.apps import train_evaluator as tev
from pygcn_tpu_torch.graph.graph import Graph as TGraph
from pygcn_tpu_torch.nn import layers as tlayers
from pygcn_tpu_torch.nn import models as tmodels
from pygcn_tpu_torch.train.optim import adam_l2
from pygcn_tpu_torch.utils.config import Config

torch.set_num_threads(1)

VAL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)


def graphs(n=60, e=400, seed=3):
    """One normalised symmetric adjacency as a JAX and a port graph (dense)."""
    rng = np.random.default_rng(seed)
    m = sp.coo_matrix((rng.uniform(0.1, 1.0, e), (rng.integers(0, n, e), rng.integers(0, n, e))),
                      shape=(n, n))
    a = sym_normalize(symmetrize_max(m))
    return (JGraph.from_scipy(a, is_symmetric=True, build_dense=True),
            TGraph.from_scipy(a, is_symmetric=True, build_dense=True))


def carry(jmodule, tmodule, key, to_state=convert.evaluator_params_to_state_dict):
    """JAX init at ``key``, the same weights loaded into the port module."""
    params = jmodule.init(jax.random.key(key))
    tmodule.load_state_dict(to_state(params))
    return params


def normal(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def flagged(b, n, f, picks, seed):
    """``[B, N, F]`` normal features whose last column flags ``picks`` nodes."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, f)).astype(np.float32)
    x[:, :, -1] = 0.0
    for i in range(b):
        x[i, rng.choice(n, picks, replace=False), -1] = 1.0
    return x


def gen():
    return torch.Generator().manual_seed(0)


def assert_grads(tmodule, j_grads):
    t_grads = convert.state_dict_to_evaluator_params(
        {k: p.grad for k, p in tmodule.named_parameters()})
    flat_t = convert.tree_to_state_dict(t_grads)
    flat_j = convert.tree_to_state_dict(jax.tree.map(np.asarray, j_grads))
    assert flat_t.keys() == flat_j.keys()
    for k in flat_j:
        np.testing.assert_allclose(flat_t[k].numpy(), flat_j[k].numpy(), err_msg=k, **GRAD)


def test_graphconv_forward_matches_jax():
    jg, tg = graphs()
    jl, tl = jlayers.GraphConv(12, 8), tlayers.GraphConv(12, 8)
    carry(jl, tl, 0)
    x = normal(tg.n_nodes, 12)
    np.testing.assert_allclose(tl(torch.from_numpy(x), tg).detach().numpy(),
                               np.asarray(jl(jl.init(jax.random.key(0)), jnp.asarray(x), jg)),
                               **VAL)


@pytest.mark.parametrize("shape", [(50, 7), (3, 50, 7)])
def test_batch_standardize_matches_jax(shape):
    """Biased variance over the node axis (-2), per sample when batched;
    one sample is the reference's fresh ``BatchNorm1d`` in training mode."""
    x = normal(*shape, seed=1) * 3 + 1
    got = tlayers.batch_standardize(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jlayers.batch_standardize(jnp.asarray(x))), **VAL)
    last = torch.from_numpy(x.reshape(-1, 50, 7)[-1])
    np.testing.assert_allclose(got.reshape(-1, 50, 7)[-1],
                               torch.nn.BatchNorm1d(7)(last).detach().numpy(), **VAL)


def test_gcn3_forward_and_gradients_match_jax():
    jg, tg = graphs()
    jm, tm = jmodels.GCN3(6, 16, 4), tmodels.GCN3(6, 16, 4, generator=gen())
    params = carry(jm, tm, 1)
    x, cot = normal(tg.n_nodes, 6, seed=2), normal(tg.n_nodes, 4, seed=3)
    j_out, vjp = jax.vjp(lambda p: jm(p, jnp.asarray(x), jg), params)
    t_out = tm(torch.from_numpy(x), tg)
    (t_out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out), **VAL)
    assert_grads(tm, vjp(jnp.asarray(cot))[0])


def test_gcn3_dropout_only_with_a_generator():
    _, tg = graphs()
    tm = tmodels.GCN3(6, 16, 4, dropout=0.5, generator=gen())
    x = torch.from_numpy(normal(tg.n_nodes, 6, seed=2))
    plain = tm(x, tg)
    assert torch.equal(tm(x, tg), plain)
    assert not torch.equal(tm(x, tg, dropout_generator=torch.Generator().manual_seed(1)), plain)


@pytest.mark.parametrize("cls", ["MLP3", "GeneratorMLP3", "SoftmaxMLP3"])
def test_mlp3_variants_match_jax(cls):
    """MLP3, with batch standardisation after the hidden ReLUs
    (GeneratorMLP3), and with a softmax over the node axis (SoftmaxMLP3)."""
    jm, tm = getattr(jlayers, cls)(10, 32, 8, 1), getattr(tlayers, cls)(10, 32, 8, 1,
                                                                        generator=gen())
    params = carry(jm, tm, 2)
    x, cot = normal(25, 10, seed=3), normal(25, 1, seed=4)
    j_out, vjp = jax.vjp(lambda p: jm(p, jnp.asarray(x)), params)
    t_out = tm(torch.from_numpy(x))
    (t_out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out), **VAL)
    assert_grads(tm, vjp(jnp.asarray(cot))[0])
    if cls == "SoftmaxMLP3":
        np.testing.assert_allclose(t_out.detach().sum(0).numpy(), 1.0, rtol=1e-5)


def test_masked_mean_pool_matches_jax():
    x = flagged(3, 40, 6, 5, seed=4)
    got = tlayers.masked_mean_pool(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.vmap(jlayers.masked_mean_pool)(
        jnp.asarray(x))), **VAL)
    np.testing.assert_allclose(tlayers.masked_mean_pool(torch.from_numpy(x[1])).numpy(), got[1])
    x[2, :, -1] = 0.0  # no flag: the count is held at 1
    np.testing.assert_allclose(tlayers.masked_mean_pool(torch.from_numpy(x))[2].numpy(), 0.0)


def test_pool_key_and_attention_match_jax():
    jm, tm = jlayers.PoolKeyMLP(8, 16, 8), tlayers.PoolKeyMLP(8, 16, 8, generator=gen())
    params = carry(jm, tm, 12)
    x = normal(20, 8, seed=12)
    j_key = jm(params, jnp.asarray(x))
    t_key = tm(torch.from_numpy(x))
    assert t_key.shape == (1, 8)
    np.testing.assert_allclose(t_key.detach().numpy(), np.asarray(j_key), **VAL)
    np.testing.assert_allclose(
        tlayers.attention_scores(t_key, torch.from_numpy(x)).detach().numpy(),
        np.asarray(jlayers.attention_scores(j_key, jnp.asarray(x))), **VAL)


def test_topk_flag_values_and_gradients_match_jax():
    scores = np.random.default_rng(5).uniform(0.5, 2.0, size=(30, 1)).astype(np.float32)
    j_flag, vjp = jax.vjp(lambda s: jmodels.topk_flag_straight_through(s, 7), jnp.asarray(scores))
    s = torch.from_numpy(scores).requires_grad_(True)
    t_flag = tmodels.topk_flag_straight_through(s, 7)
    t_flag.sum().backward()
    np.testing.assert_allclose(t_flag.detach().numpy(), np.asarray(j_flag), **VAL)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(vjp(jnp.ones((30, 1)))[0]), **GRAD)
    sel = np.isclose(t_flag.detach().numpy()[:, 0], 1.0, atol=1e-5)
    assert sel.sum() == 7 and (t_flag.detach().numpy()[~sel] == 0).all()
    np.testing.assert_allclose(s.grad.numpy()[sel, 0], 1.0 / scores[sel, 0], rtol=1e-5)


def evaluator_pair(f=9, dim_touched=6, nclass=5, impl="auto"):
    kw = dict(gcn_nfeat=dim_touched, gcn_nhid=12, gcn_nclass=nclass, dim_touched=dim_touched,
              linear_nin=nclass + (f - dim_touched) - 1, linear_nhid1=16, linear_nhid2=8,
              linear_nout=1)
    jm = jmodels.GCNOverMLP(**kw)
    tm = tmodels.GCNOverMLP(**kw, impl=impl, generator=gen())
    return jm, tm, carry(jm, tm, 3)


def test_gcn_over_mlp_forward_and_gradients_match_jax():
    """The evaluator on a batch of 4 samples, folded through each SpMM."""
    jg, tg = graphs()
    jm, tm, params = evaluator_pair()
    x, cot = flagged(4, tg.n_nodes, 9, 8, seed=6), normal(4, 1, seed=7)
    j_out, vjp = jax.vjp(lambda p: jm(p, jnp.asarray(x), jg), params)
    t_out = tm(torch.from_numpy(x), tg)
    (t_out * torch.from_numpy(cot)).sum().backward()
    assert t_out.shape == (4, 1)
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out), **VAL)
    assert_grads(tm, vjp(jnp.asarray(cot))[0])
    # the batch equals its samples run alone
    for i in (0, 3):
        np.testing.assert_allclose(tm(torch.from_numpy(x[i:i + 1]), tg).detach().numpy(),
                                   t_out[i:i + 1].detach().numpy(), **VAL)


def test_init_bounds():
    """GraphConv's (in, out)-stored kaiming bound and the dense layers'
    torch-Linear bound, 1/sqrt(in), each filling its range."""
    layer = tlayers.GraphConv(64, 16, generator=gen())
    w, b = layer.weight.detach().numpy(), layer.bias.detach().numpy()
    assert np.abs(w).max() <= np.sqrt(6 / 16) and np.abs(w).max() > 0.8 * np.sqrt(6 / 16)
    assert np.abs(b).max() <= 1 / np.sqrt(16)
    dense = tlayers.Dense(64, 16, generator=gen())
    for p in (dense.weight, dense.bias):
        assert 0.8 / 8 < p.detach().abs().max() <= 1 / 8
    assert dense.weight.shape == (64, 16)


CONFIG = Config(gcn_nfeat=6, gcn_nhid=8, gcn_nclass=4, dim_touched=6, NN=5,
                linear_nin=4 + 3, linear_nhid1=16, linear_nhid2=8, linear_nout=1)
# name: (inputs, how the JAX tree maps onto the port's state dict)
GET_MODEL = {
    "GCN": ("node", convert.evaluator_params_to_state_dict),
    "MLP": ("pool", convert.evaluator_params_to_state_dict),
    "GNN_OVER_MLP": ("batch", convert.evaluator_params_to_state_dict),
    "Generator": ("wide", convert.evaluator_params_to_state_dict),
    "Hierarchical_Generator": ("group", convert.evaluator_params_to_state_dict),
    "SoftGenerator": ("node", convert.evaluator_params_to_state_dict),
    "KipfGCN": ("node", convert.kipf_params_to_state_dict),
    "GAT": ("node", convert.gat_params_to_state_dict),
    "GATv2": ("node", convert.gat_params_to_state_dict),
    "SAGE": ("node", convert.tree_to_state_dict),
    "GIN": ("node", convert.tree_to_state_dict),
    "APPNP": ("node", convert.tree_to_state_dict),
}


def model_inputs(kind, n):
    """Inputs of each model: node features ``[N, 6]``; the pool-and-MLP
    input ``[B, N, 8]`` (7 features and the flag); the evaluator's batch
    ``[B, N, 10]`` (6 touched, 4 untouched, the flag last); the top-K
    generator's ``[N, 9]`` (6 touched, 3 untouched); the hierarchical one's
    ``[N, 10]``, its last column a group id in 0..2."""
    if kind == "node":
        return normal(n, 6, seed=8)
    if kind == "pool":
        return flagged(3, n, 8, 6, seed=9)
    if kind == "batch":
        return flagged(3, n, 10, 6, seed=10)
    x = normal(n, 10 if kind == "group" else 9, seed=11)
    if kind == "group":
        x[:, -1] = np.arange(n) % 3
    return x


@pytest.mark.parametrize("name", list(GET_MODEL))
def test_get_model_every_name_matches_jax(name):
    """The port's ``get_model`` builds each model of the JAX factory with the
    same parameter tree; with the JAX weights carried over, their forward
    values and gradients agree (GCN-family models on a dense graph, the
    attention models on its COO)."""
    kind, to_state = GET_MODEL[name]
    jg, tg = graphs(n=40, e=240)
    cfg = CONFIG.copy()
    if name == "GCN":
        cfg.linear_nin = cfg.gcn_nclass  # its head reads the node mean of the GCN's output
    jm = jmodels.get_model(cfg, name)
    tm = tmodels.get_model(cfg, name, generator=gen())
    params = carry(jm, tm, 4, to_state)
    assert set(tm.state_dict()) == set(to_state(params))
    x = model_inputs(kind, tg.n_nodes)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if name == "MLP":
        j_fn, t_out = (lambda p: jm(p, jx)), tm(tx)
    else:
        j_fn, t_out = (lambda p: jm(p, jx, jg)), tm(tx, tg)
    j_out, vjp = jax.vjp(j_fn, params)
    cot = normal(*t_out.shape, seed=12)
    (t_out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out), **VAL)
    (j_grads,) = vjp(jnp.asarray(cot))
    flat_j = to_state(jax.tree.map(np.asarray, j_grads))
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), flat_j[k].numpy(), err_msg=k, **GRAD)


def test_get_model_refuses_an_unknown_name():
    with pytest.raises(ValueError, match="unknown model"):
        tmodels.get_model(CONFIG, "Transformer", generator=gen())


def j_evaluator_step(jm, graph, lr=0.01, wd=5e-4, clip=0.1, bf16=False):
    """The JAX trainer's index-fed step (``apps/train_evaluator.py:195-209``)."""
    import dataclasses

    import optax

    tx = j_adam_l2(lr, wd, grad_clip_norm=clip)
    compute_graph = graph
    if bf16:
        compute_graph = dataclasses.replace(graph, dense=graph.dense.astype(jnp.bfloat16))

    def loss_fn(params, bx, by):
        if bf16:
            params = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
            bx = bx.astype(jnp.bfloat16)
        pred = jm.apply(params, bx, compute_graph)[:, 0].astype(jnp.float32)
        return jnp.mean((pred - by) ** 2)

    @jax.jit
    def step(params, opt_state, feats_all, y_all, idx):
        bx, by = jnp.take(feats_all, idx, axis=0), jnp.take(y_all, idx, axis=0)
        loss, grads = jax.value_and_grad(loss_fn)(params, bx, by)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    return tx, step


@pytest.mark.parametrize("bf16", [False, True])
def test_evaluator_training_steps_match_jax(bf16):
    """Five steps of the port's ``make_train_step`` (Adam, L2 5e-4, clipping
    at 0.1, batches picked by index from device-resident samples) against
    the JAX step: every loss and the weights after them. With ``--bf16``'s
    casts the losses agree within 2e-2 relative (the second is the loss
    after one step)."""
    jg, tg = graphs()
    jm, tm, params = evaluator_pair()
    feats = flagged(12, tg.n_nodes, 9, 8, seed=13)
    y = normal(12, seed=14)
    tx, j_step = j_evaluator_step(jm, jg, bf16=bf16)
    opt_state = tx.init(params)
    t_step = tev.make_train_step(tm, adam_l2(tm.parameters(), 0.01, 5e-4, grad_clip_norm=0.1),
                                 tg, bf16=bf16)
    t_feats, t_y = torch.from_numpy(feats), torch.from_numpy(y)
    order = np.random.default_rng(15).permutation(12)
    for b in range(5):
        idx = order[(b % 3) * 4:(b % 3 + 1) * 4]
        params, opt_state, j_loss = j_step(params, opt_state, jnp.asarray(feats),
                                           jnp.asarray(y), jnp.asarray(idx))
        ti = torch.from_numpy(idx)
        t_loss = t_step(t_feats.index_select(0, ti), t_y.index_select(0, ti))
        if bf16:
            assert float(t_loss) == pytest.approx(float(j_loss), rel=2e-2)
            if b == 1:
                break
        else:
            np.testing.assert_allclose(float(t_loss), float(j_loss), **GRAD)
    if not bf16:
        got = convert.tree_to_state_dict(convert.state_dict_to_evaluator_params(tm.state_dict()))
        want = convert.tree_to_state_dict(jax.tree.map(np.asarray, params))
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), err_msg=k, **GRAD)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
