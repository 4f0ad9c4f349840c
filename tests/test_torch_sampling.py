"""Neighbourhood sampling: the port (``pygcn_tpu_torch/ops/sampling.py``,
``utils/native.py``) against the JAX package on the CPU.

The sampler's blocks equal JAX's bit for bit on every path: graphkit at 1
and 4 threads, and the NumPy fallback (forced by making the port's
``native._load`` find no library). The three sampled forwards take JAX's
parameters through ``convert.sampled_params_to_state_dict`` and agree with
JAX's within 1e-5 (values) and 1e-4 (gradients), on blocks with isolated
nodes, blocks where every row is isolated, and fanout 1.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pygcn_tpu.graph.transform import sym_normalize, symmetrize_max
from pygcn_tpu.nn import init as jinit
from pygcn_tpu.ops import sampling as js
from pygcn_tpu.utils import native as jn

from pygcn_tpu_torch import convert
from pygcn_tpu_torch.apps import train_sampled as tapp
from pygcn_tpu_torch.ops import sampling as ts
from pygcn_tpu_torch.utils import native as tn

torch.set_num_threads(1)

PATHS = ["native-1", "native-4", "fallback"]


@pytest.fixture
def path(request, monkeypatch):
    """Run the port's sampling on one path: graphkit with a thread count, or
    the NumPy fallback."""
    name = request.param
    if name == "fallback":
        monkeypatch.setattr(tn, "_load", lambda: None)
    else:
        if not tn.available():
            pytest.skip("graphkit did not build")
        threads = int(name.split("-")[1])
        real = tn.sample_layer
        monkeypatch.setattr(tn, "sample_layer",
                            lambda *a, **kw: real(*a, **{**kw, "threads": threads}))
    return name


def csr_with_isolated(n=300, density=0.04, seed=7, isolated=(0, 5, 17)):
    """A random adjacency (positive weights) whose ``isolated`` rows are
    empty, the last row among them (its CSR row ends the index array)."""
    m = sp.random(n, n, density=density, random_state=seed, format="csr", dtype=np.float32)
    keep = np.ones(n, np.float32)
    keep[list(isolated) + [n - 1]] = 0.0
    return sp.csr_matrix(sp.diags(keep) @ m, dtype=np.float32)


@pytest.mark.parametrize("path", PATHS, indirect=True)
@pytest.mark.parametrize("mode", ["gcn", "mean"])
def test_sample_layer_matches_jax_bit_for_bit(path, mode):
    a = csr_with_isolated()
    indptr, indices = a.indptr.astype(np.int64), a.indices.astype(np.int64)
    out_nodes = np.concatenate([[0, 5, 299], np.random.default_rng(7).integers(0, 300, 61)])
    for base in (0, 12345, (1 << 63) + 99, (1 << 64) - 3):
        want_c, want_w = jn.sample_layer(indptr, indices, a.data, out_nodes, 5, base, mode=mode,
                                         threads=1)
        got_c, got_w = tn.sample_layer(indptr, indices, a.data, out_nodes, 5, base, mode=mode)
        assert got_c.dtype == np.int64 and got_w.dtype == np.float32
        np.testing.assert_array_equal(got_c, want_c)
        np.testing.assert_array_equal(got_w, want_w)
    # isolated rows emit the node itself with weight 0
    assert (got_c[:3] == np.array([0, 5, 299])[:, None]).all() and not got_w[:3].any()


@pytest.mark.parametrize("path", PATHS, indirect=True)
def test_sample_layer_on_an_edgeless_graph(path):
    e = sp.csr_matrix((4, 4), dtype=np.float32)
    nodes = np.array([3, 0, 2], np.int64)
    cols, w = tn.sample_layer(e.indptr.astype(np.int64), e.indices.astype(np.int64), e.data,
                              nodes, 2, 0, mode="mean")
    want_c, want_w = jn.sample_layer(e.indptr.astype(np.int64), e.indices.astype(np.int64),
                                     e.data, nodes, 2, 0, mode="mean")
    np.testing.assert_array_equal(cols, want_c)
    np.testing.assert_array_equal(w, want_w)
    assert (cols == nodes[:, None]).all() and not w.any()


@pytest.mark.parametrize("path", ["native-1", "fallback"], indirect=True)
def test_unique_inverse_matches_jax(path):
    rng = np.random.default_rng(4)
    scratch = np.zeros(500, np.int32)
    for n in (0, 1, 9, 1000, 20000):
        v = rng.integers(0, 500, n).astype(np.int64)
        for kwargs in ({}, {"n_max": 500}, {"n_max": 500, "scratch": scratch}):
            got_u, got_i = tn.unique_inverse(v, **kwargs)
            want_u, want_i = jn.unique_inverse(v, **kwargs)
            np.testing.assert_array_equal(got_u, want_u)
            np.testing.assert_array_equal(got_i, want_i)
            assert got_i.dtype == np.int64
        assert not scratch.any()  # returned zeroed for reuse


@pytest.mark.parametrize("bad", [[-1, 3], [3, 500]])
def test_bounded_unique_refuses_ids_out_of_range(bad):
    if not tn.available():
        pytest.skip("graphkit did not build")
    for mod in (tn, jn):
        with pytest.raises(ValueError, match="outside"):
            mod.unique_inverse(np.array(bad, np.int64), 500)


def sbm_adj(n=400, seed=1):
    m = sp.random(n, n, density=0.03, random_state=seed, format="coo")
    return sym_normalize(symmetrize_max(m))


def assert_blocks_equal(got_blocks, want_blocks):
    assert len(got_blocks) == len(want_blocks)
    for g, w in zip(got_blocks, want_blocks):
        for name in ("cols", "weights", "self_idx"):
            np.testing.assert_array_equal(np.asarray(getattr(g, name)),
                                          np.asarray(getattr(w, name)))


@pytest.mark.parametrize("path", PATHS, indirect=True)
def test_sampler_stream_matches_jax(path):
    """Three successive calls: blocks (innermost first) and node sets equal
    to JAX's ``sample(pad=False)``; the outermost block's rows are the seeds."""
    a = sbm_adj()
    port = ts.NeighborSampler(a, fanouts=[4, 3], seed=11)
    jax_s = js.NeighborSampler(a, fanouts=[4, 3], seed=11)
    rng = np.random.default_rng(0)
    for _ in range(3):
        seeds = rng.integers(0, 400, 17)
        got, want = port.sample(seeds), jax_s.sample(seeds)
        np.testing.assert_array_equal(got.input_nodes, want.input_nodes)
        np.testing.assert_array_equal(got.output_nodes, want.output_nodes)
        assert_blocks_equal(got.blocks, want.blocks)
        assert got.blocks[-1].cols.shape == (17, 3) and got.blocks[0].cols.shape[1] == 4
        assert got.blocks[0].cols.dtype == torch.int32
    assert port.n_draws == jax_s._n_draws == 6


def test_draw_base_calls_in_any_order_equal_the_stream():
    a = sbm_adj()
    seq = ts.NeighborSampler(a, fanouts=[4, 3], seed=5)
    rng = np.random.default_rng(2)
    seed_batches = [rng.integers(0, 400, 9) for _ in range(4)]
    want = [seq.sample_np(s) for s in seed_batches]
    conc = ts.NeighborSampler(a, fanouts=[4, 3], seed=5)
    for i in (3, 1, 0, 2):
        blocks, nodes = conc.sample_np(seed_batches[i], draw_base=2 * i,
                                       scratch=conc.make_scratch())
        np.testing.assert_array_equal(nodes, want[i][1])
        for g, w in zip(blocks, want[i][0]):
            for x, y in zip(g, w):
                np.testing.assert_array_equal(x, y)
    assert conc.n_draws == 0  # the stream is left untouched
    if tn.available():
        conc.sample_np(seed_batches[0])  # allocates the shared table
        with pytest.raises(ValueError, match="own scratch"):
            conc.sample_np(seed_batches[0], draw_base=0)


def test_unpadded_blocks_are_the_real_rows_of_jax_padded_ones():
    a = sbm_adj(300, seed=3)
    seeds = np.random.default_rng(1).integers(0, 300, 17)
    got = ts.NeighborSampler(a, fanouts=[4, 4], seed=9).sample(seeds)
    padded = js.NeighborSampler(a, fanouts=[4, 4], seed=9).sample(seeds, pad=True)
    n_in = got.input_nodes.size
    np.testing.assert_array_equal(padded.input_nodes[:n_in], got.input_nodes)
    assert not padded.input_nodes[n_in:].any()
    for g, p in zip(got.blocks, padded.blocks):
        m = g.cols.shape[0]
        for name in ("cols", "weights", "self_idx"):
            np.testing.assert_array_equal(np.asarray(getattr(p, name))[:m],
                                          getattr(g, name).numpy())


def test_sampled_aggregation_unbiased():
    """E[sampled gcn aggregation] == the full A_hat @ h row
    (``tests/test_sampling.py::test_sampled_aggregation_unbiased``)."""
    rng = np.random.default_rng(0)
    n = 60
    a = sym_normalize(symmetrize_max(sp.random(n, n, density=0.2, random_state=0,
                                               format="coo")))
    h = torch.from_numpy(rng.normal(size=(n, 8)).astype(np.float32))
    full = a.toarray() @ h.numpy()
    sampler = ts.NeighborSampler(a, fanouts=[8], mode="gcn", seed=1)
    acc = np.zeros((n, 8))
    reps = 300
    for _ in range(reps):
        batch = sampler.sample(np.arange(n))
        h_in = h[torch.from_numpy(batch.input_nodes)]
        acc += ts.aggregate_block(batch.blocks[0], h_in).numpy()
    np.testing.assert_allclose(acc / reps, full, atol=0.15, rtol=0.2)


def _stream(prefetch, sampler_seed=7, **kw):
    a = sbm_adj(200, seed=2)
    rng = np.random.default_rng(0)
    seed_batches = [rng.integers(0, 200, 16) for _ in range(6)]
    sampler = ts.NeighborSampler(a, fanouts=[4, 4], seed=sampler_seed)
    return seed_batches, sampler, ts.iter_sampled_batches(sampler, seed_batches,
                                                         prefetch=prefetch, **kw)


@pytest.mark.parametrize("prefetch", [2, 0])
def test_prefetch_matches_the_serial_stream(prefetch):
    seed_batches, _, it = _stream(prefetch)
    _, serial_sampler, _ = _stream(0)
    got = list(it)
    assert len(got) == len(seed_batches)
    for (seeds, batch), want_seeds in zip(got, seed_batches):
        np.testing.assert_array_equal(seeds, want_seeds)
        want = serial_sampler.sample(want_seeds)
        np.testing.assert_array_equal(batch.input_nodes, want.input_nodes)
        assert_blocks_equal(batch.blocks, want.blocks)


def test_early_exit_stops_the_producer():
    calls = []
    seed_batches, sampler, _ = _stream(2)

    def slow_sample(seeds):
        calls.append(1)
        time.sleep(0.01)
        return sampler.sample(seeds)

    threads_before = threading.active_count()
    it = ts.iter_sampled_batches(sampler, seed_batches * 5, prefetch=2, sample_fn=slow_sample)
    next(it)
    it.close()
    # the producer stops within one batch of the request
    assert threading.active_count() == threads_before
    n = len(calls)
    time.sleep(0.05)
    assert len(calls) == n <= 1 + 2 + 2


def test_producer_exception_reaches_the_consumer():
    seed_batches, sampler, _ = _stream(2)

    def failing(seeds):
        if failing.n == 2:
            raise RuntimeError("sampler failed")
        failing.n += 1
        return sampler.sample(seeds)

    failing.n = 0
    it = ts.iter_sampled_batches(sampler, seed_batches, prefetch=2, sample_fn=failing)
    assert len([next(it), next(it)]) == 2
    with pytest.raises(RuntimeError, match="sampler failed"):
        next(it)


# ---------------------------------------------------------------------------
# the three sampled forwards against JAX's, values and gradients

F_IN, HEADS, HID, N_CLS = 6, 2, 3, 4


def jax_params(model, n_layers=2, tied=False):
    """Per-layer parameter lists as ``pygcn_tpu/apps/train_sampled.py``
    initialises them (biases drawn too, so that they are not zero)."""
    key = jax.random.key(3)
    if model == "gcn":
        dims = [F_IN] + [HID] * (n_layers - 1) + [N_CLS]
        out = []
        for fi, fo in zip(dims[:-1], dims[1:]):
            key, kw, kb = jax.random.split(key, 3)
            out.append({"w": jinit.graphconv_weight(kw, fi, fo),
                        "b": jinit.graphconv_bias(kb, fo)})
        return [{k: np.asarray(v) for k, v in p.items()} for p in out]
    out = []
    for fi, h, fo in tapp.gat_layer_dims(n_layers, F_IN, HEADS, HID, N_CLS):
        key, k1, k2, k3, kb = jax.random.split(key, 5)
        if model == "gat":
            p = {"w": jinit.graphconv_weight(k1, fi, h * fo),
                 "a_src": jinit.graphconv_weight(k2, h, fo),
                 "a_dst": jinit.graphconv_weight(k3, h, fo)}
        else:
            p = {"w_l": jinit.graphconv_weight(k1, fi, h * fo),
                 "a": jinit.graphconv_weight(k3, h, fo)}
            if not tied:
                p["w_r"] = jinit.graphconv_weight(k2, fi, h * fo)
        p["b"] = jinit.graphconv_bias(kb, h * fo)
        out.append({k: np.asarray(v) for k, v in p.items()})
    return out


JAX_FWD = {"gcn": js.sampled_gcn_forward, "gat": js.sampled_gat_forward,
           "gatv2": js.sampled_gatv2_forward}


def port_model(model, params):
    """A port model loaded with JAX's ``params`` through ``convert``."""
    m = tapp.MODELS[model].init(tapp.gat_layer_dims(2, F_IN, HEADS, HID, N_CLS)
                                if model != "gcn" else [F_IN, HID, N_CLS],
                                generator=torch.Generator().manual_seed(0))
    for layer, p in zip(m.layers, params):
        if "w_r" in layer and "w_r" not in p:  # tied: the layer holds no w_r
            del layer["w_r"]
    m.load_state_dict(convert.sampled_params_to_state_dict(params))
    return m


def blocks_case(case):
    """``(blocks_np, n_in)`` of one sampled batch for each parity case."""
    seeds = np.array([0, 5, 17, 299, 3, 8, 40, 41, 42, 120])
    if case == "all_isolated":
        sampler = ts.NeighborSampler(sp.csr_matrix((300, 300), dtype=np.float32), [3, 2])
    else:
        sampler = ts.NeighborSampler(csr_with_isolated(), [1, 1] if case == "k1" else [4, 3],
                                     seed=2)
    blocks, nodes = sampler.sample_np(seeds)
    if case == "all_isolated":
        assert not any(w.any() for _, w, _ in blocks)
    else:
        assert any((~(w > 0).any(1)).any() for _, w, _ in blocks)  # isolated rows
    return blocks, nodes.size


@pytest.mark.parametrize("case", ["isolated", "all_isolated", "k1"])
@pytest.mark.parametrize("model", ["gcn", "gat", "gatv2", "gatv2_tied"])
def test_sampled_forward_and_gradients_match_jax(model, case):
    tied = model == "gatv2_tied"
    kind = "gatv2" if tied else model
    params = jax_params(kind, tied=tied)
    blocks_np, n_in = blocks_case(case)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(n_in, F_IN)).astype(np.float32)
    cot = rng.normal(size=(10, N_CLS)).astype(np.float32)

    jblocks = [js.SampledBlock(*(jnp.asarray(t) for t in b)) for b in blocks_np]
    jbatch = js.SampledBatch(blocks=jblocks, input_nodes=None, output_nodes=None)

    def jloss(p, xx):
        out = JAX_FWD[kind](p, jbatch, xx)
        return (out * cot).sum(), out

    jp = jax.tree.map(jnp.asarray, params)
    (_, j_out), (j_gp, j_gx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(x))

    m = port_model(kind, params)
    tblocks = [ts.SampledBlock(*(torch.from_numpy(t) for t in b)) for b in blocks_np]
    tx = torch.from_numpy(x).requires_grad_()
    out = m(tblocks, tx)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), rtol=1e-5, atol=1e-5)
    assert torch.isfinite(tx.grad).all()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(j_gx), rtol=1e-4, atol=1e-4)
    grads = convert.state_dict_to_sampled_params(
        {k: p.grad for k, p in m.named_parameters()})
    for g, jg in zip(grads, j_gp):
        assert g.keys() == jg.keys()
        for k in g:
            assert np.isfinite(g[k]).all(), k
            np.testing.assert_allclose(g[k], np.asarray(jg[k]), rtol=1e-4, atol=1e-4,
                                       err_msg=k)


def test_convert_round_trip_and_names():
    params = jax_params("gatv2")
    m = port_model("gatv2", params)
    assert set(m.state_dict()) == {f"layers.{i}.{k}" for i in (0, 1)
                                   for k in ("w_l", "w_r", "a", "b")}
    back = convert.state_dict_to_sampled_params(m.state_dict())
    for p, q in zip(params, back):
        assert p.keys() == q.keys()
        for k in p:
            np.testing.assert_array_equal(p[k], q[k])


@pytest.mark.parametrize("model", ["gcn", "gat", "gatv2"])
def test_sampled_models_learn_sbm_labels(model):
    """``tests/test_sampling.py::test_sampled_training_reaches_accuracy``,
    ``::test_sampled_gat_trains`` and ``::test_sampled_gatv2_trains`` in the
    port: 60 (GATv2: 40) steps of 32 seeds on a 300-node SBM graph, fanouts
    [5, 5], then test accuracy above 0.6 with fanouts [10, 10] (GATv2: the
    training sampler's stream, its second layer tied)."""
    from pygcn_tpu_torch.graph.datasets import sbm_classification

    data = sbm_classification(n=300, n_classes=3, feat_dim=32, seed=0)
    a = data.graph.to_scipy().tocsr()
    sampler = ts.NeighborSampler(a, fanouts=[5, 5], mode="gcn", seed=0)
    gen = torch.Generator().manual_seed(0)
    if model == "gcn":
        net = tapp.SampledGCN.init([32, 16, data.n_classes], generator=gen)
    else:
        net = tapp.MODELS[model].init(tapp.gat_layer_dims(2, 32, 2, 8, data.n_classes),
                                      generator=gen)
        if model == "gatv2":  # the second layer's w_r tied to its w_l
            del net.layers[1]["w_r"]
    wd, steps = (0.0, 40) if model == "gatv2" else (5e-4, 60)
    opt = tapp.adam_l2(net.parameters(), 0.01, wd)
    x_all = torch.from_numpy(data.features)
    y_all = torch.from_numpy(data.labels.astype(np.int64))
    rng = np.random.default_rng(0)
    for _ in range(steps):
        seeds = rng.choice(data.idx_train, 32, replace=model == "gatv2")
        batch = sampler.sample(seeds)
        loss = tapp.train_step(net, opt, batch.blocks, x_all[batch.input_nodes],
                               y_all[seeds])
    assert torch.isfinite(loss)
    eval_sampler = sampler if model == "gatv2" else ts.NeighborSampler(a, [10, 10], seed=1)
    batch = eval_sampler.sample(data.idx_test)
    with torch.no_grad():
        logits = net(batch.blocks, x_all[batch.input_nodes])
    acc = float((logits.argmax(1) == y_all[data.idx_test]).float().mean())
    assert acc > 0.6, acc
