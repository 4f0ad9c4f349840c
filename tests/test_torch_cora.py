"""The Cora path of the port against the JAX package: loaders, the Kipf GCN,
the classifier steps, early stopping, the plateau scheduler, the metrics,
dropout, and the two CLIs that use them (``apps/train_cora`` and
``apps/train_fullgraph --npz/--content/--cites``).

Real Cora is not in the repo (``tests/test_cora_real.py`` skips), so the
loaders read small ``.content``/``.cites``/``.npz`` files the tests write
themselves; both packages must give the same arrays and graphs. Weights are
carried from JAX by ``pygcn_tpu_torch.convert``; with dropout off, the Kipf
GCN agrees to 1e-5 (values) and 1e-4 (gradients, five Adam steps). Dropout
draws come from different generators in the two packages, so it is held to
its distribution, as ``tests/test_draws.py`` holds the simulator's draws: the
share of kept values within a binomial bound, and each kept value exactly
``x / keep``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_graph import assert_graph_equal

import pygcn_tpu.graph.datasets as jds
from pygcn_tpu.nn.models import KipfGCN as JKipf
from pygcn_tpu.train import adam_l2 as j_adam_l2
from pygcn_tpu.train import loop as jloop
from pygcn_tpu.train import metrics as jmetrics
from pygcn_tpu.train import optim as joptim

import pygcn_tpu_torch.graph.datasets as tds
from pygcn_tpu_torch import convert
from pygcn_tpu_torch.apps import train_cora as tcora
from pygcn_tpu_torch.apps import train_fullgraph as tapp
from pygcn_tpu_torch.nn import gat as tgat_nn
from pygcn_tpu_torch.nn import models as tmodels
from pygcn_tpu_torch.nn.gat import GAT as TGAT
from pygcn_tpu_torch.nn.layers import dropout
from pygcn_tpu_torch.nn.models import KipfGCN as TKipf
from pygcn_tpu_torch.ops import gat as tgat
from pygcn_tpu_torch.train import loop as tloop
from pygcn_tpu_torch.train import metrics as tmetrics
from pygcn_tpu_torch.train import optim as toptim
from pygcn_tpu_torch.utils import native

torch.set_num_threads(1)

VAL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
SPLITS = (range(12), range(12, 30), range(30, 60))


def write_planetoid(path, n=80, feat=24, classes=("ai", "db", "ml", "os"), seed=0):
    """A Cora-format pair: ``<id> <features> <label>`` lines with paper ids
    that are not 0..n-1, and ``<cited> <citing>`` lines, some naming papers
    absent from the content file (the loader skips them)."""
    rng = np.random.default_rng(seed)
    ids = rng.choice(10**6, n, replace=False)
    with open(path / "toy.content", "w") as fh:
        for i in ids:
            bits = " ".join(str(b) for b in (rng.uniform(size=feat) < 0.2).astype(int))
            fh.write(f"{i} {bits} {classes[rng.integers(len(classes))]}\n")
    with open(path / "toy.cites", "w") as fh:
        for _ in range(4 * n):
            a, b = rng.choice(ids, 2, replace=False)
            fh.write(f"{a} {b}\n")
        fh.write(f"{ids[0]} 999999999\n")
    return str(path / "toy.content"), str(path / "toy.cites")


def assert_data_equal(jd, td):
    for f in ("features", "labels", "idx_train", "idx_val", "idx_test"):
        np.testing.assert_array_equal(getattr(td, f), getattr(jd, f), err_msg=f)
    assert td.n_classes == jd.n_classes
    assert_graph_equal(jd.graph, td.graph)


@pytest.mark.parametrize("adj_norm", ["sym", "row"])
def test_load_planetoid_matches_jax(tmp_path, adj_norm):
    content, cites = write_planetoid(tmp_path)
    kw = dict(adj_norm=adj_norm, splits=SPLITS)
    assert_data_equal(jds.load_planetoid(content, cites, **kw),
                      tds.load_planetoid(content, cites, **kw))


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
def test_load_planetoid_structure_matches_jax(tmp_path, monkeypatch, use_native):
    """The edge list parsed by graphkit and by NumPy gives JAX's arrays."""
    _, cites = write_planetoid(tmp_path, n=300)
    jd = jds.load_planetoid_structure(cites, seed=3)
    if not use_native:
        monkeypatch.setattr(native, "_load", lambda: None)
    else:
        assert native.available()
    assert_data_equal(jd, tds.load_planetoid_structure(cites, seed=3))


def test_parse_edge_list_native_and_numpy_agree(tmp_path, monkeypatch):
    _, cites = write_planetoid(tmp_path)
    assert native.available()
    a = native.parse_edge_list(cites)
    monkeypatch.setattr(native, "_load", lambda: None)
    b = native.parse_edge_list(cites)
    raw = np.genfromtxt(cites, dtype=np.int64)
    for x, y, col in zip(a, b, (0, 1)):
        np.testing.assert_array_equal(x, raw[:, col])
        np.testing.assert_array_equal(y, raw[:, col])


def test_npz_round_trip_and_unmarked_file_match_jax(tmp_path):
    """``save_npz_dataset`` writes the normalized operator with its markers,
    which both loaders read back as it is; an unmarked file (raw edges, no
    splits) is sym-normalized by both alike."""
    data = tds.sbm_classification(n=300, seed=4)
    path = str(tmp_path / "d.npz")
    tds.save_npz_dataset(path, data)
    assert_data_equal(jds.load_npz_dataset(path), tds.load_npz_dataset(path))
    back = tds.load_npz_dataset(path)
    np.testing.assert_allclose(back.graph.to_scipy().toarray(),
                               data.graph.to_scipy().toarray(), rtol=1e-6, atol=1e-7)
    rng = np.random.default_rng(5)
    raw = str(tmp_path / "raw.npz")
    np.savez(raw, edge_index=rng.integers(0, 200, (2, 900)),
             features=rng.uniform(size=(200, 12)).astype(np.float32),
             labels=rng.integers(0, 3, 200))
    assert_data_equal(jds.load_npz_dataset(raw), tds.load_npz_dataset(raw))


def test_sbm_classification_matches_jax():
    kw = dict(n=500, n_classes=7, feat_dim=64, seed=42)
    assert_data_equal(jds.sbm_classification(**kw), tds.sbm_classification(**kw))


def kipf_pair(data, dropout_rate=0.0):
    jm = JKipf(nfeat=data.features.shape[1], nhid=16, nclass=data.n_classes,
               dropout=dropout_rate)
    params = jm.init(jax.random.key(0))
    tm = TKipf(data.features.shape[1], 16, data.n_classes, dropout=dropout_rate)
    tm.load_state_dict(convert.kipf_params_to_state_dict(params))
    return jm, params, tm


_DATA = {}


def sbm_data():
    if not _DATA:
        kw = dict(n=400, n_classes=7, feat_dim=64, seed=42)
        _DATA["j"], _DATA["t"] = jds.sbm_classification(**kw), tds.sbm_classification(**kw)
    return _DATA["j"], _DATA["t"]


def test_kipf_gcn_forward_and_gradients_match_jax():
    jd, td = sbm_data()
    jm, params, tm = kipf_pair(td)
    x = td.features
    cot = np.random.default_rng(1).normal(size=(x.shape[0], td.n_classes)).astype(np.float32)
    j_out, j_vjp = jax.vjp(lambda p: jm(p, jnp.asarray(x), jd.graph), params)
    (j_grads,) = j_vjp(jnp.asarray(cot))
    t_out = tm(torch.from_numpy(x), td.graph)
    (t_out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out), **VAL)
    t_grads = convert.state_dict_to_kipf_params(
        {k: p.grad for k, p in tm.named_parameters()})
    for layer in convert.KIPF_LAYERS:
        for name in ("w", "b"):
            np.testing.assert_allclose(t_grads[layer][name],
                                       np.asarray(j_grads[layer][name]), **GRAD)
    assert convert.state_dict_to_kipf_params(tm.state_dict())["gc2"]["w"].shape == (16, 7)


def test_five_classifier_steps_match_jax():
    """``make_classifier_steps`` with Adam and L2 decay: five steps' losses,
    the weights after them, and the eval step's loss and accuracy."""
    jd, td = sbm_data()
    jm, params, tm = kipf_pair(td)
    tx = j_adam_l2(0.01, 5e-4)
    opt_state = tx.init(params)
    j_train, j_eval = jloop.make_classifier_steps(jm, tx, jd.graph)
    t_train, t_eval = tloop.make_classifier_steps(
        tm, toptim.adam_l2(tm.parameters(), 0.01, 5e-4), td.graph)
    n = td.graph.n_nodes
    jx, jy = jnp.asarray(td.features), jnp.asarray(td.labels)
    tx_, ty = torch.from_numpy(td.features), torch.from_numpy(td.labels).long()
    jm_train, tm_train = jloop.bool_mask(td.idx_train, n), tloop.bool_mask(td.idx_train, n)
    np.testing.assert_array_equal(tm_train.numpy(), np.asarray(jm_train))
    for step in range(5):
        params, opt_state, j_loss = j_train(params, opt_state, jx, jy, jm_train,
                                            jax.random.key(step))
        t_loss = t_train(tx_, ty, tm_train)
        np.testing.assert_allclose(float(t_loss), float(j_loss), **GRAD)
    t_params = convert.state_dict_to_kipf_params(tm.state_dict())
    for layer in convert.KIPF_LAYERS:
        for name in ("w", "b"):
            np.testing.assert_allclose(t_params[layer][name], np.asarray(params[layer][name]),
                                       **GRAD)
    m_val = tloop.bool_mask(td.idx_val, n)
    j_l, j_a = j_eval(params, jx, jy, jnp.asarray(m_val.numpy()))
    t_l, t_a = t_eval(tx_, ty, m_val)
    np.testing.assert_allclose(float(t_l), float(j_l), **GRAD)
    assert float(t_a) == pytest.approx(float(j_a), abs=1e-6)
    assert float(tloop.nll_loss(torch.log_softmax(tx_[:5, :7], 1), ty[:5])) == pytest.approx(
        float(jloop.nll_loss(jax.nn.log_softmax(jx[:5, :7], 1), jy[:5])), rel=1e-6)


def test_early_stopping_matches_jax():
    losses = [1.0, 0.9, 0.95, 0.9, 0.89, 0.95, 0.96, 0.97, 0.7, 0.8, 0.8, 0.8]
    for patience, delta in ((2, 0.0), (3, 0.05)):
        j, t = jloop.EarlyStopping(patience, delta), tloop.EarlyStopping(patience, delta)
        for v in losses:
            assert t(v) == j(v)
            assert t.state_dict() == j.state_dict()
        fresh = tloop.EarlyStopping(patience, delta)
        fresh.load_state_dict(t.state_dict())
        assert fresh.state_dict() == t.state_dict()


@pytest.mark.parametrize("mode", ["min", "max"])
def test_reduce_lr_on_plateau_matches_jax(mode):
    """The same metric sequence gives the same reductions, learning rates and
    state in both packages (cooldown and the floor included)."""
    kw = dict(mode=mode, factor=0.5, patience=2, threshold=1e-3, min_lr=0.002, cooldown=1)
    j, t = joptim.ReduceLROnPlateau(**kw), toptim.ReduceLROnPlateau(**kw)
    j_state = j_adam_l2(0.01).init({"w": jnp.zeros(3)})
    t_opt = toptim.adam_l2([torch.nn.Parameter(torch.zeros(3))], 0.01)
    metrics = [1.0, 0.99, 0.995, 0.999, 1.0, 0.98, 0.98, 0.981, 0.99, 0.97, 0.97, 0.97, 0.97,
               0.97, 0.97, 0.97, 0.97]
    if mode == "max":
        metrics = [-m + 2 for m in metrics]
    for m in metrics:
        j_state, j_red = j.step(m, j_state)
        t_opt, t_red = t.step(m, t_opt)
        assert t_red == j_red
        assert toptim.get_learning_rate(t_opt) == pytest.approx(
            joptim.get_learning_rate(j_state), rel=1e-6)
        assert t.state_dict() == j.state_dict()
    assert toptim.get_learning_rate(t_opt) == pytest.approx(0.002)
    fresh = toptim.ReduceLROnPlateau(**kw)
    fresh.load_state_dict(t.state_dict())
    assert fresh.state_dict() == t.state_dict()


def test_metrics_match_jax_with_ties():
    rng = np.random.default_rng(2)
    pred = rng.integers(0, 5, 40).astype(np.float32)  # many ties
    target = (pred + rng.integers(-2, 3, 40)).astype(np.float32)
    logits = rng.normal(size=(40, 6)).astype(np.float32)
    labels = rng.integers(0, 6, 40)
    for a, b in ((pred, target), (target, pred), (pred, np.ones(40, np.float32)),
                 (rng.normal(size=40).astype(np.float32), target)):
        np.testing.assert_allclose(float(tmetrics.spearman(torch.from_numpy(a),
                                                           torch.from_numpy(b))),
                                   float(jmetrics.spearman(jnp.asarray(a), jnp.asarray(b))),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(tmetrics.mse(torch.from_numpy(pred),
                                                  torch.from_numpy(target))),
                               float(jmetrics.mse(jnp.asarray(pred), jnp.asarray(target))),
                               rtol=1e-6)
    assert float(tmetrics.accuracy(torch.from_numpy(logits), torch.from_numpy(labels))) == \
        pytest.approx(float(jmetrics.accuracy(jnp.asarray(logits), jnp.asarray(labels))))
    from scipy.stats import spearmanr

    assert float(tmetrics.spearman(torch.from_numpy(pred), torch.from_numpy(target))) == \
        pytest.approx(spearmanr(pred, target)[0], rel=1e-5)


def assert_dropout_distribution(pairs, rate):
    """``pairs`` of (input, dropped output): every value either zero or
    exactly ``x / keep``, and the share kept within six standard deviations
    of ``keep`` (a binomial count)."""
    keep = 1.0 - rate
    n = kept = 0
    for x, out in pairs:
        x, out = x.detach(), out.detach()
        live = x != 0
        dropped = out == 0
        torch.testing.assert_close(out[~dropped], x[~dropped] / keep, rtol=0, atol=0)
        n += int(live.sum())
        kept += int((live & ~dropped).sum())
    assert n > 1000
    assert abs(kept - n * keep) <= 6 * (n * keep * (1 - keep)) ** 0.5, (kept, n)


def capture_dropout(monkeypatch, module):
    pairs = []

    def recording(x, rate, generator):
        out = dropout(x, rate, generator)
        if generator is not None:
            pairs.append((x, out))
        return out

    monkeypatch.setattr(module, "dropout", recording)
    return pairs


@pytest.mark.parametrize("rate", [0.5, 0.2])
def test_dropout_function_distribution(rate):
    x = torch.randn(50_000)
    out = dropout(x, rate, torch.Generator().manual_seed(1))
    assert_dropout_distribution([(x, out)], rate)
    assert dropout(x, rate, None) is x and dropout(x, 0.0, torch.Generator()) is x


def test_kipf_gcn_dropout_distribution_and_eval(monkeypatch):
    """Input dropout on both layers in training mode with a generator;
    nothing dropped in eval mode or without one."""
    _, td = sbm_data()
    _, _, tm = kipf_pair(td, dropout_rate=0.5)
    pairs = capture_dropout(monkeypatch, tmodels)
    x = torch.from_numpy(td.features)
    tm.train()
    out = tm(x, td.graph, dropout_generator=torch.Generator().manual_seed(0))
    assert len(pairs) == 2 and pairs[0][0] is x
    assert_dropout_distribution(pairs, 0.5)
    tm.eval()
    ref = tm(x, td.graph, dropout_generator=torch.Generator().manual_seed(0))
    tm.train()
    torch.testing.assert_close(tm(x, td.graph), ref)
    assert len(pairs) == 2 and not torch.allclose(out, ref)


_GAT = {}


def gat_setup():
    if not _GAT:
        data = tds.community_classification(n=512, avg_degree=8.0, n_classes=4, feat_dim=16,
                                            seed=3, build_dense=False, build_ell=True,
                                            build_hybrid=True, hybrid_min_edges_per_tile=64)
        assert data.graph.hybrid.bcsr is not None
        _GAT["data"] = data
        _GAT["kw"] = dict(edge_map=tgat.build_edge_map(data.graph), hybrid_tiles=True,
                          tiles_t=tgat.build_gat_tiles_t(data.graph))
    return _GAT["data"], _GAT["kw"]


@pytest.mark.parametrize("path", ["ell", "coo"])
@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
def test_gat_input_and_attention_dropout_distribution(monkeypatch, v2, path):
    """Input dropout on both layers and attention dropout on each layer's
    coefficients (the COO path) or on its slots' numerator terms (the ELL
    one-pass: factors of a ones tensor), all from the one generator."""
    data, kw = gat_setup()
    kw = dict(kw) if path == "ell" else {}
    model = TGAT(16, 8, 4, heads=4, dropout=0.4, v2=v2,
                 generator=torch.Generator().manual_seed(1))
    pairs = capture_dropout(monkeypatch, tgat_nn)
    model.train()
    out = model(torch.from_numpy(data.features), data.graph,
                dropout_generator=torch.Generator().manual_seed(2), **kw)
    assert torch.isfinite(out).all()
    n_buckets = len(data.graph.ell.ks) if path == "ell" else 1
    assert len(pairs) == 2 + 2 * n_buckets
    assert_dropout_distribution(pairs, 0.4)


@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
def test_gat_training_with_dropout_calls_no_tile_path(monkeypatch, v2):
    """JAX's routing: a training step with dropout on the hybrid layout runs
    the slot path and reaches no tile-attention function; evaluation does."""
    data, kw = gat_setup()
    calls = []
    for name in ("gat_conv_hybrid", "gatv2_conv_hybrid"):
        real = getattr(tgat_nn, name)

        def counting(*a, _real=real, **k):
            calls.append(1)
            return _real(*a, **k)

        monkeypatch.setattr(tgat_nn, name, counting)
    model = TGAT(16, 8, 4, heads=2, dropout=0.5, v2=v2,
                 generator=torch.Generator().manual_seed(1))
    opt = toptim.adam_l2(model.parameters(), 0.01)
    x = torch.from_numpy(data.features)
    labels = torch.from_numpy(data.labels.astype(np.int64))
    mask = tloop.bool_mask(data.idx_train, data.graph.n_nodes)
    model.train()
    loss = tapp.train_step(model, opt, x, labels, mask, data.graph,
                           dropout_generator=torch.Generator().manual_seed(0), **kw)
    assert torch.isfinite(loss) and not calls
    model.eval()
    with torch.no_grad():
        model(x, data.graph, **kw)
    assert len(calls) == 2


def test_cora_clis_learn_on_one_seed():
    """Both CLIs on the synthetic SBM (seed 42): the JAX CLI test's band."""
    from pygcn_tpu.apps import train_cora as jcora

    argv = ["--epochs", "60", "--synthetic_nodes", "400", "--fastmode",
            "--data_dir", "no_such_dir"]
    t_acc = tcora.main(argv + ["--device", "cpu"])
    j_acc = jcora.main(argv)
    assert t_acc > 0.6 and j_acc > 0.6, (t_acc, j_acc)


def test_cora_cli_reads_planetoid_files_and_raises_without_cuda(tmp_path, monkeypatch):
    content, cites = write_planetoid(tmp_path, n=1600, feat=32)
    r = tcora.train(tcora.parse_args(["--data_dir", str(tmp_path), "--dataset", "toy",
                                      "--epochs", "3", "--device", "cpu", "--patience", "2"]))
    assert np.isfinite(r["test_loss"]) and 0.0 <= r["test_acc"] <= 1.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcora.main(["--data_dir", str(tmp_path), "--epochs", "1"])


def test_train_fullgraph_npz_reports_accuracy_beside_jax(tmp_path):
    """``--npz`` without ``--clustered``: both CLIs train the same GCN
    configuration on a small labelled file and return ``{"dt", "val",
    "test"}``; each lands above 0.6 and within 0.15 of the other (their
    weights start from different generators). ``--content``/``--cites``
    runs too."""
    from pygcn_tpu.apps import train_fullgraph as japp

    path = str(tmp_path / "sbm.npz")
    tds.save_npz_dataset(path, tds.sbm_classification(n=400, n_classes=4, feat_dim=32,
                                                      seed=7))
    argv = ["--npz", path, "--epochs", "40", "--layers", "2", "--hidden", "16",
            "--lr", "0.02"]
    t = tapp.main(argv + ["--device", "cpu"])
    j = japp.main(argv)
    assert set(t) == {"dt", "val", "test"} == set(j)
    for split in ("val", "test"):
        assert t[split] > 0.6 and j[split] > 0.6, (t, j)
        assert abs(t[split] - j[split]) <= 0.15, (t, j)
    content, cites = write_planetoid(tmp_path, n=1600, feat=16)  # the default splits
    r = tapp.main(["--content", content, "--cites", cites, "--epochs", "2", "--layers", "2",
                   "--hidden", "8", "--device", "cpu"])
    assert set(r) == {"dt", "val", "test"}
