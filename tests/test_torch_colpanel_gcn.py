"""The port's GCN on the column-panel layout against the benchmark's plain
reference, and the layout's span and counter.

A 3,000-node clustered graph (the benchmark's community generator) through
the port's host pipeline, built with ``colpanel_min_nodes`` lowered and
512-sender panels (6 panels), trains three steps of
``apps/train_fullgraph.train_step`` in float64 at the ogbn-products widths
(100 -> 256 -> 256 -> 47); ``benchmark/reference/gcn.py`` follows them on the
blocked adjacency of ``benchmark/reference/blocked.py``, from the same seeded
leaves. The layout keeps float32 edge values, so the port's operator is the
reference's rounded to float32 (2^-24 relative a value): every compared
number is held to 1e-5 relative, room for sums over a row's edges.
"""

import numpy as np
import pytest
import torch

import pygcn_tpu_torch.ops.colpanel as tcp
from benchmark import harness
from benchmark.generators import community
from benchmark.models import gcn as gcn_model
from benchmark.reference import adjacency, blocked
from benchmark.reference import gcn as gcn_ref
from benchmark.reference.training import follow
from pygcn_tpu_torch.apps.train_fullgraph import train_step
from pygcn_tpu_torch.graph.graph import Graph
from pygcn_tpu_torch.graph.transform import sym_normalize, symmetrize_max
from pygcn_tpu_torch.ops.spmm import spmm
from pygcn_tpu_torch.train.optim import adam_l2
from pygcn_tpu_torch.utils.logging import recording

torch.set_num_threads(1)

N, PANEL = 3000, 512
CONFIG = harness.load_json(harness.HERE / "configs" / "gcn_products.json")
MIX = dict(harness.load_json(harness.HERE / "traffic" / "clustered_products.json"), n_nodes=N)
RTOL = 1e-5

_CACHE = {}


def raw():
    if "raw" not in _CACHE:
        _CACHE["raw"] = community.graph(MIX)
    return _CACHE["raw"]


def graph():
    """The port's graph of the mix: column panels alone, transposes built."""
    if "graph" not in _CACHE:
        a = sym_normalize(symmetrize_max(raw()[0]))
        g = Graph.from_scipy(a, is_symmetric=False, build_dense=False, build_bcsr=False,
                             panel_width=PANEL, colpanel_min_nodes=N - 1)
        assert g.colpanel is not None and g.hybrid is None and g.ell is None
        assert len(g.colpanel.panels) >= 4 and g.colpanel_t is not g.colpanel
        _CACHE["graph"] = g
    return _CACHE["graph"]


def leaves(seed):
    gen = torch.Generator().manual_seed(seed)
    return {name: (torch.rand(shape, generator=gen, dtype=torch.float64) * 2 - 1) * bound
            for name, shape, bound in gcn_model.leaves(CONFIG)}


def inputs(seed):
    m, comm = raw()
    data = community.node_data(MIX, comm, CONFIG["in_features"], CONFIG["out_channels"],
                               seed, "cpu")
    return data.x.double(), data.labels, data.mask.double()


def port_steps(params0, x, labels, mask, steps):
    """The port's first ``steps`` steps: first log-probabilities, losses,
    first gradient and the leaves after the last update."""
    model = gcn_model.build(CONFIG, torch.Generator().manual_seed(0)).double()
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(params0[name])
    b1, b2 = CONFIG["adam_betas"]
    opt = adam_l2(model.parameters(), CONFIG["lr"], CONFIG["weight_decay"], b1=b1, b2=b2,
                  eps=CONFIG["adam_eps"])
    with torch.no_grad():
        logp = model(x, graph())
    losses, grad1 = [], None
    for _ in range(steps):
        losses.append(float(train_step(model, opt, x, labels, mask, graph())))
        if grad1 is None:
            grad1 = {n: p.grad.clone() for n, p in model.named_parameters()}
    return {"logp": logp, "losses": losses, "grad1": grad1,
            "params": {n: p.detach() for n, p in model.named_parameters()}}


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_colpanel_gcn_follows_the_blocked_reference(seed):
    params0 = leaves(seed)
    x, labels, mask = inputs(2 * seed)
    m = raw()[0]
    adj = blocked.normalized(m.row, m.col, m.data, N, "cpu", torch.float64,
                             block_bytes=8 * 256 * 5000)  # blocks of 5,000 edges at H = 256
    assert adj.rows.shape[0] > 10 * 5000
    ref = follow(gcn_ref, CONFIG, params0, adj, x, labels, mask, 3)
    got = port_steps(params0, x, labels, mask, 3)
    assert _rel(got["logp"], ref["logp"]) < RTOL
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=RTOL)
    for name in params0:
        assert _rel(got["grad1"][name], ref["grad1"][name]) < RTOL, name
        assert _rel(got["params"][name] - params0[name],
                    ref["params"][name] - params0[name]) < RTOL, name


@pytest.mark.parametrize("block", [1, 7, None])
def test_blocked_product_is_the_one_piece_product(block):
    """Forward and gradient, at blocks of 1 and 7 edges and one block of all."""
    rng = np.random.default_rng(0)
    n, e, d = 40, 300, 5
    rows, cols = rng.integers(0, n, e), rng.integers(0, n, e)
    one = adjacency.normalized(rows, cols, np.ones(e), n, "cpu", torch.float64)
    size = one.rows.shape[0] + 1 if block is None else block
    adj = blocked.BlockedAdjacency(one.rows, one.cols, one.weights, n, block_bytes=8 * d * size)
    assert adj.block_edges(torch.zeros(1, d, dtype=torch.float64)) == size
    x = torch.randn(n, d, dtype=torch.float64, generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    g = torch.randn(n, d, dtype=torch.float64, generator=torch.Generator().manual_seed(2))
    want = one.spmm(x)
    (want_dx,) = torch.autograd.grad(want, x, g)
    got = adj.spmm(x)
    (got_dx,) = torch.autograd.grad(got, x, g)
    torch.testing.assert_close(got, want, rtol=1e-13, atol=1e-13)
    torch.testing.assert_close(got_dx, want_dx, rtol=1e-13, atol=1e-13)


def test_span_once_per_product():
    """One training step: each layer's product forward, its gradient on the
    transpose layout backward, each in one ``spmm.colpanel`` span."""
    params0 = leaves(5)
    x, labels, mask = inputs(10)
    with recording() as records:
        port_steps(params0, x, labels, mask, 1)
    cp = [r for r in records if r.name == "spmm.colpanel"]
    # the first forward outside the step, then the step's forward and backward
    assert len(cp) == 3 * CONFIG["num_layers"]
    assert all(r.end_ns is not None for r in cp)
    assert not any(r.parent is not None and r.parent.name == "spmm.colpanel" for r in cp)


def _chunks(pe, h):
    return sum(len(tcp.row_chunks(cols.shape[0], cols.shape[1] * h,
                                  tcp.COLPANEL_CHUNK_BUDGET_ELEMS))
               for _, _, cols, _, _, _ in tcp.buckets(pe))


@pytest.mark.parametrize("budget", [None, 64])
def test_counter_counts_the_bucket_chunks(monkeypatch, budget):
    if budget is not None:
        monkeypatch.setattr(tcp, "COLPANEL_CHUNK_BUDGET_ELEMS", budget)
    monkeypatch.setattr(tcp, "bucket_products", 0)
    g, h = graph(), 16
    x = torch.randn(N, h, generator=torch.Generator().manual_seed(4), requires_grad=True)
    spmm(g, x).sum().backward()
    live = sum(1 for _ in tcp.buckets(g.colpanel)) + sum(1 for _ in tcp.buckets(g.colpanel_t))
    want = _chunks(g.colpanel, h) + _chunks(g.colpanel_t, h)
    assert tcp.bucket_products == want
    assert (want > live) == (budget is not None)
