"""The program's spans (``utils/logging.span``): a shared no-op when nothing
listens, ``record_function`` ranges under the profiler (also inside a custom
``autograd.Function``'s backward), records under ``recording()`` stamped on
the profiler trace's clock, and the counts an epoch of the full-graph path
opens."""

import contextlib
import json
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import pygcn_tpu_torch.graph.datasets as tds
from pygcn_tpu_torch.apps.train_fullgraph import GCN, _gat_layouts, train_step
from pygcn_tpu_torch.nn.gat import GAT
from pygcn_tpu_torch.parallel.partition import locality_order
from pygcn_tpu_torch.train.optim import adam_l2
from pygcn_tpu_torch.utils import logging as tlog
from pygcn_tpu_torch.utils.logging import recording, span

torch.set_num_threads(1)


class _Twice(torch.autograd.Function):
    """``2 x``, with a span in its backward."""

    @staticmethod
    def forward(ctx, x):
        with span("twice.fwd"):
            return x * 2

    @staticmethod
    def backward(ctx, g):
        with span("twice.bwd"):
            return g * 2


def _trace(prof, tmp_path) -> dict:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return json.load(f)


def _ranges(trace: dict, name: str) -> list:
    return [e for e in trace["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"] == name]


def test_off_is_one_shared_no_op(monkeypatch):
    def no_range(name):
        raise AssertionError(f"record_function({name!r}) made with nothing listening")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    assert span("a") is span("b")
    with span("a"), span("b"):
        pass
    with recording() as records:
        pass
    assert records == [] and tlog._recorders == []


def test_recorder_nests_by_thread():
    seen = {}

    def worker():
        with span("worker"):
            seen["thread"] = threading.get_native_id()

    with recording() as outer:
        with span("a"):
            with recording() as inner, span("b"):
                t = threading.Thread(target=worker)
                t.start()
                t.join()
        with span("c"):
            pass
    assert [r.name for r in outer] == ["a", "b", "worker", "c"]
    assert [r.name for r in inner] == ["b", "worker"] and inner[0] is outer[1]
    a, b, w, c = outer
    assert a.parent is None and b.parent is a and c.parent is None
    assert w.parent is None and w.thread == seen["thread"] != a.thread == b.thread
    assert a.start_ns <= b.start_ns <= b.end_ns <= a.end_ns <= c.start_ns <= c.end_ns
    assert tlog._recorders == []
    with span("after"):
        pass
    assert len(outer) == 4


@pytest.mark.parametrize("record", [False, True], ids=["profiler", "profiler+recorder"])
def test_profiler_ranges_also_inside_a_backward(tmp_path, record):
    x = torch.randn(64, 8, requires_grad=True)
    listen = recording() if record else contextlib.nullcontext([])
    with profile(activities=[ProfilerActivity.CPU]) as prof, listen as records:
        with span("step"):
            _Twice.apply(x).sum().backward()
    trace = _trace(prof, tmp_path)
    for name in ("step", "twice.fwd", "twice.bwd"):
        assert len(_ranges(trace, name)) == 1, name
    assert [r.name for r in records] == (["step", "twice.fwd", "twice.bwd"] if record else [])
    assert torch.equal(x.grad, torch.full_like(x, 2.0))


def test_records_land_on_the_profiler_timeline(tmp_path):
    """A record's stamps and the profiler's range of the same span agree
    within 1 ms on the trace's wall clock (``ts * 1000 + baseTimeNanoseconds``)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof, recording() as records:
        for k in range(3):
            with span(f"s{k}"):
                torch.randn(200, 200) @ torch.randn(200, 200)
    trace = _trace(prof, tmp_path)
    base = trace.get("baseTimeNanoseconds", 0)
    for rec in records:
        (ev,) = _ranges(trace, rec.name)
        start = ev["ts"] * 1000 + base
        end = start + ev["dur"] * 1000
        assert abs(rec.start_ns - start) < 1e6 and abs(rec.end_ns - end) < 1e6, rec.name


def _graph_and_model(model: str):
    data = tds.community_classification(n=512, avg_degree=8.0, n_classes=4, feat_dim=16,
                                        seed=3, build_dense=False, build_ell=True,
                                        build_hybrid=True, hybrid_min_edges_per_tile=64)
    assert data.graph.hybrid.bcsr is not None
    gen = torch.Generator().manual_seed(0)
    if model == "gcn":
        return data, GCN([16, 32, 32, 4], generator=gen), {}
    net = GAT(16, 8, 4, heads=2, out_heads=1, generator=gen)
    return data, net, _gat_layouts(data.graph, False)


# an epoch's spans on the hybrid layout: one step, the step's and the
# evaluation's forward, and each half of every sparse product (the GCN's
# 3 layers: forward, gradient, evaluation; the GAT's 2 layers: forward and
# evaluation, the backward running through autograd)
EPOCH = {"gcn": {"train_step": 1, "model.forward": 2, "spmm.ell": 9, "spmm.tile": 9},
         "gat": {"train_step": 1, "model.forward": 2, "gat.ell": 4, "gat.tile": 4}}


@pytest.mark.parametrize("model", sorted(EPOCH))
def test_an_epoch_opens_each_layer_span(model):
    data, net, kw = _graph_and_model(model)
    opt = adam_l2(net.parameters(), 0.01)
    x, labels = torch.as_tensor(data.features), torch.as_tensor(data.labels).long()
    mask = torch.zeros(data.graph.n_nodes)
    mask[:64] = 1
    train_step(net, opt, x, labels, mask, data.graph, **kw)  # warm
    with recording() as records:
        loss = train_step(net, opt, x, labels, mask, data.graph, **kw)
        with torch.no_grad():
            net(x, data.graph, **kw).argmax(dim=1)
    assert torch.isfinite(loss)
    counts = {}
    for r in records:
        counts[r.name] = counts.get(r.name, 0) + 1
    assert counts == EPOCH[model]
    (step,) = [r for r in records if r.name == "train_step"]
    fwd = [r for r in records if r.name == "model.forward"]
    assert [f.parent is step for f in fwd] == [True, False]
    assert all(r.end_ns is not None and r.end_ns >= r.start_ns for r in records)


def test_the_host_pipeline_spans():
    data = tds.community_classification(n=512, avg_degree=8.0, n_classes=4, feat_dim=16,
                                        seed=3, build_dense=False, build_ell=True,
                                        build_hybrid=True, hybrid_min_edges_per_tile=64)
    with recording() as records:
        locality_order(data.graph, "bfs")
        _gat_layouts(data.graph, False)
        type(data.graph).from_scipy(data.graph.to_scipy(), is_symmetric=True,
                                    build_dense=False, build_hybrid=True)
    assert [r.name for r in records] == ["pipeline.locality_order", "pipeline.layouts",
                                         "pipeline.layouts"]
