"""The saved-graph driver of ``gcn_products-clustered`` and the
``colpanel_*`` readers, on the CPU at a tiny size: the cache is built once
and read back with the bits the uncached pipeline gives; a whole run on the
column panels (their threshold lowered) is correct and counts its bucket
products; the readers on synthetic contexts."""

import time
import types

import pytest
import torch

import pygcn_tpu_torch.graph.graph as tgraph
import pygcn_tpu_torch.ops.colpanel as tcp
from benchmark import attribution, colpanel_work, harness, span_passes
from benchmark.drivers import fullgraph, fullgraph_saved
from benchmark.faults import FAULTS
from benchmark.layer_metrics import colpanel_buckets, colpanel_half_ms, colpanel_roofline
from benchmark.models import gcn
from benchmark.peaks import PEAKS
from benchmark.work import TileEdges

CELL = "gcn_products-clustered"
SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")


@pytest.fixture
def small(monkeypatch, tmp_path):
    """The cell's configuration and mix at 2,000 nodes, its cache in ``tmp_path``."""
    monkeypatch.setattr(fullgraph_saved, "CACHE", tmp_path / "datasets")
    _, config, mix, _ = harness.cell_files(SPEC, CELL)
    return config, dict(mix, n_nodes=2000)


def _coo(g):
    e = g.n_edges
    return g.senders[:e], g.receivers[:e], g.weights[:e]


def test_cache_is_built_once_and_read_back(small):
    config, mix = small
    first, again = harness.Spans(), harness.Spans()
    a = fullgraph_saved.build_graph(config, mix, first)
    b = fullgraph_saved.build_graph(config, mix, again)
    assert "cache_build" in first.seconds and "cache.locality_order" in first.seconds
    assert "cache_build" not in again.seconds and "load_layouts" in again.seconds
    assert "layout_build" in again.seconds  # what layout_build_s reads
    made = [p.name for p in fullgraph_saved.CACHE.iterdir()]
    assert made == [fullgraph_saved.cache_dir(mix).name]  # no temporary directory left
    plain = fullgraph.build_graph(config, mix, harness.Spans())
    for got in (a, b):
        assert (got.perm == plain.perm).all() and (got.aux == plain.aux).all()
        assert (got.raw != plain.raw).nnz == 0
        for x, y in zip(_coo(got.graph), _coo(plain.graph)):
            assert torch.equal(x, y)


def test_a_changed_mix_builds_its_own_cache(small):
    _, mix = small
    assert fullgraph_saved.cache_dir(mix) != fullgraph_saved.cache_dir(dict(mix, p_in=0.5))
    assert fullgraph_saved.cache_dir(mix) == fullgraph_saved.cache_dir(dict(mix))


def test_whole_run_on_the_column_panels(tiny, small, monkeypatch, tmp_path):
    """``run_cell`` with the column panels' threshold under the tiny graph:
    correct, and its bucket products counted (an epoch's: 6 products on the
    forward layout, 3 on the transpose)."""
    monkeypatch.setattr(tgraph, "COLPANEL_MIN_NODES", 1000)
    seen = []
    build = fullgraph_saved.build_graph
    monkeypatch.setattr(fullgraph_saved, "build_graph",
                        lambda *a: seen.append(build(*a)) or seen[-1])
    result = harness.run_cell(tiny, CELL, 2**31 + 9, 0.3, True, t0=time.perf_counter(),
                              device="cpu", out_dir=tmp_path)
    assert result["correct"], result["compared"]
    g = seen[0].graph
    assert g.colpanel is not None and g.hybrid is None
    live = lambda pe: sum(1 for _ in tcp.buckets(pe))  # noqa: E731
    want = 6 * live(g.colpanel) + 3 * live(g.colpanel_t)
    assert result["metrics"]["colpanel_buckets"]["value"] == want
    # off the card the device passes give nothing
    assert "colpanel_half_ms" not in result["metrics"]
    assert "colpanel_roofline" not in result["metrics"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct_on_the_column_panels(tiny, small, monkeypatch, tmp_path, fault):
    """Each planted fault under the saved driver's timed path, on the column
    panels: the cell's limits find it."""
    monkeypatch.setattr(tgraph, "COLPANEL_MIN_NODES", 1000)
    start = fullgraph_saved.SavedGraphRun.start

    def broken_start(run):
        FAULTS[fault](run)
        start(run)

    monkeypatch.setattr(fullgraph_saved.SavedGraphRun, "start", broken_start)
    result = harness.run_cell(tiny, CELL, 5, 0.2, False, t0=time.perf_counter(),
                              device="cpu", out_dir=tmp_path)
    assert not result["correct"], result["compared"]


def _x(name, cat, tid, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "tid": tid, "ts": ts, "dur": dur,
            "args": args}


def _trace():
    """One epoch: a forward whose ``spmm.colpanel`` span launches a gather
    (30 µs) beside a GEMM in ``model.forward`` (10 µs), and the backward on
    the autograd thread whose node opens ``spmm.colpanel`` and launches an
    add (20 µs)."""
    launch = lambda tid, ts, c: _x("cudaLaunchKernel", "cuda_runtime", tid, ts, 1,  # noqa: E731
                                   correlation=c)
    return [_x("bench.span_window", "user_annotation", 1, 0, 1000),
            _x("model.forward", "user_annotation", 1, 10, 300),
            # the autograd function's forward op, around the product's span
            _x("ColPanelSpMM", "cpu_op", 1, 15, 110, **{"Sequence number": 3}),
            _x("spmm.colpanel", "user_annotation", 1, 20, 100),
            launch(1, 30, 1),
            launch(1, 200, 2),
            _x(attribution.BACKWARD + "ColPanelSpMMBackward", "cpu_op", 2, 400, 100,
               **{"Sequence number": 3}),
            _x("spmm.colpanel", "user_annotation", 2, 410, 80),
            launch(2, 420, 3),
            _x("gather", "kernel", 7, 40, 30, correlation=1),
            _x("gemm", "kernel", 7, 210, 10, correlation=2),
            _x("index_add", "kernel", 7, 430, 20, correlation=3)]


@pytest.fixture
def traced(monkeypatch, tmp_path):
    """A context whose attributed pass reads :func:`_trace`."""
    import json

    path = tmp_path / f"{CELL}.spans.json"
    path.write_text(json.dumps({"traceEvents": _trace()}))
    monkeypatch.setattr(span_passes, "OUT", tmp_path)
    monkeypatch.setattr(span_passes, "on_card", lambda ctx: True)
    monkeypatch.setattr(span_passes, "_attribute", lambda ctx: attribution.read(
        str(path), ctx.mix["profile_steps"], span_passes.WINDOW))
    return types.SimpleNamespace(run=types.SimpleNamespace(), mix={"profile_steps": 1},
                                 cell={"name": CELL})


def test_half_ms_reads_the_colpanel_span(traced):
    assert colpanel_half_ms.read(traced) == pytest.approx(0.05)
    # the spans attribution.py knows are left as they were
    assert colpanel_work.SPAN not in attribution.SPANS


def test_the_shared_pass_is_the_same_whichever_reader_runs_first(traced):
    """Read first, the half leaves the pass the other readers share (and its
    printed ``span_device_ms``) without ``spmm.colpanel``."""
    assert colpanel_half_ms.read(traced) == pytest.approx(0.05)
    assert span_passes.attributed(traced).ms == pytest.approx({"model.forward": 0.06})


def test_half_ms_after_a_pass_made_without_the_span(traced):
    """An earlier reader's pass, made without ``spmm.colpanel``, gave its
    ops to ``model.forward``; the trace is read again with it."""
    assert span_passes.attributed(traced).ms == pytest.approx({"model.forward": 0.06})
    assert colpanel_half_ms.read(traced) == pytest.approx(0.05)


def test_roofline_counts_the_graph(traced):
    """Least time of the epoch's 9 products over the half's 0.05 ms."""
    import numpy as np
    import scipy.sparse as sp

    m = sp.random(300, 300, density=0.05, format="coo", random_state=0, dtype=np.float32)
    g = tgraph.Graph.from_scipy(m + sp.eye(300, dtype=np.float32), build_dense=False,
                                build_bcsr=False)
    config = harness.load_json(harness.HERE / "configs" / "gcn_products.json")
    traced.run.graph, traced.run.spec = g, gcn
    traced.config, traced.peak = config, PEAKS["NVIDIA H100 80GB HBM3"]
    e = g.n_edges
    assert colpanel_work.graph_edges(g) == TileEdges(e, 300, 300)
    nbytes = sum(e * 8 + 4 * w * 600 for w in (256, 256, 47)) * 3
    least_ms = nbytes / traced.peak["hbm_bytes_per_s"] * 1e3
    assert colpanel_roofline.read(traced) == pytest.approx(100 * least_ms / 0.05)


def test_buckets_reader_without_the_counter(monkeypatch):
    """A program without the counter (an earlier checkout) gives nothing and
    runs no epoch."""
    monkeypatch.delattr(tcp, "bucket_products")
    ctx = types.SimpleNamespace(run=types.SimpleNamespace(epoch=lambda: 1 / 0))
    assert colpanel_buckets.read(ctx) is None
