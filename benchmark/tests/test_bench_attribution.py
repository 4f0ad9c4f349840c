"""Device time by the program's spans (``benchmark/attribution.py``) on a
small synthetic Chrome trace, and the span readers through ``run_cell`` on
the CPU."""

import time

import pytest

from benchmark import attribution, harness, span_passes

SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")
MAIN, AUTOGRAD = 1, 2  # thread ids


def _x(name, cat, tid, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "tid": tid, "ts": ts, "dur": dur,
            "args": args}


def _launch(tid, ts, corr):
    return _x("cudaLaunchKernel", "cuda_runtime", tid, ts, 1, correlation=corr)


def _kernel(name, ts, dur, corr=None):
    args = {} if corr is None else {"correlation": corr}
    return _x(name, "kernel", 7, ts, dur, **args)


def _trace():
    """Two epochs of: a step around a forward whose ``spmm.ell`` span runs
    an index_select (sequence number 5, recorded first by an argmax in the
    step) and ``spmm.tile`` launches B1; the
    backward on the autograd thread, where the index_select's gradient
    launches with no span open and B1's own backward opens ``spmm.tile``;
    a kernel outside every span; and a copy with no launch record."""
    ev = [_x("bench.span_window", "user_annotation", MAIN, 0, 2000)]
    for k in range(2):
        t = 1000 * k
        ev += [_x("train_step", "user_annotation", MAIN, t + 10, 600),
               # makes no node: records the number index_select's node takes
               _x("aten::argmax", "cpu_op", MAIN, t + 12, 3, **{"Sequence number": 5 + 10 * k}),
               _x("model.forward", "user_annotation", MAIN, t + 20, 200),
               _x("spmm.ell", "user_annotation", MAIN, t + 30, 50),
               _x("aten::index_select", "cpu_op", MAIN, t + 35, 20,
                  **{"Sequence number": 5 + 10 * k}),
               _launch(MAIN, t + 40, 100 * k + 1),
               _x("spmm.tile", "user_annotation", MAIN, t + 90, 50),
               _launch(MAIN, t + 100, 100 * k + 2),
               _launch(MAIN, t + 180, 100 * k + 3),  # in model.forward alone
               _x(attribution.BACKWARD + "IndexSelectBackward0", "cpu_op", AUTOGRAD,
                  t + 300, 40, **{"Sequence number": 5 + 10 * k}),
               _launch(AUTOGRAD, t + 310, 100 * k + 4),
               _x(attribution.BACKWARD + "B1Backward", "cpu_op", AUTOGRAD, t + 400, 60,
                  **{"Sequence number": 6 + 10 * k}),
               _x("spmm.tile", "user_annotation", AUTOGRAD, t + 405, 50),
               _launch(AUTOGRAD, t + 410, 100 * k + 5),
               _launch(MAIN, t + 700, 100 * k + 6),  # after the step
               _kernel("gather", t + 45, 30, 100 * k + 1),
               _kernel("bcsr_spmm_kernel", t + 105, 40, 100 * k + 2),
               _kernel("add", t + 185, 5, 100 * k + 3),
               _kernel("index_add", t + 315, 50, 100 * k + 4),
               _kernel("bcsr_spmm_kernel", t + 415, 40, 100 * k + 5),
               _kernel("argmax", t + 705, 10, 100 * k + 6),
               _kernel("memcpy", t + 720, 4)]
    return ev


def test_launches_and_backward_ops_go_to_their_spans():
    a = attribution.attribute(_trace(), 2, "bench.span_window")
    assert a.ms == {"spmm.ell": pytest.approx(0.08), "spmm.tile": pytest.approx(0.08),
                    attribution.OUTSIDE: pytest.approx(0.01),
                    "model.forward": pytest.approx(0.005)}
    assert a.unattributed_ms == pytest.approx(0.004)
    assert a.busy_ms == pytest.approx(0.179)
    assert a.top["spmm.ell"] == [["index_add", pytest.approx(0.05)],
                                 ["gather", pytest.approx(0.03)]]


def test_idle_by_span_sums_the_gaps():
    a = attribution.attribute(_trace(), 2, "bench.span_window", n_gaps=1000)
    assert sum(a.idle_ms.values()) == pytest.approx(1 - 0.179)  # the window's rest an epoch
    # the gap of epoch 1's step between B1 and the add (145..185 µs) lies in
    # model.forward; the gap from the argmax to the copy (715..720) in none
    assert a.idle_ms["model.forward"] > 0 and a.idle_ms["none"] > 0
    assert set(a.idle_ms) <= {"train_step", "model.forward", "spmm.ell", "spmm.tile", "none"}
    few = attribution.attribute(_trace(), 2, "bench.span_window", n_gaps=2)
    assert sum(few.idle_ms.values()) < sum(a.idle_ms.values())


def test_half_ms_refuses_an_unattributed_trace(monkeypatch):
    class Run:
        pass

    ctx = type("Ctx", (), {"run": Run()})()
    monkeypatch.setattr(span_passes, "on_card", lambda ctx: True)
    a = attribution.attribute(_trace(), 2, "bench.span_window")
    monkeypatch.setattr(span_passes, "_attribute", lambda ctx: a)
    assert span_passes.half_ms(ctx, ("spmm.ell",)) is None  # 0.004 of 0.179 ms: over 1%
    a.unattributed_ms = 0.001
    assert span_passes.half_ms(ctx, ("spmm.ell", "gat.ell")) == pytest.approx(0.08)
    assert span_passes.half_ms(ctx, ("gat.tile",)) is None


NEW = ("ell_half_ms", "tile_half_ms", "enqueue_ms", "locality_order_s", "layouts_s")


@pytest.mark.parametrize("workload", ["gcn_arxiv-clustered", "gat_arxiv-clustered"])
def test_span_readers_through_run_cell(tiny, monkeypatch, tmp_path, workload, capsys):
    """On the CPU the passes run when let (on the card they always do): the
    host's spans read, the attribution finds no device op and gives
    nothing."""
    monkeypatch.setattr(span_passes, "on_card", lambda ctx: True)
    monkeypatch.setattr(span_passes, "OUT", tmp_path)
    result = harness.run_cell(tiny, workload, 2**31 + 5, 0.3, True, t0=time.perf_counter(),
                              device="cpu", out_dir=tmp_path)
    assert result["correct"]
    got = {k.split(".")[0]: v["value"] for k, v in result["metrics"].items()}
    assert {"enqueue_ms", "locality_order_s", "layouts_s"} <= set(got)
    assert "ell_half_ms" not in got and "tile_half_ms" not in got
    assert got["enqueue_ms"] > 0
    assert got["locality_order_s"] > 0 and got["layouts_s"] > 0
    err = capsys.readouterr().err
    assert "idle_by_span {" in err and "recorded epochs: " in err
    names = {m["name"].split(".")[0] for m in SPEC["per_layer"]}
    assert set(NEW) <= names
