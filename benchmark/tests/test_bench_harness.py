"""The harness finds everything by name, and runs a whole cell end to end
on the CPU at a tiny size, against the reference."""

import importlib
import json
import math
import time

import pytest

from benchmark import harness

SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_files_load_by_name(workload):
    cell, config, mix, limits = harness.cell_files(SPEC, workload)
    assert config["name"] == cell["config"]
    assert importlib.import_module(f"benchmark.drivers.{mix['driver']}").Run
    assert importlib.import_module(f"benchmark.generators.{mix['generator']}").graph
    assert importlib.import_module(f"benchmark.models.{config['model']}").step_ops
    assert importlib.import_module(f"benchmark.reference.{config['model']}").forward
    assert set(limits) == {"logp_diff", "loss_gap", "grad_gap", "change_gap"}


@pytest.mark.parametrize("trace", [False, True])
def test_every_metric_has_a_reader(trace):
    family = "layer_metrics" if trace else "end_to_end"
    for m in SPEC["per_layer" if trace else "end_to_end"]:
        assert callable(harness.reader(family, m["name"]).read)


def test_config_files_name_their_cuts():
    for c in SPEC["configs"]:
        config = harness.load_json(harness.ROOT / c["file"])
        assert config["reduced"] == c["reduced"] and config["source"] == c["source"]
        assert set(config["changed"]) == set(c["reduced"])
        assert config["precision"] == {"dtype": "float32", "allow_tf32": False}


@pytest.mark.parametrize("workload", CELLS)
def test_cell_end_to_end_on_cpu(tiny, workload, tmp_path):
    result = harness.run_cell(tiny, workload, 2**31 + 7, 0.5, False, t0=time.perf_counter(),
                              device="cpu", out_dir=tmp_path)
    assert result["correct"], result["compared"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    wanted = {m["name"] for m in SPEC["end_to_end"] if workload in m.get("workloads", [workload])}
    assert set(result["metrics"]) == wanted and "setup_s" in wanted and len(wanted) >= 2
    assert list(result)[-1] == "compared"
    json.dumps(result)


def test_traced_run_on_cpu(tiny, tmp_path):
    """The per-layer readers on a CPU trace: the host's counts and spans
    read, the device's records are absent, so their readers give nothing."""
    result = harness.run_cell(tiny, "gcn_arxiv-clustered", 11, 0.3, True,
                              t0=time.perf_counter(), device="cpu", out_dir=tmp_path)
    assert result["correct"]
    assert set(result["metrics"]) == {"layout_build_s", "tile_edge_share"}
    assert 0 < result["metrics"]["tile_edge_share"]["value"] < 100
    assert result["device"]["window_s"] > 0
    assert result["breakdown"]["idle_gaps"]
    assert all(math.isfinite(c["value"]) for c in result["compared"].values())


def test_host_bound_cell_reports_its_step_per_layer(tiny, tmp_path):
    """The GAT clustered cell keeps its step time as the per-layer
    ``window_step_ms``, the window's seconds over its steps."""
    result = harness.run_cell(tiny, "gat_arxiv-clustered", 13, 0.3, True,
                              t0=time.perf_counter(), device="cpu", out_dir=tmp_path)
    assert result["correct"]
    assert "step_ms.attn" not in {m["name"] for m in SPEC["end_to_end"]}
    step = result["metrics"]["window_step_ms"]["value"]
    assert step > 0 and math.isfinite(step)
