"""The check catches what it is there to catch. Each fault of
``benchmark/faults.py`` is planted under a whole run's timed path (the look
for a card skipped, on the CPU at a tiny size) and ``correct`` must come out
false; so must the control, the reference in TF32 put in the program's
place. The exchange between chips is no fault these one-chip cells can have,
and a training step produces no token."""

import time

import pytest
import torch

from benchmark import harness
from benchmark.compare import training_gaps
from benchmark.control import control
from benchmark.drivers import fullgraph
from benchmark.faults import FAULTS

CELLS = [w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", ["gcn_arxiv-clustered", "gat_arxiv-clustered"])
def test_fault_is_not_correct(tiny, monkeypatch, tmp_path, workload, fault):
    start = fullgraph.FullGraphRun.start

    def broken_start(run):
        FAULTS[fault](run)
        start(run)

    monkeypatch.setattr(fullgraph.FullGraphRun, "start", broken_start)
    result = harness.run_cell(tiny, workload, 5, 0.2, False, t0=time.perf_counter(),
                              device="cpu", out_dir=tmp_path)
    assert not result["correct"], result["compared"]


def _control_gaps(spec, workload, device):
    cell, config, mix, limits = harness.cell_files(spec, workload)
    run = fullgraph.FullGraphRun(config, mix, 3, device, harness.Spans())
    return training_gaps(control(run), run.reference(), run.params0), limits


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(tiny, workload):
    """TF32 emulated on the CPU: the products' operands rounded to 10 bits."""
    gaps, limits = _control_gaps(tiny, workload, "cpu")
    assert any(gaps[k] > limits[k] for k in gaps), gaps


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct_on_the_card(tiny, workload):
    """The real TF32 of cuBLAS, at the tiny size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gaps, limits = _control_gaps(tiny, workload, "cuda")
    assert any(gaps[k] > limits[k] for k in gaps), gaps
