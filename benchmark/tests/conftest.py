"""Shared fixtures of the benchmark's CPU tests: the repository on the path,
and the cells' mixes cut to a graph a CPU test run can hold."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_NODES = 2000


@pytest.fixture
def tiny(monkeypatch):
    """Every cell's mix at ``TINY_NODES`` nodes (the structure otherwise the
    mix's own), for ``harness.run_cell`` on the CPU."""
    from benchmark import harness

    full = harness.cell_files

    def cut(spec, workload):
        cell, config, mix, limits = full(spec, workload)
        return cell, config, dict(mix, n_nodes=TINY_NODES), limits

    monkeypatch.setattr(harness, "cell_files", cut)
    return harness.load_json(ROOT / "BENCHMARK.json")
