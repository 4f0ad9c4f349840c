"""The benchmark's process loads neither JAX nor the JAX package, compared
by whole top-level module names (``pygcn_tpu_torch`` begins with
``pygcn_tpu``), and the reference imports nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from benchmark import harness

SCRIPT = """
import json, sys, time
sys.path.insert(0, {root!r})
from benchmark import harness
full = harness.cell_files
def cut(spec, workload):
    cell, config, mix, limits = full(spec, workload)
    return cell, config, dict(mix, n_nodes=1500), limits
harness.cell_files = cut
spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
for w in ("gcn_arxiv-clustered", "gat_arxiv-clustered"):
    harness.run_cell(spec, w, 3, 0.2, True, t0=time.perf_counter(), device="cpu",
                     out_dir=__import__("pathlib").Path({out!r}))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_no_jax_in_the_benchmark_process(tmp_path):
    script = SCRIPT.format(root=str(harness.ROOT), out=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", script],
                         capture_output=True, text=True, timeout=600, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "pygcn_tpu_torch" in loaded  # the program ran
    assert not loaded & set(harness.FORBIDDEN)


def test_forbidden_names_are_compared_whole(monkeypatch):
    import pygcn_tpu_torch  # noqa: F401

    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_program():
    files = sorted((harness.HERE / "reference").glob("*.py"))
    assert files
    for f in files:
        bad = _imports(f) & {"pygcn_tpu_torch", *harness.FORBIDDEN}
        assert not bad, (f.name, bad)
