"""The port stands alone: no JAX, no ``pygcn_tpu``, and no silent CPU fallback."""

import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import pygcn_tpu_torch
from pygcn_tpu_torch.apps import train_fullgraph
from pygcn_tpu_torch.graph.graph import Graph
from pygcn_tpu_torch.ops.cuda import bcsr_spmm as b1
from pygcn_tpu_torch.ops.cuda import build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        pygcn_tpu_torch.__path__, prefix="pygcn_tpu_torch."))


def test_every_module_imports_without_jax_or_pygcn_tpu():
    mods = port_modules()
    assert "pygcn_tpu_torch.ops.cuda.bcsr_spmm" in mods and len(mods) >= 20
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'pygcn_tpu' or m.startswith('pygcn_tpu.'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cli_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_fullgraph.main(["--n_nodes", "200", "--epochs", "1"])


def _tiny_graph():
    return Graph.from_coo([0, 1, 2], [1, 2, 0], n_nodes=3, build_bcsr=True,
                          build_dense=False, build_hybrid=False, build_ell=False)


def test_b1_wrapper_never_runs_plain_for_a_non_cpu_request():
    g = _tiny_graph()
    before = b1.launches
    with pytest.raises(ValueError, match="CUDA"):
        b1.bcsr_spmm_cuda(g.bcsr, torch.ones(3, 4), n_rows=3)
    with pytest.raises(ValueError, match="cpu .plain. or cuda .kernel."):
        b1.bcsr_spmm(g.bcsr, torch.ones(3, 4, device="meta"), n_rows=3)
    assert b1.launches == before


def test_kernel_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()
