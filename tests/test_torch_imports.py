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
from pygcn_tpu_torch.ops.cuda import gat_tile_attn as gta

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        pygcn_tpu_torch.__path__, prefix="pygcn_tpu_torch."))


def test_every_module_imports_without_jax_or_pygcn_tpu():
    mods = port_modules()
    for m in ("ops.cuda.bcsr_spmm", "ops.cuda.gat_tile_attn", "ops.cuda.build", "ops.gat",
              "nn.gat", "nn.sage", "nn.gin", "apps.ab_kernel_stream", "convert"):
        assert f"pygcn_tpu_torch.{m}" in mods
    assert len(mods) >= 26
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


def test_ab_tool_default_device_raises_without_cuda(monkeypatch):
    from pygcn_tpu_torch.apps import ab_kernel_stream

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ab_kernel_stream.main(["--n_nodes", "200"])


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


def test_b2_wrapper_never_runs_plain_for_a_non_cpu_request(monkeypatch):
    g = _tiny_graph()
    before = (b1.launches, b1.stream_launches)
    with pytest.raises(ValueError, match="CUDA"):
        b1.bcsr_spmm_stream_cuda(g.bcsr, torch.ones(3, 4), n_rows=3)
    with pytest.raises(ValueError, match="cpu .plain. or cuda .kernel."):
        b1.bcsr_spmm_stream(g.bcsr, torch.ones(3, 4, device="meta"), n_rows=3)
    monkeypatch.setattr(b1, "BCSR_STREAM", True)
    with pytest.raises(ValueError, match="cpu .plain. or cuda .kernel."):
        b1.bcsr_spmm(g.bcsr, torch.ones(3, 4, device="meta"), n_rows=3)
    assert (b1.launches, b1.stream_launches) == before


def test_gat_stream_wrappers_never_run_plain_for_a_non_cpu_request(monkeypatch):
    g = Graph.from_coo([0, 1, 2], [1, 2, 0], n_nodes=3, build_bcsr=False, build_dense=False,
                       build_hybrid=True, build_ell=True, hybrid_min_edges_per_tile=1)
    bcsr = g.hybrid.bcsr
    bcsr_t = gta.transpose_bcsr(bcsr)
    lsrc, ldst, s2 = torch.zeros(3, 2), torch.zeros(3, 2), torch.zeros(3, 8)
    before = dict(gta.launches)
    with pytest.raises(ValueError, match="CUDA"):
        gta.tile_fwd_stream_cuda(bcsr, lsrc, ldst, s2, 2, 4, 0.2)
    args = (lsrc, ldst, s2, torch.zeros(3, 2), torch.zeros(3, 8), torch.zeros(3, 2), 2, 4, 0.2)
    with pytest.raises(ValueError, match="CUDA"):
        gta.tile_bwd_dldst_stream_cuda(bcsr, *args)
    with pytest.raises(ValueError, match="CUDA"):
        gta.tile_bwd_sender_stream_cuda(bcsr_t, *args)
    monkeypatch.setattr(gta, "TILE_REVISIT", False)
    meta = [t.to("meta") for t in (lsrc, ldst, s2)]
    with pytest.raises(ValueError, match="cpu .plain. or cuda .kernel."):
        gta.gat_tile_partials((2, 4, 0.2), bcsr, bcsr_t, *meta)
    assert gta.launches == before


def test_gat_tile_wrapper_never_runs_plain_for_a_non_cpu_request():
    g = Graph.from_coo([0, 1, 2], [1, 2, 0], n_nodes=3, build_bcsr=False, build_dense=False,
                       build_hybrid=True, build_ell=True, hybrid_min_edges_per_tile=1)
    bcsr = g.hybrid.bcsr
    bcsr_t = gta.transpose_bcsr(bcsr)
    lsrc, ldst, s2 = torch.zeros(3, 2), torch.zeros(3, 2), torch.zeros(3, 8)
    before = dict(gta.launches)
    with pytest.raises(ValueError, match="CUDA"):
        gta.tile_fwd_cuda(bcsr, lsrc, ldst, s2, 2, 4, 0.2)
    args = (lsrc, ldst, s2, torch.zeros(3, 2), torch.zeros(3, 8), torch.zeros(3, 2), 2, 4, 0.2)
    with pytest.raises(ValueError, match="CUDA"):
        gta.tile_bwd_dldst_cuda(bcsr, *args)
    with pytest.raises(ValueError, match="CUDA"):
        gta.tile_bwd_sender_cuda(bcsr_t, *args)
    meta = [t.to("meta") for t in (lsrc, ldst, s2)]
    with pytest.raises(ValueError, match="cpu .plain. or cuda .kernel."):
        gta.gat_tile_partials((2, 4, 0.2), bcsr, bcsr_t, *meta)
    assert gta.launches == before


def test_gatv2_tile_wrapper_never_runs_plain_for_a_non_cpu_request():
    g = Graph.from_coo([0, 1, 2], [1, 2, 0], n_nodes=3, build_bcsr=False, build_dense=False,
                       build_hybrid=True, build_ell=True, hybrid_min_edges_per_tile=1)
    bcsr = g.hybrid.bcsr
    bcsr_t = gta.transpose_bcsr(bcsr)
    sl2, sr2, a = torch.zeros(3, 8), torch.zeros(3, 8), torch.zeros(2, 4)
    before = dict(gta.launches)
    with pytest.raises(ValueError, match="CUDA"):
        gta.tile_v2_fwd_cuda(bcsr, sl2, sr2, a, 2, 4, 0.2)
    args = (sl2, sr2, a, torch.zeros(3, 2), torch.zeros(3, 8), torch.zeros(3, 2), 2, 4, 0.2)
    with pytest.raises(ValueError, match="CUDA"):
        gta.tile_v2_bwd_recv_cuda(bcsr, *args)
    with pytest.raises(ValueError, match="CUDA"):
        gta.tile_v2_bwd_send_cuda(bcsr_t, *args)
    meta = [t.to("meta") for t in (sl2, sr2, a)]
    with pytest.raises(ValueError, match="cpu .plain. or cuda .kernel."):
        gta.gatv2_tile_partials((2, 4, 0.2), bcsr, bcsr_t, *meta)
    assert gta.launches == before


def test_kernel_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()
