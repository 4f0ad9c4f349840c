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
              "nn.gat", "nn.sage", "nn.gin", "apps.ab_kernel_stream", "convert",
              "sim", "sim.calibration", "sim.policies", "sim.draws", "sim.model", "sim.dist",
              "graph.covisit", "data", "data.features", "apps.common", "apps.gt_gen",
              "apps.no_vac_baseline", "apps.export_dynalearn", "apps.time_sim"):
        assert f"pygcn_tpu_torch.{m}" in mods
    assert len(mods) >= 52
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


@pytest.mark.parametrize("tool", ["time_spmm", "time_gat", "time_sim"])
def test_timing_tools_raise_without_cuda(monkeypatch, tool):
    """The kernel timing scripts time the card only, before building any graph."""
    import importlib

    app = importlib.import_module(f"pygcn_tpu_torch.apps.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="times the CUDA device"):
        app.main([])


def test_kernel_bits_needs_cuda_and_compares_fingerprints(monkeypatch, tmp_path, capsys):
    """``apps/kernel_bits`` runs on the card only; ``--compare`` reads two
    fingerprint files and reports, per kernel and shape, whether the trees'
    bits agree and whether each tree's two launches did."""
    import json

    from pygcn_tpu_torch.apps import kernel_bits

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no card"):
        kernel_bits.main([])
    old, new = tmp_path / "old.json", tmp_path / "new.json"
    old.write_text(json.dumps({"B1 H=40": ["a", "a"], "B2 H=40": ["b", "c"]}))
    new.write_text(json.dumps({"B1 H=40": ["a", "a"], "B2 H=40": ["d", "d"]}))
    kernel_bits.main(["--compare", str(old), str(new)])
    rows = json.loads(capsys.readouterr().out.splitlines()[0])
    assert rows == {"B1 H=40": {"same_bits": True, "old_repeats": True, "new_repeats": True},
                    "B2 H=40": {"same_bits": False, "old_repeats": False,
                                "new_repeats": True}}


def test_kernel_bits_reports_a_shape_change(tmp_path, capsys):
    """``--compare`` on fingerprints whose outputs changed shape between the
    trees (per-tile blocks ``[T, 128, H]`` in one, merged rows ``[N, H]`` in
    the other) marks the row ``changed_output`` with both shapes, not an
    error; rows of one shape, and a file of bits only, compare as before."""
    import json

    from pygcn_tpu_torch.apps import kernel_bits

    old, new = tmp_path / "old.json", tmp_path / "new.json"
    old.write_text("building the graph\n" + json.dumps({
        "B5s 8x8": {"bits": ["a", "a"], "shapes": [[2863, 128, 8]]},
        "B5 8x8": {"bits": ["b", "b"], "shapes": [[169343, 8]]},
        "B1 H=40": ["c", "c"]}))
    new.write_text(json.dumps({
        "B5s 8x8": {"bits": ["d", "e"], "shapes": [[169343, 8]]},
        "B5 8x8": {"bits": ["b", "b"], "shapes": [[169343, 8]]},
        "B1 H=40": {"bits": ["c", "c"], "shapes": [[169343, 40]]}}))
    rows = kernel_bits.compare(*(json.loads(p.read_text().splitlines()[-1]) for p in (old, new)))
    assert rows == {
        "B5s 8x8": {"same_bits": False, "old_repeats": True, "new_repeats": False,
                    "changed_output": [[[2863, 128, 8]], [[169343, 8]]]},
        "B5 8x8": {"same_bits": True, "old_repeats": True, "new_repeats": True},
        "B1 H=40": {"same_bits": True, "old_repeats": True, "new_repeats": True}}
    assert "changed output: ['B5s 8x8']" in capsys.readouterr().out.splitlines()[1]


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
