"""The yardstick's counts on hand-counted shapes: the tile rooflines' bytes
and operations, the whole step's operations, and the readers built on them."""

import types

import numpy as np
import pytest
import scipy.sparse as sp

from benchmark import work
from benchmark.drivers.fullgraph import FullGraphRun
from benchmark.layer_metrics import gat_tile_roofline, spmm_tile_roofline, step_mfu
from benchmark.models import gat, gcn
from benchmark.trace import Trace

EDGES = work.TileEdges(edges=10, senders=4, receivers=3)
PEAK = {"hbm_bytes_per_s": 100.0, "f32_flops_per_s": 1000.0}
GCN = {"in_features": 4, "hidden_channels": 3, "num_layers": 2, "out_channels": 2}
GAT = {"in_features": 4, "heads": 2, "hidden_per_head": 3, "out_heads": 1, "out_channels": 2,
       "negative_slope": 0.2}


def test_spmm_tile_work():
    # 10 edges at 8 B, 4 operand and 3 output rows of 2 floats; 2 ops an edge and column
    assert work.spmm_tile_work(EDGES, 2) == (80 + 4 * 2 * 7, 40)
    assert work.spmm_tile_work(EDGES, 2, transpose=True) == (80 + 4 * 2 * 7, 40)


@pytest.mark.parametrize("kind,nbytes,ops", [
    ("fwd", 80 + 4 * (4 * 8 + 3 * 2 + 3 * 10), 10 * 2 * 12),
    ("bwd_recv", 80 + 4 * (4 * 8 + 3 * 12 + 3 * 2), 10 * 2 * 14),
    ("bwd_send", 80 + 4 * (4 * 8 + 3 * 12 + 4 * 8), 10 * 2 * 20),
])
def test_gat_tile_work(kind, nbytes, ops):
    assert work.gat_tile_work(EDGES, kind, 2, 3) == (nbytes, ops)


def test_least_seconds_says_what_bounds_it():
    assert work.least_seconds(200.0, 1000.0, PEAK) == (2.0, "bytes")
    assert work.least_seconds(100.0, 3000.0, PEAK) == (3.0, "operations")


def test_step_ops_by_hand():
    # GCN 4 -> 3 -> 2 on 5 nodes and 7 edges: forward 162 + 88, backward
    # 162 + 88 and the second layer's input gradient 60, the evaluation forward
    assert gcn.step_ops(GCN, 5, 7) == 2 * 250 + 310
    # GAT 4 -> 2x3 -> 1x2: forward 528 + 230, backward 956 + 516
    assert gat.step_ops(GAT, 5, 7) == 2 * (528 + 230) + (956 + 516)


def test_tile_edges_are_read_from_the_routed_edges():
    from pygcn_tpu_torch.ops.hybrid import build_hybrid

    rows = np.array([0, 0, 1, 8, 8, 0])
    cols = np.array([1, 2, 2, 9, 10, 9])
    m = sp.coo_matrix((np.ones(6, np.float32), (rows, cols)), shape=(16, 16))
    hy = build_hybrid(m, (8, 8), min_edges_per_tile=2)
    run = types.SimpleNamespace(graph=types.SimpleNamespace(hybrid=hy))
    assert FullGraphRun.tile_edges(run) == work.TileEdges(edges=5, senders=4, receivers=3)


def _ctx(config, spec, names, steps=2):
    run = types.SimpleNamespace(spec=spec, tile_edges=lambda: EDGES,
                                counts=lambda: {"n_nodes": 5, "n_edges": 7, "tile_edges": 10})
    records = [(n, 0.0, 3.0) for n in names] * steps
    trace = Trace(records, 1.0, 0.5, steps, [])
    return types.SimpleNamespace(run=run, config=config, peak=PEAK, trace=trace,
                                 record={"steps": 4, "seconds": 2.0})


def test_spmm_roofline_reader():
    names = ["void bcsr_spmm_kernel<float>(...)"] * 6
    least = sum(work.least_seconds(*work.spmm_tile_work(EDGES, w, t), PEAK)[0]
                for w, t in gcn.tile_launches(GCN))
    got = spmm_tile_roofline.read(_ctx(GCN, gcn, names))
    assert got == pytest.approx(100 * least / (6 * 3.0e-6))
    assert spmm_tile_roofline.read(_ctx(GCN, gcn, names[:5])) is None  # launches missing


def test_gat_roofline_reader():
    names = ["gat_fwd_item_kernel", "gat_bwd_dldst_item_kernel", "gat_bwd_sender_item_kernel",
             "gat_fwd_item_kernel"] * 2
    least = sum(work.least_seconds(*work.gat_tile_work(EDGES, k, h, f), PEAK)[0]
                for k, h, f in gat.tile_launches(GAT))
    got = gat_tile_roofline.read(_ctx(GAT, gat, names))
    assert got == pytest.approx(100 * least / (8 * 3.0e-6))


def test_step_mfu_reader():
    ctx = _ctx(GCN, gcn, [])
    assert step_mfu.read(ctx) == pytest.approx(100 * 810 / (0.5 * 1000.0))
