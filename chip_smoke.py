#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pygcn_tpu_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``pygcn_tpu_torch/csrc`` (one
``nvcc`` per source, in parallel), holds each against its plain PyTorch
version on the card (the per-tile "stream" kernels also against the revisit
kernels: B2, whose merge is fused, against B1, and B4, B5s and B6s, once
merged, against B3, B5 and B6), holds a small GCN, a small GAT and a small
GATv2 on the card against the same models on the CPU, and drives the port's
main paths at the ogbn-arxiv sizes (169,343 nodes, average degree 13.3, the
hybrid layout) for a few epochs each through ``apps/train_fullgraph
--clustered``:

- the 3-layer GCN (widths 128/128/40): kernel B1, and with ``BCSR_STREAM``
  kernel B2;
- ``--model gat --hidden 8`` (2-layer GAT, 8 heads of 8 then 1 head of 40):
  kernels B3/B5/B6, and with ``TILE_REVISIT = False`` B4/B5s/B6s and their
  merges;
- ``--model gatv2 --hidden 8``: kernels B7/B8/B9;
- ``--model sage``, ``gin`` and ``appnp`` (128 -> 128 -> 40): kernel B1.

It checks that each path launched its kernels exactly as often as it must
and no other tile kernel, runs ``apps/ab_kernel_stream`` (revisit against
stream on the flagship graph) once, and times each kernel at its path's
shapes beside its bound. It prints each phase's wall time. Its last line is
``{"ok": true, "device": {...}}``; any failure exits non-zero before it.
Without a CUDA card, or outside a checkout, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Tolerances of the kernels against their plain versions on the card. Both
# sum the same f32 terms (bf16 tiles: for B1, x rounded to bf16 in both,
# products exact in f32; for B3-B9 the tiles only gate the mask) in another
# order, and B3 and B7 rescale their running sums as the max rises where the
# plain versions exponentiate once against the final max; with unit-normal
# inputs and sums of up to a few thousand terms the error stays below 1e-4
# relative.
RTOL = ATOL = 1e-4

# (heads, per-head width) of the GAT tile-kernel checks: both layers of the
# main path (8x8, 1x40), two more compiled widths (2x4, 4x16) and one that
# runs a wider kernel with its last columns masked (3x5, on the width-8 kernels).
GAT_SHAPES = ((2, 4), (8, 8), (4, 16), (1, 40), (3, 5))
# GATv2's add the widest compiled width, where B8 holds the most registers.
GATV2_SHAPES = GAT_SHAPES + ((1, 64),)
SLOPE = 0.2


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def setup():
    if not os.path.isdir(os.path.join(HERE, "pygcn_tpu_torch")):
        fail(f"{HERE} holds no pygcn_tpu_torch package; run from a checkout of the repo")
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    if not out:
        fail("nvidia-smi printed no card")
    return out[0]


def build_kernels():
    from pygcn_tpu_torch.ops.cuda import build

    t0 = time.time()
    logs = build.build(force=True)
    secs = time.time() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    print(f"kernel build: {', '.join(logs)} in {secs:.1f}s (one nvcc per source, in parallel)",
          flush=True)


def _random_bcsr(rng, n_rows, n_cols, density, empty_block_row, drop_padding, dtype):
    """A BCSR with ragged edges and one block row without entries."""
    import dataclasses

    import numpy as np
    import scipy.sparse as sp

    from pygcn_tpu_torch.graph.graph import _build_bcsr, drop_zero_tiles

    m = sp.random(n_rows, n_cols, density=density, random_state=rng,
                  data_rvs=rng.standard_normal, format="coo", dtype=np.float32)
    keep = m.row // 128 != empty_block_row
    m = sp.coo_matrix((m.data[keep], (m.row[keep], m.col[keep])), shape=m.shape)
    b = _build_bcsr(m, (128, 128))
    if drop_padding:
        # the builder gives the empty block row an all-zero tile; the kernel
        # must not need it, so this variant has none
        b = drop_zero_tiles(b)
    return dataclasses.replace(b, data=b.data.to(dtype))


def check_b1(torch):
    """Kernel B1 against its plain version on the card: values and gradient,
    and on the long-row tile set values and the same bits in two launches."""
    import numpy as np

    from pygcn_tpu_torch.apps.time_spmm import long_row_counts, long_row_tiles
    from pygcn_tpu_torch.graph.graph import Graph
    from pygcn_tpu_torch.ops.cuda import bcsr_spmm as b1

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    worst = 0.0
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for drop_padding in (False, True):
            b = _random_bcsr(rng, 300, 270, 0.05, 1, drop_padding, dtype).to(dev)
            for h in (1, 40, 128, 200):
                x = torch.from_numpy(rng.standard_normal((270, h)).astype(np.float32)).to(dev)
                got = b1.bcsr_spmm(b, x, n_rows=300)
                ref = b1.bcsr_spmm_plain(b, x, n_rows=300)
                torch.cuda.synchronize()
                if got.shape != (300, h) or not torch.isfinite(got).all():
                    fail(f"B1 {dtype} H={h}: shape {tuple(got.shape)} or non-finite values")
                torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
                if not torch.all(got[128:256] == 0):
                    fail(f"B1 {dtype} H={h}: the empty block row is not zero")
                worst = max(worst, float((got - ref).abs().max()))
                cases += 1
        b, n_rows, n_cols = long_row_tiles(b1.MAX_TILES, rng, dtype)
        b = b.to(dev)
        for h in (1, 40, 128, 200):
            x = torch.from_numpy(rng.standard_normal((n_cols, h)).astype(np.float32)).to(dev)
            got = b1.bcsr_spmm(b, x, n_rows=n_rows)
            again = b1.bcsr_spmm(b, x, n_rows=n_rows)
            ref = b1.bcsr_spmm_plain(b, x, n_rows=n_rows)
            torch.cuda.synchronize()
            if got.shape != (n_rows, h) or not torch.isfinite(got).all():
                fail(f"B1 long rows {dtype} H={h}: shape {tuple(got.shape)} or non-finite")
            torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
            if not torch.equal(got, again) or got[:128].any():
                fail(f"B1 long rows {dtype} H={h}: two launches differ, or the block row "
                     f"without tiles is not zero")
            worst = max(worst, float((got - ref).abs().max()))
            cases += 1

    # asymmetric graph: forward on bcsr, gradient through bcsr_t
    n = 300
    src = rng.integers(0, n, 3000)
    dst = rng.integers(0, n, 3000)
    keep = dst // 128 != 1
    w = rng.standard_normal(int(keep.sum())).astype(np.float32)
    g = Graph.from_coo(src[keep], dst[keep], w, n_nodes=n, build_dense=False,
                       build_bcsr=True, build_ell=False, build_hybrid=False).to(dev)
    from pygcn_tpu_torch.ops.spmm import spmm

    for h in (1, 40, 128, 200):
        x = torch.from_numpy(rng.standard_normal((n, h)).astype(np.float32)).to(dev)
        cot = torch.from_numpy(rng.standard_normal((n, h)).astype(np.float32)).to(dev)
        xg = x.clone().requires_grad_(True)
        y = spmm(g, xg, impl="bcsr")
        (dx,) = torch.autograd.grad(y, xg, cot)
        y_ref = b1.bcsr_spmm_plain(g.bcsr, x, n_rows=n)
        dx_ref = b1.bcsr_spmm_plain(g.bcsr_t, cot, n_rows=n)
        torch.cuda.synchronize()
        torch.testing.assert_close(y, y_ref, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(dx, dx_ref, rtol=RTOL, atol=ATOL)
        worst = max(worst, float((y - y_ref).abs().max().detach()), float((dx - dx_ref).abs().max()))
        cases += 2
    print(f"B1 vs plain on the card: {cases} cases (f32 and bf16 tiles, ragged 300x270, "
          f"empty block row with and without its padding tile, H in 1/40/128/200, "
          f"BCSRSpMM value and gradient on an asymmetric graph; block rows of "
          f"{long_row_counts(b1.MAX_TILES)} tiles, bitwise equal in two launches) "
          f"within rtol=atol={RTOL}; max abs err {worst:.3e}", flush=True)


def _gat_tiles(rng, symmetric, dtype, drop_padding):
    """Ragged 300-node tile sets whose block row 1 has no edge, with or
    without the builder's zero padding tile, and their exact transpose (which
    has that empty block row too when the set is symmetric)."""
    import dataclasses

    import numpy as np
    import scipy.sparse as sp

    from pygcn_tpu_torch.graph.graph import _build_bcsr, drop_zero_tiles
    from pygcn_tpu_torch.ops.cuda import gat_tile_attn as gta

    m = sp.random(300, 300, density=0.05, random_state=rng, format="coo", dtype=np.float32)
    keep = (m.row // 128 != 1) & ((m.col // 128 != 1) | (not symmetric))
    m = sp.coo_matrix((rng.uniform(0.5, 2.0, int(keep.sum())).astype(np.float32),
                       (m.row[keep], m.col[keep])), shape=m.shape)
    if symmetric:
        m = m.maximum(m.T).tocoo()
    b = _build_bcsr(m, (128, 128))
    bt = gta.transpose_bcsr(b)
    if drop_padding:
        b, bt = drop_zero_tiles(b), drop_zero_tiles(bt)
    return tuple(dataclasses.replace(x, data=x.data.to(dtype)).to("cuda") for x in (b, bt))


def check_gat_tiles(torch, v2: bool):
    """Kernels B3, B5 and B6 (with ``v2``: B7, B8 and B9) against their plain
    versions on the card: the partials and their VJP through
    ``GATTilePartials`` (``dlsrc``, ``dldst``, ``ds``) or ``GATv2TilePartials``
    (``dsl``, ``dsr``, ``da``)."""
    import numpy as np

    from pygcn_tpu_torch.ops.cuda import gat_tile_attn as gta

    names, shapes, seed = ("B7/B8/B9", GATV2_SHAPES, 2) if v2 else ("B3/B5/B6", GAT_SHAPES, 1)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    worst = 0.0
    cases = 0
    for symmetric in (False, True):
        for dtype in (torch.float32, torch.bfloat16):
            for drop_padding in (False, True):
                b, bt = _gat_tiles(rng, symmetric, dtype, drop_padding)
                for h, f in shapes:
                    op_shapes = (((300, h * f), (300, h * f), (h, f)) if v2
                                 else ((300, h), (300, h), (300, h * f)))
                    ops = [torch.randn(*shape, device="cuda", generator=gen)
                           for shape in op_shapes]
                    cot = [torch.randn(300, w, device="cuda", generator=gen) for w in (h * f, h)]
                    args = [o.clone().requires_grad_(True) for o in ops]
                    partials = gta.gatv2_tile_partials if v2 else gta.gat_tile_partials
                    got = partials((h, f, SLOPE), b, bt, *args)
                    grads = torch.autograd.grad(got[:2], args, cot)
                    ref = (gta.tile_v2_fwd_plain if v2 else gta.tile_fwd_plain)(
                        b, *ops, h, f, SLOPE)
                    bwd = (*ops, ref[2], *cot, h, f, SLOPE)
                    if v2:
                        dsr, dapart = gta.tile_v2_bwd_recv_plain(b, *bwd)
                        ref_grads = (gta.tile_v2_bwd_send_plain(bt, *bwd), dsr,
                                     dapart.sum(dim=0).view(h, f))
                    else:
                        ds, dlsrc = gta.tile_bwd_sender_plain(bt, *bwd)
                        ref_grads = (dlsrc, gta.tile_bwd_dldst_plain(b, *bwd), ds)
                    torch.cuda.synchronize()
                    label = (f"{names} {'sym' if symmetric else 'asym'} {dtype} "
                             f"{'no tile' if drop_padding else 'padding tile'} H={h} F={f}")
                    for a, r in list(zip(got, ref)) + list(zip(grads, ref_grads)):
                        if a.shape != r.shape or not torch.isfinite(a).all():
                            fail(f"{label}: shape {tuple(a.shape)} or non-finite values")
                        torch.testing.assert_close(a.detach(), r, rtol=RTOL, atol=ATOL)
                        worst = max(worst, float((a.detach() - r).abs().max()))
                    # grads[1] is the receiver gradient: dldst, or dsr
                    if not ((got[2][128:256] == gta.NEG).all() and not got[0][128:256].any()
                            and not got[1][128:256].any() and not grads[1][128:256].any()):
                        fail(f"{label}: the block row without edges is not num = den = 0, "
                             f"m = NEG, {'dsr' if v2 else 'dldst'} = 0")
                    cases += 1
    vjp = ("dsl/dsr/da through GATv2TilePartials" if v2
           else "dlsrc/dldst/ds through GATTilePartials")
    print(f"{names} vs plain on the card: {cases} cases (asymmetric and symmetric ragged "
          f"300-node tile sets, f32 and bf16 tiles, an empty block row with and without its "
          f"padding tile, (H, F) in {list(shapes)}; num/den/m and the VJP {vjp}) within "
          f"rtol=atol={RTOL}; max abs err {worst:.3e}", flush=True)


def check_stream_kernels(torch):
    """B2 (its merge fused: it writes ``[n_rows, H]``) against the plain
    per-tile parts merged by block row and against B1, over the grids of
    :func:`check_b1` and its long-row tile set; B4, B5s and B6s against
    their plain per-tile blocks over the grids of :func:`check_gat_tiles`,
    each merged output against the revisit kernel's (B3, B5, B6); and the
    stream mode of ``GATTilePartials`` (values and VJP) against its revisit
    mode."""
    import numpy as np

    from pygcn_tpu_torch.apps.time_spmm import long_row_tiles
    from pygcn_tpu_torch.ops.cuda import bcsr_spmm as b1
    from pygcn_tpu_torch.ops.cuda import gat_tile_attn as gta

    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    worst, cases = 0.0, 0

    def close(a, r, label):
        nonlocal worst
        if a.shape != r.shape or not torch.isfinite(a).all():
            fail(f"{label}: shape {tuple(a.shape)} (want {tuple(r.shape)}) or non-finite values")
        torch.testing.assert_close(a, r, rtol=RTOL, atol=ATOL)
        worst = max(worst, float((a - r).abs().max()))

    for dtype in (torch.float32, torch.bfloat16):
        sets = [(f"{'no tile' if drop else 'padding tile'}",
                 (_random_bcsr(rng, 300, 270, 0.05, 1, drop, dtype), 300, 270), 128)
                for drop in (False, True)]
        sets.append(("long rows", long_row_tiles(b1.MAX_TILES, rng, dtype), 0))
        for name, (b, n_rows, n_cols), empty in sets:
            b = b.to(dev)
            for h in (1, 40, 128, 200):
                label = f"B2 {dtype} {name} H={h}"
                x = torch.from_numpy(rng.standard_normal((n_cols, h)).astype(np.float32)).to(dev)
                fused = b1.bcsr_spmm_stream(b, x, n_rows=n_rows)
                revisit = b1.bcsr_spmm_cuda(b, x, n_rows=n_rows)
                torch.cuda.synchronize()
                close(fused, b1.sum_by_block_row(b1.bcsr_spmm_stream_plain(b, x), b, n_rows),
                      label)
                close(fused, revisit, label + " vs B1")
                if fused[empty:empty + 128].any():
                    fail(f"{label}: the empty block row is not zero")
                cases += 1

    gen = torch.Generator(device="cuda").manual_seed(4)
    saved = gta.TILE_REVISIT
    try:
        for symmetric in (False, True):
            for dtype in (torch.float32, torch.bfloat16):
                for drop_padding in (False, True):
                    b, bt = _gat_tiles(rng, symmetric, dtype, drop_padding)
                    for h, f in GAT_SHAPES:
                        label = (f"B4/B5s/B6s {'sym' if symmetric else 'asym'} {dtype} "
                                 f"{'no tile' if drop_padding else 'padding tile'} H={h} F={f}")
                        ops = [torch.randn(300, w, device="cuda", generator=gen)
                               for w in (h, h, h * f)]
                        cot = [torch.randn(300, w, device="cuda", generator=gen)
                               for w in (h * f, h)]
                        blocks = gta.tile_fwd_stream(b, *ops, h, f, SLOPE)
                        merged = gta.softmax_merge(b, *blocks, 300)
                        bwd = (*ops, merged[2], *cot, h, f, SLOPE)
                        dl_t = gta.tile_bwd_dldst_stream(b, *bwd)
                        ds_t, dls_t = gta.tile_bwd_sender_stream(bt, *bwd)
                        got = (*blocks, dl_t, ds_t, dls_t)
                        ref = (*gta.tile_fwd_stream_plain(b, *ops, h, f, SLOPE),
                               gta.tile_bwd_dldst_stream_plain(b, *bwd),
                               *gta.tile_bwd_sender_stream_plain(bt, *bwd))
                        rev = gta.tile_fwd_cuda(b, *ops, h, f, SLOPE)
                        rev_bwd = (gta.tile_bwd_dldst_cuda(b, *bwd),
                                   *gta.tile_bwd_sender_cuda(bt, *bwd))
                        mer_bwd = (b1.sum_by_block_row(dl_t, b, 300),
                                   b1.sum_by_block_row(ds_t, bt, 300),
                                   b1.sum_by_block_row(dls_t, bt, 300))
                        modes = {}
                        for revisit in (True, False):
                            gta.TILE_REVISIT = revisit
                            args = [o.clone().requires_grad_(True) for o in ops]
                            out = gta.gat_tile_partials((h, f, SLOPE), b, bt, *args)
                            modes[revisit] = [o.detach() for o in out] + list(
                                torch.autograd.grad(out[:2], args, cot))
                        gta.TILE_REVISIT = saved
                        torch.cuda.synchronize()
                        for a, r in zip(got, ref):
                            close(a, r, label)
                        for a, r in zip((*merged, *mer_bwd), (*rev, *rev_bwd)):
                            close(a, r, label + " merged vs B3/B5/B6")
                        for a, r in zip(modes[False], modes[True]):
                            close(a, r, label + " GATTilePartials stream vs revisit")
                        if not ((merged[2][128:256] == gta.NEG).all()
                                and not merged[0][128:256].any()
                                and not merged[1][128:256].any()
                                and not mer_bwd[0][128:256].any()):
                            fail(f"{label}: the block row without edges is not num = den = 0, "
                                 f"m = NEG, dldst = 0")
                        cases += 1
    finally:
        gta.TILE_REVISIT = saved
    print(f"B2/B4/B5s/B6s vs plain on the card: {cases} cases (B2 on B1's grids, its fused "
          f"output vs the plain parts merged and vs B1; B4/B5s/B6s on the GAT grid, (H, F) in "
          f"{list(GAT_SHAPES)}: per-tile blocks vs plain, merged outputs vs B3/B5/B6, "
          f"GATTilePartials stream vs revisit (values and VJP)), within rtol=atol={RTOL}; "
          f"max abs err {worst:.3e}", flush=True)


def check_small_reference(torch):
    """The GCN on the card against the same GCN on the CPU (plain versions),
    on a small clustered graph with tiles: log-probs, loss and gradients."""
    import numpy as np

    from pygcn_tpu_torch.apps.train_fullgraph import GCN, masked_nll
    from pygcn_tpu_torch.graph.datasets import community_classification

    data = community_classification(n=3000, avg_degree=10, n_classes=5, feat_dim=32,
                                    seed=1, build_dense=False, build_hybrid=True,
                                    hybrid_min_edges_per_tile=8)
    if data.graph.hybrid.bcsr is None:
        fail("small reference graph has no tiles")
    x = torch.from_numpy(data.features)
    labels = torch.from_numpy(data.labels.astype(np.int64))
    mask = torch.zeros(data.graph.n_nodes)
    mask[torch.from_numpy(data.idx_train.astype(np.int64))] = 1.0
    outs = {}
    for dev in ("cpu", "cuda"):
        model = GCN([32, 16, 16, 5], generator=torch.Generator().manual_seed(3)).to(dev)
        g = data.graph.to(dev)
        logp = model(x.to(dev), g)
        loss = masked_nll(logp, labels.to(dev), mask.to(dev))
        loss.backward()
        outs[dev] = [logp.detach().cpu(), loss.detach().cpu()] + [
            p.grad.cpu() for p in model.parameters()]
    for a, b in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    print(f"small reference: 3-layer GCN on the card matches the CPU plain path "
          f"(log-probs, loss, {len(outs['cpu']) - 2} gradients) within rtol=1e-4, "
          f"atol=1e-5 on {data.graph.n_nodes} nodes, "
          f"{data.graph.hybrid.bcsr.data.shape[0]} tiles", flush=True)


def check_small_gat_reference(torch, v2: bool):
    """The 2-layer GAT (GATv2 with ``v2``) on the card against the same model
    on the CPU (plain versions), on a small clustered graph whose hybrid
    layout has tiles and an ELL residual: log-probs, loss and gradients."""
    import numpy as np

    from pygcn_tpu_torch.apps.train_fullgraph import masked_nll
    from pygcn_tpu_torch.graph.datasets import community_classification
    from pygcn_tpu_torch.nn.gat import GAT
    from pygcn_tpu_torch.ops.gat import build_gat_tiles_t

    data = community_classification(n=3000, avg_degree=10, n_classes=5, feat_dim=32,
                                    seed=1, build_dense=False, build_ell=True,
                                    build_hybrid=True, hybrid_min_edges_per_tile=64)
    hy = data.graph.hybrid
    if hy.bcsr is None or not 0 < hy.tile_edges < data.graph.n_edges:
        fail("small GAT reference graph needs tiles and a residual")
    tiles_t = build_gat_tiles_t(data.graph)
    x = torch.from_numpy(data.features)
    labels = torch.from_numpy(data.labels.astype(np.int64))
    mask = torch.zeros(data.graph.n_nodes)
    mask[torch.from_numpy(data.idx_train.astype(np.int64))] = 1.0
    outs = {}
    for dev in ("cpu", "cuda"):
        model = GAT(32, 8, 5, heads=8, v2=v2,
                    generator=torch.Generator().manual_seed(3)).to(dev)
        logp = model(x.to(dev), data.graph.to(dev), hybrid_tiles=True, tiles_t=tiles_t.to(dev))
        loss = masked_nll(logp, labels.to(dev), mask.to(dev))
        loss.backward()
        outs[dev] = [logp.detach().cpu(), loss.detach().cpu()] + [
            p.grad.cpu() for p in model.parameters()]
    worst = 0.0
    for a, b in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        worst = max(worst, float((a - b).abs().max()))
    name = "GATv2" if v2 else "GAT"
    print(f"small {name} reference: 2-layer {name} (8 heads x 8, then 1 x 5) on the card matches "
          f"the CPU plain path (log-probs, loss, {len(outs['cpu']) - 2} gradients) within "
          f"rtol=atol=1e-4 on {data.graph.n_nodes} nodes, {hy.bcsr.data.shape[0]} tiles, "
          f"tile_frac {hy.tile_edges / data.graph.n_edges:.4f}; max abs err {worst:.3e}",
          flush=True)


def run_main_path(torch, epochs):
    from pygcn_tpu_torch.apps import train_fullgraph
    from pygcn_tpu_torch.ops.cuda import bcsr_spmm as b1
    from pygcn_tpu_torch.utils import native

    print(f"graphkit native library: {'loaded' if native.available() else 'missing (NumPy/BFS fallbacks)'}",
          flush=True)
    b1.launches = b1.stream_launches = 0
    result = train_fullgraph.main(["--clustered", "--max_epochs", str(epochs), "--memstats",
                                   "--device", "cuda"])
    torch.cuda.synchronize()
    launches = b1.launches
    graph = result["graph"]
    expected = 6 * result["steps"] + 3 * result["evals"]
    print(f"main path: {graph.n_nodes} nodes, {graph.n_edges} edges, tile_frac="
          f"{result['tile_frac']}, {graph.hybrid.bcsr.data.shape[0] if graph.hybrid.bcsr is not None else 0} tiles, "
          f"{result['steps']} steps + {result['evals']} evals, B1 launches {launches} "
          f"(expected 6/step + 3/eval = {expected}), ms/step {result['epoch_s'] * 1e3:.3f}, "
          f"peak memory {result['peak_mem_bytes'] / 2**30:.3f} GiB, last loss {result['loss']}, "
          f"best val {result['val']}", flush=True)
    if not result["tile_frac"] or result["tile_frac"] <= 0:
        fail(f"tile_frac={result['tile_frac']}: the hybrid layout has no tiles")
    if launches != expected or launches == 0 or b1.stream_launches:
        fail(f"B1 launched {launches} times on the main path, expected {expected}; "
             f"B2 {b1.stream_launches} times, expected 0")
    if not math.isfinite(result["loss"]) or not math.isfinite(result["val"]):
        fail(f"non-finite loss {result['loss']} or val {result['val']}")
    return graph, launches


def run_gat_main_path(torch, v2: bool, epochs):
    """``--model gat`` (or ``gatv2``) at the arxiv flagship: every tile kernel
    of the other version launched 0 times, this version's forward kernel
    2 per step + 2 per evaluation and its two backward kernels 2 per step."""
    from pygcn_tpu_torch.apps import train_fullgraph
    from pygcn_tpu_torch.ops.cuda import gat_tile_attn as gta

    model, (fwd, recv, send) = (("gatv2", ("B7", "B8", "B9")) if v2
                                else ("gat", ("B3", "B5", "B6")))
    for k in gta.launches:
        gta.launches[k] = 0
    result = train_fullgraph.main(["--clustered", "--model", model, "--hidden", "8",
                                   "--max_epochs", str(epochs), "--memstats", "--device", "cuda"])
    torch.cuda.synchronize()
    launches = dict(gta.launches)
    graph = result["graph"]
    steps, evals = result["steps"], result["evals"]
    expected = dict.fromkeys(launches, 0)
    expected.update({fwd: 2 * steps + 2 * evals, recv: 2 * steps, send: 2 * steps})
    tiles = graph.hybrid.bcsr.data.shape[0] if graph.hybrid.bcsr is not None else 0
    print(f"{model} main path: {graph.n_nodes} nodes, {graph.n_edges} edges, tile_frac="
          f"{result['tile_frac']}, {tiles} tiles ({result['tiles_t'].data.shape[0]} "
          f"transpose tiles), {steps} steps + {evals} evals, launches {launches} (expected "
          f"{fwd} 2/step + 2/eval, {recv} and {send} 2/step: {expected}), ms/step "
          f"{result['epoch_s'] * 1e3:.3f}, peak memory {result['peak_mem_bytes'] / 2**30:.3f} "
          f"GiB, last loss {result['loss']}, best val {result['val']}", flush=True)
    if not result["tile_frac"] or result["tile_frac"] <= 0 or not result["hybrid_tiles"]:
        fail(f"tile_frac={result['tile_frac']}: {model} did not take the tile-attention path")
    if launches != expected or 0 in (launches[fwd], launches[recv], launches[send]):
        fail(f"{model} main path launched {launches}, expected {expected}")
    if not math.isfinite(result["loss"]) or not math.isfinite(result["val"]):
        fail(f"non-finite {model} loss {result['loss']} or val {result['val']}")
    return result, launches


def run_stream_main_paths(torch, epochs):
    """The GCN main path with ``BCSR_STREAM = True`` (B2 6 per step + 3 per
    evaluation, B1 none) and the GAT main path with ``TILE_REVISIT = False``
    (B4 2 per step + 2 per evaluation, B5s and B6s 2 per step, every other
    tile kernel none). Both flags are restored whatever happens."""
    from pygcn_tpu_torch.apps import train_fullgraph
    from pygcn_tpu_torch.ops.cuda import bcsr_spmm as b1
    from pygcn_tpu_torch.ops.cuda import gat_tile_attn as gta

    saved = (b1.BCSR_STREAM, gta.TILE_REVISIT)
    try:
        b1.BCSR_STREAM = True
        b1.launches = b1.stream_launches = 0
        r = train_fullgraph.main(["--clustered", "--max_epochs", str(epochs), "--memstats",
                                  "--device", "cuda"])
        torch.cuda.synchronize()
        gcn = {"B1": b1.launches, "B2": b1.stream_launches}
        want = {"B1": 0, "B2": 6 * r["steps"] + 3 * r["evals"]}
        print(f"GCN stream main path (BCSR_STREAM): {r['steps']} steps + {r['evals']} evals, "
              f"launches {gcn} (expected B2 6/step + 3/eval, B1 0: {want}), ms/step "
              f"{r['epoch_s'] * 1e3:.3f}, peak memory {r['peak_mem_bytes'] / 2**30:.3f} GiB, "
              f"last loss {r['loss']}, best val {r['val']}", flush=True)
        if gcn != want or not math.isfinite(r["loss"]) or not math.isfinite(r["val"]):
            fail(f"GCN stream main path: launches {gcn}, expected {want}; loss {r['loss']}, "
                 f"val {r['val']}")
        del r
        b1.BCSR_STREAM = False
        gta.TILE_REVISIT = False
        for k in gta.launches:
            gta.launches[k] = 0
        b1.launches = b1.stream_launches = 0
        r = train_fullgraph.main(["--clustered", "--model", "gat", "--hidden", "8",
                                  "--max_epochs", str(epochs), "--memstats", "--device", "cuda"])
        torch.cuda.synchronize()
        gat = dict(gta.launches)
        steps, evals = r["steps"], r["evals"]
        want_gat = dict.fromkeys(gat, 0)
        want_gat.update({"B4": 2 * steps + 2 * evals, "B5s": 2 * steps, "B6s": 2 * steps})
        print(f"GAT stream main path (TILE_REVISIT = False): {steps} steps + {evals} evals, "
              f"launches {gat} (expected B4 2/step + 2/eval, B5s and B6s 2/step: {want_gat}), "
              f"ms/step {r['epoch_s'] * 1e3:.3f}, peak memory "
              f"{r['peak_mem_bytes'] / 2**30:.3f} GiB, last loss {r['loss']}, best val "
              f"{r['val']}", flush=True)
        if (gat != want_gat or (b1.launches, b1.stream_launches) != (0, 0)
                or not math.isfinite(r["loss"]) or not math.isfinite(r["val"])):
            fail(f"GAT stream main path: launches {gat}, expected {want_gat}; loss {r['loss']}, "
                 f"val {r['val']}")
        return {"B2": gcn["B2"], **{k: gat[k] for k in ("B4", "B5s", "B6s")}}
    finally:
        b1.BCSR_STREAM, gta.TILE_REVISIT = saved


# B1 launches of the extension models' training step and evaluation: each
# spmm is one forward launch, and one backward launch when its input needs a
# gradient. SAGE and GIN aggregate the input x in layer 1 (no gradient) and
# the hidden layer in layer 2: 2 + 1 per step, 2 per evaluation. APPNP runs
# K = 10 propagation steps on the MLP's output: 10 + 10 per step, 10 per
# evaluation.
EXTENSION_B1 = {"sage": (3, 2), "gin": (3, 2), "appnp": (20, 10)}


def run_extension_main_paths(torch, epochs):
    """``--model sage``, ``gin`` and ``appnp`` at the default widths (128 ->
    128 -> 40): B1 exactly :data:`EXTENSION_B1` times, no other kernel."""
    from pygcn_tpu_torch.apps import train_fullgraph
    from pygcn_tpu_torch.ops.cuda import bcsr_spmm as b1
    from pygcn_tpu_torch.ops.cuda import gat_tile_attn as gta

    total = 0
    for model, (per_step, per_eval) in EXTENSION_B1.items():
        b1.launches = b1.stream_launches = 0
        for k in gta.launches:
            gta.launches[k] = 0
        t0 = time.time()
        r = train_fullgraph.main(["--clustered", "--model", model, "--max_epochs", str(epochs),
                                  "--memstats", "--device", "cuda"])
        torch.cuda.synchronize()
        want = per_step * r["steps"] + per_eval * r["evals"]
        print(f"{model} main path: {r['steps']} steps + {r['evals']} evals, B1 launches "
              f"{b1.launches} (expected {per_step}/step + {per_eval}/eval = {want}), ms/step "
              f"{r['epoch_s'] * 1e3:.3f}, peak memory {r['peak_mem_bytes'] / 2**30:.3f} GiB, "
              f"last loss {r['loss']}, best val {r['val']}, wall {time.time() - t0:.1f}s",
              flush=True)
        if (b1.launches != want or b1.stream_launches or any(gta.launches.values())
                or not r["tile_frac"] or not math.isfinite(r["loss"])
                or not math.isfinite(r["val"])):
            fail(f"{model} main path: B1 {b1.launches} (expected {want}), B2 "
                 f"{b1.stream_launches}, tile kernels {gta.launches}, tile_frac "
                 f"{r['tile_frac']}, loss {r['loss']}, val {r['val']}")
        total += b1.launches
        del r
    return total


def run_ab_tool():
    """``apps/ab_kernel_stream`` at the flagship: revisit against stream."""
    from pygcn_tpu_torch.apps import ab_kernel_stream

    rows = ab_kernel_stream.main(["--device", "cuda"])
    diff = rows[-1]
    # the modes sum the same f32 terms in another order (the merges' index_add_
    # in no fixed order), and the stream merge rescales by exp(max_t - m) where
    # the revisit kernels rescale as they go: relative to the output's largest
    # magnitude they agree to about 1e-6
    for op in ("hybrid_spmm", "gat_hybrid_fwd", "gat_hybrid_step"):
        if not diff[op + "_relative"] <= 1e-4:
            fail(f"A/B: stream and revisit {op} differ by {diff[op]}, "
                 f"{diff[op + '_relative']} of its largest value (limit 1e-4)")
    return rows


def _tile_csr(torch, bcsr, n_rows, n_cols):
    """The tile matrix as a torch CSR tensor on the card (the library yardstick)."""
    t, r, c = torch.nonzero(bcsr.data, as_tuple=True)
    rows = bcsr.block_rows.long()[t] * bcsr.tm + r
    cols = bcsr.block_cols.long()[t] * bcsr.tk + c
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), bcsr.data[t, r, c].float(),
                                  (n_rows, n_cols)).coalesce()
    return coo.to_sparse_csr()


# B1's work-item sizes C timed by time_b1 (B1's MAX_TILES was picked from them)
SWEEP_MAX_TILES = (2, 4, 8)


def time_b1(torch, graph):
    """B1 and B2 at the main path's shapes: kernel, plain, bound and library
    times, and each kernel's time without the longest block row (how much of
    a launch that row sets); B1 also at each C of :data:`SWEEP_MAX_TILES`.
    Both compute the same function from the same bytes, so they share one
    bound; B2's time includes the zero fill of the output it adds into. B1
    also gives the same bits in two launches."""
    from pygcn_tpu_torch.apps.time_spmm import spmm_bound, without_longest_row
    from pygcn_tpu_torch.ops.cuda import bcsr_spmm as b1
    from pygcn_tpu_torch.utils.timing import cuda_ms

    bcsr = graph.hybrid.bcsr
    n = graph.n_nodes
    csr = _tile_csr(torch, bcsr, n, n)
    short = without_longest_row(bcsr)
    max_tiles = b1.MAX_TILES
    sched = b1.spmm_schedule(bcsr, max_tiles)
    per_row = torch.diff(bcsr.block_row_ptr.long())
    print(f"B1 schedule at C = {max_tiles}: {sched.items.shape[0]} work items over "
          f"{bcsr.n_block_rows} block rows (tiles per row: mean "
          f"{float(per_row.float().mean()):.2f}, max {int(per_row.max())}), "
          f"{sched.n_slots} partial blocks in the workspace", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    saved = b1.launches, b1.stream_launches
    for h in (128, 40):
        x = torch.randn((n, h), device="cuda", generator=gen)
        ref = b1.bcsr_spmm_plain(bcsr, x, n_rows=n)
        lib = torch.sparse.mm(csr, x)
        torch.cuda.synchronize()
        torch.testing.assert_close(lib, ref, rtol=RTOL, atol=ATOL)
        plain_ms = cuda_ms(lambda: b1.bcsr_spmm_plain(bcsr, x, n_rows=n), iters=20)
        library_ms = cuda_ms(lambda: torch.sparse.mm(csr, x), iters=50)
        bound_ms, bound_by, nbytes, flops = spmm_bound(bcsr, n, h)
        by_c = {c: [] for c in SWEEP_MAX_TILES}
        try:
            for _ in range(2):  # in turns, twice, to show the spread
                for c in SWEEP_MAX_TILES:
                    b1.MAX_TILES = c
                    by_c[c].append(cuda_ms(lambda: b1.bcsr_spmm_cuda(bcsr, x, n_rows=n),
                                           iters=50))
        finally:
            b1.MAX_TILES = max_tiles
        for name, fn in (("B1", b1.bcsr_spmm_cuda), ("B2", b1.bcsr_spmm_stream_cuda)):
            got, again = fn(bcsr, x, n_rows=n), fn(bcsr, x, n_rows=n)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
            if name == "B1" and not torch.equal(got, again):
                fail(f"B1 at H={h} gave other bits in a second launch")
            err = float((got - ref).abs().max())
            del got, again
            ms = cuda_ms(lambda: fn(bcsr, x, n_rows=n), iters=50)
            short_ms = cuda_ms(lambda: fn(short, x, n_rows=n), iters=50)
            ms2 = cuda_ms(lambda: fn(bcsr, x, n_rows=n), iters=50)
            row = {"kernel": name, "H": h, "tiles": bcsr.data.shape[0],
                   "tile_nnz": flops // (2 * h), "ms": min(ms, ms2), "ms_runs": [ms, ms2],
                   "ms_without_longest_row": short_ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                   "bytes": nbytes, "flops": flops, "max_abs_err": err}
            if name == "B1":
                row["ms_by_max_tiles"] = {c: min(v) for c, v in by_c.items()}
                row["ms_by_max_tiles_runs"] = by_c
            print(f"{name} timing: " + json.dumps(row), flush=True)
            rows.append(row)
    b1.launches, b1.stream_launches = saved
    return rows


def _rows_under(torch, blocks, size, n):
    """Operand rows a tile set reads on one side: the distinct blocks, capped at n."""
    return min(n, int(torch.unique(blocks).numel()) * size)


def time_gat(torch, graph, tiles_t, v2: bool):
    """B3, B5 and B6 and their stream modes B4, B5s and B6s (with ``v2``: B7,
    B8 and B9) at the GAT main path's tiles, for both layer shapes: kernel
    and plain times (CUDA events), the bound of each function, the kernel's
    time without the longest block row (``ms_without_longest_row``, a
    diagnostic of the launch's tail), and for the stream kernels their
    merge's time and bound."""
    from pygcn_tpu_torch.apps.time_spmm import F32_FLOPS, HBM_BYTES_PER_S, without_longest_row
    from pygcn_tpu_torch.ops.cuda import gat_tile_attn as gta
    from pygcn_tpu_torch.ops.cuda.bcsr_spmm import sum_by_block_row
    from pygcn_tpu_torch.utils.timing import cuda_ms

    bcsr = graph.hybrid.bcsr
    n = graph.n_nodes
    gen = torch.Generator(device="cuda").manual_seed(2)
    # the function's work: one term per tile edge (the tiles' nonzeros, the
    # same in the transpose) and head. Per term B3 takes the logit (add,
    # leaky), the max, the shifted exp, the den add and 2F for the weighted
    # sum; B5 the logit, the exp, 2F for s_u . dnum_v, then + dden, * p,
    # * leaky' and the sum; B6 that and 2F more for ds. GATv2's logit is 5F
    # (per f: add, leaky as a multiply and a select, times a, the sum); B7
    # adds the max, the shifted exp, the den add and 2F for num; B8 adds the
    # exp, 2F for sl_u . dnum_v, + dden and * p, then per f 4 for dsr
    # (leaky', * a, * de, the sum) and 2 for dapart (* de, the sum); B9 the
    # same with 2F for the aggregation p * dnum_v in place of dapart. The
    # stream modes B4, B5s and B6s do the terms of B3, B5 and B6.
    nnz = int(torch.count_nonzero(bcsr.data))
    ops_per_term = {"B3": lambda f: 2 * f + 6, "B5": lambda f: 2 * f + 8,
                    "B6": lambda f: 4 * f + 8, "B7": lambda f: 7 * f + 4,
                    "B8": lambda f: 13 * f + 4, "B9": lambda f: 13 * f + 4}
    ops_per_term.update(B4=ops_per_term["B3"], B5s=ops_per_term["B5"], B6s=ops_per_term["B6"])
    fwd_rows = _rows_under(torch, bcsr.block_rows, bcsr.tm, n)
    fwd_cols = _rows_under(torch, bcsr.block_cols, bcsr.tk, n)
    t_rows = _rows_under(torch, tiles_t.block_rows, tiles_t.tm, n)
    t_cols = _rows_under(torch, tiles_t.block_cols, tiles_t.tk, n)

    def tile_bytes(b):
        return b.data.shape[0] * b.tm * b.tk * b.data.element_size()

    short = {id(bcsr): without_longest_row(bcsr), id(tiles_t): without_longest_row(tiles_t)}

    # one CTA per (head, block row) walks the row's tiles: the longest rows
    # set the kernels' tail
    for label, b in (("forward", bcsr), ("transpose", tiles_t)):
        per_row = torch.diff(b.block_row_ptr.long())
        print(f"GAT {label} tiles per block row: mean {float(per_row.float().mean()):.2f}, "
              f"max {int(per_row.max())}, rows with >= 8 tiles {int((per_row >= 8).sum())} "
              f"of {b.n_block_rows}", flush=True)

    saved = dict(gta.launches)
    rows = []
    for h, f in ((8, 8), (1, 40)):
        hf = h * f
        dnum, dden = (torch.randn(n, w, device="cuda", generator=gen) for w in (hf, h))
        # name: (kernel, plain, tiles, bytes: tiles + operand rows under the
        #        tiles + outputs, each read or written once; for the stream
        #        kernels, the merge of the kernel's blocks)
        if v2:
            sl2, sr2 = (torch.randn(n, hf, device="cuda", generator=gen) for _ in range(2))
            a = torch.randn(h, f, device="cuda", generator=gen)
            fwd = (bcsr, sl2, sr2, a, h, f, SLOPE)
            bwd = (sl2, sr2, a, gta.tile_v2_fwd_plain(*fwd)[2], dnum, dden, h, f, SLOPE)
            runs = {
                "B7": (lambda b: gta.tile_v2_fwd_cuda(b, *fwd[1:]),
                       lambda b: gta.tile_v2_fwd_plain(b, *fwd[1:]), bcsr,
                       tile_bytes(bcsr) + 4 * (fwd_cols * hf + fwd_rows * hf + hf
                                               + n * (hf + 2 * h)), None),
                "B8": (lambda b: gta.tile_v2_bwd_recv_cuda(b, *bwd),
                       lambda b: gta.tile_v2_bwd_recv_plain(b, *bwd), bcsr,
                       tile_bytes(bcsr) + 4 * (fwd_cols * hf + fwd_rows * (2 * hf + 2 * h) + hf
                                               + n * 2 * hf), None),
                "B9": (lambda b: gta.tile_v2_bwd_send_cuda(b, *bwd),
                       lambda b: gta.tile_v2_bwd_send_plain(b, *bwd), tiles_t,
                       tile_bytes(tiles_t) + 4 * (t_rows * hf + t_cols * (2 * hf + 2 * h) + hf
                                                  + n * hf), None),
            }
        else:
            lsrc, ldst = (torch.randn(n, h, device="cuda", generator=gen) for _ in range(2))
            s2 = torch.randn(n, hf, device="cuda", generator=gen)
            fwd = (bcsr, lsrc, ldst, s2, h, f, SLOPE)
            bwd = (lsrc, ldst, s2, gta.tile_fwd_plain(*fwd)[2], dnum, dden, h, f, SLOPE)
            t_blocks = bcsr.data.shape[0] * bcsr.tm  # rows of the per-tile blocks
            tt_blocks = tiles_t.data.shape[0] * tiles_t.tm
            runs = {
                "B3": (lambda b: gta.tile_fwd_cuda(b, *fwd[1:]),
                       lambda b: gta.tile_fwd_plain(b, *fwd[1:]), bcsr,
                       tile_bytes(bcsr) + 4 * (fwd_cols * (h + hf) + fwd_rows * h
                                               + n * (hf + 2 * h)), None),
                "B5": (lambda b: gta.tile_bwd_dldst_cuda(b, *bwd),
                       lambda b: gta.tile_bwd_dldst_plain(b, *bwd), bcsr,
                       tile_bytes(bcsr) + 4 * (fwd_cols * (h + hf) + fwd_rows * (3 * h + hf)
                                               + n * h), None),
                "B6": (lambda b: gta.tile_bwd_sender_cuda(b, *bwd),
                       lambda b: gta.tile_bwd_sender_plain(b, *bwd), tiles_t,
                       tile_bytes(tiles_t) + 4 * (t_rows * (h + hf) + t_cols * (3 * h + hf)
                                                  + n * (hf + h)), None),
                "B4": (lambda b: gta.tile_fwd_stream_cuda(b, *fwd[1:]),
                       lambda b: gta.tile_fwd_stream_plain(b, *fwd[1:]), bcsr,
                       tile_bytes(bcsr) + 4 * (fwd_cols * (h + hf) + fwd_rows * h
                                               + t_blocks * (hf + 2 * h)),
                       lambda out: gta.softmax_merge(bcsr, *out, n)),
                "B5s": (lambda b: gta.tile_bwd_dldst_stream_cuda(b, *bwd),
                        lambda b: gta.tile_bwd_dldst_stream_plain(b, *bwd), bcsr,
                        tile_bytes(bcsr) + 4 * (fwd_cols * (h + hf) + fwd_rows * (3 * h + hf)
                                                + t_blocks * h),
                        lambda out: sum_by_block_row(out[0], bcsr, n)),
                "B6s": (lambda b: gta.tile_bwd_sender_stream_cuda(b, *bwd),
                        lambda b: gta.tile_bwd_sender_stream_plain(b, *bwd), tiles_t,
                        tile_bytes(tiles_t) + 4 * (t_rows * (h + hf) + t_cols * (3 * h + hf)
                                                   + tt_blocks * (hf + h)),
                        lambda out: (sum_by_block_row(out[0], tiles_t, n),
                                     sum_by_block_row(out[1], tiles_t, n))),
            }
        for name, (kernel_on, plain_on, tiles, nbytes, merge) in runs.items():
            kernel, plain = (lambda: kernel_on(tiles)), (lambda: plain_on(tiles))
            a, r = kernel(), plain()
            torch.cuda.synchronize()
            a, r = (a if isinstance(a, tuple) else (a,)), (r if isinstance(r, tuple) else (r,))
            err = 0.0
            for x, y in zip(a, r):
                torch.testing.assert_close(x, y, rtol=RTOL, atol=ATOL)
                err = max(err, float((x - y).abs().max()))
            ms = cuda_ms(kernel, iters=20)
            plain_ms = cuda_ms(plain, iters=5, warmup=1)
            ms2 = cuda_ms(kernel, iters=20)
            short_ms = cuda_ms(lambda: kernel_on(short[id(tiles)]), iters=20)
            flops = nnz * h * ops_per_term[name](f)
            bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
            row = {"kernel": name, "H": h, "F": f, "tiles": tiles.data.shape[0],
                   "tile_nnz": nnz, "ms": min(ms, ms2), "ms_runs": [ms, ms2],
                   "ms_without_longest_row": short_ms, "plain_ms": plain_ms, "library_ms": None,
                   "bound_ms": max(bytes_ms, ops_ms),
                   "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                   "bytes": nbytes, "flops": flops, "max_abs_err": err}
            if merge is not None:
                # the merge reads the blocks once and writes [n, W] once
                merge_bytes = sum(x.numel() * 4 + n * x.shape[2] * 4 for x in a)
                row.update(merge_ms=cuda_ms(lambda: merge(a), iters=20),
                           merge_bound_ms=merge_bytes / HBM_BYTES_PER_S * 1e3)
            print(f"{name} timing: " + json.dumps(row), flush=True)
            rows.append(row)
            del a, r
    print(f"{'/'.join(runs)} library_ms: null; no single PyTorch call computes these "
          "attention partials or their gradients (a sparse softmax over the tile edges "
          "would need several)", flush=True)
    gta.launches.update(saved)
    return rows


def gat_kernel_entries(timing, launches, source, lines):
    """The ``kernels`` line's entries of the tile-attention kernels named in
    ``lines`` (name: line of the TPU kernel), from the layer-1 (8x8) row; a
    stream kernel's entry also has its merge's time."""
    out = []
    for name, line in lines.items():
        mine = [r for r in timing if r["kernel"] == name]
        layer1 = mine[0]  # H = 8, F = 8
        entry = {
            "name": f"{name} {source.split('/')[-1][:-3]}",
            "route": "cuda",
            "source": source,
            "replaces": f"pygcn_tpu/ops/pallas/gat_tile_attn.py:{line}",
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": layer1["ms"],
            "plain_ms": layer1["plain_ms"],
            "bound_ms": layer1["bound_ms"],
            "bound_by": layer1["bound_by"],
            "library_ms": None,
        }
        if "merge_ms" in layer1:
            entry["merge_ms"] = layer1["merge_ms"]
        out.append(entry)
    return out


def spmm_kernel_entry(timing, name, launches, line):
    """The ``kernels`` line's entry of B1 or B2, from its H = 128 row."""
    mine = [r for r in timing if r["kernel"] == name]
    h128 = mine[0]
    return {
        "name": f"{name} bcsr_spmm",
        "route": "cuda",
        "source": "pygcn_tpu_torch/csrc/bcsr_spmm.cu",
        "replaces": f"pygcn_tpu/ops/pallas/bcsr_spmm.py:{line}",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in mine),
        "ms": h128["ms"],
        "plain_ms": h128["plain_ms"],
        "bound_ms": h128["bound_ms"],
        "bound_by": h128["bound_by"],
        "library_ms": h128["library_ms"],
    }


# Epochs of each main path: enough for a step and an evaluation after the
# warm-up pair; the launch checks hold at any count.
EPOCHS = 2


def main() -> None:
    t_start = time.time()
    walls = {}

    def phase(name, fn, *args):
        t0 = time.time()
        out = fn(*args)
        walls[name] = time.time() - t0
        print(f"phase {name} wall: {walls[name]:.1f}s", flush=True)
        return out

    torch = setup()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}", flush=True)
    card = card_line()
    print(card, flush=True)
    phase("build", build_kernels)
    phase("check_b1", check_b1, torch)
    phase("check_gat_tiles", check_gat_tiles, torch, False)
    phase("check_gatv2_tiles", check_gat_tiles, torch, True)
    phase("check_stream_kernels", check_stream_kernels, torch)
    phase("small_gcn_reference", check_small_reference, torch)
    phase("small_gat_reference", check_small_gat_reference, torch, False)
    phase("small_gatv2_reference", check_small_gat_reference, torch, True)
    graph, launches = phase("gcn_main_path", run_main_path, torch, EPOCHS)
    timing = phase("time_b1_b2", time_b1, torch, graph)
    del graph
    gat_result, gat_launches = phase("gat_main_path", run_gat_main_path, torch, False, EPOCHS)
    gat_timing = phase("time_gat", time_gat, torch, gat_result["graph"], gat_result["tiles_t"],
                       False)
    del gat_result
    gatv2_result, gatv2_launches = phase("gatv2_main_path", run_gat_main_path, torch, True,
                                         EPOCHS)
    gatv2_timing = phase("time_gatv2", time_gat, torch, gatv2_result["graph"],
                         gatv2_result["tiles_t"], True)
    del gatv2_result
    stream_launches = phase("stream_main_paths", run_stream_main_paths, torch, EPOCHS)
    phase("extension_main_paths", run_extension_main_paths, torch, EPOCHS)
    phase("ab_kernel_stream", run_ab_tool)
    kernels = {"kernels": [
        spmm_kernel_entry(timing, "B1", launches, 50),
        spmm_kernel_entry(timing, "B2", stream_launches["B2"], 64),
    ]}
    kernels["kernels"] += gat_kernel_entries(
        gat_timing, gat_launches, "pygcn_tpu_torch/csrc/gat_tile_attn.cu",
        {"B3": 118, "B5": 265, "B6": 304})
    kernels["kernels"] += gat_kernel_entries(
        gat_timing, stream_launches, "pygcn_tpu_torch/csrc/gat_tile_attn.cu",
        {"B4": 151, "B5s": 265, "B6s": 304})
    kernels["kernels"] += gat_kernel_entries(
        gatv2_timing, gatv2_launches, "pygcn_tpu_torch/csrc/gatv2_tile_attn.cu",
        {"B7": 559, "B8": 593, "B9": 633})
    print(f"chip_smoke wall: {time.time() - t_start:.1f}s (phases: "
          + ", ".join(f"{k} {v:.1f}s" for k, v in walls.items()) + ")", flush=True)
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
