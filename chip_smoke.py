#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pygcn_tpu_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``pygcn_tpu_torch/csrc`` (one
``nvcc`` per source, in parallel), holds each against its plain PyTorch
version on the card (the per-tile "stream" kernels, whose merges are fused,
also against the revisit kernels: B2, B4, B5s and B6s against B1, B3, B5 and
B6; B3, B4 and B5s also at 256 and 512 heads; every kernel also at tile
shapes other than 128 x 128, ``check_tile_shapes``), holds a small GCN, a
small GAT and a small GATv2 on the card against the same models on the CPU,
runs the Cora CLI (``apps/train_cora``: the dense layout, no tile kernel) in
its accuracy band and against the CPU, trains a GAT with dropout (its steps
launch no tile kernel, its evaluation does), and drives the port's
main paths at the ogbn-arxiv sizes (169,343 nodes, average degree 13.3, the
hybrid layout) for a few epochs each through ``apps/train_fullgraph
--clustered``:

- the 3-layer GCN (widths 128/128/40): kernel B1, and with ``BCSR_STREAM``
  kernel B2, and kernel E1 on the ELL residual (``check_e1`` holds E1
  against its plain version at widths 1 to 640, bit for bit in two launches;
  ``time_e1`` on the main path's residual at H = 128 and 40);
- ``--model gat --hidden 8`` (2-layer GAT, 8 heads of 8 then 1 head of 40):
  kernels B3/B5/B6, and with ``TILE_REVISIT = False`` B4/B5s/B6s;
- ``--model gatv2 --hidden 8``: kernels B7/B8/B9;
- ``--model gat`` and ``--model gatv2`` at the CLI's default ``--hidden 128``
  (8 heads of 128): the same kernels on wide heads, for one epoch;
- ``--model sage``, ``gin`` and ``appnp`` (128 -> 128 -> 40): kernels B1
  and E1.

It checks that each path launched its kernels exactly as often as it must
and no other tile kernel. On the GCN path's arxiv data it then runs the
graph-parallel path of ``train_fullgraph --shards`` at world size 1 over
NCCL (``dist_main_path``; one card, and NCCL runs no two ranks on one
device): ``DistGCN``, ``DistSAGE``, ``DistAPPNP``, ``DistGAT`` and its
GATv2 form for a warm-up step and 2 epochs each through
``train_fullgraph.run_sharded``, with finite losses, no tile kernel launched,
each forward within 1e-4 of the single-device model's at the same weights,
and ``--shards 2 --device cuda`` refused on the one card with the mesh
message; it prints a ``dist {...}`` line (the plan's build seconds, halo
rows, ms/step, device-busy ms and peak memory per model beside the
single-device GCN's ms/step) and destroys its process group. It runs
``apps/ab_kernel_stream`` (revisit against
stream on the flagship graph) once, and times each kernel at its path's
shapes beside its bound. Then the epidemic simulator, which reaches no
hand-written kernel: the card's samplers against the exact pmfs, a small
world on the card against the CPU, the simulator at SafeGraph width (2943
CBGs, 50,000 POIs, 600K visits an hour, 1512 hours, 40 seeds; two runs of
one seed and the paged run give the same bits, a day runs with no host
sync; it prints ms/hour, seed-hours/s, peak memory and the profiled split
on a ``sim {...}`` line), 8 policies in one batch against their runs
alone, and ``apps/gt_gen`` and ``apps/no_vac_baseline`` on the card. Then
the surrogate evaluator at SafeGraph width, whose dense graph reaches no
hand-written kernel: ``gt_gen`` for 200 policies, ``apps/train_evaluator``
for 4 epochs and again for 3 ended by SIGTERM and resumed for the fourth
(equal weights), a step timed and profiled, the model's ``impl="bcsr"``
step (kernel B1) against the dense one, B1 at the folded ``[2943, 640]``
product beside ``torch.mm``, and ``apps/baselines`` and
``apps/train_legacy``; it prints an ``evaluator {...}`` line. Beside it, at
world size 1 over NCCL on data that earlier phases built, the model axes
(``model_axes``), which reach no hand-written kernel, as in JAX: the
tensor-parallel GCN (``parallel/tp_gcn.py``, 128 -> 128 -> 128 -> 40 on
the arxiv data, col/row/full) trained through the distributed step and held
within 1e-4 of ``DistGCN`` at its weights, its parameters and Adam state
saved by ``train/checkpoint_dist.py`` asynchronously and restored bit for
bit; the GPipe pipeline (``parallel/pipeline.py``, 4 stages of width 32 on
the evaluator's dense graph) against its loop, forward and gradients; the
expert-parallel MoE (``parallel/moe.py``, 8 experts of 128 -> 512 on the
169,343 arxiv nodes) against a plain per-expert loop and the einsum form on
a slice; ``parallel/dryrun.dryrun_multichip(1)``; and the dry run's
``--ranks 2 --device cuda`` refused on the one card; it prints an ``axes
{...}`` line. Then, against
that evaluator, the policy generators and the server: ``apps/train_generator``
(plain and ``--hierarchical``; NN-node policies, a step timed and profiled,
the ``impl="bcsr"`` step against the dense one and B1 at ``[2943, 32]``),
``apps/train_rl`` (128 policies an episode, then a rerun answered by its
cache) and ``apps/predict`` (from the pickle, writing a ``torch.export``
artifact, then from the artifact in a process that imports no model code;
padding changes no row); it prints ``policy {...}`` and ``serve {...}``
lines. The layouts for graphs above a million nodes, which reach no tile
kernel but the hybrid's: at the arxiv graph the column panels, the panels
and the hybrid with a column-panel residual (B1 on its tiles, timed as a
``kernels`` entry) against the segment SpMM with repeating bits, and the
column-panel GAT/GATv2 against the COO attention in f64
(``colpanel_arxiv``); then the ogbn-products cell (2,449,029 nodes, about
63M edges): its dataset built once and saved as ``.npz``, and
``train_fullgraph --clustered --npz`` for the GCN, GAT and GATv2 on the
column panels with no tile kernel launched (E2 once a GCN product, never in
the GAT's), each printing ms/step, peak memory and a profiled step's split,
and E2 on the GCN's column panels held against its plain version and timed
(a ``kernels`` entry) (``products {...}``). Then
neighbourhood-sampled training (``apps/train_sampled``), which reaches no
hand-written kernel: on a 2000-node graph the native sampler's blocks at 1
and 4 threads against the NumPy fallback's, bit for bit, and one step of
the sampled GCN, GAT and GATv2 on the card against the CPU
(``sampled_reference``); then BASELINE.json's Reddit configuration
(232,965 nodes, average degree 489, 602 features, fanouts 25/10, batches
of 1024): the GCN for an epoch with prefetch 2 and again serially (the same
blocks bit for bit), GAT and GATv2 for an epoch each, no tile kernel
launched, printing the host set-up, ms/batch and its split, a profiled
step and peak memory (``sampled {...}``). It prints each
phase's wall time. Its last line is
``{"ok": true, "device": {...}}``; any failure exits non-zero before it.
Without a CUDA card, or outside a checkout, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Tolerances of the kernels against their plain versions on the card. Both
# sum the same f32 terms (bf16 tiles: for B1, x rounded to bf16 in both,
# products exact in f32; for B3-B9 the tiles only gate the mask) in another
# order (B2, B4, B5s and B6s by atomic reductions, in an order that changes
# from run to run), and B3 and B7 rescale their running sums as the max rises
# where the plain versions exponentiate once against the final max (B4's
# plain version rescales each tile's sums onto the merged max); with
# unit-normal inputs and sums of up to a few thousand terms the error stays
# below 1e-4 relative.
RTOL = ATOL = 1e-4

# (heads, per-head width) of the GAT tile-kernel checks: the layers of the
# main paths (8x8 and 1x40 at --hidden 8; 8x128 at the CLI's default --hidden
# 128, where B3 takes shared memory above 48 KB and B7-B9 their widest
# configurations), two more compiled widths (2x4, 4x16), one that runs a wider
# kernel with its last columns masked (3x5, on the width-8 kernels), and two
# more wider than one 64-column slab (2x65: a full slab and a ragged one;
# 1x128: two full slabs, one head).
GAT_SHAPES = ((2, 4), (8, 8), (4, 16), (1, 40), (3, 5), (2, 65), (1, 128), (8, 128))
# GATv2's add 2x48 (B8 and B9 on their F-chunked kernels with a ragged
# chunk, B7 on its width-64 kernel with its last columns masked), 1x64 (one
# slab, where B7 reads its own rows from shared memory), 1x160 (B8 and B9
# past the width whose whole rows would fit an H100's shared memory) and
# 1x224 (B7 past it too: its chunked kernel).
GATV2_SHAPES = GAT_SHAPES + ((2, 48), (1, 64), (1, 160), (1, 224))
# GATv2's kernels on dense rows (tile sets of density DENSE: more own edges of
# a row in one work item than a batch of the chunked kernels holds), at the
# widths of those kernels: B8 and B9 at all four, B7 at 1x224.
DENSE = 0.35
DENSE_SHAPES = ((2, 48), (8, 128), (1, 160), (1, 224))
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


# Widths of E1's checks: one column (4-byte loads, 32 rows a warp), the GCN's
# last layer (10 lanes a row, 3 rows a warp), 128 and 256 (the GCN cells'
# hidden width: one warp a row, 1 and 2 float4 a lane) and a folded batch of
# 640 (4 float4 a lane, two column chunks).
E1_WIDTHS = (1, 40, 128, 256, 640)


def _random_ell_matrix(rng, n_rows, n_cols):
    """A CSR matrix of unit-normal values whose rows have 1 to 40 edges, but
    row 0, which has none, and 12 rows of 257 to 1,100 edges: split over the
    widest bucket, their tails in smaller ones. Every bucket has trailing
    padding."""
    import scipy.sparse as sp

    deg = rng.integers(1, 41, n_rows)
    deg[0] = 0
    deg[rng.choice(np.arange(1, n_rows), 12, replace=False)] = rng.integers(257, 1101, 12)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    indices = np.concatenate([np.sort(rng.choice(n_cols, d, replace=False)) for d in deg])
    data = rng.standard_normal(indices.size).astype(np.float32)
    return sp.csr_matrix((data, indices, indptr), shape=(n_rows, n_cols))


def check_e1(torch):
    """Kernel E1 against its plain version on the card at :data:`E1_WIDTHS`
    on a random ELL layout with split rows and trailing padding (the same
    bits in two launches, the row without edges zero), on an x whose rows
    are not 16-byte aligned (the 4-byte path at H = 256), and ``ELLSpMM``'s
    value and gradient on an asymmetric pair of layouts."""
    from pygcn_tpu_torch.ops import ell as ell_mod
    from pygcn_tpu_torch.ops.cuda import ell_spmm as e1

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    n_rows, n_cols = 3000, 2500
    m = _random_ell_matrix(rng, n_rows, n_cols)
    ell = ell_mod.build_ell(m).to(dev)
    ell_t = ell_mod.build_ell(m.T.tocsr()).to(dev)
    worst, cases = 0.0, 0

    def hold(got, ref, label):
        nonlocal worst, cases
        torch.cuda.synchronize()
        if got.shape != ref.shape or not torch.isfinite(got).all():
            fail(f"E1 {label}: shape {tuple(got.shape)} or non-finite values")
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
        worst = max(worst, float((got - ref).abs().max()))
        cases += 1

    for h in E1_WIDTHS:
        x = torch.from_numpy(rng.standard_normal((n_cols, h)).astype(np.float32)).to(dev)
        before = e1.launches
        got = ell_mod.ell_spmm_raw(ell, x)
        again = ell_mod.ell_spmm_raw(ell, x)
        hold(got, ell_mod.ell_spmm_plain(ell, x), f"H={h}")
        if e1.launches != before + 2:
            fail(f"E1 H={h}: {e1.launches - before} launches for two products")
        if not torch.equal(got, again) or got[0].any():
            fail(f"E1 H={h}: two launches differ, or the row without edges is not zero")
    flat = torch.from_numpy(rng.standard_normal(n_cols * 256 + 1).astype(np.float32)).to(dev)
    x = flat[1:].view(n_cols, 256)  # rows 4 bytes off a 16-byte boundary
    hold(ell_mod.ell_spmm_raw(ell, x), ell_mod.ell_spmm_plain(ell, x), "H=256 unaligned")
    for h in (40, 256):
        x = torch.from_numpy(rng.standard_normal((n_cols, h)).astype(np.float32)).to(dev)
        cot = torch.from_numpy(rng.standard_normal((n_rows, h)).astype(np.float32)).to(dev)
        xg = x.clone().requires_grad_(True)
        y = ell_mod.ell_spmm_pair(ell, ell_t, xg)
        (dx,) = torch.autograd.grad(y, xg, cot)
        hold(y.detach(), ell_mod.ell_spmm_plain(ell, x), f"ELLSpMM H={h}")
        hold(dx, ell_mod.ell_spmm_plain(ell_t, cot), f"ELLSpMM gradient H={h}")
    try:
        ell_mod.ell_spmm_raw(ell, torch.ones(n_cols, 4, device=dev, dtype=torch.bfloat16))
    except TypeError:
        pass
    else:
        fail("E1 took a bf16 x")
    print(f"E1 vs plain on the card: {cases} cases ({n_rows} x {n_cols}, 12 split rows, a row "
          f"without edges, H in {'/'.join(map(str, E1_WIDTHS))}, bitwise equal in two launches; "
          f"an unaligned x at H = 256; ELLSpMM value and gradient at H = 40 and 256) within "
          f"rtol=atol={RTOL}; max abs err {worst:.3e}", flush=True)


def _gat_tiles(rng, symmetric, dtype, drop_padding, density=0.05):
    """Ragged 300-node tile sets whose block row 1 has no edge, with or
    without the builder's zero padding tile, and their exact transpose (which
    has that empty block row too when the set is symmetric)."""
    import dataclasses

    import numpy as np
    import scipy.sparse as sp

    from pygcn_tpu_torch.graph.graph import _build_bcsr, drop_zero_tiles
    from pygcn_tpu_torch.ops.cuda import gat_tile_attn as gta

    m = sp.random(300, 300, density=density, random_state=rng, format="coo", dtype=np.float32)
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
    (``dsl``, ``dsr``, ``da``). GATv2's ``a`` is drawn at unit scale; at
    F >= 64 the kernels on that draw are held against the f64 plain versions
    (:func:`_v2_f64_errors`), and ``a / sqrt(F)`` against the f32 ones, but
    for ``da`` above F = 128, which is held against f64 too. GATv2 also runs
    on two dense tile sets (:data:`DENSE`), rows of more own edges in one
    work item than a batch of the chunked kernels, at :data:`DENSE_SHAPES`
    and ``a / sqrt(F)`` only; there ``da``, a sum over every node of
    hundreds, is held against f64 at every F."""
    import numpy as np

    from pygcn_tpu_torch.ops.cuda import gat_tile_attn as gta

    names, shapes, seed = ("B7/B8/B9", GATV2_SHAPES, 2) if v2 else ("B3/B5/B6", GAT_SHAPES, 1)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    worst = 0.0
    cases = 0
    unit_a = dict.fromkeys(V2_OUTPUTS, (0.0, 0.0))  # largest (kernel, plain) relative errs
    wide_da = (0.0, 0.0)  # the same of da at F > 128 (or on dense rows), a / sqrt(F)
    # (symmetric, tile dtype, drop the padding tile, dense, shapes)
    sets = [(symmetric, dtype, drop_padding, False, shapes) for symmetric in (False, True)
            for dtype in (torch.float32, torch.bfloat16) for drop_padding in (False, True)]
    if v2:
        sets += [(False, torch.float32, True, True, DENSE_SHAPES),
                 (True, torch.bfloat16, False, True, DENSE_SHAPES)]
    most_edges = 1 << 30  # a tile set's most own edges of a row in one work item, the
    # fewest over the dense sets
    for symmetric, dtype, drop_padding, dense, set_shapes in sets:
        b, bt = _gat_tiles(rng, symmetric, dtype, drop_padding, DENSE if dense else 0.05)
        if dense:
            most_edges = min(most_edges, *(gta.most_own_edges(x) for x in (b, bt)))
            if most_edges <= gta.CHUNK_EDGES:
                fail(f"a dense tile set has rows of at most {most_edges} edges in a work "
                     f"item, not more than a batch of {gta.CHUNK_EDGES}")
        for h, f in set_shapes:
            op_shapes = (((300, h * f), (300, h * f), (h, f)) if v2
                         else ((300, h), (300, h), (300, h * f)))
            ops = [torch.randn(*shape, device="cuda", generator=gen) for shape in op_shapes]
            cot = [torch.randn(300, w, device="cuda", generator=gen) for w in (h * f, h)]
            label = (f"{names} {'dense ' if dense else ''}{'sym' if symmetric else 'asym'} "
                     f"{dtype} {'no tile' if drop_padding else 'padding tile'} H={h} F={f}")
            if dense:
                ops[2] = ops[2] / f ** 0.5
            elif v2 and f >= 64:
                for name, errs in _v2_f64_errors(torch, b, bt, ops, cot, h, f, label).items():
                    unit_a[name] = tuple(map(max, unit_a[name], errs))
                ops[2] = ops[2] / f ** 0.5  # a for fan-in F: logits of unit scale
            # da sums over every node; above F = 128, or on dense rows, it reaches
            # hundreds and the f32 plain version's own error there about 5e-4: it
            # is held against the f64 plain versions (as the unit-a draws), the
            # rest at 1e-4
            da_f64 = v2 and (f > 128 or dense)
            if da_f64:
                errs = _v2_f64_errors(torch, b, bt, ops, cot, h, f, label)["da"]
                wide_da = tuple(map(max, wide_da, errs))
            args = [o.clone().requires_grad_(True) for o in ops]
            partials = gta.gatv2_tile_partials if v2 else gta.gat_tile_partials
            got = partials((h, f, SLOPE), b, bt, *args)
            grads = torch.autograd.grad(got[:2], args, cot)
            ref = (gta.tile_v2_fwd_plain if v2 else gta.tile_fwd_plain)(b, *ops, h, f, SLOPE)
            bwd = (*ops, ref[2], *cot, h, f, SLOPE)
            if v2:
                dsr, dapart = gta.tile_v2_bwd_recv_plain(b, *bwd)
                ref_grads = (gta.tile_v2_bwd_send_plain(bt, *bwd), dsr,
                             dapart.sum(dim=0).view(h, f))
            else:
                ds, dlsrc = gta.tile_bwd_sender_plain(bt, *bwd)
                ref_grads = (dlsrc, gta.tile_bwd_dldst_plain(b, *bwd), ds)
            torch.cuda.synchronize()
            pairs = list(zip(got, ref)) + list(zip(grads, ref_grads))
            for i, (a, r) in enumerate(pairs):
                if a.shape != r.shape or not torch.isfinite(a).all():
                    fail(f"{label}: shape {tuple(a.shape)} or non-finite values")
                if da_f64 and i == len(pairs) - 1:
                    continue  # da, held against f64 above
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
    dense_note = (f"; two dense sets at (H, F) in {list(DENSE_SHAPES)}, at least "
                  f"{most_edges} edges in one work item on some row, da against f64"
                  if v2 else "")
    long_rows = check_long_rows(torch, v2)
    print(f"{names} vs plain on the card: {cases} cases (asymmetric and symmetric ragged "
          f"300-node tile sets, f32 and bf16 tiles, an empty block row with and without its "
          f"padding tile, (H, F) in {list(shapes)}{dense_note}; num/den/m and the VJP {vjp}) "
          f"within rtol=atol={RTOL}; max abs err {worst:.3e}; {long_rows}", flush=True)
    if v2:
        print("B7/B8/B9 at unit a and F >= 64 against the f64 plain versions (largest error "
              "over the cases, relative to the largest f64 value: kernel / f32 plain): "
              + ", ".join(f"{k} {ek:.2e} / {ep:.2e}" for k, (ek, ep) in unit_a.items())
              + f"; da at F > 128 or on dense rows, a / sqrt(F): {wide_da[0]:.2e} / "
              f"{wide_da[1]:.2e}", flush=True)


V2_OUTPUTS = ("num", "den", "m", "dsl", "dsr", "da")


def _v2_f64_errors(torch, b, bt, ops, cot, h, f, label):
    """GATv2 with ``a`` of unit scale at F >= 64: logits of 64 or more terms
    reach tens and gradients hundreds (``da`` sums them over every node, with
    cancellation), so a few values of the kernels and of the f32 plain
    versions lie more than 1e-4 apart. Both are held against the plain
    versions in f64 on the same inputs (partials, and the VJP through
    ``GATv2TilePartials``): each within 1e-4 of the largest f64 value, and the
    kernels' error within 4x the f32 plain version's, so what parts them is
    f32 rounding of the same order. Above F = 128 ``da`` reaches a thousand
    even at ``a / sqrt(F)``, so that draw's ``da`` is held so too. Returns
    each output's (kernel, plain) error relative to its largest f64 value."""
    from pygcn_tpu_torch.ops.cuda import gat_tile_attn as gta

    args = [o.clone().requires_grad_(True) for o in ops]
    out = gta.gatv2_tile_partials((h, f, SLOPE), b, bt, *args)
    got = [o.detach() for o in out] + list(torch.autograd.grad(out[:2], args, cot))

    def plain(ops, cot):
        num, den, m = gta.tile_v2_fwd_plain(b, *ops, h, f, SLOPE)
        bwd = (*ops, m, *cot, h, f, SLOPE)
        dsr, dapart = gta.tile_v2_bwd_recv_plain(b, *bwd)
        return [num, den, m, gta.tile_v2_bwd_send_plain(bt, *bwd), dsr,
                dapart.sum(dim=0).view(h, f)]

    p32 = plain(ops, cot)
    p64 = plain([o.double() for o in ops], [c.double() for c in cot])
    torch.cuda.synchronize()
    live = p64[2] > gta.NEG / 2  # m of the rows with an edge
    errs = {}
    for name, k, p, r in zip(V2_OUTPUTS, got, p32, p64):
        if name == "m":
            k, p, r = k[live], p[live], r[live]
        if k.shape != r.shape or not torch.isfinite(k).all():
            fail(f"{label} unit a {name}: shape or non-finite values")
        scale = float(r.abs().max())
        ek, ep = float((k.double() - r).abs().max()), float((p.double() - r).abs().max())
        if ek > RTOL * scale or ek > 4 * max(ep, 1e-7 * scale):
            fail(f"{label} unit a {name}: kernel err {ek:.3e}, f32 plain err {ep:.3e} "
                 f"against f64, largest value {scale:.3e}")
        errs[name] = (ek / scale, ep / scale)
    return errs


def _long_row_gat_tiles(torch, rng):
    """The long-row tile set (block rows of 0, 1, C, C + 1, 43 and 2 tiles at
    C = ``MAX_TILES``, then none) made square, 5631 nodes, without padding
    tiles: ``(dtype, tiles, transpose, n)`` on the card for f32 and bf16
    tiles of one draw from ``rng``."""
    import dataclasses

    import numpy as np
    import scipy.sparse as sp

    from pygcn_tpu_torch.apps.time_spmm import long_row_matrix
    from pygcn_tpu_torch.graph.graph import _build_bcsr, drop_zero_tiles
    from pygcn_tpu_torch.ops.cuda import gat_tile_attn as gta

    m = long_row_matrix(gta.MAX_TILES, rng)
    n = m.shape[1]
    m = sp.coo_matrix((np.ones(m.nnz, np.float32), (m.row, m.col)), shape=(n, n))
    sets = []
    for dtype in (torch.float32, torch.bfloat16):
        b = drop_zero_tiles(_build_bcsr(m, (128, 128)))
        b = dataclasses.replace(b, data=b.data.to(dtype))
        sets.append((dtype, b.to("cuda"), gta.transpose_bcsr(b).to("cuda"), n))
    return sets


def check_long_rows(torch, v2: bool):
    """B3, B5 and B6 (with ``v2``: B7, B8 and B9) on the long-row tile set
    made square (block rows of 0, 1, C, C + 1, 43 and 2 tiles, then none;
    5631 nodes), B6 and B9 on its transpose: within the tolerance of the
    plain version and the same bits in two launches, the arrival counters
    back at zero."""
    import numpy as np

    from pygcn_tpu_torch.apps.time_spmm import long_row_counts
    from pygcn_tpu_torch.ops.cuda import gat_tile_attn as gta

    names = "B7/B8/B9" if v2 else "B3/B5/B6"
    gen = torch.Generator(device="cuda").manual_seed(6)
    worst, cases = 0.0, 0
    for dtype, b, bt, n in _long_row_gat_tiles(torch, np.random.default_rng(6)):
        for h, f in ((8, 8), (1, 40), (2, 65), (8, 128)):
            shapes = ((n, h * f), (n, h * f), (h, f)) if v2 else ((n, h), (n, h), (n, h * f))
            ops = [torch.randn(*s, device="cuda", generator=gen) for s in shapes]
            if v2 and f >= 64:
                ops[2] = ops[2] / f ** 0.5
            if v2:
                dnum = torch.randn(n, h * f, device="cuda", generator=gen)
                dden = torch.randn(n, h, device="cuda", generator=gen)
                mx = gta.tile_v2_fwd_plain(b, *ops, h, f, SLOPE)[2]
                bwd = (*ops, mx, dnum, dden, h, f, SLOPE)
                runs = {"B7": (lambda: gta.tile_v2_fwd_cuda(b, *ops, h, f, SLOPE),
                               lambda: gta.tile_v2_fwd_plain(b, *ops, h, f, SLOPE)),
                        "B8": (lambda: gta.tile_v2_bwd_recv_cuda(b, *bwd),
                               lambda: gta.tile_v2_bwd_recv_plain(b, *bwd)),
                        "B9": (lambda: (gta.tile_v2_bwd_send_cuda(bt, *bwd),),
                               lambda: (gta.tile_v2_bwd_send_plain(bt, *bwd),))}
            else:
                dnum = torch.randn(n, h * f, device="cuda", generator=gen)
                dden = torch.randn(n, h, device="cuda", generator=gen)
                mx = gta.tile_fwd_plain(b, *ops, h, f, SLOPE)[2]
                bwd = (*ops, mx, dnum, dden, h, f, SLOPE)
                runs = {"B3": (lambda: gta.tile_fwd_cuda(b, *ops, h, f, SLOPE),
                               lambda: gta.tile_fwd_plain(b, *ops, h, f, SLOPE)),
                        "B5": (lambda: (gta.tile_bwd_dldst_cuda(b, *bwd),),
                               lambda: (gta.tile_bwd_dldst_plain(b, *bwd),)),
                        "B6": (lambda: gta.tile_bwd_sender_cuda(bt, *bwd),
                               lambda: gta.tile_bwd_sender_plain(bt, *bwd))}
            for name, (kernel, plain) in runs.items():
                got, again, ref = kernel(), kernel(), plain()
                torch.cuda.synchronize()
                label = f"{name} long rows {dtype} H={h} F={f}"
                for a, r, a2 in zip(got, ref, again):
                    if a.shape != r.shape or not torch.isfinite(a).all():
                        fail(f"{label}: shape {tuple(a.shape)} or non-finite values")
                    torch.testing.assert_close(a, r, rtol=RTOL, atol=ATOL)
                    if not torch.equal(a, a2):
                        fail(f"{label}: two launches gave other bits")
                    worst = max(worst, float((a - r).abs().max()))
                if name in ("B3", "B7") and not ((got[2][:128] == gta.NEG).all()
                                                 and not got[0][:128].any()):
                    fail(f"{label}: the block row without tiles is not num = 0, m = NEG")
                if name in ("B5", "B8") and any(x[:128].any() for x in got):
                    fail(f"{label}: the block row without tiles has a gradient")
                cases += 1
        for tiles in (b, bt):
            if tiles.cache[("gat_tile", gta.MAX_TILES)][1].any():
                fail(f"{names} long rows: arrival counters not back at zero")
    return (f"{names} on block rows of {long_row_counts(gta.MAX_TILES)} tiles: {cases} cases "
            f"bitwise equal in two launches, max abs err {worst:.3e}")


def check_stream_kernels(torch):
    """B2 (its merge fused: it writes ``[n_rows, H]``) against the plain
    per-tile parts merged by block row and against B1, over the grids of
    :func:`check_b1` and its long-row tile set; B4, B5s and B6s (their merges
    fused) against their merged plain versions, over the grids of
    :func:`check_gat_tiles` and the long-row tile set made square, each
    output against the revisit kernel's (B3, B5, B6) and B5s's against a
    second launch of it; and the stream mode of ``GATTilePartials`` (values
    and VJP) against its revisit mode."""
    import numpy as np

    from pygcn_tpu_torch.apps.time_spmm import long_row_counts, long_row_tiles
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

    def gat_stream_case(b, bt, n, h, f, label, empty, transpose_empty):
        """B4, B5s and B6s (merged) against their plain versions, B4's m bit
        for bit, against B3/B5/B6, B5s against a second launch of it, and
        GATTilePartials' stream mode against its revisit mode."""
        ops = [torch.randn(n, w, device="cuda", generator=gen) for w in (h, h, h * f)]
        cot = [torch.randn(n, w, device="cuda", generator=gen) for w in (h * f, h)]
        fused = gta.tile_fwd_stream(b, *ops, h, f, SLOPE)
        bwd = (*ops, fused[2], *cot, h, f, SLOPE)
        dl = gta.tile_bwd_dldst_stream(b, *bwd)
        dl_again = gta.tile_bwd_dldst_stream(b, *bwd)
        snd = gta.tile_bwd_sender_stream(bt, *bwd)
        ref = gta.tile_fwd_plain(b, *ops, h, f, SLOPE)
        ref_bwd = (gta.tile_bwd_dldst_plain(b, *bwd), *gta.tile_bwd_sender_plain(bt, *bwd))
        rev = gta.tile_fwd_cuda(b, *ops, h, f, SLOPE)
        rev_bwd = (gta.tile_bwd_dldst_cuda(b, *bwd), *gta.tile_bwd_sender_cuda(bt, *bwd))
        mer_bwd = (dl, *snd)
        modes = {}
        try:
            for revisit in (True, False):
                gta.TILE_REVISIT = revisit
                args = [o.clone().requires_grad_(True) for o in ops]
                out = gta.gat_tile_partials((h, f, SLOPE), b, bt, *args)
                modes[revisit] = [o.detach() for o in out] + list(
                    torch.autograd.grad(out[:2], args, cot))
        finally:
            gta.TILE_REVISIT = saved
        torch.cuda.synchronize()
        for a, r in zip((*fused, *mer_bwd), (*ref, *ref_bwd)):
            close(a, r, label + " vs plain")
        if not torch.equal(fused[2], ref[2]):
            fail(f"{label}: B4's m is not the plain version's bit for bit")
        for a, r in zip((*fused, *mer_bwd), (*rev, *rev_bwd)):
            close(a, r, label + " vs B3/B5/B6")
        close(dl_again, dl, label + " B5s's second launch")
        for a, r in zip(modes[False], modes[True]):
            close(a, r, label + " GATTilePartials stream vs revisit")
        rows = slice(empty, empty + 128)
        if not ((fused[2][rows] == gta.NEG).all() and not fused[0][rows].any()
                and not fused[1][rows].any() and not mer_bwd[0][rows].any()):
            fail(f"{label}: the block row without edges is not num = den = 0, m = NEG, "
                 f"dldst = 0")
        if transpose_empty and (snd[0][rows].any() or snd[1][rows].any()):
            fail(f"{label}: the senders without edges have ds or dlsrc")

    for symmetric in (False, True):
        for dtype in (torch.float32, torch.bfloat16):
            for drop_padding in (False, True):
                b, bt = _gat_tiles(rng, symmetric, dtype, drop_padding)
                for h, f in GAT_SHAPES:
                    label = (f"B4/B5s/B6s {'sym' if symmetric else 'asym'} {dtype} "
                             f"{'no tile' if drop_padding else 'padding tile'} H={h} F={f}")
                    gat_stream_case(b, bt, 300, h, f, label, 128, symmetric)
                    cases += 1
    # the long-row tile set made square: the 43-tile block row puts 43 CTAs'
    # reductions onto the same 128 rows; block row 0 has no tile
    for dtype, b, bt, n_long in _long_row_gat_tiles(torch, np.random.default_rng(7)):
        for h, f in ((8, 8), (1, 40), (2, 65), (8, 128)):
            gat_stream_case(b, bt, n_long, h, f, f"B4/B5s/B6s long rows {dtype} H={h} F={f}",
                            0, False)
            cases += 1
    print(f"B2/B4/B5s/B6s vs plain on the card: {cases} cases (B2 on B1's grids, its fused "
          f"output vs the plain parts merged and vs B1; B4/B5s/B6s on the GAT grid, (H, F) in "
          f"{list(GAT_SHAPES)}, and on block rows of {long_row_counts(gta.MAX_TILES)} tiles: "
          f"their fused outputs vs the merged plain versions (B4's m bit for bit) and vs "
          f"B3/B5/B6, B5s's second launch vs its first, GATTilePartials stream vs revisit "
          f"(values and VJP)), within rtol=atol={RTOL}; max abs err {worst:.3e}", flush=True)


# Head counts of the many-heads check (F = 1): above what B3 and B4 staged at
# once before they walked their heads in groups (about 224 and 450 heads).
MANY_HEADS = (256, 512)


def check_many_heads(torch):
    """B3, B4 and B5s at :data:`MANY_HEADS` heads of one feature, more than
    their shared memory stages at once: on a small tile set and on the
    long-row set made square, each launch counted once and within the
    tolerance of its plain version (B4's ``m`` bit for bit)."""
    import numpy as np

    from pygcn_tpu_torch.ops.cuda import gat_tile_attn as gta

    gen = torch.Generator(device="cuda").manual_seed(9)
    sets = [("300 nodes", _gat_tiles(np.random.default_rng(9), False, torch.float32, False)[0],
             300)]
    sets += [("long rows", b, n)
             for dtype, b, _bt, n in _long_row_gat_tiles(torch, np.random.default_rng(10))
             if dtype == torch.float32]
    worst, cases = 0.0, 0
    saved = dict(gta.launches)
    for label, b, n in sets:
        for h in MANY_HEADS:
            f = 1
            lsrc, ldst, s2, dnum, dden = (torch.randn(n, h, device="cuda", generator=gen)
                                          for _ in range(5))
            ref = gta.tile_fwd_plain(b, lsrc, ldst, s2, h, f, SLOPE)
            bwd = (lsrc, ldst, s2, ref[2], dnum, dden, h, f, SLOPE)
            runs = {"B3": (lambda: gta.tile_fwd_cuda(b, lsrc, ldst, s2, h, f, SLOPE), ref),
                    "B4": (lambda: gta.tile_fwd_stream_cuda(b, lsrc, ldst, s2, h, f, SLOPE), ref),
                    "B5s": (lambda: (gta.tile_bwd_dldst_stream_cuda(b, *bwd),),
                            (gta.tile_bwd_dldst_plain(b, *bwd),))}
            for name, (kernel, want) in runs.items():
                before = dict(gta.launches)
                got = kernel()
                torch.cuda.synchronize()
                tag = f"{name} {label} H={h} F={f}"
                if {k: gta.launches[k] - before[k] for k in before} != {
                        **dict.fromkeys(before, 0), name: 1}:
                    fail(f"{tag}: launches {gta.launches}, before {before}")
                for a, r in zip(got, want):
                    if a.shape != r.shape or not torch.isfinite(a).all():
                        fail(f"{tag}: shape {tuple(a.shape)} or non-finite values")
                    torch.testing.assert_close(a, r, rtol=RTOL, atol=ATOL)
                    worst = max(worst, float((a - r).abs().max()))
                if name == "B4" and not torch.equal(got[2], ref[2]):
                    fail(f"{tag}: m is not the plain version's bit for bit")
                cases += 1
    gta.launches.update(saved)
    print(f"B3/B4/B5s at {list(MANY_HEADS)} heads of F = 1 (head groups) vs plain on the card: "
          f"{cases} cases on a 300-node set and on the long-row set, each launch counted, "
          f"within rtol=atol={RTOL} (B4's m bit for bit); max abs err {worst:.3e}", flush=True)


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


# Tile shapes other than 128 x 128 (``Graph.from_coo(tile=...)``): B1 and B2
# at sides that are multiples of 8 (rectangular included), the GAT kernels
# at square sides that are multiples of 32 (160 and 256 cut into panels).
SPMM_TILES = ((8, 8), (32, 32), (64, 64), (96, 96), (64, 128), (256, 256))
GAT_SIDES = (32, 64, 96, 160, 256)
TILE_SHAPE_HF = ((2, 4), (1, 40))


def check_tile_shapes(torch):
    """Every kernel against its plain version at the tile shapes above, on
    ``apps/time_spmm.shaped_tiles`` sets (a block row without tiles, one
    split into work items, ragged edges), with each kernel's time there
    (CUDA events, 10 launches after warm-up)."""
    import numpy as np

    from pygcn_tpu_torch.apps.time_spmm import shaped_tiles
    from pygcn_tpu_torch.graph.graph import drop_zero_tiles
    from pygcn_tpu_torch.ops.cuda import bcsr_spmm as b1
    from pygcn_tpu_torch.ops.cuda import gat_tile_attn as gta
    from pygcn_tpu_torch.utils.timing import cuda_ms

    dev = torch.device("cuda")
    worst, cases, times = 0.0, 0, {}

    def hold(name, shape, got, ref, fn=None):
        nonlocal worst, cases
        for a, r in zip(got, ref):
            if a.shape != r.shape or not torch.isfinite(a).all():
                fail(f"{name} at {shape}: shape {tuple(a.shape)} or non-finite values")
            torch.testing.assert_close(a, r, rtol=RTOL, atol=ATOL)
            worst = max(worst, float((a - r).abs().max()))
        cases += 1
        if fn is not None:
            times[f"{name} {shape}"] = round(cuda_ms(fn, iters=10), 4)

    for tile in SPMM_TILES:
        for dtype in (torch.float32, torch.bfloat16):
            b, n_rows, n_cols = shaped_tiles(tile, np.random.default_rng(tile[0]), dtype)
            b = b.to(dev)
            gen = torch.Generator(device=dev).manual_seed(tile[1])
            for h in (40, 128):
                x = torch.randn(n_cols, h, device=dev, generator=gen)
                ref = (b1.bcsr_spmm_plain(b, x, n_rows=n_rows),)
                label = f"{tile[0]}x{tile[1]} {'bf16' if dtype == torch.bfloat16 else 'f32'} H={h}"
                for name, fn in (("B1", b1.bcsr_spmm_cuda), ("B2", b1.bcsr_spmm_stream_cuda)):
                    got = (fn(b, x, n_rows=n_rows),)
                    torch.cuda.synchronize()
                    if got[0][tile[0]:2 * tile[0]].any():
                        fail(f"{name} at {label}: the block row without tiles is not zero")
                    hold(name, label, got, ref,
                         (lambda fn=fn: fn(b, x, n_rows=n_rows)) if dtype == torch.float32
                         and h == 128 else None)

    for side in GAT_SIDES:
        b, n, _ = shaped_tiles((side, side), np.random.default_rng(side), square=True)
        bt = drop_zero_tiles(gta.transpose_bcsr(b))
        b, bt = b.to(dev), bt.to(dev)
        gen = torch.Generator(device=dev).manual_seed(side)
        for h, f in TILE_SHAPE_HF:
            label = f"side {side} {h}x{f}"
            timed = (h, f) == TILE_SHAPE_HF[0]
            lsrc, ldst, dden = (torch.randn(n, h, device=dev, generator=gen) for _ in range(3))
            s2, dnum = (torch.randn(n, h * f, device=dev, generator=gen) for _ in range(2))
            ref = gta.tile_fwd_plain(b, lsrc, ldst, s2, h, f, SLOPE)
            bwd = (lsrc, ldst, s2, ref[2], dnum, dden, h, f, SLOPE)
            for name, fn, args, plain in (
                    ("B3", gta.tile_fwd_cuda, (b, lsrc, ldst, s2, h, f, SLOPE), ref),
                    ("B4", gta.tile_fwd_stream_cuda, (b, lsrc, ldst, s2, h, f, SLOPE), ref),
                    ("B5", gta.tile_bwd_dldst_cuda, (b, *bwd), None),
                    ("B5s", gta.tile_bwd_dldst_stream_cuda, (b, *bwd), None),
                    ("B6", gta.tile_bwd_sender_cuda, (bt, *bwd), None),
                    ("B6s", gta.tile_bwd_sender_stream_cuda, (bt, *bwd), None)):
                if plain is None:
                    plain = ((gta.tile_bwd_dldst_plain(b, *bwd),) if name.startswith("B5")
                             else gta.tile_bwd_sender_plain(bt, *bwd))
                got = fn(*args)
                got = got if isinstance(got, tuple) else (got,)
                torch.cuda.synchronize()
                if name == "B4" and not torch.equal(got[2], ref[2]):
                    fail(f"B4 at {label}: m differs from the plain version's")
                hold(name, label, got, plain, (lambda fn=fn, args=args: fn(*args))
                     if timed else None)
            sl2, sr2 = (torch.randn(n, h * f, device=dev, generator=gen) for _ in range(2))
            a = torch.randn(h, f, device=dev, generator=gen) / f ** 0.5
            ref = gta.tile_v2_fwd_plain(b, sl2, sr2, a, h, f, SLOPE)
            bwd = (sl2, sr2, a, ref[2], dnum, dden, h, f, SLOPE)
            for name, fn, args, plain in (
                    ("B7", gta.tile_v2_fwd_cuda, (b, sl2, sr2, a, h, f, SLOPE), ref),
                    ("B8", gta.tile_v2_bwd_recv_cuda, (b, *bwd),
                     gta.tile_v2_bwd_recv_plain(b, *bwd)),
                    ("B9", gta.tile_v2_bwd_send_cuda, (bt, *bwd),
                     (gta.tile_v2_bwd_send_plain(bt, *bwd),))):
                got = fn(*args)
                got = got if isinstance(got, tuple) else (got,)
                torch.cuda.synchronize()
                hold(name, label, got, plain, (lambda fn=fn, args=args: fn(*args))
                     if timed else None)
            empty = slice(side, 2 * side)  # block row 1 has no tile
            if (ref[2][empty] != gta.NEG).any():
                fail(f"shaped GAT set at side {side}: block row 1 is not empty")
    print(f"tile shapes: {cases} kernel cases within rtol=atol={RTOL} (B1/B2 f32 and bf16 at "
          f"{', '.join(f'{a}x{b}' for a, b in SPMM_TILES)}, H = 40 and 128; B3-B9, B4, B5s and "
          f"B6s at sides {', '.join(map(str, GAT_SIDES))}, heads x width "
          f"{', '.join(f'{a}x{b}' for a, b in TILE_SHAPE_HF)}); max abs err {worst:.3e}",
          flush=True)
    print("tile-shape times (ms, B1/B2 at f32 H=128, GAT at 2x4): " + json.dumps(times),
          flush=True)


# The Cora CLI at its defaults (the synthetic SBM stand-in: 1500 nodes, 7
# classes, 256 features; 200 epochs): accuracy must clear the JAX CLI test's
# band. Dense layout: no hand-written kernel.
CORA_BAND = 0.6


def run_cora(torch):
    """``apps/train_cora`` on the card at its defaults, in the accuracy band,
    launching no tile kernel; with ``--dropout 0`` its final loss within 1e-4
    of the same run on the CPU."""
    from pygcn_tpu_torch.apps import train_cora
    from pygcn_tpu_torch.ops.cuda import bcsr_spmm as b1
    from pygcn_tpu_torch.ops.cuda import gat_tile_attn as gta

    b1.launches = b1.stream_launches = 0
    for k in gta.launches:
        gta.launches[k] = 0
    base = ["--data_dir", os.path.join(HERE, "no_such_dir"), "--fastmode"]  # the SBM
    t0 = time.time()
    card = train_cora.train(train_cora.parse_args(base))
    card_s = time.time() - t0
    tile_launches = b1.launches + b1.stream_launches + sum(gta.launches.values())
    on_card, on_cpu = (train_cora.train(train_cora.parse_args(base + ["--dropout", "0",
                                                                      "--device", dev]))
                       for dev in ("cuda", "cpu"))
    diff = abs(on_card["loss"] - on_cpu["loss"])
    print(f"cora: train_cora on the card at its defaults (SBM 1500 nodes, 200 epochs, dropout "
          f"0.5): test accuracy {card['test_acc']:.4f} (band > {CORA_BAND}), loss "
          f"{card['loss']:.6f}, {card_s:.2f}s; tile-kernel launches {tile_launches} (dense "
          f"layout); --dropout 0: final loss card {on_card['loss']:.7f}, CPU "
          f"{on_cpu['loss']:.7f}, |diff| {diff:.3e}", flush=True)
    if not card["test_acc"] > CORA_BAND:
        fail(f"train_cora test accuracy {card['test_acc']} not above {CORA_BAND}")
    if tile_launches:
        fail(f"train_cora launched {tile_launches} tile kernels on the dense layout")
    if not diff <= 1e-4:
        fail(f"train_cora --dropout 0: card and CPU final losses differ by {diff}")


def run_gat_dropout(torch):
    """A GAT trained with dropout on the hybrid layout: its training steps
    take the slot path (JAX's routing) and launch no tile kernel; its
    evaluation launches B3 once per layer."""
    import numpy as np

    from pygcn_tpu_torch.apps.train_fullgraph import train_step
    from pygcn_tpu_torch.graph.datasets import community_classification
    from pygcn_tpu_torch.nn.gat import GAT
    from pygcn_tpu_torch.ops.cuda import gat_tile_attn as gta
    from pygcn_tpu_torch.ops.gat import build_edge_map, build_gat_tiles_t
    from pygcn_tpu_torch.train.optim import adam_l2

    data = community_classification(n=3000, avg_degree=10, n_classes=5, feat_dim=32,
                                    seed=1, build_dense=False, build_ell=True,
                                    build_hybrid=True, hybrid_min_edges_per_tile=64)
    if data.graph.hybrid.bcsr is None:
        fail("GAT dropout graph has no tiles")
    dev = torch.device("cuda")
    kw = dict(edge_map=build_edge_map(data.graph).to(dev), hybrid_tiles=True,
              tiles_t=build_gat_tiles_t(data.graph).to(dev))
    g = data.graph.to(dev)
    x = torch.from_numpy(data.features).to(dev)
    labels = torch.from_numpy(data.labels.astype(np.int64)).to(dev)
    mask = torch.zeros(g.n_nodes, device=dev)
    mask[torch.from_numpy(data.idx_train.astype(np.int64)).to(dev)] = 1.0
    model = GAT(32, 8, 5, heads=8, dropout=0.5,
                generator=torch.Generator().manual_seed(3)).to(dev)
    opt = adam_l2(model.parameters(), 0.01)
    gen = torch.Generator(device=dev).manual_seed(0)
    for k in gta.launches:
        gta.launches[k] = 0
    model.train()
    losses = [float(train_step(model, opt, x, labels, mask, g, dropout_generator=gen, **kw))
              for _ in range(3)]
    torch.cuda.synchronize()
    train_launches = dict(gta.launches)
    model.eval()
    with torch.no_grad():
        logp = model(x, g, **kw)
    torch.cuda.synchronize()
    eval_launches = {k: gta.launches[k] - train_launches[k] for k in gta.launches}
    print(f"GAT with dropout 0.5 on the hybrid layout: 3 training steps (losses "
          f"{', '.join(f'{v:.4f}' for v in losses)}) launched {sum(train_launches.values())} "
          f"tile kernels (the slot path); evaluation launched {eval_launches}", flush=True)
    if any(train_launches.values()):
        fail(f"GAT training with dropout launched tile kernels: {train_launches}")
    if eval_launches != {**dict.fromkeys(gta.launches, 0), "B3": 2}:
        fail(f"GAT evaluation launched {eval_launches}, expected B3 twice")
    if not all(map(math.isfinite, losses)) or not torch.isfinite(logp).all():
        fail("GAT with dropout: non-finite loss or log-probs")


def run_main_path(torch, epochs):
    from pygcn_tpu_torch.apps import train_fullgraph
    from pygcn_tpu_torch.ops.cuda import bcsr_spmm as b1
    from pygcn_tpu_torch.ops.cuda import ell_spmm as e1
    from pygcn_tpu_torch.utils import native

    print(f"graphkit native library: {'loaded' if native.available() else 'missing (NumPy/BFS fallbacks)'}",
          flush=True)
    b1.launches = b1.stream_launches = e1.launches = 0
    result = train_fullgraph.main(["--clustered", "--max_epochs", str(epochs), "--memstats",
                                   "--device", "cuda"])
    torch.cuda.synchronize()
    launches = b1.launches
    graph = result["graph"]
    # each of the 3 layers' products: one launch of each half forward and,
    # in the step, one of each in the backward; E1 takes one launch a product
    expected = 6 * result["steps"] + 3 * result["evals"]
    print(f"main path: {graph.n_nodes} nodes, {graph.n_edges} edges, tile_frac="
          f"{result['tile_frac']}, {graph.hybrid.bcsr.data.shape[0] if graph.hybrid.bcsr is not None else 0} tiles, "
          f"{result['steps']} steps + {result['evals']} evals, B1 launches {launches}, E1 "
          f"launches {e1.launches} (each expected 6/step + 3/eval = {expected}), ms/step "
          f"{result['epoch_s'] * 1e3:.3f}, peak memory {result['peak_mem_bytes'] / 2**30:.3f} GiB, "
          f"last loss {result['loss']}, best val {result['val']}", flush=True)
    if not result["tile_frac"] or result["tile_frac"] <= 0:
        fail(f"tile_frac={result['tile_frac']}: the hybrid layout has no tiles")
    if launches != expected or launches == 0 or b1.stream_launches:
        fail(f"B1 launched {launches} times on the main path, expected {expected}; "
             f"B2 {b1.stream_launches} times, expected 0")
    if e1.launches != expected:
        fail(f"E1 launched {e1.launches} times on the main path, expected {expected}")
    result["e1_launches"] = e1.launches
    if not math.isfinite(result["loss"]) or not math.isfinite(result["val"]):
        fail(f"non-finite loss {result['loss']} or val {result['val']}")
    return graph, launches, result


# The graph-parallel path at world size 1 (one card; NCCL runs no two ranks
# on one device): the models of train_fullgraph --shards at the CLI's widths
# (the GCN 3 layers of 128/128/40; SAGE and APPNP 128 -> 128 -> 40, APPNP's
# K = 10; GAT and GATv2 8 heads of 8, then 1 of 40), each through
# run_sharded, the runner every rank of --shards runs.
DIST_MODELS = {"gcn": [], "sage": ["--model", "sage"], "appnp": ["--model", "appnp"],
               "gat": ["--model", "gat", "--hidden", "8"],
               "gatv2": ["--model", "gatv2", "--hidden", "8"]}


def _single_device_model(torch, tapp, model, args):
    """The port's single-device model of ``model`` at ``args``' widths."""
    from pygcn_tpu_torch.nn.gat import GAT

    gen = torch.Generator().manual_seed(0)
    if model in ("gat", "gatv2"):
        return GAT(args.feat_dim, args.hidden, args.n_classes, heads=args.gat_heads,
                   v2=model == "gatv2", generator=gen)
    if model in tapp.EXTENSION_MODELS:
        return tapp.EXTENSION_MODELS[model](args.feat_dim, args.hidden, args.n_classes,
                                            generator=gen)
    dims = [args.feat_dim] + [args.hidden] * (args.layers - 1) + [args.n_classes]
    return tapp.GCN(dims, generator=gen)


def run_dist_main_path(torch, gcn_result):
    """``dist_main_path``: the models of ``train_fullgraph --shards`` at world
    size 1 over NCCL (a ``file://`` rendezvous) on the GCN phase's arxiv
    dataset (its ``prepared`` data, not built again), each for a warm-up step
    and EPOCHS epochs through ``train_fullgraph.run_sharded``: finite losses,
    no tile kernel launched (the counts set to 0 before the five runs and
    read after them), each forward at its trained weights equal to the
    port's single-device model on the card within 1e-4 (those forwards run
    after the counts are read: the single-device GCN, SAGE and APPNP take B1
    on the hybrid tiles), then ``--shards 2 --device cuda`` on this one card
    refused with the mesh message. Prints a ``dist {...}`` line: the plan's
    host build seconds, halo rows, ms/step (host clock and CUDA events),
    device-busy ms of a profiled step and peak memory per model, beside the
    single-device GCN's ms/step from the GCN phase. The process group is
    destroyed before it returns. Returns its numbers and the DistGCN's plan
    shard, which ``model_axes`` reuses."""
    from pygcn_tpu_torch.apps import train_fullgraph as tapp

    prepared = gcn_result["prepared"]
    count = _reset_tile_launches()
    runs, out = {}, {"card": card_line(), "nodes": prepared.graph.n_nodes,
                     "edges": prepared.graph.n_edges,
                     "single_device_gcn_ms_per_step": gcn_result["epoch_s"] * 1e3}
    with _OneRankGroup("dist_main_path"):
        for model, flags in DIST_MODELS.items():
            args = tapp.parse_args(["--clustered", "--max_epochs", str(EPOCHS), "--memstats",
                                    "--device", "cuda", *flags])
            t0 = time.perf_counter()
            r = tapp.run_sharded(args, prepared)
            torch.cuda.synchronize()
            r["wall_s"] = time.perf_counter() - t0
            r["args"] = args
            if not math.isfinite(r["loss"]) or not math.isfinite(r["val"]):
                fail(f"dist {model}: non-finite loss {r['loss']} or val {r['val']}")
            runs[model] = r
        launches = count()
        if launches:
            fail(f"dist_main_path launched {launches} tile kernels, expected none")
        x = prepared.x
        splits, out["kernel_ms_outside_the_profiled_steps"] = _dist_step_splits(
            torch, {model: r["step"] for model, r in runs.items()})
        for model, r in runs.items():
            ms = sorted(_event_ms(torch, r["step"])[1] for _ in range(3))
            split = splits[model]
            dm = r["model"]
            with torch.no_grad():
                got = dm(dm.shard_x(x))[: prepared.graph.n_nodes]
                single = _single_device_model(torch, tapp, model, r["args"]).cuda()
                single.load_state_dict(dm.state_dict(), strict=True)
                want = single(x, prepared.graph)
            err = float((got - want).abs().max())
            if not torch.allclose(got, want, rtol=1e-4, atol=1e-4):
                fail(f"dist {model}: world-size-1 forward differs from the single-device "
                     f"model by {err} (limit 1e-4)")
            out[model] = {
                "plan_s": r["plan_s"], "shard_size": r["shard_size"], "halo": r["halo"],
                "halo_rows": r["halo_rows"], "steps": r["steps"], "loss": r["loss"],
                "val": r["val"], "ms_per_step": r["epoch_s"] * 1e3,
                "event_ms_per_step_median": ms[1], "device_busy_ms": split["busy_ms"],
                "profiled_wall_ms": split["wall_ms"],
                "device_launches": split["device_launches"],
                "device_ms_by_group": split["device_ms_by_group"],
                "top_kernels_ms": split["top_kernels_ms"],
                "peak_mem_gib": r["peak_mem_bytes"] / 2**30,
                "forward_max_abs_err_vs_single_device": err, "run_wall_s": r["wall_s"]}
            del single, got, want
        out["tile_kernel_launches"] = launches
        gcn_shard = runs["gcn"]["model"].shard
        runs.clear()
    torch.cuda.empty_cache()
    out["shards2_refusal"] = _mesh_refusal("pygcn_tpu_torch.apps.train_fullgraph",
                                           ["--n_nodes", "1000"])
    print("dist " + json.dumps(out), flush=True)
    return out, gcn_shard


def run_gat_main_path(torch, v2: bool, epochs, hidden=8):
    """``--model gat`` (or ``gatv2``) at the arxiv flagship with 8 heads of
    ``hidden``: every tile kernel of the other version launched 0 times, this
    version's forward kernel 2 per step + 2 per evaluation and its two
    backward kernels 2 per step."""
    from pygcn_tpu_torch.apps import train_fullgraph
    from pygcn_tpu_torch.ops.cuda import gat_tile_attn as gta

    model, (fwd, recv, send) = (("gatv2", ("B7", "B8", "B9")) if v2
                                else ("gat", ("B3", "B5", "B6")))
    for k in gta.launches:
        gta.launches[k] = 0
    result = train_fullgraph.main(["--clustered", "--model", model, "--hidden", str(hidden),
                                   "--max_epochs", str(epochs), "--memstats", "--device", "cuda"])
    torch.cuda.synchronize()
    launches = dict(gta.launches)
    graph = result["graph"]
    steps, evals = result["steps"], result["evals"]
    expected = dict.fromkeys(launches, 0)
    expected.update({fwd: 2 * steps + 2 * evals, recv: 2 * steps, send: 2 * steps})
    tiles = graph.hybrid.bcsr.data.shape[0] if graph.hybrid.bcsr is not None else 0
    print(f"{model} --hidden {hidden} main path: {graph.n_nodes} nodes, {graph.n_edges} edges, tile_frac="
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
    evaluation, B1 none, E1 as often as B2: one launch a product's ELL half)
    and the GAT main path with ``TILE_REVISIT = False`` (B4 2 per step + 2
    per evaluation, B5s and B6s 2 per step, every other tile kernel and E1
    none). Both flags are restored whatever happens."""
    from pygcn_tpu_torch.apps import train_fullgraph
    from pygcn_tpu_torch.ops.cuda import bcsr_spmm as b1
    from pygcn_tpu_torch.ops.cuda import ell_spmm as e1
    from pygcn_tpu_torch.ops.cuda import gat_tile_attn as gta

    saved = (b1.BCSR_STREAM, gta.TILE_REVISIT)
    try:
        b1.BCSR_STREAM = True
        b1.launches = b1.stream_launches = e1.launches = 0
        r = train_fullgraph.main(["--clustered", "--max_epochs", str(epochs), "--memstats",
                                  "--device", "cuda"])
        torch.cuda.synchronize()
        gcn = {"B1": b1.launches, "B2": b1.stream_launches, "E1": e1.launches}
        per = 6 * r["steps"] + 3 * r["evals"]
        want = {"B1": 0, "B2": per, "E1": per}
        print(f"GCN stream main path (BCSR_STREAM): {r['steps']} steps + {r['evals']} evals, "
              f"launches {gcn} (expected B2 and E1 6/step + 3/eval, B1 0: {want}), ms/step "
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
        b1.launches = b1.stream_launches = e1.launches = 0
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
        if (gat != want_gat or (b1.launches, b1.stream_launches, e1.launches) != (0, 0, 0)
                or not math.isfinite(r["loss"]) or not math.isfinite(r["val"])):
            fail(f"GAT stream main path: launches {gat}, expected {want_gat}; B1, B2, E1 "
                 f"{b1.launches}, {b1.stream_launches}, {e1.launches}, expected none; loss "
                 f"{r['loss']}, val {r['val']}")
        return {"B2": gcn["B2"], **{k: gat[k] for k in ("B4", "B5s", "B6s")}}
    finally:
        b1.BCSR_STREAM, gta.TILE_REVISIT = saved


# B1 launches of the extension models' training step and evaluation: each
# spmm is one forward launch, and one backward launch when its input needs a
# gradient. Each such product's ELL half is one E1 launch, so E1 launches as
# often. SAGE and GIN aggregate the input x in layer 1 (no gradient) and
# the hidden layer in layer 2: 2 + 1 per step, 2 per evaluation. APPNP runs
# K = 10 propagation steps on the MLP's output: 10 + 10 per step, 10 per
# evaluation.
EXTENSION_B1 = {"sage": (3, 2), "gin": (3, 2), "appnp": (20, 10)}


def run_extension_main_paths(torch, epochs):
    """``--model sage``, ``gin`` and ``appnp`` at the default widths (128 ->
    128 -> 40): B1 and E1 each exactly :data:`EXTENSION_B1` times, no other
    hand-written kernel."""
    from pygcn_tpu_torch.apps import train_fullgraph
    from pygcn_tpu_torch.ops.cuda import bcsr_spmm as b1
    from pygcn_tpu_torch.ops.cuda import ell_spmm as e1
    from pygcn_tpu_torch.ops.cuda import gat_tile_attn as gta

    total = 0
    for model, (per_step, per_eval) in EXTENSION_B1.items():
        b1.launches = b1.stream_launches = e1.launches = 0
        for k in gta.launches:
            gta.launches[k] = 0
        t0 = time.time()
        r = train_fullgraph.main(["--clustered", "--model", model, "--max_epochs", str(epochs),
                                  "--memstats", "--device", "cuda"])
        torch.cuda.synchronize()
        want = per_step * r["steps"] + per_eval * r["evals"]
        print(f"{model} main path: {r['steps']} steps + {r['evals']} evals, B1 launches "
              f"{b1.launches}, E1 launches {e1.launches} (each expected {per_step}/step + "
              f"{per_eval}/eval = {want}), ms/step "
              f"{r['epoch_s'] * 1e3:.3f}, peak memory {r['peak_mem_bytes'] / 2**30:.3f} GiB, "
              f"last loss {r['loss']}, best val {r['val']}, wall {time.time() - t0:.1f}s",
              flush=True)
        if (b1.launches != want or e1.launches != want or b1.stream_launches
                or any(gta.launches.values()) or not r["tile_frac"]
                or not math.isfinite(r["loss"]) or not math.isfinite(r["val"])):
            fail(f"{model} main path: B1 {b1.launches}, E1 {e1.launches} (each expected "
                 f"{want}), B2 "
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
    # the modes sum the same f32 terms in another order (the stream kernels'
    # reductions in no fixed order), and B4 exponentiates once against the
    # final max where the revisit kernels rescale as they go: relative to the
    # output's largest magnitude they agree to about 1e-6
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
# B3's, B7's, B8's and B9's, timed by time_gat
SWEEP_GAT_MAX_TILES = (1, 2, 4)
# The GAT kernels on work items, with their split-row workspace's floats a
# row (given H and H·F): B3's and B7's (num, den, m), B5's (dldst), B6's
# (ds, dlsrc), B8's (dsr, dapart), B9's (dsl).
ITEM_KERNELS = {"B3": lambda h, hf: hf + 2 * h, "B5": lambda h, hf: h,
                "B6": lambda h, hf: hf + h, "B7": lambda h, hf: hf + 2 * h,
                "B8": lambda h, hf: 2 * hf, "B9": lambda h, hf: hf}


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


def time_e1(torch, graph):
    """E1 at the main path's shapes: the clustered arxiv graph's ELL residual
    at H = 128 and 40 against its plain version (within RTOL/ATOL, the same
    bits in two launches), timed beside the plain version, ``torch.sparse.mm``
    on the residual as a CSR tensor, and its bound (``apps/time_ell``)."""
    from pygcn_tpu_torch.apps.time_ell import e1_bound, residual_csr
    from pygcn_tpu_torch.ops.cuda import ell_spmm as e1
    from pygcn_tpu_torch.ops.ell import ell_spmm_plain
    from pygcn_tpu_torch.utils.timing import cuda_ms

    ell = graph.hybrid.ell
    sched = e1._device_schedule(ell)[0]
    csr = residual_csr(ell)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    saved = e1.launches
    for h in (128, 40):
        x = torch.randn((graph.n_nodes, h), device="cuda", generator=gen)
        ref = ell_spmm_plain(ell, x)
        got, again = e1.ell_spmm_cuda(ell, x), e1.ell_spmm_cuda(ell, x)
        lib = torch.sparse.mm(csr, x)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(lib, ref, rtol=RTOL, atol=ATOL)
        if not torch.equal(got, again):
            fail(f"E1 at H={h} gave other bits in a second launch")
        err = float((got - ref).abs().max())
        del got, again, lib
        ms = cuda_ms(lambda: e1.ell_spmm_cuda(ell, x), iters=50)
        plain_ms = cuda_ms(lambda: ell_spmm_plain(ell, x), iters=20)
        library_ms = cuda_ms(lambda: torch.sparse.mm(csr, x), iters=50)
        ms2 = cuda_ms(lambda: e1.ell_spmm_cuda(ell, x), iters=50)
        bound = e1_bound(ell, sched, h)
        row = {"kernel": "E1", "H": h, "virtual_rows": sum(r.shape[0] for r in ell.rows),
               "items": sched.items.shape[0], "parts": sched.n_parts, "slots": bound["slots"],
               "ms": min(ms, ms2), "ms_runs": [ms, ms2], "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound["bound_ms"], "bound_by": "bytes",
               "bytes": bound["bound_bytes"], "gather_ms": bound["gather_ms"],
               "max_abs_err": err}
        print("E1 timing: " + json.dumps(row), flush=True)
        rows.append(row)
    e1.launches = saved
    return rows


def time_e2(torch, graph):
    """E2 at the products phase's shapes: the GCN graph's column panels at
    H = 128 and 40 against the plain chain (within RTOL/ATOL, the same bits
    in two launches), timed beside the plain chain, ``torch.sparse.mm`` on
    the operator as a CSR tensor, and its bound (``apps/time_colpanel``);
    then E2's 4-byte loads, held alone against the plain chain: at H = 47,
    and at H = 128 on an x whose rows are not 16-byte aligned."""
    from pygcn_tpu_torch.apps.time_colpanel import e2_bound, layout_csr
    from pygcn_tpu_torch.ops.colpanel import col_panel_spmm_plain
    from pygcn_tpu_torch.ops.cuda import colpanel_spmm as e2
    from pygcn_tpu_torch.utils.timing import cuda_ms

    pe = graph.colpanel
    sched = e2._device_schedule(pe, torch.device("cuda", torch.cuda.current_device()))[0]
    a = graph.to_scipy().tocsr()
    csr = layout_csr(a, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    saved = e2.launches

    def hold(got, ref, label):
        torch.cuda.synchronize()
        if got.shape != ref.shape or not torch.isfinite(got).all():
            fail(f"E2 {label}: shape {tuple(got.shape)} or non-finite values")
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
        return float((got - ref).abs().max())

    for h in (128, 40):
        x = torch.randn((graph.n_nodes, h), device="cuda", generator=gen)
        ref = col_panel_spmm_plain(pe, x)
        got, again = e2.colpanel_spmm_cuda(pe, x), e2.colpanel_spmm_cuda(pe, x)
        lib = torch.sparse.mm(csr, x)
        err = hold(got, ref, f"H={h}")
        torch.testing.assert_close(lib, ref, rtol=RTOL, atol=ATOL)
        if not torch.equal(got, again):
            fail(f"E2 at H={h} gave other bits in a second launch")
        del got, again, lib, ref
        ms = cuda_ms(lambda: e2.colpanel_spmm_cuda(pe, x), iters=20)
        plain_ms = cuda_ms(lambda: col_panel_spmm_plain(pe, x), iters=3, warmup=1)
        library_ms = cuda_ms(lambda: torch.sparse.mm(csr, x), iters=20)
        ms2 = cuda_ms(lambda: e2.colpanel_spmm_cuda(pe, x), iters=20)
        bound = e2_bound(sched, graph.n_nodes, a.nnz, h)
        row = {"kernel": "E2", "H": h, "panels": len(pe.panels), "virtual_rows": pe.n_vrows,
               "parts": sched.n_parts, "slots": bound["slots"], "ms": min(ms, ms2),
               "ms_runs": [ms, ms2], "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound["bound_ms"], "bound_by": "bytes", "bytes": bound["bound_bytes"],
               "gather_ms": bound["gather_ms"], "max_abs_err": err}
        print("E2 timing: " + json.dumps(row), flush=True)
        rows.append(row)
        del x
    x = torch.randn((graph.n_nodes, 47), device="cuda", generator=gen)
    rows[0]["max_abs_err_h47"] = hold(e2.colpanel_spmm_cuda(pe, x),
                                      col_panel_spmm_plain(pe, x), "H=47")
    flat = torch.randn(graph.n_nodes * 128 + 1, device="cuda", generator=gen)
    x = flat[1:].view(graph.n_nodes, 128)  # rows 4 bytes off a 16-byte boundary
    rows[0]["max_abs_err_unaligned"] = hold(e2.colpanel_spmm_cuda(pe, x),
                                            col_panel_spmm_plain(pe, x), "H=128 unaligned")
    print(f"E2 vs plain at products: H = 128 and 40 (float4), 47 and an unaligned x at H = 128 "
          f"(4-byte loads) within rtol=atol={RTOL}", flush=True)
    del x, flat, csr
    e2.launches = saved
    return rows


def _rows_under(torch, blocks, size, n):
    """Operand rows a tile set reads on one side: the distinct blocks, capped at n."""
    return min(n, int(torch.unique(blocks).numel()) * size)


def time_gat(torch, graph, tiles_t, v2: bool):
    """B3, B5 and B6 and their stream modes B4, B5s and B6s (with ``v2``: B7,
    B8 and B9) at the GAT main path's tiles, for both layer shapes: kernel
    and plain times (CUDA events), the bound of each function, the kernel's
    time without the longest block row (``ms_without_longest_row``, a
    diagnostic of the launch's tail); B4's, B5s's and B6s's times include
    their outputs' fills, and B4's row gives its bits buffer's traffic, which
    the bound does not count (``bits_bytes``, ``bits_ms``).
    The kernels on work items (:data:`ITEM_KERNELS`)
    also at each C of :data:`SWEEP_GAT_MAX_TILES` (two runs in turns) and the
    same bits in two launches."""
    from pygcn_tpu_torch.apps.time_spmm import F32_FLOPS, HBM_BYTES_PER_S, without_longest_row
    from pygcn_tpu_torch.ops.cuda import gat_tile_attn as gta
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
    # stream modes B4, B5s and B6s compute B3's, B5's and B6's functions from
    # the same inputs into merged [N, .] outputs: they share their bounds.
    same_function = {"B4": "B3", "B5s": "B5", "B6s": "B6"}
    nnz = int(torch.count_nonzero(bcsr.data))
    ops_per_term = {"B3": lambda f: 2 * f + 6, "B5": lambda f: 2 * f + 8,
                    "B6": lambda f: 4 * f + 8, "B7": lambda f: 7 * f + 4,
                    "B8": lambda f: 13 * f + 4, "B9": lambda f: 13 * f + 4}
    fwd_rows = _rows_under(torch, bcsr.block_rows, bcsr.tm, n)
    fwd_cols = _rows_under(torch, bcsr.block_cols, bcsr.tk, n)
    t_rows = _rows_under(torch, tiles_t.block_rows, tiles_t.tm, n)
    t_cols = _rows_under(torch, tiles_t.block_cols, tiles_t.tk, n)

    def tile_bytes(b):
        return b.data.shape[0] * b.tm * b.tk * b.data.element_size()

    # B4's mask words, written by B4a and read by B4b
    bits_bytes = 2 * 16 * bcsr.data.shape[0] * bcsr.tm

    def gat_bytes(name, h, f):
        """Bytes kernel ``name`` must move at H x F: the tiles, the operand
        rows under them, and its outputs, each read or written once (B4's
        bits buffer is its design's own traffic, not counted; its row gives
        it beside the bound)."""
        hf = h * f
        fwd_t, bwd_t = tile_bytes(bcsr), tile_bytes(tiles_t)
        return {
            "B3": fwd_t + 4 * (fwd_cols * (h + hf) + fwd_rows * h + n * (hf + 2 * h)),
            "B5": fwd_t + 4 * (fwd_cols * (h + hf) + fwd_rows * (3 * h + hf) + n * h),
            "B6": bwd_t + 4 * (t_rows * (h + hf) + t_cols * (3 * h + hf) + n * (hf + h)),
            "B7": fwd_t + 4 * (fwd_cols * hf + fwd_rows * hf + hf + n * (hf + 2 * h)),
            "B8": fwd_t + 4 * (fwd_cols * hf + fwd_rows * (2 * hf + 2 * h) + hf + n * 2 * hf),
            "B9": bwd_t + 4 * (t_rows * hf + t_cols * (2 * hf + 2 * h) + hf + n * hf),
        }[same_function.get(name, name)]

    def bound(name, h, f):
        """(bound ms, what bounds it, bytes, operations) of kernel ``name``."""
        flops = nnz * h * ops_per_term[same_function.get(name, name)](f)
        nbytes = gat_bytes(name, h, f)
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
        return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations", nbytes,
                flops)

    short = {id(bcsr): without_longest_row(bcsr), id(tiles_t): without_longest_row(tiles_t)}

    # the tiles per block row: the item kernels (B3, B5-B9) split the long
    # rows into work items; the stream kernels take one CTA per tile
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
        # name: (kernel, plain, tiles)
        if v2:
            sl2, sr2 = (torch.randn(n, hf, device="cuda", generator=gen) for _ in range(2))
            a = torch.randn(h, f, device="cuda", generator=gen)
            fwd = (bcsr, sl2, sr2, a, h, f, SLOPE)
            bwd = (sl2, sr2, a, gta.tile_v2_fwd_plain(*fwd)[2], dnum, dden, h, f, SLOPE)
            runs = {
                "B7": (lambda b: gta.tile_v2_fwd_cuda(b, *fwd[1:]),
                       lambda b: gta.tile_v2_fwd_plain(b, *fwd[1:]), bcsr),
                "B8": (lambda b: gta.tile_v2_bwd_recv_cuda(b, *bwd),
                       lambda b: gta.tile_v2_bwd_recv_plain(b, *bwd), bcsr),
                "B9": (lambda b: gta.tile_v2_bwd_send_cuda(b, *bwd),
                       lambda b: gta.tile_v2_bwd_send_plain(b, *bwd), tiles_t),
            }
        else:
            lsrc, ldst = (torch.randn(n, h, device="cuda", generator=gen) for _ in range(2))
            s2 = torch.randn(n, hf, device="cuda", generator=gen)
            fwd = (bcsr, lsrc, ldst, s2, h, f, SLOPE)
            bwd = (lsrc, ldst, s2, gta.tile_fwd_plain(*fwd)[2], dnum, dden, h, f, SLOPE)
            runs = {
                "B3": (lambda b: gta.tile_fwd_cuda(b, *fwd[1:]),
                       lambda b: gta.tile_fwd_plain(b, *fwd[1:]), bcsr),
                "B5": (lambda b: gta.tile_bwd_dldst_cuda(b, *bwd),
                       lambda b: gta.tile_bwd_dldst_plain(b, *bwd), bcsr),
                "B6": (lambda b: gta.tile_bwd_sender_cuda(b, *bwd),
                       lambda b: gta.tile_bwd_sender_plain(b, *bwd), tiles_t),
                "B4": (lambda b: gta.tile_fwd_stream_cuda(b, *fwd[1:]),
                       lambda b: gta.tile_fwd_plain(b, *fwd[1:]), bcsr),
                "B5s": (lambda b: gta.tile_bwd_dldst_stream_cuda(b, *bwd),
                        lambda b: gta.tile_bwd_dldst_plain(b, *bwd), bcsr),
                "B6s": (lambda b: gta.tile_bwd_sender_stream_cuda(b, *bwd),
                        lambda b: gta.tile_bwd_sender_plain(b, *bwd), tiles_t),
            }
        for name, (kernel_on, plain_on, tiles) in runs.items():
            kernel, plain = (lambda: kernel_on(tiles)), (lambda: plain_on(tiles))
            a, r = kernel(), plain()
            torch.cuda.synchronize()
            a, r = (a if isinstance(a, tuple) else (a,)), (r if isinstance(r, tuple) else (r,))
            err = 0.0
            for x, y in zip(a, r):
                torch.testing.assert_close(x, y, rtol=RTOL, atol=ATOL)
                err = max(err, float((x - y).abs().max()))
            if name == "B4" and not torch.equal(a[2], r[2]):
                fail(f"B4 at H={h} F={f}: m is not the plain version's bit for bit")
            if name in ITEM_KERNELS:
                again = kernel()
                again = again if isinstance(again, tuple) else (again,)
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip(a, again)):
                    fail(f"{name} at H={h} F={f} gave other bits in a second launch")
                del again
            ms = cuda_ms(kernel, iters=20)
            plain_ms = cuda_ms(plain, iters=5, warmup=1)
            ms2 = cuda_ms(kernel, iters=20)
            short_ms = cuda_ms(lambda: kernel_on(short[id(tiles)]), iters=20)
            bound_ms, bound_by, nbytes, flops = bound(name, h, f)
            row = {"kernel": name, "H": h, "F": f, "tiles": tiles.data.shape[0],
                   "tile_nnz": nnz, "ms": min(ms, ms2), "ms_runs": [ms, ms2],
                   "ms_without_longest_row": short_ms, "plain_ms": plain_ms, "library_ms": None,
                   "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops,
                   "max_abs_err": err}
            if name in ITEM_KERNELS:
                by_c = {c: [] for c in SWEEP_GAT_MAX_TILES}
                saved_c = gta.MAX_TILES
                try:
                    for _ in range(2):  # in turns, twice, to show the spread
                        for c in SWEEP_GAT_MAX_TILES:
                            gta.MAX_TILES = c
                            by_c[c].append(cuda_ms(kernel, iters=20))
                finally:
                    gta.MAX_TILES = saved_c
                sched = gta._item_schedule(tiles)[0]
                row.update(ms_by_max_tiles={c: min(v) for c, v in by_c.items()},
                           ms_by_max_tiles_runs=by_c, items=sched.items.shape[0],
                           split_slots=sched.n_slots,
                           workspace_bytes=sched.n_slots * tiles.tm * ITEM_KERNELS[name](h, hf) * 4)
            if name == "B4":  # beside the bound: the bits buffer's traffic, at the card's rate
                row.update(bits_bytes=bits_bytes, bits_ms=bits_bytes / HBM_BYTES_PER_S * 1e3)
            print(f"{name} timing: " + json.dumps(row), flush=True)
            rows.append(row)
            del a, r
    print(f"{'/'.join(runs)} library_ms: null; no single PyTorch call computes these "
          "attention partials or their gradients (a sparse softmax over the tile edges "
          "would need several)", flush=True)
    time_wide_heads(torch, bcsr, tiles_t, n, v2, bound)
    gta.launches.update(saved)
    return rows


def time_wide_heads(torch, bcsr, tiles_t, n, v2: bool, bound):
    """Each tile kernel of the version at the CLI's default width, 8 heads of
    128, on the main path's tiles: kernel times (:func:`check_gat_tiles` and
    :func:`check_stream_kernels` hold them against their plain versions at
    8x128 on the small tile sets), the backward fed the forward kernel's m,
    each beside its bound (``bound(name, h, f)`` of :func:`time_gat`)."""
    from pygcn_tpu_torch.ops.cuda import gat_tile_attn as gta
    from pygcn_tpu_torch.utils.timing import cuda_ms

    h, f = 8, 128
    gen = torch.Generator(device="cuda").manual_seed(8)
    dnum, dden = (torch.randn(n, w, device="cuda", generator=gen) for w in (h * f, h))
    if v2:
        sl2, sr2 = (torch.randn(n, h * f, device="cuda", generator=gen) for _ in range(2))
        a = torch.randn(h, f, device="cuda", generator=gen) / f ** 0.5
        m = gta.tile_v2_fwd_cuda(bcsr, sl2, sr2, a, h, f, SLOPE)[2]
        bwd = (sl2, sr2, a, m, dnum, dden, h, f, SLOPE)
        runs = {"B7": lambda: gta.tile_v2_fwd_cuda(bcsr, sl2, sr2, a, h, f, SLOPE),
                "B8": lambda: gta.tile_v2_bwd_recv_cuda(bcsr, *bwd),
                "B9": lambda: gta.tile_v2_bwd_send_cuda(tiles_t, *bwd)}
    else:
        lsrc, ldst = (torch.randn(n, h, device="cuda", generator=gen) for _ in range(2))
        s2 = torch.randn(n, h * f, device="cuda", generator=gen)
        m = gta.tile_fwd_cuda(bcsr, lsrc, ldst, s2, h, f, SLOPE)[2]
        bwd = (lsrc, ldst, s2, m, dnum, dden, h, f, SLOPE)
        runs = {"B3": lambda: gta.tile_fwd_cuda(bcsr, lsrc, ldst, s2, h, f, SLOPE),
                "B5": lambda: gta.tile_bwd_dldst_cuda(bcsr, *bwd),
                "B6": lambda: gta.tile_bwd_sender_cuda(tiles_t, *bwd),
                "B4": lambda: gta.tile_fwd_stream_cuda(bcsr, lsrc, ldst, s2, h, f, SLOPE),
                "B5s": lambda: gta.tile_bwd_dldst_stream_cuda(bcsr, *bwd),
                "B6s": lambda: gta.tile_bwd_sender_stream_cuda(tiles_t, *bwd)}
    wide = {name: {"ms": cuda_ms(fn, iters=5), "bound_ms": bound(name, h, f)[0],
                   "bound_by": bound(name, h, f)[1]} for name, fn in runs.items()}
    torch.cuda.synchronize()
    print(f"{'/'.join(runs)} at 8 heads of 128 (ms, beside the bound): " + json.dumps(wide),
          flush=True)
    return wide


def gat_kernel_entries(timing, launches, source, lines):
    """The ``kernels`` line's entries of the tile-attention kernels named in
    ``lines`` (name: line of the TPU kernel), from the layer-1 (8x8) row."""
    out = []
    for name, line in lines.items():
        mine = [r for r in timing if r["kernel"] == name]
        layer1 = mine[0]  # H = 8, F = 8
        out.append({
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
        })
    return out


def spmm_kernel_entry(timing, name, launches, line, path=""):
    """The ``kernels`` line's entry of B1 or B2, from its first row (the
    main path's H = 128; the evaluator's bcsr route: H = 640)."""
    mine = [r for r in timing if r["kernel"] == name]
    h128 = mine[0]
    return {
        "name": f"{name} bcsr_spmm{path}",
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


def e1_kernel_entry(timing, launches):
    """The ``kernels`` line's entry of E1, from its first row (the main
    path's H = 128). E1 replaces no TPU kernel: JAX leaves the product to
    XLA."""
    h128 = timing[0]
    return {
        "name": "E1 ell_spmm",
        "route": "cuda",
        "source": "pygcn_tpu_torch/csrc/ell_spmm.cu",
        "replaces": "none (XLA: pygcn_tpu/ops/ell.py:159 ell_spmm_raw)",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in timing),
        "ms": h128["ms"],
        "plain_ms": h128["plain_ms"],
        "bound_ms": h128["bound_ms"],
        "bound_by": h128["bound_by"],
        "library_ms": h128["library_ms"],
    }


def e2_kernel_entry(timing, launches):
    """The ``kernels`` line's entry of E2, from its first row (the products
    GCN's H = 128). E2 replaces no TPU kernel: JAX leaves the product to
    XLA."""
    h128 = timing[0]
    return {
        "name": "E2 colpanel_spmm (products)",
        "route": "cuda",
        "source": "pygcn_tpu_torch/csrc/colpanel_spmm.cu",
        "replaces": "none (XLA: pygcn_tpu/ops/colpanel.py:183 col_panel_spmm_raw)",
        "launches": launches,
        "max_abs_err": max(v for r in timing for k, v in r.items()
                           if k.startswith("max_abs_err")),
        "ms": h128["ms"],
        "plain_ms": h128["plain_ms"],
        "bound_ms": h128["bound_ms"],
        "bound_by": h128["bound_by"],
        "library_ms": h128["library_ms"],
    }


# ---------------------------------------------------------------------- #
# The epidemic simulator (pygcn_tpu_torch/sim): no hand-written kernel; its
# samplers, its bits and its rates at SafeGraph width.
# ---------------------------------------------------------------------- #

# tests/test_draws.py's regimes, at its sample size
DRAW_SAMPLES = 120_000
POISSON_LAMS = (0.3, 3.0, 9.9, 10.1, 50.0, 400.0)
BINOMIAL_NPS = ((5, 0.3), (40, 0.1), (100, 0.5), (1000, 0.002), (1000, 0.3), (1000, 0.97),
                (20000, 0.4), (7, 0.9))
# the policy batch: 8 policies at that width, over a horizon cut to two weeks
BATCH_POLICIES, BATCH_HOURS = 8, 336


def _chi2_pval(samples, ks, pmf):
    from scipy import stats

    obs = np.array([(samples == k).sum() for k in ks], float)
    exp = pmf * samples.size
    keep = exp > 5
    chi2 = ((obs[keep] - exp[keep]) ** 2 / exp[keep]).sum()
    return float(stats.chi2.sf(chi2, int(keep.sum()) - 1))


def check_draws(torch):
    """The card's samplers (``torch.poisson``/``torch.binomial`` on CUDA share
    no code with the CPU's) held to tests/test_draws.py's chi-square and
    moment checks at each of its regimes, and the edge cases."""
    from scipy import stats

    from pygcn_tpu_torch.sim import draws

    dev, n_s = torch.device("cuda"), DRAW_SAMPLES
    g = torch.Generator(device=dev)
    worst = 1.0
    for lam in POISSON_LAMS:
        g.manual_seed(int(lam * 100))
        s = draws.poisson(torch.full((n_s,), lam, device=dev), g).cpu().numpy()
        lo = int(max(0, lam - 6 * np.sqrt(lam + 1)))
        ks = np.arange(lo, int(lam + 6 * np.sqrt(lam + 1) + 10) + 1)
        pval = _chi2_pval(s, ks, stats.poisson.pmf(ks, lam))
        worst = min(worst, pval)
        if not (abs(s.mean() - lam) < 4 * np.sqrt(lam / n_s) + 1e-3
                and abs(s.var() - lam) / lam < 0.05 and pval > 1e-4 and (s >= 0).all()):
            fail(f"poisson({lam}) on the card: mean {s.mean()}, var {s.var()}, chi2 p {pval}")
    for n, p in BINOMIAL_NPS:
        g.manual_seed(n * 31 + int(p * 1000))
        s = draws.binomial(torch.full((n_s,), float(n), device=dev),
                           torch.full((n_s,), p, device=dev), g).cpu().numpy()
        m, v = n * p, n * p * (1 - p)
        sd = max(np.sqrt(v), 1.0)
        ks = np.arange(int(max(0, m - 6 * sd)), int(min(n, m + 6 * sd) + 5) + 1)
        pval = _chi2_pval(s, ks, stats.binom.pmf(ks, n, p))
        worst = min(worst, pval)
        if not (abs(s.mean() - m) < 4 * np.sqrt(v / n_s) + 1e-3
                and abs(s.var() - v) / max(v, 1e-6) < 0.06 and s.min() >= 0 and s.max() <= n
                and pval > 1e-4):
            fail(f"binomial({n}, {p}) on the card: mean {s.mean()}, var {s.var()}, "
                 f"range [{s.min()}, {s.max()}], chi2 p {pval}")
    edge = draws.binomial(torch.tensor([0.0, 10.0, 10.0, 3.9], device=dev),
                          torch.tensor([0.5, 0.0, 1.0, 1.0], device=dev), g).tolist()
    if edge != [0.0, 0.0, 10.0, 3.0]:
        fail(f"binomial edge cases (n=0, p=0, p=1, n=3.9 floored) on the card gave {edge}")
    print(f"draws: poisson at {POISSON_LAMS} and binomial at {BINOMIAL_NPS} on the card, "
          f"{n_s} samples each: moments within bounds, smallest chi-square p {worst:.3g} "
          f"(limit 1e-4); edge cases and the floor of n hold", flush=True)


def _small_sim_world(torch, device, deterministic: bool):
    """A 16-CBG, 6-POI world; ``deterministic``: every draw has p in {0, 1}
    or lambda = 0 (tests/test_torch_sim.py's regime)."""
    from pygcn_tpu_torch.sim import EpidemicParams, VisitSeq

    n_cbgs, n_pois, hours = 16, 6, 24
    rng = np.random.default_rng(11)
    visits = rng.uniform(0, 3.0, (hours, n_pois, n_cbgs)).astype(np.float32)
    visits[visits < 2.0] = 0.0
    kw = (dict(p_sick_at_t0=1.0, cbg_attack_rates_original=np.zeros(n_cbgs),
               cbg_death_rates_original=np.arange(n_cbgs) % 2, latency_period=1.0,
               infectious_period=1.0, confirmation_rate=1.0, confirmation_lag=1.0,
               death_lag=1.0)
          if deterministic else
          dict(p_sick_at_t0=0.01, cbg_attack_rates_original=np.ones(n_cbgs),
               cbg_death_rates_original=np.full(n_cbgs, 0.01)))
    params = EpidemicParams.build(
        poi_areas=rng.uniform(100, 1000, n_pois),
        cbg_sizes=rng.integers(500, 2000, n_cbgs).astype(np.float32), total_hours=72,
        vaccination_time=24, vaccination_vector=np.zeros(n_cbgs),
        vaccine_acceptance=np.ones(n_cbgs), protection_rate=0.5, poi_psi=1500.0,
        home_beta=0.005, device=device, **kw)
    return params, VisitSeq.from_dense(visits, device)


def sim_reference(torch):
    """A small world on the card against the CPU: the deterministic regime's
    outputs bit for bit, the hour rates within 1e-5."""
    from pygcn_tpu_torch.sim import model

    outs = {}
    for dev in ("cuda", "cpu"):
        params, visits = _small_sim_world(torch, dev, True)
        outs[dev] = model.simulate(params, visits, 3, 0)
    bad = [k for k in outs["cpu"] if not torch.equal(outs["cuda"][k].cpu(), outs["cpu"][k])]
    if bad:
        fail(f"simulator, deterministic regime: card and CPU differ in {bad}")
    rng = np.random.default_rng(7)
    state = {k: rng.uniform(0, hi, (3, 16)).astype(np.float32)
             for k, hi in (("latent", 30), ("infected", 150), ("removed", 20))}
    worst = 0.0
    for t in (3, 30):
        rates = {}
        for dev in ("cuda", "cpu"):
            params, visits = _small_sim_world(torch, dev, False)
            rates[dev] = model.compute_hour_rates(
                {k: torch.from_numpy(v).to(dev) for k, v in state.items()}, t, params, visits)
        for k, ref in rates["cpu"].items():
            got = rates["cuda"][k].cpu()
            if not torch.allclose(got.double(), ref.double(), rtol=1e-5, atol=1e-5):
                fail(f"hour rates at t={t}: {k} on the card differs from the CPU by "
                     f"{(got.double() - ref.double()).abs().max().item()}")
            worst = max(worst, (got.double() - ref.double()).abs().max().item())
    params, visits = _small_sim_world(torch, "cuda", False)
    out = model.simulate(params, visits, 8, 3)
    if not all(torch.isfinite(v.float()).all() for v in out.values()):
        fail("small simulator run on the card: non-finite outputs")
    print(f"sim reference: deterministic 72-hour run card == CPU bit for bit "
          f"({len(outs['cpu'])} outputs); hour rates at t=3, 30 within {worst:.3g} "
          f"(limit 1e-5); stochastic run finite", flush=True)


def _reset_tile_launches():
    from pygcn_tpu_torch.ops.cuda import bcsr_spmm as b1
    from pygcn_tpu_torch.ops.cuda import gat_tile_attn as gta

    b1.launches = b1.stream_launches = 0
    for k in gta.launches:
        gta.launches[k] = 0
    return lambda: b1.launches + b1.stream_launches + sum(gta.launches.values())


def _same_bits(torch, a, b):
    return [k for k in a if not torch.equal(a[k], b[k])]


def _event_ms(torch, fn):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _profile_split(torch, fn):
    """Device milliseconds of one call of ``fn``, from torch.profiler: all
    kernels and copies, and those launched inside the simulator's
    ``sim.visit_products`` and ``sim.draws`` ranges."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()

    def annotation(e):
        return getattr(e, "is_user_annotation", False) or e.name.startswith("sim.")

    split = {"device_busy_ms": sum(e.device_time_total for e in events
                                   if e.device_type == DeviceType.CUDA and not annotation(e))}
    for name in ("sim.visit_products", "sim.draws"):
        split[name] = sum(e.device_time_total for e in events
                          if e.name == name and e.device_type == DeviceType.CPU)
    return {k: v / 1e3 for k, v in split.items()}


def sim_main_path(torch):
    """The simulator at SafeGraph width on the card (``apps/time_sim``'s
    world: 2943 CBGs, 50,000 POIs, 600K visit entries an hour, one week of
    hourly matrices reused, a 1512-hour horizon, 40 seeds, exact draws): two
    runs of one seed give equal bits, the paged run (a week a page) the
    one-shot run's; a 24-hour block and two one-day pages run with no host
    sync (CUDA's sync debug mode); the block is timed, then profiled, for
    its split and idle share; ms/hour, seed-hours/s and peak memory are
    printed."""
    import dataclasses

    from pygcn_tpu_torch.apps.time_sim import SAFEGRAPH, safegraph_params, safegraph_visits
    from pygcn_tpu_torch.sim import HostVisitSeq, VisitSeq, simulate, simulate_paged

    c = SAFEGRAPH
    t0 = time.time()
    poi, cbg, w = safegraph_visits()
    params = safegraph_params()
    host = HostVisitSeq(poi, cbg, w, c["n_pois"], c["n_cbgs"])
    torch.cuda.synchronize()
    t1 = time.time()
    visits = VisitSeq.from_coo(poi, cbg, w, c["n_pois"], c["n_cbgs"], "cuda")
    torch.cuda.synchronize()
    build_s, upload_s = t1 - t0, time.time() - t1
    launched = _reset_tile_launches()

    t3 = time.time()
    host.layout  # sorted on the host and page-locked once: pages are row copies of it
    host_sort_s = time.time() - t3
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    with torch.cuda.stream(side):
        page = host.page(0, c["period"], "cuda")  # a week, as simulate_paged queues it
    page_queue_ms = 1e3 * (time.perf_counter() - t4)
    side.synchronize()
    page_ready_ms = 1e3 * (time.perf_counter() - t4)
    del page
    day = dataclasses.replace(params, total_hours=24)
    two_days = dataclasses.replace(params, total_hours=48)
    simulate(day, visits, c["seeds"], 1)  # first calls, outside the sync check
    simulate_paged(two_days, host, c["seeds"], 1, page_hours=24)
    torch.cuda.set_sync_debug_mode("error")
    try:
        simulate(day, visits, c["seeds"], 1)
        simulate_paged(two_days, host, c["seeds"], 1, page_hours=24)
    except RuntimeError as e:
        fail(f"simulator: a 24-hour block or a page synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _, day_ms = _event_ms(torch, lambda: simulate(day, visits, c["seeds"], 1))
    split = _profile_split(torch, lambda: simulate(day, visits, c["seeds"], 1))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t2 = time.perf_counter()
    out, run_ms = _event_ms(torch, lambda: simulate(params, visits, c["seeds"], 7))
    wall_s = time.perf_counter() - t2
    peak = torch.cuda.max_memory_allocated()
    if not all(t.is_pinned() for t in host.layout.tensors()):
        fail("the host-sorted visit layout is not page-locked: its pages would block the host")

    def paged_run():
        return _event_ms(torch, lambda: simulate_paged(params, host, c["seeds"], 7,
                                                       page_hours=c["period"]))

    # one-shot and paged in turns: the host's clock varies from run to run
    paged, paged_ms = paged_run()
    again, again_ms = _event_ms(torch, lambda: simulate(params, visits, c["seeds"], 7))
    paged2, paged2_ms = paged_run()
    tiles = launched()

    bad = _same_bits(torch, out, again)
    if bad:
        fail(f"simulator at SafeGraph width: two runs of one seed differ in {bad}")
    bad = _same_bits(torch, out, paged) + _same_bits(torch, out, paged2)
    if bad:
        fail(f"simulator at SafeGraph width: simulate_paged differs from simulate in {bad}")
    days = c["hours"] // 24
    shapes = {"L": (days, c["seeds"]), "history_C2": (days, c["seeds"], c["n_cbgs"]),
              "C2": (c["seeds"], c["n_cbgs"]), "total_affected": (c["seeds"],),
              "monitor": (c["hours"], 5)}
    for k, shape in shapes.items():
        if tuple(out[k].shape) != shape:
            fail(f"simulator output {k} has shape {tuple(out[k].shape)}, expected {shape}")
    if not all(torch.isfinite(v.float()).all() for v in out.values()):
        fail("simulator at SafeGraph width: non-finite outputs")
    affected = out["cbg_all_affected"]
    if (affected < 0).any() or (affected > params.cbg_sizes + 1e-3).any() or \
            not out["total_affected"].gt(0).all():
        fail("simulator at SafeGraph width: affected counts outside [0, population] or zero")
    if tiles:
        fail(f"the simulator launched {tiles} tile kernels; its path has none")
    ms_hour = run_ms / c["hours"]
    result = {
        "cbgs": c["n_cbgs"], "pois": c["n_pois"], "entries_per_hour": c["entries"],
        "period_hours": c["period"], "hours": c["hours"], "seeds": c["seeds"], "draws": "exact",
        "ms_per_hour": ms_hour, "repeat_ms_per_hour": again_ms / c["hours"],
        "paged_ms_per_hour": paged_ms / c["hours"],
        "paged_repeat_ms_per_hour": paged2_ms / c["hours"],
        "seed_hours_per_s": c["seeds"] * c["hours"] / (run_ms / 1e3),
        "host_wall_s": wall_s, "visit_seq_device_bytes": visits.nbytes,
        "peak_memory_bytes": peak, "world_build_s": build_s, "upload_sort_s": upload_s,
        "host_sort_pin_s": host_sort_s, "page_queue_host_ms": page_queue_ms,
        "page_ready_ms": page_ready_ms, "block24_ms": day_ms,
        "block24_device_busy_ms": split["device_busy_ms"],
        "block24_visit_products_ms": split["sim.visit_products"],
        "block24_draws_ms": split["sim.draws"],
        "block24_idle_share": 1 - split["device_busy_ms"] / day_ms,
        "final_affected_share": float(out["total_affected"].mean() / params.cbg_sizes.sum()),
        "final_confirmed_mean": float(out["C2"].sum(-1).mean()),
    }
    print(f"sim_main_path: {c['n_cbgs']} CBGs x {c['n_pois']} POIs, {c['entries']} entries/h, "
          f"{c['period']}-hour period, {c['hours']} hours, {c['seeds']} seeds, exact draws: "
          f"{ms_hour:.4f} ms/hour (repeat {again_ms / c['hours']:.4f}; paged, in turns with "
          f"them, {paged_ms / c['hours']:.4f} and {paged2_ms / c['hours']:.4f}), "
          f"{result['seed_hours_per_s']:.1f} seed-hours/s; "
          f"visit sequence {visits.nbytes / 2**30:.3f} GiB on the card, peak "
          f"{peak / 2**30:.3f} GiB; the first 24-hour block {day_ms:.3f} ms, of it (profiled) "
          f"products {split['sim.visit_products']:.3f} ms, draws {split['sim.draws']:.3f} ms, "
          f"card busy {split['device_busy_ms']:.3f} ms: idle share "
          f"{result['block24_idle_share']:.3f}; bits repeat, paged == one-shot, no host sync "
          f"in a block or a page, no tile kernel", flush=True)
    print("sim " + json.dumps(result), flush=True)
    return visits, params


def policy_batch(torch, visits, params):
    """8 policies at SafeGraph width in one batch: rows 0 and 7 equal their
    runs alone (the horizon cut to BATCH_HOURS)."""
    import dataclasses

    from pygcn_tpu_torch.apps.time_sim import SAFEGRAPH
    from pygcn_tpu_torch.sim import simulate, simulate_policy_batch

    c = SAFEGRAPH
    params = dataclasses.replace(params, total_hours=BATCH_HOURS)
    fracs = torch.linspace(0.0, 0.7, BATCH_POLICIES, device="cuda")
    attack = params.attack_orig[None] * (1 - fracs[:, None])
    seeds = [100 + b for b in range(BATCH_POLICIES)]
    out, ms = _event_ms(torch, lambda: simulate_policy_batch(
        params, visits, attack, seeds, c["seeds"], extract=lambda o: o))
    for b in (0, BATCH_POLICIES - 1):
        solo = simulate(dataclasses.replace(params, attack_vac=attack[b]), visits, c["seeds"],
                        seeds[b])
        bad = [k for k in solo if not torch.equal(out[k][b], solo[k])]
        if bad:
            fail(f"policy batch row {b} differs from its run alone in {bad}")
    print(f"policy_batch: {BATCH_POLICIES} policies x {c['seeds']} seeds at SafeGraph width, "
          f"horizon cut from {c['hours']} to {BATCH_HOURS} hours: {ms / BATCH_HOURS:.4f} "
          f"ms/hour for the batch ({BATCH_POLICIES * c['seeds'] * BATCH_HOURS / (ms / 1e3):.1f}"
          f" seed-hours/s); rows 0 and {BATCH_POLICIES - 1} equal their runs alone", flush=True)


def run_sim_clis(torch):
    """``apps/gt_gen --quick_test`` and ``apps/no_vac_baseline --quick_test``
    through their ``main`` at their default device, the card."""
    import csv
    import tempfile

    from pygcn_tpu_torch.apps import gt_gen, no_vac_baseline

    launched = _reset_tile_launches()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "vac.csv")
        gt_gen.main(["--quick_test", "--out", path])
        with open(path, newline="") as fh:
            rows = list(csv.DictReader(fh))
        cases, deaths = no_vac_baseline.main(["--quick_test", "--out_dir", d])
        files = sorted(os.listdir(d))
    values = [float(r[k]) for r in rows for k in ("Total_Cases", "Case_Rates_STD",
                                                  "Total_Deaths", "Death_Rates_STD")]
    if len(rows) != 5 or not all(math.isfinite(v) and v >= 0 for v in values):
        fail(f"gt_gen --quick_test on the card wrote {len(rows)} rows, outcomes {values}")
    if len(files) != 5 or not np.isfinite(cases).all() or not cases[-1].sum() > 0:
        fail(f"no_vac_baseline --quick_test on the card wrote {files}, cases {cases[-1]}")
    if launched():
        fail("the simulator CLIs launched tile kernels")
    print(f"gt_gen --quick_test on the card: {len(rows)} rows (baseline total cases "
          f"{rows[0]['Total_Cases']}); no_vac_baseline --quick_test: {files}", flush=True)


# ---------------------------------------------------------------------- #
# The surrogate evaluator (apps/train_evaluator and its neighbours) at
# SafeGraph width: the dense co-visitation graph on cuBLAS, no tile kernel;
# with impl="bcsr" its products run kernel B1 on the graph's tiles.
# ---------------------------------------------------------------------- #

# SafeGraph's CBG count; the POI count and the horizon only shape the
# co-visitation graph and the ground truth's cost, not the evaluator's width
EVAL_WORLD = ["--n_cbgs", "2943", "--n_pois", "500", "--hours", "48"]
# ground truth: policies (the reference used 990) and simulator seeds each
EVAL_POLICIES, EVAL_SEEDS = 200, 2
# the CLI's defaults: batch 20, hidden 32; epochs before the preemption, and
# the one resumed after it
EVAL_BATCH, EVAL_HIDDEN, EVAL_EPOCHS = 20, 32, 3
# steps timed by CUDA events (after EVAL_WARMUP untimed), and profiled
EVAL_TIMED, EVAL_WARMUP, EVAL_PROFILED = 50, 5, 10


def _evaluator_setup(torch, csv_path):
    """The evaluator's inputs as ``apps/train_evaluator`` builds them, on
    the card: world, features, targets, split; with the seconds of the
    world and of the centralities."""
    from pygcn_tpu_torch.apps import train_evaluator as tev
    from pygcn_tpu_torch.apps.common import build_synthetic_world
    from pygcn_tpu_torch.data.features import assemble_evaluator_features, centrality_features
    from pygcn_tpu_torch.data.vac_results import load_vac_results

    t0 = time.perf_counter()
    world = build_synthetic_world(n_cbgs=int(EVAL_WORLD[1]), n_pois=int(EVAL_WORLD[3]),
                                  hours=int(EVAL_WORLD[5]), seed=42, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cent = centrality_features(world.adj)
    t2 = time.perf_counter()
    res = load_vac_results(csv_path)
    feats, dim = assemble_evaluator_features(tev.build_predictor_features(world, res), cent,
                                             True, False)
    y = res.graph_labels[:, 0]
    y = ((y - y.mean()) / (y.std() + 1e-8)).astype(np.float32)
    return world, res, feats, dim, y, t1 - t0, t2 - t1


def _kernel_time_split(torch, fn, top=4):
    """Device milliseconds of ``fn()`` from torch.profiler: all kernels and
    copies (user annotations left out), their count, and the ``top``
    kernels by time."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name, count = Counter(), 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            by_name[e.name] += e.device_time_total / 1e3
            count += 1
    return sum(by_name.values()), count, {k[:60]: v for k, v in by_name.most_common(top)}


def _time_b1_at(torch, graph, h):
    """B1 on ``graph.bcsr`` at ``x [n, h]`` against its plain version (and
    again, bit for bit), timed by CUDA events beside ``torch.mm`` on the
    dense matrix and its bound; launches made here are not counted."""
    from pygcn_tpu_torch.apps.time_spmm import spmm_bound
    from pygcn_tpu_torch.ops.cuda import bcsr_spmm as b1
    from pygcn_tpu_torch.utils.timing import cuda_ms

    bcsr, n = graph.bcsr, graph.n_nodes
    x = torch.randn((n, h), device="cuda", generator=torch.Generator(device="cuda").manual_seed(5))
    saved = b1.launches
    got, again = b1.bcsr_spmm_cuda(bcsr, x, n_rows=n), b1.bcsr_spmm_cuda(bcsr, x, n_rows=n)
    ref = b1.bcsr_spmm_plain(bcsr, x, n_rows=n)
    mm = torch.mm(graph.dense, x)
    exact = torch.mm(graph.dense.double(), x.double())
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(mm, ref, rtol=RTOL, atol=ATOL)
    if not torch.equal(got, again):
        fail(f"B1 at [{n}, {h}] gave other bits in a second launch")
    ms = [cuda_ms(lambda: b1.bcsr_spmm_cuda(bcsr, x, n_rows=n), iters=50) for _ in range(2)]
    mm_ms = [cuda_ms(lambda: torch.mm(graph.dense, x), iters=50) for _ in range(2)]
    b1.launches = saved
    bound_ms, bound_by, nbytes, flops = spmm_bound(bcsr, n, h)
    return {"kernel": "B1", "n": n, "H": h, "tiles": bcsr.data.shape[0],
            "tile_nnz": flops // (2 * h), "tile_fill": flops / (2 * h) / bcsr.data.numel(),
            "ms": min(ms), "ms_runs": ms,
            "plain_ms": cuda_ms(lambda: b1.bcsr_spmm_plain(bcsr, x, n_rows=n), iters=10),
            "library_ms": min(mm_ms), "library_ms_runs": mm_ms, "library": "torch.mm",
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "flops": flops,
            "max_abs_err": float((got - ref).abs().max()),
            "f64_max_abs_err": float((got.double() - exact).abs().max()),
            "library_f64_max_abs_err": float((mm.double() - exact).abs().max()),
            "plain_f64_max_abs_err": float((ref.double() - exact).abs().max())}


def run_evaluator_main_path(torch, keep_dir):
    """The evaluator pipeline at SafeGraph width through its CLIs on the
    card: ``gt_gen`` writes the ground truth (EVAL_POLICIES policies);
    ``train_evaluator`` trains four epochs, and again three that end in a
    SIGTERM caught by its preemption guard, then ``--resume`` runs the
    fourth: the weights equal the uninterrupted run's within 1e-6. No tile
    kernel runs on this path (dense layout). Then one step is timed by CUDA
    events and profiled; the same model with ``impl="bcsr"`` is held
    against ``impl="dense"`` (outputs, gradients and weights after an Adam
    step within 1e-4; B1 launched 6 times a step), and B1 is timed at the
    folded ``[2943, 640]`` product against its plain version, ``torch.mm``
    on the dense matrix and its bound; ``baselines mlp``, ``summary-ols``
    and ``train_legacy`` take a few epochs. Prints an ``evaluator {...}``
    line; returns B1's row for the ``kernels`` line and the evaluator's
    inputs (world, split, features, targets) for ``dp_evaluator``. The
    trained ``evaluator.pkl`` and the ground truth ``vac.csv`` are copied
    into ``keep_dir`` for the phases after."""
    import pickle
    import shutil
    import signal
    import tempfile

    from pygcn_tpu_torch.apps import baselines, gt_gen, train_legacy
    from pygcn_tpu_torch.apps import train_evaluator as tev
    from pygcn_tpu_torch.convert import tree_to_state_dict
    from pygcn_tpu_torch.data.loader import ArrayLoader
    from pygcn_tpu_torch.ops.cuda import bcsr_spmm as b1
    from pygcn_tpu_torch.train.optim import adam_l2
    from pygcn_tpu_torch.utils.timing import cuda_ms

    class PreemptedLogger(tev.MetricsLogger):
        """Raises SIGTERM once the epoch EVAL_EPOCHS - 1 is logged: the
        guard latches it and the loop saves its preemption checkpoint."""

        def log(self, step, **metrics):
            super().log(step, **metrics)
            if step == EVAL_EPOCHS - 1:
                signal.raise_signal(signal.SIGTERM)

    out = {"cbgs": int(EVAL_WORLD[1]), "pois": int(EVAL_WORLD[3]), "hours": int(EVAL_WORLD[5]),
           "policies": EVAL_POLICIES, "sim_seeds": EVAL_SEEDS, "batch": EVAL_BATCH,
           "hidden": EVAL_HIDDEN}
    with tempfile.TemporaryDirectory() as d:
        csv_path = os.path.join(d, "vac.csv")
        t0 = time.perf_counter()
        gt_gen.main(["--out", csv_path, "--num_samples", str(EVAL_POLICIES), "--num_seeds",
                     str(EVAL_SEEDS), "--batch", "50", *EVAL_WORLD])
        out["gt_gen_s"] = time.perf_counter() - t0
        common = ["--vac_result_path", csv_path, *EVAL_WORLD]
        launched = _reset_tile_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        test_loss, test_corr = tev.main(common + ["--out_dir", os.path.join(d, "full"),
                                                  "--epochs", str(EVAL_EPOCHS + 1)])
        out["cli_4_epochs_s"] = time.perf_counter() - t0
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        pre = os.path.join(d, "pre")
        saved_logger = tev.MetricsLogger
        tev.MetricsLogger = PreemptedLogger
        try:
            preempted = tev.main(common + ["--out_dir", pre, "--epochs", str(EVAL_EPOCHS + 1)])
        finally:
            tev.MetricsLogger = saved_logger
        if preempted is not None or not os.path.exists(os.path.join(pre, "checkpoint_last.pkl")):
            fail("train_evaluator: SIGTERM after epoch 2 did not end in a preemption save")
        resumed = tev.main(common + ["--out_dir", pre, "--epochs", "1", "--resume"])
        shutil.copy(os.path.join(d, "full", "evaluator.pkl"), keep_dir)
        params = {}
        for name in ("full", "pre"):
            with open(os.path.join(d, name, "evaluator.pkl"), "rb") as f:
                params[name] = pickle.load(f)["params"]
        full, pre = (tree_to_state_dict(params[k]) for k in ("full", "pre"))
        diffs = [float((full[k] - pre[k]).abs().max()) for k in full]
        out["resume_max_abs_diff"] = max(diffs)
        if max(diffs) > 1e-6 or abs(resumed[0] - test_loss) > 1e-6:
            fail(f"train_evaluator --resume after {EVAL_EPOCHS} epochs differs from 4 "
                 f"uninterrupted epochs: weights by {max(diffs)}, test loss {resumed[0]} "
                 f"against {test_loss}")
        if not (math.isfinite(test_loss) and -1 <= test_corr <= 1):
            fail(f"train_evaluator: test loss {test_loss}, Spearman {test_corr}")
        out.update(test_loss=test_loss, test_spearman=test_corr)

        mse, corr = baselines.main(["mlp", *common, "--epochs", "2"])
        fit = baselines.main(["summary-ols", *common])
        legacy = train_legacy.main(["--vac_result_path", csv_path, *EVAL_WORLD, "--epochs", "3"])
        if not all(math.isfinite(v) for v in (mse, corr, fit["r2"], legacy)):
            fail(f"baselines/train_legacy: mlp {mse} {corr}, ols r2 {fit['r2']}, "
                 f"legacy {legacy}")
        out.update(mlp_test_mse=mse, ols_r2=fit["r2"], legacy_test_loss=legacy)
        if launched():
            fail(f"the evaluator's CLIs launched {launched()} tile kernels; the dense "
                 "layout has none")
        world, res, feats, dim, y, out["world_s"], out["centralities_s"] = \
            _evaluator_setup(torch, csv_path)
        shutil.copy(csv_path, keep_dir)

    graph = world.graph
    feats_dev, y_dev = torch.from_numpy(feats).cuda(), torch.from_numpy(y).cuda()
    model = tev.make_model(dim, feats.shape[2], EVAL_HIDDEN, 42, device="cuda")
    step = tev.make_train_step(model, adam_l2(model.parameters(), 0.01, 5e-4,
                                              grad_clip_norm=0.1), graph)
    batches = tev.epoch_batches(torch.from_numpy(np.array(res.idx_train)).cuda(), EVAL_BATCH)
    n_steps = len(batches)
    turn = itertools.count()

    def one_step():
        idx = batches[next(turn) % n_steps]
        return step(feats_dev.index_select(0, idx), y_dev.index_select(0, idx))

    step_ms = [cuda_ms(one_step, iters=EVAL_TIMED, warmup=EVAL_WARMUP) for _ in range(2)]
    busy_ms, n_kernels, top = _kernel_time_split(
        torch, lambda: [one_step() for _ in range(EVAL_PROFILED)])
    val = ArrayLoader([feats[res.idx_val], y[res.idx_val]], EVAL_BATCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [one_step() for _ in range(n_steps)]
    torch.stack(losses).tolist()
    tev.evaluate(model, graph, val, "cuda")
    out["epoch_s"] = time.perf_counter() - t0
    out.update(ms_per_step=min(step_ms), ms_per_step_runs=step_ms, steps_per_epoch=n_steps,
               profiled_device_ms_per_step=busy_ms / EVAL_PROFILED,
               device_idle_share=1 - busy_ms / EVAL_PROFILED / min(step_ms),
               kernels_per_step=n_kernels / EVAL_PROFILED,
               profiled_top_kernels_ms_per_step={n: v / EVAL_PROFILED for n, v in top.items()},
               n_features=feats.shape[2], dim_touched=dim)

    b1_row = _time_b1_at(torch, graph, EVAL_BATCH * EVAL_HIDDEN)
    n, h, ms, mm_ms = b1_row["n"], b1_row["H"], b1_row["ms_runs"], b1_row["library_ms_runs"]
    bound_ms, bound_by = b1_row["bound_ms"], b1_row["bound_by"]

    # the same model on kernel B1 (impl="bcsr") against the dense layout
    out.update(_bcsr_route(torch, tev, b1, adam_l2, graph, feats_dev.index_select(0, batches[0]),
                           y_dev.index_select(0, batches[0]), dim, feats.shape[2]))
    b1_row["launches"] = b1_launches = out["bcsr_route_b1_launches_per_step"]
    print("evaluator B1 timing: " + json.dumps(b1_row), flush=True)
    print(f"evaluator_main_path: {n} CBGs, batch {EVAL_BATCH}, hidden {EVAL_HIDDEN}, "
          f"{feats.shape[2]} features: {min(step_ms):.4f} ms a step (CUDA events; "
          f"{step_ms}; the card busy {out['profiled_device_ms_per_step']:.4f} ms of it, "
          f"{out['kernels_per_step']:.0f} kernels), epoch {out['epoch_s']:.3f} s, "
          f"centralities {out['centralities_s']:.2f} s, "
          f"peak {out['peak_memory_bytes'] / 2**30:.3f} GiB; test loss {test_loss:.4f}, "
          f"Spearman {test_corr:.4f} (a stand-in: training moves); --resume after "
          f"{EVAL_EPOCHS} epochs == 4 epochs within {out['resume_max_abs_diff']:.3g}; "
          f"impl=bcsr == dense within {out['bcsr_route_max_abs_err']:.3g} "
          f"({out['bcsr_route_sign_flips']} weights stepped the other way), B1 "
          f"{b1_launches} launches a step; B1 at "
          f"[{n}, {h}] {min(ms):.4f} ms against torch.mm {min(mm_ms):.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}); no tile kernel on the CLIs", flush=True)
    print("evaluator " + json.dumps(out), flush=True)
    return b1_row, {"world": world, "res": res, "feats": feats, "dim": dim, "y": y,
                    "csv": os.path.join(keep_dir, "vac.csv")}


def _bcsr_route(torch, tev, b1, adam_l2, graph, bx, by, dim, n_features):
    """One evaluator step with ``impl="bcsr"`` (B1) against ``impl="dense"``
    (cuBLAS), the same weights and batch: outputs and gradients within
    rtol = atol = 1e-4, and each route's weights after its Adam step equal
    that step computed from its own gradient (1e-6), which is the other
    route's within 1e-4 wherever the two gradients Adam sees (clipped, plus
    the L2 term) have one sign. A first Adam step moves each weight by the
    learning rate times the sign of that gradient, whatever its size, so an
    element whose gradient lies within rounding of zero may step either way
    on the two routes: such elements are counted and reported, and their
    gradients are held to 1e-4 with the rest."""
    from pygcn_tpu_torch.ops.cuda import ell_spmm as e1

    lr, wd = 0.01, 5e-4
    runs = {}
    for impl in ("dense", "bcsr"):
        m = tev.make_model(dim, n_features, EVAL_HIDDEN, 42, impl=impl, device="cuda")
        w0 = {n: p.detach().clone() for n, p in m.named_parameters()}
        with torch.no_grad():
            fwd = m(bx, graph)
        opt = adam_l2(m.parameters(), lr, wd, grad_clip_norm=0.1)
        step = tev.make_train_step(m, opt, graph)
        before, e1_before = b1.launches, e1.launches
        step(bx, by)
        torch.cuda.synchronize()
        # Adam's first moment after one step is (1 - b1) times the gradient it
        # saw (clipped, plus the L2 term); its step is lr·m/(sqrt(v)/sqrt(1-b2) + eps)/(1-b1)
        state = {n: opt.state[p] for n, p in m.named_parameters()}
        runs[impl] = {
            "output": fwd, "grads": {n: p.grad.clone() for n, p in m.named_parameters()},
            "seen": {n: st["exp_avg"] for n, st in state.items()},
            "weights": {n: p.detach().clone() for n, p in m.named_parameters()},
            "expected": {n: w0[n] - lr / 0.1 * st["exp_avg"] / (
                st["exp_avg_sq"].sqrt() / 0.001 ** 0.5 + 1e-8) for n, st in state.items()},
            "launches": b1.launches - before, "e1_launches": e1.launches - e1_before}
    d, b = runs["dense"], runs["bcsr"]
    if d["e1_launches"] or b["e1_launches"]:
        fail(f"evaluator step: E1 launched {d['e1_launches']} times on the dense layout and "
             f"{b['e1_launches']} on bcsr (neither has an ELL half)")
    if d["launches"] != 0 or b["launches"] != 6:
        fail(f"evaluator step: B1 launched {d['launches']} times on the dense layout "
             f"and {b['launches']} on bcsr (expected 0 and 6)")
    bad, worst, flips, n_weights = [], 0.0, [], 0

    def hold(name, got, ref, rtol, atol, where=None):
        err = (got - ref).abs()
        over = err > atol + rtol * ref.abs()
        if where is not None:
            over &= where
        if over.any():
            j = int(torch.nonzero(over.flatten())[0])
            bad.append(f"{name}: {int(over.sum())} of {ref.numel()} off, e.g. "
                       f"{float(got.flatten()[j])} against {float(ref.flatten()[j])}")
        return float(err[where].max()) if where is not None and where.any() else \
            float(err.max()) if where is None else 0.0

    worst = max(worst, hold("output", b["output"], d["output"], RTOL, ATOL))
    for n, ref in d["grads"].items():
        worst = max(worst, hold(f"grad {n}", b["grads"][n], ref, RTOL, ATOL))
        for run in (d, b):
            hold(f"Adam step of {n}", run["weights"][n], run["expected"][n], 0.0, 1e-6)
        same_sign = torch.sign(b["seen"][n]) == torch.sign(d["seen"][n])
        worst = max(worst, hold(f"weight {n}", b["weights"][n], d["weights"][n], RTOL, ATOL,
                                same_sign))
        n_weights += ref.numel()
        for j in torch.nonzero(~same_sign.flatten()).flatten().tolist():
            flips.append(f"{n}[{j}]: {float(d['seen'][n].flatten()[j]):.3g} (dense) against "
                         f"{float(b['seen'][n].flatten()[j]):.3g} (bcsr)")
    if bad:
        fail("evaluator step, impl=bcsr against dense: " + "; ".join(bad))
    print(f"evaluator bcsr route: outputs, gradients and weights within rtol=atol=1e-4 "
          f"(max abs err {worst:.3g}); {len(flips)} of {n_weights} weights stepped the other "
          f"way, their gradients within rounding of zero: {flips}", flush=True)
    return {"bcsr_route_max_abs_err": worst, "bcsr_route_b1_launches_per_step": b["launches"],
            "bcsr_route_sign_flips": len(flips), "bcsr_route_weights": n_weights}


# ---------------------------------------------------------------------- #
# The policy generators and the server (pygcn_tpu_torch/policy, apps/
# train_generator, train_rl, predict): the dense graph reaches no
# hand-written kernel; the generator's impl="bcsr" route runs B1 at H = 32.
# ---------------------------------------------------------------------- #

# the generator CLI's defaults (NN 5, hidden 32, --max_validate 8,
# --num_seeds 8) for GEN_EPOCHS epochs; steps timed by CUDA events (after
# GEN_WARMUP untimed), and profiled; weight states the bcsr route starts from
GEN_EPOCHS, GEN_NN, GEN_HIDDEN = 20, 5, 32
GEN_TIMED, GEN_WARMUP, GEN_PROFILED = 50, 5, 10
GEN_ROUTE_STATES = (0, 10, 20, 30, 40)
# REINFORCE: 128 policies an episode (the reference samples 1000)
RL_EPISODES = 3
RL_ARGS = ["--episodes", str(RL_EPISODES), "--epoch_width", "128", "--num_seeds", "4",
           "--replay_width", "4"]
# serving: the fixed batch, and requests for 200 batches (199 latencies once
# the first is left out)
SERVE_BATCH = 32
SERVE_REQUESTS = 200 * SERVE_BATCH


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def run_generator_main_path(torch, evaluator_path):
    """``apps/train_generator`` on the card at SafeGraph width against the
    evaluator that ``evaluator_main_path`` trained: GEN_EPOCHS epochs at its
    defaults, then again with ``--hierarchical`` and ``--target_group`` the
    income group that the plain run's policies pick most from (the two runs
    start from the same weights and differ only by the mask, so the mask
    binds). Every validated policy has NN distinct nodes, the hierarchical
    ones none of the target group's, the losses are finite,
    ``policies.pkl`` reads back as plain types, and no tile kernel runs.
    Then one generator step is timed by CUDA events and profiled; the step
    on ``impl="bcsr"`` (generator and evaluator on the graph's tiles, kernel
    B1) is held against the dense one from several weight states (loss and
    the generator's gradients within 1e-4; the flags equal wherever the
    NN-th and (NN+1)-th scores lie further apart than that), with B1's
    launches a step; B1 is timed at ``[2943, 32]``. Returns B1's row for the
    ``kernels`` line and the phase's numbers."""
    import collections
    import tempfile

    from pygcn_tpu_torch.apps import train_generator as tgen
    from pygcn_tpu_torch.apps.common import build_synthetic_world
    from pygcn_tpu_torch.policy import make_generator_train_step
    from pygcn_tpu_torch.train.checkpoint import load_evaluator, load_plain_pickle
    from pygcn_tpu_torch.train.optim import adam_l2
    from pygcn_tpu_torch.utils.timing import cuda_ms

    out = {"cbgs": int(EVAL_WORLD[1]), "epochs": GEN_EPOCHS, "NN": GEN_NN, "hidden": GEN_HIDDEN}
    world = build_synthetic_world(n_cbgs=int(EVAL_WORLD[1]), n_pois=int(EVAL_WORLD[3]),
                                  hours=int(EVAL_WORLD[5]), seed=42, device="cuda")
    groups = tgen.generator_inputs(world, hierarchical=True)[0][:, -1]
    runs = {}
    launched = _reset_tile_launches()
    with tempfile.TemporaryDirectory() as d:
        for name in ("plain", "hierarchical"):
            if name == "plain":
                extra = []
            else:
                picked = collections.Counter(int(groups[i]) for r in runs["plain"]
                                             for i in r["policy"])
                target = picked.most_common(1)[0][0]
                extra = ["--hierarchical", "--target_group", str(target)]
                out.update(target_group=target, plain_picks_of_target=picked[target])
            run_dir = os.path.join(d, name)
            t0 = time.perf_counter()
            results = tgen.main(["--evaluator", evaluator_path, "--out_dir", run_dir, "--epochs",
                                 str(GEN_EPOCHS), *EVAL_WORLD, *extra])
            out[f"{name}_cli_s"] = time.perf_counter() - t0
            losses = [r["train_loss"] for r in _jsonl(os.path.join(run_dir, "metrics.jsonl"))]
            saved = load_plain_pickle(os.path.join(run_dir, "policies.pkl"))
            if not (len(losses) == GEN_EPOCHS and all(math.isfinite(v) for v in losses)):
                fail(f"train_generator {name}: losses {losses}")
            if [r["policy"] for r in saved["results"]] != [r["policy"] for r in results] \
                    or not results:
                fail(f"train_generator {name}: policies.pkl does not hold the run's results")
            for r in results:
                if len(set(r["policy"])) != GEN_NN or len(r["policy"]) != GEN_NN \
                        or not math.isfinite(r["total_cases"]):
                    fail(f"train_generator {name}: policy {r}")
            runs[name] = results
            out[f"{name}_policies"] = len(results)
            out[f"{name}_first_loss"], out[f"{name}_last_loss"] = losses[0], losses[-1]
            out[f"{name}_best_cases"] = min(r["total_cases"] for r in results)
    if launched():
        fail(f"train_generator launched {launched()} tile kernels; the dense layout has none")
    picked = [i for r in runs["hierarchical"] for i in r["policy"] if groups[i] == target]
    if picked:
        fail(f"train_generator --hierarchical --target_group {target} picked nodes {picked} "
             f"of that group; the plain run picked {out['plain_picks_of_target']}")
    gen_feats, dim, eval_block = tgen.generator_inputs(world)
    evaluator, _ = load_evaluator(evaluator_path, "cuda")
    eval_base = torch.from_numpy(tgen.evaluator_base(evaluator, eval_block)).cuda()
    x = torch.from_numpy(gen_feats).cuda()
    gen = tgen.make_generator(gen_feats.shape[1], dim, GEN_HIDDEN, GEN_NN, 42, device="cuda")
    step = make_generator_train_step(gen, evaluator, adam_l2(gen.parameters(), 0.01, 5e-4),
                                     world.graph, eval_base)
    states, turn = {}, itertools.count()

    def one_step():
        k = next(turn)
        if k in GEN_ROUTE_STATES:
            states[k] = {n: t.detach().clone() for n, t in gen.state_dict().items()}
        return step(x)

    step_ms = [cuda_ms(one_step, iters=GEN_TIMED, warmup=GEN_WARMUP) for _ in range(2)]
    busy_ms, n_kernels, top = _kernel_time_split(
        torch, lambda: [one_step() for _ in range(GEN_PROFILED)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(GEN_PROFILED):  # the CLI's epoch: a step and its one host copy
        loss, flag = step(x)
        torch.cat([loss.reshape(1), flag[:, 0]]).cpu()
    out.update(ms_per_step=min(step_ms), ms_per_step_runs=step_ms,
               ms_per_epoch_with_sync=(time.perf_counter() - t0) * 1e3 / GEN_PROFILED,
               profiled_device_ms_per_step=busy_ms / GEN_PROFILED,
               device_idle_share=1 - busy_ms / GEN_PROFILED / min(step_ms),
               kernels_per_step=n_kernels / GEN_PROFILED,
               profiled_top_kernels_ms_per_step={n: v / GEN_PROFILED for n, v in top.items()},
               n_features=gen_feats.shape[1], dim_touched=dim)

    out.update(_generator_bcsr_route(torch, tgen, world, evaluator_path, x, eval_base,
                                     gen_feats.shape[1], dim, [states[k] for k in sorted(states)]))
    b1_row = _time_b1_at(torch, world.graph, GEN_HIDDEN)
    b1_row["launches"] = out["bcsr_route_b1_launches_per_step"]
    print("generator B1 timing: " + json.dumps(b1_row), flush=True)
    print(f"generator_main_path: {world.n_cbgs} CBGs, hidden {GEN_HIDDEN}, NN {GEN_NN}: "
          f"{min(step_ms):.4f} ms a step (CUDA events; {step_ms}; the card busy "
          f"{out['profiled_device_ms_per_step']:.4f} ms of it, {out['kernels_per_step']:.0f} "
          f"kernels), {out['ms_per_epoch_with_sync']:.4f} ms an epoch with its host copy; "
          f"CLI {out['plain_cli_s']:.2f} s, --hierarchical {out['hierarchical_cli_s']:.2f} s "
          f"(--target_group {target}: none of its nodes against the plain run's "
          f"{out['plain_picks_of_target']}); "
          f"impl=bcsr == dense within {out['bcsr_route_max_abs_err']:.3g} over "
          f"{len(states)} weight states, B1 {b1_row['launches']} launches a step; B1 at "
          f"[{world.n_cbgs}, {GEN_HIDDEN}] {b1_row['ms']:.4f} ms against torch.mm "
          f"{b1_row['library_ms']:.4f} ms, bound {b1_row['bound_ms']:.4f} ms "
          f"({b1_row['bound_by']}); no tile kernel on the CLIs", flush=True)
    return b1_row, out, world


def _generator_bcsr_route(torch, tgen, world, evaluator_path, x, eval_base, n_features, dim,
                          states):
    """One generator step on ``impl="bcsr"`` (B1, generator and evaluator)
    against ``impl="dense"`` from each of ``states``: the loss and the
    generator's gradients within rtol = atol = 1e-4, and the flags equal
    where the NN-th and (NN+1)-th scores (before the step) lie further apart
    than 1e-4 on both routes; closer pairs are reported. B1 runs 6 times a
    step: the generator's three graph convolutions forward and backward (the
    evaluator's GCN sees only the constant base, so the step is made with
    its output, and the gradient crosses no evaluator convolution)."""
    from pygcn_tpu_torch.ops.cuda import bcsr_spmm as b1
    from pygcn_tpu_torch.ops.cuda import ell_spmm as e1
    from pygcn_tpu_torch.policy import make_generator_train_step
    from pygcn_tpu_torch.train.checkpoint import load_evaluator
    from pygcn_tpu_torch.train.optim import adam_l2

    graph, worst, near, bad, launches = world.graph, 0.0, [], [], set()
    models = {}
    for impl in ("dense", "bcsr"):
        evaluator, _ = load_evaluator(evaluator_path, "cuda", impl=impl)
        gen = tgen.make_generator(n_features, dim, GEN_HIDDEN, GEN_NN, 42, impl=impl,
                                  device="cuda")
        opt = adam_l2(gen.parameters(), 0.01, 5e-4)
        models[impl] = (gen, opt, make_generator_train_step(gen, evaluator, opt, graph, eval_base))
    for k, state in enumerate(states):
        runs = {}
        for impl, (gen, opt, step) in models.items():
            gen.load_state_dict(state)
            opt.state.clear()
            with torch.no_grad():
                scores = gen.scores(x, graph)[:, 0]
            before, e1_before = b1.launches, e1.launches
            loss, flag = step(x)
            torch.cuda.synchronize()
            top = torch.topk(scores, GEN_NN + 1).values
            runs[impl] = {"loss": loss, "flag": flag, "gap": float(top[-2] - top[-1]),
                          "grads": {n: p.grad.clone() for n, p in gen.named_parameters()},
                          "launches": b1.launches - before,
                          "e1_launches": e1.launches - e1_before}
        d, b = runs["dense"], runs["bcsr"]
        if d["launches"] != 0:
            fail(f"generator step: B1 launched {d['launches']} times on the dense layout")
        if d["e1_launches"] or b["e1_launches"]:
            fail(f"generator step: E1 launched {d['e1_launches']} times on the dense layout "
                 f"and {b['e1_launches']} on bcsr (neither has an ELL half)")
        launches.add(b["launches"])
        if min(d["gap"], b["gap"]) <= RTOL:
            near.append({"state": k, "gap_dense": d["gap"], "gap_bcsr": b["gap"],
                         "same_flags": bool(torch.equal(d["flag"] > 0, b["flag"] > 0))})
            continue
        if not torch.equal(d["flag"] > 0, b["flag"] > 0):
            bad.append(f"state {k}: flags differ with the NN-th score {d['gap']:.3g} above "
                       "the next")
            continue
        pairs = [("loss", b["loss"], d["loss"])] + [
            (f"grad {n}", b["grads"][n], g) for n, g in d["grads"].items()]
        for name, got, ref in pairs:
            err = (got - ref).abs()
            worst = max(worst, float(err.max()))
            if (err > ATOL + RTOL * ref.abs()).any():
                bad.append(f"state {k}: {name} off by {float(err.max()):.3g}")
    if launches != {6}:
        fail(f"generator step on impl=bcsr: B1 launched {sorted(launches)} times a step "
             "(expected 6)")
    (per_step,) = launches
    if bad or len(near) == len(states):
        fail("generator step, impl=bcsr against dense: " + "; ".join(bad or ["every state "
             "had the NN-th and (NN+1)-th scores within 1e-4"]))
    print(f"generator bcsr route: losses and gradients within rtol=atol=1e-4 (max abs err "
          f"{worst:.3g}) from {len(states) - len(near)} weight states, flags equal; "
          f"{len(near)} states with the NN-th and (NN+1)-th scores within 1e-4: {near}",
          flush=True)
    return {"bcsr_route_max_abs_err": worst, "bcsr_route_b1_launches_per_step": per_step,
            "bcsr_route_states": len(states), "bcsr_route_near_ties": near}


def run_rl_main_path(torch):
    """``apps/train_rl`` on the card at SafeGraph width: RL_ARGS (128
    policies an episode, 4 seeds), then again in the same ``--out_dir``.
    Every simulated policy (each sampled row, the cache's key) is NN distinct
    nodes, the average rewards finite, ``checkpoint_rl.pkl`` written, the
    greedy policy NN nodes. The cache shards hold one entry for each policy
    the first run simulated before its last dump (its ``metrics.jsonl``
    misses), and the rerun's misses are exactly the entries it adds to them:
    it simulates no policy the merged cache answers. Reads each episode's
    seconds, the simulator's seconds in it, and its misses from
    ``metrics.jsonl``."""
    import tempfile

    from pygcn_tpu_torch.apps import train_rl
    from pygcn_tpu_torch.policy import SimCache
    from pygcn_tpu_torch.train.checkpoint import load_plain_pickle

    def dumped_misses(records):
        return int(records[-1]["baseline_misses"] + sum(r["misses"] for r in records[:-1]))

    out = {"cbgs": int(EVAL_WORLD[1]), "args": " ".join(RL_ARGS)}
    with tempfile.TemporaryDirectory() as d:
        argv = ["--out_dir", d, *RL_ARGS, *EVAL_WORLD]
        t0 = time.perf_counter()
        final_cases, baseline = train_rl.main(argv)
        out["cli_s"] = time.perf_counter() - t0
        log = _jsonl(os.path.join(d, "metrics.jsonl"))
        ckpt = load_plain_pickle(os.path.join(d, "checkpoint_rl.pkl"))
        dumped = set(SimCache(d).cache)
        t0 = time.perf_counter()
        train_rl.main(argv)
        out["rerun_s"] = time.perf_counter() - t0
        rerun = _jsonl(os.path.join(d, "metrics.jsonl"))[len(log):]
        merged = set(SimCache(d).cache)

    if [r["step"] for r in log + rerun] != 2 * list(range(RL_EPISODES + 1)):
        fail(f"train_rl: metrics.jsonl steps {[r['step'] for r in log + rerun]}")
    bad = [p for p in merged if len(set(p)) != GEN_NN or len(p) != GEN_NN]
    if bad:
        fail(f"train_rl: {len(bad)} simulated policies without {GEN_NN} distinct nodes, "
             f"e.g. {bad[:2]}")
    episodes = log[:-1]
    avg = [r["avg_reward"] for r in episodes]
    if not all(math.isfinite(v) for v in avg) or not math.isfinite(ckpt["avg_rewards"]):
        fail(f"train_rl: average rewards {avg}, checkpoint {ckpt.get('avg_rewards')}")
    greedy = [log[-1]["greedy"], rerun[-1]["greedy"]]
    if any(len(set(g)) != GEN_NN for g in greedy):
        fail(f"train_rl: greedy policies {greedy}")
    if dumped_misses(log) != len(dumped) or not dumped <= merged \
            or dumped_misses(rerun) != len(merged - dumped):
        fail(f"train_rl rerun: the first run simulated {dumped_misses(log)} policies before its "
             f"last dump and its shards hold {len(dumped)}; the rerun simulated "
             f"{dumped_misses(rerun)} and added {len(merged - dumped)} to them")
    per_episode = [{"s": r["episode_s"], "sim_s": r["sim_s"],
                    "sim_share": r["sim_s"] / r["episode_s"], "misses": int(r["misses"])}
                   for r in episodes]
    out.update(episodes=per_episode, baseline_cases=baseline, final_cases=final_cases,
               baseline_sim_s=log[-1]["baseline_sim_s"], avg_rewards=avg,
               cache_policies=len(dumped), rerun_misses=dumped_misses(rerun),
               greedy=greedy[0])
    print(f"rl_main_path: {out['cbgs']} CBGs, {' '.join(RL_ARGS)}: episodes "
          + ", ".join(f"{p['s']:.2f} s ({p['misses']} misses, simulator "
                      f"{100 * p['sim_share']:.0f}%)" for p in per_episode)
          + f"; the rerun simulated {out['rerun_misses']} policies before its last dump "
          f"(shards of {len(dumped)}); greedy {greedy[0]}: {final_cases:.1f} cases against "
          f"the random baseline's {baseline:.1f}", flush=True)
    return out


def run_serve_main_path(torch, evaluator_path, world):
    """``apps/predict`` on the card at SafeGraph width: SERVE_REQUESTS random
    policies in batches of SERVE_BATCH from ``evaluator.pkl``, writing a
    ``torch.export`` artifact, then from that artifact in a fresh process,
    which imports no ``pygcn_tpu_torch.nn`` module: the predictions agree
    within 1e-5; a batch padded from 1 row to SERVE_BATCH gives the
    unpadded row within 1e-5. Prints a ``serve {...}`` line: p50/p99 ms a
    batch over the batches after the first (their count beside them), the
    export's seconds."""
    import csv
    import tempfile

    from pygcn_tpu_torch.apps import predict

    out = {"cbgs": int(EVAL_WORLD[1]), "requests": SERVE_REQUESTS, "batch": SERVE_BATCH}
    with tempfile.TemporaryDirectory() as d:
        art = os.path.join(d, "art.pt2")
        common = ["--random", str(SERVE_REQUESTS), *EVAL_WORLD]
        t0 = time.perf_counter()
        eager, timing = predict.main(["--evaluator", evaluator_path, "--batch", str(SERVE_BATCH),
                                      "--export", art, "--out", os.path.join(d, "a.csv"),
                                      *common])
        out["cli_s"] = time.perf_counter() - t0
        code = (
            "import sys\n"
            f"sys.path.insert(0, {HERE!r})\n"
            "from pygcn_tpu_torch.apps import predict\n"
            f"predict.main(['--from_export', {art!r}, '--out', {os.path.join(d, 'b.csv')!r}, "
            f"*{common!r}])\n"
            "bad = sorted(m for m in sys.modules if m.startswith('pygcn_tpu_torch.nn'))\n"
            "print('MODEL_MODULES', bad)\n"
            "sys.exit(1 if bad else 0)\n"
        )
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              timeout=600, cwd=d)
        out["from_export_process_s"] = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"predict --from_export: rc {proc.returncode}\n{proc.stdout}\n{proc.stderr}")
        with open(os.path.join(d, "b.csv")) as f:
            served = np.array([float(r["Prediction"]) for r in csv.DictReader(f)], np.float32)
        latency = [ln for ln in proc.stdout.splitlines() if "latency p50=" in ln][0]
    err = float(np.abs(served - eager).max())
    if served.shape != eager.shape or not np.isfinite(eager).all() \
            or not np.allclose(served, eager, rtol=1e-5, atol=1e-5):
        fail(f"predict: the exported artifact's {served.shape} predictions against the "
             f"eager {eager.shape}: max abs err {err}")

    server, feature_mode = predict.load_server(evaluator_path, world, "cuda")
    rng = np.random.default_rng(3)
    feats = predict._policy_features(world, [rng.choice(world.n_cbgs, GEN_NN, replace=False)],
                                     feature_mode)
    with torch.inference_mode():
        row = torch.from_numpy(feats).cuda()
        alone = server(row)
        padded = server(torch.cat([row, row.new_zeros((SERVE_BATCH - 1,) + row.shape[1:])]))
    pad_err = float((padded[:1] - alone).abs().max())
    if not torch.allclose(padded[:1], alone, rtol=1e-5, atol=1e-5):
        fail(f"predict: a row padded to {SERVE_BATCH} moved by {pad_err} "
             f"({float(padded[0])} against {float(alone[0])})")
    served_lat = timing["batch_ms"][1:]
    out.update(p50_ms=float(np.percentile(served_lat, 50)),
               p99_ms=float(np.percentile(served_lat, 99)), batches_timed=len(served_lat),
               max_ms=max(served_lat), export_s=timing["export_s"], export_max_abs_err=err,
               padding_max_abs_err=pad_err, from_export_latency=latency.split("; ")[-1])
    print("serve " + json.dumps(out), flush=True)
    return out


# ---------------------------------------------------------------------- #
# The layouts for graphs above a million nodes: column panels, panels, the
# hybrid's column-panel residual and the column-panel attention, checked at
# the arxiv flagship graph, then trained at ogbn-products scale.
# ---------------------------------------------------------------------- #


def check_colpanel_arxiv(torch, graph):
    """On the arxiv flagship graph (the GCN main path's, ordered ids), with the
    column panels, the panels and the hybrid's column-panel residual built:
    ``spmm``, its gradient and ``spmm_t`` of each against ``impl="segment"``
    (within RTOL/ATOL, the same bits on a second call; the hybrid launching
    B1 three times a call, as a kernel; the column panels and the hybrid's
    column-panel residual launching E2 three times a call), B1 on that
    route's tiles timed beside its plain version, ``torch.sparse.mm`` and
    its bound, and ``gat_conv_colpanel``/``gatv2_conv_colpanel`` at 8 heads
    of 8, outputs
    and gradients, against the COO attention path run in f64 (each tensor
    within RTOL and ATOL times its largest magnitude; the f32 COO path's own
    error is printed beside; forward bits repeat). Returns the B1 timing
    row, with its launches."""
    from pygcn_tpu_torch.apps.time_spmm import spmm_bound
    from pygcn_tpu_torch.graph.graph import Graph
    from pygcn_tpu_torch.ops.cuda import bcsr_spmm as b1
    from pygcn_tpu_torch.ops.cuda import colpanel_spmm as e2
    from pygcn_tpu_torch.ops.gat import attention_aggregate, gat_attention, gatv2_attention
    from pygcn_tpu_torch.ops.gat_colpanel import gat_conv_colpanel, gatv2_conv_colpanel
    from pygcn_tpu_torch.ops.spmm import spmm, spmm_t
    from pygcn_tpu_torch.utils.timing import cuda_ms

    t0 = time.perf_counter()
    g = Graph.from_scipy(graph.to_scipy(), is_symmetric=True, build_dense=False,
                         build_bcsr=False, build_ell=False, build_hybrid=True,
                         hybrid_residual="colpanel", hybrid_min_edges_per_tile=64,
                         build_panel=True, build_colpanel=True)
    build_s = time.perf_counter() - t0
    g = g.to("cuda")
    n, cp, hy = g.n_nodes, g.colpanel, g.hybrid
    out = {"nodes": n, "edges": g.n_edges, "build_s": build_s, "panels": len(cp.panels),
           "virtual_rows": cp.n_vrows, "tiles": hy.bcsr.data.shape[0],
           "tile_frac": hy.tile_edges / g.n_edges,
           "residual_virtual_rows": hy.ell.n_vrows}
    gen = torch.Generator(device="cuda").manual_seed(11)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, device="cuda", generator=gen) * scale
    x, cot = randn(n, 128), randn(n, 128)

    def run(impl):
        xx = x.clone().requires_grad_()
        y = spmm(g, xx, impl=impl)
        (dx,) = torch.autograd.grad(y, xx, cot)
        return y.detach(), dx, spmm_t(g, x, impl=impl)

    ref = run("segment")
    saved = b1.launches, b1.stream_launches
    b1.launches = b1.stream_launches = 0
    e2_launches = {}
    for impl in ("colpanel", "panel", "hybrid"):
        e2_before = e2.launches
        got, again = run(impl), run(impl)
        torch.cuda.synchronize()
        e2_launches[impl] = e2.launches - e2_before
        if impl == "hybrid":
            launches = b1.launches
        for name, a, r in zip(("spmm", "grad", "spmm_t"), got, ref):
            try:
                torch.testing.assert_close(a, r, rtol=RTOL, atol=ATOL)
            except AssertionError as e:
                fail(f"{impl} {name} at the arxiv graph against segment: {e}")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"{impl} SpMM at the arxiv graph gave other bits in a second call")
        out[impl] = {"max_abs_err": max(float((a - r).abs().max()) for a, r in zip(got, ref)),
                     "ms": cuda_ms(lambda: spmm(g, x, impl=impl), iters=10)}
    b1.launches, b1.stream_launches = saved
    out["segment_ms"] = cuda_ms(lambda: spmm(g, x, impl="segment"), iters=10)
    if launches != 6 or b1.stream_launches:
        fail(f"hybrid(residual='colpanel') launched B1 {launches} times in two calls "
             "(forward, gradient, spmm_t), expected 6")
    # the column panels and the hybrid's column-panel residual run E2, a
    # launch a product; the panels keep their own path
    if e2_launches != {"colpanel": 6, "panel": 0, "hybrid": 6}:
        fail(f"E2 launches in two calls (forward, gradient, spmm_t): {e2_launches}, expected "
             "6 for colpanel and hybrid, 0 for panel")
    out["e2_launches"] = e2_launches

    bcsr = hy.bcsr
    saved = b1.launches
    got = b1.bcsr_spmm_cuda(bcsr, x, n_rows=n)
    ref_b = b1.bcsr_spmm_plain(bcsr, x, n_rows=n)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref_b, rtol=RTOL, atol=ATOL)
    csr = _tile_csr(torch, bcsr, n, n)
    bound_ms, bound_by, nbytes, flops = spmm_bound(bcsr, n, 128)
    ms = [cuda_ms(lambda: b1.bcsr_spmm_cuda(bcsr, x, n_rows=n), iters=50) for _ in range(2)]
    b1_row = {"kernel": "B1", "H": 128, "tiles": bcsr.data.shape[0], "launches": launches,
              "ms": min(ms), "ms_runs": ms,
              "plain_ms": cuda_ms(lambda: b1.bcsr_spmm_plain(bcsr, x, n_rows=n), iters=10),
              "library_ms": cuda_ms(lambda: torch.sparse.mm(csr, x), iters=50),
              "library": "torch.sparse.mm", "bound_ms": bound_ms, "bound_by": bound_by,
              "bytes": nbytes, "flops": flops, "max_abs_err": float((got - ref_b).abs().max())}
    b1.launches = saved
    del got, ref_b, csr, x, cot

    h, f = 8, 8
    s, s_r, gcot = randn(n, h, f), randn(n, h, f), randn(n, h, f)
    a1, a2, a3 = randn(h, f, scale=0.3), randn(h, f, scale=0.3), randn(h, f, scale=0.3)
    cases = {
        "gat": ((s, a1, a2), lambda t: gat_conv_colpanel(g, *t, SLOPE),
                lambda t: attention_aggregate(g, t[0], gat_attention(g, *t, SLOPE))),
        "gatv2": ((s, s_r, a3), lambda t: gatv2_conv_colpanel(g, *t, SLOPE),
                  lambda t: attention_aggregate(g, t[0], gatv2_attention(g, *t, SLOPE))),
    }
    for name, (inputs, colpanel, coo) in cases.items():
        def fwd_bwd(fn, dtype=torch.float32):
            t = [v.to(dtype).requires_grad_() for v in inputs]
            y = fn(t)
            return [y.detach()] + list(torch.autograd.grad(y, t, gcot.to(dtype)))
        got, again = fwd_bwd(colpanel), fwd_bwd(colpanel)
        ref, coo32 = fwd_bwd(coo, torch.float64), fwd_bwd(coo)
        torch.cuda.synchronize()
        errs, coo_errs = [], []
        for i, (a, r, c) in enumerate(zip(got, ref, coo32)):
            # the gradients of a and a_src sum terms over all 4.45M edges in
            # f32: each tensor is held to 1e-4 of its own largest magnitude
            scale = max(1.0, float(r.abs().max()))
            errs.append(float((a.double() - r).abs().max()) / scale)
            coo_errs.append(float((c.double() - r).abs().max()) / scale)
            try:
                torch.testing.assert_close(a.double(), r, rtol=RTOL, atol=ATOL * scale)
            except AssertionError as e:
                fail(f"{name}_conv_colpanel {'output' if i == 0 else f'gradient {i}'} "
                     f"against the COO attention path in f64: {e}")
        if not torch.equal(got[0], again[0]):
            fail(f"{name}_conv_colpanel gave other output bits in a second call")
        out[name] = {"scaled_err_vs_f64": errs, "coo_f32_scaled_err_vs_f64": coo_errs,
                     "grad_repeat_max_abs_diff": max(float((a - b).abs().max())
                                                     for a, b in zip(got[1:], again[1:])),
                     "ms_fwd_bwd": cuda_ms(lambda: fwd_bwd(colpanel), iters=3),
                     "coo_ms_fwd_bwd": cuda_ms(lambda: fwd_bwd(coo), iters=3)}
        del got, again, ref, coo32
    print("colpanel arxiv " + json.dumps(out), flush=True)
    print("B1 timing (hybrid colpanel residual): " + json.dumps(b1_row), flush=True)
    return b1_row


# The ogbn-products cell (tools/bench_products.py:36-38): 2,449,029 nodes,
# average degree 13 (about 63M directed edges), 128 features, hidden 128, 40
# classes, the 3-layer GCN; GAT and GATv2 at 8 heads of 8, the configuration
# JAX ran at this scale (tools/bench_gat_products_r4.py:9).
PRODUCTS_NODES, PRODUCTS_DEGREE = 2_449_029, 13.0
PRODUCTS_EPOCHS = 2


def build_products_dataset(path):
    """The products convergence dataset, built once on the host as
    ``tools/products_ds_cache.py`` does (community graph with shuffled ids,
    locality order, relabelled) and saved to ``path`` in the ``.npz`` format;
    prints each stage's host seconds."""
    from pygcn_tpu_torch.graph.datasets import community_classification, save_npz_dataset
    from pygcn_tpu_torch.parallel.partition import locality_order, reorder_dataset
    from pygcn_tpu_torch.utils import native

    bare = dict(build_dense=False, build_bcsr=False, build_ell=False, build_hybrid=False,
                build_colpanel=False)
    host_s = {}
    t0 = time.perf_counter()
    data = community_classification(n=PRODUCTS_NODES, avg_degree=PRODUCTS_DEGREE, n_classes=40,
                                    feat_dim=128, seed=0, **bare)
    host_s["community_classification"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    data = reorder_dataset(data, locality_order(data.graph, "auto"))
    host_s["locality_order"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    save_npz_dataset(path, data)
    host_s["save_npz_dataset"] = time.perf_counter() - t0
    out = {"nodes": data.graph.n_nodes, "edges": data.graph.n_edges,
           "graphkit": native.available(), "npz_bytes": os.path.getsize(path), "host_s": host_s}
    print("products dataset " + json.dumps(out), flush=True)
    return out


# Kernel-name fragments of each group of ``_step_split``, tried in order: the
# adds by index (``index_add_``, ``scatter_reduce_``, whose kernel is
# ``_scatter_gather_elementwise_kernel``, ``segment_reduce``), the gathers of
# ``index_select`` (``vectorized_gather_kernel``), the elementwise products,
# exponentials and masks, the reductions over a bucket's slots, and the GEMMs.
STEP_GROUPS = (("index_add", ("indexFunc", "index_add", "scatter", "segment")),
               ("gather", ("gather", "indexSelect", "index_select")),
               ("elementwise", ("elementwise", "Elementwise")),
               ("reduce", ("reduce_kernel", "Reduce")),
               ("gemm", ("gemm", "Gemm", "xmma", "cutlass", "cublas")))


def _step_split(torch, step):
    """One more training step under torch.profiler, the card's activity only
    (tracing the host's operators too cost a minute of post-processing at
    the GAT's tens of thousands of launches): its wall ms, the device's busy
    ms (kernels and copies) and the device ms by kernel group
    (:data:`STEP_GROUPS`, the rest "other"), with the top kernels by time."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, launches = Counter(), 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            by_name[e.name] += e.device_time_total / 1e3
            launches += 1
    busy_ms = sum(by_name.values())
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "device_launches": launches,
            "device_ms_by_group": _by_group(by_name),
            "top_kernels_ms": {k[:80]: v for k, v in by_name.most_common(8)}}


def _by_group(by_name):
    """Device ms by kernel name summed by :data:`STEP_GROUPS` (the rest "other")."""
    split = dict.fromkeys([g for g, _ in STEP_GROUPS] + ["other"], 0.0)
    for name, ms in by_name.items():
        group = next((g for g, frags in STEP_GROUPS if any(f in name for f in frags)), "other")
        split[group] += ms
    return split


def _dist_step_splits(torch, steps):
    """Three more steps of each of ``steps`` (name → step) in a single
    torch.profiler session, a round of one step each at a time, each step
    in a ``dist.<name>`` range that ends in a device sync; the last round is
    read, as :func:`_sampled_step_split` reads its last step (the first
    recorded step of a session has lost most of its kernels' records). Per
    step: its wall ms, and of the kernels launched inside its range
    (:func:`_launched_in`, the host's clock alone: the device's timeline can
    sit milliseconds off it) the device's busy ms, their count, ms by
    :data:`STEP_GROUPS` and the top kernels; beside them, the ms of kernels
    launched outside the last round's ranges. Fails if a launch in a read
    range left no device record."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile, record_function

    walls = {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=torch.profiler.schedule(wait=0, warmup=1, active=2, repeat=1)) as prof:
        for _ in range(3):
            for name, step in steps.items():
                with record_function(f"dist.{name}"):
                    t0 = time.perf_counter()
                    step()
                    torch.cuda.synchronize()
                    walls[name] = (time.perf_counter() - t0) * 1e3
            prof.step()
    rows = _raw_events(prof)
    splits, attributed = {}, 0.0
    for name in steps:
        lo, hi = max((r[3], r[4]) for r in rows if not r[1] and r[0] == f"dist.{name}")
        kernels, lost = _launched_in(rows, lo, hi)
        if lost:
            fail(f"step split {name}: {len(lost)} launches left no device record")
        by_name = Counter()
        for k, us in kernels:
            by_name[k] += us / 1e3
        attributed += sum(by_name.values())
        splits[name] = {"wall_ms": walls[name], "busy_ms": sum(by_name.values()),
                        "device_launches": len(kernels), "device_ms_by_group": _by_group(by_name),
                        "top_kernels_ms": {k[:80]: v for k, v in by_name.most_common(6)}}
    start = min(max(r[3] for r in rows if not r[1] and r[0] == f"dist.{n}") for n in steps)
    outside_ms = _launched_ms(rows, start) - attributed
    return splits, outside_ms


def run_products_path(torch, npz, model):
    """``train_fullgraph --clustered --npz`` at products scale for ``model``
    (GAT/GATv2 at 8 heads of 8), PRODUCTS_EPOCHS epochs: the column panels and
    no ELL or hybrid layout, GAT/GATv2 on the column-panel attention path, no
    tile kernel launched, E2 launched once a product of the GCN (its 3
    layers: 6 a step, 3 an evaluation) and never by the GAT's, a finite
    loss; ms/step, peak memory and one more step profiled; for the GCN, E2
    on its column panels (:func:`time_e2`)."""
    from pygcn_tpu_torch.apps import train_fullgraph
    from pygcn_tpu_torch.ops.cuda import colpanel_spmm as e2

    count = _reset_tile_launches()
    e2.launches = 0
    argv = ["--clustered", "--npz", npz, "--model", model, "--max_epochs",
            str(PRODUCTS_EPOCHS), "--memstats", "--device", "cuda"]
    if model != "gcn":
        argv += ["--hidden", "8"]
    t0 = time.perf_counter()
    r = train_fullgraph.main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = count()
    e2_launches = e2.launches
    g = r["graph"]
    if g.colpanel is None or g.ell is not None or g.hybrid is not None:
        fail(f"products {model}: layouts colpanel={g.colpanel is not None}, "
             f"ell={g.ell is not None}, hybrid={g.hybrid is not None}; expected the "
             "column panels alone")
    if model != "gcn" and not r["colpanel"]:
        fail(f"products {model} did not take the column-panel attention path")
    if launches:
        fail(f"products {model} launched {launches} tile kernels, expected none")
    e2_expected = 6 * r["steps"] + 3 * r["evals"] if model == "gcn" else 0
    if e2_launches != e2_expected:
        fail(f"products {model} launched E2 {e2_launches} times, expected {e2_expected}")
    if not math.isfinite(r["loss"]) or not math.isfinite(r["val"]):
        fail(f"products {model}: non-finite loss {r['loss']} or val {r['val']}")
    out = {"nodes": g.n_nodes, "edges": g.n_edges, "panels": len(g.colpanel.panels),
           "virtual_rows": g.colpanel.n_vrows, "steps": r["steps"], "evals": r["evals"],
           "ms_per_step": r["epoch_s"] * 1e3, "peak_mem_gib": r["peak_mem_bytes"] / 2**30,
           "loss": r["loss"], "val": r["val"], "run_wall_s": wall_s, "e2_launches": e2_launches,
           "profiled_step": _step_split(torch, r["step"])}
    # the profiler slows the host's launches: the busy share of an unprofiled step
    out["busy_share_of_step"] = out["profiled_step"]["busy_ms"] / out["ms_per_step"]
    if model == "gcn":
        out["e2_timing"] = time_e2(torch, g)
    print(f"products {model} " + json.dumps(out), flush=True)
    del r, g
    torch.cuda.empty_cache()
    return out


def _build_products_child(path):
    """A child process's job: :func:`build_products_dataset` into ``path``
    (host work alone, on one core), its numbers beside it as JSON."""
    out = build_products_dataset(path)
    with open(path + ".json", "w") as f:
        json.dump(out, f)


def start_products_build(workdir):
    """Start building the products dataset in a child process, beside the
    phases before ``products`` (its host set-up, about 180–280 s, then costs
    the smoke's wall nothing); the child is a daemon, stopped if the smoke
    exits first."""
    import multiprocessing

    npz = os.path.join(workdir, "products.npz")
    proc = multiprocessing.get_context("spawn").Process(target=_build_products_child,
                                                        args=(npz,), daemon=True)
    proc.start()
    return proc, npz


def run_products(torch, build):
    """The products cell: the dataset the child of
    :func:`start_products_build` built, then the GCN, GAT and GATv2."""
    proc, npz = build
    t0 = time.perf_counter()
    proc.join()
    if proc.exitcode != 0:
        fail(f"building the products dataset failed (child exit code {proc.exitcode})")
    with open(npz + ".json") as f:
        out = {"dataset": json.load(f)}
    out["dataset"]["waited_s"] = time.perf_counter() - t0
    for model in ("gcn", "gat", "gatv2"):
        t0 = time.perf_counter()
        out[model] = run_products_path(torch, npz, model)
        print(f"phase products_{model} wall: {time.perf_counter() - t0:.1f}s", flush=True)
    os.remove(npz)
    return out


# Neighbourhood-sampled training (apps/train_sampled): a small SBM graph for
# the reference checks, and BASELINE.json's Reddit configuration
# (PERF_NOTES.md:477-479; the CLI's --hidden 64 and --gat_heads 4) for the
# main path: 232,965 nodes, average degree 489 (about 114M directed edges),
# 602 features, 41 classes, fanouts 25 then 10, batches of 1024.
SAMPLED_SMALL = ["--n_nodes", "2000", "--fanouts", "5", "5", "--batch_size", "128"]
REDDIT = ["--n_nodes", "232965", "--avg_degree", "489", "--feat_dim", "602", "--n_classes",
          "41", "--fanouts", "25", "10", "--batch_size", "1024", "--prefetch", "2",
          "--epochs", "1", "--device", "cuda"]
SAMPLED_MODELS = {"gcn": [], "gat": ["--model", "gat"], "gatv2": ["--model", "gatv2"]}
# Adam divides each gradient entry by its own magnitude plus eps = 1e-8, so
# an entry whose gradient is near eps moves by up to lr on its rounding alone
# (GATv2's last-layer w_r has gradient entries down to 3e-13, where the
# receiver's term cancels in the softmax). The card's gradients are held to
# the CPU's before Adam; the updated parameters only where the CPU's gradient
# is at least GRAD_FLOOR, where Adam's first step scales a gradient's error
# by at most lr * eps / GRAD_FLOOR**2 = 100.
GRAD_FLOOR = 1e-6


def _sample_stream(adj, fanouts, seed_batches, threads=None):
    """Three batches' ``(blocks, input_nodes)`` from a fresh sampler;
    ``threads`` pins the native kernel's thread count."""
    from pygcn_tpu_torch.ops.sampling import NeighborSampler
    from pygcn_tpu_torch.utils import native

    real = native.sample_layer
    if threads is not None:
        native.sample_layer = lambda *a, **kw: real(*a, **{**kw, "threads": threads})
    try:
        sampler = NeighborSampler(adj, fanouts, seed=0)
        return [sampler.sample_np(seeds) for seeds in seed_batches]
    finally:
        native.sample_layer = real


def _stream_arrays(stream):
    return [a for blocks, nodes in stream for a in (nodes, *itertools.chain(*blocks))]


def sampled_reference(torch):
    """The sampler's bits and one sampled step, card against CPU, on a
    2000-node SBM graph with fanouts [5, 5] and batches of 128: the native
    sampler at 1 and 4 threads gives the NumPy fallback's blocks bit for bit;
    for gcn, gat (2 heads of 8) and gatv2, one Adam step of
    ``train_sampled.train_step`` on the card from the CPU's blocks and
    weights gives the CPU's loss, logits and gradients within 1e-4, and its
    updated parameters where the CPU's gradient is at least ``GRAD_FLOOR``."""
    from pygcn_tpu_torch.apps import train_sampled as tapp
    from pygcn_tpu_torch.ops.sampling import NeighborSampler
    from pygcn_tpu_torch.utils import native

    if not native.available():
        fail("sampled_reference: graphkit did not build, so the native sampler is not checked")
    args = tapp.parse_args(["--device", "cpu", *SAMPLED_SMALL])
    prep = tapp.prepare(args, torch.device("cpu"))
    seed_batches = [prep.data.idx_train[i * 128:(i + 1) * 128] for i in range(3)]
    real_load = native._load
    native._load = lambda: None
    try:
        fallback = _stream_arrays(_sample_stream(prep.adj, args.fanouts, seed_batches))
    finally:
        native._load = real_load
    for threads in (1, 4):
        got = _stream_arrays(_sample_stream(prep.adj, args.fanouts, seed_batches, threads))
        if not all(np.array_equal(a, b) for a, b in zip(got, fallback)):
            fail(f"sampled_reference: native blocks at {threads} threads differ from NumPy's")
    out = {"blocks_bitwise": True}
    count = _reset_tile_launches()
    for model, flags in SAMPLED_MODELS.items():
        margs = tapp.parse_args(["--device", "cpu", *SAMPLED_SMALL, *flags, "--gat_heads", "2",
                                 "--hidden", "8"])
        batch = NeighborSampler(prep.adj, args.fanouts, seed=0).sample(seed_batches[0])
        idx = torch.from_numpy(batch.input_nodes)
        y = torch.from_numpy(prep.labels[seed_batches[0]])
        runs = []
        for device in ("cpu", "cuda"):
            net = tapp.build_model(margs, prep.data.n_classes).to(device)
            opt = tapp.adam_l2(net.parameters(), margs.lr)  # the CLI's optimizer
            blocks = [b.to(device) for b in batch.blocks]
            x_in = prep.x_full.to(device).index_select(0, idx.to(device))
            with torch.no_grad():
                logits = net(blocks, x_in)
            loss = tapp.train_step(net, opt, blocks, x_in, y.to(device))
            params = list(net.parameters())
            runs.append(([loss, logits], [p.grad.cpu() for p in params],
                         [p.detach().cpu() for p in params]))
        (c_out, c_grads, c_params), (g_out, g_grads, g_params) = runs
        held = [g.abs() >= GRAD_FLOOR for g in c_grads]
        pairs = [*zip(g_out, c_out), *zip(g_grads, c_grads),
                 *((g[h], c[h]) for g, c, h in zip(g_params, c_params, held))]
        err = 0.0
        for g, c in pairs:
            if not torch.allclose(g.cpu(), c, rtol=RTOL, atol=ATOL):
                fail(f"sampled_reference {model}: the card's step differs from the CPU's")
            err = max(err, float((g.cpu() - c).abs().max()))
        below = [g[~h].abs() for g, h in zip(c_grads, held)]
        out[model] = {
            "loss": float(g_out[0]), "max_abs_err": err,
            "entries": sum(h.numel() for h in held),
            "entries_below_grad_floor": sum(int(b.numel()) for b in below),
            "largest_grad_below_floor": max((float(b.max()) for b in below if b.numel()),
                                            default=None),
            "smallest_held_grad": min((float(g[h].abs().min()) for g, h in zip(c_grads, held)
                                       if h.any()), default=None),
            "param_gap_below_floor": max((float((g - c)[~h].abs().max()) for g, c, h
                                          in zip(g_params, c_params, held) if (~h).any()),
                                         default=None)}
    if count():
        fail(f"sampled_reference launched {count()} tile kernels, expected none")
    print("sampled reference " + json.dumps(out), flush=True)
    return out


# Kernel-name fragments of the sampled step's groups, tried in order: Adam's
# foreach kernels, the host-to-device copies, then :data:`STEP_GROUPS`. The
# kernels launched inside the ``sampled.feature_gather`` range (the
# ``index_select`` of the feature rows, a ``_scatter_gather`` kernel that the
# names would put among the adds by index) form a group of their own.
SAMPLED_GROUPS = (("adam", ("multi_tensor_apply",)), ("copies", ("Memcpy", "memcpy")),
                  *STEP_GROUPS)


def _kernels_under(event):
    """``(name, ms)`` of every kernel launched inside a profiled CPU range."""
    for k in event.kernels:
        yield k.name, k.duration / 1e3
    for child in event.cpu_children:
        yield from _kernels_under(child)


def _cpu_under(event):
    """A profiled CPU range and every CPU range inside it."""
    yield event
    for child in event.cpu_children:
        yield from _cpu_under(child)


def _sampled_step_split(torch, step):
    """Sampled training steps under torch.profiler: the last step's device
    busy ms and its ms by group (the feature gather apart)."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    # a warm-up step, then two recorded ones, of which the last is read. Its
    # kernels are those launched inside its range (:func:`_launched_in`): the
    # device's timeline can sit some ms off the host's, so kernels taken by
    # their device times could fall outside the step. The backward's ops run
    # on autograd's own thread, outside the range's CPU children, and are
    # taken all the same. Checked: every launch of the last step left a
    # device record, and every kernel launched from the step's own thread is
    # among them.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=torch.profiler.schedule(wait=0, warmup=1, active=2, repeat=1)) as prof:
        for _ in range(3):
            step()
            torch.cuda.synchronize()
            prof.step()
    rows = _raw_events(prof)
    lo, hi = max((r[3], r[4]) for r in rows if not r[1] and r[0].startswith("ProfilerStep"))
    kernels, lost = _launched_in(rows, lo, hi)
    if lost:
        fail(f"sampled step split: {len(lost)} launches in the last step left no device "
             f"record: {dict(Counter(lost))}")
    by_name, count = Counter(), Counter()
    for name, us in kernels:
        by_name[name] += us / 1e3
        count[name] += 1
    last = max((e for e in prof.events() if e.device_type == DeviceType.CPU
                and e.name.startswith("ProfilerStep")), key=lambda e: e.time_range.start)
    missing = Counter(name for name, _ in _kernels_under(last)) - count
    if missing:
        fail(f"sampled step split: kernels launched from the last step's thread are missing "
             f"from its launches: {dict(missing)}")
    gather_kernels, gather_ms = Counter(), 0.0
    for e in _cpu_under(last):
        if e.name == "sampled.feature_gather":
            gather_ms += e.device_time_total / 1e3
            for name, ms in _kernels_under(e):
                gather_kernels[name] += ms
    if not gather_ms or abs(sum(gather_kernels.values()) - gather_ms) > 1e-3:
        fail(f"sampled step split: the feature gather's kernels sum to "
             f"{sum(gather_kernels.values()):.4f} ms, its range to {gather_ms:.4f} ms "
             "(none: the profiler recorded no feature gather)")
    split = dict.fromkeys([g for g, _ in SAMPLED_GROUPS] + ["other"], 0.0)
    for name, ms in (by_name - gather_kernels).items():
        group = next((g for g, frags in SAMPLED_GROUPS if any(f in name for f in frags)), "other")
        split[group] += ms
    split["feature_gather"] = gather_ms
    split["block_gathers"] = split.pop("gather")
    return {"busy_ms": sum(by_name.values()), "device_launches": sum(count.values()),
            "device_ms_by_group": split,
            "top_kernels_ms": {k[:80]: v for k, v in by_name.most_common(6)}}


def _raw_events(prof):
    """Every event of a profiler session from its raw (kineto) records:
    ``(name, on_device, correlation id, start µs, end µs)``. A kernel (or a
    copy, a fill) and the runtime call that launched it share their
    correlation id."""
    rows = []
    for k in prof.profiler.kineto_results.events():
        on_device = "CUDA" in str(k.device_type())
        if on_device and getattr(k, "is_user_annotation", lambda: False)():
            continue  # a range's mirror on the device's timeline, not a kernel
        start = k.start_ns() / 1e3 if hasattr(k, "start_ns") else float(k.start_us())
        dur = k.duration_ns() / 1e3 if hasattr(k, "duration_ns") else float(k.duration_us())
        rows.append((k.name(), on_device, k.correlation_id(), start, start + dur))
    return rows


def _launched_in(rows, lo, hi):
    """``(kernels, lost)`` of a CPU range ``[lo, hi]`` of :func:`_raw_events`'
    rows, taken by launch, on the host's clock alone: each device record,
    ``(name, µs)``, whose runtime call (a kernel launch, a copy or a fill)
    started in the range, and the kernel launches of the range that left no
    device record."""
    device = {}
    for r in rows:
        if r[1]:
            device.setdefault(r[2], []).append((r[0], r[4] - r[3]))
    launches = [(r[2], r[0]) for r in rows if not r[1] and lo <= r[3] <= hi
                and any(t in r[0] for t in ("Launch", "Memcpy", "Memset"))]
    kernels = [k for corr, _ in launches for k in device.get(corr, [])]
    lost = [name for corr, name in launches if "Launch" in name and corr not in device]
    return kernels, lost


def _launched_ms(rows, start):
    """Device ms of every record launched at or after ``start`` (µs)."""
    launched = {r[2] for r in rows if not r[1] and r[3] >= start}
    return sum(r[4] - r[3] for r in rows if r[1] and r[2] in launched) / 1e3


def _same_batches(a, b) -> bool:
    """Whether two runs drew the same batches, bit for bit."""
    def arrays(batch):
        yield batch.input_nodes
        for blk in batch.blocks:
            yield from (blk.cols.numpy(), blk.weights.numpy(), blk.self_idx.numpy())

    return len(a) == len(b) and all(np.array_equal(x, y) for p, q in zip(a, b)
                                    for x, y in zip(arrays(p), arrays(q)))


def _sampled_run(torch, tapp, model, record=None, extra=(), prepared=None):
    """``train_sampled.main`` at the Reddit shape for ``model`` (one epoch);
    with ``record``, a list, each batch drawn is appended to it (a reference
    only: the timed loop does no more work; the batches are compared after
    the run). Gates: finite losses and no tile kernel."""
    count = _reset_tile_launches()
    real_iter = tapp.iter_sampled_batches

    def recording(*a, **kw):
        for seeds, batch in real_iter(*a, **kw):
            record.append(batch)
            yield seeds, batch

    if record is not None:
        tapp.iter_sampled_batches = recording
    t0 = time.perf_counter()
    try:
        r = tapp.main([*REDDIT, *SAMPLED_MODELS[model], *extra], prepared=prepared)
    finally:
        tapp.iter_sampled_batches = real_iter
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    if count():
        fail(f"sampled_main_path {model} launched {count()} tile kernels, expected none")
    if not np.isfinite(r["losses"]).all() or not math.isfinite(r["acc"]):
        fail(f"sampled_main_path {model}: non-finite loss or accuracy")
    return r, wall_s


def _fixed_step(tapp, r, batch_size=1024):
    """One more training step of a finished run, on a fixed batch (the first
    of epoch 0's order, drawn from the run's sampler), for profiling."""
    prep = r["prepared"]
    seeds = next(tapp.epoch_seed_batches(prep.data.idx_train, batch_size, 0, 0))
    batch = r["sampler"].sample(seeds)
    return lambda: tapp.run_batch(r["model"], r["opt"], prep, seeds, batch)


def _host_sampling(tapp, prep, batch_size, reps=5):
    """Host ms of one batch sampled serially (a fresh sampler, the first
    ``reps`` batches of epoch 0's order)."""
    from pygcn_tpu_torch.ops.sampling import NeighborSampler

    sampler = NeighborSampler(prep.adj, [25, 10], seed=0)
    ms = []
    for seeds in itertools.islice(
            tapp.epoch_seed_batches(prep.data.idx_train, batch_size, 0, 0), reps):
        t0 = time.perf_counter()
        sampler.sample_np(seeds)
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def run_sampled_main_path(torch):
    """BASELINE.json's Reddit configuration through ``apps/train_sampled``:
    the GCN for one epoch with prefetch 2, again with ``--prefetch 0`` (the
    same blocks bit for bit, losses within 1e-5 relative), then GAT and
    GATv2 (4 heads of 64) for one epoch each on the same prepared data (the
    host set-up is paid once). Prints the host set-up by stage, ms/batch and
    its split, host sampling, layer sizes, bytes copied per batch, a
    profiled step's device split, the idle share of an unprofiled step, peak
    memory and test accuracy (``sampled {...}``). Returns the prepared
    data, which ``dp_sampled`` reuses."""
    from pygcn_tpu_torch.apps import train_sampled as tapp
    from pygcn_tpu_torch.graph import datasets
    from pygcn_tpu_torch.utils import native

    finalize_s = []
    real_finalize = datasets._finalize

    def timed_finalize(*a, **kw):
        t0 = time.perf_counter()
        out = real_finalize(*a, **kw)
        finalize_s.append(time.perf_counter() - t0)
        return out

    datasets._finalize = timed_finalize
    drawn = []
    try:
        gcn, gcn_wall = _sampled_run(torch, tapp, "gcn", drawn)
    finally:
        datasets._finalize = real_finalize
    prep = gcn["prepared"]
    s = prep.setup_s
    out = {"sampler": "graphkit" if native.available() else "numpy fallback",
           "nodes": prep.data.graph.n_nodes, "edges": prep.data.graph.n_edges,
           "train_nodes": len(prep.data.idx_train),
           "host_setup_s": {"sbm_generation": s["data"] - finalize_s[0],
                            "finalize": finalize_s[0], "sampler_csr": s["sampler_csr"],
                            "features_to_device": s["features_to_device"]}}
    print(f"sampled setup ({out['sampler']}): " + json.dumps(out), flush=True)
    drawn_serial = []
    serial, _ = _sampled_run(torch, tapp, "gcn", drawn_serial, ["--prefetch", "0"], prep)
    if not _same_batches(drawn, drawn_serial):
        fail("sampled_main_path: --prefetch 0 drew other blocks than --prefetch 2")
    del drawn, drawn_serial
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(gcn["losses"], serial["losses"]))
    if len(gcn["losses"]) != len(serial["losses"]) or loss_rel > 1e-5:
        fail(f"sampled_main_path: prefetch 0 and 2 losses differ by {loss_rel:.3g} relative")
    out["prefetch_off_vs_on"] = {"blocks_bitwise": True, "max_loss_rel_diff": loss_rel,
                                 "serial_ms_per_batch": serial["ms_per_batch"],
                                 "serial_wait_ms": serial["wait_ms"],
                                 "serial_step_ms": serial["step_ms"]}
    del serial
    host_ms = _host_sampling(tapp, prep, 1024)
    counts = np.asarray(gcn["node_counts"])  # per batch: input nodes, then each block's rows
    out["host_sampling_ms"] = host_ms
    out["layer_input_nodes"] = {"layer0": {"mean": float(counts[:, 0].mean()),
                                           "max": int(counts[:, 0].max())},
                                "layer1": {"mean": float(counts[:, 1].mean()),
                                           "max": int(counts[:, 1].max())}}
    runs = {"gcn": (gcn, gcn_wall)}
    for model in ("gat", "gatv2"):
        runs[model] = _sampled_run(torch, tapp, model, prepared=prep)
    for model, (r, wall_s) in runs.items():
        step = _fixed_step(tapp, r)
        split = _sampled_step_split(torch, step)
        # warm, unprofiled steps (each ends in its device sync)
        unprofiled = float(np.median([_event_ms(torch, step)[1] for _ in range(5)]))
        out[model] = {"batches": r["n_batches"], "ms_per_batch": r["ms_per_batch"],
                      "sampler_wait_ms": r["wait_ms"], "step_ms": r["step_ms"],
                      "h2d_bytes_per_batch": r["h2d_bytes"],
                      "peak_mem_gib": r["peak_mem_bytes"] / 2**30, "test_acc": r["acc"],
                      "first_loss": r["losses"][0], "last_loss": r["losses"][-1],
                      "run_wall_s": wall_s, "unprofiled_step_ms": unprofiled,
                      "profiled_step": split,
                      "idle_share_of_step": 1.0 - split["busy_ms"] / unprofiled}
        print(f"sampled {model} " + json.dumps(out[model]), flush=True)
    del runs, gcn
    torch.cuda.empty_cache()
    print("sampled " + json.dumps(out), flush=True)
    return prep


# ---------------------------------------------------------------------- #
# Data parallelism (queue A item 8b) at world size 1 over NCCL: the
# evaluator on a graph × data mesh and train_evaluator --data_parallel, the
# simulator's fan-out (gt_gen / train_rl --shards) and data-parallel sampled
# training. One card: every collective runs over one rank, with nothing to
# exchange; the paths reach no hand-written kernel, as in JAX.
# ---------------------------------------------------------------------- #

# the steps of each data-parallel evaluator check, and those timed by CUDA
# events (after EVAL_WARMUP untimed)
DP_EVAL_STEPS, DP_EVAL_TIMED = 3, 20
# dp_sim: policies and simulator seeds of its gt_gen runs, and its train_rl
# episode
DP_SIM_POLICIES, DP_SIM_SEEDS = 16, 2
DP_RL_ARGS = ["--episodes", "1", "--epoch_width", "16", "--num_seeds", "2"]


class _OneRankGroup:
    """A process group of this process alone over NCCL (``file://``
    rendezvous in a temporary directory), destroyed on exit."""

    def __init__(self, phase):
        self.phase = phase

    def __enter__(self):
        import torch
        import torch.distributed as dist

        from pygcn_tpu_torch.parallel.launcher import initialize_multihost

        self._dir = tempfile.TemporaryDirectory()
        info = initialize_multihost(f"file://{self._dir.name}/rendezvous", 1, 0, device="cuda")
        if not info.distributed or dist.get_backend() != "nccl":
            fail(f"{self.phase}: no NCCL group ({info})")
        # NCCL builds its communicator at the first collective: not inside a timed step
        dist.all_reduce(torch.zeros(1, device="cuda"))
        torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.destroy_process_group()
        self._dir.cleanup()
        if dist.is_initialized():
            fail(f"{self.phase} left a process group behind")


def _mesh_refusal(module, argv, flag="--shards"):
    """``python -m <module> <flag> 2 --device cuda <argv>`` on this one
    card, run after the phase's timed work: a non-zero exit with the mesh
    message, before anything started."""
    import torch

    proc = subprocess.run([sys.executable, "-m", module, flag, "2", "--device", "cuda",
                           *argv], cwd=HERE, capture_output=True, text=True, timeout=300)
    want = f"mesh needs 2 devices, have {torch.cuda.device_count()}"
    if proc.returncode == 0 or want not in proc.stderr:
        fail(f"{module} {flag} 2 --device cuda: rc {proc.returncode}, stderr tail "
             f"{proc.stderr[-400:]!r}; expected a non-zero exit with {want!r}")
    return {"rc": proc.returncode, "message": want}


def run_dp_evaluator(torch, ev, evaluator_path):
    """``dp_evaluator``: on ``evaluator_main_path``'s world and ground truth
    (SafeGraph width), ``DistGCNOverMLP`` on a 1×1 ``graph × data`` mesh at
    the trained evaluator's weights: its forward on a batch within 1e-4 of
    ``GCNOverMLP``'s dense forward, and DP_EVAL_STEPS
    ``make_dist_evaluator_step`` steps finite; then ``train_evaluator
    --data_parallel`` for 2 epochs (finite), and a ``--data_parallel`` step
    against the single-device step on the same batch from the same weights
    (loss and weights within 1e-6), timed by CUDA events and profiled in one
    session. No tile kernel. Returns its numbers."""
    import pickle

    from pygcn_tpu_torch.apps import train_evaluator as tev
    from pygcn_tpu_torch.parallel import DistGCNOverMLP, build_dist_plan, make_mesh
    from pygcn_tpu_torch.parallel.dist_evaluator import make_dist_evaluator_step
    from pygcn_tpu_torch.train.checkpoint import load_model_params
    from pygcn_tpu_torch.train.optim import adam_l2
    from pygcn_tpu_torch.utils.timing import cuda_ms

    world, res, feats, dim, y = (ev[k] for k in ("world", "res", "feats", "dim", "y"))
    graph = world.graph
    with open(evaluator_path, "rb") as f:
        handoff = pickle.load(f)
    single = tev.make_model(dim, feats.shape[2], EVAL_HIDDEN, 0, device="cuda")
    load_model_params(single, handoff["params"])
    idx = np.asarray(res.idx_train)[:EVAL_BATCH]
    bx, by = torch.from_numpy(feats[idx]).cuda(), torch.from_numpy(y[idx]).cuda()
    count = _reset_tile_launches()
    out = {"cbgs": graph.n_nodes, "edges": graph.n_edges, "batch": EVAL_BATCH}
    with _OneRankGroup("dp_evaluator"), tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        plan = build_dist_plan(graph, 1)
        out["plan_s"] = time.perf_counter() - t0
        cfg = {k: getattr(single, k) for k in (
            "gcn_nfeat", "gcn_nhid", "gcn_nclass", "dim_touched", "linear_nin", "linear_nhid1",
            "linear_nhid2", "linear_nout")}
        dm = DistGCNOverMLP(make_mesh([1, 1], ["graph", "data"]), plan, **cfg)
        dm.load_state_dict(single.state_dict())
        sx, sy = dm.shard_batch(feats[idx]), dm.shard_targets(y[idx])
        with torch.no_grad():
            got, want = dm(sx), single(bx, graph)
        out["forward_max_abs_err"] = err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=1e-4, atol=1e-4):
            fail(f"dp_evaluator: DistGCNOverMLP differs from GCNOverMLP by {err} (limit 1e-4)")
        step = make_dist_evaluator_step(dm, adam_l2(dm.parameters(), 0.01, 5e-4,
                                                    grad_clip_norm=0.1))
        out["dist_losses"] = [float(step(sx, sy)) for _ in range(DP_EVAL_STEPS)]
        if not all(math.isfinite(v) for v in out["dist_losses"]):
            fail(f"dp_evaluator: make_dist_evaluator_step losses {out['dist_losses']}")
        del dm, step, got, want
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, corr = tev.main(["--vac_result_path", ev["csv"], *EVAL_WORLD, "--out_dir", d,
                               "--epochs", "2", "--data_parallel"])
        out["cli_2_epochs_s"] = time.perf_counter() - t0
        out["cli_peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        if not (math.isfinite(loss) and -1 <= corr <= 1):
            fail(f"train_evaluator --data_parallel: test loss {loss}, Spearman {corr}")
        out.update(cli_test_loss=loss, cli_test_spearman=corr)

        mesh = make_mesh([1], ["data"])
        models = [tev.make_model(dim, feats.shape[2], EVAL_HIDDEN, 42, device="cuda")
                  for _ in range(2)]
        steps = [tev.make_train_step(m, adam_l2(m.parameters(), 0.01, 5e-4, grad_clip_norm=0.1),
                                     graph, mesh=dp) for m, dp in zip(models, (mesh, None))]
        dp_loss, one_loss = (float(s(bx, by)) for s in steps)
        diffs = [float((a - b).detach().abs().max())
                 for a, b in zip(*(m.parameters() for m in models))]
        out["dp_vs_single_step"] = {"loss_diff": abs(dp_loss - one_loss),
                                    "max_weight_diff": max(diffs)}
        if abs(dp_loss - one_loss) > 1e-6 or max(diffs) > 1e-6:
            fail(f"dp_evaluator: the --data_parallel step differs from the single-device step: "
                 f"loss {dp_loss} against {one_loss}, weights by {max(diffs)} (limit 1e-6)")
        # the two steps in turns: single, dp, dp, single
        one_step, dp_step = steps[1], steps[0]
        single_ms = [cuda_ms(lambda: one_step(bx, by), iters=DP_EVAL_TIMED, warmup=EVAL_WARMUP)]
        ms = [cuda_ms(lambda: dp_step(bx, by), iters=DP_EVAL_TIMED, warmup=EVAL_WARMUP)
              for _ in range(2)]
        single_ms.append(cuda_ms(lambda: one_step(bx, by), iters=DP_EVAL_TIMED,
                                 warmup=EVAL_WARMUP))
        busy, n_kernels, top = _kernel_time_split(
            torch, lambda: [dp_step(bx, by) for _ in range(EVAL_PROFILED)])
        out.update(ms_per_step=min(ms), ms_per_step_runs=ms,
                   single_device_ms_per_step=min(single_ms), single_device_ms_runs=single_ms,
                   device_busy_ms_per_step=busy / EVAL_PROFILED,
                   kernels_per_step=n_kernels / EVAL_PROFILED,
                   top_kernels_ms_per_step={k: v / EVAL_PROFILED for k, v in top.items()})
    out["tile_kernel_launches"] = count()
    if out["tile_kernel_launches"]:
        fail(f"dp_evaluator launched {out['tile_kernel_launches']} tile kernels, expected none")
    torch.cuda.empty_cache()
    print("dp_evaluator " + json.dumps(out), flush=True)
    return out


def run_dp_sim(torch):
    """``dp_sim``: at SafeGraph width (EVAL_WORLD), ``gt_gen --shards 1``
    (one NCCL rank) and the unsharded ``gt_gen`` on the same
    DP_SIM_POLICIES policies write the same CSV, byte for byte; one
    ``train_rl --shards 1`` episode and one unsharded give the same result
    and the same cached outcomes; ``gt_gen --shards 2 --device cuda`` is
    refused in a subprocess with the mesh message, after the timed runs. The
    two ``gt_gen`` runs are timed twice each, in turns. No tile kernel.
    Returns its numbers."""
    from pygcn_tpu_torch.apps import gt_gen, train_rl
    from pygcn_tpu_torch.train.checkpoint import load_plain_pickle

    flags = ["--num_samples", str(DP_SIM_POLICIES), "--num_seeds", str(DP_SIM_SEEDS),
             "--batch", "8", *EVAL_WORLD]
    count = _reset_tile_launches()
    out = {"policies": DP_SIM_POLICIES, "sim_seeds": DP_SIM_SEEDS}
    with tempfile.TemporaryDirectory() as d:
        rl = {k: os.path.join(d, f"rl_{k}") for k in ("plain", "sharded")}
        walls, texts = {"plain": [], "sharded": []}, {"plain": [], "sharded": []}

        def generate(kind):
            # a file of its own for each run: gt_gen appends to an existing CSV
            path = os.path.join(d, f"{kind}{len(walls[kind])}.csv")
            t0 = time.perf_counter()
            gt_gen.main([*flags, "--out", path, *(["--shards", "1"] if kind == "sharded" else [])])
            walls[kind].append(time.perf_counter() - t0)
            with open(path, "rb") as f:
                texts[kind].append(f.read())

        # the two runs timed in turns: plain, sharded, sharded, plain
        generate("plain")
        results = {"plain": train_rl.main(["--out_dir", rl["plain"], *DP_RL_ARGS, *EVAL_WORLD])}
        with _OneRankGroup("dp_sim"):
            generate("sharded")
            generate("sharded")
            results["sharded"] = train_rl.main(["--out_dir", rl["sharded"], *DP_RL_ARGS,
                                                *EVAL_WORLD, "--shards", "1"])
        generate("plain")
        out.update(gt_gen_s=walls["plain"], gt_gen_shards1_s=walls["sharded"])
        want = texts["plain"][0]
        if (any(t != want for t in texts["plain"] + texts["sharded"])
                or want.count(b"\n") != 2 + DP_SIM_POLICIES):
            fail("dp_sim: gt_gen --shards 1 wrote another CSV than the unsharded run")
        caches = {k: load_plain_pickle(os.path.join(p, "sim_cache_42.pkl")) for k, p in rl.items()}
        if caches["plain"] != caches["sharded"] or results["plain"] != results["sharded"]:
            fail(f"dp_sim: train_rl --shards 1 cached {len(caches['sharded'])} outcomes, "
                 f"result {results['sharded']}; unsharded {len(caches['plain'])}, "
                 f"{results['plain']}")
        out.update(csv_bytes=len(want), rl_cached_outcomes=len(caches["plain"]),
                   rl_result=list(results["plain"]))
    out["tile_kernel_launches"] = count()
    if out["tile_kernel_launches"]:
        fail(f"dp_sim launched {out['tile_kernel_launches']} tile kernels, expected none")
    out["shards2_refusal"] = _mesh_refusal("pygcn_tpu_torch.apps.gt_gen", ["--out", "x.csv"])
    print("dp_sim " + json.dumps(out), flush=True)
    return out


def run_dp_sampled(torch, prep):
    """``dp_sampled``: on ``sampled_main_path``'s prepared Reddit-shape data
    (not built again), an epoch of the GCN and of the GAT on one device,
    then through the data-parallel runner (``train_sampled.train`` on a
    one-rank ``data`` mesh over NCCL), replicated and ``--feature_sharded
    --align_seeds``: the blocks equal the single-device run's bit for bit
    (shard 0 of one draws the same counters), the losses within 1e-5 of it,
    the feature-sharded run moves no row and its losses are within 1e-6 of
    the replicated run's; no tile kernel; one more step of each run
    profiled in one session; ``--shards 2 --device cuda`` refused. Returns
    its numbers."""
    from pygcn_tpu_torch.apps import train_sampled as tapp
    from pygcn_tpu_torch.parallel import make_mesh

    out, steps, tile = {}, {}, 0
    real_iter = tapp.iter_sampled_batches
    for model in ("gcn", "gat"):
        single_drawn = []
        single, _ = _sampled_run(torch, tapp, model, single_drawn, prepared=prep)
        count = _reset_tile_launches()
        with _OneRankGroup("dp_sampled"):
            mesh = make_mesh([1], ["data"])
            runs = {}
            for mode in ("replicated", "feature_sharded"):
                args = tapp.parse_args([*REDDIT, *SAMPLED_MODELS[model]])
                args.feature_sharded = args.align_seeds = mode == "feature_sharded"
                drawn = []

                def recording(*a, **kw):
                    for seeds, batch in real_iter(*a, **kw):
                        drawn.append(batch)
                        yield seeds, batch

                tapp.iter_sampled_batches = recording
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                try:
                    r = tapp.train(args, prep, mesh)
                finally:
                    tapp.iter_sampled_batches = real_iter
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                if not _same_batches(single_drawn, drawn):
                    fail(f"dp_sampled {model} {mode}: other blocks than the single-device run")
                gap = max(abs(a - b) for a, b in zip(r["losses"], single["losses"]))
                if len(r["losses"]) != len(single["losses"]) or gap > 1e-5:
                    fail(f"dp_sampled {model} {mode}: losses differ from the single-device "
                         f"run's by {gap} (limit 1e-5)")
                seeds = next(tapp.epoch_seed_batches(prep.data.idx_train, 1024, 0, 0))
                batch = r["sample"](seeds)
                steps[f"{model}_{mode}"] = (lambda rs=r["run_step"], s=seeds, b=batch: rs(s, b))
                runs[mode] = r
                out[f"{model}_{mode}"] = {
                    "batches": r["n_batches"], "ms_per_batch": r["ms_per_batch"],
                    "sampler_wait_ms": r["wait_ms"], "step_ms": r["step_ms"],
                    "peak_mem_gib": r["peak_mem_bytes"] / 2**30, "test_acc": r["acc"],
                    "last_loss": r["losses"][-1], "max_loss_diff_vs_single_device": gap,
                    "fetch_rows_moved": r["fetch_rows_moved"], "run_wall_s": wall}
            moved = runs["feature_sharded"]["fetch_rows_moved"]
            gap = max(abs(a - b) for a, b in zip(runs["feature_sharded"]["losses"],
                                                 runs["replicated"]["losses"]))
            if moved or gap > 1e-6:
                fail(f"dp_sampled {model}: --feature_sharded moved {moved} rows and its losses "
                     f"differ from the replicated run's by {gap} (limits 0, 1e-6)")
            out[f"{model}_feature_sharded"]["max_loss_diff_vs_replicated"] = gap
            out[f"{model}_single_device"] = {"ms_per_batch": single["ms_per_batch"],
                                             "sampler_wait_ms": single["wait_ms"],
                                             "step_ms": single["step_ms"]}
            del runs, r
        tile += count()
    count = _reset_tile_launches()
    with _OneRankGroup("dp_sampled"):
        splits, out["kernel_ms_outside_the_profiled_steps"] = _dist_step_splits(torch, steps)
    for name, split in splits.items():
        out[name].update(profiled_step_busy_ms=split["busy_ms"],
                         profiled_step_wall_ms=split["wall_ms"],
                         profiled_step_launches=split["device_launches"])
    steps.clear()
    out["tile_kernel_launches"] = tile + count()
    if out["tile_kernel_launches"]:
        fail(f"dp_sampled launched {out['tile_kernel_launches']} tile kernels, expected none")
    try:
        tapp.main(["--shards", "2", "--device", "cuda", *REDDIT[:-2]])
        fail("train_sampled --shards 2 --device cuda ran on one card")
    except ValueError as e:
        if f"mesh needs 2 devices, have {torch.cuda.device_count()}" not in str(e):
            raise
        out["shards2_refusal"] = str(e)
    torch.cuda.empty_cache()
    print("dp_sampled " + json.dumps(out), flush=True)
    return out


# model_axes: the tensor-parallel GCN at the CLI's widths (3 layers, 128 ->
# 128 -> 40: col, row, full), the pipeline on the evaluator's dense graph
# (hidden 32, 4 stages on the one rank, a batch of EVAL_BATCH in
# microbatches of AXES_MICROBATCH), the MoE at the arxiv width (8 experts,
# 128 -> 512 -> 128) and its einsum form on AXES_DENSE_TOKENS tokens.
AXES_STAGES, AXES_MICROBATCH, AXES_PIPE_HIDDEN, AXES_PIPE_STEPS = 4, 4, 32, 3
AXES_EXPERTS, AXES_EXPERT_HIDDEN, AXES_DENSE_TOKENS = 8, 512, 4096


def _moe_plain(torch, moe, x):
    """The MoE by a plain loop over the experts: each expert's kept tokens
    (first come first in, at most ``capacity``) through its MLP, weighted
    by the router's probability."""
    probs = torch.softmax(x @ moe.gate, dim=1)
    p, expert = probs.max(dim=1)
    out = torch.zeros_like(x)
    cap = moe.capacity(x.shape[0])
    for e in range(moe.n_experts):
        idx = torch.nonzero(expert == e)[:cap, 0]
        h1 = torch.relu(x[idx] @ moe.w1[e] + moe.b1[e])
        out[idx] = (h1 @ moe.w2[e] + moe.b2[e]) * p[idx, None]
    return out


def _tp_axes(torch, arxiv, shard, dist_ms, out):
    """TPDistGCN on a 1×1 graph × model mesh on the arxiv data and the
    dist phase's plan shard: a warm-up step and EPOCHS steps, the forward
    against DistGCN's at the same weights, ms/step; returns the model, its
    optimizer, step and inputs."""
    import torch.nn.functional as F

    from pygcn_tpu_torch.parallel import make_mesh
    from pygcn_tpu_torch.parallel.dist_gcn import DistGCN, make_dist_classifier_step
    from pygcn_tpu_torch.parallel.tp_gcn import TPDistGCN
    from pygcn_tpu_torch.train.optim import adam_l2

    dims = [arxiv.x.shape[1], 128, 128, arxiv.data.n_classes]
    log_softmax = lambda h: F.log_softmax(h, dim=1)  # noqa: E731
    mesh = make_mesh([1, 1], ["graph", "model"])
    tp = TPDistGCN(mesh, shard, dims, final_activation=log_softmax,
                   generator=torch.Generator().manual_seed(0))
    opt = adam_l2(tp.parameters(), 0.01, 5e-4)
    step = make_dist_classifier_step(tp, opt)
    xs, labels, mask = (tp.shard_x(t) for t in (arxiv.x, arxiv.labels, arxiv.mask))
    losses = [float(step(xs, labels, mask))]  # warm-up
    t0 = time.perf_counter()
    for _ in range(EPOCHS):
        losses.append(float(step(xs, labels, mask)))
    host_ms = (time.perf_counter() - t0) * 1e3 / EPOCHS
    if not all(math.isfinite(v) for v in losses):
        fail(f"model_axes: TPDistGCN losses {losses}")
    event_ms = sorted(_event_ms(torch, lambda: step(xs, labels, mask))[1] for _ in range(3))
    gcn = DistGCN(make_mesh([1], ["graph"]), shard, dims, final_activation=log_softmax).cuda()
    gcn.load_state_dict(tp.state_dict())
    with torch.no_grad():
        got, want = tp(xs), gcn(gcn.shard_x(arxiv.x))
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-4):
        fail(f"model_axes: TPDistGCN differs from DistGCN at the same weights by {err} "
             f"(limit 1e-4)")
    out["tp"] = {"dims": dims, "modes": tp.modes, "losses": losses,
                 "ms_per_step": host_ms, "event_ms_per_step": event_ms,
                 "dist_gcn_ms_per_step": dist_ms, "forward_max_abs_err_vs_dist_gcn": err}
    del gcn, got, want
    return tp, opt, step, (xs, labels, mask), mesh


def _checkpoint_axes(torch, tp, opt, step, inputs, mesh, out):
    """The TP model's parameters and Adam state saved asynchronously (twice,
    each save timed to its return and its ``wait()``), then restored into a
    fresh model and optimizer, bit for bit."""
    from pygcn_tpu_torch.parallel.dist_gcn import make_dist_classifier_step
    from pygcn_tpu_torch.parallel.tp_gcn import TPDistGCN
    from pygcn_tpu_torch.train.checkpoint_dist import (DistCheckpointer, load_state_tree,
                                                       state_tree)
    from pygcn_tpu_torch.train.optim import adam_l2

    with tempfile.TemporaryDirectory() as d:
        ck = DistCheckpointer(mesh)
        live = state_tree(tp, opt, mesh, "model", tp.split_dims())
        saves = []
        for _ in range(2):  # the first save also starts DCP's machinery
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ck.save(os.path.join(d, "tp"), live)
            t1 = time.perf_counter()
            ck.wait()
            saves.append((t1 - t0, time.perf_counter() - t1))
        files = [os.path.join(d, "tp", f) for f in os.listdir(os.path.join(d, "tp"))]
        fresh = TPDistGCN(mesh, tp.shard, tp.dims, final_activation=tp.final_activation,
                          generator=torch.Generator().manual_seed(1))
        fresh_opt = adam_l2(fresh.parameters(), 0.01, 5e-4)
        t3 = time.perf_counter()
        load_state_tree(fresh, ck.restore(os.path.join(d, "tp"), like=live), fresh_opt)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        ck.close()
        differ = [k for (k, a), b in zip(tp.named_parameters(), fresh.parameters())
                  if not torch.equal(a, b)]
        differ += [f"{k}.{s}" for (k, a), b in zip(tp.named_parameters(), fresh.parameters())
                   for s in opt.state[a] if not torch.equal(opt.state[a][s], fresh_opt.state[b][s])]
        if differ:
            fail(f"model_axes: the restored TP model differs from the saved one in {differ}")
        loss = float(step(*inputs))
        fresh_loss = float(make_dist_classifier_step(fresh, fresh_opt)(*inputs))
        if loss != fresh_loss:
            fail(f"model_axes: the restored model's next loss {fresh_loss} != {loss}")
        out["checkpoint"] = {"save_return_s": [a for a, _ in saves],
                             "wait_s": [b for _, b in saves],
                             "restore_s": t4 - t3, "files": len(files),
                             "bytes_on_disk": sum(os.path.getsize(f) for f in files),
                             "next_loss": loss}


def _pipeline_axes(torch, ev, out):
    """PipelinedDeepGCN on the evaluator's dense co-visitation graph:
    forward and gradients against the unpipelined loop, a few Adam steps."""
    from pygcn_tpu_torch.parallel import make_mesh
    from pygcn_tpu_torch.parallel.pipeline import PipelinedDeepGCN
    from pygcn_tpu_torch.train.optim import adam_l2

    world, feats, dim, y = (ev[k] for k in ("world", "feats", "dim", "y"))
    idx = np.asarray(ev["res"].idx_train)[:EVAL_BATCH]
    x = torch.from_numpy(np.ascontiguousarray(feats[idx][:, :, :dim])).cuda()
    by = torch.from_numpy(y[idx]).cuda()
    model = PipelinedDeepGCN(make_mesh([1], ["pipe"]), world.graph.dense, dim, AXES_PIPE_HIDDEN,
                             1, n_stages=AXES_STAGES, generator=torch.Generator().manual_seed(0))

    def loss_of(pred):
        return torch.mean((pred.mean(dim=(1, 2)) - by) ** 2)

    results = []
    for fn in (lambda: model(x, AXES_MICROBATCH), lambda: model.forward_unpipelined(x)):
        model.zero_grad()
        pred = fn()
        loss_of(pred).backward()
        results.append((pred.detach(), [p.grad.clone() for p in model.parameters()]))
    (pipe, pipe_g), (loop, loop_g) = results
    err = float((pipe - loop).abs().max())
    grad_err = max(float((a - b).abs().max()) for a, b in zip(pipe_g, loop_g))
    if not torch.allclose(pipe, loop, rtol=1e-4, atol=1e-4) or not all(
            torch.allclose(a, b, rtol=1e-4, atol=1e-4) for a, b in zip(pipe_g, loop_g)):
        fail(f"model_axes: the pipeline differs from its loop: forward {err}, gradients "
             f"{grad_err} (limit 1e-4)")
    opt = adam_l2(model.parameters(), 0.01)

    def one_step():
        opt.zero_grad(set_to_none=True)
        loss = loss_of(model(x, AXES_MICROBATCH))
        loss.backward()
        opt.step()
        return loss.detach()

    losses = [float(one_step()) for _ in range(AXES_PIPE_STEPS)]
    if not all(math.isfinite(v) for v in losses):
        fail(f"model_axes: pipeline losses {losses}")
    event_ms = sorted(_event_ms(torch, one_step)[1] for _ in range(3))
    out["pipeline"] = {"nodes": int(x.shape[1]), "f_in": dim, "hidden": AXES_PIPE_HIDDEN,
                       "stages": AXES_STAGES, "batch": EVAL_BATCH,
                       "microbatch": AXES_MICROBATCH, "forward_max_abs_err_vs_loop": err,
                       "grad_max_abs_err_vs_loop": grad_err, "losses": losses,
                       "event_ms_per_step": event_ms}


def _moe_axes(torch, tp, inputs, n_nodes, out):
    """ExpertParallelMLP at the arxiv width on the TP model's first hidden
    activations: forward and backward, the index route against the plain
    loop, the einsum form on a slice against the index route; ms and peak
    memory."""
    from pygcn_tpu_torch.parallel import make_mesh
    from pygcn_tpu_torch.parallel.moe import ExpertParallelMLP, top1_route

    with torch.no_grad():
        first = tp.layers[0]
        h = torch.relu(tp.spmm(inputs[0] @ first.weight) + first.bias)[:n_nodes]
    moe = ExpertParallelMLP(make_mesh([1], ["expert"]), AXES_EXPERTS, h.shape[1],
                            AXES_EXPERT_HIDDEN, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got, want = moe(h), _moe_plain(torch, moe, h)
        dense_got = moe.forward_dense(h[:AXES_DENSE_TOKENS])
        dense_want = moe(h[:AXES_DENSE_TOKENS])
        kept = int(top1_route(h @ moe.gate, moe.capacity(h.shape[0]))[2].sum())
    err = float((got - want).abs().max())
    dense_err = float((dense_got - dense_want).abs().max())
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-4) or not torch.allclose(
            dense_got, dense_want, rtol=1e-4, atol=1e-4):
        fail(f"model_axes: MoE index route against the loop {err}, einsum form against the "
             f"index route {dense_err} (limit 1e-4)")
    del got, want, dense_got, dense_want
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()

    def fwd_bwd():
        moe.zero_grad(set_to_none=True)
        loss = torch.mean((h + moe(h)) ** 2)
        loss.backward()
        return loss.detach()

    loss = float(fwd_bwd())
    peak = torch.cuda.max_memory_allocated() - base
    if not math.isfinite(loss) or not all(
            float(p.grad.abs().sum()) > 0 for p in (moe.gate, moe.w1, moe.w2)):
        fail(f"model_axes: MoE loss {loss}, or no gradient reached the gate or the experts")
    ms = sorted(_event_ms(torch, fwd_bwd)[1] for _ in range(3))
    with torch.no_grad():
        fwd_ms = sorted(_event_ms(torch, lambda: moe(h))[1] for _ in range(3))
    out["moe"] = {"tokens": int(h.shape[0]), "h": int(h.shape[1]), "experts": AXES_EXPERTS,
                  "hidden": AXES_EXPERT_HIDDEN, "capacity": moe.capacity(h.shape[0]),
                  "kept_tokens": kept, "loss": loss,
                  "max_abs_err_vs_plain_loop": err,
                  "einsum_vs_index_max_abs_err": dense_err,
                  "einsum_tokens": AXES_DENSE_TOKENS, "fwd_bwd_ms": ms, "fwd_ms": fwd_ms,
                  "peak_mem_gib_over_inputs": peak / 2**30}


def run_model_axes(torch, arxiv, shard, dist_ms, ev):
    """``model_axes``: the model axes at world size 1 over NCCL, on data
    that earlier phases built (the arxiv ``prepared`` data and
    ``dist_main_path``'s plan shard; the evaluator's world and features):
    ``TPDistGCN`` [128, 128, 128, 40] for a warm-up step and EPOCHS steps
    through ``make_dist_classifier_step`` (finite, its forward within 1e-4
    of ``DistGCN`` at the same weights, ms/step beside DistGCN's), its
    parameters and Adam state saved by ``DistCheckpointer`` asynchronously
    and restored bit for bit; ``PipelinedDeepGCN`` on the evaluator's dense
    graph (forward and gradients within 1e-4 of its loop, Adam steps);
    ``ExpertParallelMLP`` on 169,343 tokens (against a plain loop, the
    einsum form on a slice; ms, peak); ``dryrun_multichip(1)``. Then the
    dry run's ``--ranks 2 --device cuda`` refused on this one card. No tile
    kernel. Prints an ``axes {...}`` line."""
    from pygcn_tpu_torch.parallel.dryrun import dryrun_multichip

    count = _reset_tile_launches()
    out = {"card": card_line(), "nodes": arxiv.graph.n_nodes}
    with _OneRankGroup("model_axes"):
        tp, opt, step, inputs, mesh = _tp_axes(torch, arxiv, shard, dist_ms, out)
        _checkpoint_axes(torch, tp, opt, step, inputs, mesh, out)
        _pipeline_axes(torch, ev, out)
        _moe_axes(torch, tp, inputs, arxiv.graph.n_nodes, out)
        del tp, opt, step, inputs
        t0 = time.perf_counter()
        out["dryrun_1"] = dryrun_multichip(1)
        out["dryrun_1_s"] = time.perf_counter() - t0
    out["tile_kernel_launches"] = count()
    if out["tile_kernel_launches"]:
        fail(f"model_axes launched {out['tile_kernel_launches']} tile kernels, expected none")
    torch.cuda.empty_cache()
    out["ranks2_refusal"] = _mesh_refusal("pygcn_tpu_torch.parallel.dryrun", [], flag="--ranks")
    print("axes " + json.dumps(out), flush=True)
    return out


# Epochs of each main path: enough for a step and an evaluation after the
# warm-up pair; the launch checks hold at any count. The runs at --hidden 128
# take one.
EPOCHS = 2
WIDE_EPOCHS = 1


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
    products_dir = tempfile.TemporaryDirectory()
    products_build = start_products_build(products_dir.name)
    phase("build", build_kernels)
    phase("check_b1", check_b1, torch)
    phase("check_e1", check_e1, torch)
    phase("check_gat_tiles", check_gat_tiles, torch, False)
    phase("check_gatv2_tiles", check_gat_tiles, torch, True)
    phase("check_stream_kernels", check_stream_kernels, torch)
    phase("check_many_heads", check_many_heads, torch)
    phase("small_gcn_reference", check_small_reference, torch)
    phase("small_gat_reference", check_small_gat_reference, torch, False)
    phase("small_gatv2_reference", check_small_gat_reference, torch, True)
    phase("check_tile_shapes", check_tile_shapes, torch)
    phase("cora", run_cora, torch)
    phase("gat_dropout", run_gat_dropout, torch)
    graph, launches, gcn_result = phase("gcn_main_path", run_main_path, torch, EPOCHS)
    gcn_e1_launches = gcn_result["e1_launches"]
    dist_out, arxiv_shard = phase("dist_main_path", run_dist_main_path, torch, gcn_result)
    arxiv = gcn_result["prepared"]  # for model_axes, beside dp_evaluator
    del gcn_result
    timing = phase("time_b1_b2", time_b1, torch, graph)
    e1_timing = phase("time_e1", time_e1, torch, graph)
    colpanel_b1 = phase("colpanel_arxiv", check_colpanel_arxiv, torch, graph)
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
    # the CLI's default width, 8 heads of 128, one epoch each
    phase("gat_main_path_hidden128", run_gat_main_path, torch, False, WIDE_EPOCHS, 128)
    phase("gatv2_main_path_hidden128", run_gat_main_path, torch, True, WIDE_EPOCHS, 128)
    stream_launches = phase("stream_main_paths", run_stream_main_paths, torch, EPOCHS)
    phase("extension_main_paths", run_extension_main_paths, torch, EPOCHS)
    phase("ab_kernel_stream", run_ab_tool)
    phase("check_draws", check_draws, torch)
    phase("sim_reference", sim_reference, torch)
    sim_world = phase("sim_main_path", sim_main_path, torch)
    phase("policy_batch", policy_batch, torch, *sim_world)
    del sim_world
    phase("sim_clis", run_sim_clis, torch)
    dp = {"card": card, "sim": phase("dp_sim", run_dp_sim, torch)}
    with tempfile.TemporaryDirectory() as kept:
        eval_b1, ev = phase("evaluator_main_path", run_evaluator_main_path, torch, kept)
        evaluator = os.path.join(kept, "evaluator.pkl")
        dp["evaluator"] = phase("dp_evaluator", run_dp_evaluator, torch, ev, evaluator)
        phase("model_axes", run_model_axes, torch, arxiv, arxiv_shard,
              dist_out["gcn"]["ms_per_step"], ev)
        del ev, arxiv, arxiv_shard
        gen_b1, gen_out, world = phase("generator_main_path", run_generator_main_path, torch,
                                       evaluator)
        rl_out = phase("rl_main_path", run_rl_main_path, torch)
        phase("serve_main_path", run_serve_main_path, torch, evaluator, world)
        del world
    print("policy " + json.dumps({"generator": gen_out, "rl": rl_out}), flush=True)
    products = phase("products", run_products, torch, products_build)
    products_dir.cleanup()
    print("products " + json.dumps(products), flush=True)
    phase("sampled_reference", sampled_reference, torch)
    prep = phase("sampled_main_path", run_sampled_main_path, torch)
    dp["sampled"] = phase("dp_sampled", run_dp_sampled, torch, prep)
    del prep
    print("dp " + json.dumps(dp), flush=True)
    kernels = {"kernels": [
        spmm_kernel_entry(timing, "B1", launches, 50),
        spmm_kernel_entry(timing, "B2", stream_launches["B2"], 64),
        e1_kernel_entry(e1_timing, gcn_e1_launches),
        e2_kernel_entry(products["gcn"]["e2_timing"], products["gcn"]["e2_launches"]),
        spmm_kernel_entry([eval_b1], "B1", eval_b1["launches"], 50,
                          f" (evaluator, H={eval_b1['H']})"),
        spmm_kernel_entry([gen_b1], "B1", gen_b1["launches"], 50,
                          f" (generator, H={gen_b1['H']})"),
        spmm_kernel_entry([colpanel_b1], "B1", colpanel_b1["launches"], 50,
                          " (hybrid, column-panel residual, H=128)"),
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
