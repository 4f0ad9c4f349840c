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
  kernel B2;
- ``--model gat --hidden 8`` (2-layer GAT, 8 heads of 8 then 1 head of 40):
  kernels B3/B5/B6, and with ``TILE_REVISIT = False`` B4/B5s/B6s;
- ``--model gatv2 --hidden 8``: kernels B7/B8/B9;
- ``--model gat`` and ``--model gatv2`` at the CLI's default ``--hidden 128``
  (8 heads of 128): the same kernels on wide heads, for one epoch;
- ``--model sage``, ``gin`` and ``appnp`` (128 -> 128 -> 40): kernel B1.

It checks that each path launched its kernels exactly as often as it must
and no other tile kernel, runs ``apps/ab_kernel_stream`` (revisit against
stream on the flagship graph) once, and times each kernel at its path's
shapes beside its bound. Then the epidemic simulator, which reaches no
hand-written kernel: the card's samplers against the exact pmfs, a small
world on the card against the CPU, the simulator at SafeGraph width (2943
CBGs, 50,000 POIs, 600K visits an hour, 1512 hours, 40 seeds; two runs of
one seed and the paged run give the same bits, a day runs with no host
sync; it prints ms/hour, seed-hours/s, peak memory and the profiled split
on a ``sim {...}`` line), 8 policies in one batch against their runs
alone, and ``apps/gt_gen`` and ``apps/no_vac_baseline`` on the card. It
prints each phase's wall time. Its last line is
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
    phase("build", build_kernels)
    phase("check_b1", check_b1, torch)
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
