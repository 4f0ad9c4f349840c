#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pygcn_tpu_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``pygcn_tpu_torch/csrc``, holds
each against its plain PyTorch version on the card, drives the port's main
path (``apps/train_fullgraph --clustered`` at the ogbn-arxiv sizes: 169,343
nodes, average degree 13.3, 3 layers, widths 128/128/40) for a few epochs,
checks that the path launched the kernels, and times each kernel at the
main path's shapes. Its last line is ``{"ok": true, "device": {...}}``; any
failure exits non-zero before it. Without a CUDA card, or outside a checkout,
it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and f32
# FLOP/s outside the tensor cores, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# Tolerances of kernel B1 against its plain version on the card. Both sum
# the same f32 products (bf16 tiles: x rounded to bf16 in both, products
# exact in f32) in another order; with unit-normal inputs and sums of up to a
# few thousand terms the reordering error stays below 1e-4 relative.
RTOL = ATOL = 1e-4


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


def _random_bcsr(torch, rng, n_rows, n_cols, density, empty_block_row, drop_padding,
                 dtype):
    """A BCSR with ragged edges and one block row without entries."""
    import dataclasses

    import numpy as np
    import scipy.sparse as sp

    from pygcn_tpu_torch.graph.graph import _build_bcsr

    m = sp.random(n_rows, n_cols, density=density, random_state=rng,
                  data_rvs=rng.standard_normal, format="coo", dtype=np.float32)
    keep = m.row // 128 != empty_block_row
    m = sp.coo_matrix((m.data[keep], (m.row[keep], m.col[keep])), shape=m.shape)
    b = _build_bcsr(m, (128, 128))
    if drop_padding:
        # the builder gives the empty block row an all-zero tile; the kernel
        # must not need it, so this variant has none
        keep_t = (b.block_rows != empty_block_row).numpy()
        ptr = np.zeros(b.n_block_rows + 1, np.int32)
        np.add.at(ptr, b.block_rows.numpy()[keep_t] + 1, 1)
        b = dataclasses.replace(
            b, data=b.data[keep_t], block_rows=b.block_rows[keep_t],
            block_cols=b.block_cols[keep_t],
            block_row_ptr=torch.from_numpy(np.cumsum(ptr).astype(np.int32)))
    return dataclasses.replace(b, data=b.data.to(dtype))


def check_b1(torch):
    """Kernel B1 against its plain version on the card: values and gradient."""
    import numpy as np

    from pygcn_tpu_torch.graph.graph import Graph
    from pygcn_tpu_torch.ops.cuda import bcsr_spmm as b1

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    worst = 0.0
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for drop_padding in (False, True):
            b = _random_bcsr(torch, rng, 300, 270, 0.05, 1, drop_padding, dtype).to(dev)
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
          f"BCSRSpMM value and gradient on an asymmetric graph) within rtol=atol={RTOL}; "
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


def run_main_path(torch):
    from pygcn_tpu_torch.apps import train_fullgraph
    from pygcn_tpu_torch.ops.cuda import bcsr_spmm as b1
    from pygcn_tpu_torch.utils import native

    print(f"graphkit native library: {'loaded' if native.available() else 'missing (NumPy/BFS fallbacks)'}",
          flush=True)
    b1.launches = 0
    result = train_fullgraph.main(["--clustered", "--max_epochs", "3", "--memstats",
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
    if launches != expected or launches == 0:
        fail(f"B1 launched {launches} times on the main path, expected {expected}")
    if not math.isfinite(result["loss"]) or not math.isfinite(result["val"]):
        fail(f"non-finite loss {result['loss']} or val {result['val']}")
    return graph, launches


def _tile_csr(torch, bcsr, n_rows, n_cols):
    """The tile matrix as a torch CSR tensor on the card (the library yardstick)."""
    t, r, c = torch.nonzero(bcsr.data, as_tuple=True)
    rows = bcsr.block_rows.long()[t] * bcsr.tm + r
    cols = bcsr.block_cols.long()[t] * bcsr.tk + c
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), bcsr.data[t, r, c].float(),
                                  (n_rows, n_cols)).coalesce()
    return coo.to_sparse_csr()


def time_b1(torch, graph):
    """B1 at the main path's shapes: kernel, plain, bound and library times."""
    from pygcn_tpu_torch.ops.cuda import bcsr_spmm as b1
    from pygcn_tpu_torch.utils.timing import cuda_ms

    bcsr = graph.hybrid.bcsr
    n = graph.n_nodes
    csr = _tile_csr(torch, bcsr, n, n)
    gen = torch.Generator(device="cuda").manual_seed(0)
    n_x_rows = min(n, int(torch.unique(bcsr.block_cols).numel()) * bcsr.tk)
    # the multiplies the function needs: one per stored nonzero and column
    nnz = int(torch.count_nonzero(bcsr.data))
    rows = []
    saved = b1.launches
    for h in (128, 40):
        x = torch.randn((n, h), device="cuda", generator=gen)
        got = b1.bcsr_spmm(bcsr, x, n_rows=n)
        ref = b1.bcsr_spmm_plain(bcsr, x, n_rows=n)
        lib = torch.sparse.mm(csr, x)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(lib, ref, rtol=RTOL, atol=ATOL)
        err = float((got - ref).abs().max())
        ms = cuda_ms(lambda: b1.bcsr_spmm(bcsr, x, n_rows=n), iters=50)
        plain_ms = cuda_ms(lambda: b1.bcsr_spmm_plain(bcsr, x, n_rows=n), iters=20)
        library_ms = cuda_ms(lambda: torch.sparse.mm(csr, x), iters=50)
        ms2 = cuda_ms(lambda: b1.bcsr_spmm(bcsr, x, n_rows=n), iters=50)
        t = bcsr.data.shape[0]
        nbytes = (t * bcsr.tm * bcsr.tk * bcsr.data.element_size()  # tiles, as stored
                  + n_x_rows * h * 4  # x rows under some tile, read once
                  + n * h * 4)  # output
        flops = 2 * nnz * h
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
        row = {"H": h, "tiles": t, "tile_nnz": nnz, "ms": min(ms, ms2), "ms_runs": [ms, ms2],
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "bytes": nbytes, "flops": flops, "max_abs_err": err}
        print("B1 timing: " + json.dumps(row), flush=True)
        rows.append(row)
    b1.launches = saved
    return rows


def main() -> None:
    torch = setup()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}", flush=True)
    card = card_line()
    print(card, flush=True)
    build_kernels()
    check_b1(torch)
    check_small_reference(torch)
    t0 = time.time()
    graph, launches = run_main_path(torch)
    print(f"main path wall: {time.time() - t0:.1f}s", flush=True)
    timing = time_b1(torch, graph)
    h128 = timing[0]
    kernels = {"kernels": [{
        "name": "B1 bcsr_spmm",
        "route": "cuda",
        "source": "pygcn_tpu_torch/csrc/bcsr_spmm.cu",
        "replaces": "pygcn_tpu/ops/pallas/bcsr_spmm.py:50",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in timing),
        "ms": h128["ms"],
        "plain_ms": h128["plain_ms"],
        "bound_ms": h128["bound_ms"],
        "bound_by": h128["bound_by"],
        "library_ms": h128["library_ms"],
    }]}
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
