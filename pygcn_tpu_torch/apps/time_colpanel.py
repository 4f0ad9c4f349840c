"""Kernel E2 timed on the column panels of the benchmark's clustered graph.

Two graphs, each laid out as column panels (``build_col_panel_ell`` on the
port's bucket ladder):

- ``arxiv``: the ``clustered`` graph at ogbn-arxiv size, built as
  ``apps/time_ell.benchmark_graph`` builds it (169,343 nodes, degree 13.3,
  communities of 256, graph seed 0, symmetric, normalised, locality
  ordered), in sender panels of 16,384 (11 panels: the benchmark takes
  column panels only above a million nodes, in panels of 65,536);
- ``products``: the benchmark's saved ogbn-products-sized operator
  (``.bench_cache/datasets/*/operator.npz``, which a first run of the
  ``gcn_products-clustered`` cell writes; ``--npz`` names another) in panels
  of 65,536, as the benchmark runs it; skipped where no such file exists.

At H = 256 and 47 (the GCN's hidden and output widths) it times with CUDA
events (each twice in turns, the faster kept):

- ``e2_ms``: kernel E2 (``colpanel_spmm_cuda``);
- ``plain_ms``: the plain chain (``col_panel_spmm_plain``) E2 replaced;
- ``library_ms``: ``torch.sparse.mm`` on the same edges as a CSR tensor, the
  yardstick only;

beside E2's bound (:func:`e2_bound`), the peak memory above the inputs of
one E2 and one plain call, and E2's largest gap from the plain version. It
prints one JSON line per graph and width::

    PYTHONPATH=. python3 pygcn_tpu_torch/apps/time_colpanel.py
"""

from __future__ import annotations

import argparse
import glob
import json
import subprocess
import time

import numpy as np
import scipy.sparse as sp
import torch

from pygcn_tpu_torch.apps.time_spmm import HBM_BYTES_PER_S, _peak_above

WIDTHS = (256, 47)
ARXIV_PANEL_WIDTH = 16_384
PRODUCTS_PANEL_WIDTH = 65_536
# mean of so many calls a timing (the plain chain at products size takes
# about a quarter of a second a call)
ITERS = {"arxiv": (50, 10), "products": (10, 2)}


def arxiv_matrix() -> sp.csr_matrix:
    """The arxiv-sized clustered graph's operator, ordered as the benchmark
    orders it."""
    from pygcn_tpu_torch.apps.time_ell import benchmark_graph

    return benchmark_graph("clustered").to_scipy().tocsr()


def products_matrix(path: str) -> sp.csr_matrix:
    """The operator saved in ``path`` (``save_npz_dataset``'s format: row 0
    of ``edge_index`` the receivers)."""
    with np.load(path) as z:
        (row, col), w = z["edge_index"], z["edge_weight"]
        n = int(z["labels"].shape[0])
    return sp.csr_matrix((w, (row, col)), shape=(n, n))


def layout_csr(a: sp.csr_matrix, device) -> torch.Tensor:
    """The operator as a CSR tensor on ``device``."""
    return torch.sparse_csr_tensor(torch.from_numpy(a.indptr.astype(np.int64)),
                                   torch.from_numpy(a.indices.astype(np.int64)),
                                   torch.from_numpy(a.data.astype(np.float32)), a.shape,
                                   device=device)


def e2_bound(sched, n_rows: int, slots: int, h: int) -> dict:
    """E2's least bytes at width ``h``: x and y once each, 8 bytes a valid
    slot (its column and value) and the schedule; and the bytes of a gather
    that reads each slot's operand row from device memory; with their ms at
    3.35 TB/s."""
    schedule = sched.refs.nbytes + sched.row_ptr.nbytes + sched.parts.nbytes
    least = (sched.n_cols + n_rows) * h * 4 + slots * 8 + schedule
    gathered = slots * h * 4 + n_rows * h * 4 + slots * 8 + schedule
    return {"slots": slots, "schedule_bytes": schedule, "bound_bytes": least,
            "bound_ms": least / HBM_BYTES_PER_S * 1e3, "gather_bytes": gathered,
            "gather_ms": gathered / HBM_BYTES_PER_S * 1e3}


def time_graph(name: str, a: sp.csr_matrix, panel_width: int, card: str) -> list:
    from pygcn_tpu_torch.ops.colpanel import build_col_panel_ell, col_panel_spmm_plain
    from pygcn_tpu_torch.ops.cuda import colpanel_spmm as e2
    from pygcn_tpu_torch.utils.timing import cuda_ms

    t0 = time.perf_counter()
    pe = build_col_panel_ell(a, panel_width).to("cuda")
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sched = e2._device_schedule(pe, pe.panels[0].cols[0].device)[0]
    torch.cuda.synchronize()
    schedule_s = time.perf_counter() - t0
    csr = layout_csr(a, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    fast_iters, plain_iters = ITERS[name]
    rows = []
    for h in WIDTHS:
        x = torch.randn((a.shape[1], h), device="cuda", generator=gen)
        got, again = e2.colpanel_spmm_cuda(pe, x), e2.colpanel_spmm_cuda(pe, x)
        ref = col_panel_spmm_plain(pe, x)
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
        row = {"graph": name, "card": card, "H": h, "nodes": a.shape[0], "edges": a.nnz,
               "panels": len(pe.panels), "virtual_rows": pe.n_vrows,
               "parts": sched.n_parts, "layout_build_s": build_s, "schedule_s": schedule_s,
               "same_bits": bool(torch.equal(got, again)),
               "max_abs_err": float((got - ref).abs().max()),
               **e2_bound(sched, a.shape[0], a.nnz, h)}
        del got, again, ref
        timed = {"e2_ms": (lambda: e2.colpanel_spmm_cuda(pe, x), fast_iters),
                 "plain_ms": (lambda: col_panel_spmm_plain(pe, x), plain_iters),
                 "library_ms": (lambda: torch.sparse.mm(csr, x), fast_iters)}
        for _ in range(2):
            for key, (fn, iters) in timed.items():
                row.setdefault(key + "_runs", []).append(cuda_ms(fn, iters=iters, warmup=1))
        for key in timed:
            row[key] = min(row[key + "_runs"])
        row["bound_share"] = row["bound_ms"] / row["e2_ms"]
        row["e2_peak_bytes"] = _peak_above(timed["e2_ms"][0])
        row["plain_peak_bytes"] = _peak_above(timed["plain_ms"][0])
        print(json.dumps(row), flush=True)
        rows.append(row)
    del pe, csr
    torch.cuda.empty_cache()
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--graphs", default="arxiv,products")
    ap.add_argument("--npz", default=None, help="the products operator (default: the "
                    "benchmark's .bench_cache/datasets/*/operator.npz)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("time_colpanel times the CUDA device; none is available")

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    rows = []
    for name in args.graphs.split(","):
        if name == "arxiv":
            rows += time_graph(name, arxiv_matrix(), ARXIV_PANEL_WIDTH, card)
            continue
        found = ([args.npz] if args.npz
                 else sorted(glob.glob(".bench_cache/datasets/*/operator.npz")))
        if not found:
            print(json.dumps({"graph": name, "skipped": "no saved operator"}), flush=True)
            continue
        rows += time_graph(name, products_matrix(found[0]), PRODUCTS_PANEL_WIDTH, card)
    return rows


if __name__ == "__main__":
    main()
