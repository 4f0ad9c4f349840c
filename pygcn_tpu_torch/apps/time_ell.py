"""Kernel E1 timed on the ELL residual of the benchmark's two GCN graphs.

Builds each graph as the full-graph benchmark does (169,343 nodes, degree
13.3, graph seed 0): the ``clustered`` graph (``community_graph``:
communities of 256, ``p_in`` 0.7, power 2.2, ids shuffled) and the
``powerlaw`` one (``chung_lu_graph``, power 2.2), each made symmetric
(``symmetrize_max``), normalised (``sym_normalize``), locality ordered and
laid out as the hybrid at ``hybrid_min_edges_per_tile=64``. On the hybrid's
ELL residual, at H = 256 and 40 (the GCN's hidden and output widths), it
times with CUDA events (mean of 50 calls after warm-up, each twice in turns):

- ``e1_ms``: kernel E1 (``ell_spmm_cuda``);
- ``plain_ms``: the plain version (``ell_spmm_plain``), the chain E1 replaced;
- ``library_ms``: ``torch.sparse.mm`` on the residual as a CSR tensor;

beside the bound (:func:`e1_bound`), the peak memory above the inputs of
one E1 and one plain call, and E1's largest gap from the plain version. It
prints one JSON line per graph and width::

    PYTHONPATH=. python3 pygcn_tpu_torch/apps/time_ell.py
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from pygcn_tpu_torch.apps.time_spmm import HBM_BYTES_PER_S, _peak_above

WIDTHS = (256, 40)
ITERS = 50
N_NODES, DEGREE = 169_343, 13.3


def benchmark_graph(name: str):
    """The ``clustered`` or ``powerlaw`` graph, ordered and laid out as the
    full-graph benchmark builds it (on the host)."""
    from pygcn_tpu_torch.graph.datasets import chung_lu_graph, community_graph
    from pygcn_tpu_torch.graph.graph import Graph
    from pygcn_tpu_torch.graph.transform import sym_normalize, symmetrize_max
    from pygcn_tpu_torch.parallel.partition import locality_order, reorder_graph

    raw = (community_graph(N_NODES, DEGREE, seed=0) if name == "clustered"
           else chung_lu_graph(N_NODES, DEGREE, seed=0))
    a = sym_normalize(symmetrize_max(raw))
    bare = Graph.from_scipy(a, is_symmetric=True, build_dense=False, build_bcsr=False,
                            build_ell=False, build_hybrid=False, build_colpanel=False)
    ordered, _ = reorder_graph(bare, locality_order(bare, "auto"))
    return Graph.from_scipy(ordered.to_scipy(), is_symmetric=True, build_dense=False,
                            build_bcsr=False, hybrid_min_edges_per_tile=64)


def residual_csr(ell) -> torch.Tensor:
    """The layout's edges as a CSR tensor on its device."""
    rows, cols, vals = [], [], []
    for c, v, r, n in zip(ell.cols, ell.vals, ell.rows, ell.lens):
        valid = torch.arange(c.shape[1], device=c.device) < n[:, None]
        rows.append(r[:, None].expand_as(c)[valid].long())
        cols.append(c[valid].long())
        vals.append(v[valid])
    coo = torch.sparse_coo_tensor(torch.stack([torch.cat(rows), torch.cat(cols)]),
                                  torch.cat(vals), (ell.n_rows, ell.n_rows))
    return coo.coalesce().to_sparse_csr()


def e1_bound(ell, sched, h: int) -> dict:
    """E1's least bytes at width ``h`` (x and y once each, 8 bytes a valid
    slot, its work items) and the bytes of a gather that reads each valid
    slot's operand row from device memory, with their ms at 3.35 TB/s."""
    slots = int(sched.items[:, 2].sum())
    items = sched.items.numel() * 4
    least = (sched.n_cols + ell.n_rows) * h * 4 + slots * 8 + items
    gathered = slots * h * 4 + ell.n_rows * h * 4 + slots * 8 + items
    return {"slots": slots, "bound_bytes": least, "bound_ms": least / HBM_BYTES_PER_S * 1e3,
            "gather_bytes": gathered, "gather_ms": gathered / HBM_BYTES_PER_S * 1e3}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--graphs", default="powerlaw,clustered")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("time_ell times the CUDA device; none is available")

    from pygcn_tpu_torch.ops.cuda import ell_spmm as e1
    from pygcn_tpu_torch.ops.ell import ell_spmm_plain
    from pygcn_tpu_torch.utils.timing import cuda_ms

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    rows = []
    for name in args.graphs.split(","):
        graph = benchmark_graph(name)
        ell = graph.hybrid.ell.to("cuda")
        csr = residual_csr(ell)
        sched = e1._device_schedule(ell)[0]
        gen = torch.Generator(device="cuda").manual_seed(0)
        for h in WIDTHS:
            x = torch.randn((graph.n_nodes, h), device="cuda", generator=gen)
            got, again = e1.ell_spmm_cuda(ell, x), e1.ell_spmm_cuda(ell, x)
            ref = ell_spmm_plain(ell, x)
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
            row = {"graph": name, "card": card, "H": h, "virtual_rows": sum(
                       r.shape[0] for r in ell.rows), "items": sched.items.shape[0],
                   "parts": sched.n_parts, "same_bits": bool(torch.equal(got, again)),
                   "max_abs_err": float((got - ref).abs().max()), **e1_bound(ell, sched, h)}
            timed = {"e1_ms": lambda: e1.ell_spmm_cuda(ell, x),
                     "plain_ms": lambda: ell_spmm_plain(ell, x),
                     "library_ms": lambda: torch.sparse.mm(csr, x)}
            for _ in range(2):
                for key, fn in timed.items():
                    row.setdefault(key + "_runs", []).append(cuda_ms(fn, iters=ITERS))
            for key in timed:
                row[key] = min(row[key + "_runs"])
            row["e1_peak_bytes"] = _peak_above(timed["e1_ms"])
            row["plain_peak_bytes"] = _peak_above(timed["plain_ms"])
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    main()
