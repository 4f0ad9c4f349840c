"""Kernel E1's work items (``ops/cuda/ell_spmm.ell_schedule``) and its
plain model, on the CPU.

The graph has 700 rows, one without edges, one of degree 310 (a full chunk
of 256 in the widest bucket and a tail of 54 in the bucket of 64) and one of
degree 600 (two full chunks and a tail of 88 in the bucket of 128). The
layout's lengths (``lens``) must count each virtual row's edges, and the
schedule must read every edge once and no padding, write the row without
edges as zeros, and merge each split row's parts in its chunk order; summing
the plain products along it (:func:`scheduled_sum`, E1's arithmetic in
plain PyTorch, in float64 so that only the schedule is compared) is the plain ``ell_spmm_raw`` to 1e-6 and the dense
product to 1e-5 at H = 1, 3, 40 and 256. The wrapper raises on what E1 does
not take. The layout comes from the native library where it loads and from
NumPy.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pygcn_tpu_torch.ops import ell as ell_mod
from pygcn_tpu_torch.ops.cuda import ell_spmm as e1
from pygcn_tpu_torch.utils import native

torch.set_num_threads(1)

N = 700
EMPTY, HUB, WIDE_HUB = 5, 7, 11
KS = (4, 8, 16, 32, 64, 128, 256)


def matrix():
    rng = np.random.default_rng(0)
    rows, cols = rng.integers(0, N, 6000), rng.integers(0, N, 6000)
    keep = ~np.isin(rows, (EMPTY, HUB, WIDE_HUB))
    rows = np.concatenate([rows[keep], np.full(310, HUB), np.full(600, WIDE_HUB)])
    cols = np.concatenate([cols[keep], rng.permutation(N)[:310], rng.permutation(N)[:600]])
    vals = rng.uniform(0.1, 1.0, rows.size).astype(np.float32)  # no edge of value 0
    m = sp.csr_matrix((vals, (rows, cols)), shape=(N, N))
    m.sum_duplicates()
    return m


def layout(made_by, monkeypatch):
    if made_by == "numpy":
        monkeypatch.setattr(native, "build_ell_layout", lambda *a, **k: None)
    m = matrix()
    return m, ell_mod.build_ell(m, KS)


def item_edges(ell, sched):
    """Each item's ``(row, [(col, val), ...])``, in item order."""
    cols = [c.reshape(-1).numpy() for c in ell.cols]
    vals = [v.reshape(-1).numpy() for v in ell.vals]
    return [(row, list(zip(cols[b][s:s + n].tolist(), vals[b][s:s + n].tolist())))
            for b, s, n, row, *_ in sched.items.tolist()]


def scheduled_sum(ell, sched, x):
    """E1's sums in plain PyTorch along ``sched``: each item's edges summed
    in slot order, a split row's partials summed in part order."""
    h = x.shape[1]
    out = x.new_empty((ell.n_rows, h))
    ws = x.new_empty((sched.n_parts, h))
    cols = [c.reshape(-1).long() for c in ell.cols]
    vals = [v.reshape(-1) for v in ell.vals]
    split = {}  # row: (first part, parts)
    for bucket, slot, length, row, part, first, parts, _ in sched.items.tolist():
        acc = x.new_zeros(h)
        for s in range(slot, slot + length):
            acc = acc + vals[bucket][s] * x[cols[bucket][s]]
        if part < 0:
            out[row] = acc
        else:
            ws[part] = acc
            split[row] = (first, parts)
    for row, (first, parts) in split.items():
        acc = ws[first]
        for k in range(first + 1, first + parts):
            acc = acc + ws[k]
        out[row] = acc
    return out


def check_cover(m, ell, sched):
    deg = np.diff(m.indptr)
    assert deg[EMPTY] == 0 and deg[HUB] == 310 and deg[WIDE_HUB] == 600
    # no edge has value 0, so a virtual row's edges are its slots of value != 0
    for n, v in zip(ell.lens, ell.vals):
        assert n.dtype == torch.int32 and n.tolist() == (v != 0).sum(1).tolist()
    got = sorted((row, c, v) for row, edges in item_edges(ell, sched) for c, v in edges)
    coo = m.tocoo()
    assert got == sorted(zip(coo.row.tolist(), coo.col.tolist(), coo.data.tolist()))
    # no padding read: every slot an item reads holds an edge (no edge has value 0)
    assert all(v != 0 for _, edges in item_edges(ell, sched) for _, v in edges)
    items = sched.items.numpy()
    assert sorted(set(items[:, 3].tolist())) == list(range(N))  # every row written
    assert items[items[:, 3] == EMPTY].tolist() == [[0, 0, 0, EMPTY, -1, -1, 1, 0]]
    assert (items[:, 2] <= KS[-1]).all()
    assert sched.n_parts == 2 + 3 and sched.n_cols == int(m.indices.max()) + 1


def check_hub_order(m, ell, sched):
    items = sched.items.numpy()
    edges = item_edges(ell, sched)
    for row, want_buckets in ((HUB, [6, 4]), (WIDE_HUB, [6, 6, 5])):
        mine = np.flatnonzero(items[:, 3] == row)
        by_part = mine[np.argsort(items[mine, 4])]
        first = items[by_part[0], 4]
        assert items[by_part, 4].tolist() == list(range(first, first + len(want_buckets)))
        assert (items[by_part, 5] == first).all() and (items[by_part, 6] == len(want_buckets)).all()
        assert items[by_part, 0].tolist() == want_buckets  # the tail chunk in a smaller bucket
        cols = [c for i in by_part for c, _ in edges[i][1]]
        assert cols == m.indices[m.indptr[row]:m.indptr[row + 1]].tolist()  # chunk order


def check_sum(m, ell, sched, h):
    x = torch.from_numpy(np.random.default_rng(h).standard_normal((N, h)))
    got = scheduled_sum(ell, sched, x)
    torch.testing.assert_close(got, ell_mod.ell_spmm_raw(ell, x), rtol=1e-6, atol=1e-6)
    dense = torch.from_numpy(m.toarray().astype(np.float64) @ x.numpy())
    torch.testing.assert_close(got, dense, rtol=1e-5, atol=1e-5)
    assert not got[EMPTY].any()


def check_rejects(ell):
    x = torch.ones(N, 4)
    with pytest.raises(TypeError, match="float32"):
        e1.ell_spmm_cuda(ell, x.double())
    with pytest.raises(ValueError, match=r"\[n_cols, H\]"):
        e1.ell_spmm_cuda(ell, torch.ones(N))
    with pytest.raises(ValueError, match="CUDA"):
        e1.ell_spmm_cuda(ell, x)  # a CPU tensor
    with pytest.raises(ValueError, match="cpu .plain. or cuda"):
        ell_mod.ell_spmm_raw(ell, x.to("meta"))
    assert "ell_spmm" not in ell.cache


CASES = ["cover", "hub_order", "sum_h1", "sum_h3", "sum_h40", "sum_h256", "rejects"]


@pytest.mark.parametrize("made_by", ["native", "numpy"])
@pytest.mark.parametrize("case", CASES)
def test_e1_schedule(case, made_by, monkeypatch):
    m, ell = layout(made_by, monkeypatch)
    if case == "rejects":
        return check_rejects(ell)
    sched = e1.ell_schedule(ell)
    if case == "cover":
        check_cover(m, ell, sched)
    elif case == "hub_order":
        check_hub_order(m, ell, sched)
    else:
        check_sum(m, ell, sched, int(case.removeprefix("sum_h")))
