"""Kernel E2's schedule (``ops/cuda/colpanel_spmm.colpanel_schedule``) and its
plain model, on the CPU.

The graph has 2,400 rows in five sender panels of 512 (the last 352 wide),
on the port's bucket ladder (widest 256): a row without edges, a hub of 400
edges in panel 1 (a full chunk of 256 in the widest bucket and a tail of 144
in the bucket of 192) and 100 more in other panels, and a wider hub of 1,500
edges spread over every panel (each panel's chunk split over the widest
bucket). At a hub cap of 300 slots both hubs are cut into parts. The
schedule must reference every valid slot of every live bucket once, in its
row's list, in panel, bucket and slot order, and no padding; write the row
without edges as zeros; cut the hubs at virtual-row boundaries into parts
that hold the references starting in each 300 slots of the row; and stay
within 8 bytes a virtual row and 4 an output row (the hubs' parts apart).
Summing along it (:func:`scheduled_sum`, E2's arithmetic in plain PyTorch,
in float64 so that only the schedule is compared) is the plain
``col_panel_spmm_raw`` to 1e-6 and the dense product to 1e-5 at H = 1, 3,
47 and 256. The layout's ``lens`` are ``build_ell``'s; the wrapper raises on
what E2 does not take, and the CPU product is still the plain chain. The
layout comes from the native library where it loads and from NumPy, for a
symmetric and an asymmetric graph.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pygcn_tpu_torch.ops import colpanel as cp
from pygcn_tpu_torch.ops.cuda import colpanel_spmm as e2
from pygcn_tpu_torch.ops.ell import build_ell
from pygcn_tpu_torch.utils import native

torch.set_num_threads(1)

N, PW, CAP = 2400, 512, 300
EMPTY, HUB, WIDE_HUB = 5, 7, 11


def matrix(symmetric):
    rng = np.random.default_rng(1)
    rows, cols = rng.integers(0, N, 14000), rng.integers(0, N, 14000)
    special = (EMPTY, HUB, WIDE_HUB)
    keep = ~np.isin(rows, special) & ~np.isin(cols, special)
    hub_cols = np.concatenate([PW + rng.permutation(PW)[:400],
                               2 * PW + rng.permutation(N - 2 * PW)[:100]])
    rows = np.concatenate([rows[keep], np.full(500, HUB), np.full(1500, WIDE_HUB)])
    cols = np.concatenate([cols[keep], hub_cols, rng.permutation(N)[:1500]])
    keep = cols != EMPTY  # so that row EMPTY stays empty when mirrored
    rows, cols = rows[keep], cols[keep]
    vals = rng.uniform(0.1, 1.0, rows.size).astype(np.float32)  # no edge of value 0
    m = sp.csr_matrix((vals, (rows, cols)), shape=(N, N))
    m.sum_duplicates()
    if symmetric:
        m = m.maximum(m.T).tocsr()
    return m


def layout(made_by, symmetric, monkeypatch):
    if made_by == "numpy":
        monkeypatch.setattr(native, "build_ell_layout", lambda *a, **k: None)
    m = matrix(symmetric)
    return m, cp.build_col_panel_ell(m, PW)


def tables(pe):
    """Per bucket table, in panel and bucket order: its panel start, k, flat
    cols, flat vals, rows and lens."""
    return [(s, k, c.reshape(-1).numpy(), v.reshape(-1).numpy(), r.numpy(), n)
            for fb, s in zip(pe.panels, pe.starts)
            for k, c, v, r, n in zip(fb.ks, fb.cols, fb.vals, fb.rows, fb.lens)]


def row_ranges(sched):
    """Each row's ``(begin, end, hub)`` over ``refs``."""
    ptr = sched.row_ptr.numpy().astype(np.int64)
    return [(int(ptr[r] & 0x7FFFFFFF), int(ptr[r + 1] & 0x7FFFFFFF), bool(ptr[r] < 0))
            for r in range(N)]


def ref_slots(sched, lo, hi):
    """The ``(table, flat slot)`` of every slot the references ``lo .. hi - 1``
    read, in order."""
    out = []
    for slot, info in sched.refs[lo:hi].tolist():
        out += [(info >> 16, s) for s in range(slot, slot + (info & 0xFFFF))]
    return out


def scheduled_sum(pe, sched, x):
    """E2's sums in plain PyTorch along ``sched``: each item's references in
    order, each reference's slots in slot order; a hub row's partials summed
    in part order."""
    tabs = tables(pe)
    h = x.shape[1]

    def walk(lo, hi):
        acc = x.new_zeros(h)
        for t, s in ref_slots(sched, lo, hi):
            start, _, cols, vals, _, _ = tabs[t]
            acc = acc + float(vals[s]) * x[start + int(cols[s])]
        return acc

    out = x.new_empty((pe.n_rows, h))
    for r, (lo, hi, hub) in enumerate(row_ranges(sched)):
        if not hub:
            out[r] = walk(lo, hi)
    partials = [walk(b, e) for _, b, e, *_ in sched.parts.tolist()]
    for row, _, _, _, part, first, parts, _ in sched.parts.tolist():
        if part == first:
            acc = partials[first]
            for k in range(first + 1, first + parts):
                acc = acc + partials[k]
            out[row] = acc
    return out


def check_cover(m, pe, sched):
    deg = np.diff(m.indptr)
    assert deg[EMPTY] == 0 and deg[HUB] >= 500 and deg[WIDE_HUB] >= 1500
    assert len(pe.panels) == 5 and sched.n_tables == sum(len(fb.ks) for fb in pe.panels)
    # what each row should read: every valid slot of every live bucket, in
    # panel, bucket and slot order (a row's chunks in one bucket in order)
    want = [[] for _ in range(N)]
    for t, (_, k, _, vals, rows, lens) in enumerate(tables(pe)):
        for i, (r, n) in enumerate(zip(rows, lens)):
            assert (vals[i * k:i * k + n] != 0).all() and not vals[i * k + n:(i + 1) * k].any()
            want[r] += [(t, i * k + s) for s in range(n)]
    got = [ref_slots(sched, lo, hi) for lo, hi, _ in row_ranges(sched)]
    assert got == want
    assert sum(map(len, got)) == m.nnz  # every edge once, no padding
    lo, hi, hub = row_ranges(sched)[EMPTY]
    assert lo == hi and not hub  # an item without references: it writes zeros
    lengths = sched.refs[:, 1].numpy() & 0xFFFF
    assert lengths.min() >= 1 and lengths.max() <= 256
    assert sched.n_cols == N


def check_hubs(m, pe, sched):
    parts = sched.parts.numpy()
    ranges = row_ranges(sched)
    hubs = sorted({int(r) for r in parts[:, 0]})
    assert HUB in hubs and WIDE_HUB in hubs
    assert [r for r, (_, _, hub) in enumerate(ranges) if hub] == hubs
    lengths = sched.refs[:, 1].numpy() & 0xFFFF
    for row in range(N):
        lo, hi, hub = ranges[row]
        slots = lengths[lo:hi]
        part_of = (np.cumsum(slots) - slots) // CAP  # each reference's part of its row
        if not hub:
            assert part_of.max(initial=0) == 0  # every reference starts in the first CAP slots
            continue
        mine = parts[parts[:, 0] == row]
        n = len(mine)
        assert n == part_of.max() + 1 >= 2
        first = int(mine[0, 4])
        assert mine[:, 4].tolist() == list(range(first, first + n))  # the partials, in order
        assert (mine[:, 5] == first).all() and (mine[:, 6] == n).all()
        assert (mine[:, 3] == 0).all() and (mine[:, 7] == 0).all()
        assert mine[0, 1] == lo and mine[-1, 2] == hi and (mine[1:, 1] == mine[:-1, 2]).all()
        for k, (b, e) in enumerate(mine[:, 1:3]):
            assert (part_of[b - lo:e - lo] == k).all()  # cut at virtual-row boundaries
    assert sched.parts.shape == (sched.n_parts, e2.PART_INTS)


def check_budget(m, pe, sched):
    n_refs = sched.refs.shape[0]
    assert n_refs <= pe.n_vrows and sched.refs.dtype == torch.int32
    assert sched.refs.nbytes == 8 * n_refs and sched.row_ptr.nbytes == 4 * (N + 1)
    assert sched.refs.nbytes + sched.row_ptr.nbytes <= 8 * pe.n_vrows + 4 * N + 4
    assert sched.parts.nbytes == 32 * sched.n_parts


def check_lens(m, pe, sched):
    csc = m.tocsc()
    for fb, s, w in zip(pe.panels, pe.starts, pe.widths):
        sub = csc[:, s:s + w].tocsr()
        ell = build_ell(sub[np.flatnonzero(np.diff(sub.indptr))], fb.ks)
        assert [n.dtype for n in fb.lens] == [np.int32] * len(fb.ks)
        assert [n.tolist() for n in fb.lens] == [n.tolist() for n in ell.lens]
    pe.cache["x"] = 1
    assert pe.to("cpu").cache == {}  # a moved layout starts without a schedule
    # the lengths stay on the host: only the schedule's build reads them
    moved = pe.to("meta")
    assert all(c.is_meta for fb in moved.panels for c in fb.cols)
    assert all(a is b for fb, fm in zip(pe.panels, moved.panels) for a, b in zip(fb.lens, fm.lens))


def check_sum(m, pe, sched, h):
    x = torch.from_numpy(np.random.default_rng(h).standard_normal((N, h)))
    got = scheduled_sum(pe, sched, x)
    torch.testing.assert_close(got, cp.col_panel_spmm_raw(pe, x), rtol=1e-6, atol=1e-6)
    dense = torch.from_numpy(m.toarray().astype(np.float64) @ x.numpy())
    torch.testing.assert_close(got, dense, rtol=1e-5, atol=1e-5)
    assert not got[EMPTY].any()


def check_rejects(m, pe, sched):
    x = torch.ones(N, 4)
    with pytest.raises(TypeError, match="float32"):
        e2.colpanel_spmm_cuda(pe, x.double())
    with pytest.raises(ValueError, match=r"\[n_cols, H\]"):
        e2.colpanel_spmm_cuda(pe, torch.ones(N))
    with pytest.raises(ValueError, match="CUDA"):
        e2.colpanel_spmm_cuda(pe, x)  # a CPU tensor
    with pytest.raises(ValueError, match="x is on meta, the layout on cpu"):
        e2.colpanel_spmm_cuda(pe, x.to("meta"))
    with pytest.raises(ValueError, match="cpu .plain. or cuda"):
        cp.col_panel_spmm_raw(pe, x.to("meta"))
    assert "colpanel_spmm" not in pe.cache
    with pytest.MonkeyPatch.context() as mp, pytest.raises(ValueError,
                                                         match="under the widest bucket"):
        mp.setattr(e2, "HUB_SLOTS", 255)
        e2.colpanel_schedule(pe)


def check_plain_on_cpu(m, pe, sched):
    live = sum(sum(fb.live) for fb in pe.panels)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((N, 8)).astype(np.float32))
    before, launched = cp.bucket_products, e2.launches
    got = cp.col_panel_spmm_raw(pe, x)
    assert cp.bucket_products - before == live
    assert torch.equal(got, cp.col_panel_spmm_plain(pe, x))
    assert "colpanel_spmm" not in pe.cache and e2.launches == launched


CASES = ["cover", "hubs", "budget", "lens", "sum_h1", "sum_h3", "sum_h47", "sum_h256",
         "rejects", "plain_on_cpu"]
CHECKS = {"cover": check_cover, "hubs": check_hubs, "budget": check_budget,
          "lens": check_lens, "rejects": check_rejects, "plain_on_cpu": check_plain_on_cpu}


@pytest.mark.parametrize("symmetric", [False, True], ids=["asym", "sym"])
@pytest.mark.parametrize("made_by", ["native", "numpy"])
@pytest.mark.parametrize("case", CASES)
def test_e2_schedule(case, made_by, symmetric, monkeypatch):
    m, pe = layout(made_by, symmetric, monkeypatch)
    monkeypatch.setattr(e2, "HUB_SLOTS", CAP)
    sched = e2.colpanel_schedule(pe)
    if case.startswith("sum_h"):
        return check_sum(m, pe, sched, int(case.removeprefix("sum_h")))
    CHECKS[case](m, pe, sched)


def test_empty_layout_schedule():
    """A layout without panels (a hybrid whose every edge lies on a tile):
    every row an item without references, no part."""
    empty = sp.csr_matrix((40, 40), dtype=np.float32)
    pe = cp.build_col_panel_ell(empty, 16)
    sched = e2.colpanel_schedule(pe)
    assert pe.panels == () and sched.refs.shape == (0, e2.REF_INTS)
    assert sched.row_ptr.tolist() == [0] * 41 and sched.n_parts == 0
    assert sched.n_tables == 0 and sched.n_cols == 0


def test_transpose_shares_the_structure_of_an_operator_symmetric_in_its_edges():
    """An operator symmetric in its edges but not in its weights (as the
    benchmark's saved ogbn-products operator is, in the last bit): the
    transpose panels hold the forward panels' columns, rows, lengths and
    merges (the same tensors, also once moved) and their own values; E2
    runs both on one schedule; the products are ``A @ x`` and ``A^T @ x``.
    An operator asymmetric in its edges keeps its transpose's own arrays."""
    from pygcn_tpu_torch.graph.graph import Graph
    from pygcn_tpu_torch.ops.spmm import spmm, spmm_t

    m = matrix(True)
    m.data = m.data * (1 + 1e-3 * np.random.default_rng(4).random(m.nnz)).astype(np.float32)
    assert (m != m.T).nnz > 0
    kw = dict(is_symmetric=False, build_dense=False, build_bcsr=False, build_ell=False,
              build_hybrid=False, build_colpanel=True, panel_width=PW)
    g = Graph.from_scipy(m, **kw).to("cpu")
    pe, pe_t = g.colpanel, g.colpanel_t
    assert pe_t.twin is pe and pe.twin is None
    for f, ft in zip(pe.panels, pe_t.panels):
        assert all(a is b for a, b in zip(ft.cols + ft.rows + ft.lens, f.cols + f.rows + f.lens))
        assert ft.merge is f.merge
    assert any(not torch.equal(a, b) for f, ft in zip(pe.panels, pe_t.panels)
               for a, b in zip(f.vals, ft.vals))
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((N, 8)).astype(np.float32))
    dense = m.toarray().astype(np.float64)
    for got, want in ((spmm(g, x, "colpanel"), dense), (spmm_t(g, x, "colpanel"), dense.T)):
        torch.testing.assert_close(got.double(), torch.from_numpy(want @ x.double().numpy()),
                                   rtol=1e-5, atol=1e-5)
    cpu = torch.device("cpu")
    assert e2._device_schedule(pe_t, cpu)[0] is e2._device_schedule(pe, cpu)[0]
    n = pe.cache["colpanel_spmm"][0].n_tables
    tables, tables_t = pe.cache["colpanel_spmm"][1], pe_t.cache["colpanel_spmm"][1]
    assert torch.equal(tables[:n], tables_t[:n])  # the same columns
    assert not torch.equal(tables[n:2 * n], tables_t[n:2 * n])  # their own values
    asym = Graph.from_scipy(matrix(False), **kw)
    assert asym.colpanel_t.twin is None
    assert asym.colpanel_t.panels[0].cols[0] is not asym.colpanel.panels[0].cols[0]
