"""The port's column-panel and panel layouts against the JAX package's.

The layouts of both packages come from one scipy matrix and agree array for
array: JAX stores a bucket's ``cols``/``vals`` flat (``[nb*k]``), the port as
``[nb, k]``. ``spmm``/``spmm_t`` with ``impl="colpanel"``, ``"panel"`` and the
hybrid's column-panel residual are held against JAX's on the same layouts,
values to 1e-5 and gradients (``torch.autograd`` against ``jax.vjp`` with one
fixed cotangent, one ``jax.jit`` per implementation) to 1e-5, on a symmetric
and an asymmetric graph whose first row has more edges in each panel than the
panel and hybrid layouts' (1, 2, 4, 8) bucket ladder holds (so their widest
buckets repeat it), with the port also at a chunk budget that splits buckets
into single rows. JAX runs B1's Pallas body in interpret mode; the port runs
B1's plain version.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pygcn_tpu.graph.graph import Graph as JGraph
from pygcn_tpu.ops.colpanel import build_col_panel_ell as j_build_cp
from pygcn_tpu.ops.colpanel import col_panel_spmm_raw as j_cp_raw
from pygcn_tpu.ops.hybrid import build_hybrid as j_build_hybrid
from pygcn_tpu.ops.panel import build_panel_ell as j_build_panel
from pygcn_tpu.ops.spmm import spmm as j_spmm
from pygcn_tpu.ops.spmm import spmm_t as j_spmm_t
from pygcn_tpu.parallel.partition import reorder_graph as j_reorder

import pygcn_tpu_torch.graph.graph as tgraph
import pygcn_tpu_torch.ops.colpanel as tcp
from pygcn_tpu_torch.graph.graph import Graph as TGraph
from pygcn_tpu_torch.ops.colpanel import build_col_panel_ell as t_build_cp
from pygcn_tpu_torch.ops.hybrid import build_hybrid as t_build_hybrid
from pygcn_tpu_torch.ops.panel import build_panel_ell as t_build_panel
from pygcn_tpu_torch.ops.spmm import spmm as t_spmm
from pygcn_tpu_torch.ops.spmm import spmm_t as t_spmm_t
from pygcn_tpu_torch.parallel.partition import reorder_graph as t_reorder

torch.set_num_threads(1)

N, PW, H = 300, 128, 16
KW = dict(build_dense=False, build_bcsr=False, build_ell=False,
          build_hybrid=True, hybrid_residual="colpanel", hybrid_min_edges_per_tile=300,
          build_panel=True, build_colpanel=True, panel_width=PW, ell_ks=(1, 2, 4, 8))


def coo(seed=0, e=2400):
    """Random edges (none from panel 2 into rows 200-299, an empty stretch),
    plus row 0 receiving from senders 40-299: more edges in each panel than
    the panel and hybrid layouts' widest bucket (8) holds, so their buckets
    repeat row 0."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, N, e), rng.integers(1, N, e)
    keep = ~((dst >= 200) & (src >= 2 * PW))
    hub = np.arange(40, N)
    src = np.concatenate([src[keep], hub])
    dst = np.concatenate([dst[keep], np.zeros(hub.size, np.int64)])
    src, dst = np.unique(np.stack([src, dst]), axis=1)
    return src, dst, rng.uniform(0.1, 1.0, src.size).astype(np.float32)


def matrix(symmetric=False):
    s, d, w = coo()
    m = sp.coo_matrix((w, (d, s)), shape=(N, N)).tocsr()
    return (m + m.T).tocoo() if symmetric else m.tocoo()


_GRAPHS = {}


def graphs(symmetric=False):
    if symmetric not in _GRAPHS:
        m = matrix(symmetric)
        _GRAPHS[symmetric] = (JGraph.from_scipy(m, is_symmetric=symmetric, **KW),
                              TGraph.from_scipy(m, is_symmetric=symmetric, **KW))
    return _GRAPHS[symmetric]


def assert_colpanel_equal(j, t):
    assert (t.starts, t.widths, t.n_rows, t.n_vrows) == (j.starts, j.widths, j.n_rows, j.n_vrows)
    assert len(t.panels) == len(j.panels)
    for jp, tp in zip(j.panels, t.panels):
        assert tp.ks == jp.ks
        for jc, jv, jr, tc, tv, tr, k in zip(jp.cols, jp.vals, jp.rows, tp.cols, tp.vals,
                                             tp.rows, tp.ks):
            assert tc.shape[1] == k
            np.testing.assert_array_equal(tc.numpy().reshape(-1), np.asarray(jc))
            np.testing.assert_array_equal(tv.numpy().reshape(-1), np.asarray(jv))
            np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def assert_ell_equal(j, t):
    assert t.ks == j.ks
    for name in ("cols", "vals", "rows"):
        for a, b in zip(getattr(j, name), getattr(t, name)):
            # JAX's ELL blocks are flat too
            np.testing.assert_array_equal(b.numpy().reshape(-1), np.asarray(a).reshape(-1))


@pytest.mark.parametrize("symmetric", [False, True], ids=["asym", "sym"])
def test_layouts_match_jax_array_for_array(symmetric):
    m = matrix(symmetric)
    for pw, ks in ((PW, tcp.COLPANEL_KS), (64, (4, 8, 16)), (PW, (1, 2, 4))):
        j, t = j_build_cp(m, pw, ks), t_build_cp(m, pw, ks)
        assert_colpanel_equal(j, t)
    assert len(t.panels) == 3 and t.n_vrows > 0
    # on the (1, 2, 4) ladder the widest bucket repeats row 0 and carries
    # its merge; the other buckets add once per row
    merged = [(mg, r) for p in t.panels for mg, r in zip(p.merge, p.rows) if mg is not None]
    assert len(merged) >= 1
    for (lengths, urows), rows in merged:
        np.testing.assert_array_equal(np.repeat(urows.numpy(), lengths.numpy()), rows.numpy())
    assert all(mg is None for p in t_build_cp(m, PW).panels for mg in p.merge)
    jp, tp = j_build_panel(m, PW), t_build_panel(m, PW)
    assert (tp.starts, tp.n_rows, tp.diag_edges) == (jp.starts, jp.n_rows, jp.diag_edges)
    for a, b in zip(jp.panels, tp.panels):
        assert_ell_equal(a, b)
    assert_ell_equal(jp.residual, tp.residual)
    kw = dict(min_edges_per_tile=300, ks=(1, 2, 4, 8), residual="colpanel", panel_width=PW)
    jh, th = j_build_hybrid(m, **kw), t_build_hybrid(m, **kw)
    assert 0 < th.tile_edges == jh.tile_edges < m.nnz
    np.testing.assert_array_equal(th.bcsr.data.numpy(), np.asarray(jh.bcsr.data))
    np.testing.assert_array_equal(th.bcsr.block_cols.numpy(), np.asarray(jh.bcsr.block_cols))
    assert_colpanel_equal(jh.ell, th.ell)
    # and through Graph.from_coo, whose column panels take the fine ladder
    jg, tg = graphs(symmetric)
    assert_colpanel_equal(jg.colpanel, tg.colpanel)
    assert_colpanel_equal(jg.hybrid.ell, tg.hybrid.ell)
    if not symmetric:
        assert_colpanel_equal(jg.colpanel_t, tg.colpanel_t)
        assert_ell_equal(jg.panel_t.residual, tg.panel_t.residual)


def _jax_both(impl):
    """``(spmm, its vjp, spmm_t, its vjp)`` in one compiled function."""
    @jax.jit
    def f(g, x, cot):
        y, vjp = jax.vjp(lambda v: j_spmm(g, v, impl=impl), x)
        yt, vjp_t = jax.vjp(lambda v: j_spmm_t(g, v, impl=impl), x)
        return y, vjp(cot)[0], yt, vjp_t(cot)[0]
    return f


_JAX_FNS = {}


@pytest.mark.parametrize("symmetric", [False, True], ids=["asym", "sym"])
@pytest.mark.parametrize("impl", ["colpanel", "panel", "hybrid"])
def test_spmm_and_gradients_match_jax(monkeypatch, impl, symmetric):
    jg, tg = graphs(symmetric)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((N, H)).astype(np.float32)
    cot = rng.standard_normal((N, H)).astype(np.float32)
    f = _JAX_FNS.setdefault(impl, _jax_both(impl))
    want = [np.asarray(a) for a in f(jg, jnp.asarray(x), jnp.asarray(cot))]

    def port():
        out = []
        for fn in (t_spmm, t_spmm_t):
            xt = torch.from_numpy(x).requires_grad_(True)
            y = fn(tg, xt, impl=impl)
            (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(cot))
            out += [y.detach().numpy(), dx.numpy()]
        return out

    got = port()
    for name, a, b in zip(("spmm", "grad", "spmm_t", "grad_t"), got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=name)
    # the port again with buckets split into row chunks of one row: the same bits
    monkeypatch.setattr(tcp, "COLPANEL_CHUNK_BUDGET_ELEMS", 1)
    for a, b in zip(port(), got):
        np.testing.assert_array_equal(a, b)


def test_auto_policy_above_the_threshold_builds_column_panels(monkeypatch):
    s, d, w = coo()
    kw = dict(n_nodes=N, dense_max_nodes=100)
    below = TGraph.from_coo(s, d, w, **kw)
    assert below.colpanel is None and below.hybrid is not None and below.ell is not None
    above = TGraph.from_coo(s, d, w, colpanel_min_nodes=200, **kw)
    assert above.ell is above.hybrid is above.panel is None
    assert above.colpanel is not None and above.colpanel_t is not None
    # the threshold is read when the graph is built, so lowering it reaches
    # every caller of the auto-policy
    monkeypatch.setattr(tgraph, "COLPANEL_MIN_NODES", 200)
    lowered = TGraph.from_coo(s, d, w, **kw)
    assert lowered.ell is None and lowered.colpanel is not None
    jg = JGraph.from_coo(s, d, w, colpanel_min_nodes=200, **kw)
    assert_colpanel_equal(jg.colpanel, lowered.colpanel)
    x = np.random.default_rng(1).standard_normal((N, 5)).astype(np.float32)
    np.testing.assert_allclose(t_spmm(lowered, torch.from_numpy(x)).numpy(),
                               matrix().toarray() @ x, rtol=1e-5, atol=1e-5)


def test_transpose_and_reorder_keep_the_layouts():
    jg, tg = graphs(False)
    tt, jt = tg.transpose(), jg.transpose()
    assert tt.panel is not None and tt.colpanel is not None and tt.hybrid is not None
    assert_colpanel_equal(jt.colpanel, tt.colpanel)
    assert_colpanel_equal(jt.colpanel_t, tt.colpanel_t)
    assert_ell_equal(jt.panel.residual, tt.panel.residual)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((N, 4)).astype(np.float32))
    for impl in ("colpanel", "panel"):
        torch.testing.assert_close(t_spmm(tt, x, impl=impl), t_spmm_t(tg, x, impl=impl),
                                   rtol=1e-5, atol=1e-5)
    perm = np.random.default_rng(3).permutation(N)
    (jr, _), (tr, inv) = j_reorder(jg, perm), t_reorder(tg, perm)
    assert tr.panel is not None and tr.colpanel is not None and tr.colpanel_t is not None
    assert_colpanel_equal(jr.colpanel, tr.colpanel)
    assert_colpanel_equal(jr.hybrid.ell, tr.hybrid.ell)
    xr = x[torch.from_numpy(perm)]
    for impl in ("colpanel", "panel", "hybrid"):
        torch.testing.assert_close(t_spmm(tr, xr, impl=impl)[torch.from_numpy(inv)],
                                   t_spmm(tg, x, impl=impl), rtol=1e-5, atol=1e-5)


def test_all_empty_layout_keeps_the_dtype():
    empty = sp.coo_matrix((np.zeros(0, np.float32), (np.zeros(0, int), np.zeros(0, int))),
                          shape=(40, 40))
    j, t = j_build_cp(empty, 16), t_build_cp(empty, 16)
    assert t.panels == () == j.panels and t.n_vrows == 0
    x = np.ones((40, 3), np.float64)
    got = tcp.col_panel_spmm_raw(t, torch.from_numpy(x))
    want = j_cp_raw(j, jnp.asarray(x, jnp.float32))
    assert got.dtype == torch.float64 and not got.any()
    assert want.dtype == jnp.float32 and not np.asarray(want).any()
    # a hybrid whose every edge lies on a tile leaves an all-empty residual
    dense = sp.coo_matrix(np.ones((32, 32), np.float32))
    th = t_build_hybrid(dense, (32, 32), min_edges_per_tile=1, residual="colpanel")
    assert th.ell.panels == () and th.tile_edges == 32 * 32
    xt = torch.ones(32, 2)
    torch.testing.assert_close(tcp.col_panel_spmm_raw(th.ell, xt), torch.zeros(32, 2))


def test_unknown_residual_raises():
    with pytest.raises(ValueError, match="unknown residual"):
        t_build_hybrid(matrix(), residual="panel")


def test_unsorted_bucket_rows_raise():
    with pytest.raises(ValueError, match="sorted"):
        tcp.merge_of(np.array([3, 1, 1], np.int32))
    assert tcp.merge_of(np.array([1, 3, 7], np.int32)) is None


def test_graph_to_moves_every_layout():
    _, tg = graphs(True)
    moved = tg.to("cpu")
    assert moved.colpanel_t is moved.colpanel and moved.panel_t is moved.panel
    assert dataclasses.is_dataclass(moved.colpanel.panels[0])
