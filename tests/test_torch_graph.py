"""The port's host-side builders against the JAX package's, array for array.

The same COO (made from a seed with NumPy) goes through ``pygcn_tpu`` and
``pygcn_tpu_torch``; every layout array, transform, dataset array and node
ordering must be equal. Only the container types differ (jax arrays vs torch
tensors), and the port stores ELL buckets ``[Nb, K]`` where the JAX package
stores them flat for the TPU's tile padding.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pygcn_tpu.graph.datasets as jds
import pygcn_tpu.graph.transform as jtr
import pygcn_tpu.parallel.partition as jpart
from pygcn_tpu.graph.graph import Graph as JGraph
from pygcn_tpu.utils import native as jnative

import pygcn_tpu_torch.graph.datasets as tds
import pygcn_tpu_torch.graph.transform as ttr
import pygcn_tpu_torch.parallel.partition as tpart
from pygcn_tpu_torch.graph.graph import Graph as TGraph
from pygcn_tpu_torch.ops.hybrid import build_hybrid
from pygcn_tpu_torch.utils import native as tnative

torch.set_num_threads(1)


def coo_arrays(n=300, e=2600, seed=0, empty_block_row=1, dups=200):
    """Asymmetric COO with ragged ``n``, duplicate edges and one empty block row."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    keep = dst // 128 != empty_block_row
    src, dst = src[keep], dst[keep]
    src = np.concatenate([src, src[:dups]])
    dst = np.concatenate([dst, dst[:dups]])
    w = rng.uniform(0.1, 1.0, src.size).astype(np.float32)
    return src, dst, w


def np_of(a):
    """A jax array or torch tensor as NumPy (bf16 as float32)."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def assert_bcsr_equal(jb, tb):
    assert (tb.tm, tb.tk, tb.n_block_rows, tb.n_block_cols) == (
        jb.tm, jb.tk, jb.n_block_rows, jb.n_block_cols)
    for f in ("data", "block_rows", "block_cols", "block_row_ptr"):
        np.testing.assert_array_equal(np_of(getattr(tb, f)), np_of(getattr(jb, f)), err_msg=f)


def assert_ell_equal(je, te):
    assert te.ks == tuple(je.ks) and te.n_rows == je.n_rows
    for jc, jv, jr, k, tc, tv, tr in zip(je.cols, je.vals, je.rows, je.ks,
                                         te.cols, te.vals, te.rows):
        assert tc.shape[1] == k
        np.testing.assert_array_equal(tc.numpy(), np_of(jc).reshape(-1, k))
        np.testing.assert_array_equal(tv.numpy(), np_of(jv).reshape(-1, k))
        np.testing.assert_array_equal(tr.numpy(), np_of(jr))


def assert_graph_equal(jg, tg):
    assert (tg.n_nodes, tg.n_edges, tg.is_symmetric, tg.e_pad) == (
        jg.n_nodes, jg.n_edges, jg.is_symmetric, jg.e_pad)
    assert tg.build_meta == jg.build_meta
    for f in ("senders", "receivers", "weights"):
        np.testing.assert_array_equal(np_of(getattr(tg, f)), np_of(getattr(jg, f)), err_msg=f)
    for f in ("dense", "bcsr", "bcsr_t", "ell", "ell_t", "hybrid", "hybrid_t"):
        assert (getattr(tg, f) is None) == (getattr(jg, f) is None), f
    if tg.dense is not None:
        np.testing.assert_array_equal(tg.dense.numpy(), np_of(jg.dense))
    for f in ("bcsr", "bcsr_t"):
        if getattr(tg, f) is not None:
            assert_bcsr_equal(getattr(jg, f), getattr(tg, f))
    for f in ("ell", "ell_t"):
        if getattr(tg, f) is not None:
            assert_ell_equal(getattr(jg, f), getattr(tg, f))
    for f in ("hybrid", "hybrid_t"):
        th, jh = getattr(tg, f), getattr(jg, f)
        if th is None:
            continue
        assert (th.n_rows, th.tile_edges) == (jh.n_rows, jh.tile_edges)
        assert (th.bcsr is None) == (jh.bcsr is None)
        if th.bcsr is not None:
            assert_bcsr_equal(jh.bcsr, th.bcsr)
        assert_ell_equal(jh.ell, th.ell)


ALL_LAYOUTS = dict(build_dense=True, build_bcsr=True, build_ell=True, build_hybrid=True,
                   hybrid_min_edges_per_tile=24)


@pytest.mark.parametrize("kwargs", [
    ALL_LAYOUTS,
    dict(ALL_LAYOUTS, is_symmetric=True),
    dict(ALL_LAYOUTS, hybrid_tile_dtype="bfloat16"),
    dict(ALL_LAYOUTS, hybrid_tile_budget_bytes=2 * 128 * 128 * 4),
    dict(ALL_LAYOUTS, ell_ks=(2, 4, 8)),
    {},  # the auto-policy (dense at this size)
    dict(dense_max_nodes=100, hybrid_min_edges_per_tile=24),  # auto: hybrid + ELL
], ids=["all", "symmetric", "bf16_tiles", "tile_budget", "narrow_ell", "auto_dense",
        "auto_hybrid"])
def test_from_coo_matches_jax(kwargs):
    src, dst, w = coo_arrays()
    jg = JGraph.from_coo(src, dst, w, n_nodes=300, **kwargs)
    tg = TGraph.from_coo(src, dst, w, n_nodes=300, **kwargs)
    assert_graph_equal(jg, tg)


def test_bcsr_empty_block_row_and_duplicates():
    src, dst, w = coo_arrays()
    tg = TGraph.from_coo(src, dst, w, n_nodes=300, build_bcsr=True, build_dense=True)
    b = tg.bcsr
    # block row 1 has no entries: one all-zero padding tile at block column 0
    assert b.block_row_ptr[2] - b.block_row_ptr[1] == 1
    pad = int(b.block_row_ptr[1])
    assert int(b.block_cols[pad]) == 0 and not b.data[pad].any()
    # duplicate edges are summed into the tiles
    dense = np.zeros((384, 384), np.float32)
    for t in range(b.data.shape[0]):
        r, c = int(b.block_rows[t]) * 128, int(b.block_cols[t]) * 128
        dense[r:r + 128, c:c + 128] += b.data[t].numpy()
    np.testing.assert_allclose(dense[:300, :300], tg.dense.numpy(), rtol=1e-6, atol=0)


def test_transpose_to_scipy_and_device_move():
    src, dst, w = coo_arrays(seed=3)
    kw = dict(n_nodes=300, build_bcsr=True, build_hybrid=True, hybrid_min_edges_per_tile=24)
    tg = TGraph.from_coo(src, dst, w, **kw)
    jg = JGraph.from_coo(src, dst, w, **kw)
    assert_graph_equal(jg.transpose(), tg.transpose())
    np.testing.assert_array_equal(tg.to_scipy().toarray(), jg.to_scipy().toarray())
    moved = tg.to("cpu")
    assert_graph_equal(jg, moved)
    assert moved.hybrid.to("cpu").bcsr.data.device.type == "cpu"
    sym = TGraph.from_coo(src, dst, w, is_symmetric=True, **kw)
    assert sym.transpose() is sym


def test_device_move_keeps_symmetric_layouts_shared():
    src, dst, w = coo_arrays(seed=4)
    kw = dict(n_nodes=300, build_ell=True, build_hybrid=True, hybrid_min_edges_per_tile=24)
    sym = TGraph.from_coo(src, dst, w, is_symmetric=True, **kw)
    assert sym.hybrid_t is sym.hybrid and sym.ell_t is sym.ell
    moved = sym.to("cpu")
    # the transpose layouts are the forward ones, moved once
    assert moved.hybrid_t is moved.hybrid and moved.ell_t is moved.ell
    assert moved.hybrid is not sym.hybrid
    asym = TGraph.from_coo(src, dst, w, **kw).to("cpu")
    assert asym.hybrid_t is not asym.hybrid and asym.ell_t is not asym.ell


def test_unported_layouts_raise():
    src, dst, w = coo_arrays()
    with pytest.raises(NotImplementedError, match="not ported yet"):
        TGraph.from_coo(src, dst, w, n_nodes=300, build_panel=True)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        TGraph.from_coo(src, dst, w, n_nodes=300, build_colpanel=True)
    # the >colpanel_min_nodes auto choice raises instead of picking another layout
    with pytest.raises(NotImplementedError, match="not ported yet"):
        TGraph.from_coo(src, dst, w, n_nodes=300, dense_max_nodes=100, colpanel_min_nodes=200)
    m = sp.coo_matrix((w, (dst, src)), shape=(300, 300))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        build_hybrid(m, residual="colpanel")


def test_transforms_match_jax():
    src, dst, w = coo_arrays(seed=5)
    m = sp.coo_matrix((w, (dst, src)), shape=(300, 300))
    for name in ("symmetrize_max", "sym_normalize", "row_normalize"):
        a = getattr(jtr, name)(m)
        b = getattr(ttr, name)(m)
        np.testing.assert_array_equal(b.toarray(), a.toarray(), err_msg=name)
    x = np.random.default_rng(0).uniform(size=(40, 7)).astype(np.float32)
    x[3] = 0
    np.testing.assert_array_equal(ttr.row_normalize_dense(x), jtr.row_normalize_dense(x))


def test_generators_match_jax():
    a = jds.chung_lu_graph(500, 6.0, seed=4, weighted=True)
    b = tds.chung_lu_graph(500, 6.0, seed=4, weighted=True)
    np.testing.assert_array_equal(b.toarray(), a.toarray())
    a, ca = jds.community_graph(700, 9.0, seed=2, return_communities=True)
    b, cb = tds.community_graph(700, 9.0, seed=2, return_communities=True)
    np.testing.assert_array_equal(b.toarray(), a.toarray())
    np.testing.assert_array_equal(cb, ca)


SMALL_DATA = dict(n=600, avg_degree=8.0, n_classes=4, feat_dim=12, seed=7,
                  build_dense=False, build_bcsr=False, build_ell=False, build_hybrid=False)


def assert_data_equal(jd, td):
    assert td.n_classes == jd.n_classes
    for f in ("features", "labels", "idx_train", "idx_val", "idx_test"):
        np.testing.assert_array_equal(getattr(td, f), np.asarray(getattr(jd, f)), err_msg=f)
    assert_graph_equal(jd.graph, td.graph)


def test_community_classification_matches_jax():
    kw = dict(SMALL_DATA, build_hybrid=True, hybrid_min_edges_per_tile=16)
    assert_data_equal(jds.community_classification(**kw), tds.community_classification(**kw))


@pytest.mark.parametrize("method", ["bfs", "lp", "louvain"])
def test_locality_order_and_reorder_match_jax(method):
    if method == "lp" and not (tnative.available() and jnative.available()):
        pytest.skip("graphkit native library did not load")
    jd = jds.community_classification(**SMALL_DATA)
    td = tds.community_classification(**SMALL_DATA)
    perm_j = jpart.locality_order(jd.graph, method)
    perm_t = tpart.locality_order(td.graph, method)
    np.testing.assert_array_equal(perm_t, perm_j)
    assert sorted(perm_t.tolist()) == list(range(600))
    assert_data_equal(jpart.reorder_dataset(jd, perm_j), tpart.reorder_dataset(td, perm_t))


def test_lp_fallback_matches_native():
    if not tnative.available():
        pytest.skip("graphkit native library did not load")
    a = tds.community_graph(400, 8.0, seed=1)
    a = ttr.symmetrize_max(a).tocsr()
    native_labels = tnative.label_propagation(a.indptr, a.indices, a.data, max_iters=5)
    saved = tnative._lib
    try:
        tnative._lib = None
        tnative._tried = True  # forces the NumPy sweep
        fallback = tnative.label_propagation(a.indptr, a.indices, a.data, max_iters=5)
    finally:
        tnative._lib = saved
    np.testing.assert_array_equal(fallback, native_labels)


def test_ell_numpy_fallback_matches_native():
    if not tnative.available():
        pytest.skip("graphkit native library did not load")
    from pygcn_tpu_torch.ops.ell import build_ell

    src, dst, w = coo_arrays(seed=9, e=3000)
    m = sp.coo_matrix((w, (dst, src)), shape=(300, 300)).tocsr()
    ks = (2, 4, 8, 16)
    native_ell = build_ell(m, ks)
    saved = tnative._lib
    try:
        tnative._lib = None
        fallback = build_ell(m, ks)
    finally:
        tnative._lib = saved
    assert_ell_equal(dataclasses.replace(
        fallback, cols=tuple(c.reshape(-1) for c in fallback.cols),
        vals=tuple(v.reshape(-1) for v in fallback.vals)), native_ell)
