"""The port against the JAX package on tile shapes other than 128 x 128.

``Graph.from_coo(tile=...)`` is public in both packages, and JAX's kernels
take the shape the layout carries. The same seeded graphs are built by both
packages at square tiles of 32, 64 and 96, and for the SpMM also at
(64, 128) and (8, 8): the layouts must be equal, the port's BCSR and hybrid
SpMM (forward and transpose) and its GAT and GATv2 hybrid convolutions
(values and gradients) must agree with JAX's, which runs its Pallas kernels
in interpret mode, as its own tests do. The port runs the kernels' plain
versions here (CPU tensors); ``tests/test_torch_cuda.py`` holds the card
kernels against those at the same shapes. Last, shapes outside the kernels'
rule are refused with a ``ValueError`` before any device is touched.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from test_torch_gat import GRAD, VAL, check_vjp
from test_torch_graph import assert_graph_equal

from pygcn_tpu.graph.graph import Graph as JGraph
from pygcn_tpu.ops import gat as jgat
from pygcn_tpu.ops.spmm import spmm as j_spmm
from pygcn_tpu.ops.spmm import spmm_t as j_spmm_t

from pygcn_tpu_torch.graph.graph import Graph as TGraph
from pygcn_tpu_torch.ops import gat as tgat
from pygcn_tpu_torch.ops.cuda import bcsr_spmm as b1
from pygcn_tpu_torch.ops.cuda import gat_tile_attn as gta
from pygcn_tpu_torch.ops.spmm import spmm as t_spmm
from pygcn_tpu_torch.ops.spmm import spmm_t as t_spmm_t

torch.set_num_threads(1)

N = 200
GAT_SIDES = [32, 64, 96]
SPMM_TILES = [(32, 32), (64, 64), (96, 96), (64, 128), (8, 8)]


def coo(symmetric: bool, seed: int = 5):
    """Dense blocks on the diagonal (so that the hybrid layout keeps tiles at
    any of these sides), a sparse random residual, and no edge in rows
    100-131 (an empty block row at every side here)."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for lo, hi in ((0, 64), (140, N)):
        rows.append(rng.integers(lo, hi, 900))
        cols.append(rng.integers(lo, hi, 900))
    rows.append(rng.integers(0, N, 120))
    cols.append(rng.integers(0, N, 120))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    keep = (rows != cols) & ((rows < 100) | (rows >= 132))
    if symmetric:
        keep &= (cols < 100) | (cols >= 132)
    m = sp.coo_matrix((np.ones(int(keep.sum()), np.float32), (rows[keep], cols[keep])),
                      shape=(N, N))
    m.sum_duplicates()
    m.data[:] = np.random.default_rng(seed + 1).uniform(0.5, 2.0, m.nnz)
    if symmetric:
        m = m.maximum(m.T).tocoo()
    return m.col, m.row, m.data.astype(np.float32)


_GRAPHS = {}


def graphs(tile, symmetric=False, **layouts):
    key = (tuple(tile), symmetric, tuple(sorted(layouts.items())))
    if key not in _GRAPHS:
        s, d, w = coo(symmetric)
        kw = dict(n_nodes=N, is_symmetric=symmetric, build_dense=False, tile=tuple(tile),
                  hybrid_min_edges_per_tile=max(8, tile[0] * tile[1] // 16), **layouts)
        _GRAPHS[key] = JGraph.from_coo(s, d, w, **kw), TGraph.from_coo(s, d, w, **kw)
    return _GRAPHS[key]


@pytest.mark.parametrize("tile", SPMM_TILES, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("symmetric", [False, True], ids=["asym", "sym"])
def test_from_coo_layouts_match_jax(tile, symmetric):
    jg, tg = graphs(tile, symmetric, build_bcsr=True, build_ell=True, build_hybrid=True)
    assert tg.bcsr.tm == tile[0] and tg.hybrid.bcsr is not None
    assert 0 < tg.hybrid.tile_edges < tg.n_edges
    assert_graph_equal(jg, tg)


@pytest.mark.parametrize("impl", ["bcsr", "hybrid"])
@pytest.mark.parametrize("tile", SPMM_TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_spmm_both_directions_match_jax(tile, impl):
    """``A @ x`` and ``A^T @ x`` on an asymmetric graph (the transpose on the
    layout's transpose tiles), with their gradients (each on the other's
    tiles). JAX's ``spmm_t`` over BCSR has no VJP in interpret mode at any
    tile, so there the values alone are held."""
    jg, tg = graphs(tile, build_bcsr=True, build_ell=True, build_hybrid=True)
    x = np.random.default_rng(7).normal(size=(N, 6)).astype(np.float32)
    check_vjp(lambda a: j_spmm(jg, a, impl=impl), lambda a: t_spmm(tg, a, impl=impl), (x,), 8)
    if impl == "hybrid":
        check_vjp(lambda a: j_spmm_t(jg, a, impl=impl), lambda a: t_spmm_t(tg, a, impl=impl),
                  (x,), 9)
    else:
        np.testing.assert_allclose(t_spmm_t(tg, torch.from_numpy(x), impl=impl).numpy(),
                                   np.asarray(j_spmm_t(jg, jnp.asarray(x), impl=impl)), **VAL)


def gat_graphs(side, symmetric):
    return graphs((side, side), symmetric, build_bcsr=False, build_ell=True, build_hybrid=True)


def gat_inputs(seed, h=2, f=4):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((N, h, f), (h, f), (h, f)))


@pytest.mark.parametrize("symmetric", [False, True], ids=["asym", "sym"])
@pytest.mark.parametrize("side", GAT_SIDES)
def test_gat_conv_hybrid_matches_jax(side, symmetric):
    """Values and gradients with respect to ``s``, ``a_src`` and ``a_dst``."""
    jg, tg = gat_graphs(side, symmetric)
    jt, tt = jgat.build_gat_tiles_t(jg), tgat.build_gat_tiles_t(tg)
    assert tt.tm == side
    check_vjp(lambda s, a, b: jgat.gat_conv_hybrid(jg, jt, s, a, b),
              lambda s, a, b: tgat.gat_conv_hybrid(tg, tt, s, a, b), gat_inputs(side), 9,
              VAL, GRAD)


@pytest.mark.parametrize("symmetric", [False, True], ids=["asym", "sym"])
@pytest.mark.parametrize("side", GAT_SIDES)
def test_gatv2_conv_hybrid_matches_jax(side, symmetric):
    """Values and gradients with respect to ``s_l``, ``s_r`` and ``a``."""
    jg, tg = gat_graphs(side, symmetric)
    jt, tt = jgat.build_gat_tiles_t(jg), tgat.build_gat_tiles_t(tg)
    rng = np.random.default_rng(side + 1)
    args = tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((N, 2, 4), (N, 2, 4), (2, 4)))
    check_vjp(lambda sl, sr, a: jgat.gatv2_conv_hybrid(jg, jt, sl, sr, a),
              lambda sl, sr, a: tgat.gatv2_conv_hybrid(tg, tt, sl, sr, a), args, 10,
              VAL, GRAD)


@pytest.mark.parametrize("tile", [(12, 16), (8, 4), (20, 40)], ids=lambda t: f"{t[0]}x{t[1]}")
def test_spmm_kernels_refuse_sides_off_the_rule(tile):
    """B1 and B2 take sides that are multiples of 8 and refuse others first,
    whatever the device."""
    _, tg = graphs(tile, build_bcsr=True)
    x = torch.ones(N, 4)
    for fn in (b1.bcsr_spmm_cuda, b1.bcsr_spmm_stream_cuda):
        with pytest.raises(ValueError, match="multiples of 8"):
            fn(tg.bcsr, x, n_rows=N)


@pytest.mark.parametrize("tile", [(64, 128), (48, 48), (16, 16), (8, 8)],
                         ids=lambda t: f"{t[0]}x{t[1]}")
def test_gat_kernels_refuse_tiles_off_the_rule(tile):
    """The GAT kernels take square tiles whose side is a multiple of 32 and
    refuse others first, whatever the device; the rule's sides pass the
    check and then need a card."""
    _, tg = graphs(tile, build_bcsr=True)
    ops = (torch.zeros(N, 2), torch.zeros(N, 2), torch.zeros(N, 8))
    for fn in (gta.tile_fwd_cuda, gta.tile_fwd_stream_cuda):
        with pytest.raises(ValueError, match="multiple of 32"):
            fn(tg.bcsr, *ops, 2, 4, 0.2)
    ok = graphs((32, 32), build_bcsr=True)[1].bcsr
    with pytest.raises(ValueError, match="CUDA device"):
        gta.tile_fwd_cuda(ok, *ops, 2, 4, 0.2)


def test_panels_of_a_wide_side():
    """A side above 128 reaches the GAT kernels as its panels: every panel
    tile once, sorted by panel block row, with its source tile."""
    b, n, _ = __import__("pygcn_tpu_torch.apps.time_spmm", fromlist=["x"]).shaped_tiles(
        (160, 160), np.random.default_rng(0), square=True)
    view = gta.tile_panels(b)
    assert view.panels == 2 and view.n_block_rows == 2 * b.n_block_rows
    t = b.data.shape[0]
    assert view.src.shape[0] == 4 * t
    rows, cols, src = (a.numpy().astype(np.int64) for a in (view.block_rows, view.block_cols,
                                                            view.src))
    assert (np.diff(rows) >= 0).all()
    np.testing.assert_array_equal(rows // 2, b.block_rows.numpy()[src])
    np.testing.assert_array_equal(cols // 2, b.block_cols.numpy()[src])
    assert len({(r, c) for r, c in zip(rows, cols)}) == 4 * t
    np.testing.assert_array_equal(np.diff(view.block_row_ptr.numpy()),
                                  np.bincount(rows, minlength=view.n_block_rows))
    assert gta.tile_panels(b) is view  # built once per tile set
    assert gta.tile_panels(gta.transpose_bcsr(b)).panels == 2
    small = __import__("pygcn_tpu_torch.apps.time_spmm", fromlist=["x"]).shaped_tiles(
        (96, 96), np.random.default_rng(0), square=True)[0]
    assert gta.tile_panels(small).src is None and not small.cache
