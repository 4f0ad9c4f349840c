"""Kernels B1-B9, the stream modes B5s and B6s, E1 and E2 on a CUDA card against
their plain versions (skipped without a card), on 128 x 128 tiles and on the
other tile shapes a layout can carry.

Run on a machine with an H100 from the repo root (``--noconftest`` because
``tests/conftest.py`` configures JAX, which that machine does not need)::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pygcn_tpu_torch.apps.time_spmm import long_row_tiles, shaped_tiles
from pygcn_tpu_torch.graph.graph import Graph, _build_bcsr, drop_zero_tiles
from pygcn_tpu_torch.ops.cuda import bcsr_spmm as b1
from pygcn_tpu_torch.ops.cuda import gat_tile_attn as gta

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("h", [1, 40, 128, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b1_kernel_matches_plain(dev, dtype, h):
    rng = np.random.default_rng(h)
    m = sp.random(300, 270, density=0.05, random_state=rng, format="coo",
                  data_rvs=rng.standard_normal, dtype=np.float32)
    keep = m.row // 128 != 1  # an empty block row
    m = sp.coo_matrix((m.data[keep], (m.row[keep], m.col[keep])), shape=m.shape)
    b = _build_bcsr(m, (128, 128))
    b = dataclasses.replace(b, data=b.data.to(dtype)).to(dev)
    x = torch.from_numpy(rng.standard_normal((270, h)).astype(np.float32)).to(dev)
    before = b1.launches
    got = b1.bcsr_spmm(b, x, n_rows=300)
    torch.cuda.synchronize()
    assert b1.launches == before + 1
    torch.testing.assert_close(got, b1.bcsr_spmm_plain(b, x, n_rows=300), rtol=1e-4, atol=1e-4)
    assert not got[128:256].any()


@pytest.mark.parametrize("h", [1, 3, 40, 256, 640])
def test_e1_kernel_matches_plain(dev, h):
    """E1 on a layout with a row without edges and a row split over two
    buckets (degree 300) against the plain version, bit for bit in two
    launches; forward and gradient through ``ELLSpMM``."""
    from pygcn_tpu_torch.ops import ell as ell_mod
    from pygcn_tpu_torch.ops.cuda import ell_spmm as e1

    rng = np.random.default_rng(h)
    m = sp.random(300, 270, density=0.05, random_state=rng, format="lil",
                  data_rvs=rng.standard_normal, dtype=np.float32)
    m[3, :] = 0
    m[5, :] = 0
    m[5, rng.choice(270, 260, replace=False)] = 1.0
    m = m.tocsr()
    ell, ell_t = ell_mod.build_ell(m).to(dev), ell_mod.build_ell(m.T.tocsr()).to(dev)
    x = torch.from_numpy(rng.standard_normal((270, h)).astype(np.float32)).to(dev)
    before = e1.launches
    got = ell_mod.ell_spmm_raw(ell, x)
    again = ell_mod.ell_spmm_raw(ell, x)
    torch.cuda.synchronize()
    assert e1.launches == before + 2
    assert torch.equal(got, again) and not got[3].any()
    torch.testing.assert_close(got, ell_mod.ell_spmm_plain(ell, x), rtol=1e-4, atol=1e-4)
    xg = x.clone().requires_grad_(True)
    cot = torch.from_numpy(rng.standard_normal((300, h)).astype(np.float32)).to(dev)
    (dx,) = torch.autograd.grad(ell_mod.ell_spmm_pair(ell, ell_t, xg), xg, cot)
    torch.testing.assert_close(dx, ell_mod.ell_spmm_plain(ell_t, cot), rtol=1e-4, atol=1e-4)


def _e2_matrix(rng):
    """A 4000-node CSR matrix of unit-normal values in four 1024-wide sender
    panels: row 3 without edges, row 9 with 900 edges in panel 0 (split over
    the widest bucket) and row 5 with 3,000 over every panel, a hub row over
    E2's cap that its schedule cuts into parts."""
    n = 4000
    rows, cols = rng.integers(0, n, 40000), rng.integers(0, n, 40000)
    keep = ~np.isin(rows, (3, 5, 9))
    rows = np.concatenate([rows[keep], np.full(900, 9), np.full(3000, 5)])
    cols = np.concatenate([cols[keep], rng.permutation(1024)[:900], rng.permutation(n)[:3000]])
    data = rng.standard_normal(rows.size).astype(np.float32)
    return sp.csr_matrix((data, (rows, cols)), shape=(n, n))


@pytest.mark.parametrize("h", [40, 47, 256])
def test_e2_kernel_matches_plain(dev, h):
    """E2 against the plain chain and a float64 product on the forward and
    the transpose layout, bit for bit in two launches, one launch a
    product, the row without edges zero and the hub row summed from its
    parts; at H = 256 also on an x whose rows are not 16-byte aligned (the
    4-byte path); forward and gradient through ``ColPanelSpMM``."""
    from pygcn_tpu_torch.ops import colpanel as cp
    from pygcn_tpu_torch.ops.cuda import colpanel_spmm as e2

    rng = np.random.default_rng(h)
    m = _e2_matrix(rng)
    pes = [cp.build_col_panel_ell(a, 1024).to(dev) for a in (m, m.T.tocsr())]
    for i, (a, pe) in enumerate(zip((m, m.T.tocsr()), pes)):
        x = torch.from_numpy(rng.standard_normal((a.shape[1], h)).astype(np.float32)).to(dev)
        before = e2.launches
        got = cp.col_panel_spmm_raw(pe, x)
        again = cp.col_panel_spmm_raw(pe, x)
        torch.cuda.synchronize()
        assert e2.launches == before + 2
        assert torch.equal(got, again) and (i == 1 or not got[3].any())
        torch.testing.assert_close(got, cp.col_panel_spmm_plain(pe, x), rtol=1e-4, atol=1e-4)
        want = torch.from_numpy(a.toarray().astype(np.float64) @ x.double().cpu().numpy())
        torch.testing.assert_close(got.double().cpu(), want, rtol=1e-4, atol=1e-4)
    assert pes[0].cache["colpanel_spmm"][0].n_parts >= 2  # row 5's parts
    if h == 256:
        flat = torch.from_numpy(rng.standard_normal(4000 * 256 + 1).astype(np.float32)).to(dev)
        x = flat[1:].view(4000, 256)  # rows 4 bytes off a 16-byte boundary
        torch.testing.assert_close(cp.col_panel_spmm_raw(pes[0], x),
                                   cp.col_panel_spmm_plain(pes[0], x), rtol=1e-4, atol=1e-4)
    xg = x.clone().requires_grad_(True)
    cot = torch.from_numpy(rng.standard_normal((4000, h)).astype(np.float32)).to(dev)
    y = cp.col_panel_spmm_pair(pes[0], pes[1], xg)
    (dx,) = torch.autograd.grad(y, xg, cot)
    torch.testing.assert_close(y.detach(), cp.col_panel_spmm_plain(pes[0], x),
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dx, cp.col_panel_spmm_plain(pes[1], cot), rtol=1e-4, atol=1e-4)
    with pytest.raises(TypeError, match="float32"):
        cp.col_panel_spmm_raw(pes[0], x.to(torch.bfloat16))


def test_e2_on_a_transpose_that_shares_the_structure(dev):
    """An operator symmetric in its edges but not in its weights: the
    transpose panels hold the forward panels' arrays and E2 runs both on
    one schedule; ``spmm``, ``spmm_t`` and the gradient on the card against
    the CPU (1e-4) and against float64 products."""
    from pygcn_tpu_torch.ops.cuda import colpanel_spmm as e2
    from pygcn_tpu_torch.ops.spmm import spmm, spmm_t

    rng = np.random.default_rng(24)
    m = _e2_matrix(rng)
    m = m.maximum(m.T).tocsr()
    m.data = (m.data * (1 + 1e-3 * rng.random(m.nnz))).astype(np.float32)
    g = Graph.from_scipy(m, is_symmetric=False, build_dense=False, build_bcsr=False,
                         build_ell=False, build_hybrid=False, build_colpanel=True,
                         panel_width=1024)
    x = torch.from_numpy(rng.standard_normal((4000, 64)).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((4000, 64)).astype(np.float32))

    def run(graph, x, cot):
        xx = x.clone().requires_grad_()
        y = spmm(graph, xx, impl="colpanel")
        (dx,) = torch.autograd.grad(y, xx, cot)
        return y.detach(), dx, spmm_t(graph, x, impl="colpanel")

    want = run(g, x, cot)
    gd = g.to(dev)
    assert gd.colpanel_t.twin is gd.colpanel
    got = run(gd, x.to(dev), cot.to(dev))
    torch.cuda.synchronize()
    assert gd.colpanel_t.cache["colpanel_spmm"][0] is gd.colpanel.cache["colpanel_spmm"][0]
    assert e2.launches  # the card ran E2
    dense = m.toarray().astype(np.float64)
    f64 = (dense @ x.double().numpy(), dense.T @ cot.double().numpy(), dense.T @ x.double().numpy())
    for a, w, d in zip(got, want, f64):
        torch.testing.assert_close(a.cpu(), w, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(a.double().cpu(), torch.from_numpy(d), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("h", [1, 40, 128, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b2_kernel_matches_plain(dev, dtype, h):
    """B2's fused output on B1's grid (a ragged last block column, the block
    row without entries with its padding tile, ragged H) against the plain
    per-tile parts merged by block row."""
    rng = np.random.default_rng(h + 7)
    m = sp.random(300, 270, density=0.05, random_state=rng, format="coo",
                  data_rvs=rng.standard_normal, dtype=np.float32)
    keep = m.row // 128 != 1
    m = sp.coo_matrix((m.data[keep], (m.row[keep], m.col[keep])), shape=m.shape)
    b = _build_bcsr(m, (128, 128))
    b = dataclasses.replace(b, data=b.data.to(dtype)).to(dev)
    x = torch.from_numpy(rng.standard_normal((270, h)).astype(np.float32)).to(dev)
    before = (b1.launches, b1.stream_launches)
    got = b1.bcsr_spmm_stream(b, x, n_rows=300)
    torch.cuda.synchronize()
    assert (b1.launches, b1.stream_launches) == (before[0], before[1] + 1)
    assert got.shape == (300, h)
    ref = b1.sum_by_block_row(b1.bcsr_spmm_stream_plain(b, x), b, 300)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    assert not got[128:256].any()


@pytest.mark.parametrize("h", [1, 40, 128, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["B1", "B2"])
def test_long_row_kernels_match_plain(dev, kernel, dtype, h):
    """B1 (split rows, summed in item order by the last CTA to arrive) and
    B2 on rows of 0, 1, C, C + 1 and 43 tiles (C = ``MAX_TILES``), a ragged
    last block row and column, the row without tiles without a padding tile."""
    b, n_rows, n_cols = long_row_tiles(b1.MAX_TILES, np.random.default_rng(h), dtype)
    b = b.to(dev)
    x = torch.randn(n_cols, h, device=dev, generator=torch.Generator(dev).manual_seed(h))
    fn = b1.bcsr_spmm_cuda if kernel == "B1" else b1.bcsr_spmm_stream_cuda
    got = fn(b, x, n_rows=n_rows)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, b1.bcsr_spmm_plain(b, x, n_rows=n_rows), rtol=1e-4,
                               atol=1e-4)
    assert not got[:128].any()


@pytest.mark.parametrize("h", [1, 40, 128, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_b1_is_bitwise_deterministic(dev, dtype, h):
    """Two launches of B1 give the same bits, split rows included; the
    arrival counters are back at zero after each."""
    b, n_rows, n_cols = long_row_tiles(b1.MAX_TILES, np.random.default_rng(h + 1), dtype)
    b = b.to(dev)
    x = torch.randn(n_cols, h, device=dev, generator=torch.Generator(dev).manual_seed(h))
    first = b1.bcsr_spmm_cuda(b, x, n_rows=n_rows)
    second = b1.bcsr_spmm_cuda(b, x, n_rows=n_rows)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    ((sched, counters),) = b.cache.values()
    assert sched.n_slots > 0 and not counters.any()


def test_b1_gradient_on_asymmetric_graph(dev):
    from pygcn_tpu_torch.ops.spmm import spmm

    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 300, 3000), rng.integers(0, 300, 3000)
    g = Graph.from_coo(src, dst, rng.standard_normal(3000).astype(np.float32), n_nodes=300,
                       build_dense=False, build_bcsr=True, build_ell=False,
                       build_hybrid=False).to(dev)
    x = torch.randn(300, 40, device=dev, requires_grad=True)
    cot = torch.randn(300, 40, device=dev)
    (dx,) = torch.autograd.grad(spmm(g, x, impl="bcsr"), x, cot)
    torch.testing.assert_close(dx, b1.bcsr_spmm_plain(g.bcsr_t, cot, n_rows=300),
                               rtol=1e-4, atol=1e-4)


def gat_tiles(symmetric, dtype, drop_padding, seed=0, density=0.05):
    """Ragged 300-node tile sets whose block row 1 has no edge (with or
    without the builder's zero padding tile) and their exact transpose; the
    symmetric set's transpose has that empty block row too."""
    rng = np.random.default_rng(seed)
    m = sp.random(300, 300, density=density, random_state=rng, format="coo", dtype=np.float32)
    keep = (m.row // 128 != 1) & ((m.col // 128 != 1) | (not symmetric))
    m = sp.coo_matrix((np.ones(int(keep.sum()), np.float32), (m.row[keep], m.col[keep])),
                      shape=m.shape)
    if symmetric:
        m = m.maximum(m.T).tocoo()
    b = _build_bcsr(m, (128, 128))
    bt = gta.transpose_bcsr(b)
    if drop_padding:
        b, bt = drop_zero_tiles(b), drop_zero_tiles(bt)
    return (dataclasses.replace(b, data=b.data.to(dtype)),
            dataclasses.replace(bt, data=bt.data.to(dtype)))


GAT_SHAPES = [(2, 4), (8, 8), (4, 16), (1, 40), (3, 5)]


@pytest.mark.parametrize("hf", GAT_SHAPES, ids=lambda x: f"{x[0]}x{x[1]}")
@pytest.mark.parametrize("drop_padding", [False, True], ids=["padding_tile", "no_tile"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("symmetric", [False, True], ids=["asym", "sym"])
def test_gat_tile_kernels_match_plain(dev, symmetric, dtype, drop_padding, hf):
    h, f = hf
    b, bt = (x.to(dev) for x in gat_tiles(symmetric, dtype, drop_padding))
    gen = torch.Generator(device=dev).manual_seed(h * 100 + f)
    lsrc, ldst = (torch.randn(300, h, device=dev, generator=gen) for _ in range(2))
    s2 = torch.randn(300, h * f, device=dev, generator=gen)
    dnum = torch.randn(300, h * f, device=dev, generator=gen)
    dden = torch.randn(300, h, device=dev, generator=gen)
    before = dict(gta.launches)
    got = gta.tile_fwd(b, lsrc, ldst, s2, h, f, 0.2)
    ref = gta.tile_fwd_plain(b, lsrc, ldst, s2, h, f, 0.2)
    m = ref[2]
    got_dl = gta.tile_bwd_dldst(b, lsrc, ldst, s2, m, dnum, dden, h, f, 0.2)
    ref_dl = gta.tile_bwd_dldst_plain(b, lsrc, ldst, s2, m, dnum, dden, h, f, 0.2)
    got_snd = gta.tile_bwd_sender(bt, lsrc, ldst, s2, m, dnum, dden, h, f, 0.2)
    ref_snd = gta.tile_bwd_sender_plain(bt, lsrc, ldst, s2, m, dnum, dden, h, f, 0.2)
    torch.cuda.synchronize()
    assert gta.launches == {k: before[k] + (k in ("B3", "B5", "B6")) for k in before}
    for a, r in zip((*got, got_dl, *got_snd), (*ref, ref_dl, *ref_snd)):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4)
    assert (got[2][128:256] == gta.NEG).all() and not got[1][128:256].any()
    assert not got_dl[128:256].any()
    if symmetric:
        assert not got_snd[0][128:256].any() and not got_snd[1][128:256].any()


@pytest.mark.parametrize("hf", GAT_SHAPES, ids=lambda x: f"{x[0]}x{x[1]}")
@pytest.mark.parametrize("drop_padding", [False, True], ids=["padding_tile", "no_tile"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("symmetric", [False, True], ids=["asym", "sym"])
def test_gat_stream_kernels_match_plain(dev, symmetric, dtype, drop_padding, hf):
    """B4, B5s and B6s (their merges fused) against their merged plain
    versions, on the grid of the revisit kernels' test; B4's ``m`` bit for
    bit, the block row without edges ``NEG``/0 (and no ``dldst``)."""
    h, f = hf
    b, bt = (x.to(dev) for x in gat_tiles(symmetric, dtype, drop_padding))
    gen = torch.Generator(device=dev).manual_seed(h * 100 + f + 1)
    lsrc, ldst = (torch.randn(300, h, device=dev, generator=gen) for _ in range(2))
    s2 = torch.randn(300, h * f, device=dev, generator=gen)
    dnum = torch.randn(300, h * f, device=dev, generator=gen)
    dden = torch.randn(300, h, device=dev, generator=gen)
    before = dict(gta.launches)
    got = gta.tile_fwd_stream(b, lsrc, ldst, s2, h, f, 0.2)
    ref = gta.tile_fwd_plain(b, lsrc, ldst, s2, h, f, 0.2)
    m = ref[2]
    args = (lsrc, ldst, s2, m, dnum, dden, h, f, 0.2)
    got_dl = gta.tile_bwd_dldst_stream(b, *args)
    ref_dl = gta.tile_bwd_dldst_plain(b, *args)
    got_snd = gta.tile_bwd_sender_stream(bt, *args)
    ref_snd = gta.tile_bwd_sender_plain(bt, *args)
    torch.cuda.synchronize()
    assert gta.launches == {k: before[k] + (k in ("B4", "B5s", "B6s")) for k in before}
    for a, r in zip((*got, got_dl, *got_snd), (*ref, ref_dl, *ref_snd)):
        assert a.shape == r.shape
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4)
    assert torch.equal(got[2], m)
    assert (got[2][128:256] == gta.NEG).all() and not got[0][128:256].any()
    assert not got[1][128:256].any() and not got_dl[128:256].any()
    if symmetric:
        assert not got_snd[0][128:256].any() and not got_snd[1][128:256].any()


def test_gat_tile_kernels_leaky_derivative_at_zero(dev):
    """Integer logits put many pre-activations at exactly 0, where the
    kernels' leaky' must be 1, as in the plain versions (and JAX)."""
    b, bt = (x.to(dev) for x in gat_tiles(False, torch.float32, False, seed=3))
    gen = torch.Generator(device=dev).manual_seed(3)
    lsrc, ldst = (torch.randint(-1, 2, (300, 2), device=dev, generator=gen).float()
                  for _ in range(2))
    s2, dnum = (torch.randn(300, 8, device=dev, generator=gen) for _ in range(2))
    dden = torch.randn(300, 2, device=dev, generator=gen)
    m = gta.tile_fwd_plain(b, lsrc, ldst, s2, 2, 4, 0.2)[2]
    args = (lsrc, ldst, s2, m, dnum, dden, 2, 4, 0.2)
    got = (gta.tile_bwd_dldst(b, *args), *gta.tile_bwd_sender(bt, *args))
    ref = (gta.tile_bwd_dldst_plain(b, *args), *gta.tile_bwd_sender_plain(bt, *args))
    torch.cuda.synchronize()
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4)


def v2_operands(dev, h, f, seed, integer=False, scale_a=False):
    """``sl2``, ``sr2``, ``a``, then ``dnum`` and ``dden`` on the card;
    ``integer`` puts many pre-activations ``sl + sr`` at exactly 0. ``a`` is
    scaled by 1/sqrt(F) above F = 64, or with ``scale_a`` at any F."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    if integer:
        sl2, sr2 = (torch.randint(-1, 2, (300, h * f), device=dev, generator=gen).float()
                    for _ in range(2))
    else:
        sl2, sr2 = (torch.randn(300, h * f, device=dev, generator=gen) for _ in range(2))
    a = torch.randn(h, f, device=dev, generator=gen)
    if f > 64 or scale_a:
        a = a / f ** 0.5  # a for fan-in F: logits of unit scale however wide the head
    return sl2, sr2, a, torch.randn(300, h * f, device=dev, generator=gen), \
        torch.randn(300, h, device=dev, generator=gen)


def v2_kernel_and_plain(name, b, bt, ops, m, h, f):
    """The outputs of kernel ``name`` (through its dispatcher, on CUDA
    tensors; ``B7c``: B7 on its chunked kernel) and of its plain version on
    the same operands."""
    sl2, sr2, a, dnum, dden = ops
    if name in ("B7", "B7c"):
        args = (sl2, sr2, a, h, f, 0.2)
        kernel = gta.tile_v2_fwd_cuda(b, *args, chunked=True) if name == "B7c" else \
            gta.tile_v2_fwd(b, *args)
        return kernel, gta.tile_v2_fwd_plain(b, *args)
    args = (sl2, sr2, a, m, dnum, dden, h, f, 0.2)
    if name == "B8":
        return gta.tile_v2_bwd_recv(b, *args), gta.tile_v2_bwd_recv_plain(b, *args)
    return (gta.tile_v2_bwd_send(bt, *args),), (gta.tile_v2_bwd_send_plain(bt, *args),)


@pytest.mark.parametrize("hf", GAT_SHAPES + [(2, 48), (1, 64), (1, 160), (1, 224)],
                         ids=lambda x: f"{x[0]}x{x[1]}")
@pytest.mark.parametrize("drop_padding", [False, True], ids=["padding_tile", "no_tile"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("symmetric", [False, True], ids=["asym", "sym"])
@pytest.mark.parametrize("name", ["B7", "B8", "B9", "B7c"])
def test_gatv2_tile_kernel_matches_plain(dev, name, symmetric, dtype, drop_padding, hf):
    """Each GATv2 tile kernel on the grid of the v1 kernels' test, plus wider
    heads: 2x48 and 1x64 (B8 and B9 on their chunked kernels, 2x48 with a
    ragged chunk; B7 on its shared-memory one), 1x160 (B8 and B9 past the
    width whose whole rows would fit an H100's shared memory) and 1x224 (B7
    past it too: its chunked kernel). ``B7c`` is B7's chunked kernel at every
    width."""
    h, f = hf
    b, bt = (x.to(dev) for x in gat_tiles(symmetric, dtype, drop_padding))
    ops = v2_operands(dev, h, f, h * 100 + f)
    m = gta.tile_v2_fwd_plain(b, *ops[:3], h, f, 0.2)[2]
    before = dict(gta.launches)
    got, ref = v2_kernel_and_plain(name, b, bt, ops, m, h, f)
    torch.cuda.synchronize()
    assert gta.launches == {k: before[k] + (k == name[:2]) for k in before}
    for x, r in zip(got, ref):
        torch.testing.assert_close(x, r, rtol=1e-4, atol=1e-4)
    if name in ("B7", "B7c"):
        assert (got[2][128:256] == gta.NEG).all() and not got[0][128:256].any()
        assert not got[1][128:256].any()
    elif name == "B8" or symmetric:
        assert not got[0][128:256].any()


@pytest.mark.parametrize("hf", [(2, 48), (1, 64), (8, 128), (1, 160), (1, 224)],
                         ids=lambda x: f"{x[0]}x{x[1]}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("symmetric", [False, True], ids=["asym", "sym"])
@pytest.mark.parametrize("name", ["B7", "B8", "B9", "B7c"])
def test_gatv2_tile_kernel_on_dense_rows(dev, name, symmetric, dtype, hf):
    """The chunked kernels on rows of more own edges in one work item than a
    batch holds (``gta.CHUNK_EDGES``): the 300-node sets at density 0.35, up to
    114 edges a row in an item, walked in up to four batches, each after the
    first reading back what the earlier ones wrote (B8's and B9's partial
    gradients, B7's running max, sum and num). ``a`` is scaled by 1/sqrt(F).
    Each output against its plain version within 1e-4, but B8's ``dapart``,
    per receiver a sum of up to 114 edges' products that reaches hundreds
    and cancels, whose f32 plain version already lies up to 0.7 of that
    tolerance from the f64 one: it is held against the plain version in f64,
    within 1e-4 of the largest value and within 4x the f32 plain version's
    error."""
    h, f = hf
    b, bt = gat_tiles(symmetric, dtype, True, density=0.35)
    assert min(gta.most_own_edges(b), gta.most_own_edges(bt)) > 2 * gta.CHUNK_EDGES
    b, bt = b.to(dev), bt.to(dev)
    ops = v2_operands(dev, h, f, h * 10 + f, scale_a=True)
    m = gta.tile_v2_fwd_plain(b, *ops[:3], h, f, 0.2)[2]
    before = dict(gta.launches)
    got, ref = v2_kernel_and_plain(name, b, bt, ops, m, h, f)
    torch.cuda.synchronize()
    assert gta.launches == {k: before[k] + (k == name[:2]) for k in before}
    for i, (x, r) in enumerate(zip(got, ref)):
        assert x.shape == r.shape and torch.isfinite(x).all()
        if name == "B8" and i == 1:
            args = [o.double() for o in (*ops[:3], m, *ops[3:])]
            r64 = gta.tile_v2_bwd_recv_plain(b, *args, h, f, 0.2)[1]
            scale = float(r64.abs().max())
            err_k, err_p = (float((y.double() - r64).abs().max()) for y in (x, r))
            assert err_k <= 1e-4 * scale and err_k <= 4 * max(err_p, 1e-7 * scale), (err_k, err_p)
        else:
            torch.testing.assert_close(x, r, rtol=1e-4, atol=1e-4)
    if name in ("B7", "B7c"):
        assert (got[2][128:256] == gta.NEG).all() and not got[0][128:256].any()


def test_gatv2_tile_kernels_leaky_derivative_at_zero(dev):
    """Integer operands put many pre-activations at exactly 0, where the
    kernels' leaky' must be 1, as in the plain versions (and JAX)."""
    b, bt = (x.to(dev) for x in gat_tiles(False, torch.float32, False, seed=3))
    ops = v2_operands(dev, 2, 4, 3, integer=True)
    m = gta.tile_v2_fwd_plain(b, *ops[:3], 2, 4, 0.2)[2]
    for name in ("B8", "B9"):
        got, ref = v2_kernel_and_plain(name, b, bt, ops, m, 2, 4)
        torch.cuda.synchronize()
        for x, r in zip(got, ref):
            torch.testing.assert_close(x, r, rtol=1e-4, atol=1e-4)


WIDE_SHAPES = [(2, 65), (1, 128)]


@pytest.mark.parametrize("hf", WIDE_SHAPES, ids=lambda x: f"{x[0]}x{x[1]}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("symmetric", [False, True], ids=["asym", "sym"])
@pytest.mark.parametrize("family", ["B3/B5/B6", "B4/B5s/B6s", "B7/B8/B9"])
def test_gat_tile_kernels_wide_heads(dev, family, symmetric, dtype, hf):
    """Every GAT tile kernel at per-head widths above 64 (one full 64-column
    slab and a ragged one, or two full ones) against its plain version (B4,
    B5s and B6s, whose merges are fused, against the merged ones); each
    launch is counted."""
    h, f = hf
    b, bt = (x.to(dev) for x in gat_tiles(symmetric, dtype, True))
    gen = torch.Generator(device=dev).manual_seed(h * 1000 + f)
    if family == "B7/B8/B9":
        ops = v2_operands(dev, h, f, h * 1000 + f)
        m = gta.tile_v2_fwd_plain(b, *ops[:3], h, f, 0.2)[2]
        pairs = [v2_kernel_and_plain(name, b, bt, ops, m, h, f) for name in ("B7", "B8", "B9")]
        names = ("B7", "B8", "B9")
    else:
        lsrc, ldst = (torch.randn(300, h, device=dev, generator=gen) for _ in range(2))
        s2, dnum = (torch.randn(300, h * f, device=dev, generator=gen) for _ in range(2))
        dden = torch.randn(300, h, device=dev, generator=gen)
        stream = family == "B4/B5s/B6s"
        fwd = (gta.tile_fwd_stream if stream else gta.tile_fwd, gta.tile_fwd_plain)
        before = dict(gta.launches)
        m = gta.tile_fwd_plain(b, lsrc, ldst, s2, h, f, 0.2)[2]
        args = (lsrc, ldst, s2, m, dnum, dden, h, f, 0.2)
        dl = (gta.tile_bwd_dldst_stream if stream else gta.tile_bwd_dldst,
              gta.tile_bwd_dldst_plain)
        snd = (gta.tile_bwd_sender_stream if stream else gta.tile_bwd_sender,
               gta.tile_bwd_sender_plain)
        pairs = [(fwd[0](b, *args[:3], h, f, 0.2), fwd[1](b, *args[:3], h, f, 0.2)),
                 ((dl[0](b, *args),), (dl[1](b, *args),)),
                 (snd[0](bt, *args), snd[1](bt, *args))]
        names = ("B4", "B5s", "B6s") if stream else ("B3", "B5", "B6")
        assert gta.launches == {k: before[k] + (k in names) for k in before}
    torch.cuda.synchronize()
    for name, (got, ref) in zip(names, pairs):
        for x, r in zip(got, ref):
            assert x.shape == r.shape, name
            torch.testing.assert_close(x, r, rtol=1e-4, atol=1e-4, msg=name)


@pytest.mark.parametrize("v2", [False, True], ids=["gat", "gatv2"])
def test_tile_partials_at_8_heads_of_128(dev, v2):
    """``GATTilePartials``/``GATv2TilePartials`` at the CLI's default width
    (8 heads of 128): values and gradients against the plain versions."""
    h, f = 8, 128
    b, bt = (x.to(dev) for x in gat_tiles(True, torch.float32, False))
    gen = torch.Generator(device=dev).manual_seed(8128 + v2)
    if v2:
        shapes = ((300, h * f), (300, h * f), (h, f))
    else:
        shapes = ((300, h), (300, h), (300, h * f))
    ops = [torch.randn(*s, device=dev, generator=gen) for s in shapes]
    if v2:
        ops[2] = ops[2] / f ** 0.5  # a for fan-in F: logits of unit scale
    cot = [torch.randn(300, w, device=dev, generator=gen) for w in (h * f, h)]
    args = [o.clone().requires_grad_(True) for o in ops]
    partials = gta.gatv2_tile_partials if v2 else gta.gat_tile_partials
    got = partials((h, f, 0.2), b, bt, *args)
    grads = torch.autograd.grad(got[:2], args, cot)
    ref = (gta.tile_v2_fwd_plain if v2 else gta.tile_fwd_plain)(b, *ops, h, f, 0.2)
    bwd = (*ops, ref[2], *cot, h, f, 0.2)
    if v2:
        dsr, dapart = gta.tile_v2_bwd_recv_plain(b, *bwd)
        ref_grads = (gta.tile_v2_bwd_send_plain(bt, *bwd), dsr, dapart.sum(dim=0).view(h, f))
    else:
        ds, dlsrc = gta.tile_bwd_sender_plain(bt, *bwd)
        ref_grads = (dlsrc, gta.tile_bwd_dldst_plain(b, *bwd), ds)
    torch.cuda.synchronize()
    for x, r in list(zip(got, ref)) + list(zip(grads, ref_grads)):
        torch.testing.assert_close(x.detach(), r, rtol=1e-4, atol=1e-4)


def v2_plain_partials_and_grads(b, bt, ops, cot, h, f):
    """``num, den, m, dsl, dsr, da`` of the plain GATv2 versions, in the
    dtype of ``ops``."""
    num, den, m = gta.tile_v2_fwd_plain(b, *ops, h, f, 0.2)
    bwd = (*ops, m, *cot, h, f, 0.2)
    dsr, dapart = gta.tile_v2_bwd_recv_plain(b, *bwd)
    return [num, den, m, gta.tile_v2_bwd_send_plain(bt, *bwd), dsr, dapart.sum(dim=0).view(h, f)]


@pytest.mark.parametrize("hf", [(1, 128), (8, 128)], ids=["1x128", "8x128"])
def test_gatv2_partials_at_unit_a_err_like_plain_f32(dev, hf):
    """At 128-wide heads and ``a`` of unit scale (logits of tens, gradients of
    hundreds) the kernels and the f32 plain versions part by more than 1e-4
    in a few values. Against the plain versions in f64 on the same inputs,
    each stays within 1e-4 of the largest value, and the kernels' error within
    4x the f32 plain version's: f32 rounding of the same order."""
    h, f = hf
    b, bt = (x.to(dev) for x in gat_tiles(False, torch.float32, True))
    gen = torch.Generator(device=dev).manual_seed(7 + h)
    ops = [torch.randn(*s, device=dev, generator=gen)
           for s in ((300, h * f), (300, h * f), (h, f))]
    cot = [torch.randn(300, w, device=dev, generator=gen) for w in (h * f, h)]
    args = [o.clone().requires_grad_(True) for o in ops]
    out = gta.gatv2_tile_partials((h, f, 0.2), b, bt, *args)
    got = [o.detach() for o in out] + list(torch.autograd.grad(out[:2], args, cot))
    p32 = v2_plain_partials_and_grads(b, bt, ops, cot, h, f)
    p64 = v2_plain_partials_and_grads(b, bt, [o.double() for o in ops],
                                      [c.double() for c in cot], h, f)
    torch.cuda.synchronize()
    live = p64[2] > gta.NEG / 2
    for i, (k, p, r) in enumerate(zip(got, p32, p64)):
        if i == 2:  # m, where a row has an edge
            k, p, r = k[live], p[live], r[live]
        scale = float(r.abs().max())
        err_k = float((k.double() - r).abs().max())
        err_p = float((p.double() - r).abs().max())
        assert err_k <= 1e-4 * scale and err_k <= 4 * max(err_p, 1e-7 * scale), (i, err_k, err_p)


def long_row_gat_tiles(dtype=torch.float32):
    """The long-row tile set (block rows of 0, 1, C, C + 1, 43 and 2 tiles at
    C = ``gta.MAX_TILES``) made square: 5631 nodes, a ragged last block."""
    from pygcn_tpu_torch.apps.time_spmm import long_row_matrix

    m = long_row_matrix(gta.MAX_TILES, np.random.default_rng(5))
    n = m.shape[1]
    m = sp.coo_matrix((np.ones(m.nnz, np.float32), (m.row, m.col)), shape=(n, n))
    b = drop_zero_tiles(_build_bcsr(m, (128, 128)))
    return dataclasses.replace(b, data=b.data.to(dtype)), n


@pytest.mark.parametrize("hf", [(8, 8), (1, 40), (2, 65)], ids=lambda x: f"{x[0]}x{x[1]}")
@pytest.mark.parametrize("name", ["B3", "B7"])
def test_b3_b7_long_rows_bitwise_and_plain(dev, name, hf):
    """B3 and B7 on split rows (the 43-tile row is 22 items): the same bits in
    two launches, the arrival counters back at zero, and the plain version's
    values within 1e-4 (``m`` too)."""
    h, f = hf
    b, n = long_row_gat_tiles()
    b = b.to(dev)
    gen = torch.Generator(device=dev).manual_seed(h + f)
    if name == "B7":
        ops = (torch.randn(n, h * f, device=dev, generator=gen),
               torch.randn(n, h * f, device=dev, generator=gen),
               torch.randn(h, f, device=dev, generator=gen))
        kernel, plain = gta.tile_v2_fwd_cuda, gta.tile_v2_fwd_plain
    else:
        ops = (torch.randn(n, h, device=dev, generator=gen),
               torch.randn(n, h, device=dev, generator=gen),
               torch.randn(n, h * f, device=dev, generator=gen))
        kernel, plain = gta.tile_fwd_cuda, gta.tile_fwd_plain
    first = kernel(b, *ops, h, f, 0.2)
    second = kernel(b, *ops, h, f, 0.2)
    ref = plain(b, *ops, h, f, 0.2)
    torch.cuda.synchronize()
    for x, y, r in zip(first, second, ref):
        assert torch.equal(x, y)
        torch.testing.assert_close(x, r, rtol=1e-4, atol=1e-4)
    assert (first[2][:128] == gta.NEG).all() and not first[0][:128].any()
    sched, counters = b.cache[("gat_tile", gta.MAX_TILES)]
    assert sched.n_slots > 0 and not counters.any()


@pytest.mark.parametrize("hf", [(8, 8), (1, 40), (2, 65), (1, 224)], ids=lambda x: f"{x[0]}x{x[1]}")
@pytest.mark.parametrize("name", ["B8", "B9"])
def test_b8_b9_long_rows_bitwise_and_plain(dev, name, hf):
    """B8 and B9 on split rows (the 43-tile row is 22 items, its partials summed
    in item order): the same bits in two launches, the arrival counters back at
    zero, the plain version's values within 1e-4, and the block row without
    tiles zero. B8 runs on B7's schedule entry of the forward tiles; B9 on one
    of its own, of the transpose tiles."""
    h, f = hf
    b, n = long_row_gat_tiles()
    bt = gta.transpose_bcsr(b)
    b, bt = b.to(dev), bt.to(dev)
    gen = torch.Generator(device=dev).manual_seed(h * 7 + f)
    sl2, sr2, dnum = (torch.randn(n, h * f, device=dev, generator=gen) for _ in range(3))
    dden = torch.randn(n, h, device=dev, generator=gen)
    a = torch.randn(h, f, device=dev, generator=gen) / (f ** 0.5 if f > 64 else 1.0)
    m = gta.tile_v2_fwd_cuda(b, sl2, sr2, a, h, f, 0.2)[2]
    bwd = (sl2, sr2, a, m, dnum, dden, h, f, 0.2)
    if name == "B8":
        kernel, plain, tiles = gta.tile_v2_bwd_recv_cuda, gta.tile_v2_bwd_recv_plain, b
    else:
        kernel, plain, tiles = gta.tile_v2_bwd_send_cuda, gta.tile_v2_bwd_send_plain, bt
    first, second = kernel(tiles, *bwd), kernel(tiles, *bwd)
    ref = plain(tiles, *bwd)
    torch.cuda.synchronize()
    first, second, ref = ((x,) if torch.is_tensor(x) else x for x in (first, second, ref))
    for x, y, r in zip(first, second, ref):
        assert torch.equal(x, y)
        torch.testing.assert_close(x, r, rtol=1e-4, atol=1e-4)
        if name == "B8":
            assert not x[:128].any()
    assert list(b.cache) == [("gat_tile", gta.MAX_TILES)]
    assert list(bt.cache) == ([("gat_tile", gta.MAX_TILES)] if name == "B9" else [])
    sched, counters = tiles.cache[("gat_tile", gta.MAX_TILES)]
    assert sched.n_slots > 0 and not counters.any()


def v1_operands(dev, n, h, f, seed):
    """GAT operands ``lsrc, ldst, s2`` and cotangents ``dnum, dden``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    lsrc, ldst = (torch.randn(n, h, device=dev, generator=gen) for _ in range(2))
    s2, dnum = (torch.randn(n, h * f, device=dev, generator=gen) for _ in range(2))
    return lsrc, ldst, s2, dnum, torch.randn(n, h, device=dev, generator=gen)


def b5_b6_runs(name, b, bt, bwd):
    """(kernel, scheduled plain, plain) of B5 over ``b`` or B6 over ``bt``,
    each returning a tuple."""
    c = gta.MAX_TILES
    if name == "B5":
        return ((lambda: (gta.tile_bwd_dldst_cuda(b, *bwd),)),
                (lambda: (gta.tile_bwd_dldst_scheduled_plain(b, *bwd, c),)),
                (lambda: (gta.tile_bwd_dldst_plain(b, *bwd),)))
    return ((lambda: gta.tile_bwd_sender_cuda(bt, *bwd)),
            (lambda: gta.tile_bwd_sender_scheduled_plain(bt, *bwd, c)),
            (lambda: gta.tile_bwd_sender_plain(bt, *bwd)))


@pytest.mark.parametrize("hf", GAT_SHAPES + [(2, 65), (1, 128), (8, 128)],
                         ids=lambda x: f"{x[0]}x{x[1]}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("symmetric", [False, True], ids=["asym", "sym"])
@pytest.mark.parametrize("name", ["B5", "B6"])
def test_b5_b6_match_scheduled_and_plain(dev, name, symmetric, dtype, hf):
    """B5 (``dldst``) and B6 (``ds``, ``dlsrc``) on their work items against
    their scheduled plain versions (the per-tile partials summed as the
    kernels sum them) and their plain versions, to 1e-4, the 8x128 of the
    CLI's default width included; each launch counted once, and the block row
    without edges zero."""
    h, f = hf
    b, bt = (x.to(dev) for x in gat_tiles(symmetric, dtype, True))
    lsrc, ldst, s2, dnum, dden = v1_operands(dev, 300, h, f, h * 10 + f)
    m = gta.tile_fwd_plain(b, lsrc, ldst, s2, h, f, 0.2)[2]
    bwd = (lsrc, ldst, s2, m, dnum, dden, h, f, 0.2)
    kernel, scheduled, plain = b5_b6_runs(name, b, bt, bwd)
    before = dict(gta.launches)
    got = kernel()
    torch.cuda.synchronize()
    assert gta.launches == {k: before[k] + (k == name) for k in before}
    for x, s_, p_ in zip(got, scheduled(), plain()):
        assert x.shape == p_.shape
        torch.testing.assert_close(x, s_, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(x, p_, rtol=1e-4, atol=1e-4)
        if name == "B5" or symmetric:
            assert not x[128:256].any()


@pytest.mark.parametrize("hf", [(8, 8), (1, 40), (2, 65), (8, 128)],
                         ids=lambda x: f"{x[0]}x{x[1]}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["B5", "B6"])
def test_b5_b6_long_rows_bitwise_and_plain(dev, name, dtype, hf):
    """B5 and B6 on split rows (the 43-tile row is 22 items, its partials
    summed in item order): the same bits in two launches, the arrival
    counters back at zero, the scheduled plain and plain versions' values
    within 1e-4, and the block row without tiles zero in ``dldst``. B5 runs
    on B3's schedule entry of the forward tiles; B6 on one of its own, of the
    transpose tiles."""
    h, f = hf
    b, n = long_row_gat_tiles(dtype)
    bt = gta.transpose_bcsr(b)
    b, bt = b.to(dev), bt.to(dev)
    lsrc, ldst, s2, dnum, dden = v1_operands(dev, n, h, f, h * 7 + f)
    m = gta.tile_fwd_cuda(b, lsrc, ldst, s2, h, f, 0.2)[2]
    bwd = (lsrc, ldst, s2, m, dnum, dden, h, f, 0.2)
    kernel, scheduled, plain = b5_b6_runs(name, b, bt, bwd)
    first, second = kernel(), kernel()
    torch.cuda.synchronize()
    for x, y, s_, p_ in zip(first, second, scheduled(), plain()):
        assert torch.equal(x, y)
        torch.testing.assert_close(x, s_, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(x, p_, rtol=1e-4, atol=1e-4)
        if name == "B5":
            assert not x[:128].any()
    key = ("gat_tile", gta.MAX_TILES)
    assert list(b.cache) == [key] and list(bt.cache) == ([key] if name == "B6" else [])
    sched, counters = (b if name == "B5" else bt).cache[key]
    assert sched.n_slots > 0 and not counters.any()


@pytest.mark.parametrize("name,h", [("B5", 230), ("B6", 80)])
def test_b5_b6_many_heads_match_plain(dev, name, h):
    """More heads than the node arrays of all heads fit in a CTA's shared
    memory (B5 above 217 heads of F <= 4, B6 above 71): the item walks its
    heads in groups, restaging between; against the scheduled plain and plain
    versions, on the long-row tile set (split rows) at one feature a head."""
    f = 1
    b, n = long_row_gat_tiles()
    bt = gta.transpose_bcsr(b)
    b, bt = b.to(dev), bt.to(dev)
    lsrc, ldst, s2, dnum, dden = v1_operands(dev, n, h, f, h)
    m = gta.tile_fwd_plain(b, lsrc, ldst, s2, h, f, 0.2)[2]
    bwd = (lsrc, ldst, s2, m, dnum, dden, h, f, 0.2)
    kernel, scheduled, plain = b5_b6_runs(name, b, bt, bwd)
    got = kernel()
    torch.cuda.synchronize()
    for x, s_, p_ in zip(got, scheduled(), plain()):
        torch.testing.assert_close(x, s_, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(x, p_, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["B5", "B6"])
def test_b5_b6_refused_launch_raises(dev, monkeypatch, name):
    """Work items of C = 200 tiles need more shared memory for their mask
    words than a CTA gets: B5 and B6 refuse the launch and raise (no plain
    fallback, no count); at C = 2 the next launch matches the plain version."""
    b, bt = (x.to(dev) for x in gat_tiles(False, torch.float32, False))
    h, f = 2, 4
    lsrc, ldst, s2, dnum, dden = v1_operands(dev, 300, h, f, 12)
    m = gta.tile_fwd_plain(b, lsrc, ldst, s2, h, f, 0.2)[2]
    bwd = (lsrc, ldst, s2, m, dnum, dden, h, f, 0.2)
    kernel, _, plain = b5_b6_runs(name, b, bt, bwd)
    before = gta.launches[name]
    monkeypatch.setattr(gta, "MAX_TILES", 200)
    with pytest.raises(RuntimeError, match=f"{name} kernel launch failed"):
        kernel()
    assert gta.launches[name] == before
    monkeypatch.setattr(gta, "MAX_TILES", 2)
    got = kernel()
    torch.cuda.synchronize()
    for x, r in zip(got, plain()):
        torch.testing.assert_close(x, r, rtol=1e-4, atol=1e-4)


def test_wide_heads_never_reach_the_plain_versions(dev, monkeypatch):
    """F > 64 on CUDA tensors (F = 96, and 224, above the widths whose whole
    rows B7 stages) launches the kernels (their counters rise) and never calls
    a plain version."""
    def refuse(*_args, **_kw):
        raise AssertionError("a plain version was called for CUDA tensors")

    for name in dir(gta):
        if name.endswith("_plain") and name.startswith("tile_"):
            monkeypatch.setattr(gta, name, refuse)
    monkeypatch.setattr(gta, "softmax_merge", refuse)
    b, bt = (x.to(dev) for x in gat_tiles(True, torch.float32, False))
    before = dict(gta.launches)
    for h, f in ((2, 96), (1, 224)):
        for v2 in (False, True):
            shapes = (((300, h * f), (300, h * f), (h, f)) if v2
                      else ((300, h), (300, h), (300, h * f)))
            args = [torch.randn(*s, device=dev).requires_grad_(True) for s in shapes]
            partials = gta.gatv2_tile_partials if v2 else gta.gat_tile_partials
            num, den, _m = partials((h, f, 0.2), b, bt, *args)
            (num.sum() + den.sum()).backward()
    torch.cuda.synchronize()
    assert {k: gta.launches[k] - before[k] for k in before} == {
        "B3": 2, "B4": 0, "B5": 2, "B5s": 0, "B6": 2, "B6s": 0, "B7": 2, "B8": 2, "B9": 2}


def test_refused_launch_leaves_no_stale_error(dev, monkeypatch):
    """A launch the card refuses raises, and the library's next launch runs:
    work items of C = 200 tiles need more shared memory for their mask words
    than a CTA gets, so B7, B8 and B9 refuse them; at C = 2 each then matches
    its plain version (a refused opt-in once stayed the runtime's last error
    and failed the next launch of the library)."""
    b, bt = (x.to(dev) for x in gat_tiles(False, torch.float32, False))
    h, f = 2, 4
    ops = v2_operands(dev, h, f, 11)
    m = gta.tile_v2_fwd_plain(b, *ops[:3], h, f, 0.2)[2]
    for name in ("B7", "B8", "B9"):
        monkeypatch.setattr(gta, "MAX_TILES", 200)
        with pytest.raises(RuntimeError, match=f"{name} kernel launch failed"):
            v2_kernel_and_plain(name, b, bt, ops, m, h, f)
        monkeypatch.setattr(gta, "MAX_TILES", 2)
        got, ref = v2_kernel_and_plain(name, b, bt, ops, m, h, f)
        torch.cuda.synchronize()
        for x, r in zip(got, ref):
            torch.testing.assert_close(x, r, rtol=1e-4, atol=1e-4)


def stream_runs(name, b, bt, ops, h, f):
    """(kernel, merged plain version) of B4 or B5s over ``b`` or B6s over
    ``bt``, each returning a tuple; B5s and B6s take the plain forward's
    ``m``."""
    lsrc, ldst, s2, dnum, dden = ops
    if name == "B4":
        return ((lambda: gta.tile_fwd_stream_cuda(b, lsrc, ldst, s2, h, f, 0.2)),
                (lambda: gta.tile_fwd_plain(b, lsrc, ldst, s2, h, f, 0.2)))
    m = gta.tile_fwd_plain(b, lsrc, ldst, s2, h, f, 0.2)[2]
    bwd = (lsrc, ldst, s2, m, dnum, dden, h, f, 0.2)
    if name == "B5s":
        return ((lambda: (gta.tile_bwd_dldst_stream_cuda(b, *bwd),)),
                (lambda: (gta.tile_bwd_dldst_plain(b, *bwd),)))
    return ((lambda: gta.tile_bwd_sender_stream_cuda(bt, *bwd)),
            (lambda: gta.tile_bwd_sender_plain(bt, *bwd)))


@pytest.mark.parametrize("hf", [(8, 8), (1, 40), (2, 65), (8, 128)],
                         ids=lambda x: f"{x[0]}x{x[1]}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["B4", "B5s", "B6s"])
def test_stream_kernels_long_rows_match_plain(dev, name, dtype, hf):
    """B4, B5s and B6s on the long-row tile set (its 43-tile block row puts 43
    CTAs' reductions onto the same 128 output rows) and its transpose: within
    1e-4 of the merged plain versions, two launches within 1e-4 of each other
    (the reductions add in no fixed order: not bitwise), B4's ``m`` bit for
    bit, the block row without tiles ``NEG``/0 (and no ``dldst``), and no
    ``bcsr.cache`` entry (no work items, no counters)."""
    h, f = hf
    b, n = long_row_gat_tiles(dtype)
    bt = gta.transpose_bcsr(b)
    b, bt = b.to(dev), bt.to(dev)
    kernel, plain = stream_runs(name, b, bt, v1_operands(dev, n, h, f, h * 11 + f), h, f)
    first, second, ref = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    for x, y, r in zip(first, second, ref):
        assert x.shape == r.shape
        torch.testing.assert_close(x, r, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(y, x, rtol=1e-4, atol=1e-4)
    if name == "B4":
        assert torch.equal(first[2], ref[2]) and torch.equal(second[2], ref[2])
        assert (first[2][:128] == gta.NEG).all()
        assert not first[0][:128].any() and not first[1][:128].any()
    if name == "B5s":
        assert not first[0][:128].any()
    assert not b.cache and not bt.cache


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("symmetric", [False, True], ids=["asym", "sym"])
@pytest.mark.parametrize("name", ["B4", "B5s", "B6s"])
def test_stream_kernels_at_8_heads_of_128(dev, name, symmetric, dtype):
    """B4, B5s and B6s at the CLI's default width, 8 heads of 128 (two
    64-column slabs a head), against their merged plain versions, on the
    tile sets without padding tiles."""
    h, f = 8, 128
    b, bt = (x.to(dev) for x in gat_tiles(symmetric, dtype, True))
    kernel, plain = stream_runs(name, b, bt, v1_operands(dev, 300, h, f, 81 + symmetric), h, f)
    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    for x, r in zip(got, ref):
        torch.testing.assert_close(x, r, rtol=1e-4, atol=1e-4)
    if name == "B4":
        assert torch.equal(got[2], ref[2])


@pytest.mark.parametrize("hf", GAT_SHAPES + [(2, 65), (8, 128)], ids=lambda x: f"{x[0]}x{x[1]}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("tiles", ["asym", "sym", "long_rows"])
def test_b5s_matches_plain_and_b5(dev, tiles, dtype, hf):
    """B5s (one CTA per tile for all heads, its rows added into a
    zero-filled ``[n, H]``) against the merged plain version and against B5
    (on work items, summed in item order), to 1e-4, on the GAT grid's tile
    sets without padding tiles and on the long-row set; two launches agree to
    1e-4 (their reductions add in no fixed order), each counted once."""
    h, f = hf
    if tiles == "long_rows":
        b, n = long_row_gat_tiles(dtype)
        b = b.to(dev)
    else:
        b, n = gat_tiles(tiles == "sym", dtype, True)[0].to(dev), 300
    lsrc, ldst, s2, dnum, dden = v1_operands(dev, n, h, f, h * 13 + f)
    m = gta.tile_fwd_plain(b, lsrc, ldst, s2, h, f, 0.2)[2]
    bwd = (lsrc, ldst, s2, m, dnum, dden, h, f, 0.2)
    before = dict(gta.launches)
    first = gta.tile_bwd_dldst_stream_cuda(b, *bwd)
    second = gta.tile_bwd_dldst_stream_cuda(b, *bwd)
    revisit = gta.tile_bwd_dldst_cuda(b, *bwd)
    torch.cuda.synchronize()
    assert {k: gta.launches[k] - before[k] for k in before} == {
        **dict.fromkeys(before, 0), "B5": 1, "B5s": 2}
    assert first.shape == (n, h)
    torch.testing.assert_close(first, gta.tile_bwd_dldst_plain(b, *bwd), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(first, revisit, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(second, first, rtol=1e-4, atol=1e-4)
    empty = 0 if tiles == "long_rows" else 128  # the block row without tiles
    assert not first[empty:empty + 128].any()


def test_b6s_many_heads_match_plain(dev):
    """More heads than B6s stages at once (the receivers' ldst, m and dden of
    all 160 heads of F = 1 outgrow a CTA's shared memory): it walks them in
    groups, restaging between; against the merged plain version."""
    h, f = 160, 1
    b, bt = (x.to(dev) for x in gat_tiles(False, torch.float32, False))
    kernel, plain = stream_runs("B6s", b, bt, v1_operands(dev, 300, h, f, 160), h, f)
    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    for x, r in zip(got, ref):
        torch.testing.assert_close(x, r, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tiles", ["asym", "long_rows"])
@pytest.mark.parametrize("h", [256, 512])
@pytest.mark.parametrize("name", ["B3", "B4", "B5s"])
def test_b3_b4_b5s_any_head_count(dev, name, h, tiles):
    """Fault C5: B3 and B4 staged every head's sender logits at once and
    refused more than about 224 (B3) or 450 (B4) heads. At 256 and 512 heads
    of F = 1 they, and B5s, walk their heads in groups, restaging between:
    each launch counts once and matches its plain version (B4's ``m`` bit for
    bit), on the small tile set and on the long-row set (B3's split rows
    merged over 512 heads)."""
    f = 1
    if tiles == "long_rows":
        b, n = long_row_gat_tiles()
        b = b.to(dev)
    else:
        b, n = gat_tiles(False, torch.float32, False)[0].to(dev), 300
    ops = v1_operands(dev, n, h, f, h + 1)
    if name == "B3":
        lsrc, ldst, s2 = ops[:3]

        def kernel():
            return gta.tile_fwd_cuda(b, lsrc, ldst, s2, h, f, 0.2)

        def plain():
            return gta.tile_fwd_plain(b, lsrc, ldst, s2, h, f, 0.2)
    else:
        kernel, plain = stream_runs(name, b, None, ops, h, f)
    before = dict(gta.launches)
    got = kernel()
    torch.cuda.synchronize()
    assert {k: gta.launches[k] - before[k] for k in before} == {
        **dict.fromkeys(before, 0), name: 1}
    ref = plain()
    for x, r in zip(got, ref):
        assert x.shape == r.shape
        torch.testing.assert_close(x, r, rtol=1e-4, atol=1e-4)
    if name == "B4":
        assert torch.equal(got[2], ref[2])


@pytest.mark.parametrize("hf", [(8, 8), (2, 96)], ids=lambda x: f"{x[0]}x{x[1]}")
def test_stream_mode_runs_no_merge(dev, monkeypatch, hf):
    """``GATTilePartials`` with ``TILE_REVISIT = False`` on CUDA tensors
    launches B4, B5s and B6s once each and never calls a plain version,
    :func:`softmax_merge` or :func:`sum_by_block_row`: all three merge in
    their kernels."""
    def refuse(*_args, **_kw):
        raise AssertionError("a plain version or merge was called for CUDA tensors")

    for name in dir(gta):
        if name.endswith("_plain") and name.startswith("tile_"):
            monkeypatch.setattr(gta, name, refuse)
    monkeypatch.setattr(gta, "softmax_merge", refuse)
    monkeypatch.setattr(gta, "sum_by_block_row", refuse)
    monkeypatch.setattr(gta, "TILE_REVISIT", False)
    h, f = hf
    b, bt = (x.to(dev) for x in gat_tiles(True, torch.float32, False))
    args = [torch.randn(300, w, device=dev).requires_grad_(True) for w in (h, h, h * f)]
    before = dict(gta.launches)
    num, den, _m = gta.gat_tile_partials((h, f, 0.2), b, bt, *args)
    (num.sum() + den.sum()).backward()
    torch.cuda.synchronize()
    assert {k: gta.launches[k] - before[k] for k in before} == {
        **dict.fromkeys(before, 0), "B4": 1, "B5s": 1, "B6s": 1}
    assert all(torch.isfinite(a.grad).all() for a in args)


# Tile shapes other than 128 x 128 (the layout's ``tile``): B1 and B2 take
# any sides that are multiples of 8, rectangular included; the GAT kernels
# square tiles whose side is a multiple of 32, 160 and 256 cut into panels.
SPMM_TILES = [(8, 8), (32, 32), (64, 64), (96, 96), (64, 128), (24, 40), (160, 160), (256, 256)]
GAT_SIDES = [32, 64, 96, 160, 256]


@pytest.mark.parametrize("h", [1, 40, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("tile", SPMM_TILES, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("kernel", ["B1", "B2"])
def test_b1_b2_any_tile_shape(dev, kernel, tile, dtype, h):
    """B1 (split rows included) and B2 on the tile shapes a layout can carry
    against the plain version: a block row without tiles gives zeros, and
    B1 gives the same bits in two launches with its counters back at zero."""
    b, n_rows, n_cols = shaped_tiles(tile, np.random.default_rng(h), dtype)
    b = b.to(dev)
    x = torch.randn(n_cols, h, device=dev, generator=torch.Generator(dev).manual_seed(h))
    fn = b1.bcsr_spmm_cuda if kernel == "B1" else b1.bcsr_spmm_stream_cuda
    before = (b1.launches, b1.stream_launches)
    got = fn(b, x, n_rows=n_rows)
    again = fn(b, x, n_rows=n_rows)
    torch.cuda.synchronize()
    assert (b1.launches, b1.stream_launches) == (
        (before[0] + 2, before[1]) if kernel == "B1" else (before[0], before[1] + 2))
    torch.testing.assert_close(got, b1.bcsr_spmm_plain(b, x, n_rows=n_rows), rtol=1e-4,
                               atol=1e-4)
    assert not got[tile[0]:2 * tile[0]].any()
    if kernel == "B1":
        assert torch.equal(got, again)
        ((sched, counters),) = b.cache.values()
        assert sched.n_slots > 0 and not counters.any()


def shaped_gat_tiles(side, dtype, seed):
    """:func:`shaped_tiles` at ``side`` (square), its exact transpose without
    padding tiles, and the node count."""
    b, n, _ = shaped_tiles((side, side), np.random.default_rng(seed), dtype, square=True)
    return b, drop_zero_tiles(gta.transpose_bcsr(b)), n


@pytest.mark.parametrize("hf", [(2, 4), (1, 40), (2, 65)], ids=lambda x: f"{x[0]}x{x[1]}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("side", GAT_SIDES)
@pytest.mark.parametrize("family", ["B3/B5/B6", "B4/B5s/B6s", "B7/B8/B9", "B7c"])
def test_gat_kernels_any_tile_side(dev, family, side, dtype, hf):
    """Every GAT kernel against its plain version at a tile side other than
    128, forward and backward: the block row without tiles gives NEG/0, and
    B4's ``m`` is the plain version's bit for bit."""
    h, f = hf
    b, bt, n = (x.to(dev) if i < 2 else x
                for i, x in enumerate(shaped_gat_tiles(side, dtype, side + h + f)))
    if family in ("B3/B5/B6", "B4/B5s/B6s"):
        lsrc, ldst, s2, dnum, dden = v1_operands(dev, n, h, f, side + f)
        stream = family == "B4/B5s/B6s"
        ref = gta.tile_fwd_plain(b, lsrc, ldst, s2, h, f, 0.2)
        got = (gta.tile_fwd_stream_cuda if stream else gta.tile_fwd_cuda)(
            b, lsrc, ldst, s2, h, f, 0.2)
        args = (lsrc, ldst, s2, ref[2], dnum, dden, h, f, 0.2)
        got += ((gta.tile_bwd_dldst_stream_cuda if stream else gta.tile_bwd_dldst_cuda)(b, *args),
                *(gta.tile_bwd_sender_stream_cuda if stream else gta.tile_bwd_sender_cuda)(
                    bt, *args))
        ref += (gta.tile_bwd_dldst_plain(b, *args), *gta.tile_bwd_sender_plain(bt, *args))
        if stream:
            assert torch.equal(got[2], ref[2])
    else:
        gen = torch.Generator(device=dev).manual_seed(side + f)
        sl2, sr2 = (torch.randn(n, h * f, device=dev, generator=gen) for _ in range(2))
        a = torch.randn(h, f, device=dev, generator=gen) / f ** 0.5
        dnum = torch.randn(n, h * f, device=dev, generator=gen)
        dden = torch.randn(n, h, device=dev, generator=gen)
        ref = gta.tile_v2_fwd_plain(b, sl2, sr2, a, h, f, 0.2)
        got = gta.tile_v2_fwd_cuda(b, sl2, sr2, a, h, f, 0.2, chunked=family == "B7c")
        if family == "B7/B8/B9":
            args = (sl2, sr2, a, ref[2], dnum, dden, h, f, 0.2)
            got += (*gta.tile_v2_bwd_recv_cuda(b, *args), gta.tile_v2_bwd_send_cuda(bt, *args))
            ref += (*gta.tile_v2_bwd_recv_plain(b, *args), gta.tile_v2_bwd_send_plain(bt, *args))
    torch.cuda.synchronize()
    for x, r in zip(got, ref):
        assert x.shape == r.shape
        torch.testing.assert_close(x, r, rtol=1e-4, atol=1e-4)
    empty = slice(side, 2 * side)  # block row 1 has no tile
    assert (got[2][empty] == gta.NEG).all() and not got[0][empty].any()
    assert not got[1][empty].any()


@pytest.mark.parametrize("tile", [(12, 16), (8, 4)], ids=lambda t: f"{t[0]}x{t[1]}")
def test_b1_refuses_sides_off_the_rule(dev, tile):
    b, n_rows, n_cols = shaped_tiles(tile, np.random.default_rng(0))
    b = b.to(dev)
    with pytest.raises(ValueError, match="multiples of 8"):
        b1.bcsr_spmm_cuda(b, torch.ones(n_cols, 4, device=dev), n_rows=n_rows)


@pytest.mark.parametrize("tile", [(64, 128), (48, 48), (16, 16)], ids=lambda t: f"{t[0]}x{t[1]}")
def test_gat_kernels_refuse_tiles_off_the_rule(dev, tile):
    b, n, _ = shaped_tiles(tile, np.random.default_rng(0))
    b = b.to(dev)
    ops = v1_operands(dev, n, 2, 4, 0)
    with pytest.raises(ValueError, match="multiple of 32"):
        gta.tile_fwd_cuda(b, *ops[:3], 2, 4, 0.2)


def test_b1_on_the_evaluators_nearly_dense_tiles(dev):
    """B1 at the evaluator's shape: a symmetric 2943-node matrix about 35%
    full (every one of its 23 x 23 tiles present) times ``[2943, 640]`` (a
    batch of 20 samples of 32 columns, folded), against the plain version
    and bit for bit across two launches."""
    rng = np.random.default_rng(13)
    m = sp.random(2943, 2943, density=0.2, random_state=rng, format="coo",
                  data_rvs=lambda k: rng.uniform(size=k), dtype=np.float32)
    m = m.maximum(m.T).tocoo()
    b = _build_bcsr(m, (128, 128)).to(dev)
    assert b.data.shape[0] == 23 * 23
    x = torch.from_numpy(rng.standard_normal((2943, 640)).astype(np.float32)).to(dev)
    before = b1.launches
    got, again = (b1.bcsr_spmm(b, x, n_rows=2943) for _ in range(2))
    torch.cuda.synchronize()
    assert b1.launches == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, b1.bcsr_spmm_plain(b, x, n_rows=2943), rtol=1e-4, atol=1e-4)


def test_evaluator_bcsr_step_matches_dense(dev):
    """The evaluator with ``impl="bcsr"`` (kernel B1 on the co-visitation
    graph's tiles, six launches a step) against ``impl="dense"`` (cuBLAS):
    outputs, gradients and the weights after one Adam step."""
    from pygcn_tpu_torch.apps import train_evaluator as tev
    from pygcn_tpu_torch.apps.common import build_synthetic_world
    from pygcn_tpu_torch.train.optim import adam_l2

    world = build_synthetic_world(n_cbgs=600, n_pois=60, hours=24, seed=3, device=dev)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((8, 600, 17)).astype(np.float32)
    x[:, :, -1] = rng.uniform(size=(8, 600)) < 0.02
    bx = torch.from_numpy(x).to(dev)
    by = torch.from_numpy(rng.standard_normal(8).astype(np.float32)).to(dev)
    models, grads = {}, {}
    for impl in ("dense", "bcsr"):
        model = tev.make_model(16, 17, 32, 0, impl=impl, device=dev)
        out = model(bx, world.graph)
        opt = adam_l2(model.parameters(), 0.01, 5e-4, grad_clip_norm=0.1)
        before = b1.launches
        tev.make_train_step(model, opt, world.graph)(bx, by)
        torch.cuda.synchronize()
        assert b1.launches - before == (6 if impl == "bcsr" else 0)
        models[impl], grads[impl] = (out, model), {k: p.grad for k, p in model.named_parameters()}
    torch.testing.assert_close(models["bcsr"][0], models["dense"][0], rtol=1e-4, atol=1e-4)
    for k, g in grads["dense"].items():
        torch.testing.assert_close(grads["bcsr"][k], g, rtol=1e-4, atol=1e-4, msg=k)
    for (k, p), (_, q) in zip(models["dense"][1].named_parameters(),
                              models["bcsr"][1].named_parameters()):
        torch.testing.assert_close(q, p, rtol=1e-4, atol=1e-4, msg=k)


def _colpanel_graph():
    """An asymmetric 3000-node graph in three 1024-node sender panels with
    every layout of queue A item 5: the column panels (row 0 receives 700
    edges from panel 0, so the widest bucket repeats it), the panels, and
    the hybrid with a column-panel residual; edges distinct and weighted
    (the attention's checks hold)."""
    from pygcn_tpu_torch.ops.gat_colpanel import check_gat_colpanel

    rng = np.random.default_rng(21)
    n = 3000
    src, dst = rng.integers(0, n, 30000), rng.integers(1, n, 30000)
    near = rng.integers(0, 64, 20000)  # tile-dense stretches for the hybrid
    src = np.concatenate([src, (near * 40) % n, np.arange(700)])
    dst = np.concatenate([dst, (near * 40 + rng.integers(0, 64, 20000)) % n,
                          np.zeros(700, np.int64)])
    src, dst = np.unique(np.stack([src, dst]), axis=1)
    w = rng.uniform(0.1, 1.0, src.size).astype(np.float32)
    g = Graph.from_coo(src, dst, w, n_nodes=n, build_dense=False, build_bcsr=False,
                       build_ell=False, build_hybrid=True, hybrid_residual="colpanel",
                       hybrid_min_edges_per_tile=32, build_panel=True, build_colpanel=True,
                       panel_width=1024)
    assert any(m is not None for p in g.colpanel.panels for m in p.merge)
    assert 0 < g.hybrid.tile_edges < g.n_edges
    check_gat_colpanel(g)
    return g


@pytest.mark.parametrize("impl", ["colpanel", "panel", "hybrid"])
def test_colpanel_spmm_on_the_card_matches_the_cpu(dev, impl):
    """``spmm``/``spmm_t`` and the gradient on the card against the same
    calls on the CPU (1e-4), with the same bits on a second call; the
    hybrid launches B1 once a product, as a kernel, and the column panels
    and the hybrid's column-panel residual launch E2 once a product."""
    from pygcn_tpu_torch.ops.spmm import spmm, spmm_t

    g = _colpanel_graph()
    rng = np.random.default_rng(22)
    x = torch.from_numpy(rng.standard_normal((g.n_nodes, 64)).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((g.n_nodes, 64)).astype(np.float32))

    def run(graph, x, cot):
        xx = x.clone().requires_grad_()
        y = spmm(graph, xx, impl=impl)
        (dx,) = torch.autograd.grad(y, xx, cot)
        return y.detach(), dx, spmm_t(graph, x, impl=impl)

    from pygcn_tpu_torch.ops.cuda import colpanel_spmm as e2

    want = run(g, x, cot)
    gd, xd, cd = g.to(dev), x.to(dev), cot.to(dev)
    before, e2_before = b1.launches, e2.launches
    got, again = run(gd, xd, cd), run(gd, xd, cd)
    torch.cuda.synchronize()
    assert b1.launches - before == (6 if impl == "hybrid" else 0)
    # the column panels and the hybrid's column-panel residual run E2
    assert e2.launches - e2_before == (0 if impl == "panel" else 6)
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        torch.testing.assert_close(a.cpu(), w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
def test_colpanel_attention_on_the_card_matches_the_cpu(dev, v2):
    """``gat_conv_colpanel``/``gatv2_conv_colpanel`` at 4 heads of 8 on the
    card against the CPU, output and gradients (1e-4); the output's bits
    repeat on a second call (the gradients add sender terms by atomics)."""
    from pygcn_tpu_torch.ops.gat_colpanel import gat_conv_colpanel, gatv2_conv_colpanel

    g = _colpanel_graph()
    rng = np.random.default_rng(23)
    n, h, f = g.n_nodes, 4, 8
    args = [rng.standard_normal(s).astype(np.float32) * c
            for s, c in (((n, h, f), 1.0), ((n, h, f) if v2 else (h, f), 1.0 if v2 else 0.3),
                         ((h, f), 0.3))]
    cot = torch.from_numpy(rng.standard_normal((n, h, f)).astype(np.float32))
    conv = gatv2_conv_colpanel if v2 else gat_conv_colpanel

    def run(graph, device):
        t = [torch.from_numpy(a).to(device).requires_grad_() for a in args]
        y = conv(graph, *t, 0.2)
        return [y.detach()] + list(torch.autograd.grad(y, t, cot.to(device)))

    want = run(g, "cpu")
    gd = g.to(dev)
    got, again = run(gd, dev), run(gd, dev)
    torch.cuda.synchronize()
    assert torch.equal(got[0], again[0])
    for a, w in zip(got, want):
        torch.testing.assert_close(a.cpu(), w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("model", ["gcn", "gat", "gatv2"])
def test_sampled_step_on_the_card_matches_the_cpu(dev, model):
    """``apps/train_sampled.train_step`` (feature gather, the sampled
    forward, backward, the CLI's Adam) on one batch of a 2000-node SBM
    graph, fanouts [5, 5], on the card against the CPU from the same blocks
    and weights: the loss, the logits and the gradients within 1e-4, and
    the updated parameters where the CPU's gradient is at least 1e-6 (Adam
    moves an entry whose gradient is near its eps = 1e-8 by up to lr on its
    rounding alone: ``chip_smoke.GRAD_FLOOR``)."""
    from pygcn_tpu_torch.apps import train_sampled as tapp
    from pygcn_tpu_torch.ops.sampling import NeighborSampler

    args = tapp.parse_args(["--device", "cpu", "--n_nodes", "2000", "--fanouts", "5", "5",
                            "--batch_size", "128", "--model", model, "--gat_heads", "2",
                            "--hidden", "8"])
    prep = tapp.prepare(args, torch.device("cpu"))
    seeds = prep.data.idx_train[:128]
    batch = NeighborSampler(prep.adj, args.fanouts, seed=0).sample(seeds)
    y = torch.from_numpy(prep.labels[seeds])
    idx = torch.from_numpy(batch.input_nodes)
    runs = []
    for device in ("cpu", dev):
        net = tapp.build_model(args, prep.data.n_classes).to(device)
        opt = tapp.adam_l2(net.parameters(), args.lr)
        blocks = [b.to(device) for b in batch.blocks]
        x_in = prep.x_full.to(device).index_select(0, idx.to(device))
        with torch.no_grad():
            logits = net(blocks, x_in)
        loss = tapp.train_step(net, opt, blocks, x_in, y.to(device))
        params = list(net.parameters())
        runs.append(([loss, logits], [p.grad.cpu() for p in params],
                     [p.detach().cpu() for p in params]))
    (c_out, c_grads, c_params), (g_out, g_grads, g_params) = runs
    for g, c in [*zip(g_out, c_out), *zip(g_grads, c_grads)]:
        torch.testing.assert_close(g.cpu(), c, rtol=1e-4, atol=1e-4)
    for g, c, grad in zip(g_params, c_params, c_grads):
        held = grad.abs() >= 1e-6
        torch.testing.assert_close(g[held], c[held], rtol=1e-4, atol=1e-4)


def _dist_graph():
    from pygcn_tpu_torch.graph.transform import sym_normalize, symmetrize_max

    rng = np.random.default_rng(5)
    n, e = 500, 4000
    m = sp.coo_matrix((rng.uniform(0.1, 1.0, e), (rng.integers(0, n, e), rng.integers(0, n, e))),
                      shape=(n, n))
    a = sym_normalize(symmetrize_max(m))
    return Graph.from_scipy(a, is_symmetric=True, build_dense=False, build_bcsr=False), a


def _one_rank_nccl_group(tmp_path):
    """A process group of this process alone over NCCL (``file://``
    rendezvous, no network); the caller destroys it."""
    from pygcn_tpu_torch.parallel.launcher import initialize_multihost

    info = initialize_multihost(f"file://{tmp_path}/rendezvous", 1, 0, device="cuda")
    assert info.distributed and torch.distributed.get_backend() == "nccl"


def test_dist_spmm_and_step_on_one_nccl_rank_match_the_cpu(dev, tmp_path):
    """World size 1 over NCCL (the card's halo exchange is an NCCL
    all-to-all of an empty halo): the distributed SpMM, with and without
    the plan's ELL layouts, equals the dense product and its gradient, and
    three ``DistGCN`` classifier steps equal the same steps on the CPU
    (run first, with no process group) within 1e-4."""
    import torch.nn.functional as F

    from pygcn_tpu_torch.parallel import build_dist_plan, make_dist_spmm, make_mesh
    from pygcn_tpu_torch.parallel.dist_gcn import DistGCN, make_dist_classifier_step
    from pygcn_tpu_torch.train.optim import adam_l2

    g, a = _dist_graph()
    plans = {ell: build_dist_plan(g, 1, build_ell=ell) for ell in (True, False)}
    rng = np.random.default_rng(6)
    x = rng.normal(size=(g.n_nodes, 40)).astype(np.float32)
    labels = torch.from_numpy(rng.integers(0, 4, g.n_nodes))
    mask = torch.from_numpy((rng.uniform(size=g.n_nodes) < 0.3).astype(np.float32))

    def gcn_steps(device):
        mesh = make_mesh([1], ["graph"], device=device)
        model = DistGCN(mesh, plans[True], [40, 16, 4],
                        final_activation=lambda h: F.log_softmax(h, dim=1),
                        generator=torch.Generator().manual_seed(0)).to(device)
        step = make_dist_classifier_step(model, adam_l2(model.parameters(), 0.01, 5e-4))
        xs, ys, ms = (model.shard_x(t) for t in (x, labels, mask))
        losses = [step(xs, ys, ms).cpu() for _ in range(3)]
        return losses, [p.detach().cpu() for p in model.parameters()]

    cpu_losses, cpu_params = gcn_steps("cpu")
    _one_rank_nccl_group(tmp_path)
    try:
        mesh = make_mesh([1], ["graph"])
        assert mesh.device.type == "cuda"
        for ell, plan in plans.items():
            xs = torch.from_numpy(x).to(dev).requires_grad_()
            y = make_dist_spmm(mesh, plan)(xs)
            y.sum().backward()
            torch.testing.assert_close(y.cpu()[: g.n_nodes], torch.from_numpy(a @ x).float(),
                                       rtol=1e-4, atol=1e-4, msg=f"ell={ell}")
            torch.testing.assert_close(
                xs.grad.cpu(), torch.from_numpy(a.T @ np.ones_like(x)).float(), rtol=1e-4,
                atol=1e-4, msg=f"ell={ell}")
        card_losses, card_params = gcn_steps(mesh.device)
    finally:
        torch.distributed.destroy_process_group()
    for g_, c in [*zip(card_losses, cpu_losses), *zip(card_params, cpu_params)]:
        torch.testing.assert_close(g_, c, rtol=1e-4, atol=1e-4)


def test_shards_beyond_the_visible_cards_are_refused(dev):
    """``train_fullgraph --shards N --device cuda`` with N above the visible
    cards exits with the mesh message before it builds or starts anything."""
    from pygcn_tpu_torch.apps import train_fullgraph as tapp

    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match=f"mesh needs {n} devices, have {n - 1}"):
        tapp.main(["--shards", str(n), "--device", "cuda", "--n_nodes", "300"])


def test_dist_evaluator_and_dp_sampled_on_one_nccl_rank_match_the_cpu(dev, tmp_path):
    """World size 1 over NCCL: ``DistGCNOverMLP`` on a 1×1 ``graph × data``
    mesh (forward and three ``make_dist_evaluator_step`` steps) and three
    replicated and feature-sharded ``make_dp_sampled_step`` steps equal the
    same on the CPU (run first, with no process group) within 1e-4."""
    from pygcn_tpu_torch.apps import train_sampled as tapp
    from pygcn_tpu_torch.ops.sampling import NeighborSampler
    from pygcn_tpu_torch.parallel import DistGCNOverMLP, build_dist_plan, make_mesh
    from pygcn_tpu_torch.parallel.dist_evaluator import make_dist_evaluator_step
    from pygcn_tpu_torch.parallel.dp_sampled import (ShardedNeighborSampler, build_fetch_plan,
                                                     gather_input_nodes, make_dp_sampled_step,
                                                     shard_feature_rows)
    from pygcn_tpu_torch.train.optim import adam_l2

    g, a = _dist_graph()
    plan = build_dist_plan(g, 1)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(4, g.n_nodes, 9)).astype(np.float32)
    x[:, :, -1] = rng.uniform(size=(4, g.n_nodes)) < 0.05
    y = rng.normal(size=4).astype(np.float32)
    kw = dict(gcn_nfeat=8, gcn_nhid=12, gcn_nclass=12, dim_touched=8, linear_nin=12,
              linear_nhid1=16, linear_nhid2=8)
    feats = rng.normal(size=(g.n_nodes, 16)).astype(np.float32)
    labels = rng.integers(0, 4, g.n_nodes)
    seeds = [rng.choice(g.n_nodes, 64, replace=False) for _ in range(3)]

    def run(device):
        mesh = make_mesh([1, 1], ["graph", "data"], device=device)
        model = DistGCNOverMLP(mesh, plan, **kw, generator=torch.Generator().manual_seed(0))
        step = make_dist_evaluator_step(model, adam_l2(model.parameters(), 0.01, 5e-4))
        bx, by = model.shard_batch(x), model.shard_targets(y)
        with torch.no_grad():
            out = [model(bx).cpu()]
        out += [step(bx, by).cpu() for _ in range(3)]
        out += [p.detach().cpu() for p in model.parameters()]
        data_mesh = make_mesh([1], ["data"], device=device)
        for sharded in (False, True):
            net = tapp.SampledGCN.init([16, 8, 4], generator=torch.Generator().manual_seed(0))
            net = net.to(device)
            dp = make_dp_sampled_step(data_mesh, net, adam_l2(net.parameters(), 0.01),
                                      feature_sharded=sharded)
            x_shard, s = shard_feature_rows(data_mesh, feats)
            group = ShardedNeighborSampler(NeighborSampler(a.tocsr(), [4, 3], seed=1), 1,
                                           align_shard_size=s if sharded else None)
            for sd in seeds:
                (b,) = group(sd)
                blocks = [k.to(device) for k in b.blocks]
                yb = torch.from_numpy(labels[b.output_nodes]).to(device)
                if sharded:
                    p = build_fetch_plan(gather_input_nodes(b.input_nodes, data_mesh), s)
                    out.append(dp(blocks, p, x_shard, yb).cpu())
                else:
                    ids = torch.from_numpy(b.input_nodes).to(device)
                    out.append(dp(blocks, ids, torch.from_numpy(feats).to(device), yb).cpu())
            out += [p.detach().cpu() for p in net.parameters()]
        return out

    cpu = run("cpu")
    _one_rank_nccl_group(tmp_path)
    try:
        card = run(torch.device("cuda"))
    finally:
        torch.distributed.destroy_process_group()
    for c, w in zip(card, cpu):
        torch.testing.assert_close(c, w, rtol=1e-4, atol=1e-4)


def test_sharded_simulator_on_one_nccl_rank_equals_unsharded(dev, tmp_path):
    """``simulate_policy_batch(mesh=...)`` at world size 1 over NCCL gives
    the unsharded batch on the card bit for bit."""
    from pygcn_tpu_torch.apps.common import build_synthetic_world
    from pygcn_tpu_torch.parallel import make_mesh
    from pygcn_tpu_torch.sim.dist import simulate_policy_batch

    world = build_synthetic_world(n_cbgs=48, n_pois=20, hours=48, seed=3, device=dev)
    p = world.params
    attack = p.attack_orig[None] * torch.linspace(0.4, 1.0, 5, device=dev)[:, None]
    seeds = [11, 12, 13, 14, 15]
    want = simulate_policy_batch(p, world.visits, attack, seeds, 2)
    _one_rank_nccl_group(tmp_path)
    try:
        got = simulate_policy_batch(p, world.visits, attack, seeds, 2,
                                    mesh=make_mesh([1], ["data"]))
    finally:
        torch.distributed.destroy_process_group()
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("app, argv", [
    ("gt_gen", ["--out", "x.csv"]),
    ("train_rl", ["--out_dir", "rl"]),
    ("train_sampled", ["--n_nodes", "300"]),
])
def test_data_parallel_shards_beyond_the_visible_cards_are_refused(dev, app, argv, tmp_path,
                                                                   monkeypatch):
    """``--shards N --device cuda`` with N above the visible cards exits
    with the mesh message before it writes or starts anything."""
    import importlib

    monkeypatch.chdir(tmp_path)
    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match=f"mesh needs {n} devices, have {n - 1}"):
        importlib.import_module(f"pygcn_tpu_torch.apps.{app}").main(
            ["--shards", str(n), "--device", "cuda", *argv])
    assert not os.listdir(tmp_path)
