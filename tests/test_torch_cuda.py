"""Kernels B1-B9, and the stream modes B5s and B6s, on a CUDA card against
their plain versions (skipped without a card).

Run on a machine with an H100 from the repo root (``--noconftest`` because
``tests/conftest.py`` configures JAX, which that machine does not need)::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

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


@pytest.mark.parametrize("h", [1, 40, 128, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b2_kernel_matches_plain(dev, dtype, h):
    """B2's per-tile parts on B1's grid (a ragged last block column, the
    block row without entries with its padding tile, ragged H)."""
    rng = np.random.default_rng(h + 7)
    m = sp.random(300, 270, density=0.05, random_state=rng, format="coo",
                  data_rvs=rng.standard_normal, dtype=np.float32)
    keep = m.row // 128 != 1
    m = sp.coo_matrix((m.data[keep], (m.row[keep], m.col[keep])), shape=m.shape)
    b = _build_bcsr(m, (128, 128))
    b = dataclasses.replace(b, data=b.data.to(dtype)).to(dev)
    x = torch.from_numpy(rng.standard_normal((270, h)).astype(np.float32)).to(dev)
    before = (b1.launches, b1.stream_launches)
    got = b1.bcsr_spmm_stream(b, x)
    torch.cuda.synchronize()
    assert (b1.launches, b1.stream_launches) == (before[0], before[1] + 1)
    assert got.shape == (b.data.shape[0], 128, h)
    torch.testing.assert_close(got, b1.bcsr_spmm_stream_plain(b, x), rtol=1e-4, atol=1e-4)


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


def gat_tiles(symmetric, dtype, drop_padding, seed=0):
    """Ragged 300-node tile sets whose block row 1 has no edge (with or
    without the builder's zero padding tile) and their exact transpose; the
    symmetric set's transpose has that empty block row too."""
    rng = np.random.default_rng(seed)
    m = sp.random(300, 300, density=0.05, random_state=rng, format="coo", dtype=np.float32)
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
    """B4, B5s and B6s: per-tile blocks against their plain versions, on the
    grid of the revisit kernels' test; ``m`` is the merged max."""
    h, f = hf
    b, bt = (x.to(dev) for x in gat_tiles(symmetric, dtype, drop_padding))
    gen = torch.Generator(device=dev).manual_seed(h * 100 + f + 1)
    lsrc, ldst = (torch.randn(300, h, device=dev, generator=gen) for _ in range(2))
    s2 = torch.randn(300, h * f, device=dev, generator=gen)
    dnum = torch.randn(300, h * f, device=dev, generator=gen)
    dden = torch.randn(300, h, device=dev, generator=gen)
    before = dict(gta.launches)
    got = gta.tile_fwd_stream(b, lsrc, ldst, s2, h, f, 0.2)
    ref = gta.tile_fwd_stream_plain(b, lsrc, ldst, s2, h, f, 0.2)
    m = gta.softmax_merge(b, *ref, 300)[2]
    args = (lsrc, ldst, s2, m, dnum, dden, h, f, 0.2)
    got_dl = gta.tile_bwd_dldst_stream(b, *args)
    ref_dl = gta.tile_bwd_dldst_stream_plain(b, *args)
    got_snd = gta.tile_bwd_sender_stream(bt, *args)
    ref_snd = gta.tile_bwd_sender_stream_plain(bt, *args)
    torch.cuda.synchronize()
    assert gta.launches == {k: before[k] + (k in ("B4", "B5s", "B6s")) for k in before}
    for a, r in zip((*got, got_dl, *got_snd), (*ref, ref_dl, *ref_snd)):
        assert a.shape == r.shape
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-4)


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


def v2_operands(dev, h, f, seed, integer=False):
    """``sl2``, ``sr2``, ``a``, then ``dnum`` and ``dden`` on the card;
    ``integer`` puts many pre-activations ``sl + sr`` at exactly 0."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    if integer:
        sl2, sr2 = (torch.randint(-1, 2, (300, h * f), device=dev, generator=gen).float()
                    for _ in range(2))
    else:
        sl2, sr2 = (torch.randn(300, h * f, device=dev, generator=gen) for _ in range(2))
    a = torch.randn(h, f, device=dev, generator=gen)
    return sl2, sr2, a, torch.randn(300, h * f, device=dev, generator=gen), \
        torch.randn(300, h, device=dev, generator=gen)


def v2_kernel_and_plain(name, b, bt, ops, m, h, f):
    """The outputs of kernel ``name`` (through its dispatcher, on CUDA
    tensors) and of its plain version on the same operands."""
    sl2, sr2, a, dnum, dden = ops
    if name == "B7":
        args = (sl2, sr2, a, h, f, 0.2)
        return gta.tile_v2_fwd(b, *args), gta.tile_v2_fwd_plain(b, *args)
    args = (sl2, sr2, a, m, dnum, dden, h, f, 0.2)
    if name == "B8":
        return gta.tile_v2_bwd_recv(b, *args), gta.tile_v2_bwd_recv_plain(b, *args)
    return (gta.tile_v2_bwd_send(bt, *args),), (gta.tile_v2_bwd_send_plain(bt, *args),)


@pytest.mark.parametrize("hf", GAT_SHAPES + [(1, 64)], ids=lambda x: f"{x[0]}x{x[1]}")
@pytest.mark.parametrize("drop_padding", [False, True], ids=["padding_tile", "no_tile"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("symmetric", [False, True], ids=["asym", "sym"])
@pytest.mark.parametrize("name", ["B7", "B8", "B9"])
def test_gatv2_tile_kernel_matches_plain(dev, name, symmetric, dtype, drop_padding, hf):
    """Each GATv2 tile kernel on the grid of the v1 kernels' test, plus the
    widest compiled width (F = 64, where B8 holds the most registers)."""
    h, f = hf
    b, bt = (x.to(dev) for x in gat_tiles(symmetric, dtype, drop_padding))
    ops = v2_operands(dev, h, f, h * 100 + f)
    m = gta.tile_v2_fwd_plain(b, *ops[:3], h, f, 0.2)[2]
    before = dict(gta.launches)
    got, ref = v2_kernel_and_plain(name, b, bt, ops, m, h, f)
    torch.cuda.synchronize()
    assert gta.launches == {k: before[k] + (k == name) for k in before}
    for x, r in zip(got, ref):
        torch.testing.assert_close(x, r, rtol=1e-4, atol=1e-4)
    if name == "B7":
        assert (got[2][128:256] == gta.NEG).all() and not got[0][128:256].any()
        assert not got[1][128:256].any()
    elif name == "B8" or symmetric:
        assert not got[0][128:256].any()


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
