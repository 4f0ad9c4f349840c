"""The port's GAT ops against the JAX package's, values and gradients.

Graphs of 320 nodes (ragged: the last block row holds 64 nodes) with dense
128x128 tiles at block coordinates (0, 0) and (2, 2), a sparse random
residual, and so a middle block row whose edges all stay on the ELL side:
the hybrid builder gives that row an all-zero padding tile. Both packages
build their layouts from the same COO, symmetric and asymmetric. JAX's tile
kernels run their Pallas bodies in interpret mode, as the JAX package's own
tests run them; the port runs the kernels' plain versions, its only path for
CPU tensors. JAX computes at ``highest`` matmul precision
(``tests/conftest.py``): values agree to 1e-5 and gradients to 1e-4 (rtol
and atol), with fixed cotangents made from a NumPy seed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pygcn_tpu.graph.graph import Graph as JGraph
from pygcn_tpu.ops import gat as jgat
from pygcn_tpu.ops.pallas import gat_tile_attn as jtile

from pygcn_tpu_torch.graph.graph import Graph as TGraph
from pygcn_tpu_torch.graph.graph import drop_zero_tiles
from pygcn_tpu_torch.ops import gat as tgat
from pygcn_tpu_torch.ops.cuda import gat_tile_attn as ttile

torch.set_num_threads(1)

N = 320
VAL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
KW = dict(n_nodes=N, build_dense=False, build_bcsr=False, build_ell=True, build_hybrid=True,
          hybrid_min_edges_per_tile=64)


def coo(symmetric: bool, seed: int = 21):
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for lo, hi in ((0, 128), (256, N)):  # dense blocks (0, 0) and (2, 2)
        rows.append(rng.integers(lo, hi, 2500))
        cols.append(rng.integers(lo, hi, 2500))
    rows.append(rng.integers(0, N, 150))  # sparse residual
    cols.append(rng.integers(0, N, 150))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    keep = rows != cols
    m = sp.coo_matrix((np.ones(int(keep.sum()), np.float32), (rows[keep], cols[keep])),
                      shape=(N, N))
    m.sum_duplicates()
    m.data[:] = np.random.default_rng(seed + 1).uniform(0.5, 2.0, m.nnz)
    if symmetric:
        m = m.maximum(m.T).tocoo()
    return m.col, m.row, m.data.astype(np.float32)


_GRAPHS = {}


def graphs(symmetric: bool, **extra):
    key = (symmetric, tuple(sorted(extra.items())))
    if key not in _GRAPHS:
        s, d, w = coo(symmetric)
        kw = dict(KW, is_symmetric=symmetric, **extra)
        jg, tg = JGraph.from_coo(s, d, w, **kw), TGraph.from_coo(s, d, w, **kw)
        hy = tg.hybrid
        assert hy.bcsr is not None and 0 < hy.tile_edges < tg.n_edges
        # block row 1 owns only the builder's zero padding tile
        br = hy.bcsr.block_rows.numpy()
        assert not hy.bcsr.data[br == 1].any() and (br == 1).sum() == 1
        _GRAPHS[key] = (jg, tg)
    return _GRAPHS[key]


SYM = pytest.mark.parametrize("symmetric", [False, True], ids=["asym", "sym"])


def inputs(seed, h=2, f=4):
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(N, h, f)).astype(np.float32)
    a_src = rng.normal(size=(h, f)).astype(np.float32)
    a_dst = rng.normal(size=(h, f)).astype(np.float32)
    return s, a_src, a_dst


def np_of(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy() if a.dtype == torch.bfloat16 else a.detach().numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def check_vjp(j_fn, t_fn, args, cot_seed, tol_val=VAL, tol_grad=GRAD):
    """``j_fn``/``t_fn`` map the same NumPy ``args`` to one array; values and
    the VJP of a fixed cotangent agree."""
    j_out, j_vjp = jax.vjp(jax.jit(j_fn), *[jnp.asarray(a) for a in args])
    t_args = [torch.from_numpy(a).requires_grad_(True) for a in args]
    t_out = t_fn(*t_args)
    np.testing.assert_allclose(np_of(t_out), np.asarray(j_out), **tol_val)
    cot = np.random.default_rng(cot_seed).normal(size=j_out.shape).astype(np.float32)
    t_grads = torch.autograd.grad(t_out, t_args, torch.from_numpy(cot))
    for tg_, jg_ in zip(t_grads, j_vjp(jnp.asarray(cot))):
        np.testing.assert_allclose(np_of(tg_), np.asarray(jg_), **tol_grad)


@pytest.mark.parametrize("symmetric,dtype", [(False, None), (True, None),
                                             (False, "bfloat16")],
                         ids=["asym", "sym", "asym_bf16"])
def test_transpose_bcsr_matches_jax(symmetric, dtype):
    extra = {} if dtype is None else {"hybrid_tile_dtype": dtype}
    jg, tg = graphs(symmetric, **extra)
    jt = jtile.transpose_bcsr(jg.hybrid.bcsr)
    tt = ttile.transpose_bcsr(tg.hybrid.bcsr)
    assert tt.data.dtype == tg.hybrid.bcsr.data.dtype
    assert (tt.tm, tt.tk, tt.n_block_rows, tt.n_block_cols) == (
        jt.tm, jt.tk, jt.n_block_rows, jt.n_block_cols)
    for f in ("data", "block_rows", "block_cols", "block_row_ptr"):
        np.testing.assert_array_equal(np_of(getattr(tt, f)), np_of(getattr(jt, f)), err_msg=f)
    assert tgat.build_gat_tiles_t(tg).data.shape == tt.data.shape


@SYM
def test_build_edge_map_matches_jax_and_reconstructs_vals(symmetric):
    jg, tg = graphs(symmetric)
    jem, tem = jgat.build_edge_map(jg), tgat.build_edge_map(tg)
    assert tem.sentinel == jem.sentinel == tg.e_pad
    table = np.concatenate([tg.weights.numpy(), np.zeros(1, np.float32)])
    for je, te, vals, k in zip(jem.eidx, tem.eidx, tg.ell.vals, tg.ell.ks):
        np.testing.assert_array_equal(te.numpy(), np.asarray(je).reshape(-1, k))
        np.testing.assert_array_equal(table[te.numpy()], vals.numpy())


@SYM
def test_coo_attention_matches_jax(symmetric):
    """``edge_softmax``/``gat_attention`` (alpha) and ``attention_aggregate``."""
    jg, tg = graphs(symmetric)
    args = inputs(3)
    check_vjp(lambda s, a, b: jgat.gat_attention(jg, s, a, b),
              lambda s, a, b: tgat.gat_attention(tg, s, a, b), args, 4)
    alpha = np.random.default_rng(5).uniform(size=(tg.e_pad, 2)).astype(np.float32)
    check_vjp(lambda s, al: jgat.attention_aggregate(jg, s, al),
              lambda s, al: tgat.attention_aggregate(tg, s, al), (args[0], alpha), 6)
    logits = np.random.default_rng(7).normal(size=tg.e_pad).astype(np.float32)
    check_vjp(lambda x: jgat.edge_softmax(jg, x), lambda x: tgat.edge_softmax(tg, x),
              (logits,), 8)


@pytest.mark.parametrize("stabilizer", ["flash", "segmax"])
@SYM
def test_gat_conv_ell_matches_jax(symmetric, stabilizer):
    jg, tg = graphs(symmetric)
    jem, tem = jgat.build_edge_map(jg), tgat.build_edge_map(tg)
    check_vjp(lambda s, a, b: jgat.gat_conv_ell(jg, jem, s, a, b, stabilizer=stabilizer),
              lambda s, a, b: tgat.gat_conv_ell(tg, tem, s, a, b, stabilizer=stabilizer),
              inputs(9), 10)


def tile_operands(seed, h=2, f=4):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N, h)).astype(np.float32),
            rng.normal(size=(N, h)).astype(np.float32),
            rng.normal(size=(N, h * f)).astype(np.float32))


@SYM
def test_gat_tile_partials_matches_jax(symmetric):
    """num/den/m and the VJP of a fixed (dnum, dden) cotangent."""
    jg, tg = graphs(symmetric)
    jt, tt = jtile.transpose_bcsr(jg.hybrid.bcsr), ttile.transpose_bcsr(tg.hybrid.bcsr)
    meta = (2, 4, 0.2)
    ops = tile_operands(11)
    j_out, j_vjp = jax.vjp(lambda *a: jtile.gat_tile_partials(meta, jg.hybrid.bcsr, jt, *a),
                           *[jnp.asarray(a) for a in ops])
    t_args = [torch.from_numpy(a).requires_grad_(True) for a in ops]
    t_out = ttile.gat_tile_partials(meta, tg.hybrid.bcsr, tt, *t_args)
    for t_o, j_o in zip(t_out, j_out):
        np.testing.assert_allclose(np_of(t_o), np.asarray(j_o), **VAL)
    m = t_out[2].detach()
    assert (m[128:256] == ttile.NEG).all() and (t_out[1][128:256] == 0).all()
    assert not t_out[2].requires_grad
    rng = np.random.default_rng(12)
    cot = [rng.normal(size=o.shape).astype(np.float32) for o in j_out[:2]]
    t_grads = torch.autograd.grad(t_out[:2], t_args, [torch.from_numpy(c) for c in cot])
    j_grads = j_vjp((jnp.asarray(cot[0]), jnp.asarray(cot[1]), jnp.zeros_like(j_out[2])))
    for t_g, j_g in zip(t_grads, j_grads):
        np.testing.assert_allclose(np_of(t_g), np.asarray(j_g), **GRAD)


def test_gat_tile_partials_leaky_derivative_at_zero_matches_jax():
    """Integer logits put many pre-activations ``ldst[v] + lsrc[u]`` at exactly
    0, where JAX's ``where(x >= 0, ...)`` has derivative 1 (torch's
    ``leaky_relu`` would give the slope): the VJP agrees with JAX's."""
    jg, tg = graphs(False)
    jt, tt = jtile.transpose_bcsr(jg.hybrid.bcsr), ttile.transpose_bcsr(tg.hybrid.bcsr)
    meta = (2, 4, 0.2)
    rng = np.random.default_rng(19)
    ops = [rng.integers(-1, 2, size=(N, 2)).astype(np.float32) for _ in range(2)]
    ops.append(rng.normal(size=(N, 8)).astype(np.float32))
    cot = [rng.normal(size=(N, 8)).astype(np.float32), rng.normal(size=(N, 2)).astype(np.float32)]
    j_out, j_vjp = jax.vjp(lambda *a: jtile.gat_tile_partials(meta, jg.hybrid.bcsr, jt, *a),
                           *[jnp.asarray(a) for a in ops])
    j_grads = j_vjp((jnp.asarray(cot[0]), jnp.asarray(cot[1]), jnp.zeros_like(j_out[2])))
    t_args = [torch.from_numpy(a).requires_grad_(True) for a in ops]
    t_out = ttile.gat_tile_partials(meta, tg.hybrid.bcsr, tt, *t_args)
    t_grads = torch.autograd.grad(t_out[:2], t_args, [torch.from_numpy(c) for c in cot])
    for t_g, j_g in zip(t_grads, j_grads):
        np.testing.assert_allclose(np_of(t_g), np.asarray(j_g), **GRAD)


def test_gat_tile_partials_block_rows_without_tiles():
    """A block row that owns no tile at all (the padding tile removed, in the
    forward and the transpose tiles) gives the same partials and gradients as
    with the padding tile: num = den = 0, m = NEG, zero gradients there."""
    _, tg = graphs(True)
    bcsr = tg.hybrid.bcsr
    bcsr_t = ttile.transpose_bcsr(bcsr)
    bare, bare_t = drop_zero_tiles(bcsr), drop_zero_tiles(bcsr_t)
    assert bare.data.shape[0] == bcsr.data.shape[0] - 1
    assert bare.block_row_ptr[1] == bare.block_row_ptr[2]  # block row 1: no tile
    meta = (3, 5, 0.2)
    ops = tile_operands(13, 3, 5)
    cot = [torch.from_numpy(np.random.default_rng(14).normal(size=shape).astype(np.float32))
           for shape in ((N, 15), (N, 3))]
    results = []
    for b, bt in ((bcsr, bcsr_t), (bare, bare_t)):
        args = [torch.from_numpy(a).requires_grad_(True) for a in ops]
        out = ttile.gat_tile_partials(meta, b, bt, *args)
        results.append([o.detach() for o in out]
                       + list(torch.autograd.grad(out[:2], args, cot)))
    for with_pad, without in zip(*results):
        torch.testing.assert_close(without, with_pad, rtol=0, atol=0)
    num, den, m, dlsrc, dldst, ds = results[1]
    assert (m[128:256] == ttile.NEG).all()
    for a in (num, den, dlsrc, dldst, ds):
        assert not a[128:256].any()


def test_gat_tile_partials_backward_requires_square_tiles():
    bcsr = ttile.BCSR(data=torch.ones(1, 4, 2), block_rows=torch.zeros(1, dtype=torch.int32),
                      block_cols=torch.zeros(1, dtype=torch.int32),
                      block_row_ptr=torch.tensor([0, 1], dtype=torch.int32),
                      tm=4, tk=2, n_block_rows=1, n_block_cols=2)
    lsrc = torch.zeros(4, 1, requires_grad=True)
    num, den, _m = ttile.gat_tile_partials((1, 2, 0.2), bcsr, bcsr, lsrc, torch.zeros(4, 1),
                                           torch.zeros(4, 2))
    with pytest.raises(ValueError, match="square tiles"):
        (num.sum() + den.sum()).backward()


@SYM
def test_gat_conv_hybrid_matches_jax(symmetric):
    """Values and gradients with respect to ``s``, ``a_src`` and ``a_dst``."""
    jg, tg = graphs(symmetric)
    jt, tt = jgat.build_gat_tiles_t(jg), tgat.build_gat_tiles_t(tg)
    check_vjp(lambda s, a, b: jgat.gat_conv_hybrid(jg, jt, s, a, b),
              lambda s, a, b: tgat.gat_conv_hybrid(tg, tt, s, a, b), inputs(15), 16)


@SYM
def test_gat_conv_hybrid_matches_the_port_coo_path(symmetric):
    """The three paths of the port compute one convolution."""
    _, tg = graphs(symmetric)
    s, a, b = (torch.from_numpy(x) for x in inputs(17, 3, 5))
    ref = tgat.attention_aggregate(tg, s, tgat.gat_attention(tg, s, a, b))
    hyb = tgat.gat_conv_hybrid(tg, tgat.build_gat_tiles_t(tg), s, a, b)
    ell = tgat.gat_conv_ell(tg, tgat.build_edge_map(tg), s, a, b)
    torch.testing.assert_close(hyb, ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ell, ref, rtol=1e-5, atol=1e-5)


def test_build_gat_tiles_t_rejects_zero_weight_edges():
    s, d, w = coo(False)
    w = w.copy()
    w[7] = 0.0
    g = TGraph.from_coo(s, d, w, **KW)
    with pytest.raises(ValueError, match="zero-weight edges"):
        tgat.build_gat_tiles_t(g)
    no_hybrid = dataclasses.replace(g, hybrid=None)
    with pytest.raises(ValueError, match="no hybrid layout"):
        tgat.build_gat_tiles_t(no_hybrid)
