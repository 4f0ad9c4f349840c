"""The port's GATv2 ops against the JAX package's, values and gradients.

The 320-node graphs of ``tests/test_torch_gat.py`` (dense 128x128 tiles at
block coordinates (0, 0) and (2, 2), a sparse residual, and a middle block
row that owns only the hybrid layout's all-zero padding tile), symmetric and
asymmetric. JAX's tile kernels (B7/B8/B9) run their Pallas bodies in interpret mode, as
the JAX package's own tests run them; the port runs the kernels' plain
versions, its only path for CPU tensors. Values agree to 1e-5 and VJPs,
``da`` included, to 1e-4 (rtol and atol), with fixed cotangents made from a
NumPy seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gat import GRAD, N, SYM, VAL, check_vjp, graphs, np_of

from pygcn_tpu.ops import gat as jgat
from pygcn_tpu.ops.pallas import gat_tile_attn as jtile

from pygcn_tpu_torch.graph.graph import drop_zero_tiles
from pygcn_tpu_torch.ops import gat as tgat
from pygcn_tpu_torch.ops.cuda import gat_tile_attn as ttile

torch.set_num_threads(1)


def inputs(seed, h=2, f=4):
    """``s_l``, ``s_r [N, H, F]`` and ``a [H, F]``."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N, h, f)).astype(np.float32),
            rng.normal(size=(N, h, f)).astype(np.float32),
            rng.normal(size=(h, f)).astype(np.float32))


def flat(args):
    """``inputs`` with ``s_l``/``s_r`` as the tile kernels take them, ``[N, H·F]``."""
    s_l, s_r, a = args
    return s_l.reshape(N, -1), s_r.reshape(N, -1), a


@SYM
def test_gatv2_attention_matches_jax(symmetric):
    jg, tg = graphs(symmetric)
    check_vjp(lambda sl, sr, a: jgat.gatv2_attention(jg, sl, sr, a),
              lambda sl, sr, a: tgat.gatv2_attention(tg, sl, sr, a), inputs(31), 32)


@pytest.mark.parametrize("fn", ["flash", "segmax", "onepass"])
@SYM
def test_gatv2_conv_ell_matches_jax(symmetric, fn):
    jg, tg = graphs(symmetric)
    jem, tem = jgat.build_edge_map(jg), tgat.build_edge_map(tg)
    if fn == "onepass":
        j_fn = lambda sl, sr, a: jgat.gatv2_conv_ell_onepass(jg, jem, sl, sr, a)
        t_fn = lambda sl, sr, a: tgat.gatv2_conv_ell_onepass(tg, tem, sl, sr, a)
    else:
        j_fn = lambda sl, sr, a: jgat.gatv2_conv_ell(jg, jem, sl, sr, a, stabilizer=fn)
        t_fn = lambda sl, sr, a: tgat.gatv2_conv_ell(tg, tem, sl, sr, a, stabilizer=fn)
    check_vjp(j_fn, t_fn, inputs(33), 34)


def tile_partials_both(jg, tg, meta, ops, cot):
    """Outputs and the VJP of ``cot = (dnum, dden)`` from both packages'
    ``gatv2_tile_partials`` on the same operands ``(sl2, sr2, a)``."""
    jt, tt = jtile.transpose_bcsr(jg.hybrid.bcsr), ttile.transpose_bcsr(tg.hybrid.bcsr)
    j_out, j_vjp = jax.vjp(lambda *x: jtile.gatv2_tile_partials(meta, jg.hybrid.bcsr, jt, *x),
                           *[jnp.asarray(x) for x in ops])
    j_grads = j_vjp((jnp.asarray(cot[0]), jnp.asarray(cot[1]), jnp.zeros_like(j_out[2])))
    t_args = [torch.from_numpy(x).requires_grad_(True) for x in ops]
    t_out = ttile.gatv2_tile_partials(meta, tg.hybrid.bcsr, tt, *t_args)
    t_grads = torch.autograd.grad(t_out[:2], t_args, [torch.from_numpy(c) for c in cot])
    return (j_out, j_grads), (t_out, t_grads)


def cotangents(seed, h, f):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(N, h * f)).astype(np.float32),
            rng.normal(size=(N, h)).astype(np.float32)]


@pytest.mark.parametrize("symmetric,dtype", [(False, None), (True, None),
                                             (False, "bfloat16")],
                         ids=["asym", "sym", "asym_bf16"])
def test_gatv2_tile_partials_matches_jax(symmetric, dtype):
    """num/den/m and the VJP ``(dsl, dsr, da)`` of a fixed (dnum, dden)."""
    extra = {} if dtype is None else {"hybrid_tile_dtype": dtype}
    jg, tg = graphs(symmetric, **extra)
    (j_out, j_grads), (t_out, t_grads) = tile_partials_both(
        jg, tg, (2, 4, 0.2), flat(inputs(35)), cotangents(36, 2, 4))
    for t_o, j_o in zip(t_out, j_out):
        np.testing.assert_allclose(np_of(t_o), np.asarray(j_o), **VAL)
    assert (t_out[2][128:256] == ttile.NEG).all() and not t_out[1][128:256].any()
    assert not t_out[2].requires_grad
    for t_g, j_g in zip(t_grads, j_grads):
        np.testing.assert_allclose(np_of(t_g), np.asarray(j_g), **GRAD)


def test_gatv2_tile_partials_leaky_derivative_at_zero_matches_jax():
    """Integer ``sl``/``sr`` put many pre-activations ``sl[u,f] + sr[v,f]`` at
    exactly 0, where JAX's ``where(x >= 0, ...)`` has derivative 1 (torch's
    ``leaky_relu`` would give the slope): the VJP agrees with JAX's."""
    jg, tg = graphs(False)
    rng = np.random.default_rng(37)
    ops = [rng.integers(-1, 2, size=(N, 8)).astype(np.float32) for _ in range(2)]
    ops.append(rng.normal(size=(2, 4)).astype(np.float32))
    (_, j_grads), (_, t_grads) = tile_partials_both(jg, tg, (2, 4, 0.2), ops,
                                                    cotangents(38, 2, 4))
    for t_g, j_g in zip(t_grads, j_grads):
        np.testing.assert_allclose(np_of(t_g), np.asarray(j_g), **GRAD)


def test_gatv2_tile_partials_block_rows_without_tiles():
    """A block row that owns no tile at all (the padding tile removed, in the
    forward and the transpose tiles) gives the same partials and gradients as
    with the padding tile: num = den = 0, m = NEG, zero dsl and dsr there."""
    _, tg = graphs(True)
    bcsr = tg.hybrid.bcsr
    bcsr_t = ttile.transpose_bcsr(bcsr)
    bare, bare_t = drop_zero_tiles(bcsr), drop_zero_tiles(bcsr_t)
    assert bare.block_row_ptr[1] == bare.block_row_ptr[2]  # block row 1: no tile
    meta = (3, 5, 0.2)
    ops = flat(inputs(39, 3, 5))
    cot = [torch.from_numpy(c) for c in cotangents(40, 3, 5)]
    results = []
    for b, bt in ((bcsr, bcsr_t), (bare, bare_t)):
        args = [torch.from_numpy(x).requires_grad_(True) for x in ops]
        out = ttile.gatv2_tile_partials(meta, b, bt, *args)
        results.append([o.detach() for o in out]
                       + list(torch.autograd.grad(out[:2], args, cot)))
    for with_pad, without in zip(*results):
        torch.testing.assert_close(without, with_pad, rtol=0, atol=0)
    num, den, m, dsl, dsr, _da = results[1]
    assert (m[128:256] == ttile.NEG).all()
    for x in (num, den, dsl, dsr):
        assert not x[128:256].any()


def test_gatv2_tile_partials_backward_requires_square_tiles():
    bcsr = ttile.BCSR(data=torch.ones(1, 4, 2), block_rows=torch.zeros(1, dtype=torch.int32),
                      block_cols=torch.zeros(1, dtype=torch.int32),
                      block_row_ptr=torch.tensor([0, 1], dtype=torch.int32),
                      tm=4, tk=2, n_block_rows=1, n_block_cols=2)
    sl2 = torch.zeros(4, 2, requires_grad=True)
    num, den, _m = ttile.gatv2_tile_partials((1, 2, 0.2), bcsr, bcsr, sl2, torch.zeros(4, 2),
                                             torch.ones(1, 2))
    with pytest.raises(ValueError, match="square tiles"):
        (num.sum() + den.sum()).backward()


@SYM
def test_gatv2_conv_hybrid_matches_jax(symmetric):
    """Values and gradients with respect to ``s_l``, ``s_r`` and ``a``."""
    jg, tg = graphs(symmetric)
    jt, tt = jgat.build_gat_tiles_t(jg), tgat.build_gat_tiles_t(tg)
    check_vjp(lambda sl, sr, a: jgat.gatv2_conv_hybrid(jg, jt, sl, sr, a),
              lambda sl, sr, a: tgat.gatv2_conv_hybrid(tg, tt, sl, sr, a), inputs(41), 42)


@SYM
def test_gatv2_conv_hybrid_matches_the_port_coo_path(symmetric):
    """The three v2 paths of the port compute one convolution."""
    _, tg = graphs(symmetric)
    s_l, s_r, a = (torch.from_numpy(x) for x in inputs(43, 3, 5))
    ref = tgat.attention_aggregate(tg, s_l, tgat.gatv2_attention(tg, s_l, s_r, a))
    hyb = tgat.gatv2_conv_hybrid(tg, tgat.build_gat_tiles_t(tg), s_l, s_r, a)
    ell = tgat.gatv2_conv_ell(tg, tgat.build_edge_map(tg), s_l, s_r, a)
    torch.testing.assert_close(hyb, ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ell, ref, rtol=1e-5, atol=1e-5)
