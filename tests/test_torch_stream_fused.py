"""The GAT stream mode's fused wrappers, B4 (``tile_fwd_stream``), B5s
(``tile_bwd_dldst_stream``) and B6s (``tile_bwd_sender_stream``), which
return merged outputs, on the CPU.

On the CPU each runs its plain version: the per-tile partials, or blocks,
merged by :func:`softmax_merge` or :func:`sum_by_block_row`, as the JAX
package merges its kernels' tiles. The cases hold those merged outputs
against the attention sums over the dense mask in float64 NumPy (``m`` also
against the plain blocks' row maxima, bit for bit), block rows without tiles
against ``NEG``/0, B5s and the stream mode against JAX's stream mode (values
to 1e-5, VJPs to 1e-4), both modes at 256 heads of one feature against JAX,
and the kernel path's dispatch: with stand-ins for the kernels,
``GATTilePartials`` runs no merge at all, and the fused wrappers hand the
library zero- and ``NEG``-filled ``[n, ·]`` outputs and B4 its bits buffer,
with no ``bcsr.cache`` entry. The graphs are those of
``tests/test_torch_gat.py`` (320 nodes, tiles and a residual, a block row
that owns only its padding tile) and the 300-node random tile sets of
``tests/test_torch_cuda.py``.
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cuda import gat_tiles
from test_torch_gat import GRAD, SYM, VAL, np_of, tile_operands
from test_torch_gat import graphs as gat_graphs
from test_torch_stream import stream_mode

from pygcn_tpu.ops.pallas import gat_tile_attn as jtile

from pygcn_tpu_torch.ops.cuda import gat_tile_attn as ttile

torch.set_num_threads(1)

SLOPE = 0.2


def operands(n, h, f, seed):
    """``lsrc, ldst, s2`` and cotangents ``dnum, dden`` from a NumPy seed."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(n, w)).astype(np.float32))
            for w in (h, h, h * f, h * f, h)]


def row_max_of_blocks(bcsr, max_t, n):
    """Each receiver's max of the per-tile row maxima over its block row's
    tiles, in NumPy; ``NEG`` where the block row owns no tile."""
    h = max_t.shape[2]
    m = np.full((bcsr.n_block_rows, bcsr.tm, h), ttile.NEG, np.float32)
    for t, r in enumerate(bcsr.block_rows.numpy()):
        m[r] = np.maximum(m[r], max_t[t].numpy())
    return torch.from_numpy(m.reshape(-1, h)[:n])


def dense_mask(bcsr, n):
    """``A[v, u]``: whether the tiles hold the edge u -> v (a nonzero value)."""
    a = np.zeros((bcsr.n_block_rows * bcsr.tm, (int(bcsr.block_cols.max()) + 1) * bcsr.tk), bool)
    data = bcsr.data.float().numpy()
    for t, (r, c) in enumerate(zip(bcsr.block_rows.numpy(), bcsr.block_cols.numpy())):
        a[r * bcsr.tm:(r + 1) * bcsr.tm, c * bcsr.tk:(c + 1) * bcsr.tk] |= data[t] != 0
    return a[:n, :n]


def dense_attention(a, lsrc, ldst, s2, m, dnum, dden, h, f):
    """The GAT attention sums and their gradients over the dense mask ``a``
    in float64 NumPy: ``(num, den, m)`` and, against the given ``m``,
    ``(ds, dlsrc, dldst)``; ``m = NEG`` and zeros for a receiver without
    edges."""
    lsrc, ldst, s2, m_in, dnum, dden = (t.double().numpy() for t in (lsrc, ldst, s2, m, dnum, dden))
    s2, dnum = s2.reshape(-1, h, f), dnum.reshape(-1, h, f)
    on = a[:, :, None]
    pre = ldst[:, None, :] + lsrc[None, :, :]  # [v, u, h]
    e = np.where(pre >= 0, pre, SLOPE * pre)
    has = on.any(axis=1)
    m = np.where(has, np.where(on, e, -np.inf).max(axis=1), ttile.NEG)
    p = np.exp(np.where(on, e - m[:, None, :], -np.inf))
    fwd = np.einsum("vuh,uhf->vhf", p, s2).reshape(-1, h * f), p.sum(axis=1), m
    p = np.exp(np.where(on, e - m_in[:, None, :], -np.inf))  # the backward's, against m_in
    g = p * (np.einsum("uhf,vhf->vuh", s2, dnum) + dden[:, None, :]) * np.where(pre >= 0, 1, SLOPE)
    return fwd, (np.einsum("vuh,vhf->uhf", p, dnum).reshape(-1, h * f), g.sum(axis=0),
                 g.sum(axis=1))


@pytest.mark.parametrize("hf", [(2, 4), (3, 5), (1, 40), (2, 65)],
                         ids=lambda x: f"{x[0]}x{x[1]}")
@pytest.mark.parametrize("tiles", ["f32", "bf16"])
@SYM
def test_fused_wrappers_match_a_dense_reference(symmetric, tiles, hf):
    """``tile_fwd_stream`` returns ``(num, den, m)``,
    ``tile_bwd_sender_stream`` ``(ds, dlsrc)`` and ``tile_bwd_dldst_stream``
    ``dldst``, all ``[n, ·]``: within 1e-5 (forward) and 1e-4 (gradients) of
    the attention sums evaluated over the dense mask in float64 NumPy, with
    ``m`` also the plain per-tile blocks' row maxima bit for bit."""
    h, f = hf
    dtype = torch.bfloat16 if tiles == "bf16" else torch.float32
    b, bt = gat_tiles(symmetric, dtype, False)
    lsrc, ldst, s2, dnum, dden = operands(300, h, f, h * 10 + f)
    num, den, m = ttile.tile_fwd_stream(b, lsrc, ldst, s2, h, f, SLOPE)
    ds, dlsrc = ttile.tile_bwd_sender_stream(bt, lsrc, ldst, s2, m, dnum, dden, h, f, SLOPE)
    dldst = ttile.tile_bwd_dldst_stream(b, lsrc, ldst, s2, m, dnum, dden, h, f, SLOPE)
    assert (num.shape, den.shape, m.shape) == ((300, h * f), (300, h), (300, h))
    assert (ds.shape, dlsrc.shape, dldst.shape) == ((300, h * f), (300, h), (300, h))
    fwd, bwd = dense_attention(dense_mask(b, 300), lsrc, ldst, s2, m, dnum, dden, h, f)
    for got, want in zip((num, den, m), fwd):
        np.testing.assert_allclose(got.numpy(), want, **VAL)
    for got, want in zip((ds, dlsrc, dldst), bwd):
        np.testing.assert_allclose(got.numpy(), want, **GRAD)
    blocks = ttile.tile_fwd_stream_plain(b, lsrc, ldst, s2, h, f, SLOPE)
    assert torch.equal(m, row_max_of_blocks(b, blocks[2], 300))


@SYM
def test_fused_wrappers_on_block_rows_without_tiles(symmetric):
    """Without the padding tiles (``drop_zero_tiles``), the fused wrappers give
    what they give with them: ``m = NEG``, ``num = den = 0`` and ``dldst = 0``
    on the block row without edges, and no ``ds``/``dlsrc`` for its senders
    when the set is symmetric."""
    h, f = 3, 5
    lsrc, ldst, s2, dnum, dden = operands(300, h, f, 7)
    results = []
    for drop in (False, True):
        b, bt = gat_tiles(symmetric, torch.float32, drop)
        num, den, m = ttile.tile_fwd_stream(b, lsrc, ldst, s2, h, f, SLOPE)
        bwd = (lsrc, ldst, s2, m, dnum, dden, h, f, SLOPE)
        ds, dlsrc = ttile.tile_bwd_sender_stream(bt, *bwd)
        results.append((num, den, m, ds, dlsrc, ttile.tile_bwd_dldst_stream(b, *bwd)))
    bare = gat_tiles(symmetric, torch.float32, True)[0]
    assert bare.block_row_ptr[1] == bare.block_row_ptr[2]  # block row 1: no tile
    for with_pad, without in zip(*results):
        torch.testing.assert_close(without, with_pad, rtol=0, atol=0)
    num, den, m, ds, dlsrc, dldst = results[1]
    assert (m[128:256] == ttile.NEG).all() and not num[128:256].any() and not den[128:256].any()
    assert not dldst[128:256].any()
    if symmetric:
        assert not ds[128:256].any() and not dlsrc[128:256].any()


@pytest.mark.parametrize("meta", [(3, 5, 0.2), (1, 40, 0.2)], ids=["3x5", "1x40"])
@SYM
def test_stream_partials_match_jax_at_other_widths(symmetric, meta):
    """``gat_tile_partials`` in the stream mode (B4, B5s and B6s on the
    CPU: the merged plain versions) against JAX's stream mode: num/den/m to
    1e-5 and the VJP (dlsrc, dldst, ds) to 1e-4, at a width masked inside a
    compiled one (3x5) and the second layer's 1x40."""
    h, f, _ = meta
    jg, tg = gat_graphs(symmetric)
    jt, tt = jtile.transpose_bcsr(jg.hybrid.bcsr), ttile.transpose_bcsr(tg.hybrid.bcsr)
    ops = tile_operands(61, h, f)
    rng = np.random.default_rng(62)
    cot = [rng.normal(size=(ops[0].shape[0], w)).astype(np.float32) for w in (h * f, h)]
    with stream_mode():
        j_out, j_vjp = jax.vjp(
            lambda *a: jtile.gat_tile_partials(meta, jg.hybrid.bcsr, jt, *a),
            *[jnp.asarray(a) for a in ops])
        j_grads = j_vjp((jnp.asarray(cot[0]), jnp.asarray(cot[1]), jnp.zeros_like(j_out[2])))
        t_args = [torch.from_numpy(a).requires_grad_(True) for a in ops]
        t_out = ttile.gat_tile_partials(meta, tg.hybrid.bcsr, tt, *t_args)
        t_grads = torch.autograd.grad(t_out[:2], t_args, [torch.from_numpy(c) for c in cot])
    for t_o, j_o in zip(t_out, j_out):
        np.testing.assert_allclose(np_of(t_o), np.asarray(j_o), **VAL)
    for t_g, j_g in zip(t_grads, j_grads):
        np.testing.assert_allclose(np_of(t_g), np.asarray(j_g), **GRAD)


@pytest.mark.parametrize("hf", [(3, 5), (1, 40), (2, 65)], ids=lambda x: f"{x[0]}x{x[1]}")
@SYM
def test_b5s_wrapper_matches_jax_stream(symmetric, hf):
    """``tile_bwd_dldst_stream`` (B5s, merged) against JAX's stream-mode
    receiver gradient (``_bwd_dldst_kernel`` with ``stream=True`` in
    interpret mode, then its ``segment_sum`` by block row), read from JAX's
    VJP of ``gat_tile_partials`` and fed JAX's forward ``m``: to 1e-4, at a
    width masked inside a compiled one (3x5), the second layer's 1x40 and a
    full 64-column slab and a ragged one (2x65)."""
    h, f = hf
    meta = (h, f, SLOPE)
    jg, tg = gat_graphs(symmetric)
    jt = jtile.transpose_bcsr(jg.hybrid.bcsr)
    ops = tile_operands(65 + f, h, f)
    rng = np.random.default_rng(66 + f)
    cot = [rng.normal(size=(ops[0].shape[0], w)).astype(np.float32) for w in (h * f, h)]
    with stream_mode():
        j_out, j_vjp = jax.vjp(
            lambda *a: jtile.gat_tile_partials(meta, jg.hybrid.bcsr, jt, *a),
            *[jnp.asarray(a) for a in ops])
        j_dldst = j_vjp((jnp.asarray(cot[0]), jnp.asarray(cot[1]), jnp.zeros_like(j_out[2])))[1]
    lsrc, ldst, s2 = (torch.from_numpy(a) for a in ops)
    m = torch.from_numpy(np.array(j_out[2]))
    dldst = ttile.tile_bwd_dldst_stream(tg.hybrid.bcsr, lsrc, ldst, s2, m,
                                        *(torch.from_numpy(c) for c in cot), h, f, SLOPE)
    assert dldst.shape == (ops[0].shape[0], h)
    np.testing.assert_allclose(dldst.numpy(), np.asarray(j_dldst), **GRAD)


@pytest.mark.parametrize("mode", ["revisit", "stream"])
def test_partials_at_256_heads_match_jax(mode):
    """``gat_tile_partials`` at 256 heads of one feature, more heads than B3,
    B4 and B5s stage at once on the card (they walk them in groups there):
    the CPU path against JAX's, in either mode, num/den/m to 1e-5 and the VJP
    (dlsrc, dldst, ds) to 1e-4."""
    h, f = 256, 1
    meta = (h, f, SLOPE)
    jg, tg = gat_graphs(False)
    jt, tt = jtile.transpose_bcsr(jg.hybrid.bcsr), ttile.transpose_bcsr(tg.hybrid.bcsr)
    ops = tile_operands(71, h, f)
    rng = np.random.default_rng(72)
    cot = [rng.normal(size=(ops[0].shape[0], w)).astype(np.float32) for w in (h * f, h)]
    with stream_mode() if mode == "stream" else contextlib.nullcontext():
        j_out, j_vjp = jax.vjp(
            lambda *a: jtile.gat_tile_partials(meta, jg.hybrid.bcsr, jt, *a),
            *[jnp.asarray(a) for a in ops])
        j_grads = j_vjp((jnp.asarray(cot[0]), jnp.asarray(cot[1]), jnp.zeros_like(j_out[2])))
        t_args = [torch.from_numpy(a).requires_grad_(True) for a in ops]
        t_out = ttile.gat_tile_partials(meta, tg.hybrid.bcsr, tt, *t_args)
        t_grads = torch.autograd.grad(t_out[:2], t_args, [torch.from_numpy(c) for c in cot])
    for t_o, j_o in zip(t_out, j_out):
        np.testing.assert_allclose(np_of(t_o), np.asarray(j_o), **VAL)
    for t_g, j_g in zip(t_grads, j_grads):
        np.testing.assert_allclose(np_of(t_g), np.asarray(j_g), **GRAD)


@SYM
def test_kernel_path_merges_only_b5s(symmetric, monkeypatch):
    """On the kernel path (the dispatch forced to the ``*_cuda`` wrappers,
    here stand-ins that run the merged plain versions), ``GATTilePartials``
    in the stream mode runs no merge at all: it calls neither
    :func:`sum_by_block_row` nor :func:`softmax_merge`, since B4, B5s and B6s
    return merged outputs. Values and gradients equal the CPU path's."""
    _, tg = gat_graphs(symmetric)
    bcsr, bcsr_t = tg.hybrid.bcsr, ttile.transpose_bcsr(tg.hybrid.bcsr)
    ops = tile_operands(63)
    cot = [torch.from_numpy(np.random.default_rng(64).normal(size=(ops[0].shape[0], w))
                            .astype(np.float32)) for w in (8, 2)]

    def run():
        args = [torch.from_numpy(a).requires_grad_(True) for a in ops]
        out = ttile.gat_tile_partials((2, 4, SLOPE), bcsr, bcsr_t, *args)
        return [o.detach() for o in out] + list(torch.autograd.grad(out[:2], args, cot))

    with stream_mode(jax_too=False):
        ref = run()
        calls, inside = [], []

        def counted(name, fn):
            def wrapper(*a, **k):
                if not inside:  # not from inside a stand-in kernel
                    calls.append(name)
                return fn(*a, **k)
            return wrapper

        def stand_in(name, fn):
            def kernel(*a):
                calls.append(name)
                inside.append(name)
                try:
                    return fn(*a)
                finally:
                    inside.pop()
            return kernel

        monkeypatch.setattr(ttile, "softmax_merge", counted("softmax_merge", ttile.softmax_merge))
        monkeypatch.setattr(ttile, "sum_by_block_row",
                            counted("sum_by_block_row", ttile.sum_by_block_row))
        monkeypatch.setattr(ttile, "tile_fwd_stream_cuda", stand_in("B4", ttile.tile_fwd_plain))
        monkeypatch.setattr(ttile, "tile_bwd_dldst_stream_cuda",
                            stand_in("B5s", ttile.tile_bwd_dldst_plain))
        monkeypatch.setattr(ttile, "tile_bwd_sender_stream_cuda",
                            stand_in("B6s", ttile.tile_bwd_sender_plain))
        monkeypatch.setattr(ttile, "_pick", lambda plain, cuda, x: cuda)
        got = run()
    assert calls == ["B4", "B5s", "B6s"]
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


class _Recorder:
    """Stands in for the built GAT library: records each entry point's
    arguments and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


def test_fused_wrappers_hand_the_library_filled_outputs(monkeypatch):
    """Driven with a stand-in library on the CPU (no card here): B4 gets
    ``num``/``den`` zero-filled and ``m`` filled with ``NEG``, all ``[n, ·]``,
    and a bits buffer of ``[T, 128, 4]`` int32; B5s ``dldst`` and B6s
    ``ds``/``dlsrc`` zero-filled; the outputs returned are those buffers;
    each launch counts once and none leaves a ``bcsr.cache`` entry (no work
    items, no counters)."""
    b, bt = gat_tiles(False, torch.float32, False)
    h, f = 2, 4
    lsrc, ldst, s2, dnum, dden = operands(300, h, f, 9)
    lib = _Recorder()
    monkeypatch.setattr(ttile, "_load", lambda name: lib)
    monkeypatch.setattr(ttile, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    allocated = []
    empty = torch.empty

    def recording_empty(*a, **k):
        out = empty(*a, **k)
        allocated.append(out)
        return out

    monkeypatch.setattr(torch, "empty", recording_empty)
    before = dict(ttile.launches)
    num, den, m = ttile.tile_fwd_stream_cuda(b, lsrc, ldst, s2, h, f, SLOPE)
    dldst = ttile.tile_bwd_dldst_stream_cuda(b, lsrc, ldst, s2, m, dnum, dden, h, f, SLOPE)
    ds, dlsrc = ttile.tile_bwd_sender_stream_cuda(bt, lsrc, ldst, s2, m, dnum, dden, h, f, SLOPE)
    (fwd, fwd_args), (rcv, rcv_args), (snd, snd_args) = lib.calls
    assert (fwd, rcv, snd) == ("gat_tile_fwd_stream", "gat_tile_bwd_dldst_stream",
                               "gat_tile_bwd_sender_stream")
    (bits,) = [t for t in allocated if t.data_ptr() == fwd_args[9]]
    assert bits.shape == (b.data.shape[0], 128, 4) and bits.dtype == torch.int32
    assert fwd_args[6:9] == (num.data_ptr(), den.data_ptr(), m.data_ptr())
    assert fwd_args[10:15] == (b.data.shape[0], 300, h, f, 0)
    assert rcv_args[9] == dldst.data_ptr()
    assert rcv_args[10:15] == (b.data.shape[0], 300, h, f, 0)
    assert snd_args[9:11] == (ds.data_ptr(), dlsrc.data_ptr())
    assert snd_args[11:16] == (bt.data.shape[0], 300, h, f, 0)
    assert (num.shape, den.shape, m.shape, dldst.shape, ds.shape, dlsrc.shape) == (
        (300, h * f), (300, h), (300, h), (300, h), (300, h * f), (300, h))
    assert not any(x.any() for x in (num, den, dldst, ds, dlsrc))
    assert (m == ttile.NEG).all()
    assert not b.cache and not bt.cache
    assert {k: ttile.launches[k] - before[k] for k in before} == {
        **dict.fromkeys(before, 0), "B4": 1, "B5s": 1, "B6s": 1}
