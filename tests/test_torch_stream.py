"""The stream modes (kernels B2, B4, B5s, B6s and their merges) against the
JAX package's stream modes, values and gradients.

Both packages run with their flags set: ``BCSR_STREAM = True`` for the BCSR
SpMM and ``TILE_REVISIT = False`` for the GAT tile attention, each restored
in a ``finally``; JAX's flags are read while it traces, so its caches are
cleared around them, as ``tests/test_spmm.py`` and ``tests/test_gat.py`` do.
JAX runs its per-tile Pallas bodies in interpret mode and merges them with
``segment_max``/``segment_sum``; the port runs the kernels' plain per-tile
versions and its merges, its only path for CPU tensors. The graphs are those
of ``tests/test_torch_spmm.py`` (300 nodes, asymmetric, a block row without
edges) and ``tests/test_torch_gat.py`` (320 nodes, tiles and a residual, a
block row that owns only its padding tile). Values agree to 1e-5 and VJPs to
1e-4 (rtol and atol), with cotangents made from a NumPy seed.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gat import GRAD, SYM, VAL, check_vjp, np_of, tile_operands
from test_torch_gat import graphs as gat_graphs
from test_torch_gat import inputs as gat_inputs
from test_torch_spmm import KW, coo, run_both

from pygcn_tpu.graph.graph import Graph as JGraph
from pygcn_tpu.ops import gat as jgat
from pygcn_tpu.ops.pallas import bcsr_spmm as jb
from pygcn_tpu.ops.pallas import gat_tile_attn as jtile
from pygcn_tpu.ops.spmm import spmm as j_spmm
from pygcn_tpu.ops.spmm import spmm_t as j_spmm_t

from pygcn_tpu_torch.graph.graph import Graph as TGraph
from pygcn_tpu_torch.graph.graph import drop_zero_tiles
from pygcn_tpu_torch.ops import gat as tgat
from pygcn_tpu_torch.ops.cuda import bcsr_spmm as tb
from pygcn_tpu_torch.ops.cuda import gat_tile_attn as ttile
from pygcn_tpu_torch.ops.spmm import spmm as t_spmm
from pygcn_tpu_torch.ops.spmm import spmm_t as t_spmm_t

torch.set_num_threads(1)


@contextlib.contextmanager
def stream_mode(jax_too=True):
    """Both flags of both packages (only the port's when not ``jax_too``) in
    the stream modes for the ``with`` block."""
    old = (jb.BCSR_STREAM, jtile.TILE_REVISIT, tb.BCSR_STREAM, ttile.TILE_REVISIT)
    try:
        tb.BCSR_STREAM, ttile.TILE_REVISIT = True, False
        if jax_too:
            jb.BCSR_STREAM, jtile.TILE_REVISIT = True, False
            jax.clear_caches()
        yield
    finally:
        jb.BCSR_STREAM, jtile.TILE_REVISIT, tb.BCSR_STREAM, ttile.TILE_REVISIT = old
        if jax_too:
            jax.clear_caches()


_SPMM_GRAPHS = {}


def spmm_graphs(tiles):
    """The asymmetric graph of ``tests/test_torch_spmm.py`` with its BCSR
    and hybrid tiles (and their transposes) stored as ``tiles``."""
    if tiles not in _SPMM_GRAPHS:
        s, d, w = coo()
        kw = dict(KW, hybrid_tile_dtype="bfloat16") if tiles == "bf16" else KW
        jg, tg = JGraph.from_coo(s, d, w, **kw), TGraph.from_coo(s, d, w, **kw)
        if tiles == "bf16":
            jg = dataclasses.replace(jg, bcsr=_bf16(jg.bcsr, jnp), bcsr_t=_bf16(jg.bcsr_t, jnp))
            tg = dataclasses.replace(tg, bcsr=_bf16(tg.bcsr, torch), bcsr_t=_bf16(tg.bcsr_t, torch))
            assert tg.hybrid.bcsr.data.dtype == torch.bfloat16
        _SPMM_GRAPHS[tiles] = (jg, tg)
    return _SPMM_GRAPHS[tiles]


def _bf16(bcsr, lib):
    data = bcsr.data.astype(jnp.bfloat16) if lib is jnp else bcsr.data.to(torch.bfloat16)
    return dataclasses.replace(bcsr, data=data)


@pytest.mark.parametrize("tiles", ["f32", "bf16"])
@pytest.mark.parametrize("h", [1, 40, 200])
@pytest.mark.parametrize("impl", ["bcsr", "hybrid"])
def test_stream_spmm_matches_jax(impl, h, tiles):
    """``spmm`` (value and VJP) and ``spmm_t`` (value) over B2's parts and the
    sum merge; H = 200 is ragged across two 128-column slabs."""
    jg, tg = spmm_graphs(tiles)
    n = tg.n_nodes
    before = (tb.launches, tb.stream_launches)
    with stream_mode():
        x, _, (yj, yt), (dj, dt) = run_both(j_spmm, t_spmm, jg, tg, impl, (n, h), h)
        yj_t = np.asarray(jax.jit(lambda v: j_spmm_t(jg, v, impl=impl))(jnp.asarray(x)))
        yt_t = t_spmm_t(tg, torch.from_numpy(x), impl=impl).numpy()
    assert (tb.launches, tb.stream_launches) == before  # CPU tensors: plain versions only
    for got, want, tol in ((yt, yj, VAL), (dt, dj, GRAD), (yt_t, yj_t, VAL)):
        assert got.shape == want.shape == (n, h)
        np.testing.assert_allclose(got, want, **tol)
    if impl == "bcsr":
        assert not yt[128:256].any()  # the block row without edges


@pytest.mark.parametrize("tiles", ["f32", "bf16"])
def test_b2_parts_merge_to_b1_and_empty_rows(tiles):
    """B2's plain parts are one ``[128, H]`` block per tile; merged by block
    row they equal B1's plain product, and so does the B2 dispatcher's merged
    output, with and without the padding tile of the block row that has no
    edges."""
    _, tg = spmm_graphs(tiles)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((tg.n_nodes, 40))
                         .astype(np.float32))
    ref = tb.bcsr_spmm_plain(tg.bcsr, x, n_rows=tg.n_nodes)
    for bcsr in (tg.bcsr, drop_zero_tiles(tg.bcsr)):
        parts = tb.bcsr_spmm_stream_plain(bcsr, x)
        assert parts.shape == (bcsr.data.shape[0], 128, 40)
        torch.testing.assert_close(tb.sum_by_block_row(parts, bcsr, tg.n_nodes), ref,
                                   rtol=0, atol=0)
        torch.testing.assert_close(tb.bcsr_spmm_stream(bcsr, x, n_rows=tg.n_nodes), ref,
                                   rtol=0, atol=0)
    assert (drop_zero_tiles(tg.bcsr).block_rows != 1).all()
    with stream_mode(jax_too=False):
        out = tb.bcsr_spmm(drop_zero_tiles(tg.bcsr), x, n_rows=tg.n_nodes)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert not out[128:256].any()


def _partials_both(symmetric, ops, cot, meta=(2, 4, 0.2)):
    """``gat_tile_partials`` (num, den, m) and the VJP of ``cot`` in both packages."""
    jg, tg = gat_graphs(symmetric)
    jt, tt = jtile.transpose_bcsr(jg.hybrid.bcsr), ttile.transpose_bcsr(tg.hybrid.bcsr)
    j_out, j_vjp = jax.vjp(lambda *a: jtile.gat_tile_partials(meta, jg.hybrid.bcsr, jt, *a),
                           *[jnp.asarray(a) for a in ops])
    j_grads = j_vjp((jnp.asarray(cot[0]), jnp.asarray(cot[1]), jnp.zeros_like(j_out[2])))
    t_args = [torch.from_numpy(a).requires_grad_(True) for a in ops]
    t_out = ttile.gat_tile_partials(meta, tg.hybrid.bcsr, tt, *t_args)
    t_grads = torch.autograd.grad(t_out[:2], t_args, [torch.from_numpy(c) for c in cot])
    return (j_out, j_grads), ([o.detach() for o in t_out], t_grads)


@SYM
def test_stream_gat_tile_partials_matches_jax(symmetric):
    """num/den/m (B4 and the softmax merge) and dlsrc/dldst/ds (B5s, B6s and
    the sum merges) against JAX's stream mode."""
    ops = tile_operands(41)
    rng = np.random.default_rng(42)
    cot = [rng.normal(size=(ops[0].shape[0], w)).astype(np.float32) for w in (8, 2)]
    with stream_mode():
        (j_out, j_grads), (t_out, t_grads) = _partials_both(symmetric, ops, cot)
    for t_o, j_o in zip(t_out, j_out):
        np.testing.assert_allclose(np_of(t_o), np.asarray(j_o), **VAL)
    for t_g, j_g in zip(t_grads, j_grads):
        np.testing.assert_allclose(np_of(t_g), np.asarray(j_g), **GRAD)
    assert (t_out[2][128:256] == ttile.NEG).all() and not t_out[1][128:256].any()


@SYM
def test_stream_gat_conv_hybrid_matches_jax_and_revisit(symmetric):
    """``gat_conv_hybrid`` in the stream mode against JAX's stream mode, and
    against the port's own revisit mode."""
    jg, tg = gat_graphs(symmetric)
    jt, tt = jgat.build_gat_tiles_t(jg), tgat.build_gat_tiles_t(tg)
    args = gat_inputs(43)
    with stream_mode():
        check_vjp(lambda s, a, b: jgat.gat_conv_hybrid(jg, jt, s, a, b),
                  lambda s, a, b: tgat.gat_conv_hybrid(tg, tt, s, a, b), args, 44)
    outs = {}
    cot = torch.from_numpy(np.random.default_rng(45).normal(size=args[0].shape)
                           .astype(np.float32))
    for mode in ("revisit", "stream"):
        t_args = [torch.from_numpy(a).requires_grad_(True) for a in args]
        with stream_mode(jax_too=False) if mode == "stream" else contextlib.nullcontext():
            out = tgat.gat_conv_hybrid(tg, tt, *t_args)
            outs[mode] = [out.detach(), *torch.autograd.grad(out, t_args, cot)]
    torch.testing.assert_close(outs["stream"][0], outs["revisit"][0], **VAL)
    for a, b in zip(outs["stream"][1:], outs["revisit"][1:]):
        torch.testing.assert_close(a, b, **GRAD)


def test_stream_block_rows_without_tiles():
    """A block row that owns no tile (the padding tile removed, in the
    forward and the transpose tiles) gives, in the stream mode, what it gives
    with the padding tile: num = den = 0, m = NEG, zero gradients there."""
    _, tg = gat_graphs(True)
    bcsr = tg.hybrid.bcsr
    bcsr_t = ttile.transpose_bcsr(bcsr)
    bare, bare_t = drop_zero_tiles(bcsr), drop_zero_tiles(bcsr_t)
    assert bare.block_row_ptr[1] == bare.block_row_ptr[2]  # block row 1: no tile
    meta = (3, 5, 0.2)
    ops = tile_operands(47, 3, 5)
    n = ops[0].shape[0]
    cot = [torch.from_numpy(np.random.default_rng(48).normal(size=shape).astype(np.float32))
           for shape in ((n, 15), (n, 3))]
    results = []
    with stream_mode(jax_too=False):
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


@pytest.mark.parametrize("forward_mode", ["revisit", "stream"])
def test_flag_kept_from_forward_to_backward(forward_mode, monkeypatch):
    """The backward runs the forward's mode even when the flag flips in
    between; the gradient is the one of an unflipped run."""
    _, tg = gat_graphs(False)
    bcsr, bcsr_t = tg.hybrid.bcsr, ttile.transpose_bcsr(tg.hybrid.bcsr)
    ops = tile_operands(49)
    cot = [torch.from_numpy(np.random.default_rng(50).normal(size=(ops[0].shape[0], w))
                            .astype(np.float32)) for w in (8, 2)]
    revisit = forward_mode == "revisit"

    def run(flip):
        monkeypatch.setattr(ttile, "TILE_REVISIT", revisit)
        args = [torch.from_numpy(a).requires_grad_(True) for a in ops]
        out = ttile.gat_tile_partials((2, 4, 0.2), bcsr, bcsr_t, *args)
        if flip:
            monkeypatch.setattr(ttile, "TILE_REVISIT", not revisit)
        return torch.autograd.grad(out[:2], args, cot)

    ref = run(flip=False)
    calls = []
    for name in ("tile_bwd_dldst_plain", "tile_bwd_dldst_stream_plain"):
        fn = getattr(ttile, name)
        monkeypatch.setattr(ttile, name,
                            lambda *a, _fn=fn, _name=name: calls.append(_name) or _fn(*a))
    got = run(flip=True)
    assert calls[0] == ("tile_bwd_dldst_plain" if revisit else "tile_bwd_dldst_stream_plain")
    assert ("tile_bwd_dldst_plain" in calls) == revisit
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_gatv2_unchanged_by_the_stream_flag():
    """GATv2 has no stream mode: its partials and VJP are the same with
    ``TILE_REVISIT = False``."""
    _, tg = gat_graphs(False)
    bcsr, bcsr_t = tg.hybrid.bcsr, ttile.transpose_bcsr(tg.hybrid.bcsr)
    rng = np.random.default_rng(51)
    ops = [rng.normal(size=shape).astype(np.float32)
           for shape in ((tg.n_nodes, 8), (tg.n_nodes, 8), (2, 4))]
    cot = [torch.from_numpy(rng.normal(size=(tg.n_nodes, w)).astype(np.float32))
           for w in (8, 2)]
    results = []
    for ctx in (contextlib.nullcontext(), stream_mode(jax_too=False)):
        with ctx:
            args = [torch.from_numpy(a).requires_grad_(True) for a in ops]
            out = ttile.gatv2_tile_partials((2, 4, 0.2), bcsr, bcsr_t, *args)
            results.append([o.detach() for o in out]
                           + list(torch.autograd.grad(out[:2], args, cot)))
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
