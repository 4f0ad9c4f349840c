"""The work schedule of kernels B3, B5-B9 on the CPU, and wide heads.

B3 and B7 cut each block row's tiles into work items of at most C tiles
(B1's ``spmm_schedule``); the items of a split row write partials that the
last to arrive merges in item order by the flash merge. ``scheduled_merge``
is that split-and-merge in plain PyTorch. On the long-row tile set
(``apps/time_spmm.long_row_matrix`` made square: block rows of 0, 1, C, C + 1,
43 and 2 tiles, then 38 without tiles, a ragged last block) it is held
against the plain versions and against the JAX package's
``gat_tile_partials`` and ``gatv2_tile_partials`` (their Pallas bodies in
interpret mode, as the JAX package's own tests run them): values to 1e-5,
``m`` exactly against the plain versions and JAX's GAT. JAX's GATv2 logit
sums its F terms as XLA compiles them (its own contraction of products and
sums), so there ``m`` agrees to 1e-5 like the values, not bit for bit; both
packages' ``m`` are then held against an f64 evaluation of the same edges,
each within the bound of f32 summation, (F + 3) u sum_f |a_f leaky(pre_f)|
(u = 2^-24), of the row's largest such sum.

Wide heads (F = 65 and 128, above one 64-column slab): the port's partials
and their gradients against JAX's, to 1e-4, on the 320-node graphs of
``tests/test_torch_gat.py``. GATv2's attention vector ``a`` is scaled by
1/sqrt(F), as a layer initialised for fan-in F holds it, so that the logits
(sums of F terms) stay of unit scale at every F. At unit ``a`` and F = 128
(logits of tens, gradients of hundreds) a few values of the two packages
part by more than 1e-4; that case holds each package against the f64
evaluation instead: within 1e-4 of the largest value, errors within 4x of
each other, and ``m`` within the summation bound.

B8 and B9 sum a split row's gradient partials in item order (``scheduled_sum``:
each item's tiles, then the row's items): held against the plain versions
and JAX's VJP of ``gatv2_tile_partials`` on the long-row set at C = 1, 2, 4
and 8, and at one head of 224 (past every width whose whole rows would fit
an H100's shared memory). On rows of more own edges in one work item than a
batch of the chunked kernels holds (a 300-node set at density 0.35), the
scheduled B7, B8 and B9 are held against the plain versions and JAX. B8
shares B7's work items on the forward tiles and
B9 has its own on the transpose tiles: checked by driving the wrappers with a
stand-in library.

B5 and B6 sum their split rows the same way (``scheduled_sum`` of B5s's and
B6s's per-tile partials): held against the plain versions and JAX's VJP of
``gat_tile_partials`` on the long-row set at C = 1, 2, 4 and 8, and at
F = 65 and 128 on the 320-node graphs. B5 runs on B3's work items and
counters over the forward tiles, B6 on the transpose tiles' own: checked with
the stand-in library too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from test_torch_gat import GRAD, N, graphs, np_of

from pygcn_tpu.graph.graph import _build_bcsr as j_build_bcsr
from pygcn_tpu.ops.pallas import gat_tile_attn as jtile

from pygcn_tpu_torch.apps.time_spmm import long_row_counts, long_row_matrix
from pygcn_tpu_torch.graph.graph import _build_bcsr, drop_zero_tiles
from pygcn_tpu_torch.ops.cuda import bcsr_spmm as b1
from pygcn_tpu_torch.ops.cuda import gat_tile_attn as gta

torch.set_num_threads(1)

VAL = dict(rtol=1e-5, atol=1e-5)
H, F, SLOPE = 2, 4, 0.2
C = gta.MAX_TILES


def square_long_rows(c, seed=0):
    """The long-row matrix padded to a square node space (its columns)."""
    m = long_row_matrix(c, np.random.default_rng(seed))
    n = m.shape[1]
    return sp.coo_matrix((np.ones(m.nnz, np.float32), (m.row, m.col)), shape=(n, n))


def long_row_sets(c):
    """The port's tiles (no padding tiles) and JAX's (with them), and n."""
    m = square_long_rows(c)
    b = drop_zero_tiles(_build_bcsr(m, (128, 128)))
    assert tuple(np.diff(b.block_row_ptr.numpy()))[:6] == long_row_counts(c)
    return b, j_build_bcsr(m, (128, 128)), m.shape[0]


def operands(v2, n, h=H, f=F, seed=1):
    rng = np.random.default_rng(seed)
    if v2:
        return (rng.normal(size=(n, h * f)).astype(np.float32),
                rng.normal(size=(n, h * f)).astype(np.float32),
                rng.normal(size=(h, f)).astype(np.float32))
    return (rng.normal(size=(n, h)).astype(np.float32),
            rng.normal(size=(n, h)).astype(np.float32),
            rng.normal(size=(n, h * f)).astype(np.float32))


def port_fns(v2):
    """(plain, scheduled model, partials) of B7 with ``v2``, else of B3."""
    if v2:
        return gta.tile_v2_fwd_plain, gta.tile_v2_fwd_scheduled_plain, jtile.gatv2_tile_partials
    return gta.tile_fwd_plain, gta.tile_fwd_scheduled_plain, jtile.gat_tile_partials


def assert_partials(got, ref, exact_m=True):
    """num and den to 1e-5, m bit for bit (or, without ``exact_m``, to 1e-5)."""
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(np_of(g), np_of(r), **VAL)
    np.testing.assert_allclose(np_of(got[2]), np_of(ref[2]),
                               **(dict(rtol=0, atol=0) if exact_m else VAL))


@pytest.mark.parametrize("v2", [False, True], ids=["gat", "gatv2"])
def test_scheduled_merge_matches_plain_and_jax(v2):
    b, jb, n = long_row_sets(C)
    ops = operands(v2, n)
    plain, model, j_partials = port_fns(v2)
    t_ops = [torch.from_numpy(x) for x in ops]
    got = model(b, *t_ops, H, F, SLOPE, C)
    assert_partials(got, plain(b, *t_ops, H, F, SLOPE))
    j_out = j_partials((H, F, SLOPE), jb, jtile.transpose_bcsr(jb),
                       *[jnp.asarray(x) for x in ops])
    assert_partials(got, [np.asarray(x)[:n] for x in j_out], exact_m=not v2)
    if v2:  # both m within f32 summation error of the f64 logits' max
        (_, _, m64), _, bound = v2_f64(b, n, ops, None, H, F)
        live = m64 > gta.NEG / 2
        for m in (np_of(got[2]), np.asarray(j_out[2])[:n]):
            assert (np.abs(m[live] - m64[live]) <= bound[live]).all()
    # block row 0 has no tile; the split rows (C + 1 and 43 tiles) have rows
    # that some of their items miss, whose parts are still at NEG there
    assert (got[2][:128] == gta.NEG).all() and not got[0][:128].any() and not got[1][:128].any()
    assert (got[2][128:768] > gta.NEG).any()


@pytest.mark.parametrize("max_tiles", [1, 4, 8])
@pytest.mark.parametrize("v2", [False, True], ids=["gat", "gatv2"])
def test_scheduled_merge_at_any_c(v2, max_tiles):
    """The model at other item sizes C, on the tile set made for C = 2: the
    same function, ``m`` exactly."""
    b, _, n = long_row_sets(C)
    plain, model, _ = port_fns(v2)
    t_ops = [torch.from_numpy(x) for x in operands(v2, n, seed=max_tiles)]
    assert_partials(model(b, *t_ops, H, F, SLOPE, max_tiles), plain(b, *t_ops, H, F, SLOPE))


def test_scheduled_merge_adds_nothing_from_parts_at_neg():
    """Two items of one row, the second without an edge on row 0: the merge
    equals the first item's partial there, whatever the second's sums hold
    (a part at NEG is scaled by 0, never by exp(NEG - NEG) = 1)."""
    t = 2
    b = gta.BCSR(data=torch.zeros(t, 128, 128), block_rows=torch.zeros(t, dtype=torch.int32),
                 block_cols=torch.arange(t, dtype=torch.int32),
                 block_row_ptr=torch.tensor([0, t], dtype=torch.int32), tm=128, tk=128,
                 n_block_rows=1, n_block_cols=t)
    max_t = torch.full((t, 128, 1), gta.NEG)
    max_t[0, 0] = 0.5
    den_t, num_t = torch.ones(t, 128, 1), torch.full((t, 128, 3), 2.0)
    num, den, m = gta.scheduled_merge(b, num_t, den_t, max_t, 128, 1)
    assert m[0, 0] == 0.5 and den[0, 0] == 1.0 and (num[0] == 2.0).all()
    assert (m[1:] == gta.NEG).all() and not den[1:].any() and not num[1:].any()


def test_item_schedule_is_cached_apart_from_b1s(monkeypatch):
    """B3/B7's schedule lives in ``bcsr.cache`` under its own key, with its own
    counters (one per split item, zero), and is built once per tile set and C."""
    b, _, _ = long_row_sets(C)
    sched, counters = gta._item_schedule(b)
    assert ("gat_tile", C) in b.cache and len(b.cache) == 1
    assert torch.equal(sched.items, b1.spmm_schedule(b, C).items)
    assert counters.numel() == sched.n_slots and not counters.any()
    assert gta._item_schedule(b)[1] is counters
    b1._device_schedule(b, 40)
    assert len(b.cache) == 2 and gta._item_schedule(b)[1] is counters
    monkeypatch.setattr(gta, "MAX_TILES", 4)
    assert gta._item_schedule(b)[0].items.shape[0] < sched.items.shape[0]


def v2_f64(b, n, ops, cot, h, f):
    """GATv2's partials ``(num, den, m)`` over the tile edges of ``b`` in f64
    from the f32 operands ``ops`` (numpy), one edge at a time, with ``m``
    held fixed in the VJP as the kernels hold it; their gradients
    ``(dsl, dsr, da)`` for the cotangents ``cot`` (None: none); and per row the
    bound on f32 error in ``m``, ``(F + 3) u`` times the largest
    ``sum_f |a_f leaky(pre_f)|`` over the row's edges."""
    t, r, c = torch.nonzero(b.data, as_tuple=True)
    v, u = b.block_rows.long()[t] * b.tm + r, b.block_cols.long()[t] * b.tk + c
    keep = (v < n) & (u < n)
    v, u = v[keep], u[keep]
    sl, sr, a = (torch.from_numpy(x).double().requires_grad_(cot is not None) for x in ops)
    pre = sl.view(n, h, f)[u] + sr.view(n, h, f)[v]  # [E, h, f]
    terms = a * torch.where(pre >= 0, pre, SLOPE * pre)
    e = terms.sum(-1)
    rows = v[:, None].expand(-1, h)
    m = torch.full((n, h), gta.NEG, dtype=torch.float64).scatter_reduce(0, rows, e.detach(), "amax")
    p = torch.exp(e - m[v])
    den = torch.zeros(n, h, dtype=torch.float64).index_add(0, v, p)
    num = torch.zeros(n, h, f, dtype=torch.float64).index_add(
        0, v, p[..., None] * sl.view(n, h, f)[u]).view(n, h * f)
    grads = None
    if cot is not None:
        grads = [g.numpy() for g in torch.autograd.grad(
            (num, den), (sl, sr, a), [torch.from_numpy(x).double() for x in cot])]
    bound = torch.zeros(n, h, dtype=torch.float64).scatter_reduce(
        0, rows, terms.detach().abs().sum(-1), "amax") * (f + 3) * 2.0 ** -24
    return (num.detach().numpy(), den.detach().numpy(), m.numpy()), grads, bound.numpy()


def wide_case(v2, symmetric, h, f, unit_a=False):
    """Operands, cotangents, and outputs and VJPs of both packages' partials
    at heads ``h`` of width ``f``; GATv2's ``a`` scaled by 1/sqrt(F) unless
    ``unit_a``."""
    jg, tg = graphs(symmetric)
    jt, tt = jtile.transpose_bcsr(jg.hybrid.bcsr), gta.transpose_bcsr(tg.hybrid.bcsr)
    ops = operands(v2, N, h, f, seed=f)
    if v2 and not unit_a:
        ops = (*ops[:2], ops[2] / np.float32(np.sqrt(f)))
    rng = np.random.default_rng(f + 1)
    cot = [rng.normal(size=(N, h * f)).astype(np.float32),
           rng.normal(size=(N, h)).astype(np.float32)]
    j_fn = jtile.gatv2_tile_partials if v2 else jtile.gat_tile_partials
    t_fn = gta.gatv2_tile_partials if v2 else gta.gat_tile_partials
    j_out, j_vjp = jax.vjp(lambda *x: j_fn((h, f, SLOPE), jg.hybrid.bcsr, jt, *x),
                           *[jnp.asarray(x) for x in ops])
    j_grads = j_vjp((jnp.asarray(cot[0]), jnp.asarray(cot[1]), jnp.zeros_like(j_out[2])))
    t_args = [torch.from_numpy(x).requires_grad_(True) for x in ops]
    t_out = t_fn((h, f, SLOPE), tg.hybrid.bcsr, tt, *t_args)
    t_grads = torch.autograd.grad(t_out[:2], t_args, [torch.from_numpy(c) for c in cot])
    return (ops, cot), (j_out, j_grads), (t_out, t_grads)


@pytest.mark.parametrize("hf", [(2, 65), (1, 128)], ids=["2x65", "1x128"])
@pytest.mark.parametrize("v2", [False, True], ids=["gat", "gatv2"])
def test_wide_heads_match_jax(v2, hf):
    """Per-head widths above 64: the partials and their gradients
    (``dlsrc, dldst, ds`` or ``dsl, dsr, da``) against JAX's, to 1e-4."""
    _, (j_out, j_grads), (t_out, t_grads) = wide_case(v2, True, *hf)
    for t_o, j_o in zip(t_out, j_out):
        np.testing.assert_allclose(np_of(t_o), np.asarray(j_o), **GRAD)
    for t_g, j_g in zip(t_grads, j_grads):
        np.testing.assert_allclose(np_of(t_g), np.asarray(j_g), **GRAD)


def test_wide_gatv2_at_unit_a_is_f32_rounding():
    """GATv2 at one head of 128 and unit ``a``: the port and JAX each against
    the f64 evaluation, partials and gradients within 1e-4 of the largest
    value with errors within 4x of each other, ``m`` within the bound of f32
    summation."""
    h, f = 1, 128
    (ops, cot), (j_out, j_grads), (t_out, t_grads) = wide_case(True, True, h, f, unit_a=True)
    ref, ref_grads, bound = v2_f64(graphs(True)[1].hybrid.bcsr, N, ops, cot, h, f)
    live = ref[2] > gta.NEG / 2
    for i, (t, j, r) in enumerate(zip([*t_out, *t_grads], [*j_out, *j_grads], [*ref, *ref_grads])):
        t, j = np_of(t).astype(np.float64), np.asarray(j)[:r.shape[0]].astype(np.float64)
        if i == 2:
            t, j, r = t[live], j[live], r[live]
            assert (np.abs(t - r) <= bound[live]).all() and (np.abs(j - r) <= bound[live]).all()
        scale = np.abs(r).max()
        err_t, err_j = np.abs(t - r).max(), np.abs(j - r).max()
        assert max(err_t, err_j) <= 1e-4 * scale, (i, err_t, err_j, scale)
        floor = 1e-7 * scale
        assert err_t <= 4 * max(err_j, floor) and err_j <= 4 * max(err_t, floor), (i, err_t, err_j)


def v2_backward_case(b, jb, n, h, f, seed=3):
    """GATv2 operands at heads ``h`` of width ``f`` (``a`` scaled by
    1/sqrt(F)), the port's forward ``m`` and cotangents, and JAX's VJP of
    ``gatv2_tile_partials`` on its tiles ``jb`` (``dsl, dsr, da``)."""
    sl2, sr2, a = operands(True, n, h, f, seed=seed)
    a = a / np.float32(np.sqrt(f))
    rng = np.random.default_rng(seed + 1)
    dnum = rng.normal(size=(n, h * f)).astype(np.float32)
    dden = rng.normal(size=(n, h)).astype(np.float32)
    _, vjp = jax.vjp(lambda *x: jtile.gatv2_tile_partials((h, f, SLOPE), jb,
                                                          jtile.transpose_bcsr(jb), *x),
                     jnp.asarray(sl2), jnp.asarray(sr2), jnp.asarray(a))
    j_grads = vjp((jnp.asarray(dnum), jnp.asarray(dden), jnp.zeros((n, h), jnp.float32)))
    t = [torch.from_numpy(x) for x in (sl2, sr2, a)]
    m = gta.tile_v2_fwd_plain(b, *t, h, f, SLOPE)[2]
    bwd = (*t, m, torch.from_numpy(dnum), torch.from_numpy(dden), h, f, SLOPE)
    return bwd, [np.asarray(g) for g in j_grads]


def scheduled_grads(b, bt, bwd, h, f, max_tiles):
    """``dsl, dsr, da`` as B9 and B8 compute them at ``max_tiles``."""
    dsr, dapart = gta.tile_v2_bwd_recv_scheduled_plain(b, *bwd, max_tiles)
    dsl = gta.tile_v2_bwd_send_scheduled_plain(bt, *bwd, max_tiles)
    return dsl, dsr, dapart.sum(dim=0).view(h, f)


def test_b8_b9_scheduled_sums_match_plain_and_jax():
    """B8's and B9's split-row sums (per-tile partials summed per item, then a
    row's items in item order) on the long-row tile set, at C = MAX_TILES:
    against the plain versions (one sum by block row) and the JAX package's
    VJP of ``gatv2_tile_partials``. Gradients, to 1e-4: sums over a row's
    edges of products of the operands, taken in other orders (and ``m`` from
    another logit order in JAX), whose values reach tens."""
    b, jb, n = long_row_sets(C)
    bt = gta.transpose_bcsr(b)
    bwd, j_grads = v2_backward_case(b, jb, n, H, F)
    got = scheduled_grads(b, bt, bwd, H, F, C)
    dsr, dapart = gta.tile_v2_bwd_recv_plain(b, *bwd)
    plain = (gta.tile_v2_bwd_send_plain(bt, *bwd), dsr, dapart.sum(dim=0).view(H, F))
    for g, p, j in zip(got, plain, j_grads):
        np.testing.assert_allclose(np_of(g), np_of(p), **GRAD)
        np.testing.assert_allclose(np_of(g), j[:g.shape[0]], **GRAD)
    # the block row without tiles has no gradient through its receivers
    assert not got[1][:128].any()


@pytest.mark.parametrize("max_tiles", [1, 4, 8])
def test_b8_b9_scheduled_sums_at_any_c(max_tiles):
    """The split-row sums at other item sizes C on the tile set made for
    C = 2 (one item a tile at C = 1; the 43-tile row in 11 or 6 items): the
    plain versions' gradients and the JAX package's VJP of
    ``gatv2_tile_partials``, to 1e-4, as at C = 2."""
    b, jb, n = long_row_sets(C)
    bt = gta.transpose_bcsr(b)
    bwd, j_grads = v2_backward_case(b, jb, n, H, F, seed=max_tiles)
    got = scheduled_grads(b, bt, bwd, H, F, max_tiles)
    dsr, dapart = gta.tile_v2_bwd_recv_plain(b, *bwd)
    plain = (gta.tile_v2_bwd_send_plain(bt, *bwd), dsr, dapart.sum(dim=0).view(H, F))
    for g, p, j in zip(got, plain, j_grads):
        np.testing.assert_allclose(np_of(g), np_of(p), **GRAD)
        np.testing.assert_allclose(np_of(g), j[:g.shape[0]], **GRAD)


def test_scheduled_on_dense_rows_match_plain_and_jax():
    """Rows of more own edges in one work item than a batch of the chunked
    kernels holds (``gta.CHUNK_EDGES``): a ragged 300-node set at density
    0.35, block row 1 without edges, at two heads of 48 (a ragged chunk) and
    ``a`` scaled by 1/sqrt(F). B7's, B8's and B9's functions as they compute
    them (scheduled, at C = MAX_TILES) against the plain versions and JAX's
    ``gatv2_tile_partials`` and its VJP: values to 1e-5, gradients to 1e-4."""
    h, f = 2, 48
    rng = np.random.default_rng(35)
    m = sp.random(300, 300, density=0.35, random_state=rng, format="coo", dtype=np.float32)
    keep = m.row // 128 != 1
    m = sp.coo_matrix((np.ones(int(keep.sum()), np.float32), (m.row[keep], m.col[keep])),
                      shape=m.shape)
    b, jb = _build_bcsr(m, (128, 128)), j_build_bcsr(m, (128, 128))
    bt = gta.transpose_bcsr(b)
    assert min(gta.most_own_edges(b), gta.most_own_edges(bt)) > 2 * gta.CHUNK_EDGES
    bwd, j_grads = v2_backward_case(b, jb, 300, h, f)
    got = gta.tile_v2_fwd_scheduled_plain(b, *bwd[:3], h, f, SLOPE, C)
    assert_partials(got, gta.tile_v2_fwd_plain(b, *bwd[:3], h, f, SLOPE))
    j_out = jtile.gatv2_tile_partials((h, f, SLOPE), jb, jtile.transpose_bcsr(jb),
                                      *[jnp.asarray(np_of(x)) for x in bwd[:3]])
    assert_partials(got, [np.asarray(x)[:300] for x in j_out], exact_m=False)
    grads = scheduled_grads(b, bt, bwd, h, f, C)
    dsr, dapart = gta.tile_v2_bwd_recv_plain(b, *bwd)
    plain = (gta.tile_v2_bwd_send_plain(bt, *bwd), dsr, dapart.sum(dim=0).view(h, f))
    for g, p, j in zip(grads, plain, j_grads):
        np.testing.assert_allclose(np_of(g), np_of(p), **GRAD)
        np.testing.assert_allclose(np_of(g), j[:g.shape[0]], **GRAD)
    assert not grads[1][128:256].any() and (got[2][128:256] == gta.NEG).all()


def test_scheduled_sum_orders_items():
    """A row of three one-tile items sums its parts as ((p0 + p1) + p2), a row
    of one item keeps its part, a row without tiles is zero."""
    b = gta.BCSR(data=torch.ones(4, 128, 128),
                 block_rows=torch.tensor([0, 0, 0, 2], dtype=torch.int32),
                 block_cols=torch.arange(4, dtype=torch.int32) % 3,
                 block_row_ptr=torch.tensor([0, 3, 3, 4], dtype=torch.int32), tm=128, tk=128,
                 n_block_rows=3, n_block_cols=3)
    parts = torch.tensor([1e8, -1e8, 1.0, 5.0]).view(4, 1, 1).expand(4, 128, 2).contiguous()
    out = gta.scheduled_sum(b, parts, 384, 1)
    assert (out[:128] == 1.0).all() and not out[128:256].any() and (out[256:] == 5.0).all()
    swapped = gta.scheduled_sum(b, parts[[2, 1, 0, 3]], 384, 1)
    assert (swapped[:128] == 0.0).all()  # (1 - 1e8) + 1e8 rounds the 1 away


def test_gatv2_at_224_matches_jax():
    """One head of 224, past the widths whose whole rows would fit an H100's
    shared memory (B8, B9: 144; B7: 208), ``a`` scaled by 1/sqrt(F): the
    port's partials
    against JAX's to 1e-5, ``dsl`` and ``dsr`` (each a sum over a node's
    edges) to 1e-4, and B8's and B9's scheduled sums likewise. ``da`` sums
    over every node, values of hundreds that cancel to tenths in places, so
    each package's ``da`` (and the scheduled one) is held against the f64
    evaluation: within 1e-4 of its largest value, the port's error within 4x
    JAX's."""
    h, f = 1, 224
    (ops, cot), (j_out, j_grads), (t_out, t_grads) = wide_case(True, True, h, f)
    for t_o, j_o in zip(t_out, j_out):
        np.testing.assert_allclose(np_of(t_o), np.asarray(j_o), **VAL)
    tg = graphs(True)[1]
    b, bt = tg.hybrid.bcsr, gta.transpose_bcsr(tg.hybrid.bcsr)
    t = [torch.from_numpy(x) for x in ops]
    bwd = (*t, t_out[2].detach(), *(torch.from_numpy(c) for c in cot), h, f, SLOPE)
    sched = scheduled_grads(b, bt, bwd, h, f, C)
    for got in (t_grads, sched):
        for g, j_g in zip(got[:2], j_grads[:2]):
            np.testing.assert_allclose(np_of(g), np.asarray(j_g), **GRAD)
    da64 = v2_f64(b, N, ops, cot, h, f)[1][2]
    scale = np.abs(da64).max()
    err_j = np.abs(np.asarray(j_grads[2], np.float64) - da64).max()
    for da in (t_grads[2], sched[2]):
        err = np.abs(np_of(da).astype(np.float64) - da64).max()
        assert err <= 1e-4 * scale and err <= 4 * max(err_j, 1e-7 * scale), (err, err_j, scale)


class _FakeLib:
    """Stands in for a built GAT library: records each entry point's
    work-item and counter pointers and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args[2], args[-13]))  # items, counters
            return 0
        return entry


def test_b8_shares_b7s_schedule_and_b9_has_its_own(monkeypatch):
    """B8 runs on B7's work items over the forward tiles, the same
    ``("gat_tile", C)`` cache entry, items and counters; B9 on an entry of the
    transpose tiles' own. The wrappers are driven with a stand-in library on
    the CPU (no card here), which records what each launch was given."""
    import contextlib
    import types

    b, _, n = long_row_sets(C)
    bt = gta.transpose_bcsr(b)
    lib = _FakeLib()
    monkeypatch.setattr(gta, "_load", lambda name: lib)
    monkeypatch.setattr(gta, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    t = [torch.from_numpy(x) for x in operands(True, n)]
    m, dden = torch.zeros(n, H), torch.zeros(n, H)
    bwd = (*t, m, torch.zeros(n, H * F), dden, H, F, SLOPE)
    before = dict(gta.launches)
    gta.tile_v2_fwd_cuda(b, *t, H, F, SLOPE)
    gta.tile_v2_bwd_recv_cuda(b, *bwd)
    gta.tile_v2_bwd_send_cuda(bt, *bwd)
    assert [c[0] for c in lib.calls] == ["gatv2_tile_fwd", "gatv2_tile_bwd_recv",
                                         "gatv2_tile_bwd_send"]
    key = ("gat_tile", C)
    assert list(b.cache) == [key] and list(bt.cache) == [key]
    (sched, counters), (sched_t, counters_t) = b.cache[key], bt.cache[key]
    fwd, recv, send = lib.calls
    assert fwd[1:] == recv[1:] == (sched.items.data_ptr(), counters.data_ptr())
    assert send[1:] == (sched_t.items.data_ptr(), counters_t.data_ptr())
    assert torch.equal(sched_t.items, b1.spmm_schedule(bt, C).items)
    assert {k: gta.launches[k] - before[k] for k in before} == {
        **dict.fromkeys(before, 0), "B7": 1, "B8": 1, "B9": 1}


def v1_backward_case(b, jb, n, h, f, seed):
    """GAT operands at heads ``h`` of width ``f``, the port's forward ``m`` and
    cotangents, and JAX's VJP of ``gat_tile_partials`` on its tiles ``jb``
    (``dlsrc, dldst, ds``)."""
    lsrc, ldst, s2 = operands(False, n, h, f, seed=seed)
    rng = np.random.default_rng(seed + 1)
    dnum = rng.normal(size=(n, h * f)).astype(np.float32)
    dden = rng.normal(size=(n, h)).astype(np.float32)
    _, vjp = jax.vjp(lambda *x: jtile.gat_tile_partials((h, f, SLOPE), jb,
                                                        jtile.transpose_bcsr(jb), *x),
                     jnp.asarray(lsrc), jnp.asarray(ldst), jnp.asarray(s2))
    j_grads = vjp((jnp.asarray(dnum), jnp.asarray(dden), jnp.zeros((n, h), jnp.float32)))
    t = [torch.from_numpy(x) for x in (lsrc, ldst, s2)]
    m = gta.tile_fwd_plain(b, *t, h, f, SLOPE)[2]
    bwd = (*t, m, torch.from_numpy(dnum), torch.from_numpy(dden), h, f, SLOPE)
    return bwd, [np.asarray(g) for g in j_grads]


def v1_grads(b, bt, bwd, max_tiles=None):
    """``dlsrc, dldst, ds``: as B6 and B5 compute them at ``max_tiles``, or
    (None) by the plain versions."""
    if max_tiles is None:
        ds, dlsrc = gta.tile_bwd_sender_plain(bt, *bwd)
        return dlsrc, gta.tile_bwd_dldst_plain(b, *bwd), ds
    ds, dlsrc = gta.tile_bwd_sender_scheduled_plain(bt, *bwd, max_tiles)
    return dlsrc, gta.tile_bwd_dldst_scheduled_plain(b, *bwd, max_tiles), ds


@pytest.mark.parametrize("max_tiles", [1, 2, 4, 8])
def test_b5_b6_scheduled_sums_match_plain_and_jax(max_tiles):
    """B5's and B6's split-row sums (per-tile partials summed per item, then a
    row's items in item order) on the long-row tile set and its transpose, at
    C = 1, 2, 4 and 8: against the plain versions (one sum by block row) and
    the JAX package's VJP of ``gat_tile_partials``, to 1e-4 (sums over a row's
    edges of products of the operands, in other orders). The block row
    without tiles has no ``dldst``."""
    b, jb, n = long_row_sets(C)
    bt = gta.transpose_bcsr(b)
    bwd, j_grads = v1_backward_case(b, jb, n, H, F, seed=10 + max_tiles)
    got = v1_grads(b, bt, bwd, max_tiles)
    for g, p, j in zip(got, v1_grads(b, bt, bwd), j_grads):
        np.testing.assert_allclose(np_of(g), np_of(p), **GRAD)
        np.testing.assert_allclose(np_of(g), j[:g.shape[0]], **GRAD)
    assert not got[1][:128].any()


@pytest.mark.parametrize("hf", [(2, 65), (1, 128)], ids=["2x65", "1x128"])
def test_b5_b6_scheduled_wide_heads_match_plain_and_jax(hf):
    """B5's and B6's split-row sums at C = MAX_TILES on heads wider than one
    64-column slab, on the asymmetric 320-node graph: against the plain
    versions and JAX's VJP of ``gat_tile_partials``, to 1e-4."""
    h, f = hf
    (ops, cot), (_, j_grads), (t_out, _) = wide_case(False, False, h, f)
    tg = graphs(False)[1]
    b, bt = tg.hybrid.bcsr, gta.transpose_bcsr(tg.hybrid.bcsr)
    t = [torch.from_numpy(x) for x in ops]
    bwd = (*t, t_out[2].detach(), *(torch.from_numpy(c) for c in cot), h, f, SLOPE)
    got = v1_grads(b, bt, bwd, C)
    for g, p, j in zip(got, v1_grads(b, bt, bwd), j_grads):
        np.testing.assert_allclose(np_of(g), np_of(p), **GRAD)
        np.testing.assert_allclose(np_of(g), np.asarray(j), **GRAD)


def test_b5_shares_b3s_schedule_and_b6_has_its_own(monkeypatch):
    """B5 runs on B3's work items over the forward tiles, the same
    ``("gat_tile", C)`` cache entry, items and counters; B6 on an entry of the
    transpose tiles' own. The wrappers are driven with a stand-in library on
    the CPU, which records what each launch was given; each launch is counted
    once."""
    import contextlib
    import types

    b, _, n = long_row_sets(C)
    bt = gta.transpose_bcsr(b)
    lib = _FakeLib()
    monkeypatch.setattr(gta, "_load", lambda name: lib)
    monkeypatch.setattr(gta, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    t = [torch.from_numpy(x) for x in operands(False, n)]
    bwd = (*t, torch.zeros(n, H), torch.zeros(n, H * F), torch.zeros(n, H), H, F, SLOPE)
    before = dict(gta.launches)
    gta.tile_fwd_cuda(b, *t, H, F, SLOPE)
    gta.tile_bwd_dldst_cuda(b, *bwd)
    gta.tile_bwd_sender_cuda(bt, *bwd)
    assert [c[0] for c in lib.calls] == ["gat_tile_fwd", "gat_tile_bwd_dldst",
                                         "gat_tile_bwd_sender"]
    key = ("gat_tile", C)
    assert list(b.cache) == [key] and list(bt.cache) == [key]
    (sched, counters), (sched_t, counters_t) = b.cache[key], bt.cache[key]
    fwd, dldst, sender = lib.calls
    assert fwd[1:] == dldst[1:] == (sched.items.data_ptr(), counters.data_ptr())
    assert sender[1:] == (sched_t.items.data_ptr(), counters_t.data_ptr())
    assert torch.equal(sched_t.items, b1.spmm_schedule(bt, C).items)
    assert {k: gta.launches[k] - before[k] for k in before} == {
        **dict.fromkeys(before, 0), "B3": 1, "B5": 1, "B6": 1}
