"""The port's SpMM engine against the JAX package's, values and gradients.

One asymmetric graph (ragged 300 nodes, an empty block row, at most 9 tiles
per direction) carries every layout. For each implementation, ``spmm`` and
``spmm_t`` in both packages get the same NumPy input; the port's gradient
(``torch.autograd``) is held against ``jax.vjp`` with the same fixed
cotangent. JAX's BCSR path runs kernel B1's Pallas body in interpret mode,
as the JAX package's own tests do; the port runs B1's plain version, which
is its only path for CPU tensors. JAX runs at ``highest`` matmul precision
(``tests/conftest.py``), so f32 values agree to 1e-5 and gradients to 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygcn_tpu.graph.graph import Graph as JGraph
from pygcn_tpu.ops.spmm import sddmm as j_sddmm
from pygcn_tpu.ops.spmm import spmm as j_spmm
from pygcn_tpu.ops.spmm import spmm_t as j_spmm_t

from pygcn_tpu_torch.graph.graph import Graph as TGraph
from pygcn_tpu_torch.ops.cuda import bcsr_spmm as b1
from pygcn_tpu_torch.ops.spmm import sddmm as t_sddmm
from pygcn_tpu_torch.ops.spmm import spmm as t_spmm
from pygcn_tpu_torch.ops.spmm import spmm_t as t_spmm_t

torch.set_num_threads(1)

N = 300
KW = dict(n_nodes=N, build_dense=True, build_bcsr=True, build_ell=True,
          build_hybrid=True, hybrid_min_edges_per_tile=24)
IMPLS = ["dense", "segment", "ell", "hybrid", "bcsr"]
# x shapes: 1-D, three widths (40 is the last GCN layer's, 130 crosses a
# 128-column slab), and a batch folded into [N, B*H]
SHAPES = {"1d": (N,), "h16": (N, 16), "h40": (N, 40), "h130": (N, 130), "batch": (3, N, 8)}


def coo(seed=0, n=N, e=2600):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    keep = dst // 128 != 1  # block row 1 has no edges
    return src[keep], dst[keep], rng.uniform(0.1, 1.0, int(keep.sum())).astype(np.float32)


_GRAPHS = {}


def graphs(symmetric=False):
    if symmetric not in _GRAPHS:
        s, d, w = coo()
        if symmetric:
            s, d, w = np.concatenate([s, d]), np.concatenate([d, s]), np.concatenate([w, w])
        _GRAPHS[symmetric] = (JGraph.from_coo(s, d, w, is_symmetric=symmetric, **KW),
                              TGraph.from_coo(s, d, w, is_symmetric=symmetric, **KW))
    return _GRAPHS[symmetric]


def dense_of(tg):
    return tg.to_scipy().toarray().astype(np.float64)


def run_both(fn_j, fn_t, jg, tg, impl, shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    cot = rng.standard_normal(shape).astype(np.float32)
    y_j, vjp = jax.vjp(jax.jit(lambda v: fn_j(jg, v, impl=impl)), jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_(True)
    y_t = fn_t(tg, xt, impl=impl)
    (dx_t,) = torch.autograd.grad(y_t, xt, torch.from_numpy(cot))
    return x, cot, (np.asarray(y_j), y_t.detach().numpy()), (np.asarray(dx_j), dx_t.numpy())


@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
@pytest.mark.parametrize("impl", IMPLS)
def test_spmm_matches_jax(impl, shape):
    jg, tg = graphs()
    x, cot, (yj, yt), (dj, dt) = run_both(j_spmm, t_spmm, jg, tg, impl, SHAPES[shape], 1)
    assert yt.shape == yj.shape == x.shape
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dt, dj, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", ["1d", "h40", "h130", "batch"])
@pytest.mark.parametrize("impl", IMPLS)
def test_spmm_t_matches_jax(impl, shape):
    jg, tg = graphs()
    rng = np.random.default_rng(2)
    x = rng.standard_normal(SHAPES[shape]).astype(np.float32)
    cot = rng.standard_normal(SHAPES[shape]).astype(np.float32)
    yj = np.asarray(jax.jit(lambda v: j_spmm_t(jg, v, impl=impl))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = t_spmm_t(tg, xt, impl=impl)
    np.testing.assert_allclose(yt.detach().numpy(), yj, rtol=1e-5, atol=1e-5)
    # JAX's spmm_t on BCSR calls the Pallas kernel without a VJP, so the
    # gradient of A^T x is taken through JAX's dense path there
    impl_j = "dense" if impl == "bcsr" else impl
    _, vjp = jax.vjp(jax.jit(lambda v: j_spmm_t(jg, v, impl=impl_j)), jnp.asarray(x))
    (dj,) = vjp(jnp.asarray(cot))
    (dt,) = torch.autograd.grad(yt, xt, torch.from_numpy(cot))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("impl", ["ell", "hybrid", "bcsr"])
def test_symmetric_graph_reuses_forward_layout(impl):
    jg, tg = graphs(symmetric=True)
    assert tg.bcsr_t is None and tg.hybrid_t is tg.hybrid and tg.ell_t is tg.ell
    x, cot, (yj, yt), (dj, dt) = run_both(j_spmm, t_spmm, jg, tg, impl, (N, 40), 3)
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dt, dj, rtol=1e-4, atol=1e-4)
    a = dense_of(tg)
    np.testing.assert_allclose(dt, a.T @ cot, rtol=1e-4, atol=1e-4)


def test_auto_impl_resolution():
    from pygcn_tpu.ops.spmm import _resolve_impl as j_resolve
    from pygcn_tpu_torch.ops.spmm import _resolve_impl as t_resolve

    s, d, w = coo()
    for kw in (dict(), dict(dense_max_nodes=100), dict(build_dense=False, build_hybrid=False),
               dict(build_dense=False, build_hybrid=False, build_ell=False, build_bcsr=True),
               dict(build_dense=False, build_hybrid=False, build_ell=False, build_bcsr=False)):
        jg = JGraph.from_coo(s, d, w, n_nodes=N, **kw)
        tg = TGraph.from_coo(s, d, w, n_nodes=N, **kw)
        assert t_resolve(tg, "auto") == j_resolve(jg, "auto"), kw


@pytest.mark.parametrize("layout", ["ell", "hybrid", "bcsr"])
def test_asymmetric_transpose_guard(layout):
    jg, tg = graphs()
    jbad = dataclasses.replace(jg, **{f"{layout}_t": None})
    tbad = dataclasses.replace(tg, **{f"{layout}_t": None})
    x = np.ones((N, 4), np.float32)
    if layout != "bcsr":  # JAX's BCSR path has no guard of its own
        with pytest.raises(ValueError, match="transpose"):
            j_spmm(jbad, jnp.asarray(x), impl=layout)
    with pytest.raises(ValueError, match="transpose"):
        t_spmm(tbad, torch.from_numpy(x), impl=layout)
    with pytest.raises(ValueError, match="transpose"):
        t_spmm_t(tbad, torch.from_numpy(x), impl=layout)


def test_unported_impls_raise():
    _, tg = graphs()
    for impl in ("panel", "colpanel"):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            t_spmm(tg, torch.ones(N, 2), impl=impl)
    with pytest.raises(ValueError, match="unknown spmm impl"):
        t_spmm(tg, torch.ones(N, 2), impl="nope")


def test_sddmm_matches_jax():
    jg, tg = graphs()
    rng = np.random.default_rng(4)
    a = rng.standard_normal((N, 6)).astype(np.float32)
    b = rng.standard_normal((N, 6)).astype(np.float32)
    np.testing.assert_allclose(
        t_sddmm(tg, torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(j_sddmm(jg, jnp.asarray(a), jnp.asarray(b))), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("h", [1, 40, 130])
@pytest.mark.parametrize("tiles", ["f32", "bf16"])
def test_b1_plain_matches_dense_product(h, tiles):
    _, tg = graphs()
    a = dense_of(tg)
    x = np.random.default_rng(h).standard_normal((N, h)).astype(np.float32)
    bcsr = tg.bcsr
    ref = a @ x
    if tiles == "bf16":
        bcsr = dataclasses.replace(bcsr, data=bcsr.data.to(torch.bfloat16))
        # x and the tiles are rounded to bf16; the sum stays f32
        def bf16(v):
            return torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16).double().numpy()

        ref = bf16(a) @ bf16(x)
    out = b1.bcsr_spmm(bcsr, torch.from_numpy(x), n_rows=N)
    assert out.dtype == torch.float32 and out.shape == (N, h)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert not out[128:256].any()  # the empty block row


def test_b1_bf16_tiles_match_jax():
    """bf16 tiles in both packages: the JAX kernel casts x to bf16 and keeps an
    f32 accumulator (``bcsr_spmm.py:84-90``); the port's plain version does the
    same. Held at 2e-2 relative, as ``tests/test_spmm.py`` holds the JAX
    kernel's bf16 path."""
    from pygcn_tpu.ops.pallas.bcsr_spmm import bcsr_spmm as j_bcsr

    s, d, w = coo(seed=6)
    kw = dict(KW, hybrid_tile_dtype="bfloat16")
    jh = JGraph.from_coo(s, d, w, **kw).hybrid
    th = TGraph.from_coo(s, d, w, **kw).hybrid
    assert th.bcsr.data.dtype == torch.bfloat16
    x = np.random.default_rng(7).standard_normal((N, 40)).astype(np.float32)
    yj = np.asarray(j_bcsr(jh.bcsr, jnp.asarray(x), n_rows=N))
    yt = b1.bcsr_spmm(th.bcsr, torch.from_numpy(x), n_rows=N).numpy()
    np.testing.assert_allclose(yt, yj, rtol=2e-2, atol=2e-2 * np.abs(yj).max())


def test_b1_wrapper_rejects_bad_inputs():
    _, tg = graphs()
    with pytest.raises(TypeError, match="float32"):
        b1.bcsr_spmm(tg.bcsr, torch.ones(N, 4, dtype=torch.float64), n_rows=N)
    with pytest.raises(ValueError, match="rows"):
        b1.bcsr_spmm(tg.bcsr, torch.ones(N + 200, 4), n_rows=N)
    with pytest.raises(ValueError, match=r"\[n_cols, H\]"):
        b1.bcsr_spmm(tg.bcsr, torch.ones(N), n_rows=N)
