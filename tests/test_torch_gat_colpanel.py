"""The port's column-panel GAT and GATv2 against the JAX package.

Outputs and the gradients of the features and attention vectors (through
the port's hand-written backward) are held against JAX's COO attention path
(``gat_attention``/``gatv2_attention`` + ``attention_aggregate``, which JAX's
own ``tests/test_gat_colpanel.py`` holds equal to its column-panel path),
values to 1e-5 and gradients to 1e-4, on an asymmetric 300-node graph in 3
panels. The port runs there on the graph's column panels and on a layout of
the same matrix on a (1, 2, 4) bucket ladder, whose widest bucket repeats
rows. One case per version compares with JAX's ``gat_conv_colpanel`` /
``gatv2_conv_colpanel`` directly, forward and gradients in one compiled
function, on a 40-node graph in 2 panels; a 2-layer GAT built with JAX's
parameters through ``convert`` agrees with JAX's ``GAT.apply(colpanel=True)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pygcn_tpu.graph.graph import Graph as JGraph
from pygcn_tpu.nn.gat import GAT as JGAT
from pygcn_tpu.ops.gat import attention_aggregate as j_aggregate
from pygcn_tpu.ops.gat import gat_attention as j_gat_attention
from pygcn_tpu.ops.gat import gatv2_attention as j_gatv2_attention
from pygcn_tpu.ops.gat_colpanel import gat_conv_colpanel as j_gat_cp
from pygcn_tpu.ops.gat_colpanel import gatv2_conv_colpanel as j_gatv2_cp

import pygcn_tpu_torch.ops.gat_colpanel as tgcp
from pygcn_tpu_torch import convert
from pygcn_tpu_torch.apps import train_fullgraph as tapp
from pygcn_tpu_torch.graph.graph import Graph as TGraph
from pygcn_tpu_torch.nn.gat import GAT as TGAT
from pygcn_tpu_torch.nn.layers import dropout
from pygcn_tpu_torch.ops.colpanel import build_col_panel_ell

torch.set_num_threads(1)

SLOPE = 0.2
H, F = 3, 4
V2 = pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
LAYOUT = dict(build_dense=False, build_bcsr=False, build_ell=False, build_hybrid=False,
              build_colpanel=True)


def matrix(n, e, pw, seed=0):
    """Distinct random edges with positive weights; rows 0 and 1 receive
    from every sender of panel 0 (more than a bucket of width 4 holds); the
    last node has no edge in or out."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n - 1, e), rng.integers(2, n - 1, e)
    hub = np.arange(min(pw, n - 1))
    src = np.concatenate([src, hub, hub])
    dst = np.concatenate([dst, np.zeros_like(hub), np.ones_like(hub)])
    src, dst = np.unique(np.stack([src, dst]), axis=1)
    w = rng.uniform(0.5, 1.5, src.size).astype(np.float32)
    return sp.coo_matrix((w, (dst, src)), shape=(n, n))


_GRAPHS = {}


def graphs(small=False):
    if small not in _GRAPHS:
        n, e, pw, panels = (40, 160, 20, 2) if small else (300, 2400, 128, 3)
        m = matrix(n, e, pw)
        jg = JGraph.from_scipy(m, panel_width=pw, **LAYOUT)
        tg = TGraph.from_scipy(m, panel_width=pw, **LAYOUT)
        assert len(tg.colpanel.panels) == panels == len(jg.colpanel.panels)
        _GRAPHS[small] = (jg, tg, build_col_panel_ell(m, pw, (1, 2, 4)))
    return _GRAPHS[small]


def inputs(n, v2, seed=1):
    rng = np.random.default_rng(seed)
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    args = (f32(n, H, F), f32(n, H, F), f32(H, F)) if v2 else (f32(n, H, F), f32(H, F),
                                                                f32(H, F))
    return args, f32(n, H, F)


def jax_coo(jg, v2):
    if v2:
        return lambda sl, sr, a: j_aggregate(jg, sl, j_gatv2_attention(jg, sl, sr, a, SLOPE))
    return lambda s, a_src, a_dst: j_aggregate(jg, s, j_gat_attention(jg, s, a_src, a_dst, SLOPE))


def jax_fwd_grads(fn, args, cot):
    """Output and input gradients of ``fn`` in one compiled function."""
    @jax.jit
    def f(*a):
        y, vjp = jax.vjp(fn, *a)
        return (y,) + vjp(jnp.asarray(cot))
    return [np.asarray(v) for v in f(*map(jnp.asarray, args))]


def port_fwd_grads(layout, args, cot, v2, **kw):
    t = [torch.from_numpy(a).requires_grad_(True) for a in args]
    conv = tgcp.gatv2_conv_colpanel if v2 else tgcp.gat_conv_colpanel
    y = conv(layout, *t, SLOPE, **kw)
    return [y.detach().numpy()] + [g.numpy() for g in
                                   torch.autograd.grad(y, t, torch.from_numpy(cot))]


def assert_agree(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5, err_msg="output")
    for i, (a, b) in enumerate(zip(got[1:], want[1:])):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4, err_msg=f"gradient {i}")


@V2
def test_colpanel_attention_matches_jax_coo_path(v2):
    jg, tg, fine = graphs()
    args, cot = inputs(tg.n_nodes, v2)
    want = jax_fwd_grads(jax_coo(jg, v2), args, cot)
    assert not np.any(want[0][-1])  # the isolated node aggregates nothing
    assert any(m is not None for p in fine.panels for m in p.merge)
    for layout in (tg, fine):
        assert_agree(port_fwd_grads(layout, args, cot, v2), want)


@V2
def test_colpanel_attention_matches_jax_colpanel_directly(v2):
    jg, tg, _ = graphs(small=True)
    args, cot = inputs(tg.n_nodes, v2, seed=2)
    conv = j_gatv2_cp if v2 else j_gat_cp
    want = jax_fwd_grads(lambda *a: conv(jg, *a, SLOPE), args, cot)
    assert_agree(port_fwd_grads(tg, args, cot, v2), want)


@V2
def test_the_backward_is_hand_written_and_chunks_change_no_value(monkeypatch, v2):
    _, tg, fine = graphs()
    args, cot = inputs(tg.n_nodes, v2, seed=3)
    t = [torch.from_numpy(a).requires_grad_(True) for a in args]
    conv = tgcp.gatv2_conv_colpanel if v2 else tgcp.gat_conv_colpanel
    y = conv(tg, *t, SLOPE)
    assert type(y.grad_fn).__name__ == ("_GATv2ColPanelBackward" if v2 else
                                        "_GATColPanelBackward")
    whole = port_fwd_grads(fine, args, cot, v2)
    # one row per chunk: the forward's bits stay, the gradients' sums of
    # chunk partials (the attention vectors') move by rounding only
    monkeypatch.setattr(tgcp, "ATTN_CHUNK_BUDGET_ELEMS", 1)
    rows = port_fwd_grads(fine, args, cot, v2)
    np.testing.assert_array_equal(rows[0], whole[0])
    for a, b in zip(rows[1:], whole[1:]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_check_rejects_zero_weights_and_duplicate_edges():
    m = matrix(40, 160, 16).tocoo()
    src, dst, w = m.col, m.row, m.data.copy()
    g = TGraph.from_coo(src, dst, w, n_nodes=40, panel_width=16, **LAYOUT)
    tgcp.check_gat_colpanel(g)
    w[3] = 0.0
    zero = TGraph.from_coo(src, dst, w, n_nodes=40, panel_width=16, **LAYOUT)
    with pytest.raises(ValueError, match="zero-weight"):
        tgcp.check_gat_colpanel(zero)
    dup = TGraph.from_coo(np.r_[src, src[:2]], np.r_[dst, dst[:2]], np.r_[m.data, m.data[:2]],
                          n_nodes=40, panel_width=16, **LAYOUT)
    with pytest.raises(ValueError, match="duplicate-free"):
        tgcp.check_gat_colpanel(dup)
    # the host arrays may be passed in place of the graph's
    with pytest.raises(ValueError, match="zero-weight"):
        tgcp.check_gat_colpanel(g, senders=src, receivers=dst, weights=w)
    with pytest.raises(ValueError, match="no colpanel"):
        tgcp.check_gat_colpanel(TGraph.from_coo(src, dst, m.data, n_nodes=40))


@V2
def test_attention_dropout_scales_the_numerator_only(v2):
    _, tg, _ = graphs()
    args, _ = inputs(tg.n_nodes, v2, seed=4)
    t = [torch.from_numpy(a) for a in args]
    conv = tgcp.gatv2_conv_colpanel if v2 else tgcp.gat_conv_colpanel
    base = conv(tg, *t, SLOPE)
    # a "dropout" that keeps every term at twice its weight doubles the output:
    # the denominator keeps the undropped weights
    torch.testing.assert_close(conv(tg, *t, SLOPE, attn_dropout=lambda a: 2 * a), 2 * base,
                               rtol=1e-6, atol=1e-6)
    # the real dropout keeps each slot and head with probability 1 - p, at 1 / (1 - p),
    # JAX's law (bernoulli(keep) per slot and head, scaled by 1 / keep)
    p, seen = 0.3, []
    gen = torch.Generator().manual_seed(0)

    def drop(a):
        out = dropout(a, p, gen)
        seen.append(out)
        return out
    x = [v.clone().requires_grad_(True) for v in t]
    y = conv(tg, *x, SLOPE, attn_dropout=drop)
    y.sum().backward()  # autograd differentiates the sweeps here
    assert all(v.grad is not None and torch.isfinite(v.grad).all() for v in x)
    kept = torch.cat([s.reshape(-1) for s in seen])
    assert torch.all((kept == 0) | torch.isclose(kept, torch.tensor(1 / (1 - p))))
    share, n = float((kept != 0).float().mean()), kept.numel()
    assert abs(share - (1 - p)) < 4 * np.sqrt(p * (1 - p) / n), (share, n)


def test_gat_model_with_jax_params_matches_jax_colpanel():
    jg, tg, _ = graphs(small=True)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((tg.n_nodes, 6)).astype(np.float32)
    jgat = JGAT(nfeat=6, nhid=4, nclass=3, heads=2)
    params = jgat.init(jax.random.key(0))
    want = np.asarray(jax.jit(lambda p, v: jgat.apply(p, v, jg, colpanel=True))(
        params, jnp.asarray(x)))
    tgat = TGAT(6, 4, 3, heads=2, generator=torch.Generator().manual_seed(0))
    tgat.load_state_dict(convert.gat_params_to_state_dict(params))
    got = tgat(torch.from_numpy(x), tg, colpanel=True).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_cli_clustered_runs_on_column_panels_above_the_threshold(monkeypatch, capsys, model):
    """``train_fullgraph --clustered`` with the threshold lowered below the
    graph: the column panels alone, GAT on the column-panel attention path."""
    monkeypatch.setattr(tapp, "COLPANEL_MIN_NODES", 1000)
    r = tapp.main(["--clustered", "--model", model, "--device", "cpu", "--n_nodes", "3000",
                   "--avg_degree", "8", "--feat_dim", "16", "--hidden", "8", "--gat_heads", "2",
                   "--n_classes", "4", "--max_epochs", "3", "--seed", "3"])
    g = r["graph"]
    assert g.colpanel is not None and g.ell is None and g.hybrid is None
    assert r["tile_frac"] is None and np.isfinite(r["loss"]) and r["steps"] == 4
    out = capsys.readouterr().out
    if model == "gat":
        assert r["colpanel"] and not r["hybrid_tiles"] and r["edge_map"] is None
        assert f"gat: colpanel attention path ({len(g.colpanel.panels)} panels, " in out
