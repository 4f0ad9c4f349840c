"""The plain reference against a hand-computed step on a three-node path:
its adjacency, its GCN and GAT losses against dense NumPy in float64, its
first gradient against finite differences, and Adam's first update."""

import math

import numpy as np
import pytest
import torch

from benchmark.reference import adjacency, gat, gcn
from benchmark.reference.training import follow

# raw edges 0 -> 1, 1 -> 2 (and a duplicate 1 -> 2 of weight 2, merged by max)
ROWS, COLS, VALS = np.array([0, 1, 1]), np.array([1, 2, 2]), np.array([1.0, 1.0, 2.0])
LABELS = np.array([1, 0, 1])
MASK = np.array([1.0, 0.0, 1.0])
GCN = {"num_layers": 2, "lr": 0.01, "weight_decay": 0.0, "adam_betas": [0.9, 0.999],
       "adam_eps": 1e-8}
GAT = {"heads": 2, "out_heads": 1, "negative_slope": 0.2, **GCN}


def test_adjacency_by_hand():
    # the pair (1, 2) arrives twice, at 1 and 2: the symmetrisation takes
    # the largest value of (i, j) and (j, i) over all their entries
    adj = adjacency.normalized(ROWS, COLS, VALS, 3, "cpu")
    dense = np.zeros((3, 3))
    dense[adj.rows.numpy(), adj.cols.numpy()] = adj.weights.numpy()
    a = np.array([[1.0, 1.0, 0.0], [1.0, 1.0, 2.0], [0.0, 2.0, 1.0]])
    d = 1.0 / np.sqrt(a.sum(1))
    np.testing.assert_allclose(dense, d[:, None] * a * d[None, :], rtol=1e-6)


def _a_hat():
    a = np.array([[1.0, 1.0, 0.0], [1.0, 1.0, 2.0], [0.0, 2.0, 1.0]])
    d = 1.0 / np.sqrt(a.sum(1))
    return d[:, None] * a * d[None, :]


def _nll(logits):
    logp = logits - np.log(np.exp(logits).sum(1, keepdims=True))
    return -(logp[np.arange(3), LABELS] * MASK).sum() / MASK.sum()


def _gcn_loss(p):
    a = _a_hat()
    h = np.maximum(a @ (X @ p["layers.0.weight"]) + p["layers.0.bias"], 0.0)
    return _nll(a @ (h @ p["layers.1.weight"]) + p["layers.1.bias"])


def _gat_layer(p, name, h, heads, concat):
    nbrs = {0: [0, 1], 1: [0, 1, 2], 2: [1, 2]}
    s = (h @ p[f"{name}.w"]).reshape(3, heads, -1)
    out = np.zeros_like(s)
    for v, us in nbrs.items():
        for k in range(heads):
            e = np.array([s[u, k] @ p[f"{name}.a_src"][k] + s[v, k] @ p[f"{name}.a_dst"][k]
                          for u in us])
            e = np.where(e >= 0, e, 0.2 * e)
            alpha = np.exp(e - e.max())
            alpha /= alpha.sum()
            out[v, k] = sum(a * s[u, k] for a, u in zip(alpha, us))
    out = out.reshape(3, -1) if concat else out.mean(1)
    return out + p[f"{name}.b"]


def _gat_loss(p):
    h = _gat_layer(p, "gat1", X, 2, True)
    h = np.where(h > 0, h, np.expm1(h))
    return _nll(_gat_layer(p, "gat2", h, 1, False))


rng = np.random.default_rng(0)
X = rng.normal(size=(3, 4))
SHAPES = {"gcn": {"layers.0.weight": (4, 3), "layers.0.bias": (3,),
                  "layers.1.weight": (3, 2), "layers.1.bias": (2,)},
          "gat": {"gat1.w": (4, 6), "gat1.a_src": (2, 3), "gat1.a_dst": (2, 3), "gat1.b": (6,),
                  "gat2.w": (6, 2), "gat2.a_src": (1, 2), "gat2.a_dst": (1, 2), "gat2.b": (2,)}}
CASES = {"gcn": (gcn, GCN, _gcn_loss), "gat": (gat, GAT, _gat_loss)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(CASES))
def test_first_step_by_hand(name, dtype):
    """In float32 (the control's) and float64 (the check's)."""
    model, config, loss_fn = CASES[name]
    p0 = {k: 0.5 * rng.normal(size=s) for k, s in SHAPES[name].items()}
    adj = model.adjacency(ROWS, COLS, VALS, 3, "cpu", dtype)
    t = {k: torch.tensor(v, dtype=dtype) for k, v in p0.items()}
    got = follow(model, config, t, adj, torch.tensor(X, dtype=dtype),
                 torch.tensor(LABELS), torch.tensor(MASK, dtype=dtype), 1)
    assert got["losses"][0] == pytest.approx(loss_fn(p0), rel=1e-5, abs=1e-6)
    for k, v in p0.items():  # central differences in float64
        g = np.zeros_like(v)
        for i in np.ndindex(v.shape):
            hi, lo = dict(p0), dict(p0)
            hi[k], lo[k] = v.copy(), v.copy()
            hi[k][i] += 1e-6
            lo[k][i] -= 1e-6
            g[i] = (loss_fn(hi) - loss_fn(lo)) / 2e-6
        np.testing.assert_allclose(got["grad1"][k].numpy(), g, rtol=1e-3, atol=1e-5)
        # Adam's first update: lr * m_hat / (sqrt(v_hat) + eps) = lr * g / (|g| + eps)
        gk = got["grad1"][k].double().numpy()
        want = v - config["lr"] * gk / (np.abs(gk) + config["adam_eps"])
        np.testing.assert_allclose(got["params"][k].numpy(), want, rtol=1e-5, atol=1e-6)
    assert math.isfinite(got["losses"][0])
