"""Full-graph GCN training: the port against the JAX package, and the port's CLI.

Parity: one small clustered dataset, built by both packages from one seed
with the hybrid layout and a low tile threshold so that tiles exist (JAX's
tile half runs B1's Pallas body in interpret mode, the port's its plain
version). JAX-initialised weights go through ``pygcn_tpu_torch.convert`` and
both packages take 3 Adam steps; the per-step losses and the final weights
agree to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pygcn_tpu.graph.datasets as jds
from pygcn_tpu.nn import init as jinit
from pygcn_tpu.ops.spmm import spmm as j_spmm
from pygcn_tpu.train import adam_l2 as j_adam_l2

import pygcn_tpu_torch.graph.datasets as tds
from pygcn_tpu_torch import convert
from pygcn_tpu_torch.apps import train_fullgraph as tapp
from pygcn_tpu_torch.train.optim import adam_l2 as t_adam_l2
from pygcn_tpu_torch.train.optim import get_learning_rate, set_learning_rate

torch.set_num_threads(1)

DATA_KW = dict(n=512, avg_degree=8.0, n_classes=4, feat_dim=16, seed=3,
               build_dense=False, build_hybrid=True, hybrid_min_edges_per_tile=6)
DIMS = [16, 16, 16, 4]
LR, WD, STEPS = 0.01, 5e-4, 3


def jax_params(seed=0):
    """Weights as ``pygcn_tpu/apps/train_fullgraph.py`` initialises them."""
    key = jax.random.key(seed)
    params = []
    for fi, fo in zip(DIMS[:-1], DIMS[1:]):
        key, kw, kb = jax.random.split(key, 3)
        params.append({"w": jinit.graphconv_weight(kw, fi, fo),
                       "b": jinit.graphconv_bias(kb, fo)})
    return params


def jax_train(data, params, steps):
    """The JAX trainer's step (``pygcn_tpu/apps/train_fullgraph.py:281-312``)."""
    graph = data.graph
    x = jnp.asarray(data.features)
    labels = jnp.asarray(data.labels)
    mask = jnp.zeros(graph.n_nodes, jnp.float32).at[jnp.asarray(data.idx_train)].set(1.0)

    def forward(params, x, graph):
        h = x
        for i, p in enumerate(params):
            h = j_spmm(graph, jnp.dot(h, p["w"])) + p["b"]
            h = h if i == len(params) - 1 else jax.nn.relu(h)
        return jax.nn.log_softmax(h, axis=1)

    def loss_fn(params, graph):
        logp = forward(params, x, graph)
        per_node = -jnp.take_along_axis(logp, labels[:, None], axis=1)[:, 0]
        return (per_node * mask).sum() / mask.sum()

    tx = j_adam_l2(LR, WD)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, graph):
        loss, grads = jax.value_and_grad(loss_fn)(params, graph)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    losses = []
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state, graph)
        losses.append(float(loss))
    return losses, params


def torch_train(data, state, steps):
    graph = data.graph
    x = torch.from_numpy(data.features)
    labels = torch.from_numpy(data.labels.astype(np.int64))
    mask = torch.zeros(graph.n_nodes)
    mask[torch.from_numpy(data.idx_train.astype(np.int64))] = 1.0
    model = tapp.GCN(DIMS, generator=torch.Generator().manual_seed(0))
    model.load_state_dict(state)
    opt = t_adam_l2(model.parameters(), LR, WD)
    losses = [float(tapp.train_step(model, opt, x, labels, mask, graph)) for _ in range(steps)]
    return losses, model


def test_three_adam_steps_match_jax():
    jd = jds.community_classification(**DATA_KW)
    td = tds.community_classification(**DATA_KW)
    assert td.graph.hybrid.bcsr is not None and td.graph.hybrid.bcsr.data.shape[0] <= 16
    assert td.graph.hybrid.tile_edges == jd.graph.hybrid.tile_edges > 0
    params = jax_params()
    j_losses, j_final = jax_train(jd, params, STEPS)
    t_losses, model = torch_train(td, convert.params_to_state_dict(params), STEPS)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4, atol=1e-4)
    assert j_losses[-1] < j_losses[0]
    t_final = convert.state_dict_to_params(model.state_dict())
    for tp, jp in zip(t_final, j_final):
        for k in ("w", "b"):
            np.testing.assert_allclose(tp[k], np.asarray(jp[k]), rtol=1e-4, atol=1e-4)


def test_convert_round_trip():
    params = jax_params(seed=5)
    state = convert.params_to_state_dict(params)
    model = tapp.GCN(DIMS, generator=torch.Generator().manual_seed(0))
    model.load_state_dict(state)  # the names and shapes the model expects
    back = convert.state_dict_to_params(model.state_dict())
    assert len(back) == len(params)
    for b, p in zip(back, params):
        for k in ("w", "b"):
            np.testing.assert_array_equal(b[k], np.asarray(p[k]))


def test_init_bounds():
    model = tapp.GCN([64, 32, 10], generator=torch.Generator().manual_seed(1))
    for layer, fo in zip(model.layers, (32, 10)):
        assert layer.weight.abs().max() <= np.sqrt(6.0 / fo)
        assert layer.bias.abs().max() <= 1.0 / np.sqrt(fo)
        assert layer.weight.std() > 0.3 * np.sqrt(6.0 / fo) / np.sqrt(3)


def test_adam_clip_then_decay_matches_jax():
    """Clip the global norm, then add L2, then Adam: the optax chain of
    ``pygcn_tpu/train/optim.py:adam_l2`` and the port's torch Adam agree."""
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((5, 3)).astype(np.float32)
    grads = [rng.standard_normal((5, 3)).astype(np.float32) * 10 for _ in range(3)]
    tx = j_adam_l2(0.05, 0.01, grad_clip_norm=1.0)
    pj = jnp.asarray(w0)
    state = tx.init(pj)
    pt = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = t_adam_l2([pt], 0.05, 0.01, grad_clip_norm=1.0)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, pj)
        pj = optax.apply_updates(pj, upd)
        pt.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj), rtol=1e-5, atol=1e-6)
    set_learning_rate(opt, 0.002)
    assert get_learning_rate(opt) == pytest.approx(0.002)


CLI_SMALL = ["--device", "cpu", "--n_nodes", "800", "--avg_degree", "8", "--feat_dim", "16",
             "--hidden", "16", "--n_classes", "4", "--layers", "2"]


def test_cli_clustered_learns():
    """The sizes of ``tests/test_apps.py``'s clustered convergence run."""
    r = tapp.main(["--clustered", *CLI_SMALL, "--max_epochs", "40", "--patience", "6"])
    assert r["val"] > 0.5 and np.isfinite(r["test"]), r
    assert r["tile_frac"] > 0 and r["steps"] == r["epochs"] + 1


def test_cli_remat_gives_the_same_run():
    args = ["--clustered", *CLI_SMALL, "--max_epochs", "4", "--patience", "10"]
    plain = tapp.main(args)
    remat = tapp.main(args + ["--remat"])
    assert remat["loss"] == pytest.approx(plain["loss"], rel=1e-6)
    assert remat["val"] == plain["val"]


def test_cli_synthetic_timing():
    dt = tapp.main(["--device", "cpu", "--n_nodes", "400", "--avg_degree", "5",
                    "--feat_dim", "8", "--hidden", "4", "--n_classes", "3", "--epochs", "2",
                    "--memstats"])
    assert dt > 0


@pytest.fixture(scope="module")
def ranks4():
    from pygcn_tpu_torch.parallel.launcher import LocalRanks

    with LocalRanks(4, timeout_s=180) as ranks:
        yield ranks


@pytest.mark.parametrize("flags", [["--model", "sage", "--shards", "2"], ["--shards", "2"],
                                   ["--model", "gat", "--shards", "4"],
                                   ["--model", "appnp", "--shards", "2"]])
def test_cli_unported_options_exit(ranks4, flags):
    """The ``--shards`` flag sets the port once refused as "not ported yet"
    now train: each runs as ranks of a gloo group of 4 (as under
    ``torchrun``; ``tests/test_torch_dist_models.py`` holds the models
    against JAX's), rank 0 returning its seconds per epoch and the ranks
    outside the mesh nothing."""
    import torch_dist_ranks

    shards = int(flags[flags.index("--shards") + 1])
    out = ranks4.run(torch_dist_ranks.cli_job,
                     [*CLI_SMALL, "--epochs", "1", "--gat_heads", "2", *flags])
    assert out[0] > 0 and all(r is None for r in out[shards:])
    assert all(r > 0 for r in out[:shards])


def test_unknown_model_exits_2_as_in_jax(capsys):
    """``--model`` takes JAX's choices: an unknown name is argparse's
    "invalid choice" with exit code 2 in both packages (fault C7: the port
    said "not ported yet" and exited 1)."""
    from pygcn_tpu.apps import train_fullgraph as japp

    for run in (lambda: tapp.parse_args(["--model", "foo"]),
                lambda: tapp.main(["--device", "cpu", "--model", "foo"]),
                lambda: japp.main(["--model", "foo"])):
        with pytest.raises(SystemExit) as e:
            run()
        assert e.value.code == 2
        err = capsys.readouterr().err
        assert "invalid choice: 'foo'" in err and "not ported" not in err
    for model in ("gcn", "gat", "gatv2", "sage", "gin", "appnp"):
        assert tapp.parse_args(["--model", model]).model == model


def test_throughput_line_matches_jax(monkeypatch, capsys):
    """The same epoch time prints the same Medge-traversals/s as the JAX CLI:
    3 SpMM-equivalents per layer (the forward, and two in the backward)."""
    import time
    import types

    from pygcn_tpu.apps import train_fullgraph as japp

    args = types.SimpleNamespace(epochs=4, layers=3, clustered=False)
    graph = types.SimpleNamespace(n_edges=4_451_813)
    lines = []
    for run in (lambda: tapp._time_epochs(args, graph, lambda: 0.5),
                lambda: japp._time_and_report(args, graph, None, lambda s: (*s, 0.5), (0,),
                                              None)):
        clock = iter([10.0, 10.1])  # 4 epochs in 0.1 s: 25 ms each
        monkeypatch.setattr(time, "time", lambda: next(clock))
        run()
        monkeypatch.undo()
        (line,) = [ln for ln in capsys.readouterr().out.splitlines() if "Medge" in ln]
        lines.append(line)
    assert lines[0] == lines[1]
    assert f"~{4_451_813 * 9 / 0.025 / 1e6:.0f} Medge-traversals/s" in lines[0]
