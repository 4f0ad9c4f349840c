"""``pygcn_tpu_torch.apps.train_sampled`` on the CPU: the CLI at the JAX
package's test shapes, its step against JAX's over three steps (1e-5 on the
loss, 1e-4 on the parameters, from JAX's parameters carried over by
``convert``), a preempted and resumed run against an uninterrupted one
(1e-6), and the data-parallel flags' refusals (their runs:
``tests/test_torch_dp_sampled.py``)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pygcn_tpu.nn import init as jinit
from pygcn_tpu.ops import sampling as js
from pygcn_tpu.train import adam_l2 as j_adam_l2

from pygcn_tpu_torch import convert
from pygcn_tpu_torch.apps import train_sampled as tapp
from pygcn_tpu_torch.graph.datasets import save_npz_dataset, sbm_classification
from pygcn_tpu_torch.ops import sampling as ts
from pygcn_tpu_torch.train.checkpoint import load_checkpoint
from pygcn_tpu_torch.train.preempt import PreemptionGuard

torch.set_num_threads(1)

CPU = ["--device", "cpu"]
SMALL = [*CPU, "--n_nodes", "1500", "--fanouts", "4", "4", "--batch_size", "128"]


@pytest.mark.parametrize("argv", [
    # tests/test_apps.py::test_train_sampled
    ["--n_nodes", "2000", "--fanouts", "5", "5", "--batch_size", "128", "--epochs", "1"],
    # tests/test_apps.py::test_train_sampled_gat, and GATv2 at its shape
    ["--n_nodes", "1500", "--fanouts", "4", "4", "--batch_size", "128", "--epochs", "1",
     "--model", "gat", "--gat_heads", "2", "--hidden", "8"],
    ["--n_nodes", "1500", "--fanouts", "4", "4", "--batch_size", "128", "--epochs", "1",
     "--model", "gatv2", "--gat_heads", "2", "--hidden", "8"],
    # tests/test_scale_configs.py::test_reddit_config_tiny
    ["--n_nodes", "1500", "--avg_degree", "60.0", "--feat_dim", "32", "--n_classes", "8",
     "--fanouts", "25", "10", "--batch_size", "128", "--epochs", "1", "--prefetch", "0"],
    [*SMALL[2:], "--epochs", "1", "--locality"],
    [*SMALL[2:], "--epochs", "2", "--eval_every", "1", "--model", "gat", "--gat_heads", "2",
     "--hidden", "8"],
], ids=["gcn", "gat", "gatv2", "reddit_tiny", "locality", "eval_every"])
def test_cli_runs(argv, capsys):
    import threading

    threads = threading.active_count()
    r = tapp.main([*CPU, *argv])
    assert 0.0 <= r["acc"] <= 1.0
    assert r["n_batches"] >= 1 and np.isfinite(r["losses"]).all()
    out = capsys.readouterr().out
    assert "ms/batch incl. host sampling" in out and "utilization split" in out
    if "--eval_every" in argv:
        assert out.count("val_acc=") == 2
    assert threading.active_count() == threads  # the prefetch thread is gone


def test_cli_on_an_npz_dataset(tmp_path):
    """``tests/test_graph.py::test_npz_dataset_roundtrip``'s file, then the CLI on it."""
    data = sbm_classification(n=200, n_classes=3, feat_dim=8, seed=5, n_val=40, n_test=60,
                              build_dense=False, build_bcsr=False)
    path = str(tmp_path / "ds.npz")
    save_npz_dataset(path, data)
    r = tapp.main([*CPU, "--npz", path, "--epochs", "2", "--batch_size", "16", "--fanouts", "4",
                   "4", "--hidden", "8"])
    assert 0.0 <= r["acc"] <= 1.0
    assert r["prepared"].x_full.shape == (200, 8) and r["n_batches"] == 2 * (60 // 16)


def test_prepared_data_is_reused_only_for_the_same_flags():
    r = tapp.main([*SMALL, "--epochs", "1"])
    again = tapp.main([*SMALL, "--epochs", "1"], prepared=r["prepared"])
    assert again["losses"] == r["losses"] and again["acc"] == r["acc"]
    gat = tapp.main([*SMALL, "--epochs", "1", "--model", "gat", "--gat_heads", "2", "--hidden",
                     "8", "--prefetch", "0"], prepared=r["prepared"])
    assert np.isfinite(gat["losses"]).all()
    with pytest.raises(ValueError, match="other data flags"):
        tapp.main([*SMALL, "--epochs", "1", "--seed", "1"], prepared=r["prepared"])


def jax_cli_params(model, feat_dim, hidden, heads, n_classes, seed=0):
    """Parameters as ``pygcn_tpu/apps/train_sampled.py:131-174`` initialises
    them for two fanouts."""
    key = jax.random.key(seed)
    params = []
    if model == "gcn":
        for fi, fo in ((feat_dim, hidden), (hidden, n_classes)):
            key, kw, kb = jax.random.split(key, 3)
            params.append({"w": jinit.graphconv_weight(kw, fi, fo),
                           "b": jinit.graphconv_bias(kb, fo)})
    else:
        for fi, h, fo in tapp.gat_layer_dims(2, feat_dim, heads, hidden, n_classes):
            key, kw, ks_, kd, kb = jax.random.split(key, 5)
            if model == "gatv2":
                p = {"w_l": jinit.graphconv_weight(kw, fi, h * fo),
                     "w_r": jinit.graphconv_weight(ks_, fi, h * fo),
                     "a": jinit.graphconv_weight(kd, h, fo)}
            else:
                p = {"w": jinit.graphconv_weight(kw, fi, h * fo),
                     "a_src": jinit.graphconv_weight(ks_, h, fo),
                     "a_dst": jinit.graphconv_weight(kd, h, fo)}
            p["b"] = jinit.graphconv_bias(kb, h * fo if h > 1 else fo)
            params.append(p)
    return params


JAX_FWD = {"gcn": js.sampled_gcn_forward, "gat": js.sampled_gat_forward,
           "gatv2": js.sampled_gatv2_forward}


# Adam divides each gradient entry by its own magnitude plus eps = 1e-8, so
# an entry whose gradient is near eps moves by up to lr on its rounding alone:
# GATv2's last-layer w_r has gradient entries down to 3e-13 (where the
# receiver's term cancels in the softmax), up to 5e-10 apart between the
# packages. Every gradient entry is held to the reference before Adam; the
# updated parameters only where the reference gradient stayed at or above
# GRAD_FLOOR in every step, where Adam's first step scales a gradient's
# error by at most lr * eps / GRAD_FLOOR**2 = 100.
GRAD_FLOOR = 1e-6


@pytest.mark.parametrize("model", ["gcn", "gat", "gatv2"])
def test_three_steps_match_jax(model):
    """The port's step (``train_sampled.train_step``) against JAX's step
    written from its public functions as ``pygcn_tpu/apps/train_sampled.py:
    255-265`` defines it, from equal parameters and equal batches, with the
    CLI's optimizer (``adam_l2(lr)``): the loss (1e-5) and the gradients
    (1e-4) of each step, then the parameters after three steps (1e-4) where
    every step's reference gradient is at least ``GRAD_FLOOR``."""
    args = tapp.parse_args([*SMALL, "--model", model, "--gat_heads", "2", "--hidden", "8"])
    prep = tapp.prepare(args, torch.device("cpu"))
    sampler = ts.NeighborSampler(prep.adj, args.fanouts, seed=0)
    x_np = prep.data.features
    params = jax_cli_params(model, x_np.shape[1], 8, 2, prep.data.n_classes)

    tx = j_adam_l2(args.lr)
    fwd = JAX_FWD[model]

    @jax.jit
    def j_step(params, opt_state, blocks, input_nodes, x_full, y):
        def loss_fn(p):
            batch = js.SampledBatch(blocks=blocks, input_nodes=None, output_nodes=None)
            logits = fwd(p, batch, x_full[input_nodes])
            logp = jax.nn.log_softmax(logits, axis=1)
            return -jnp.take_along_axis(logp, y[:, None], axis=1).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    net = tapp.MODELS[model].init(
        [x_np.shape[1], 8, prep.data.n_classes] if model == "gcn"
        else tapp.gat_layer_dims(2, x_np.shape[1], 2, 8, prep.data.n_classes),
        generator=torch.Generator().manual_seed(0))
    net.load_state_dict(convert.sampled_params_to_state_dict(params))
    opt = tapp.adam_l2(net.parameters(), args.lr)
    j_params, opt_state = params, tx.init(params)
    held = [{k: np.ones(v.shape, bool) for k, v in p.items()} for p in params]
    x_full = jnp.asarray(x_np)
    rng = np.random.default_rng(3)
    for _ in range(3):
        seeds = rng.choice(prep.data.idx_train, args.batch_size, replace=False)
        batch = sampler.sample(seeds)
        y = prep.labels[seeds]
        jblocks = [js.SampledBlock(*(jnp.asarray(t.numpy()) for t in
                                     (b.cols, b.weights, b.self_idx))) for b in batch.blocks]
        j_params, opt_state, j_loss, j_grads = j_step(j_params, opt_state, jblocks,
                                                      jnp.asarray(batch.input_nodes), x_full,
                                                      jnp.asarray(y))
        x_in = prep.x_full.index_select(0, torch.from_numpy(batch.input_nodes))
        t_loss = tapp.train_step(net, opt, batch.blocks, x_in, torch.from_numpy(y))
        np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5, atol=1e-5)
        grads = convert.state_dict_to_sampled_params(
            {k: p.grad for k, p in net.named_parameters()})
        for g, w, h in zip(grads, j_grads, held):
            for k in g:
                w_k = np.asarray(w[k])
                np.testing.assert_allclose(g[k], w_k, rtol=1e-4, atol=1e-4, err_msg=k)
                h[k] &= np.abs(w_k) >= GRAD_FLOOR
    got = convert.state_dict_to_sampled_params(net.state_dict())
    n_held = n_all = 0
    for g, w, h in zip(got, j_params, held):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_allclose(g[k][h[k]], np.asarray(w[k])[h[k]], rtol=1e-4, atol=1e-4,
                                       err_msg=k)
            n_held, n_all = n_held + h[k].sum(), n_all + h[k].size
    assert n_held > 0.95 * n_all, (n_held, n_all)


class PreemptAt:
    """A guard whose flag rises at the ``n``-th poll (one poll a batch)."""

    def __init__(self, n):
        self.polls = n

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    @property
    def requested(self):
        self.polls -= 1
        return self.polls <= 0


def test_preempted_and_resumed_run_equals_an_uninterrupted_one(tmp_path, monkeypatch):
    """``tests/test_preempt.py::test_sampled_trainer_checkpoint_and_resume``,
    with the prefetch thread on. Preempted at the first batch of epoch 1, the
    checkpoint holds epoch 1 and the draw counter of epoch 1's start; the
    resumed run ends at the parameters of two uninterrupted epochs."""
    common = [*SMALL, "--model", "gat", "--gat_heads", "2", "--hidden", "8"]
    whole = tapp.main([*common, "--epochs", "2"])
    steps = whole["n_batches"] // 2
    assert steps >= 2

    out_dir = str(tmp_path / "pre")
    monkeypatch.setattr(tapp, "PreemptionGuard", lambda: PreemptAt(steps + 1))
    assert tapp.main([*common, "--epochs", "2", "--out_dir", out_dir]) is None
    ckpt = load_checkpoint(os.path.join(out_dir, "checkpoint_last.pkl"))
    assert ckpt["epoch"] == 1 and ckpt["extra"] == {"n_draws": 2 * steps}
    monkeypatch.undo()
    resumed = tapp.main([*common, "--epochs", "1", "--out_dir", out_dir, "--resume"])
    for a, b in zip(convert.state_dict_to_sampled_params(resumed["model"].state_dict()),
                    convert.state_dict_to_sampled_params(whole["model"].state_dict())):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-6, err_msg=k)
    assert resumed["losses"] == whole["losses"][steps:]
    assert load_checkpoint(os.path.join(out_dir, "checkpoint_last.pkl"))["epoch"] == 2


def recording_batches(monkeypatch, record):
    """Make ``train_sampled`` append each batch it draws to ``record``."""
    real = tapp.iter_sampled_batches

    def recording(*a, **kw):
        for seeds, batch in real(*a, **kw):
            record.append(batch)
            yield seeds, batch

    monkeypatch.setattr(tapp, "iter_sampled_batches", recording)


def test_preempted_mid_epoch_replays_the_epoch_from_its_start(tmp_path, monkeypatch):
    """Preempted after one step of epoch 1, the checkpoint holds epoch 1, the
    draw counter of epoch 1's start, and the parameters after that step.
    The resumed run replays epoch 1 whole, drawing the blocks of the
    uninterrupted run's epoch 1, from parameters one step further on: it
    ends at other parameters. ``--resume`` equals an uninterrupted run only
    when the save falls on an epoch boundary (as JAX's restart of the epoch
    does)."""
    common = [*SMALL, "--model", "gat", "--gat_heads", "2", "--hidden", "8"]
    drawn = []
    recording_batches(monkeypatch, drawn)
    whole = tapp.main([*common, "--epochs", "2"])
    steps = whole["n_batches"] // 2
    out_dir = str(tmp_path / "pre")
    monkeypatch.setattr(tapp, "PreemptionGuard", lambda: PreemptAt(steps + 2))
    assert tapp.main([*common, "--epochs", "2", "--out_dir", out_dir]) is None
    ckpt = load_checkpoint(os.path.join(out_dir, "checkpoint_last.pkl"))
    assert ckpt["epoch"] == 1 and ckpt["extra"] == {"n_draws": 2 * steps}
    assert ckpt["opt_state"]["step"] == steps + 1
    monkeypatch.setattr(tapp, "PreemptionGuard", PreemptionGuard)
    replayed = []
    recording_batches(monkeypatch, replayed)
    resumed = tapp.main([*common, "--epochs", "1", "--out_dir", out_dir, "--resume"])
    assert len(replayed) == steps
    for a, b in zip(replayed, drawn[steps:2 * steps]):
        np.testing.assert_array_equal(a.input_nodes, b.input_nodes)
        for x, y in zip(a.blocks, b.blocks):
            for t, u in zip((x.cols, x.weights, x.self_idx), (y.cols, y.weights, y.self_idx)):
                assert torch.equal(t, u)
    assert resumed["losses"][0] != whole["losses"][steps]
    gap = max(float(np.abs(a[k] - b[k]).max())
              for a, b in zip(convert.state_dict_to_sampled_params(resumed["model"].state_dict()),
                              convert.state_dict_to_sampled_params(whole["model"].state_dict()))
              for k in a)
    assert gap > 1e-6


def test_instant_preemption_restarts_the_first_epoch(tmp_path, monkeypatch):
    out_dir = str(tmp_path / "sampled_pre")
    monkeypatch.setattr(tapp, "PreemptionGuard", lambda: PreemptAt(1))
    assert tapp.main([*SMALL, "--epochs", "3", "--prefetch", "0", "--out_dir", out_dir]) is None
    ckpt = load_checkpoint(os.path.join(out_dir, "checkpoint_last.pkl"))
    assert ckpt["epoch"] == 0 and ckpt["extra"]["n_draws"] == 0
    monkeypatch.undo()
    r = tapp.main([*SMALL, "--epochs", "2", "--prefetch", "0", "--out_dir", out_dir,
                   "--resume"])
    assert 0.0 <= r["acc"] <= 1.0
    assert load_checkpoint(os.path.join(out_dir, "checkpoint_last.pkl"))["epoch"] == 2
    with pytest.raises(SystemExit, match="--resume needs"):
        tapp.main([*SMALL, "--resume"])


@pytest.mark.parametrize("flags, error, message", [
    (["--shards", "2", "--device", "cuda"], ValueError, "mesh needs 2 devices, have"),
    (["--shards", "2", "--feature_sharded", "--device", "cuda"], ValueError,
     "mesh needs 2 devices, have"),
    (["--shards", "2", "--feature_sharded", "--align_seeds", "--device", "cuda"], ValueError,
     "mesh needs 2 devices, have"),
    (["--feature_sharded"], SystemExit, "--feature_sharded needs --shards > 1"),
    (["--shards", "2", "--align_seeds"], SystemExit, "--align_seeds needs --feature_sharded"),
])
def test_data_parallel_flags_are_refused(flags, error, message, monkeypatch):
    """JAX's two refusals, in its order; ``--shards`` beyond the visible
    cards (none here, one on the card's machine) before anything starts."""
    started = []
    monkeypatch.setattr("pygcn_tpu_torch.parallel.launcher.LocalRanks",
                        lambda *a, **kw: started.append(a))
    with pytest.raises(error, match=message):
        tapp.main([*CPU, *flags])
    assert not started


def test_sample_workers_with_one_shard_trains():
    """``--sample_workers`` with ``--shards 1`` is ignored, as in JAX: the
    run equals one without it."""
    argv = [*SMALL, "--epochs", "1", "--prefetch", "0"]
    r = tapp.main([*argv, "--sample_workers", "2"])
    assert r["losses"] == tapp.main(argv, prepared=r["prepared"])["losses"]


def test_unknown_model_exits_2(capsys):
    with pytest.raises(SystemExit) as e:
        tapp.main([*CPU, "--model", "foo"])
    assert e.value.code == 2 and "invalid choice" in capsys.readouterr().err


def test_default_device_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapp.main(["--n_nodes", "200", "--out_dir", str(tmp_path / "out")])
    assert not os.listdir(tmp_path)
