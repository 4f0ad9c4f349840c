"""The evaluator's CLIs in the port, on the CPU, against the JAX package.

``apps/train_evaluator`` trains on a ground-truth CSV of the port's
``gt_gen`` and hands over an ``evaluator.pkl`` whose parameters, put through
the JAX package's ``GCNOverMLP.apply``, give the port's forward values; its
checkpoints and ``evaluator.pkl`` unpickle in a process where ``jax`` and
``torch`` cannot be imported; a run preempted after three epochs and resumed
for a fourth ends with the weights of four uninterrupted epochs. The
baselines' OLS and summary features, the legacy trainer's picks, the
logger's records and the sweep's records equal the JAX package's.
"""

import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pygcn_tpu.apps import baselines as jbase
from pygcn_tpu.graph import Graph as JGraph
from pygcn_tpu.nn.models import GCNOverMLP as JGCNOverMLP
from pygcn_tpu.train import adam_l2 as j_adam_l2
from pygcn_tpu.train import save_checkpoint_state as j_save_checkpoint
from pygcn_tpu.train.sweep import expand_grid as j_expand_grid
from pygcn_tpu.train.sweep import run_sweep as j_run_sweep
from pygcn_tpu.utils.config import Config as JConfig
from pygcn_tpu.utils.logging import MetricsLogger as JMetricsLogger
from pygcn_tpu_torch.apps import baselines as tbase
from pygcn_tpu_torch.apps import gt_gen, sweep
from pygcn_tpu_torch.apps import train_evaluator as tev
from pygcn_tpu_torch.apps import train_legacy as tlegacy
from pygcn_tpu_torch.apps.common import build_synthetic_world
from pygcn_tpu_torch.data.features import assemble_evaluator_features, centrality_features
from pygcn_tpu_torch.data.vac_results import load_vac_results
from pygcn_tpu_torch.train import checkpoint as tckpt
from pygcn_tpu_torch.train.sweep import expand_grid, run_sweep
from pygcn_tpu_torch.utils.config import Config
from pygcn_tpu_torch.utils.logging import MetricsLogger

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = ["--n_cbgs", "32", "--hours", "48"]
EVAL = ["--device", "cpu", *WORLD, "--NN", "4", "--batch_size", "4"]


@pytest.fixture(scope="module")
def gt_csv(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("gt") / "vac.csv")
    gt_gen.main(["--device", "cpu", "--out", path, "--num_samples", "24", "--batch", "24",
                 "--num_seeds", "2", *WORLD, "--NN", "4"])
    return path


@pytest.fixture(scope="module")
def trained(gt_csv, tmp_path_factory):
    """An uninterrupted 4-epoch run's directory."""
    out = str(tmp_path_factory.mktemp("eval4"))
    tev.main(["--vac_result_path", gt_csv, "--out_dir", out, "--epochs", "4", *EVAL])
    return out


def port_features(gt_csv):
    world = build_synthetic_world(n_cbgs=32, hours=48, seed=42, device="cpu")
    res = load_vac_results(gt_csv)
    feats, dim = assemble_evaluator_features(tev.build_predictor_features(world, res),
                                             centrality_features(world.adj), True, False)
    return world, feats, dim


def test_evaluator_pkl_runs_in_jax_as_in_the_port(gt_csv, trained):
    """``evaluator.pkl`` keeps the JAX CLI's keys with ``params`` as the
    JAX-shaped NumPy tree: JAX's ``GCNOverMLP.apply`` on it gives the port's
    forward values (and the recorded test loss is the port's)."""
    with open(os.path.join(trained, "evaluator.pkl"), "rb") as f:
        handoff = pickle.load(f)
    assert set(handoff) == {"model_config", "params", "dim_touched", "feature_mode",
                            "test_loss", "test_spearman"}
    cfg = handoff["model_config"]
    assert cfg == {"gcn_nfeat": 16, "gcn_nhid": 32, "gcn_nclass": 32, "dim_touched": 16,
                   "linear_nin": 32, "linear_nhid1": 64, "linear_nhid2": 8, "linear_nout": 1}
    world, feats, dim = port_features(gt_csv)
    assert dim == handoff["dim_touched"]
    model = tev.make_model(dim, feats.shape[2], 32, 0, device="cpu")
    tckpt.load_model_params(model, handoff["params"])
    with torch.no_grad():
        got = model(torch.from_numpy(feats), world.graph).numpy()
    jgraph = JGraph.from_scipy(sp.csr_matrix(world.graph.dense.numpy()), is_symmetric=True,
                               build_dense=True)
    want = JGCNOverMLP(**cfg).apply(jax.tree.map(jnp.asarray, handoff["params"]),
                                    jnp.asarray(feats), jgraph)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    assert np.isfinite(handoff["test_loss"]) and -1 <= handoff["test_spearman"] <= 1


def test_checkpoints_unpickle_without_torch_or_jax(trained, tmp_path):
    """The port's checkpoints and ``evaluator.pkl`` hold only plain types
    and NumPy arrays: a process in which ``jax`` and ``torch`` cannot be
    imported reads them."""
    paths = [os.path.join(trained, f) for f in ("checkpoint_maxcorr.pkl",
                                                "checkpoint_minloss.pkl", "evaluator.pkl")]
    code = (
        "import pickle, sys\n"
        "sys.modules['jax'] = sys.modules['torch'] = None\n"
        f"for p in {paths!r}:\n"
        "    d = pickle.load(open(p, 'rb'))\n"
        "    print(sorted(d))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == str(sorted(["format", "epoch", "params", "opt_state",
                                   "scheduler_state"]))
    payload = tckpt.load_checkpoint(paths[0])
    assert payload["format"] == tckpt.FORMAT
    assert set(payload["opt_state"]) == {"step", "exp_avg", "exp_avg_sq", "lr"}
    assert payload["opt_state"]["exp_avg"]["gcn"]["gc1"]["w"].shape == (16, 32)
    assert payload["params"]["mlp"]["linear3"]["b"].shape == (1,)


def test_jax_checkpoint_is_refused_unread(tmp_path):
    """A JAX checkpoint pickles optax's classes: the port refuses it while
    reading instead of importing them."""
    params = {"w": jnp.ones((2, 2))}
    path = str(tmp_path / "jax.pkl")
    j_save_checkpoint(params, 1, j_adam_l2(0.01).init(params), {}, path)
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        tckpt.load_checkpoint(path)


class PreemptAfter:
    """A guard whose flag rises at its ``polls``-th reading (the loop reads
    it once an epoch)."""

    def __init__(self, polls):
        self.polls = polls

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    @property
    def requested(self):
        self.polls -= 1
        return self.polls == 0


def test_resumed_run_equals_an_uninterrupted_one(gt_csv, trained, tmp_path, monkeypatch):
    """Preempted after three epochs (the preemption checkpoint holds epoch
    3, the Adam state, the scheduler, the watermarks and the early-stop
    counter) and resumed for one more, the run ends with the weights, test
    metrics and epoch log of four uninterrupted epochs."""
    out = str(tmp_path / "pre")
    common = ["--vac_result_path", gt_csv, "--out_dir", out, *EVAL]
    monkeypatch.setattr(tev, "PreemptionGuard", lambda: PreemptAfter(3))
    assert tev.main(common + ["--epochs", "4"]) is None
    last = tckpt.load_checkpoint(os.path.join(out, "checkpoint_last.pkl"))
    assert last["epoch"] == 3 and last["opt_state"]["step"] == 3 * 4
    assert {"min_val_loss", "max_val_corr", "stopper"} <= set(last["extra"])
    monkeypatch.undo()
    resumed = tev.main(common + ["--epochs", "1", "--resume"])
    assert not os.path.exists(os.path.join(out, "checkpoint_last.pkl"))
    with open(os.path.join(trained, "evaluator.pkl"), "rb") as f:
        want = pickle.load(f)
    with open(os.path.join(out, "evaluator.pkl"), "rb") as f:
        got = pickle.load(f)
    flat = {k: v for k, v in jax.tree_util.tree_leaves_with_path(want["params"])}
    for k, v in jax.tree_util.tree_leaves_with_path(got["params"]):
        np.testing.assert_allclose(v, flat[k], rtol=0, atol=1e-6, err_msg=str(k))
    assert resumed == pytest.approx((want["test_loss"], want["test_spearman"]), abs=1e-6)
    logs = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    ref = [json.loads(line) for line in open(os.path.join(trained, "metrics.jsonl"))]
    assert [r["step"] for r in logs] == [0, 1, 2, 3]
    for a, b in zip(logs, ref):
        assert a["train_loss"] == pytest.approx(b["train_loss"], abs=1e-6)


def test_cli_modes_run(gt_csv, tmp_path):
    """``--quicktest``, ``--kfold 2``, ``--bf16``, a best-metric ``--resume``
    and a missing CSV (generated by the port's ``gt_gen``) run to finite
    metrics, and so does ``--data_parallel`` as one rank."""
    for extra in (["--quicktest"], ["--kfold", "2"], ["--bf16", "--with_original_feat"]):
        loss, corr = tev.main(["--vac_result_path", gt_csv, "--out_dir",
                               str(tmp_path / extra[0][2:]), "--epochs", "2", *EVAL, *extra])
        assert np.isfinite(loss) and -1 <= corr <= 1
    out = str(tmp_path / "quicktest")
    tev.main(["--vac_result_path", gt_csv, "--out_dir", out, "--epochs", "1", "--resume",
              *EVAL, "--quicktest"])
    missing = str(tmp_path / "new.csv")
    loss, _ = tev.main(["--vac_result_path", missing, "--out_dir", str(tmp_path / "gen"),
                        "--epochs", "1", *EVAL])
    assert os.path.exists(missing) and np.isfinite(loss)
    assert len(load_vac_results(missing).vac_tags) == 48
    # --data_parallel without a process group on the CPU: one rank
    loss, corr = tev.main(["--vac_result_path", gt_csv, "--out_dir", str(tmp_path / "dp"),
                           "--epochs", "1", "--data_parallel", *EVAL])
    assert np.isfinite(loss) and -1 <= corr <= 1


def test_numpy_ols_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(40, 5))
    y = x @ rng.normal(size=5) + rng.normal(size=40)
    got, want = tbase.numpy_ols(x, y), jbase.numpy_ols(x, y)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_baselines_match_jax(gt_csv, capsys):
    """The summary baselines on one world: the same node features and
    summary statistics as JAX's, so the same OLS fit and the same
    scikit-learn MLP score; ``mlp`` trains to a finite loss."""
    argv = ["--vac_result_path", gt_csv, *WORLD]

    class Args:
        vac_result_path, n_cbgs, n_pois, hours, msa_name = gt_csv, 32, 20, 48, "SanFrancisco"
        seed, world_seed, device = 42, None, "cpu"

    _, res, got = tbase.build_world_and_features(Args)
    _, _, want = jbase.build_world_and_features(Args)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tbase.summary_stats(got, res.vac_tags),
                                  jbase.summary_stats(want, res.vac_tags))
    fit, ref = (m.main(["summary-ols", *argv] + (["--device", "cpu"] if m is tbase else []))
                for m in (tbase, jbase))
    for k in ref:
        np.testing.assert_allclose(fit[k], ref[k], rtol=1e-9, err_msg=k)
    score = tbase.main(["summary-mlp", "--device", "cpu", "--epochs", "2", *argv])
    assert score == jbase.main(["summary-mlp", "--epochs", "2", *argv])
    mse, corr = tbase.main(["mlp", "--device", "cpu", "--epochs", "2", "--batch_size", "4",
                            *argv])
    assert np.isfinite(mse) and -1 <= corr <= 1


def test_summary_mlp_reports_a_missing_scikit_learn(gt_csv, monkeypatch):
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.neural_network", None)
    with pytest.raises(RuntimeError, match="needs scikit-learn"):
        tbase.main(["summary-mlp", "--device", "cpu", "--vac_result_path", gt_csv, *WORLD])


def test_legacy_picks_match_jax_and_train(gt_csv):
    """The legacy trainer's per-epoch samples are the JAX CLI's draws
    (``rng.choice(idx_train, accumulation_step, replace=True)`` on the
    generator of ``--seed``); the CLI trains to a finite test loss."""
    idx_train = load_vac_results(gt_csv).idx_train[:16]
    ref_rng, rng = np.random.default_rng(42), np.random.default_rng(42)
    for _ in range(6):
        np.testing.assert_array_equal(tlegacy.epoch_picks(rng, idx_train, 20),
                                      ref_rng.choice(idx_train, 20, replace=True))
    loss = tlegacy.main(["--device", "cpu", "--vac_result_path", gt_csv, "--epochs", "11",
                         *WORLD])
    assert np.isfinite(loss)


def test_metrics_logger_writes_jax_records(tmp_path, capsys):
    for cls, name in ((JMetricsLogger, "jax"), (MetricsLogger, "port")):
        log = cls(str(tmp_path / f"{name}.jsonl"))
        log.log(3, train_loss=np.float32(0.5), val_loss=torch.tensor(0.25), note="x")
        log.close()
    jax_out, port_out = capsys.readouterr().out.splitlines()
    assert jax_out == port_out == "step=3 train_loss=0.5 val_loss=0.25 note=x"
    recs = [json.loads(open(tmp_path / f"{n}.jsonl").read()) for n in ("jax", "port")]
    for r in recs:
        r.pop("time")
    assert recs[0] == recs[1]


def toy_trial(cfg):
    if cfg["lr"] == 0.3:
        raise ValueError("diverged")
    return {"score": cfg["lr"] * 10 - cfg["hidden"] / 100}


def test_sweep_over_a_toy_trial_matches_jax():
    cfgs = [(Config(lr=[0.1, 0.2, 0.3], hidden=[8, 16]), JConfig(lr=[0.1, 0.2, 0.3],
                                                                    hidden=[8, 16]))]
    for cfg, jcfg in cfgs:
        assert [c.state_dict for c in expand_grid(cfg)] == [
            c.state_dict for c in j_expand_grid(jcfg)]
        for mode in ("max", "min"):
            got = run_sweep(toy_trial, cfg, metric="score", mode=mode)
            want = j_run_sweep(toy_trial, jcfg, metric="score", mode=mode)
            assert got.records == want.records and got.best == want.best
            assert got.table() == want.table()
    with pytest.raises(RuntimeError, match="every sweep trial failed"):
        run_sweep(toy_trial, Config(lr=[0.3]), metric="score")


def test_sweep_cli_over_train_evaluator(gt_csv, tmp_path):
    """Two trials of the port's evaluator, ranked; ``--app train_cora`` ends
    in argparse's exit on the ``--out_dir`` each trial is handed, as the JAX
    CLI does (``train_cora`` takes none)."""
    out = str(tmp_path / "sweep")
    result = sweep.main(["--app", "train_evaluator", "--set", "lr=0.01,0.02",
                         "--out_dir", out, "--", "--vac_result_path", gt_csv,
                         "--epochs", "1", *EVAL])
    assert len(result.records) == 2 and all("error" not in r for r in result.records)
    best = json.load(open(os.path.join(out, "best.json")))
    assert best["params"]["lr"] in (0.01, 0.02)
    assert len(open(os.path.join(out, "sweep_results.jsonl")).read().splitlines()) == 2
    with pytest.raises(SystemExit):
        sweep.main(["--app", "train_cora", "--set", "lr=0.01,0.02", "--out_dir",
                    str(tmp_path / "cora"), "--", "--device", "cpu", "--epochs", "1"])
