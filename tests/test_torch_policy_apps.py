"""The policy CLIs and the server of the port, on the CPU.

``apps/train_generator`` (plain and ``--hierarchical``) reads an
``evaluator.pkl`` written by the JAX package's ``train_evaluator`` and one
written by the port's, and validates NN-node policies with the simulator;
``apps/train_rl --quicktest`` writes its checkpoint and cache shards, and a
rerun in the same directory simulates only what the cache lacks;
``apps/predict`` serves from the pickle (the predictions of JAX's evaluator
equal JAX's ``GCNOverMLP.apply``), from a ``torch.export`` artifact (within
1e-5, importing no model code) and from a ``gt_gen`` CSV, and padding a
batch changes no row. ``utils/visualize`` draws when matplotlib is there.
"""

import csv
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

from pygcn_tpu.apps import train_evaluator as j_train_evaluator
from pygcn_tpu.graph import Graph as JGraph
from pygcn_tpu.nn.models import GCNOverMLP as JGCNOverMLP
from pygcn_tpu.policy import SimCache as JSimCache
from pygcn_tpu_torch.apps import gt_gen, predict, train_generator, train_rl
from pygcn_tpu_torch.apps import train_evaluator as tev
from pygcn_tpu_torch.apps.common import build_synthetic_world
from pygcn_tpu_torch.nn.models import SoftGenerator, TopKGenerator
from pygcn_tpu_torch.train import checkpoint as tckpt
from pygcn_tpu_torch.train.export import save_artifact

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = ["--n_cbgs", "64", "--hours", "48"]
NN = 5


@pytest.fixture(scope="module")
def gt_csv(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("gt") / "vac.csv")
    gt_gen.main(["--device", "cpu", "--out", path, "--num_samples", "24", "--batch", "24",
                 "--num_seeds", "2", *WORLD, "--NN", str(NN)])
    return path


@pytest.fixture(scope="module")
def evaluators(gt_csv, tmp_path_factory):
    """``{"jax": path, "port": path}``: each package's ``train_evaluator``
    for two epochs on the same ground truth."""
    out = {}
    for name, app in (("jax", j_train_evaluator), ("port", tev)):
        d = str(tmp_path_factory.mktemp(f"ev_{name}"))
        argv = ["--vac_result_path", gt_csv, "--out_dir", d, "--epochs", "2", *WORLD,
                "--NN", str(NN), "--batch_size", "4"]
        app.main(argv + (["--device", "cpu"] if name == "port" else []))
        out[name] = os.path.join(d, "evaluator.pkl")
    return out


@pytest.mark.parametrize("source", ["jax", "port"])
@pytest.mark.parametrize("hierarchical", [False, True])
def test_train_generator_on_either_evaluator(evaluators, tmp_path, source, hierarchical):
    """Every validated policy has NN distinct nodes (none of the target
    group's when hierarchical), the losses are finite, the evaluator's base
    layout passes its width check, and ``policies.pkl`` reads back as plain
    types whose weights load into the generator."""
    out = str(tmp_path / "gen")
    argv = ["--device", "cpu", "--evaluator", evaluators[source], "--out_dir", out,
            "--epochs", "6", "--max_validate", "2", "--num_seeds", "2", *WORLD]
    results = train_generator.main(argv + (["--hierarchical"] if hierarchical else []))
    assert 1 <= len(results) <= 2
    world = build_synthetic_world(n_cbgs=64, hours=48, seed=42, device="cpu")
    gen_feats, dim, _ = train_generator.generator_inputs(world, hierarchical)
    for r in results:
        assert len(set(r["policy"])) == len(r["policy"]) == NN
        assert np.isfinite(r["total_cases"]) and r["total_cases"] > 0
        if hierarchical:
            assert (gen_feats[r["policy"], -1] != 0).all()  # --target_group 0
    with open(os.path.join(out, "metrics.jsonl")) as f:
        losses = [float(line.split('"train_loss": ')[1].split(",")[0]) for line in f]
    assert len(losses) == 6 and np.isfinite(losses).all()
    saved = tckpt.load_plain_pickle(os.path.join(out, "policies.pkl"))
    assert [r["policy"] for r in saved["results"]] == [r["policy"] for r in results]
    model = train_generator.make_generator(gen_feats.shape[1], dim, 32, NN, 0, hierarchical,
                                           device="cpu")
    tckpt.load_model_params(model, saved["gen_params"])


def test_train_generator_refuses_a_mismatched_evaluator(evaluators):
    """An evaluator whose input width fits neither the world's block nor
    its double is refused by width."""
    world = build_synthetic_world(n_cbgs=64, hours=48, seed=42, device="cpu")
    evaluator, _ = tckpt.load_evaluator(evaluators["port"], "cpu")
    evaluator.linear_nin += 3
    with pytest.raises(ValueError, match="base feature dims"):
        train_generator.evaluator_base(evaluator, train_generator.generator_inputs(world)[2])


def test_train_rl_quicktest_and_a_rerun_from_its_cache(tmp_path, monkeypatch):
    """``--quicktest``: distinct actions (the greedy policy NN nodes), a
    finite average reward, ``checkpoint_rl.pkl`` whose weights load into the
    SoftGenerator, and cache shards that JAX's ``SimCache`` merges; the
    random baseline simulates the policies JAX's CLI draws from the same
    seed. The shards hold every policy simulated before the last episode's
    dump (the greedy policy's run comes after it, as in JAX's CLI), as many
    as ``metrics.jsonl``'s misses of the baseline and the episodes. A rerun
    in the same directory finds them in the cache, simulates only what it
    lacks (at most the greedy policy), and ends on the same numbers."""
    batches = []
    real = train_rl.batch_policy_outcomes

    def counted(world, vectors, num_seeds, seeds, approx=False, mesh=None):
        batches.append([tuple(np.nonzero(v)[0].tolist()) for v in vectors])
        return real(world, vectors, num_seeds, seeds, approx, mesh=mesh)

    monkeypatch.setattr(train_rl, "batch_policy_outcomes", counted)
    out = str(tmp_path / "rl")
    argv = ["--device", "cpu", "--out_dir", out, "--quicktest", *WORLD]
    first = train_rl.main(argv)
    rng = np.random.default_rng(42)
    want = [tuple(sorted(rng.choice(64, NN, replace=False).tolist())) for _ in range(8)]
    assert batches[0] == list(dict.fromkeys(want))
    simulated = {p for b in batches for p in b}
    assert all(len(p) == NN for p in simulated)
    ckpt = tckpt.load_plain_pickle(os.path.join(out, "checkpoint_rl.pkl"))
    assert np.isfinite(ckpt["avg_rewards"]) and 0 <= ckpt["episode"] < 3
    model = SoftGenerator(gcn_nfeat=16, gcn_nhid=32, gcn_nclass=32, dim_touched=16, nn_select=NN,
                          linear_nhid1=64, linear_nhid2=8, generator=torch.Generator())
    tckpt.load_model_params(model, ckpt["params"])
    with open(os.path.join(out, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records] == [0, 1, 2, 3]
    assert all(0 <= r["sim_s"] <= r["episode_s"] for r in records[:3])
    greedy = tuple(records[-1]["greedy"])
    assert len(set(greedy)) == NN and records[-1]["final_cases"] == first[0]
    jcache = JSimCache(out)
    missing = simulated - set(jcache.cache)
    assert set(jcache.cache) <= simulated and missing <= {greedy}
    assert records[-1]["baseline_misses"] + sum(r["misses"] for r in records[:3]) \
        == len(jcache.cache)

    batches.clear()
    second = train_rl.main(argv)
    assert second == first
    assert batches == ([[greedy]] if missing else [])


def test_train_rl_shards_beyond_the_cards_is_refused(tmp_path):
    """``--shards 2`` on ``cuda`` beyond the visible cards is refused before
    anything starts (2 gloo ranks: ``tests/test_torch_data_parallel.py``)."""
    with pytest.raises(ValueError, match="mesh needs 2 devices, have"):
        train_rl.main(["--device", "cuda", "--out_dir", str(tmp_path), "--shards", "2"])
    assert not os.listdir(tmp_path)


def read_preds(path):
    with open(path) as f:
        rows = list(csv.DictReader(f))
    return [r["Vaccinated_Idxs"] for r in rows], np.array([float(r["Prediction"]) for r in rows])


def test_predict_from_pickle_export_and_padding(evaluators, tmp_path):
    """From JAX's ``evaluator.pkl`` the server's predictions equal JAX's
    ``GCNOverMLP.apply`` on the same features; the exported artifact gives
    the same within 1e-5; a batch padded from 1 row to 8 equals the
    unpadded row, and batches of 8 and 1 give the same predictions."""
    art = str(tmp_path / "art.pt2")
    common = ["--device", "cpu", "--random", "20", "--NN", str(NN), *WORLD]
    eager, timing = predict.main(common + ["--evaluator", evaluators["jax"], "--batch", "8",
                                           "--export", art, "--out", str(tmp_path / "a.csv")])
    one, _ = predict.main(common + ["--evaluator", evaluators["jax"], "--batch", "1",
                                    "--out", str(tmp_path / "b.csv")])
    served, _ = predict.main(common + ["--from_export", art, "--out", str(tmp_path / "c.csv")])
    assert eager.shape == (20,) and np.isfinite(eager).all()
    assert len(timing["batch_ms"]) == 3 and timing["export_s"] > 0
    np.testing.assert_allclose(one, eager, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(served, eager, rtol=1e-5, atol=1e-5)
    assert read_preds(tmp_path / "a.csv")[0] == read_preds(tmp_path / "c.csv")[0]

    world = build_synthetic_world(n_cbgs=64, hours=48, seed=42, device="cpu")
    rng = np.random.default_rng(42)
    policies = [tuple(sorted(rng.choice(64, NN, replace=False))) for _ in range(20)]
    ev = tckpt.load_plain_pickle(evaluators["jax"])
    feats = predict._policy_features(world, policies, ev["feature_mode"])
    jgraph = JGraph.from_scipy(sp.csr_matrix(world.graph.dense.numpy()), is_symmetric=True,
                               build_dense=True)
    want = JGCNOverMLP(**ev["model_config"]).apply(
        jax.tree.map(jnp.asarray, ev["params"]), jnp.asarray(feats), jgraph)[:, 0]
    np.testing.assert_allclose(eager, np.asarray(want), rtol=1e-5, atol=1e-5)

    server, _ = predict.load_server(evaluators["jax"], world, "cpu")
    with torch.no_grad():
        alone = server(torch.from_numpy(feats[:1]))
        padded = server(torch.from_numpy(np.concatenate([feats[:1], np.zeros_like(feats[:7])])))
    np.testing.assert_allclose(padded[:1].numpy(), alone.numpy(), rtol=1e-5, atol=1e-5)


def test_predict_from_export_imports_no_model_code(evaluators, tmp_path):
    """Serving from the artifact, in a fresh process, leaves every
    ``pygcn_tpu_torch.nn`` module unimported."""
    art = str(tmp_path / "art.pt2")
    predict.main(["--device", "cpu", "--evaluator", evaluators["port"], "--random", "4",
                  "--batch", "4", *WORLD, "--export", art, "--out", str(tmp_path / "a.csv")])
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from pygcn_tpu_torch.apps import predict\n"
        f"predict.main(['--device', 'cpu', '--from_export', {art!r}, '--random', '4',\n"
        f"              '--n_cbgs', '64', '--hours', '48', '--out', {str(tmp_path / 'b.csv')!r}])\n"
        "bad = sorted(m for m in sys.modules if m.startswith('pygcn_tpu_torch.nn')\n"
        "             or m.split('.')[0] in ('jax', 'pygcn_tpu'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    np.testing.assert_allclose(read_preds(tmp_path / "b.csv")[1], read_preds(tmp_path / "a.csv")[1],
                               rtol=1e-5, atol=1e-5)


def test_export_refuses_the_bcsr_route_and_foreign_files(evaluators, tmp_path):
    """A graph convolution on ``impl="bcsr"`` (kernel B1 through ctypes)
    cannot be traced: the export says so and writes nothing; a pickle
    without the port's magic is not an artifact."""
    world = build_synthetic_world(n_cbgs=64, hours=48, seed=42, device="cpu")
    model, _ = tckpt.load_evaluator(evaluators["port"], "cpu", impl="bcsr")
    path = str(tmp_path / "art.pt2")
    with pytest.raises(ValueError, match="cannot export a forward on impl=\\['bcsr'\\]"):
        save_artifact(path, predict.ServingForward(model, world.graph),
                      (torch.zeros(2, 64, 17),))
    assert not os.path.exists(path)
    with open(path, "wb") as f:
        pickle.dump({"magic": "pygcn_tpu-export-v1", "stablehlo": b"", "meta": {}}, f)
    from pygcn_tpu_torch.train.export import load_artifact

    with pytest.raises(ValueError, match="not a pygcn_tpu_torch export artifact"):
        load_artifact(path)


def test_predict_reads_a_gt_gen_csv(gt_csv, evaluators, tmp_path):
    """``--policies_csv`` predicts one row for each row of the CSV (the
    no-vaccination baseline first), in its order."""
    preds, _ = predict.main(["--device", "cpu", "--evaluator", evaluators["port"],
                             "--policies_csv", gt_csv, *WORLD, "--out", str(tmp_path / "p.csv")])
    with open(gt_csv) as f:
        want = [r["Vaccinated_Idxs"] for r in csv.DictReader(f)]
    got, values = read_preds(tmp_path / "p.csv")
    assert got[0] == want[0] == "[]"
    assert [g.replace(" ", "") for g in got] == [w.replace(" ", "") for w in want]
    np.testing.assert_array_equal(values, preds.astype(np.float64))
    assert np.isfinite(preds).all()


def test_cli_generator_flags_nn_nodes():
    """The generator the CLI builds is a TopKGenerator whose flag holds NN
    ones on the CLI's features."""
    world = build_synthetic_world(n_cbgs=64, hours=48, seed=42, device="cpu")
    gen_feats, dim, _ = train_generator.generator_inputs(world)
    model = train_generator.make_generator(gen_feats.shape[1], dim, 32, NN, 42, device="cpu")
    assert isinstance(model, TopKGenerator)
    with torch.no_grad():
        flag = model(torch.from_numpy(gen_feats), world.graph)
    assert int((flag > 0).sum()) == NN
    np.testing.assert_allclose(flag[flag > 0].numpy(), 1.0, rtol=1e-6)


def test_visualize_draws_pngs(tmp_path):
    pytest.importorskip("matplotlib")
    from pygcn_tpu_torch.utils.visualize import plot_curves, visualize

    visualize(np.random.default_rng(0).normal(size=100), 10, str(tmp_path / "h.png"))
    plot_curves({"train": [3, 2, 1], "val": [3, 2.5, 2]}, str(tmp_path / "c.png"))
    assert (tmp_path / "h.png").stat().st_size > 0 and (tmp_path / "c.png").stat().st_size > 0
