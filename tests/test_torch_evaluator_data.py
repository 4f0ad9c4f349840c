"""The evaluator's data in the port against the JAX package.

Ground-truth CSVs written by the port's ``gt_gen`` are parsed by both
packages (the port on the ``csv`` module, JAX through pandas) and compared
field by field, as is their combination; the loaders, k-fold splits and the
trainer's per-epoch order give the same batches; the centralities equal
JAX's networkx version (exactly at n = 40, within 1e-9 on the 150-node
sparsified graph with sampled betweenness pivots, raw and standardised);
the four feature-assembly modes and the generator features match; the
census loaders match JAX's on the fixture of ``tests/test_data.py``, with a
CBG id written with a leading zero in one table.
"""

import os

import networkx as nx
import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

from pygcn_tpu.data import demographics as jdemo
from pygcn_tpu.data import features as jfeat
from pygcn_tpu.data import loader as jloader
from pygcn_tpu.data import vac_results as jvac
from pygcn_tpu.sim import calibration
from pygcn_tpu.utils.config import Config as JConfig
from pygcn_tpu_torch.apps import gt_gen
from pygcn_tpu_torch.apps import train_evaluator as tev
from pygcn_tpu_torch.data import demographics as tdemo
from pygcn_tpu_torch.data import features as tfeat
from pygcn_tpu_torch.data import loader as tloader
from pygcn_tpu_torch.data import vac_results as tvac
from pygcn_tpu_torch.utils.config import Config as TConfig

torch.set_num_threads(1)

# pandas' default float parser is not correctly rounded: on the 20-digit
# decimals ``gt_gen`` writes it lands up to about 1e-13 (relative) away from
# the value written, which Python's ``float`` reads back exactly; the float32
# labels are equal
F64_PARSE = 1e-12


@pytest.fixture(scope="module")
def gt_csvs(tmp_path_factory):
    """Two ground-truth CSVs of the port's ``gt_gen`` (seeds 42 and 43), and
    one whose first three policy rows repeat the first file's."""
    d = tmp_path_factory.mktemp("gt")
    paths = []
    for seed in (42, 43):
        path = str(d / f"vac_{seed}.csv")
        gt_gen.main(["--device", "cpu", "--out", path, "--num_samples", "11", "--batch", "11",
                     "--num_seeds", "2", "--hours", "24", "--n_cbgs", "24", "--NN", "3",
                     "--random_seed", str(seed)])
        paths.append(path)
    lines = open(paths[0]).read().splitlines()
    repeat = str(d / "repeat.csv")
    with open(repeat, "w") as fh:
        fh.write("\n".join(lines[:1] + lines[2:5]) + "\n")
    return paths + [repeat]


@pytest.mark.parametrize("rel_result", [True, False])
def test_load_vac_results_matches_jax(gt_csvs, rel_result):
    for path in gt_csvs[:2]:
        ref = jvac.load_vac_results(path, rel_result=rel_result)
        got = tvac.load_vac_results(path, rel_result=rel_result)
        for f in ("graph_labels", "idx_train", "idx_val", "idx_test"):
            a, b = getattr(got, f), getattr(ref, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        assert got.num_samples == ref.num_samples == 11
        assert got.baseline.keys() == ref.baseline.keys()
        for k in ref.baseline:
            assert got.baseline[k] == pytest.approx(ref.baseline[k], rel=F64_PARSE, abs=0)
        assert len(got.vac_tags) == len(ref.vac_tags)
        for a, b in zip(got.vac_tags, ref.vac_tags):
            np.testing.assert_array_equal(a, b)


def test_load_vac_results_two_label_columns(tmp_path):
    """A CSV without the death columns gives two labels, offset by the baseline."""
    path = tmp_path / "two.csv"
    path.write_text("Vaccinated_Idxs,Total_Cases,Case_Rates_STD\n[],100.5,0.25\n"
                    "\"[1, 4]\",90.0,0.2\n\"[2, 3]\",95.25,0.125\n")
    ref, got = jvac.load_vac_results(str(path)), tvac.load_vac_results(str(path))
    assert got.graph_labels.shape == (2, 2)
    np.testing.assert_array_equal(got.graph_labels, ref.graph_labels)
    assert got.baseline == ref.baseline  # short decimals: both parsers exact


def test_combine_vac_results_matches_jax(gt_csvs, tmp_path):
    ref = jvac.combine_vac_results(gt_csvs, tmp_path / "jax.csv")
    columns, rows = tvac.combine_vac_results(gt_csvs, tmp_path / "port.csv")
    assert columns == list(ref.columns)
    assert len(rows) == len(ref) == 24  # the repeated rows are dropped
    for got, want in zip(rows, ref.itertuples(index=False)):
        assert got[0] == want[0]
        assert got[1:] == pytest.approx(tuple(want)[1:], rel=F64_PARSE, abs=0)
    pd.testing.assert_frame_equal(pd.read_csv(tmp_path / "port.csv"),
                                  pd.read_csv(tmp_path / "jax.csv"), rtol=F64_PARSE, atol=0)


def loader_arrays():
    rng = np.random.default_rng(0)
    return rng.normal(size=(37, 5, 3)).astype(np.float32), rng.normal(size=37).astype(np.float32)


@pytest.mark.parametrize("quicktest", [False, True])
def test_split_loaders_give_jax_batches(quicktest):
    x, y = loader_arrays()
    idx = np.random.default_rng(1).permutation(37)
    splits = (idx[:29], idx[29:33], idx[33:])
    ref = jloader.make_split_loaders(x, y, *splits, 4, quicktest=quicktest, seed=3)
    got = tloader.make_split_loaders(x, y, *splits, 4, quicktest=quicktest, seed=3)
    for jl, tl in zip(ref, got):
        assert len(jl) == len(tl)
        for _ in range(2):  # the train loader reshuffles each pass
            for (jx, jy), (tx, ty) in zip(jl, tl, strict=True):
                np.testing.assert_array_equal(tx, jx)
                np.testing.assert_array_equal(ty, jy)


def test_kfold_loaders_and_splits_give_jax_batches():
    x, y = loader_arrays()
    splits = (np.arange(25), np.arange(25, 31), np.arange(31, 37))
    (jtv, jtest) = jloader.make_split_loaders(x, y, *splits, 5, kfold=True)
    (ttv, ttest) = tloader.make_split_loaders(x, y, *splits, 5, kfold=True)
    for a, b in zip(ttv, jtv):
        np.testing.assert_array_equal(a, b)
    for (jx, _), (tx, _) in zip(jtest, ttest, strict=True):
        np.testing.assert_array_equal(tx, jx)
    for (jtr, jva), (ttr, tva) in zip(jloader.kfold_splits(31, 3, 7),
                                      tloader.kfold_splits(31, 3, 7), strict=True):
        np.testing.assert_array_equal(ttr, jtr)
        np.testing.assert_array_equal(tva, jva)
    drop = tloader.ArrayLoader([x, y], 10, drop_last=True)
    assert len(drop) == 3 and all(b[0].shape[0] == 10 for b in drop)
    with pytest.raises(ValueError, match="differ in length"):
        tloader.ArrayLoader([x, y[:-1]], 4)


def test_epoch_order_matches_jax_and_resume_replays_it():
    """The JAX trainer shuffles its order in place each epoch with the
    generator of ``(seed, epoch)`` (``apps/train_evaluator.py:304``); the
    port's epochs give the same batches, and replaying the shuffles of the
    epochs before a resumed one reaches the order an uninterrupted run has."""
    idx_train = np.random.default_rng(2).permutation(50)[:40]
    ref_order = np.asarray(idx_train.copy())
    order = np.array(idx_train)
    for epoch in range(4):
        np.random.default_rng([42, epoch]).shuffle(ref_order)  # the JAX loop's line
        tev.shuffle_epoch(order, 42, epoch)
        ref_batches = [ref_order[b * 8:(b + 1) * 8] for b in range(max(1, 40 // 8))]
        got_batches = tev.epoch_batches(order, 8)
        assert len(got_batches) == len(ref_batches) == 5
        for a, b in zip(got_batches, ref_batches):
            np.testing.assert_array_equal(a, b)
    resumed = np.array(idx_train)
    for epoch in range(4):
        tev.shuffle_epoch(resumed, 42, epoch)
    np.testing.assert_array_equal(resumed, order)
    assert [len(b) for b in tev.epoch_batches(order[:19], 8)] == [8, 8]


def covisit_like(n, seed):
    """A symmetric co-visitation-like matrix ``V Vᵀ`` with a diagonal."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(size=(n, 30)) * (rng.uniform(size=(n, 30)) < 0.15)
    return v @ v.T


@pytest.mark.parametrize("normalize", [False, True])
def test_centralities_exact_at_40_nodes(normalize):
    a = covisit_like(40, 1)
    np.testing.assert_array_equal(tfeat.centrality_features(a, normalize=normalize),
                                  jfeat.centrality_features(a, normalize=normalize))


@pytest.mark.parametrize("normalize", [False, True])
def test_centralities_sparsified_and_sampled_at_150_nodes(normalize):
    """Top-5 sparsification (JAX's ``np.argpartition``) and 16 betweenness
    pivots (networkx's ``random.Random(seed).sample`` and rescaling)."""
    a = covisit_like(150, 2)
    kw = dict(normalize=normalize, max_neighbors=5, betweenness_samples=16, seed=3)
    np.testing.assert_allclose(tfeat.centrality_features(a, **kw),
                               jfeat.centrality_features(a, **kw), rtol=1e-9, atol=1e-9)


def test_path_centralities_match_networkx_in_float64():
    """The float64 closeness and betweenness against networkx itself, all
    sources and 16 pivots (with a node that no path reaches)."""
    a = covisit_like(150, 4)
    a[7, :] = a[:, 7] = 0.0
    g = nx.from_numpy_array(a)
    graph = sp.csr_matrix(a != 0, dtype=np.float64)
    clo = nx.closeness_centrality(g)
    np.testing.assert_array_equal(tfeat.closeness(graph), [clo[i] for i in range(150)])
    for k, seed in ((None, 0), (16, 5)):
        bet = nx.betweenness_centrality(g, k=k, normalized=False, seed=seed)
        np.testing.assert_allclose(tfeat.betweenness(graph, k, seed),
                                   [bet[i] for i in range(150)], rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("embed", [True, False])
@pytest.mark.parametrize("original", [True, False])
def test_assembly_modes_match_jax(embed, original):
    rng = np.random.default_rng(5)
    node_feats = rng.normal(size=(3, 20, 4 + 8 + 1)).astype(np.float32)
    cent = rng.normal(size=(20, 4)).astype(np.float32)
    ref, ref_dim = jfeat.assemble_evaluator_features(node_feats, cent, embed, original)
    got, dim = tfeat.assemble_evaluator_features(node_feats, cent, embed, original)
    assert dim == ref_dim
    np.testing.assert_array_equal(got, ref)
    gen_ref, gen_dim = jfeat.generator_features(node_feats[0, :, :-1], cent)
    gen_got, dim = tfeat.generator_features(node_feats[0, :, :-1], cent)
    assert dim == gen_dim
    np.testing.assert_array_equal(gen_got, gen_ref)


def test_config_matches_jax():
    kw = dict(lr=[0.01, 0.02], hidden=16, sub=TConfig(depth=[2, 3]))
    got = TConfig(**kw)
    ref = JConfig(**{**kw, "sub": JConfig(depth=[2, 3])})
    assert got.state_dict == ref.state_dict and got.has_list() and str(got) == str(ref)
    got["sub/depth"] = 4
    assert got["sub/depth"] == 4 and got.copy().state_dict == got.state_dict


def write_census(root, leading_zero):
    """``tests/test_data.py``'s open-census fixture (three CBGs), with the
    income table's third id written with a leading zero when asked, a CBG
    of the MSA missing from the occupation table, and a row of another CBG."""
    msa = "SanFrancisco"
    full = calibration.MSA_NAME_FULL_DICT[msa]
    os.makedirs(root / msa, exist_ok=True)
    data = root / "safegraph_open_census_data/data"
    os.makedirs(data, exist_ok=True)
    cbgs = [10001, 10002, 10003]
    pd.DataFrame({"cbg_id": cbgs}).to_csv(root / msa / f"{full}_cbg_ids.csv", index=False)
    age = {"census_block_group": cbgs, "B01001e1": [1000, 2000, 0]}
    for i in range(3, 50):
        age[f"B01001e{i}"] = [10, 20, 0]
    for c in ("B01001e23", "B01001e24", "B01001e25", "B01001e47", "B01001e48", "B01001e49"):
        age[c] = [10, 100, 0]
    pd.DataFrame(age).to_csv(data / "cbg_b01.csv", index=False)
    income_ids = ["10001", "10002", "010003" if leading_zero else "10003", "99999"]
    with open(data / "ACS_5years_Income_Filtered_Summary.csv", "w") as fh:
        fh.write("census_block_group,total_households,mean_household_income\n")
        for cbg, hh, inc in zip(income_ids, (400, 800, 10, 5), (50000.0, 90000.0, 30000.0, 1.0)):
            fh.write(f"{cbg},{hh},{inc}\n")
    occ = {"census_block_group": cbgs[:2]}
    for col in calibration.ew_rate_dict:
        occ[col] = [5, 10]
    pd.DataFrame(occ).to_csv(data / "cbg_c24.csv", index=False)
    return str(root), msa


@pytest.mark.parametrize("leading_zero", [False, True])
def test_census_loaders_match_jax(tmp_path, leading_zero):
    root, msa = write_census(tmp_path, leading_zero)
    ref = jdemo.load_cbg_demographics(msa, root)
    got = tdemo.load_cbg_demographics(msa, root)
    for a, b in zip(got, ref):
        assert a.shape == b.shape == (3, 1)
        np.testing.assert_allclose(a, b, rtol=1e-12)
    np.testing.assert_allclose(got[2][:, 0], [50000.0, 90000.0, 30000.0])
    assert got[3][2, 0] == 0.0  # absent from the occupation table
    np.save(tmp_path / "embed.npy", np.eye(3, 5))
    e_got, d_got = tdemo.load_pretrained_embed(str(tmp_path / "embed.npy"))
    e_ref, d_ref = jdemo.load_pretrained_embed(str(tmp_path / "embed.npy"))
    assert d_got == d_ref == 5 and np.array_equal(e_got, e_ref)
