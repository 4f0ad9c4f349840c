"""The port's simulator apps and copied host modules against the JAX package's.

``apps/gt_gen`` draws its policies from the NumPy generator of
``--random_seed`` as the JAX CLI does, so both write the same header and the
same ``Vaccinated_Idxs`` / ``Hybrid_Group`` columns; the outcome columns come
from two different random generators and are checked for range only. The
JAX CLIs run here with their simulator replaced by a stand-in: none of the
columns or files compared reads it, and compiling it would take most of a
minute. ``no_vac_baseline`` writes JAX's file names, and the visit average
and the CBG sizes bit for bit; ``export_dynalearn`` and the NumPy modules the
port copied (``calibration``, ``policies``, ``covisit``, ``standardize``)
give JAX's results on the same inputs.
"""

import ast
import dataclasses
import datetime
import os

import numpy as np
import pandas as pd
import pytest
import torch

from pygcn_tpu.apps import export_dynalearn as jexport
from pygcn_tpu.apps import gt_gen as jgt
from pygcn_tpu.apps import no_vac_baseline as jnovac
from pygcn_tpu.data import features as jfeatures
from pygcn_tpu.graph import covisit as jcovisit
from pygcn_tpu.sim import calibration as jcal
from pygcn_tpu.sim import policies as jpol
from pygcn_tpu_torch.apps import export_dynalearn as texport
from pygcn_tpu_torch.apps import gt_gen as tgt
from pygcn_tpu_torch.apps import no_vac_baseline as tnovac
from pygcn_tpu_torch.data import features as tfeatures
from pygcn_tpu_torch.graph import covisit as tcovisit
from pygcn_tpu_torch.sim import calibration as tcal
from pygcn_tpu_torch.sim import policies as tpol

torch.set_num_threads(1)

OUTCOMES = ["Total_Cases", "Case_Rates_STD", "Total_Deaths", "Death_Rates_STD"]
GT_MODES = {
    "fixed_nn": [],
    "flood": ["--distribution", "flood"],
    "grouping_safe_distance": ["--grouping", "--safe_distance", "0.05"],
    "randombag": ["--randombag"],
}


def stand_in_outcomes(world, vac_vectors, num_seeds, key, approx=False, mesh=None,
                      return_cbg=False):
    """The JAX CLI's ``batch_policy_outcomes`` without its simulator: rows
    of its shape, and per-CBG deaths that give finite equity columns."""
    rows = [(1.0, 0.0, 1.0, 0.0)] * len(vac_vectors)
    deaths = [np.arange(1.0, world.n_cbgs + 1)] * len(vac_vectors)
    return (rows, deaths) if return_cbg else rows


@pytest.mark.parametrize("mode", list(GT_MODES))
def test_gt_gen_policy_columns_match_jax(mode, tmp_path, monkeypatch):
    argv = ["--quick_test", "--random_seed", "7", "--n_cbgs", "48", "--hours", "24",
            *GT_MODES[mode]]
    monkeypatch.setattr(jgt, "batch_policy_outcomes", stand_in_outcomes)
    jgt.main([*argv, "--out", str(tmp_path / "jax.csv")])
    tgt.main([*argv, "--device", "cpu", "--out", str(tmp_path / "port.csv")])
    ref, got = (pd.read_csv(tmp_path / f) for f in ("jax.csv", "port.csv"))
    assert list(got.columns) == list(ref.columns)
    assert len(got) == len(ref) > 1
    assert got["Vaccinated_Idxs"].tolist() == ref["Vaccinated_Idxs"].tolist()
    assert got["Vaccinated_Idxs"].iloc[0] == "[]"
    assert all(ast.literal_eval(v) for v in got["Vaccinated_Idxs"].iloc[1:])
    if mode == "randombag":
        assert got["Hybrid_Group"].tolist() == ref["Hybrid_Group"].tolist()
        assert (got.filter(like="_Abs") >= 0).all().all()
    values = got.drop(columns="Vaccinated_Idxs").to_numpy(np.float64)
    assert np.isfinite(values).all()
    assert (got[OUTCOMES] >= 0).all().all()
    assert got["Total_Cases"].iloc[0] > 0


def stand_in_simulation(world, vaccination_vector, num_seeds, key, vaccination_time=None,
                        page_hours=None):
    days = world.params.total_hours // 24
    zeros = np.zeros((days, num_seeds, world.n_cbgs), np.float32)
    return {"history_C2": zeros, "history_D2": zeros}


def test_no_vac_baseline_files_match_jax(tmp_path, monkeypatch):
    argv = ["--quick_test", "--n_cbgs", "32", "--hours", "48"]
    monkeypatch.setattr(jnovac, "run_policy_simulation", stand_in_simulation)
    jnovac.main([*argv, "--out_dir", str(tmp_path / "jax")])
    cases, deaths = tnovac.main([*argv, "--device", "cpu", "--out_dir", str(tmp_path / "port")])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and len(names) == 4
    for name in names:
        if name.startswith(("avg_array", "cbg_sizes")):
            ref, got = (np.load(tmp_path / d / name) for d in ("jax", "port"))
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref, err_msg=name)
    assert cases.shape == deaths.shape == (4, 32)
    assert np.isfinite(cases).all() and cases[-1].sum() > 0
    # paged visits give the same bits
    paged, _ = tnovac.main([*argv, "--device", "cpu", "--page_hours", "24",
                            "--out_dir", str(tmp_path / "paged")])
    np.testing.assert_array_equal(paged, cases)

    out = texport.main(["--gt_dir", str(tmp_path / "port"), "--num_seeds", "2"])
    import h5py

    with h5py.File(out, "r") as f:
        assert f["timeseries"].shape == (4, 32 + 20)
        assert f["inputs"].shape[3] == 5 and "networks" in f


@pytest.mark.parametrize("gen_code", [0, 1, 2, 3])
def test_export_network_and_lag_window_match_jax(gen_code):
    rng = np.random.default_rng(0)
    cases = np.cumsum(rng.uniform(0, 5, (9, 30)), axis=0)
    avg = rng.uniform(0, 1, (12, 30)) * (rng.uniform(size=(12, 30)) < 0.3)
    sizes = rng.integers(500, 3000, 30).astype(np.float32)
    ref = jexport.build_network(gen_code, cases, avg, sizes, np.random.default_rng(5))
    got = texport.build_network(gen_code, cases, avg, sizes, np.random.default_rng(5))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(texport.lag_window(got[0], lag=4),
                    jexport.lag_window(ref[0], lag=4)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("app", [tgt, tnovac])
def test_default_device_raises_without_cuda(app, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    flag = "--out" if app is tgt else "--out_dir"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main(["--quick_test", flag, str(tmp_path / "x")])


def test_gt_gen_shards(tmp_path):
    """``--shards 1`` runs as one rank in this process and writes the
    unsharded CSV; ``--shards 2`` beyond the visible cards is refused before
    anything starts (2 ranks: ``tests/test_torch_data_parallel.py``)."""
    flags = ["--device", "cpu", "--quick_test", "--n_cbgs", "24"]
    tgt.main([*flags, "--out", str(tmp_path / "plain.csv")])
    tgt.main([*flags, "--out", str(tmp_path / "one.csv"), "--shards", "1"])
    with open(tmp_path / "plain.csv") as a, open(tmp_path / "one.csv") as b:
        assert a.read() == b.read()
    with pytest.raises(ValueError, match="mesh needs 2 devices, have"):
        tgt.main(["--shards", "2", "--device", "cuda", "--out", str(tmp_path / "x.csv")])
    assert not os.path.exists(tmp_path / "x.csv")


def test_safegraph_visits_generator():
    """``apps/time_sim``'s stand-in for SafeGraph visits, at a small size:
    the padded COO the simulator takes, one entry per (POI, CBG) pair, about
    ``entries`` an hour, and the busiest POIs visited by every CBG."""
    from pygcn_tpu_torch.apps.time_sim import safegraph_visits
    from pygcn_tpu_torch.sim import VisitSeq

    n_cbgs, n_pois, entries, period = 50, 400, 3000, 6
    poi, cbg, w = safegraph_visits(3, n_cbgs, n_pois, entries, period)
    assert poi.shape == cbg.shape == w.shape and poi.shape[0] == period
    assert poi.dtype == cbg.dtype == np.int32 and w.dtype == np.float32
    assert (poi < n_pois).all() and (cbg < n_cbgs).all() and (w >= 0).all()
    again = safegraph_visits(3, n_cbgs, n_pois, entries, period)
    assert all(np.array_equal(a, b) for a, b in zip((poi, cbg, w), again))
    for t in range(period):
        real = w[t] > 0
        assert abs(real.sum() - entries) < 5 * np.sqrt(entries)
        pairs = np.unique(poi[t][real].astype(np.int64) * n_cbgs + cbg[t][real]).size
        assert pairs == real.sum()
        assert np.bincount(poi[t][real], minlength=n_pois).max() == n_cbgs
    v = VisitSeq.from_coo(poi, cbg, w, n_pois, n_cbgs, "cpu")
    assert list(v.nnz) == (w > 0).sum(1).tolist()
    assert torch.equal(torch.diff(v.poi_ptr, dim=1),
                       torch.from_numpy(np.stack([np.bincount(poi[t][w[t] > 0], minlength=n_pois)
                                                  for t in range(period)])))


# ---------------------------------------------------------------------- #
# the NumPy modules the port keeps its own copy of
# ---------------------------------------------------------------------- #


def public_data(module):
    return {k: v for k, v in vars(module).items()
            if not k.startswith("_") and isinstance(v, (dict, list, int, float, str))}


def test_calibration_tables_equal_jax():
    ref, got = public_data(jcal), public_data(tcal)
    assert set(got) == set(ref) and len(ref) >= 10
    for k in ref:
        if k == "MSA_TABLE":
            assert {m: dataclasses.astuple(r) for m, r in got[k].items()} == {
                m: dataclasses.astuple(r) for m, r in ref[k].items()}
        else:
            assert got[k] == ref[k], k


def test_policies_equal_jax():
    rng = np.random.default_rng(0)
    sizes = rng.integers(100, 1000, 30).astype(float)
    feat = rng.normal(size=30)
    cur = np.where(rng.uniform(size=30) < 0.2, sizes, 0.0)
    vuln = (rng.uniform(size=30) < 0.1).astype(int)
    calls = [
        ("vaccine_distribution_flood", (sizes, 0.4, feat, True, 0.6)),
        ("vaccine_distribution_flood", (sizes, 0.3, feat, False, 1.0, 3)),
        ("vaccine_distribution_flood_new", (sizes, 0.2, feat, True, 0.7, 50.0, True, cur, vuln)),
        ("vaccine_distribution_flood_new", (sizes, 0.2, feat, False, 1.0, 0.0, False, cur,
                                            vuln)),
        ("vaccine_distribution_fixed_nn", (sizes, 0.1, 4, False, [1, 3, 9, 20])),
        ("vaccine_distribution_fixed_nn", (sizes, 0.1, 4, True, [1, 3, 9, 20])),
        ("get_separators", (sizes, rng.uniform(size=30), 4, True)),
        ("get_separators", (sizes, feat, 3, False)),
        ("gini", (sizes,)),
        ("apply_smoothing", (feat,)),
        ("average_across_random_seeds", (rng.uniform(size=(3, 4, 30)),
                                         rng.uniform(size=(3, 4, 30)), [0, 5, 7])),
        ("average_across_random_seeds_only_death", (rng.uniform(size=(3, 4, 30)), [2, 4])),
        ("vulnerability_and_damage", (sizes * 0.1, sizes * 0.02, sizes,
                                      rng.uniform(0, 0.05, 30), 0.9, 0.01)),
        ("fips_code", (6, 75)),
        ("match_msa_name_to_acs", ("Oakland_CA", ["San Francisco-Oakland-Hayward, CA"])),
        ("list_hours_in_range", (datetime.datetime(2020, 3, 1), datetime.datetime(2020, 3, 2))),
        ("assign_acceptance_absolute", (45000.0, "cf3")),
        ("assign_acceptance_quantile", (2, "cf13")),
    ]
    seps = jpol.get_separators(sizes, feat, 4, normalized=False)
    calls += [("assign_groups", (feat, seps, rev)) for rev in (False, True)]
    calls += [("assign_group", (x, seps, True)) for x in feat[:5]]
    for name, args in calls:
        ref, got = getattr(jpol, name)(*args), getattr(tpol, name)(*args)
        if not isinstance(ref, tuple):
            ref, got = (ref,), (got,)
        assert len(got) == len(ref), name
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)
    assert {n for n in vars(jpol) if callable(getattr(jpol, n)) and not n.startswith("_")
            and getattr(getattr(jpol, n), "__module__", "") == jpol.__name__} <= set(vars(tpol))


def test_covisit_and_standardize_equal_jax(tmp_path):
    import scipy.sparse as sp

    rng = np.random.default_rng(1)
    mats = [rng.uniform(size=(7, 11)) * (rng.uniform(size=(7, 11)) < 0.4) for _ in range(5)]
    mixed = mats[:2] + [sp.csr_matrix(m) for m in mats[2:]]
    avg = tcovisit.average_visits(mixed)
    np.testing.assert_array_equal(avg, jcovisit.average_visits(mixed))
    np.testing.assert_array_equal(tcovisit.covisitation_adj(avg), jcovisit.covisitation_adj(avg))
    got = tcovisit.load_or_build_adj("X", str(tmp_path / "t"), mats)
    ref = jcovisit.load_or_build_adj("X", str(tmp_path / "j"), mats)
    np.testing.assert_array_equal(got, ref)
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    np.testing.assert_array_equal(tcovisit.load_or_build_adj("X", str(tmp_path / "t")), got)
    with pytest.raises(FileNotFoundError):
        tcovisit.load_or_build_adj("Y", str(tmp_path / "t"))
    x = rng.normal(size=(20, 4)) * [1, 0, 3, 5]
    np.testing.assert_array_equal(tfeatures.standardize(x), jfeatures.standardize(x))
