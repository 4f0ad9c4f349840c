"""SafeGraph open-census demographic feature loaders.

The port of ``pygcn_tpu/data/demographics.py`` (the reference's loaders,
``pygcn/utils.py:135-257``) on the ``csv`` module, without pandas:
population, elder ratio, mean household income and essential-worker ratio
per CBG of an MSA, plus pretrained node embeddings. Each table is joined to
the MSA's CBG ids as pandas' left merge does (ids read as integers, so an id
written with a leading zero matches; every match of an id in turn; ids
without one get zeros), and missing values count as 0.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Tuple

import numpy as np

from pygcn_tpu_torch.sim import calibration

CBG_COLUMN = "census_block_group"


def _read_table(path: str) -> Tuple[List[str], List[List[str]]]:
    with open(path, newline="") as fh:
        reader = csv.reader(fh)
        header = next(reader)
        return header, list(reader)


def _number(value: str) -> float:
    """A census cell as a float; an empty cell is missing (0)."""
    return float(value) if value.strip() else 0.0


def load_cbg_ids(msa_name: str, mob_data_root: str) -> np.ndarray:
    """CBG ids of an MSA, as integers (reference ``pygcn/utils.py:239-242``)."""
    full = calibration.MSA_NAME_FULL_DICT[msa_name]
    header, rows = _read_table(os.path.join(mob_data_root, msa_name, f"{full}_cbg_ids.csv"))
    col = header.index("cbg_id")
    return np.array([int(r[col]) for r in rows], np.int64)


def _left_merge(cbg_ids: np.ndarray, path: str, columns) -> Tuple[int, Dict[str, np.ndarray]]:
    """``columns`` of the table at ``path`` joined to ``cbg_ids`` on the CBG
    id: one output row per match of each id in turn (a missing id gives one
    row of zeros); absent columns are left out. Returns the row count and
    the columns."""
    header, rows = _read_table(path)
    key = header.index(CBG_COLUMN)
    matches: Dict[int, list] = {}
    for r in rows:
        matches.setdefault(int(float(r[key])), []).append(r)
    cols = [c for c in columns if c in header]
    where = [header.index(c) for c in cols]
    merged = [r for cbg in cbg_ids.tolist() for r in matches.get(cbg, [None])]
    return len(merged), {c: np.array([0.0 if r is None else _number(r[i]) for r in merged],
                                     np.float64) for c, i in zip(cols, where)}


def load_cbg_age(mob_data_root: str, cbg_ids: np.ndarray):
    """Population sizes and elder ratio from ACS B01001 (reference
    ``pygcn/utils.py:146-184``): male column ``B01001e{i}`` pairs with female
    ``B01001e{i+24}`` for i in 3..25; elders are 70+."""
    path = os.path.join(mob_data_root, "safegraph_open_census_data/data/cbg_b01.csv")
    names = ["B01001e1"] + [f"B01001e{i}" for i in range(3, 50)]
    _, df = _left_merge(cbg_ids, path, names)

    total = df["B01001e1"]
    total = np.where(total == 0, 1.0, total)

    ages = {}
    for i in range(3, 26):
        label = calibration.DETAILED_AGE_LIST[i - 3]
        ages[label] = df[f"B01001e{i}"] + df[f"B01001e{i + 24}"]

    elder_labels = [lb for lb in calibration.DETAILED_AGE_LIST if lb in (
        "70 To 74 Years", "75 To 79 Years", "80 To 84 Years", "85 Years And Over")]
    elder = sum(ages[lb] for lb in elder_labels)
    elder_ratio = elder / total

    sizes = total.astype(np.int32)
    return sizes, sizes.copy(), elder_ratio


def load_cbg_income(mob_data_root: str, cbg_ids: np.ndarray) -> np.ndarray:
    """Mean household income (reference ``pygcn/utils.py:187-207``)."""
    path = os.path.join(
        mob_data_root, "safegraph_open_census_data/data/ACS_5years_Income_Filtered_Summary.csv"
    )
    _, df = _left_merge(cbg_ids, path, ["mean_household_income", "Mean_Household_Income"])
    col = "mean_household_income" if "mean_household_income" in df else "Mean_Household_Income"
    return df[col]


def load_cbg_occupation(
    mob_data_root: str, cbg_ids: np.ndarray, cbg_sizes: np.ndarray
) -> np.ndarray:
    """Essential-worker ratio weighted by per-occupation rates
    (reference ``pygcn/utils.py:210-234``)."""
    path = os.path.join(mob_data_root, "safegraph_open_census_data/data/cbg_c24.csv")
    n, df = _left_merge(cbg_ids, path, list(calibration.ew_rate_dict))

    ew_abs = np.zeros(n, np.float64)
    for col, rate in calibration.ew_rate_dict.items():
        if col in df:
            ew_abs = ew_abs + df[col] * rate
    ratio = ew_abs / np.asarray(cbg_sizes, np.float64)
    return np.nan_to_num(ratio)


def load_cbg_demographics(
    msa_name: str, mob_data_root: str
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The per-MSA demographic merge (reference ``pygcn/utils.py:237-257``);
    returns column vectors (sizes, elder_ratio, household_income, ew_ratio),
    each [N, 1]."""
    ids = load_cbg_ids(msa_name, mob_data_root)
    sizes, sizes_orig, elder = load_cbg_age(mob_data_root, ids)
    income = load_cbg_income(mob_data_root, ids)
    ew = load_cbg_occupation(mob_data_root, ids, sizes_orig)
    return (
        sizes.reshape(-1, 1).astype(np.float64),
        elder.reshape(-1, 1),
        income.reshape(-1, 1),
        ew.reshape(-1, 1),
    )


def load_pretrained_embed(path: str) -> Tuple[np.ndarray, int]:
    """Pretrained node embeddings ``.npy`` (reference ``pygcn/utils.py:135-143``)."""
    embed = np.load(path)
    return embed, embed.shape[1]
