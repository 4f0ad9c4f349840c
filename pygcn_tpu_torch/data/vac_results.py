"""Ground-truth vaccination-result CSVs: parsing, splits and combining.

The port of ``pygcn_tpu/data/vac_results.py`` (the reference's
``load_vac_results``, ``pygcn/utils.py:31-90``, and the evaluator trainer's
combine-and-dedup step, ``pygcn/gnn-over-mlp.py:108-142``) on the ``csv``
module, without pandas:

- row 0 of each CSV is the no-vaccination baseline;
- ``Vaccinated_Idxs`` holds a stringified int list per policy sample;
- labels are ``[Total_Cases, Case_Rates_STD]`` (+ ``Total_Deaths,
  Death_Rates_STD`` when present), optionally offset by the baseline;
- the split is the reference's seed-42 shuffled 80/10/10 in which **test is
  the middle slice and val the last**.
"""

from __future__ import annotations

import csv
import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class VacResults:
    graph_labels: np.ndarray  # [num_samples, 2 or 4] float32
    idx_train: np.ndarray
    idx_val: np.ndarray
    idx_test: np.ndarray
    num_samples: int
    vac_tags: List[np.ndarray]  # per-sample vaccinated CBG index lists
    baseline: Optional[dict]  # no-vaccination row values


_LABEL_COLS4 = ["Total_Cases", "Case_Rates_STD", "Total_Deaths", "Death_Rates_STD"]
_LABEL_COLS2 = ["Total_Cases", "Case_Rates_STD"]


def _parse_idx_list(s: str) -> np.ndarray:
    s = s.strip().strip("[").strip("]")
    if not s:
        return np.zeros(0, np.int64)
    return np.array([int(v) for v in s.split(", ")], np.int64)


def _read_columns(path) -> dict:
    """The CSV's columns by name, in header order, each a list of strings."""
    with open(path, newline="") as fh:
        reader = csv.reader(fh)
        header = next(reader)
        cols = {name: [] for name in header}
        for row in reader:
            for name, value in zip(header, row):
                cols[name].append(value)
    return cols


def load_vac_results(path, rel_result: bool = True, seed: int = 42) -> VacResults:
    cols = _read_columns(path)
    num_samples = len(cols["Vaccinated_Idxs"]) - 1

    baseline = None
    try:
        baseline = {c: float(cols[c][0]) for c in _LABEL_COLS2}
        if "Total_Deaths" in cols:
            baseline["Total_Deaths"] = float(cols["Total_Deaths"][0])
            baseline["Death_Rates_STD"] = float(cols["Death_Rates_STD"][0])
    except (KeyError, ValueError, IndexError):
        pass

    vac_tags = [_parse_idx_list(s) for s in cols["Vaccinated_Idxs"][1:]]

    names = _LABEL_COLS4 if "Total_Deaths" in cols else _LABEL_COLS2
    labels = np.array([[float(v) for v in cols[c][1:]] for c in names],
                      np.float64).T.astype(np.float32).reshape(num_samples, len(names))
    if rel_result and baseline is not None:
        labels = labels - np.array([baseline[c] for c in names], np.float32)

    shuffled = np.arange(num_samples)
    rng = np.random.RandomState(seed)
    rng.shuffle(shuffled)
    n80, n90 = int(0.8 * num_samples), int(0.9 * num_samples)
    idx_train = shuffled[:n80]
    idx_test = shuffled[n80:n90]  # the reference keeps test as the middle slice
    idx_val = shuffled[n90:]

    return VacResults(
        graph_labels=labels,
        idx_train=idx_train.astype(np.int64),
        idx_val=idx_val.astype(np.int64),
        idx_test=idx_test.astype(np.int64),
        num_samples=num_samples,
        vac_tags=vac_tags,
        baseline=baseline,
    )


def _parse_column(values: List[str]) -> list:
    """A column's values as pandas' ``read_csv`` types them: ints if every
    value is one, else floats if every value is one (empty → NaN), else the
    strings."""
    for cast in (int, float):
        try:
            return [cast(v) if v != "" or cast is int else math.nan for v in values]
        except ValueError:
            pass
    return list(values)


def _row_key(row: tuple) -> tuple:
    # NaN equals NaN for duplicates, as in pandas' drop_duplicates
    return tuple(("nan",) if isinstance(v, float) and math.isnan(v) else v for v in row)


def combine_vac_results(paths: Sequence, out_path=None):
    """Concatenate ground-truth CSVs and drop duplicate rows on their parsed
    values, keeping the first (``pd.concat(...).drop_duplicates()``). Returns
    ``(columns, rows)``: the union of the files' columns in order of first
    appearance, and the kept rows as tuples of parsed values (NaN where a
    file lacks a column); writes them to ``out_path`` when given."""
    files = [_read_columns(p) for p in paths]
    columns = list(dict.fromkeys(name for cols in files for name in cols))
    merged = {name: [] for name in columns}
    for cols in files:
        n = len(next(iter(cols.values()), []))
        for name in columns:
            merged[name] += cols.get(name, [""] * n)
    parsed = [_parse_column(merged[name]) for name in columns]
    rows, seen = [], set()
    for row in zip(*parsed):
        key = _row_key(row)
        if key not in seen:
            seen.add(key)
            rows.append(row)
    if out_path is not None:
        with open(out_path, "w", newline="") as fh:
            writer = csv.writer(fh)
            writer.writerow(columns)
            writer.writerows(["" if isinstance(v, float) and math.isnan(v) else v
                              for v in row] for row in rows)
    return columns, rows
