"""Vaccine-distribution policies, grouping, and equity metrics.

The port's own NumPy copy of ``pygcn_tpu/sim/policies.py``: array-based
re-implementations of the reference's ``gt-generator/functions.py`` helpers.
The pandas row-loops become vectorized prefix-sum / lexsort operations with
identical semantics; citations note the reference function each mirrors.
These are host-side policy constructors — the vectors they produce feed the
simulator on the device.
"""

from __future__ import annotations

import datetime
from typing import Callable, Optional, Sequence

import numpy as np


def list_hours_in_range(min_hour: datetime.datetime, max_hour: datetime.datetime):
    """Hourly datetimes, inclusive (reference ``functions.py:7-16``)."""
    assert min_hour <= max_hour
    hours = []
    while min_hour <= max_hour:
        hours.append(min_hour)
        min_hour = min_hour + datetime.timedelta(hours=1)
    return hours


def match_msa_name_to_acs(msa_name: str, acs_msas: Sequence[str]) -> Optional[str]:
    """Match a SafeGraph MSA name to an ACS MSA string
    (reference ``functions.py:19-45``): same state set + ≥1 shared city."""
    pieces = msa_name.split("_")
    i = len(pieces) - 1
    states = set()
    while i >= 0 and len(pieces[i]) == 2 and pieces[i].isupper():
        states.add(pieces[i])
        i -= 1
    cities = set(pieces[: i + 1])
    for msa in acs_msas:
        if ", " not in msa:
            continue
        city_str, state_str = msa.split(", ")
        if set(state_str.split("-")) == states and set(city_str.split("-")) & cities:
            return msa
    return None


def fips_code(state, county) -> int:
    """Compose a 5-digit FIPS code (reference ``functions.py:48-57``)."""
    return int(f"{int(state):02d}{int(county):03d}")


def average_across_random_seeds(history_C2, history_D2, cbg_idxs):
    """Seed-averages + MSA totals (reference ``functions.py:61-83``).

    ``history_*``: [D, S, N] → (avg_C2 [D,N], avg_D2 [D,N],
    cases_msa [D], deaths_msa [D]) summed over ``cbg_idxs``.
    """
    avg_c = np.mean(np.asarray(history_C2), axis=1)
    avg_d = np.mean(np.asarray(history_D2), axis=1)
    idx = np.asarray(cbg_idxs)
    return avg_c, avg_d, avg_c[:, idx].sum(1), avg_d[:, idx].sum(1)


def average_across_random_seeds_only_death(history_D2, cbg_idxs):
    avg_d = np.mean(np.asarray(history_D2), axis=1)
    return avg_d, avg_d[:, np.asarray(cbg_idxs)].sum(1)


def apply_smoothing(x, agg_func: Callable = np.mean, before: int = 3, after: int = 3):
    """Windowed smoothing (reference ``functions.py:107-113``)."""
    x = np.asarray(x)
    return np.array(
        [agg_func(x[max(0, i - before) : min(len(x), i + after + 1)]) for i in range(len(x))]
    )


def _prefix_cover(sorted_sizes: np.ndarray, budget: float):
    """Index i with prefix_sum[:i] <= budget < prefix_sum[:i+1]."""
    cum = np.concatenate([[0.0], np.cumsum(sorted_sizes)])
    i = int(np.searchsorted(cum, budget, side="right")) - 1
    return min(i, len(sorted_sizes) - 1), cum


def vaccine_distribution_flood(
    sizes: np.ndarray,
    vaccination_ratio: float,
    feature: np.ndarray,
    ascending: bool,
    execution_ratio: float,
    seed: int = 42,
) -> np.ndarray:
    """Water-flood by demographic rank (reference ``functions.py:118-170``):
    fully cover CBGs in feature order until the policy budget runs out, give
    the next CBG the remainder, then distribute the non-policy leftover over a
    seed-42 random permutation of uncovered CBGs."""
    sizes = np.asarray(sizes, np.float64)
    n = sizes.size
    budget = sizes.sum() * vaccination_ratio * execution_ratio

    order = np.argsort(feature, kind="stable")
    if not ascending:
        order = order[::-1]
    i_full, cum = _prefix_cover(sizes[order], budget)

    vac = np.zeros(n)
    vac[order[:i_full]] = sizes[order[:i_full]]
    vac[order[i_full]] = budget - cum[i_full]

    left = sizes.sum() * vaccination_ratio - vac.sum()
    perm = np.arange(n)
    rng = np.random.RandomState(seed)
    rng.shuffle(perm)
    for j in perm:
        if vac[j] == 0:
            give = min(sizes[j], left)
            vac[j] = give
            left -= give
    return vac


def vaccine_distribution_flood_new(
    sizes: np.ndarray,
    vaccination_ratio: float,
    feature: np.ndarray,
    ascending: bool,
    execution_ratio: float,
    leftover: float,
    is_last: bool,
    current_vector: np.ndarray,
    most_vulnerable: np.ndarray,
) -> np.ndarray:
    """Vulnerable-group-priority flood (reference ``functions.py:220-275``):
    rank by (Most_Vulnerable desc, already-Covered asc, feature), flood the
    per-round budget + leftover; the partially-covered CBG is filled only on
    the final round."""
    sizes = np.asarray(sizes, np.float64)
    n = sizes.size
    covered = (np.asarray(current_vector) == sizes).astype(np.int64)
    feat = np.asarray(feature, np.float64)
    feat_key = feat if ascending else -feat
    # np.lexsort: last key is primary
    order = np.lexsort((feat_key, covered, -np.asarray(most_vulnerable, np.int64)))

    budget = sizes.sum() * vaccination_ratio * execution_ratio + leftover
    i_full, cum = _prefix_cover(sizes[order], budget)

    vac = np.zeros(n)
    vac[order[:i_full]] = sizes[order[:i_full]]
    if is_last:
        vac[order[i_full]] = budget - cum[i_full]
    return vac


def vaccine_distribution_fixed_nn(
    sizes: np.ndarray,
    vaccination_ratio: float,
    nn: int,
    proportional: bool,
    target_idxs: Optional[Sequence[int]] = None,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Fixed-NN distribution (reference ``functions.py:419-449``): the budget
    goes to exactly ``nn`` CBGs — equal shares or population-proportional —
    capped at each CBG's population."""
    sizes = np.asarray(sizes, np.float64)
    n = sizes.size
    if target_idxs is None:
        rng = rng or np.random.default_rng()
        target_idxs = rng.choice(n, nn, replace=False)
    target_idxs = np.asarray(target_idxs)
    assert target_idxs.size == nn, "Wrong number of targeted cbgs!"

    budget = sizes.sum() * vaccination_ratio
    vac = np.zeros(n)
    if not proportional:
        vac[target_idxs] = budget / nn
    else:
        vac[target_idxs] = budget * sizes[target_idxs] / sizes[target_idxs].sum()
    return np.minimum(vac, sizes)


def get_separators(
    sizes: np.ndarray,
    indicator: np.ndarray,
    num_groups: int,
    normalized: bool,
) -> np.ndarray:
    """Population-weighted quantile separators of ``indicator``
    (reference ``functions.py:173-193``): separator i+1 is the indicator value
    where cumulative population crosses ``i+1`` group-sizes."""
    sizes = np.asarray(sizes, np.float64)
    indicator = np.asarray(indicator, np.float64)
    total = sizes.sum()
    group_size = total / num_groups

    order = np.argsort(indicator, kind="stable")
    cum = np.concatenate([[0.0], np.cumsum(sizes[order])])  # cum[j] = head(j) sum

    separators = np.zeros(num_groups + 1)
    last = 0
    for i in range(num_groups):
        target = group_size * (i + 1)
        for j in range(last, len(order)):
            if cum[j] <= target <= cum[j + 1]:
                separators[i + 1] = indicator[order[j]]
                last = j
                break
    separators[0] = -0.1  # avoid an empty [0, 0] first group (reference :190)
    separators[-1] = 1 if normalized else indicator.max()
    return separators


def assign_group(x: float, separators: np.ndarray, reverse: bool = False) -> int:
    """Interval assignment ``sep[i] < x <= sep[i+1]``; ``reverse`` flips group
    order so the most disadvantaged gets the largest id
    (reference ``functions.py:197-214``)."""
    num_groups = len(separators) - 1
    for i in range(num_groups):
        if separators[i] < x <= separators[i + 1]:
            return num_groups - 1 - i if reverse else i
    return 0 if reverse else num_groups - 1


def assign_groups(values: np.ndarray, separators: np.ndarray, reverse: bool = False):
    """Vectorized :func:`assign_group` over an array."""
    v = np.asarray(values)
    idx = np.searchsorted(separators[1:-1], v, side="left")
    in_range = (v > separators[0]) & (v <= separators[-1])
    num_groups = len(separators) - 1
    idx = np.where(in_range, idx, num_groups - 1 if not reverse else 0)
    if reverse:
        idx = np.where(in_range, num_groups - 1 - idx, idx)
    return idx.astype(np.int64)


def gini(array: np.ndarray) -> float:
    """Gini coefficient (reference ``functions.py:278-298``)."""
    array = np.asarray(array, np.float64).flatten()
    if np.amin(array) < 0:
        array = array - np.amin(array)
    array = array + 1e-7
    array = np.sort(array)
    index = np.arange(1, array.shape[0] + 1)
    n = array.shape[0]
    return float(np.sum((2 * index - n - 1) * array) / (n * np.sum(array)))


# Income-bracket vaccine-acceptance scenarios (reference functions.py:301-351):
# list of (income_upper_bound, acceptance) rows per scenario.
_ABSOLUTE_SCENARIOS = {
    "real": [(30000, 0.72), (60000, 0.74), (99999, 0.81), (np.inf, 0.86)],
    "cf1": [(30000, 0.576), (60000, 0.592), (99999, 0.81), (np.inf, 0.86)],
    "cf2": [(30000, 0.3), (60000, 0.6), (99999, 1.0), (np.inf, 1.0)],
    "cf3": [(30000, 0.3), (60000, 0.3), (99999, 1.0), (np.inf, 1.0)],
    "cf4": [(30000, 0.2), (60000, 0.2), (99999, 1.0), (np.inf, 1.0)],
    "cf5": [(30000, 0.1), (60000, 0.1), (99999, 1.0), (np.inf, 1.0)],
    "cf6": [(30000, 0.1), (60000, 0.5), (99999, 1.0), (np.inf, 1.0)],
    "cf7": [(30000, 0.1), (60000, 0.8), (99999, 1.0), (np.inf, 1.0)],
    "cf8": [(30000, 0.0), (60000, 0.0), (99999, 1.0), (np.inf, 1.0)],
}

# Quantile scenarios (reference functions.py:353-416): acceptance per quintile.
_QUANTILE_SCENARIOS = {
    "cf9": [0, 0, 0.5, 1, 1],
    "cf10": [0.3, 0.3, 0.3, 1, 1],
    "cf11": [0.3, 0.3, 1, 1, 1],
    "cf12": [0.3, 1, 1, 1, 1],
    "cf13": [0.2, 0.4, 0.6, 0.8, 1],
    "cf14": [0.2, 0.2, 1, 1, 1],
    "cf15": [0.1, 0.1, 1, 1, 1],
    "cf16": [0.1, 1, 1, 1, 1],
    "cf17": [0.1, 0.3, 0.5, 0.7, 1],
    "cf18": [0.6, 0.7, 0.8, 0.9, 1],
}


def assign_acceptance_absolute(income: float, scenario: str) -> float:
    rows = _ABSOLUTE_SCENARIOS.get(scenario)
    if rows is None:
        raise ValueError(f"invalid acceptance scenario {scenario!r}")
    for bound, acc in rows:
        if income <= bound:
            return acc
    return rows[-1][1]


def assign_acceptance_quantile(quantile: int, scenario: str) -> float:
    rows = _QUANTILE_SCENARIOS.get(scenario)
    if rows is None:
        raise ValueError(f"invalid acceptance scenario {scenario!r}")
    return rows[int(quantile)]


def vulnerability_and_damage(
    avg_infect_same: np.ndarray,
    avg_infect_diff: np.ndarray,
    cbg_sizes: np.ndarray,
    death_rates_scaled: np.ndarray,
    s_ratio: float,
    i_ratio: float,
):
    """Vulnerability/Damage stratification features
    (reference ``gt-gen-vac-randombag.py:355-390``).

    ``avg_infect_same``/``avg_infect_diff``: per-CBG expected infections from
    same/different CBGs (precomputed infection matrices). Vulnerability is the
    population-normalized infection load times the CBG death rate; Damage
    adds the secondary-infection term scaled by the MSA-average death rate and
    the S/I ratio snapshot.
    """
    sizes = np.asarray(cbg_sizes, np.float64)
    infect_all_norm = (np.asarray(avg_infect_same) + np.asarray(avg_infect_diff)) / sizes
    death = np.asarray(death_rates_scaled, np.float64)
    avg_death = float(sizes @ death / sizes.sum())
    vulnerability = infect_all_norm * death
    secondary = infect_all_norm * (infect_all_norm * (s_ratio / i_ratio)) * avg_death
    return vulnerability, vulnerability + secondary
