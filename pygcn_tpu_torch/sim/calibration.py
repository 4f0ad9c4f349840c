"""Calibrated scientific constants for the epidemic workload.

The port's own copy of ``pygcn_tpu/sim/calibration.py`` (NumPy-free tables;
the port imports nothing of the JAX package): numeric facts reproduced from
the reference's ``gt-generator/constants.py`` (age bucketing :4-42, MSA
tables :100-124, death scales :129-139, essential-worker rates :142-181),
reorganized as programmatic tables.
"""

from __future__ import annotations

import dataclasses

# ---------------------------------------------------------------------- #
# Census age buckets (ACS B01001): 23 detailed buckets as (lo, hi) years,
# hi=None meaning open-ended. Labels reproduce the ACS column names.
# ---------------------------------------------------------------------- #

_AGE_BOUNDS = [
    (0, 4), (5, 9), (10, 14), (15, 17), (18, 19), (20, 20), (21, 21),
    (22, 24), (25, 29), (30, 34), (35, 39), (40, 44), (45, 49), (50, 54),
    (55, 59), (60, 61), (62, 64), (65, 66), (67, 69), (70, 74), (75, 79),
    (80, 84), (85, None),
]


def _age_label(lo: int, hi) -> str:
    if lo == 0:
        return "Under %d Years" % (hi + 1)
    if hi is None:
        return "%d Years And Over" % lo
    if lo == hi:
        return "%d Years" % lo
    return "%d To %d Years" % (lo, hi)


DETAILED_AGE_LIST = [_age_label(lo, hi) for lo, hi in _AGE_BOUNDS]

# Coarse groupings used for attack/death rates: contiguous runs of the
# detailed buckets, expressed as (start, stop) index ranges.
_ATTACK_RATE_RUNS = [(0, 2), (2, 5), (5, 9), (9, 11), (11, 13), (13, 15), (15, 19), (19, 21), (21, 23)]
_DEATH_RATE_RUNS = [
    (0, 1), (1, 2), (2, 3), (3, 5), (5, 8), (8, 9), (9, 10), (10, 11),
    (11, 12), (12, 13), (13, 14), (14, 15), (15, 17), (17, 19), (19, 20),
    (20, 21), (21, 23),
]

AGE_GROUPS_FOR_ATTACK_RATES = {
    i: DETAILED_AGE_LIST[a:b] for i, (a, b) in enumerate(_ATTACK_RATE_RUNS)
}
AGE_GROUPS_FOR_DEATH_RATES = {
    i: DETAILED_AGE_LIST[a:b] for i, (a, b) in enumerate(_DEATH_RATE_RUNS)
}
NUM_AGE_GROUP_FOR_ATTACK_RATES = len(_ATTACK_RATE_RUNS)
NUM_AGE_GROUP_FOR_DEATH_RATES = len(_DEATH_RATE_RUNS)


# ---------------------------------------------------------------------- #
# Per-MSA calibration records
# ---------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class MSARecord:
    full_name: str
    p_sick_at_t0: float
    home_beta: float
    poi_psi: float
    death_scale: float


MSA_TABLE = {
    "Atlanta": MSARecord("Atlanta_Sandy_Springs_Roswell_GA", 2e-4, 0.0037, 2388, 1.20),
    "Chicago": MSARecord("Chicago_Naperville_Elgin_IL_IN_WI", 1e-4, 0.0063, 2076, 1.30),
    "Dallas": MSARecord("Dallas_Fort_Worth_Arlington_TX", 2e-4, 0.0063, 1452, 1.03),
    "Houston": MSARecord("Houston_The_Woodlands_Sugar_Land_TX", 5e-4, 0.0037, 1139, 0.83),
    "LosAngeles": MSARecord("Los_Angeles_Long_Beach_Anaheim_CA", 2e-4, 0.0088, 1452, 1.52),
    "Miami": MSARecord("Miami_Fort_Lauderdale_West_Palm_Beach_FL", 5e-4, 0.0012, 1764, 0.78),
    "NewYorkCity": MSARecord("New_York_Newark_Jersey_City_NY_NJ_PA", 1e-3, 0.0037, 827, 1.36),
    "Philadelphia": MSARecord("Philadelphia_Camden_Wilmington_PA_NJ_DE_MD", 1e-3, 0.0037, 827, 2.08),
    "SanFrancisco": MSARecord("San_Francisco_Oakland_Hayward_CA", 5e-4, 0.0037, 1139, 0.64),
    "WashingtonDC": MSARecord("Washington_Arlington_Alexandria_DC_VA_MD_WV", 5e-5, 0.0037, 2700, 1.40),
}

MSA_NAME_LIST = [m for m in MSA_TABLE if m != "NewYorkCity"]
MSA_NAME_FULL_DICT = {k: v.full_name for k, v in MSA_TABLE.items()}
parameters_dict = {
    k: [v.p_sick_at_t0, v.home_beta, v.poi_psi] for k, v in MSA_TABLE.items()
}
death_scale_dict = {k: [v.death_scale] for k, v in MSA_TABLE.items()}


# ---------------------------------------------------------------------- #
# Essential-worker rates per ACS C24030 occupation column. Male columns are
# C24030e<n>, female columns C24030e<n+27>, sharing the same rate.
# ---------------------------------------------------------------------- #

_EW_RATES_BY_COLUMN = [
    (4, 1.0), (5, 1.0), (6, 1.0), (7, 1.0), (8, 0.842), (9, 0.444),
    (11, 0.821), (12, 1.0), (13, 0.545), (15, 1.0), (16, 0.5), (18, 0.778),
    (19, 1.0), (20, 0.636), (22, 0.0), (23, 1.0), (25, 0.0), (26, 0.667),
    (27, 0.643),
]

ew_rate_dict = {}
for _n, _rate in _EW_RATES_BY_COLUMN:
    ew_rate_dict["C24030e%d" % _n] = _rate
    ew_rate_dict["C24030e%d" % (_n + 27)] = _rate


# US state FIPS prefixes (public reference data).
FIPS_CODES_FOR_50_STATES_PLUS_DC = {
    "01": "Alabama", "02": "Alaska", "04": "Arizona", "05": "Arkansas",
    "06": "California", "08": "Colorado", "09": "Connecticut", "10": "Delaware",
    "11": "Washington, D.C.", "12": "Florida", "13": "Georgia", "15": "Hawaii",
    "16": "Idaho", "17": "Illinois", "18": "Indiana", "19": "Iowa",
    "20": "Kansas", "21": "Kentucky", "22": "Louisiana", "23": "Maine",
    "24": "Maryland", "25": "Massachusetts", "26": "Michigan", "27": "Minnesota",
    "28": "Mississippi", "29": "Missouri", "30": "Montana", "31": "Nebraska",
    "32": "Nevada", "33": "New Hampshire", "34": "New Jersey", "35": "New Mexico",
    "36": "New York", "37": "North Carolina", "38": "North Dakota", "39": "Ohio",
    "40": "Oklahoma", "41": "Oregon", "42": "Pennsylvania", "44": "Rhode Island",
    "45": "South Carolina", "46": "South Dakota", "47": "Tennessee", "48": "Texas",
    "49": "Utah", "50": "Vermont", "51": "Virginia", "53": "Washington",
    "54": "West Virginia", "55": "Wisconsin", "56": "Wyoming",
}
