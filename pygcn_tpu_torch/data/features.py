"""Node-feature helpers for the simulator and evaluator apps.

The port's own copy of ``standardize`` from ``pygcn_tpu/data/features.py``
(the reference's ``pygcn/utils.py:280-287``), which ``apps/gt_gen`` uses to
rank CBGs; the centrality features and the assembly modes of that module
come with the evaluator pipeline.
"""

from __future__ import annotations

import numpy as np


def standardize(x: np.ndarray) -> np.ndarray:
    """Column-wise (x - mean)/std, std 0 → leave centered values (sklearn
    StandardScaler semantics)."""
    x = np.asarray(x, np.float64)
    mean = x.mean(axis=0, keepdims=True)
    std = x.std(axis=0, keepdims=True)
    std = np.where(std == 0, 1.0, std)
    return ((x - mean) / std).astype(np.float32)
