"""Hyperparameter grid sweeps.

The port's copy of ``pygcn_tpu/train/sweep.py`` (pure Python). The
reference's ``Config.has_list`` (``pygcn/config.py:76-80``) flags configs
whose values are lists, its (never finished) sweep convention:
``expand_grid`` turns one list-valued :class:`Config` into the cartesian
product of concrete configs, and ``run_sweep`` runs a trial function over
them, ranks by a metric, and returns the full record.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence

from pygcn_tpu_torch.utils.config import Config


def expand_grid(config: Config) -> List[Config]:
    """Cartesian product over every list-valued (flat, path-keyed) entry.

    A config with no list values expands to ``[config.copy()]``.
    """
    flat = config.state_dict
    keys = [k for k, v in flat.items() if isinstance(v, list)]
    out = []
    for combo in itertools.product(*(flat[k] for k in keys)):
        c = config.copy()
        for k, v in zip(keys, combo):
            c[k] = v
        out.append(c)
    return out


@dataclasses.dataclass
class SweepResult:
    records: List[Dict[str, Any]]  # one per trial: {"params", "metrics"}
    metric: str
    mode: str

    @property
    def best(self) -> Dict[str, Any]:
        key = lambda r: r["metrics"][self.metric]
        pick = max if self.mode == "max" else min
        return pick(
            (r for r in self.records if self.metric in r["metrics"]), key=key
        )

    def table(self) -> str:
        lines = []
        for r in sorted(
            self.records,
            key=lambda r: r["metrics"].get(
                self.metric, float("-inf") if self.mode == "max" else float("inf")
            ),
            reverse=self.mode == "max",
        ):
            params = " ".join(f"{k}={v}" for k, v in r["params"].items())
            metrics = " ".join(f"{k}={v:.5g}" for k, v in r["metrics"].items())
            lines.append(f"{params}  ->  {metrics}")
        return "\n".join(lines)


def run_sweep(
    trial_fn: Callable[[Config], Dict[str, float]],
    config: Config,
    *,
    metric: str,
    mode: str = "max",
    on_trial: Optional[Callable[[int, Dict[str, Any]], None]] = None,
) -> SweepResult:
    """Run ``trial_fn`` on every grid point of ``config``.

    ``trial_fn`` receives a concrete :class:`Config` and returns a metrics
    dict (must contain ``metric``). Trials that raise are recorded with an
    ``"error"`` entry and excluded from ``best``.
    """
    if mode not in ("max", "min"):
        raise ValueError(f"mode must be 'max' or 'min', got {mode!r}")
    swept_keys = [k for k, v in config.state_dict.items() if isinstance(v, list)]
    records: List[Dict[str, Any]] = []
    for i, cfg in enumerate(expand_grid(config)):
        params = {k: cfg[k] for k in swept_keys}
        try:
            metrics = trial_fn(cfg)
        except Exception as e:  # record and continue the sweep
            records.append({"params": params, "metrics": {}, "error": repr(e)})
        else:
            records.append({"params": params, "metrics": dict(metrics)})
        if on_trial is not None:
            on_trial(i, records[-1])
    result = SweepResult(records=records, metric=metric, mode=mode)
    if all("error" in r for r in records):
        raise RuntimeError(
            "every sweep trial failed; first error: " + records[0]["error"]
        )
    return result
