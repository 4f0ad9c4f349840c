"""Persistent simulation memo-cache: the port of ``pygcn_tpu/policy/cache.py``.

Mirrors the reference RL trainer's two-level cache
(``pygcn/rl-policy-generator.py:123-147, 290-304, 587-596``): an in-memory
dict keyed by the vaccination-flag tuple, backed by pickle files that are
merged on startup and re-dumped periodically, so a killed run resumes with
prior simulation results. Process-safety here comes from single-writer dumps
with atomic rename (the reference's ``Manager().dict()`` fan-out is replaced
by one batch of policies on the device, so cross-process sharing is
unnecessary). Keys are tuples of Python ints and values tuples of Python
floats, so the shards of either package merge into the other's cache.
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import Dict, Hashable, Optional, Tuple


class SimCache:
    def __init__(self, cache_dir: Optional[str] = None, prefix: str = "sim_cache"):
        self.cache: Dict[Hashable, Tuple[float, float]] = {}
        self.cache_dir = cache_dir
        self.prefix = prefix
        if cache_dir is not None:
            self.merge_from_disk()

    @staticmethod
    def key_for(policy) -> Tuple[int, ...]:
        return tuple(int(i) for i in policy)

    def merge_from_disk(self) -> int:
        """Union all pickle shards in the cache dir (reference :136-147)."""
        if self.cache_dir is None:
            return 0
        n = 0
        for path in sorted(glob.glob(os.path.join(self.cache_dir, f"{self.prefix}*.pkl"))):
            try:
                with open(path, "rb") as f:
                    d = pickle.load(f)
                self.cache.update(d)
                n += len(d)
            except (OSError, pickle.UnpicklingError):
                continue
        return n

    def dump(self, tag: str = "0") -> Optional[str]:
        if self.cache_dir is None:
            return None
        os.makedirs(self.cache_dir, exist_ok=True)
        path = os.path.join(self.cache_dir, f"{self.prefix}_{tag}.pkl")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(self.cache, f)
        os.replace(tmp, path)
        return path

    def get(self, policy):
        return self.cache.get(self.key_for(policy))

    def put(self, policy, value) -> None:
        self.cache[self.key_for(policy)] = tuple(float(v) for v in value)

    def __len__(self) -> int:
        return len(self.cache)

    def evaluate_batch(self, policies, evaluate_fn):
        """Evaluate policies with memoization; ``evaluate_fn(missing_policies)
        -> list of values``. Returns values aligned with ``policies``.

        The reference fans misses out over a process pool (:308-321); here
        misses are batched into one call so the caller can run them as one
        batch on the device.
        """
        missing = [p for p in policies if self.get(p) is None]
        # dedup while preserving order
        seen = set()
        uniq = []
        for p in missing:
            k = self.key_for(p)
            if k not in seen:
                seen.add(k)
                uniq.append(p)
        if uniq:
            for p, v in zip(uniq, evaluate_fn(uniq)):
                self.put(p, v)
        return [self.get(p) for p in policies]
