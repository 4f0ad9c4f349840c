"""Attribute-bag configuration with path-style keys.

The port's copy of ``pygcn_tpu/utils/config.py`` (pure Python), the
capability surface of the reference's ``Config`` (``pygcn/config.py:5-101``):
attribute access with model-shape defaults, ``"a/b"`` path get/set through
nested configs, flat ``state_dict``, ``merge``, ``copy``.
"""

from __future__ import annotations

import copy as _copy


class Config:
    # Defaults mirror reference pygcn/config.py:9-18.
    _DEFAULTS = dict(
        gcn_nfeat=8,
        gcn_nhid=8,
        gcn_nclass=8,
        gcn_dropout=True,
        linear_nin=100,
        linear_nhid1=64,
        linear_nhid2=8,
        linear_nout=1,
        linear_activation="relu",
        linear_bias=True,
    )

    def __init__(self, **kwargs):
        for k, v in self._DEFAULTS.items():
            setattr(self, k, v)
        for k, v in kwargs.items():
            setattr(self, k, v)

    # -- path-style access ------------------------------------------------ #

    def __setitem__(self, key, val):
        head, _, rest = key.partition("/")
        if rest:
            getattr(self, head)[rest] = val
        else:
            setattr(self, head, val)

    def __getitem__(self, key):
        head, _, rest = key.partition("/")
        if rest:
            return getattr(self, head)[rest]
        return getattr(self, head)

    def get(self, key, default=None):
        return self.__dict__.get(key, default)

    # -- introspection ---------------------------------------------------- #

    @property
    def state_dict(self):
        flat = {}
        for k, v in self.__dict__.items():
            if isinstance(v, Config):
                for kk, vv in v.state_dict.items():
                    flat[f"{k}/{kk}"] = vv
            else:
                flat[k] = v
        return flat

    def has_list(self) -> bool:
        """True if any flat config value is a list (sweep detection,
        reference ``pygcn/config.py:76-80``)."""
        return any(isinstance(v, list) for v in self.state_dict.values())

    def to_string(self, prefix: str = "") -> str:
        out = []
        for k, v in self.__dict__.items():
            if isinstance(v, Config):
                out.append(f"{prefix}{k}:")
                out.append(v.to_string(prefix=prefix + "\t"))
            else:
                out.append(f"{prefix}{k}: {v}")
        return "\n".join(out)

    def keys(self):
        return self.__dict__.keys()

    def values(self):
        return self.__dict__.values()

    def items(self):
        return self.__dict__.items()

    def __str__(self):
        return "\n".join(f"{k}: {v}" for k, v in self.state_dict.items())

    # -- combination ------------------------------------------------------ #

    def merge(self, other: "Config"):
        for k, v in other.__dict__.items():
            self.__dict__[k] = v

    def copy(self) -> "Config":
        out = self.__class__()
        for k, v in self.__dict__.items():
            out.__dict__[k] = _copy.deepcopy(v) if isinstance(v, (Config, list, dict)) else v
        return out
