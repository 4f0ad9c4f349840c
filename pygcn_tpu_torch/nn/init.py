"""Parameter initializers with the reference's PyTorch bounds.

``GraphConvolution.reset_parameters`` (reference ``pygcn/layers.py:23-29``)
runs ``kaiming_uniform_`` on a weight stored **(in_features, out_features)**;
torch reads the fan from ``size(1)``, so the effective bound is
``sqrt(6 / out_features)``. The bias is uniform ±1/√out_features. The dense
layers take ``torch.nn.Linear``'s default, ±1/√in_features for weight and
bias (:func:`linear_weight`, :func:`linear_bias`). Draws come
from a ``torch.Generator``, so they differ from the JAX package's; tests that
need equal weights carry them across with ``pygcn_tpu_torch.convert``.
"""

from __future__ import annotations

import math

import torch


def uniform(shape, bound: float, generator: torch.Generator,
            dtype=torch.float32) -> torch.Tensor:
    """Uniform on ``[-bound, bound)``, drawn on the CPU from ``generator``."""
    u = torch.rand(shape, generator=generator, dtype=dtype)
    return (2.0 * u - 1.0) * bound


def graphconv_weight(in_features: int, out_features: int,
                     generator: torch.Generator) -> torch.Tensor:
    return uniform((in_features, out_features), math.sqrt(6.0 / out_features), generator)


def graphconv_bias(out_features: int, generator: torch.Generator) -> torch.Tensor:
    return uniform((out_features,), 1.0 / math.sqrt(out_features), generator)


def linear_weight(in_features: int, out_features: int,
                  generator: torch.Generator) -> torch.Tensor:
    """``torch.nn.Linear``'s default bound, 1/√in_features, on a weight
    stored ``[in, out]`` for ``x @ W`` (the bound depends on
    ``in_features`` only, so the layout changes no distribution)."""
    return uniform((in_features, out_features), 1.0 / math.sqrt(in_features), generator)


def linear_bias(in_features: int, out_features: int,
                generator: torch.Generator) -> torch.Tensor:
    return uniform((out_features,), 1.0 / math.sqrt(in_features), generator)
