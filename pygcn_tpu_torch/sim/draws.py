"""Count samplers of the epidemic simulator: binomial and Poisson draws.

The reference draws ``np.random.binomial`` / ``np.random.poisson`` inside the
hour loop (reference ``disease_model.py:296,314,324,334-336``); the JAX
package (``pygcn_tpu/sim/draws.py``) writes its own while-loop-free samplers
because ``jax.random``'s rejection loops serialize on a TPU. Here the exact
draws are PyTorch's own samplers, ``torch.binomial`` and ``torch.poisson``,
with an explicit ``torch.Generator``, under JAX's input rules: ``n`` is
floored (the reference casts to int), ``p`` is clipped to [0, 1], and the
counts come back as float32 in [0, n]. (``torch.binomial`` does not floor:
``binomial(3.9, 1)`` gives 3.9 there.)

:func:`fast_count_draw` is the ``approx_draws`` sampler of
``pygcn_tpu/sim/model.py:254-283``: CDF inversion of a Poisson below mean 4,
a stochastically rounded Gaussian above.
"""

from __future__ import annotations

import torch

_SMALL_MEAN = 4.0
_KMAX = 12


def probability(p, like: torch.Tensor) -> torch.Tensor:
    """``p`` clipped to [0, 1] as a float32 tensor; a number is filled in on
    ``like``'s device (``torch.full_like``, no copy from the host, which
    would wait for the device)."""
    p = p.to(torch.float32) if torch.is_tensor(p) else torch.full_like(like, float(p))
    return p.clamp(0.0, 1.0)


def binomial(n: torch.Tensor, p, generator: torch.Generator) -> torch.Tensor:
    """Binomial(floor(n), clip(p, 0, 1)) counts, float32, exact in distribution."""
    n = torch.floor(n.to(torch.float32))
    n, p = torch.broadcast_tensors(n, probability(p, n))
    out = torch.binomial(n.contiguous(), p.contiguous(), generator=generator)
    return torch.minimum(out.clamp_min(0.0), n)


def poisson(lam: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Poisson(lam) counts, float32, exact in distribution."""
    return torch.poisson(lam.to(torch.float32).contiguous(), generator=generator)


def fast_count_draw(mean: torch.Tensor, var: torch.Tensor, upper, generator: torch.Generator):
    """Cheap count sampler of ``approx_draws`` mode.

    Means up to 4 (where a clipped Gaussian is badly biased and the bias
    compounds through the epidemic's growth) use truncated Poisson CDF
    inversion (k <= 12, residual tail < 1e-4); larger means a stochastically
    rounded Gaussian, clipped to [0, upper]. ``upper`` is a tensor, or None
    for no upper bound. Draws one uniform, then one normal, per element.
    """
    u = torch.rand(mean.shape, generator=generator, device=mean.device)
    lam = mean.clamp(0.0, _SMALL_MEAN)
    pk = torch.exp(-lam)
    cdf = pk
    count = torch.zeros_like(mean)
    for k in range(1, _KMAX + 1):
        count = count + (u > cdf)
        pk = pk * lam / k
        cdf = cdf + pk

    z = torch.randn(mean.shape, generator=generator, device=mean.device)
    y = torch.floor(mean + torch.sqrt(var.clamp_min(0.0)) * z + u)
    large = y.clamp_min(0.0)
    small = count
    if upper is not None:
        large = torch.minimum(large, upper)
        small = torch.minimum(small, upper)
    return torch.where(mean <= _SMALL_MEAN, small, large)
