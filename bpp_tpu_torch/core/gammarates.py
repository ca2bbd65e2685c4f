"""Discrete-gamma among-site rate variation (PyTorch).

Port of ``bpp_tpu/core/gammarates.py``: K categories of a mean-1
Gamma(alpha, alpha), cut at the k/K quantiles, each represented by its
conditional mean (``src/gamma.c:221``).  The quantile is a
Wilson-Hilferty start refined by 40 damped Newton steps on the
regularized incomplete gamma.
"""

from __future__ import annotations

import math

import torch


def _gamma_quantile(p, a):
    """Quantile of Gamma(a, 1) via Wilson-Hilferty + Newton on gammainc."""
    z = math.sqrt(2.0) * torch.special.erfinv(2.0 * p - 1.0)
    g = 2.0 / (9.0 * (2.0 * a))
    x = (2.0 * a) * (1.0 - g + z * torch.sqrt(g)) ** 3 / 2.0
    x = torch.clamp(x, min=1e-10)
    lgam = torch.lgamma(a)
    # the smallest density Newton divides by: 1e-300 as bpp_tpu has it in
    # float64, and the smallest normal number where that is 0 (float32)
    floor = max(1e-300, torch.finfo(x.dtype).tiny)
    for _ in range(40):
        f = torch.special.gammainc(a, x) - p
        dfdx = torch.exp((a - 1.0) * torch.log(x) - x - lgam)
        step = f / torch.clamp(dfdx, min=floor)
        step = torch.minimum(torch.maximum(step, -0.9 * x), 10.0 * x)
        x = torch.clamp(x - step, min=1e-12)
    return x


def discrete_gamma_rates(alpha, n_cats: int):
    """Category rates (mean 1) for Gamma(alpha, alpha): ``[..., n_cats]``.

    ``alpha`` is a tensor of any shape; all categories weigh 1/K."""
    alpha = torch.as_tensor(alpha)
    if n_cats == 1:
        return torch.ones(alpha.shape + (1,), dtype=alpha.dtype,
                          device=alpha.device)
    a = alpha[..., None]
    k = torch.arange(1, n_cats, dtype=alpha.dtype, device=alpha.device)
    cuts = _gamma_quantile(k / n_cats, a) / a
    inc = torch.special.gammainc(a + 1.0, cuts * a)
    zero = torch.zeros_like(inc[..., :1])
    inc = torch.cat([zero, inc, torch.ones_like(zero)], dim=-1)
    return (inc[..., 1:] - inc[..., :-1]) * n_cats
