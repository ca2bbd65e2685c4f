"""Conjugate / approximate-conjugate conditionals for theta-style Gibbs.

Port of ``bpp_tpu/mcmc/gibbs.py`` (``get_gamma_conditional_approx``,
``src/stree.c``): under a Gamma(a, b) prior the full conditional of theta
with k coalescences and waiting sum T, ``p(th) ∝ th^(a-1-k)
exp(-b·th - T/th)``, is moment-matched at its mode by a gamma or an
inverse-gamma; under an InvGamma(a, b) prior it is exactly
InvGamma(a + k, b + T).  The theta move proposes from the inverse-gamma
form; the conditional a1b1 log records the gamma form.
"""

from __future__ import annotations

import torch


def gamma_conditional_approx(a, b, k, T, invgamma_proposal: bool = True):
    """Approximate conditional parameters (a1, b1), vectorized over k/T;
    solved in float64, returned in T's dtype.  With ``invgamma_proposal``
    they parameterize an InvGamma proposal, otherwise a Gamma one."""
    out_dtype = T.dtype
    k = k.to(torch.float64)
    T = T.to(torch.float64)
    a1k = a - 1.0 - k
    Ts = torch.clamp(T, min=1e-300)
    m = (a1k + torch.sqrt(a1k * a1k + 4.0 * b * Ts)) / (2.0 * b)
    m = torch.clamp(m, min=1e-300)
    ddl = -(a1k + 2.0 * Ts / m) / (m * m)
    v = -1.0 / ddl
    mmv = m * m / v

    if not invgamma_proposal:
        a1 = 1.0 + mmv / 2.0 + torch.sqrt(mmv + mmv * mmv / 4.0)
        b1 = (a1 - 1.0) / m
        a1 = torch.where(T <= 0.0, torch.full_like(a1, a), a1)
        b1 = torch.where(T <= 0.0, torch.full_like(b1, b), b1)
        return a1.to(out_dtype), b1.to(out_dtype)

    # inverse-gamma proposal: a1 is the root of
    #   x^3 - (4+mmv) x^2 + (5-2mmv) x - (2+mmv) = 0  in [x0, x1]
    c1 = -(4.0 + mmv)
    c2 = 5.0 - 2.0 * mmv
    c3 = -(2.0 + mmv)

    def f(x):
        return ((x + c1) * x + c2) * x + c3

    x0 = (mmv + 2.0) / 2.0
    x1 = (mmv + 2.0) * 2.0
    f0 = f(x0)
    for _ in range(80):
        xm = 0.5 * (x0 + x1)
        fm = f(xm)
        same = f0 * fm > 0
        x0, x1, f0 = (torch.where(same, xm, x0), torch.where(same, x1, xm),
                      torch.where(same, fm, f0))
    a1 = 0.5 * (x0 + x1)
    b1 = m * (a1 + 1.0)
    a1 = torch.where(T <= 0.0, torch.full_like(a1, a + 2.0), a1)
    b1 = torch.where(T <= 0.0, torch.full_like(b1, a * (a + 1.0) / b), b1)
    return a1.to(out_dtype), b1.to(out_dtype)
