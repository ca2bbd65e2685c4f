"""Conditional (a1, b1) -> marginal posterior reconstruction.

Reference: ``src/a1b1.c`` ``conditional_to_marginal:378`` and the
per-sample logging ``log_a1b1`` (``src/method.c:4829``).  For each
sample, the full conditional of a population theta given the gene
trees is Gamma/InvGamma(a1, b1) with a1 = a + sum_l coal_lh and
b1 = b + sum_l C2_lh / hered_l (and for a migration rate,
Gamma(a + sum_l mc_lk, b + sum_l W_lk)).  The marginal posterior is
the Rao-Blackwellized mixture of those conditionals, which has far
lower Monte-Carlo error than the raw sample trace.

Outputs the ``<jobname>.conditional_a1b1.txt`` log and the second
summary table (param mean S.D 2.5% 97.5% HPDs Effu Effy c) printed by
the reference after the standard one (allfixed.c:1427, A1B1_BINS=1000,
A1B1_TAIL=0.05).

A host copy of ``bpp_tpu/summary/a1b1.py`` (numpy and scipy's
``gammaln``, as the original).
"""

from __future__ import annotations

import numpy as np
from scipy.special import gammaln

from .allfixed import eff_ict

DIST_GAMMA = 0
DIST_INVGAMMA = 1

A1B1_BINS = 1000
A1B1_TAIL = 0.05


def _posterior_interval(y, cdf, kmode, tail):
    """HPD and equal-tail intervals from a binned cdf
    (a1b1.c:45 posterior_interval)."""
    nbins = len(y)
    lindex, uindex = 0, nbins - 1
    u0 = 1
    best = np.inf
    for l0 in range(min(kmode + 1, nbins - 1)):
        while u0 < nbins and cdf[u0] - cdf[l0] <= 1 - tail:
            u0 += 1
        if u0 == nbins:
            break
        if y[u0] - y[l0] < best:
            best = y[u0] - y[l0]
            lindex, uindex = l0, u0
    hpd = (y[lindex], y[uindex])
    lo = float(np.interp(tail / 2, cdf, y))
    hi = float(np.interp(1 - tail / 2, cdf, y))
    return hpd, (lo, hi)


def conditional_to_marginal(a1, b1, dist=DIST_INVGAMMA,
                            nbins=A1B1_BINS, tail=A1B1_TAIL) -> dict:
    """Marginal stats from per-sample conditional params (a1b1.c:378)."""
    a1 = np.asarray(a1, float)
    b1 = np.asarray(b1, float)
    keep = (a1 >= 0) & (b1 >= 0)
    a1, b1 = a1[keep], b1[keep]
    n = len(a1)
    if n == 0:
        return {k: -1.0 for k in ("mean", "sd", "et025", "et975",
                                  "hpd025", "hpd975", "c", "effu", "effy")}
    if dist == DIST_GAMMA:
        m = a1 / b1
        v = a1 / (b1 * b1)
    else:
        if (a1 <= 2).any():
            raise ValueError("a1 must be > 2 for the inverse-gamma "
                             "conditional")
        m = b1 / (a1 - 1.0)
        v = b1 * b1 / ((a1 - 1.0) ** 2 * (a1 - 2.0))
    ui = m
    mv = v.mean()
    mean = ui.mean()
    sd_u = ui.std(ddof=0)
    c_inf = abs(sd_u) < 1e-10
    T_u, _ = eff_ict(ui)
    vm = sd_u * sd_u
    variance = mv + vm
    sd = np.sqrt(variance)
    c = np.inf if c_inf else variance / vm
    E_u = c / T_u
    E_y = 1.0 / (1.0 + (T_u - 1.0) / c)

    lbin = max(mean - 4 * sd, 0.0)
    ubin = mean + 4 * sd
    width = (ubin - lbin) / nbins
    y = lbin + (np.arange(nbins) + 0.5) * width
    lny = np.log(np.maximum(y, 1e-300))
    if dist == DIST_GAMMA:
        lnconst = a1 * np.log(b1) - gammaln(a1)
        logpdf = lnconst[:, None] + (a1[:, None] - 1) * lny[None, :] \
            - b1[:, None] * y[None, :]
    else:
        lnconst = a1 * np.log(b1) - gammaln(a1)
        logpdf = lnconst[:, None] + (-a1[:, None] - 1) * lny[None, :] \
            - b1[:, None] / np.maximum(y[None, :], 1e-300)
    pdf = np.exp(np.clip(logpdf, -700, 700)).sum(0) * width / n
    kmode = int(np.argmax(pdf))
    cdf = np.cumsum(pdf)
    hpd, et = _posterior_interval(y, cdf, kmode, tail)
    return {"mean": float(mean), "sd": float(sd),
            "et025": et[0], "et975": et[1],
            "hpd025": float(hpd[0]), "hpd975": float(hpd[1]),
            "c": float(c), "effu": float(E_u), "effy": float(E_y)}


class A1b1Writer:
    """Streams per-sample conditional params to
    <jobname>.conditional_a1b1.txt (method.c:4469 header,
    log_a1b1:4829 rows)."""

    def __init__(self, path, labels):
        """labels: list of (name, dist) column groups, e.g.
        ("theta:1:A", DIST_INVGAMMA) or ("W:1->2:A->B", DIST_GAMMA)."""
        self.fp = open(path, "w")
        self.labels = labels
        cols = ["Gen"]
        for name, _ in labels:
            cols.append(f"{name}_a1")
            cols.append(f"{name}_b1")
        self.fp.write("\t".join(cols) + "\n")
        self.rows_a: list = []
        self.rows_b: list = []

    def write_sample(self, gen, a1, b1):
        """a1/b1: arrays aligned with ``labels``."""
        vals = [str(gen)]
        for a, b in zip(a1, b1):
            vals.append(f"{a:.1f}")
            vals.append(f"{b:.5f}")
        self.fp.write("\t".join(vals) + "\n")
        self.rows_a.append(np.asarray(a1, float))
        self.rows_b.append(np.asarray(b1, float))

    def close(self):
        self.fp.close()

    def summary(self) -> str:
        if not self.rows_a:
            return ""
        A = np.stack(self.rows_a)
        B = np.stack(self.rows_b)
        head = (f"{'param':<10} {'mean':>9} {'S.D':>9} {'2.5%':>9} "
                f"{'97.5%':>9} {'2.5%HPD':>9} {'97.5%HPD':>9} "
                f"{'Effu':>9} {'Effy':>9} {'c':>9}")
        lines = [head, "-" * len(head)]
        for j, (name, dist) in enumerate(self.labels):
            s = conditional_to_marginal(A[:, j], B[:, j], dist)
            lines.append(
                f"{name:<10} {s['mean']:>9.6f} {s['sd']:>9.6f} "
                f"{s['et025']:>9.6f} {s['et975']:>9.6f} "
                f"{s['hpd025']:>9.6f} {s['hpd975']:>9.6f} "
                f"{s['effu']:>9.6f} {s['effy']:>9.6f} {s['c']:>9.6f}")
        return "\n".join(lines)
