"""Marginal-likelihood (Bayes factor) driver: the ``--bfdriver`` tool.

Copied from ``bpp_tpu/tools/bfdriver.py`` (host code).  Reference
behaviour (src/bfdriver.c:1161 cmd_bfdriver): given a control file and a
number K of Gauss-Legendre quadrature points, write K copies of the
control file, each with a ``BayesFactorBeta = beta_k`` line appended, and
``<ctl>.betaweights.csv`` with the (beta, weight) pairs.  A power-posterior
run under beta scales the log-likelihood by beta (src/locus.c:2630
``opt_bfbeta * logl``; here ``mcmc.state.make_logl_fn``), and the marginal
likelihood is estimated as log M = 0.5 * sum_k w_k * E_k[log f(X)], where
E_k is the posterior mean of the unscaled log-likelihood under beta_k.

The nodes and weights come from numpy's Gauss-Legendre quadrature rather
than the reference's tables (bfdriver.c:46-949): they agree to double
precision, for any even K.
"""

from __future__ import annotations

import sys

import numpy as np


def beta_weights(points: int) -> list[tuple[float, float]]:
    """(beta, weight) pairs in the reference's order (bfdriver.c:1192-1208):
    betas ascending from ~0 to ~1, each pair symmetric about 0.5."""
    if points < 2 or points % 2:
        raise ValueError("number of quadrature points must be even >= 2")
    x, w = np.polynomial.legendre.leggauss(points)
    xpos, wpos = x[points // 2:], w[points // 2:]    # positive nodes, asc
    out = []
    for i in range(points):
        if i < points // 2:
            ixw, sign = points // 2 - 1 - i, -1.0
        else:
            ixw, sign = i - points // 2, 1.0
        out.append((0.5 + sign / 2.0 * xpos[ixw], wpos[ixw]))
    return out


def cmd_bfdriver(ctlfile: str, points: int = 8, out=None) -> int:
    """Write ``<ctlfile>.1`` .. ``<ctlfile>.K`` and
    ``<ctlfile>.betaweights.csv``; the table goes to ``out`` (standard
    output at the call)."""
    out = out or sys.stdout
    with open(ctlfile) as fh:
        cfdata = fh.read()
    pairs = beta_weights(points)
    print("quadrature: log{M} = 0.5 * SUM w_b * E_b(log{f(X)})\n", file=out)
    with open(f"{ctlfile}.betaweights.csv", "w") as fp_beta:
        fp_beta.write("beta,weight,ElnfX\n")
        for i, (beta, weight) in enumerate(pairs):
            print(f"b{i+1:02d}: beta = {beta:.4f}  w = {weight:8.6f}",
                  file=out)
            fp_beta.write(f"{beta:.6f},{weight:.6f},\n")
            with open(f"{ctlfile}.{i+1}", "w") as fp_ctl:
                fp_ctl.write(cfdata)
                fp_ctl.write(f"\nBayesFactorBeta = {beta:f}   # w={weight:f}\n")
    return 0


def estimate_logml(csv_path: str) -> float:
    """The log marginal likelihood from a filled-in betaweights.csv (the
    ElnfX column: each power-posterior run's posterior mean of the
    unscaled lnL)."""
    rows = np.genfromtxt(csv_path, delimiter=",", names=True)
    if np.any(np.isnan(rows["ElnfX"])):
        raise ValueError("ElnfX column incomplete in " + csv_path)
    return float(0.5 * np.sum(rows["weight"] * rows["ElnfX"]))
