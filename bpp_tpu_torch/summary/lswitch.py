"""Copied from ``bpp_tpu/summary/lswitch.py`` (numpy and scipy, unchanged)
so that the PyTorch port never loads that package.

Label-switching correction for bidirectional introgression
(reference src/lswitch.c).

A BDI pair (X, Y) is unidentifiable up to the simultaneous relabeling

    (phi_X, phi_Y, theta_X, theta_Y) -> (1-phi_X, 1-phi_Y, theta_Y, theta_X)

(the "tower switch", lswitch.c:82).  The posterior sample is
post-processed by assigning each sample a tower indicator and
iteratively flipping samples to the mode that maximizes a
classification score until no sample moves (lswitch.c:336 ``lswitch``):

* ``CoG0``  — Euclidean distance to the running mean (lswitch.c:213)
* ``CoGN``  — variance-normalized distance (lswitch.c:219)
* ``BG``    — the default: fit Beta(p,q) to each phi and Gamma(a,b) to
  each theta by maximum likelihood (the reference uses PAML's ming2
  BFGS, ming2.c:307; here scipy L-BFGS-B with the same [0.5, 99999]
  bounds) and flip by the log-density ratio (lswitch.c:43
  ``lnlike_msci``).
"""

from __future__ import annotations

import numpy as np
from scipy.special import gammaln
from scipy.optimize import minimize

ALG_COG0, ALG_COGN, ALG_BG = 0, 1, 2
_EPS = 1e-9


def _switched(p):
    """Apply the tower switch to a [n, 4] parameter block."""
    q = p.copy()
    q[:, 0] = 1 - p[:, 0]
    q[:, 1] = 1 - p[:, 1]
    q[:, 2], q[:, 3] = p[:, 3].copy(), p[:, 2].copy()
    return q


def _neg_loglik(x, stats, est_theta):
    (slnphi, sln1mphi, stheta, slntheta) = stats
    lnp = 0.0
    for j in range(2):
        p, q = x[2 * j], x[2 * j + 1]
        lnp += (gammaln(p + q) - gammaln(p) - gammaln(q)
                + (p - 1) * slnphi[j] + (q - 1) * sln1mphi[j])
    if est_theta:
        for j in range(2):
            a, b = x[4 + 2 * j], x[5 + 2 * j]
            lnp += (a * np.log(b) - gammaln(a)
                    + (a - 1) * slntheta[j] - b * stheta[j])
    return -lnp


def _fit_beta_moments(m, v):
    z = m * (1 - m) / max(v, 1e-12) - 1
    if z <= 0:
        z = 0.01
    return m * z, (1 - m) * z


def _fit_gamma_moments(m, v):
    v = max(v, 1e-12)
    return m * m / v, m / v


def lswitch_bdi(phi_x, phi_y, theta_x=None, theta_y=None,
                algorithm=ALG_BG, rounds=100, log=None):
    """Resolve one BDI pair's label switching.

    Returns (tower [n] bool, phi_x', phi_y', theta_x', theta_y') with
    flipped samples relabeled (update_matrix lswitch.c:289).
    """
    n = len(phi_x)
    est_theta = theta_x is not None
    p = np.zeros((n, 4))
    p[:, 0] = np.clip(phi_x, _EPS, 1 - _EPS)
    p[:, 1] = np.clip(phi_y, _EPS, 1 - _EPS)
    p[:, 2] = theta_x if est_theta else -1
    p[:, 3] = theta_y if est_theta else -1

    # init_tower (lswitch.c:246)
    tower = ~((p[:, 0] < 0.5) | (p[:, 1] < 0.5))

    def current(tower):
        cur = p.copy()
        cur[tower] = _switched(p[tower])
        return cur

    def summarize(cur):
        mean = cur.mean(0)
        var = cur.var(0, ddof=1) if n > 1 else np.ones(4)
        stats = (np.log(cur[:, :2]).mean(0),
                 np.log(1 - cur[:, :2]).mean(0),
                 cur[:, 2:].mean(0) if est_theta else np.zeros(2),
                 np.log(np.maximum(cur[:, 2:], 1e-300)).mean(0)
                 if est_theta else np.zeros(2))
        return mean, var, stats

    def fit_hyper(mean, var, stats):
        nh = 8 if est_theta else 4
        x0 = np.zeros(nh)
        x0[0:2] = _fit_beta_moments(mean[0], var[0])
        x0[2:4] = _fit_beta_moments(mean[1], var[1])
        if est_theta:
            x0[4:6] = _fit_gamma_moments(mean[2], var[2])
            x0[6:8] = _fit_gamma_moments(mean[3], var[3])
        x0 = np.clip(x0, 0.5, 99999.0)
        res = minimize(_neg_loglik, x0, args=(stats, est_theta),
                       method="L-BFGS-B",
                       bounds=[(0.5, 99999.0)] * nh)
        return res.x if res.success else x0

    def score_diff(pnew, pcur, mean, var, hyper):
        # positive => flipping improves (compare_towers lswitch.c:195)
        if algorithm == ALG_COG0:
            d = (pcur - pnew) * (pcur + pnew - 2 * mean)
            return d[:, : (4 if est_theta else 2)].sum(1)
        if algorithm == ALG_COGN:
            d = (pcur - pnew) * (pcur + pnew - 2 * mean) / (2 * var)
            return d[:, : (4 if est_theta else 2)].sum(1)
        s = np.zeros(n)
        for j in range(2):
            pp, qq = hyper[2 * j], hyper[2 * j + 1]
            s += ((pp - 1) * np.log(pnew[:, j] / pcur[:, j])
                  + (qq - 1) * np.log((1 - pnew[:, j]) / (1 - pcur[:, j])))
        if est_theta:
            for j in range(2):
                a, b = hyper[4 + 2 * j], hyper[5 + 2 * j]
                s += ((a - 1) * np.log(pnew[:, 2 + j] / pcur[:, 2 + j])
                      - b * (pnew[:, 2 + j] - pcur[:, 2 + j]))
        return s

    hyper = None
    for rnd in range(rounds):
        cur = current(tower)
        mean, var, stats = summarize(cur)
        if algorithm == ALG_BG:
            hyper = fit_hyper(mean, var, stats)
        flipped = _switched(cur)
        s = score_diff(flipped, cur, mean, var, hyper)
        moves = s > 0
        if log is not None:
            log(f"Round {rnd:2d}, {int(moves.sum()):2d} points moved...")
        if not moves.any():
            break
        tower = tower ^ moves

    cur = current(tower)
    out = (tower, cur[:, 0], cur[:, 1])
    if est_theta:
        return out + (cur[:, 2], cur[:, 3])
    return out + (None, None)


def bdi_pairs_of(st) -> list[tuple[int, int]]:
    """(X, Y) BDI hinner pairs of a host SpeciesTree, tau-owner first."""
    if getattr(st, "bdi", None) is None:
        return []
    return [(i, int(st.bdi[i])) for i in range(st.n_nodes)
            if st.bdi[i] >= 0 and i < st.bdi[i]]


def lswitch_samples(st, theta, phi, est_theta=True, log=None):
    """Apply the correction in place for every BDI pair of ``st``.

    ``theta`` [n, H] and ``phi`` [n, H] sample matrices (node-indexed);
    returns the number of samples reflected per pair (lswitch.c:496).
    """
    reflected = []
    for x, y in bdi_pairs_of(st):
        mir_x = int(st.hybrid[x])
        mir_y = int(st.hybrid[y])
        if log is not None:
            lx = st.labels[x] if st.labels else str(x)
            ly = st.labels[y] if st.labels else str(y)
            log(f"Resolving potential unidentifiability for BDI "
                f"{lx} <-> {ly}")
        tower, px, py, tx, ty = lswitch_bdi(
            phi[:, mir_x], phi[:, mir_y],
            theta[:, x] if est_theta else None,
            theta[:, y] if est_theta else None, log=log)
        phi[:, mir_x] = px
        phi[:, x] = 1 - px
        phi[:, mir_y] = py
        phi[:, y] = 1 - py
        if est_theta:
            theta[:, x] = tx
            theta[:, y] = ty
        reflected.append(int(tower.sum()))
    return reflected
