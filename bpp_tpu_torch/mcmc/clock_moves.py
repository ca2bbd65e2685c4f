"""Hierarchical locus-rate moves under the strict clock (PyTorch).

Port of the ``Clock.GLOBAL`` part of ``bpp_tpu/mcmc/clock_moves.py``
(reference src/stree.c:9225 ``prop_locusrate_mui``, :9770
``prop_locusrate_mubar``): the mu_i log-slide under the Gamma-Dirichlet
or the hierarchical prior, the mubar move, and the starting
``ClockState``.  The relaxed clocks' moves (nu_i, nubar, branch rates)
and the tip-dating mubar move are not ported yet.

All proposals are log-scale Bactrian slides reflected into [-99, 99]
like the reference.  The Gamma-Dirichlet prior couples the loci through
the running sum of rates, so its accept chain is serial: the batched
per-locus likelihood deltas are exact (the likelihood factorizes per
locus), six ``[L]`` vectors go to the host in one copy, a numpy loop
takes the decisions in locus order, and the accept mask comes back in
one copy.  That is the one host synchronisation per iteration of a
chain with this prior; the hierarchical prior is fully batched.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import BppConfig
from . import rng
from .state import (
    FT_MUBAR, FT_MUI, ClockState, Ctx, McmcState, make_logl_fn,
)

LOG_BOUND = 99.0


def init_clock_state(cfg: BppConfig, n_species_nodes: int, mu: np.ndarray,
                     rng_np: np.random.Generator, dtype, device
                     ) -> ClockState:
    """Starting rate hierarchy (method.c:4212-4253) for a strict clock
    with estimated locus rates; draws from ``rng_np`` what ``bpp_tpu``
    draws, in its order."""
    L, H = len(mu), n_species_nodes
    nubar = (cfg.clock_vbar_a / cfg.clock_vbar_b
             if cfg.clock_vbar_b > 0 else 1.0)
    mubar = (cfg.locusrate_mubar_a / cfg.locusrate_mubar_b
             if cfg.locusrate_mubar_b > 0 else cfg.locusrate_mubar)
    nu = nubar * (0.9 + 0.2 * rng_np.random(L))
    brate = mu[:, None] * (0.9 + 0.2 * rng_np.random((L, H)))

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    # no branch-rate prior under the strict clock
    return ClockState(brate=t(brate), nu=t(nu), mubar=t(mubar),
                      nubar=t(nubar), lnrates=t(np.zeros(L)))


def _logslide(gen, x, eps):
    """log-scale Bactrian slide reflected into [-99, 99] (stree.c:9290):
    (new value, log of the proposal ratio)."""
    lx = torch.log(x)
    lnew = rng.reflect(
        lx + eps * rng.bactrian(gen, x.shape, x.dtype, x.device),
        -LOG_BOUND, LOG_BOUND)
    return torch.exp(lnew), lnew - lx


def _gammadir_chain(terms: np.ndarray, mask: np.ndarray, a_mubar: float,
                    terma: float, termb: float, a_mui: float) -> np.ndarray:
    """Serial Gamma-Dirichlet accept chain with the running sum of rates
    (stree.c:9299-9303).  ``terms`` rows: mu, mu_new, log proposal ratio,
    likelihood delta, uniform draw."""
    mo, mn, dlog, dlogl, u = terms
    accept = np.zeros(len(mo), bool)
    sum_mu = float(mo[mask].sum())
    with np.errstate(all="ignore"):
        logu = np.log(u)
        lratio = (a_mui - 1.0) * np.log(mn / mo) + dlog + dlogl
        for i in np.flatnonzero(mask):
            sum_new = sum_mu + mn[i] - mo[i]
            lnacc = ((a_mubar - terma) * np.log(sum_new / sum_mu)
                     - termb * (sum_new - sum_mu) + lratio[i])
            if logu[i] < lnacc:
                accept[i] = True
                sum_mu = sum_new
    return accept


def mui_move(ctx: Ctx, cfg: BppConfig, state: McmcState, gen):
    """Locus-rate mu_i under the Gamma-Dirichlet (prior 0) or the
    hierarchical conditional-iid (prior 1) prior.  The clock is global,
    so mu changes the likelihood."""
    L = state.gt.n_loci
    eps = state.finetune[FT_MUI]
    mu = state.subst.mu
    mu_new, dlog = _logslide(gen, mu, eps)
    mu_new = torch.where(ctx.locus_mask, mu_new, mu)

    subst_new = state.subst._replace(mu=mu_new)
    logl_new = make_logl_fn(ctx, cfg)(state.gt, subst_new, state.sp,
                                      state.clock)
    dlogl = logl_new - state.logl

    a_mui = cfg.locusrate_alpha
    us = rng.uniform(gen, (L,), mu.dtype, mu.device)
    if cfg.locusrate_prior == 1:
        # iid Gamma(a_mui, a_mui / mubar): no cross-locus coupling
        beta = a_mui / state.clock.mubar
        lnacc = (dlog + (a_mui - 1.0) * torch.log(mu_new / mu)
                 - beta * (mu_new - mu) + dlogl)
        accept = (torch.log(us) < lnacc) & ctx.locus_mask
    else:
        terms = torch.stack([mu, mu_new, dlog, dlogl, us]).double()
        host = torch.cat([terms, ctx.locus_mask[None].double()]).cpu().numpy()
        mask = host[5] > 0.5
        nl = float(mask.sum())
        accept = torch.as_tensor(_gammadir_chain(
            host[:5], mask, cfg.locusrate_mubar_a, a_mui * nl,
            cfg.locusrate_mubar_b / nl, a_mui)).to(mu.device)

    new = state._replace(
        subst=state.subst._replace(mu=torch.where(accept, mu_new, mu)),
        logl=torch.where(accept, logl_new, state.logl))
    return new, (ctx.locus_mask.sum(), accept.sum())


def mubar_move(ctx: Ctx, cfg: BppConfig, state: McmcState, gen):
    eps = state.finetune[FT_MUBAR]
    old = state.clock.mubar
    new, dlog = _logslide(gen, old, eps)
    a, b = cfg.locusrate_mubar_a, cfg.locusrate_mubar_b
    am = cfg.locusrate_alpha
    bnew, bold = am / new, am / old
    mu = state.subst.mu
    summu = torch.sum(torch.where(ctx.locus_mask, mu, torch.zeros_like(mu)))
    nl = ctx.locus_mask.sum()
    lnacc = (dlog + (a - 1.0) * torch.log(new / old) - b * (new - old)
             + nl * am * torch.log(bnew / bold) - (bnew - bold) * summu)
    accept = rng.mh_accept(gen, lnacc)
    mubar = torch.where(accept, new, old)
    return (state._replace(clock=state.clock._replace(mubar=mubar)),
            (1, accept.to(torch.int64)))
