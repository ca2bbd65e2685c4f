"""Locus-rate, relaxed-clock and tip-dating moves (PyTorch).

Port of ``bpp_tpu/mcmc/clock_moves.py`` (reference
src/stree.c:9052-10468): the branch-rate prior
``lnprior_rates`` (clocks 2 IID, 3 CORR, 4 SIMPLE; gamma or lognormal
rates; on an MSC-I network only the populations of
``SpeciesArrays.rate_nodes`` carry a rate), the starting ``ClockState``,
the mu_i move under the Gamma-Dirichlet or the hierarchical prior and
its mubar move, the nu_i and nubar moves, the branch-rate sweeps and the
tip-dating mutation-rate move.  Under MSC-M migration the rate moves'
likelihood passes take the state's events (``mig=state.mig``), whose
sub-edges split the branch lengths.

All proposals are log-scale Bactrian slides reflected into [-99, 99]
like the reference.  The Gamma-Dirichlet priors couple the loci through
the running sum of rates (mu_i) or variances (nu_i), so their accept
chains are serial: the batched per-locus deltas are exact (likelihood
and rate prior factorize per locus), and :func:`gammadir_accept` takes
the decisions in locus order where the deltas lie: on the card kernel K4
(``csrc/chain_kernel.cu``, ``bpp_tpu``'s ``lax.scan``, several loci a
round by lookahead; no host read), on
the CPU its plain version in numpy (under locus sharding every rank runs
the chain over the gathered vectors of all loci and keeps its rows).
The hierarchical priors are fully batched.

``1e-300`` floors in ``tipdate_mubar_move`` are
``max(1e-300, finfo(dtype).tiny)``: the same value in float64, and not 0
in float32, where 1e-300 would be (ROADMAP Queue 3).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import BppConfig, Clock
from ..core import chains
from ..core import felsenstein as fe
from ..core.pack import chain_pass
from ..parallel.mesh import gather_loci, pany, psum, psum_counts
from ..trees.coalescent import locus_sum
from ..trees.gtree import assign_populations, topo_scan
from . import notheta, rng
from .rng import tiny_floor
from .state import (
    FT_BRATE, FT_MUBAR, FT_MUI, FT_NUBAR, FT_NUI, ClockState, Ctx,
    McmcState, make_logl_fn, make_logpr_fn, relaxed_segments, tree_where,
)

LOG_BOUND = 99.0


# --------------------------------------------------------------------------
# branch-rate prior density (lnprior_rates, stree.c:8880-9050)
# --------------------------------------------------------------------------


def lnprior_rates(cfg: BppConfig, sp, mu, clock: ClockState):
    """Per-locus branch-rate log prior ``[L]`` (``[1]`` under SIMPLE).

    clock=2 IID: every species node (root included) carries an iid rate
    r ~ Gamma(mu^2/nu, mu/nu) or LogNormal(log mu - nu/2, nu).
    clock=3 CORR: brate[root] == mu; Gamma: each inner node's two
    children rates ~ Gamma(m^2/nu, m/nu) given the node's rate m;
    LogNormal: the bivariate geometric-Brownian form with branch
    midpoints (stree.c:8929-8960).
    clock=4 SIMPLE: one iid Gamma(a, a) rate per branch."""
    H = sp.n_nodes
    r = clock.brate
    if cfg.clock == Clock.GLOBAL:
        return torch.zeros((r.shape[0],), dtype=r.dtype, device=r.device)
    # MSC-I networks: zero-length hybridization segments and BDI mirrors
    # carry no rate (prop_branch_rates skips them, stree.c:10293)
    rmask = sp.rate_nodes

    def total(per):
        if rmask is None:
            return per.sum(1)
        return torch.where(rmask[None, :], per, torch.zeros_like(per)).sum(1)

    if cfg.clock == Clock.SIMPLE:
        a = cfg.clock_alpha
        per = (a * math.log(a) - math.lgamma(a) + (a - 1.0) * torch.log(r)
               - a * r)
        return total(per)
    nu = clock.nu[:, None]
    m = mu[:, None]
    if cfg.clock == Clock.IID:
        if cfg.clock_rate_prior == 1:                 # gamma
            alpha = m * m / nu
            beta = m / nu
            per = -beta * r + (alpha - 1.0) * torch.log(r)
            const = alpha * torch.log(beta) - torch.lgamma(alpha)
            return total(per + const)
        z = torch.log(r) - torch.log(m) + nu / 2.0    # lognormal
        per = -(z * z) / (2.0 * nu) - torch.log(r)
        n_rate = H if rmask is None else rmask.sum()
        return total(per) - 0.5 * torch.log(2.0 * math.pi * clock.nu) \
            * n_rate
    if cfg.clock == Clock.CORRELATED:
        NS = sp.n_tips
        inner = torch.arange(NS, H, device=r.device)
        lc, rc = sp.left[inner], sp.right[inner]
        mm = r[:, inner]                              # parent rates [L, NI]
        r1, r2 = r[:, lc], r[:, rc]
        if cfg.clock_rate_prior == 1:                 # gamma (stree.c:8904)
            alpha = mm * mm / nu
            beta = alpha / mm
            per = (-2.0 * torch.lgamma(alpha) + 2.0 * alpha * torch.log(beta)
                   - beta * (r1 + r2) + (alpha - 1.0) * torch.log(r1 * r2))
            return per.sum(1)
        # lognormal geometric Brownian motion (stree.c:8929)
        par = sp.parent[inner]
        tau = sp.tau
        tA = torch.where(par >= 0, (tau[par.clamp(min=0)] - tau[inner]) / 2.0,
                         torch.zeros_like(tau[inner]))
        t1 = (tau[inner] - tau[lc]) / 2.0
        t2 = (tau[inner] - tau[rc]) / 2.0
        detT = t1 * t2 + tA * (t1 + t2)
        Ti00 = (tA + t2) / detT
        Ti01 = -tA / detT
        Ti11 = (tA + t1) / detT
        rA = torch.where(par >= 0, mm, m)
        y1 = torch.log(r1 / rA) + (tA + t1) * nu / 2.0
        y2 = torch.log(r2 / rA) + (tA + t2) * nu / 2.0
        zz = y1 * y1 * Ti00 + 2.0 * y1 * y2 * Ti01 + y2 * y2 * Ti11
        per = -(zz / (2.0 * nu) + torch.log(detT * nu * nu) / 2.0
                + torch.log(r1 * r2))
        n_inner = H - NS
        return per.sum(1) - 0.5 * math.log(2.0 * math.pi) * n_inner * 2
    raise ValueError(cfg.clock)


def init_clock_state(cfg: BppConfig, sp, mu: np.ndarray,
                     rng_np: np.random.Generator) -> ClockState:
    """Starting rates jittered around the hierarchical means
    (method.c:4212-4253); draws from ``rng_np`` what ``bpp_tpu`` draws, in
    its order.  ``sp`` gives the device, the dtype and, for the
    correlated clock and its prior, the species tree."""
    L, H = len(mu), sp.n_nodes
    if cfg.clock == Clock.SIMPLE:
        brate = np.ones((1, H)) * (0.9 + 0.2 * rng_np.random((1, H)))
        nu = np.ones(L)
        mubar = nubar = 1.0
    else:
        nubar = (cfg.clock_vbar_a / cfg.clock_vbar_b
                 if cfg.clock_vbar_b > 0 else 1.0)
        mubar = (cfg.locusrate_mubar_a / cfg.locusrate_mubar_b
                 if cfg.locusrate_mubar_b > 0 else cfg.locusrate_mubar)
        nu = nubar * (0.9 + 0.2 * rng_np.random(L))
        brate = mu[:, None] * (0.9 + 0.2 * rng_np.random((L, H)))
        if cfg.clock == Clock.CORRELATED:
            brate[:, sp.root] = mu

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=sp.tau.dtype,
                               device=sp.tau.device)

    cl = ClockState(brate=t(brate), nu=t(nu), mubar=t(mubar), nubar=t(nubar),
                    lnrates=t(np.zeros(brate.shape[0])))
    return cl._replace(lnrates=lnprior_rates(cfg, sp, t(mu), cl))


def _logslide(gen, x, eps, shard=None):
    """log-scale Bactrian slide reflected into [-99, 99] (stree.c:9290):
    (new value, log of the proposal ratio); ``shard`` when ``x`` is per
    locus."""
    lx = torch.log(x)
    lnew = rng.reflect(
        lx + eps * rng.bactrian(gen, x.shape, x.dtype, x.device, shard),
        -LOG_BOUND, LOG_BOUND)
    return torch.exp(lnew), lnew - lx


def _gammadir_chain(terms: np.ndarray, mask: np.ndarray, a_bar: float,
                    terma: float, termb: float, a_i: float,
                    margin=None) -> np.ndarray:
    """Serial Gamma-Dirichlet accept chain with the running sum of the
    per-locus values (stree.c:9299-9303), in float64 numpy: the plain
    version of kernel K4.  ``terms`` rows: old value, new value, log
    proposal ratio, locus-factorizing density delta, uniform draw.
    ``margin`` (an array [L]), when given, receives |log u - ln
    acceptance| at each proposing locus (inf elsewhere)."""
    mo, mn, dlog, dlogl, u = terms
    accept = np.zeros(len(mo), bool)
    sum_mu = float(mo[mask].sum())
    with np.errstate(all="ignore"):
        logu = np.log(u)
        lratio = (a_i - 1.0) * np.log(mn / mo) + dlog + dlogl
        for i in np.flatnonzero(mask):
            sum_new = sum_mu + mn[i] - mo[i]
            lnacc = ((a_bar - terma) * np.log(sum_new / sum_mu)
                     - termb * (sum_new - sum_mu) + lratio[i])
            if margin is not None:
                margin[i] = abs(logu[i] - lnacc)
            if logu[i] < lnacc:
                accept[i] = True
                sum_mu = sum_new
    return accept


def gammadir_accept(ctx: Ctx, old, new, dlog, ddens, us, a_bar, b_bar, a_i,
                    margin=None):
    """The Gamma-Dirichlet accept chain of the mu_i / nu_i moves
    (``bpp_tpu``'s ``lax.scan`` over loci): accept [L] bool on the
    device of its inputs, through :func:`gammadir_chain` (``margin`` as
    there).  Under locus sharding the chain runs over every rank's loci,
    gathered, and each rank keeps its rows.  Inside the batched step of
    ``chains = K`` (``torch.func.vmap`` over the chains) the K chains'
    terms go to one call (``pack.chain_pass``): one K4 launch, a block a
    chain."""
    terms = gather_loci(ctx.shard, torch.stack(
        [x.double() for x in (old, new, dlog, ddens, us, ctx.locus_mask)],
        1))
    accept = chain_pass(gammadir_chain, {"terms": terms},
                        per_chain=("terms",), a_bar=a_bar, b_bar=b_bar,
                        a_i=a_i, margin=margin)
    if ctx.shard is not None:
        accept = ctx.shard.rows(accept)
    return accept


def gammadir_chain(terms, a_bar, b_bar, a_i, margin=None):
    """The accept chain over ``terms`` ``[L, 6]`` float64 (per locus the
    old and new value, log proposal ratio, locus-factorizing density
    delta, uniform, mask): accept ``[L]`` bool on their device; over K
    chains (``terms [K, L, 6]``) accept ``[K, L]``, each chain with its
    own running sum and its own count of proposing loci.  CUDA tensors:
    kernel K4 (one launch, a block a chain), with no host read; CPU
    tensors: the plain version :func:`_gammadir_chain` a chain
    (``margin`` as there, ``[K, L]`` over K chains; the CPU only)."""
    if terms.device.type == "cuda":
        return chains.launch_gammadir(terms.contiguous(), a_bar, b_bar, a_i)
    if terms.dim() == 3:
        return torch.stack([_host_gammadir(
            t, a_bar, b_bar, a_i, None if margin is None else margin[k])
            for k, t in enumerate(terms)])
    return _host_gammadir(terms, a_bar, b_bar, a_i, margin)


def _host_gammadir(terms, a_bar, b_bar, a_i, margin):
    """:func:`_gammadir_chain` on one chain's CPU terms."""
    host = terms.T.numpy()
    mask = host[5] > 0.5
    nl = float(mask.sum())
    return torch.from_numpy(_gammadir_chain(
        host[:5], mask, a_bar, a_i * nl, b_bar / nl, a_i, margin))


# --------------------------------------------------------------------------
# mu_i move (prop_locusrate_mui, stree.c:9225) and mubar (stree.c:9770)
# --------------------------------------------------------------------------


def mui_move(ctx: Ctx, cfg: BppConfig, state: McmcState, gen):
    """Locus-rate mu_i under the Gamma-Dirichlet (prior 0) or the
    hierarchical conditional-iid (prior 1) prior.  The GLOBAL, CORR and
    SIMPLE clocks change the likelihood; IID and CORR change the
    branch-rate prior."""
    L = state.gt.n_loci
    eps = state.finetune[FT_MUI]
    mu = state.subst.mu
    mu_new, dlog = _logslide(gen, mu, eps, ctx.shard)
    mu_new = torch.where(ctx.locus_mask, mu_new, mu)

    subst_new = state.subst._replace(mu=mu_new)
    likelihood_changes = cfg.clock in (Clock.GLOBAL, Clock.CORRELATED,
                                       Clock.SIMPLE)
    clock_new = state.clock
    root = state.sp.root
    if cfg.clock == Clock.CORRELATED:
        brate = state.clock.brate.clone()
        brate[:, root] = mu_new
        clock_new = state.clock._replace(brate=brate)
    if likelihood_changes:
        logl_new = make_logl_fn(ctx, cfg)(state.gt, subst_new, state.sp,
                                          clock_new, mig=state.mig)
        dlogl = logl_new - state.logl
    else:
        logl_new = state.logl
        dlogl = torch.zeros_like(state.logl)
    lnr_new = None
    dlnr = torch.zeros_like(mu)
    if cfg.clock in (Clock.IID, Clock.CORRELATED):
        lnr_new = lnprior_rates(cfg, state.sp, mu_new, clock_new)
        dlnr = lnr_new - state.clock.lnrates

    a_mui = cfg.locusrate_alpha
    us = rng.uniform(gen, (L,), mu.dtype, mu.device, ctx.shard)
    if cfg.locusrate_prior == 1:
        # iid Gamma(a_mui, a_mui / mubar): no cross-locus coupling
        beta = a_mui / state.clock.mubar
        lnacc = (dlog + (a_mui - 1.0) * torch.log(mu_new / mu)
                 - beta * (mu_new - mu) + dlogl + dlnr)
        accept = (torch.log(us) < lnacc) & ctx.locus_mask
    else:
        accept = gammadir_accept(ctx, mu, mu_new, dlog, dlogl + dlnr, us,
                                cfg.locusrate_mubar_a, cfg.locusrate_mubar_b,
                                a_mui)

    mu_fin = torch.where(accept, mu_new, mu)
    new = state._replace(subst=state.subst._replace(mu=mu_fin))
    if likelihood_changes:
        new = new._replace(logl=torch.where(accept, logl_new, state.logl))
    if cfg.clock == Clock.CORRELATED:
        brate = state.clock.brate.clone()
        brate[:, root] = mu_fin
        new = new._replace(clock=new.clock._replace(brate=brate))
    if lnr_new is not None:
        new = new._replace(clock=new.clock._replace(
            lnrates=torch.where(accept, lnr_new, state.clock.lnrates)))
    return new, psum_counts(ctx.shard, ctx.locus_mask.sum(), accept.sum())


def mubar_move(ctx: Ctx, cfg: BppConfig, state: McmcState, gen):
    eps = state.finetune[FT_MUBAR]
    old = state.clock.mubar
    new, dlog = _logslide(gen, old, eps)
    a, b = cfg.locusrate_mubar_a, cfg.locusrate_mubar_b
    am = cfg.locusrate_alpha
    bnew, bold = am / new, am / old
    mu = state.subst.mu
    summu, nl = psum(ctx.shard, torch.sum(torch.where(
        ctx.locus_mask, mu, torch.zeros_like(mu))), ctx.locus_mask.sum())
    lnacc = (dlog + (a - 1.0) * torch.log(new / old) - b * (new - old)
             + nl * am * torch.log(bnew / bold) - (bnew - bold) * summu)
    accept = rng.mh_accept(gen, lnacc)
    mubar = torch.where(accept, new, old)
    return (state._replace(clock=state.clock._replace(mubar=mubar)),
            (1, accept.to(torch.int64)))


# --------------------------------------------------------------------------
# nu_i move (prop_locusrate_nui, stree.c:9052) and nubar (stree.c:9814)
# --------------------------------------------------------------------------


def nui_move(ctx: Ctx, cfg: BppConfig, state: McmcState, gen):
    """Per-locus rate variances nu_i: they enter only the branch-rate
    prior, so no likelihood pass."""
    L = state.gt.n_loci
    eps = state.finetune[FT_NUI]
    nu = state.clock.nu
    nu_new, dlog = _logslide(gen, nu, eps, ctx.shard)
    nu_new = torch.where(ctx.locus_mask, nu_new, nu)
    clock_new = state.clock._replace(nu=nu_new)
    lnr_new = lnprior_rates(cfg, state.sp, state.subst.mu, clock_new)
    dlnr = lnr_new - state.clock.lnrates

    a_vi = cfg.clock_vi_alpha
    us = rng.uniform(gen, (L,), nu.dtype, nu.device, ctx.shard)
    if cfg.locusrate_prior == 1:
        beta = a_vi / state.clock.nubar
        lnacc = (dlog + (a_vi - 1.0) * torch.log(nu_new / nu)
                 - beta * (nu_new - nu) + dlnr)
        accept = (torch.log(us) < lnacc) & ctx.locus_mask
    else:
        accept = gammadir_accept(ctx, nu, nu_new, dlog, dlnr, us,
                                cfg.clock_vbar_a, cfg.clock_vbar_b, a_vi)
    new = state._replace(clock=state.clock._replace(
        nu=torch.where(accept, nu_new, nu),
        lnrates=torch.where(accept, lnr_new, state.clock.lnrates)))
    return new, psum_counts(ctx.shard, ctx.locus_mask.sum(), accept.sum())


def nubar_move(ctx: Ctx, cfg: BppConfig, state: McmcState, gen):
    eps = state.finetune[FT_NUBAR]
    old = state.clock.nubar
    new, dlog = _logslide(gen, old, eps)
    a, b = cfg.clock_vbar_a, cfg.clock_vbar_b
    av = cfg.clock_vi_alpha
    bnew, bold = av / new, av / old
    nu = state.clock.nu
    sumnu, nl = psum(ctx.shard, torch.sum(torch.where(
        ctx.locus_mask, nu, torch.zeros_like(nu))), ctx.locus_mask.sum())
    lnacc = (dlog + (a - 1.0) * dlog - b * (new - old)
             + nl * av * torch.log(bnew / bold) - (bnew - bold) * sumnu)
    accept = rng.mh_accept(gen, lnacc)
    nubar = torch.where(accept, new, old)
    return (state._replace(clock=state.clock._replace(nubar=nubar)),
            (1, accept.to(torch.int64)))


# --------------------------------------------------------------------------
# branch-rate sweeps (prop_branch_rates, stree.c:10264; _simple :10088)
# --------------------------------------------------------------------------


def _sweep_segments(ctx: Ctx, cfg: BppConfig, state: McmcState):
    """``state.relaxed_segments`` of the state's (gt, sp, mig): a sweep
    over branch rates changes none of them, so one evaluation serves all
    of its likelihood passes."""
    if not cfg.usedata:
        return None
    return relaxed_segments(ctx, state.gt, state.sp, state.mig,
                            cfg.migration)


def brate_move(ctx: Ctx, cfg: BppConfig, state: McmcState, gen):
    """Sweep every species branch h (IID, CORR); per-locus independent
    accept (each locus's rates are a priori independent).  Under CORR the
    root's rate is mu_i, which the mu_i move owns: the root is skipped,
    with no likelihood pass."""
    H = state.sp.n_nodes
    L = state.gt.n_loci
    logl_fn = make_logl_fn(ctx, cfg)
    eps = state.finetune[FT_BRATE]
    root = state.sp.root
    seg = _sweep_segments(ctx, cfg, state)
    brate, lnrates, logl = (state.clock.brate, state.clock.lnrates,
                            state.logl)
    dev = logl.device
    nprop = torch.zeros((), dtype=torch.int64, device=dev)
    nacc = torch.zeros((), dtype=torch.int64, device=dev)
    active = ctx.locus_mask
    rmask = state.sp.rate_nodes
    for h in range(H):
        if cfg.clock == Clock.CORRELATED and h == root:
            continue
        r = brate[:, h]
        r_new, dlog = _logslide(gen, r, eps, ctx.shard)
        act = active
        if rmask is not None:
            # a network's zero-length segments and BDI mirrors carry no
            # rate (stree.c:10293-10298)
            act = active & rmask[h]
        r_new = torch.where(act, r_new, r)
        brate_new = brate.clone()
        brate_new[:, h] = r_new
        clock_new = state.clock._replace(brate=brate_new)
        logl_new = logl_fn(state.gt, state.subst, state.sp, clock_new,
                           seg=seg)
        lnr_new = lnprior_rates(cfg, state.sp, state.subst.mu, clock_new)
        lnacc = dlog + (logl_new - logl) + (lnr_new - lnrates)
        us = rng.uniform(gen, (L,), r.dtype, dev, ctx.shard)
        accept = (torch.log(us) < lnacc) & act
        brate = torch.where(accept[:, None], brate_new, brate)
        lnrates = torch.where(accept, lnr_new, lnrates)
        logl = torch.where(accept, logl_new, logl)
        nprop = nprop + act.sum()
        nacc = nacc + accept.sum()
    new = state._replace(
        clock=state.clock._replace(brate=brate, lnrates=lnrates), logl=logl)
    return new, psum_counts(ctx.shard, nprop, nacc)


def brate_simple_move(ctx: Ctx, cfg: BppConfig, state: McmcState, gen):
    """SIMPLE clock (clock = 4): one shared rate per species branch,
    scaled by mu_i; Gamma(a, a) iid prior; one global accept per branch."""
    H = state.sp.n_nodes
    logl_fn = make_logl_fn(ctx, cfg)
    eps = state.finetune[FT_BRATE]
    a = cfg.clock_alpha
    seg = _sweep_segments(ctx, cfg, state)
    brate, logl = state.clock.brate, state.logl
    nacc = torch.zeros((), dtype=torch.int64, device=logl.device)
    rmask = state.sp.rate_nodes
    for h in range(H):
        r = brate[0, h]
        r_new, dlog = _logslide(gen, r, eps)
        if rmask is not None:
            r_new = torch.where(rmask[h], r_new, r)
        brate_new = brate.clone()
        brate_new[0, h] = r_new
        clock_new = state.clock._replace(brate=brate_new)
        logl_new = logl_fn(state.gt, state.subst, state.sp, clock_new,
                           seg=seg)
        lnacc = (dlog + (a - 1.0) * torch.log(r_new / r) - a * (r_new - r)
                 + psum(ctx.shard, torch.sum(logl_new - logl)))
        accept = rng.mh_accept(gen, lnacc)
        brate = torch.where(accept, brate_new, brate)
        logl = torch.where(accept, logl_new, logl)
        nacc = nacc + accept.to(torch.int64)
    clock_new = state.clock._replace(brate=brate)
    clock_new = clock_new._replace(
        lnrates=lnprior_rates(cfg, state.sp, state.subst.mu, clock_new))
    return state._replace(clock=clock_new, logl=logl), (H, nacc)


# --------------------------------------------------------------------------
# tip-dating mutation rate (prop_tipDate_muGtree, stree.c:9419)
# --------------------------------------------------------------------------


def tipdate_mubar_move(ctx: Ctx, cfg: BppConfig, state: McmcState, gen):
    """Serial-sampling mutation-rate move (prop_tipDate_muGtree,
    stree.c:9419).

    ``state.mubar`` turns calendar sample dates into substitution units:
    tip ages are ``date * mubar``.  The proposal slides log(mubar)
    (bounded above so that every dated constraint stays below its tau,
    find_maxMuGtree stree.c:9744), rescales every dated tip age to
    ``date * mubar'``, and affinely squashes each gene node inside a tip
    population so that the population's upper boundary (parent tau)
    stays fixed (prop_mu_updateCoal_recursive, stree.c:9698): with b the
    oldest descendant sample age and c = mubar'/mubar,

        h = (tau - b*c) / (tau - b),   t' = tau - h * (tau - t),

    each remapped node adding log h to the Hastings ratio.  Gene nodes in
    ancestral populations and all taus stay; the move is rejected if the
    remap breaks parent > child ordering (stree.c:9506-9513)."""
    gt, sp = state.gt, state.sp
    N, T = gt.n_nodes, gt.n_tips
    NS = sp.n_tips
    dt = sp.tau.dtype
    dev = sp.tau.device
    floor = tiny_floor(dt)
    logl_fn = make_logl_fn(ctx, cfg)
    logpr_fn = make_logpr_fn(ctx)
    eps = state.finetune[FT_MUBAR]
    old = state.mubar

    # upper bound (find_maxMuGtree): mu' < min_h tau_h / date_lmax_h
    lmax = ctx.date_lmax
    inf = torch.full_like(sp.tau, float("inf"))
    ratio = torch.where((lmax > 0) & (sp.tau > 0),
                        sp.tau / torch.clamp(lmax, min=floor), inf)
    bound = torch.min(ratio)
    lbound = torch.where(torch.isfinite(bound), torch.log(bound),
                         torch.full_like(bound, LOG_BOUND))
    lold = torch.log(old)
    lnew = rng.reflect(lold + eps * rng.bactrian(gen, (), dt, dev),
                       -LOG_BOUND, lbound)
    new = torch.exp(lnew)
    c = new / old

    pops = assign_populations(gt, sp, ctx.tip_pop)
    node_idx = torch.arange(N, device=dev)[None, :]
    is_tip = node_idx < ctx.n_seq[:, None]
    is_inner = (node_idx >= T) & (node_idx < T + ctx.n_seq[:, None] - 1)
    bmax = topo_scan(gt, gt.age[:, :T], torch.maximum)          # [L, N]
    in_tip_pop = pops < NS
    ptau = sp.tau[sp.parent[pops].clamp(min=0)]                 # [L, N]
    squash = is_inner & in_tip_pop & (bmax > 0)
    one = torch.ones_like(gt.age)
    h = torch.where(squash, (ptau - bmax * c)
                    / torch.clamp(ptau - bmax, min=floor), one)
    age_new = torch.where(squash, ptau - h * (ptau - gt.age), gt.age)
    tip_new = torch.where(is_tip[:, :T], ctx.tip_dates * new,
                          torch.zeros_like(ctx.tip_dates))
    age_new = torch.cat([tip_new.to(dt), age_new[:, T:]], dim=1)
    mask = ctx.locus_mask[:, None]
    # sums over loci in locus_sum's fixed order, which the batched step
    # (vmap over the chains) rounds as one chain's step does
    jac = locus_sum(torch.where(squash & mask,
                                torch.log(torch.clamp(h, min=floor)),
                                torch.zeros_like(h)).reshape(-1))

    # ordering check (stree.c:9506): reject if any child got older than
    # its parent under the per-node squash factors
    page_new = torch.where(
        gt.parent >= 0, torch.gather(age_new, 1, gt.parent.clamp(min=0)),
        torch.full_like(age_new, float("inf")))
    bad = torch.any((is_tip | is_inner) & mask & (gt.parent >= 0)
                    & (age_new > page_new))
    bad = pany(ctx.shard, bad | torch.any(torch.where(squash, h, one) <= 0.0))

    a_mu, b_mu = cfg.locusrate_mubar_a, cfg.locusrate_mubar_b
    lnacc = (lnew - lold + (a_mu - 1.0) * torch.log(new / old)
             - b_mu * (new - old))

    gtn = gt._replace(age=age_new)
    logl_new = logl_fn(gtn, state.subst, sp, state.clock)
    logpr_new, c_new, t2_new = logpr_fn(gtn, sp, state.subst.heredity)
    jac, dlogl, dlogpr = psum(ctx.shard, jac,
                              locus_sum(logl_new - state.logl),
                              locus_sum(logpr_new - state.logpr))
    lnacc = lnacc + jac + dlogl
    cand = state._replace(gt=gtn, logl=logl_new, logpr=logpr_new, mubar=new)
    if cfg.theta_integrated:
        hered = state.subst.heredity
        lnacc = lnacc + (
            notheta.total_integrated(cfg, c_new, t2_new, hered,
                                     ctx.locus_mask, ctx.shard)
            - notheta.total_integrated(cfg, state.coal, state.t2h, hered,
                                       ctx.locus_mask, ctx.shard))
        cand = cand._replace(coal=c_new, t2h=t2_new, logpr=state.logpr)
    else:
        lnacc = lnacc + dlogpr

    accept = rng.mh_accept(
        gen, torch.where(bad, torch.full_like(lnacc, float("-inf")), lnacc))
    return (tree_where(accept, cand, state),
            (1, accept.to(torch.int64)))
