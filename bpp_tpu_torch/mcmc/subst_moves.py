"""Substitution- and rate-parameter moves, batched over loci (PyTorch).

Port of ``bpp_tpu/mcmc/subst_moves.py``, for one DNA model for all loci
or one model per locus (``model = custom``; amino-acid loci have no free
parameter):

  * base frequencies  — locus.c:2634 ``propose_freqs``: pick a pair
    (j, k), slide the ratio x = f_j/(f_j+f_k), uniform Dirichlet prior.
  * Q-matrix rates    — locus.c:3167 ``propose_qrates``: log-slide each
    non-reference rate against the reference (A<->G for GTR, beta for
    the kappa models), Dirichlet(2,4,2,2,4,2) prior; under a partition
    the free slots and the reference vary per locus, and a locus whose
    model does not free a slot sits that round out.
  * Gamma shape alpha — prop_gamma.c:54 ``propose_alpha``: log-slide,
    Gamma(a, b) prior, mean-discretized categories recomputed.
  * locus rates mu_i under the Dirichlet prior — stree.c:9225
    ``prop_locusrate_mui`` re-designed as compensating-pair slides on
    random disjoint locus pairs: pair sums are conserved, so the
    sum-of-rates terms of the joint density cancel and every pair takes
    its own decision.  (The Gamma-Dirichlet and hierarchical priors are
    sampled by ``clock_moves.mui_move``.)
  * heredity scalars  — gtree.c:8214 ``prop_heredity``: slide mirrored
    at 0, Gamma(a_h, b_h) prior, affects only the MSC density.

Every likelihood-touching proposal recomputes the full batched
likelihood pass (one kernel launch on the card) and accepts or rejects
per locus with ``torch.where`` over the ``SubstState`` tuple; nothing is
read back to the host (the heredity move with integrated-out thetas
takes its decisions in ``notheta``'s serial accept chain, kernel K3 on
the card).
"""

from __future__ import annotations

import torch

from ..config import BppConfig, SubstModel
from ..core.gammarates import discrete_gamma_rates
from ..parallel.mesh import gather_loci, psum_counts
from . import notheta, rng
from .state import (
    FT_ALPHA, FT_FREQS, FT_LRHT, FT_QRATES, Ctx, McmcState, SubstState,
    custom_kappas, make_logl_fn, make_logpr_fn, refresh_eigen,
)

# number of free Q-matrix params and reference-rate index per model
# (locus.c:3197-3226)
QRATES_COUNT = {
    SubstModel.K80: (2, 1), SubstModel.HKY: (2, 1), SubstModel.T92: (2, 1),
    SubstModel.F84: (2, 1), SubstModel.TN93: (3, 2), SubstModel.GTR: (6, 1),
}
GTR_DIR_ALPHA = (2.0, 4.0, 2.0, 2.0, 4.0, 2.0)  # locus.c:3190
FREQS_MODELS = (SubstModel.F81, SubstModel.HKY, SubstModel.T92,
                SubstModel.TN93, SubstModel.F84, SubstModel.GTR)


def _derive_kappas(subst: SubstState, model: SubstModel,
                   custom=None) -> SubstState:
    """kappa1/kappa2 from the qrates vector for the TN93 family (per
    locus under a partition, ``custom``)."""
    if model == SubstModel.CUSTOM:
        k1, k2 = custom_kappas(subst.qrates, custom.kind)
        return subst._replace(kappa1=k1, kappa2=k2)
    if model in (SubstModel.K80, SubstModel.HKY, SubstModel.T92,
                 SubstModel.F84):
        k = subst.qrates[:, 0] / subst.qrates[:, 1]
        return subst._replace(kappa1=k, kappa2=k)
    if model == SubstModel.TN93:
        return subst._replace(kappa1=subst.qrates[:, 0] / subst.qrates[:, 2],
                              kappa2=subst.qrates[:, 1] / subst.qrates[:, 2])
    return subst


def _select(accept, new: SubstState, old: SubstState) -> SubstState:
    """Per-locus choice between two substitution states."""
    L = accept.shape[0]
    return SubstState(*(
        torch.where(accept.reshape((L,) + (1,) * (o.dim() - 1)), n, o)
        for n, o in zip(new, old)))


def _logl(ctx, cfg, state, subst_new):
    return make_logl_fn(ctx, cfg)(state.gt, subst_new, state.sp, state.clock)


def freqs_move(ctx: Ctx, cfg: BppConfig, state: McmcState, gen):
    L = state.gt.n_loci
    subst = state.subst
    f = subst.freqs
    dt, dev = f.dtype, f.device
    lidx = torch.arange(L, device=dev)
    eps = state.finetune[FT_FREQS]
    # under a partition only the loci whose model has free frequencies
    # take part (always the first 4 states: amino-acid ones are fixed)
    free = ctx.locus_mask if ctx.custom is None \
        else ctx.locus_mask & ctx.custom.freqs_free

    sh = ctx.shard
    j = rng.randint(gen, 4, (L,), dev, sh)
    k = rng.randint(gen, 3, (L,), dev, sh)
    k = torch.where(k >= j, k + 1, k)
    fj = f[lidx, j]
    fk = f[lidx, k]
    s = fj + fk
    ssafe = torch.clamp(s, min=1e-30)
    minv = 1e-8 / ssafe                   # PLL_MISC_EPSILON bound
    y = rng.reflect(fj / ssafe + eps * rng.bactrian(gen, (L,), dt, dev, sh),
                    minv, 1.0 - minv)
    fnew = f.clone()
    fnew[lidx, j] = y * s
    fnew[lidx, k] = s - y * s
    fnew = torch.where(free[:, None], fnew, f)

    subst_new = refresh_eigen(subst._replace(freqs=fnew), cfg.model,
                              ctx.custom, ctx.captured)
    logl_new = _logl(ctx, cfg, state, subst_new)
    lnacc = logl_new - state.logl         # uniform Dirichlet prior, symmetric
    accept = rng.mh_accept(gen, lnacc, sh) & free
    return (state._replace(subst=_select(accept, subst_new, subst),
                           logl=torch.where(accept, logl_new, state.logl)),
            psum_counts(ctx.shard, free.sum(), accept.sum()))


def qrates_move(ctx: Ctx, cfg: BppConfig, state: McmcState, gen):
    """Sequential sweep over non-reference rates, each batched over loci:
    one likelihood pass per target (1 for the kappa models, 2 for TN93,
    5 for GTR; under a partition one for each slot free at some locus)."""
    if cfg.model == SubstModel.CUSTOM:
        return _qrates_move_custom(ctx, cfg, state, gen)
    L = state.gt.n_loci
    count, ref = QRATES_COUNT[cfg.model]
    eps = state.finetune[FT_QRATES]
    targets = [j for j in range(count) if j != ref]

    subst, logl = state.subst, state.logl
    dt, dev = logl.dtype, logl.device
    nacc = torch.zeros((), dtype=torch.int64, device=dev)
    lo = torch.full((L,), 1e-5, dtype=dt, device=dev).log()
    for j in targets:
        q = subst.qrates
        s = q[:, j] + q[:, ref]
        old_lg = torch.log(q[:, j])
        new_lg = rng.reflect(
            old_lg + eps * rng.bactrian(gen, (L,), dt, dev, ctx.shard), lo,
            torch.log(s))
        qnew = q.clone()
        qnew[:, j] = torch.exp(new_lg)
        qnew[:, ref] = s - torch.exp(new_lg)

        subst_new = refresh_eigen(
            _derive_kappas(subst._replace(qrates=qnew), cfg.model), cfg.model,
            jacobi=ctx.captured)
        logl_new = _logl(ctx, cfg, state, subst_new)
        aj, ar = GTR_DIR_ALPHA[j], GTR_DIR_ALPHA[ref]
        lnacc = (new_lg - old_lg) + (logl_new - logl) \
            + (aj - 1.0) * (new_lg - old_lg) \
            + (ar - 1.0) * torch.log(qnew[:, ref] / q[:, ref])
        accept = rng.mh_accept(gen, lnacc, ctx.shard) & ctx.locus_mask
        subst = _select(accept, subst_new, subst)
        logl = torch.where(accept, logl_new, logl)
        nacc = nacc + accept.sum()
    nprop = len(targets) * ctx.locus_mask.sum()
    return (state._replace(subst=subst, logl=logl),
            psum_counts(ctx.shard, nprop, nacc))


def _qrates_move_custom(ctx: Ctx, cfg: BppConfig, state: McmcState, gen):
    """The qrates sweep under a partition (``model = custom``): the same
    slot-against-reference log-slide, with the free slots and the
    reference slot of each locus's model (``state.CustomModels``)."""
    cm = ctx.custom
    L = state.gt.n_loci
    eps = state.finetune[FT_QRATES]
    subst, logl = state.subst, state.logl
    dt, dev = logl.dtype, logl.device
    lidx = torch.arange(L, device=dev)
    lo = torch.full((L,), 1e-5, dtype=dt, device=dev).log()
    nprop = torch.zeros((), dtype=torch.int64, device=dev)
    nacc = torch.zeros((), dtype=torch.int64, device=dev)
    for j in cm.q_slots:
        free_j = cm.q_free[:, j] & ctx.locus_mask
        q = subst.qrates
        qref = q[lidx, cm.q_ref]
        s = q[:, j] + qref
        old_lg = torch.log(q[:, j])
        new_lg = rng.reflect(
            old_lg + eps * rng.bactrian(gen, (L,), dt, dev, ctx.shard), lo,
            torch.log(s))
        qnew = q.clone()
        qnew[:, j] = torch.exp(new_lg)
        qnew[lidx, cm.q_ref] = s - torch.exp(new_lg)
        qnew = torch.where(free_j[:, None], qnew, q)

        subst_new = refresh_eigen(
            _derive_kappas(subst._replace(qrates=qnew), cfg.model, cm),
            cfg.model, cm, ctx.captured)
        logl_new = _logl(ctx, cfg, state, subst_new)
        ref_ratio = torch.log(torch.where(
            free_j, qnew[lidx, cm.q_ref] / torch.clamp(qref, min=1e-300),
            torch.ones_like(qref)))
        lnacc = (new_lg - old_lg) + (logl_new - logl) \
            + (GTR_DIR_ALPHA[j] - 1.0) * (new_lg - old_lg) \
            + (cm.q_ref_alpha - 1.0) * ref_ratio
        accept = rng.mh_accept(gen, lnacc, ctx.shard) & free_j
        subst = _select(accept, subst_new, subst)
        logl = torch.where(accept, logl_new, logl)
        nprop = nprop + free_j.sum()
        nacc = nacc + accept.sum()
    return (state._replace(subst=subst, logl=logl),
            psum_counts(ctx.shard, nprop, nacc))


def alpha_move(ctx: Ctx, cfg: BppConfig, state: McmcState, gen):
    L = state.gt.n_loci
    C = state.subst.rates.shape[1]
    a0, b0 = cfg.alphaprior.alpha, cfg.alphaprior.beta
    eps = state.finetune[FT_ALPHA]

    alpha = state.subst.alpha
    dt, dev = alpha.dtype, alpha.device
    loga = torch.log(alpha)
    loga_new = rng.reflect(
        loga + eps * rng.bactrian(gen, (L,), dt, dev, ctx.shard), -99.0,
        99.0)
    alpha_new = torch.exp(loga_new)
    rates_new = discrete_gamma_rates(alpha_new, C).to(dt)

    subst_new = state.subst._replace(alpha=alpha_new, rates=rates_new)
    logl_new = _logl(ctx, cfg, state, subst_new)
    lnacc = (loga_new - loga) + (logl_new - state.logl) \
        + (a0 - 1.0) * (loga_new - loga) - b0 * (alpha_new - alpha)
    accept = rng.mh_accept(gen, lnacc, ctx.shard) & ctx.locus_mask
    subst = state.subst._replace(
        alpha=torch.where(accept, alpha_new, alpha),
        rates=torch.where(accept[:, None], rates_new, state.subst.rates))
    return (state._replace(subst=subst,
                           logl=torch.where(accept, logl_new, state.logl)),
            psum_counts(ctx.shard, ctx.locus_mask.sum(), accept.sum()))


def locusrate_move(ctx: Ctx, cfg: BppConfig, state: McmcState, gen):
    """mu_i under the Dirichlet prior: compensating-pair slides.  The
    clock is global, so mu changes the likelihood.  A pair may join loci
    of two ranks under locus sharding: the pairs are drawn and decided on
    the gathered rates and likelihood deltas of every locus, the same on
    each rank, and a rank keeps its rows."""
    sh = ctx.shard
    eps = state.finetune[FT_LRHT]
    a_mui = cfg.locusrate_alpha
    mu = gather_loci(sh, state.subst.mu)
    mask = gather_loci(sh, ctx.locus_mask)
    L = mu.shape[0]
    dt, dev = mu.dtype, mu.device

    def rows(x):
        return x if sh is None else sh.rows(x)

    perm = rng.randperm(gen, L, dev)
    n_pairs = L // 2
    pi = perm[:n_pairs]
    pj = perm[n_pairs:2 * n_pairs]
    valid = mask[pi] & mask[pj]

    s = mu[pi] + mu[pj]
    minv = 1e-8 / s
    y = rng.reflect(mu[pi] / s + eps * rng.bactrian(gen, (n_pairs,), dt, dev),
                    minv, 1.0 - minv)
    mu_new = mu.clone()
    mu_new[pi] = torch.where(valid, y * s, mu[pi])
    mu_new[pj] = torch.where(valid, s - y * s, mu[pj])

    logl_new = _logl(ctx, cfg, state,
                     state.subst._replace(mu=rows(mu_new)))
    dlogl = gather_loci(sh, logl_new - state.logl)
    pair_lnacc = dlogl[pi] + dlogl[pj] + (a_mui - 1.0) * (
        torch.log(mu_new[pi] * mu_new[pj]) - torch.log(mu[pi] * mu[pj]))
    accept_p = rng.mh_accept(gen, pair_lnacc) & valid
    # made from the rates, so that inside the batched step (vmap) it
    # carries the chain axis of the writes below
    accept = torch.zeros_like(mu, dtype=torch.bool)
    accept[pi] = accept_p
    accept[pj] = accept_p
    accept = rows(accept)
    state = state._replace(
        subst=state.subst._replace(mu=torch.where(accept, rows(mu_new),
                                                  state.subst.mu)),
        logl=torch.where(accept, logl_new, state.logl))
    return state, (valid.sum(), accept_p.sum())


def heredity_move(ctx: Ctx, cfg: BppConfig, state: McmcState, gen):
    """Batched prop_heredity: affects only the MSC density."""
    L = state.gt.n_loci
    eps = state.finetune[FT_LRHT]
    h = state.subst.heredity
    h_new = torch.abs(h + eps * rng.bactrian(gen, (L,), h.dtype, h.device,
                                             ctx.shard))
    h_new = torch.clamp(h_new, min=1e-300)
    h_new = torch.where(ctx.locus_mask, h_new, h)
    dprior = (cfg.heredity_alpha - 1.0) * torch.log(h_new / h) \
        - cfg.heredity_beta * (h_new - h)
    if cfg.theta_integrated:
        # the gene trees stay: only the heredity scaling of C_h moves
        accept = notheta.scan_accept(
            gen, cfg, dprior, state.coal, state.t2h, h, state.coal,
            state.t2h, h_new, ctx.locus_mask, ctx.locus_mask, ctx.shard)
        return (state._replace(subst=state.subst._replace(
            heredity=torch.where(accept, h_new, h))),
            psum_counts(ctx.shard, ctx.locus_mask.sum(), accept.sum()))
    logpr_new, _, _ = make_logpr_fn(ctx)(state.gt, state.sp, h_new)
    lnacc = dprior + (logpr_new - state.logpr)
    accept = rng.mh_accept(gen, lnacc, ctx.shard) & ctx.locus_mask
    return (state._replace(
        subst=state.subst._replace(heredity=torch.where(accept, h_new, h)),
        logpr=torch.where(accept, logpr_new, state.logpr)),
        psum_counts(ctx.shard, ctx.locus_mask.sum(), accept.sum()))
