"""rjMCMC species-delimitation moves (A10/A11): split and join (PyTorch).

Port of ``bpp_tpu/mcmc/rj_moves.py`` (``prop_split``/``prop_join``,
src/prop_rj.c:380/920, Yang & Rannala 2010).  A delimitation is the tau
vector (tau == 0 collapses a node), so a move

  1. picks a feasible node h (split: tau == 0 with a split or no parent;
     join: tau > 0 with tip or collapsed children), uniformly;
  2. draws tau_new = tau_upper * Beta(2, 8) (split; the Beta variate is a
     ratio of two Gamma draws) or zeroes the tau (join), tau_upper being
     the parent's tau, or 0.6 times the root-age scale at the root;
  3. maps the two child thetas from the parent's (the epsilon window of
     algorithm 0 or the Gamma of algorithm 1, prop_rj.c:456-469);
  4. rubber-bands the gene trees (``rubber_proportional`` prop_rj.c:205);
  5. recomputes the likelihood and the MSC density, one decision.

``bpp_tpu`` branches between split and join with ``lax.cond``.  Here both
proposals' species-level parts are built (a few ops on [H] tensors) and
selected with ``torch.where``; the rubber band and the likelihood pass
then run once, on the selected one.  Linked thetas (``thetamodel =
linked-all`` or ``linked-inner``) give a linked child its owner's theta.
Under MSC-M migration (``routes``) the populations come through the
migration events, event times ride the rubber band edge by edge
(:func:`_remap_event_times`) and the acceptance takes the
structured-coalescent density (prop_rj.c:599-656, :1140-1222).
Morphological traits are re-scored at the split or joined taus
(prop_rj.c:727-774).
"""

from __future__ import annotations

import math

import torch

from ..config import BppConfig, PriorDist
from ..trees import migration as mg
from ..trees.gtree import (
    BIG_AGE, assign_populations, inner_order, topo_scan,
)
from . import rng
from .moves import _integrated_delta, _trait_eval
from .state import Ctx, McmcState, make_logl_fn, make_logpr_fn, tree_where
from .stree_moves import _at, _masked_sum, log_species_model_prior


def _log_pdf_beta_scaled(x, p: float, q: float, scale):
    z = x / scale
    return (math.lgamma(p + q) - math.lgamma(p) - math.lgamma(q)
            + (p - 1.0) * torch.log(z) + (q - 1.0) * torch.log1p(-z)
            - torch.log(scale))


def _pick_uniform(u, mask):
    """The ``floor(u * count)``-th True index of ``mask`` [H], and the
    count."""
    count = mask.sum()
    rank = torch.minimum(torch.floor(u * count).to(torch.int64),
                         torch.clamp(count - 1, min=0))
    mi = mask.to(torch.int64)
    hit = mask & (torch.cumsum(mi, 0) - mi == rank)
    return torch.argmax(hit.to(torch.uint8)), count


def _rubber_band(ctx: Ctx, state: McmcState, h, tau_from, tau_to, tau_upper,
                 pops=None):
    """Age remap for a split/join at node h (0-dim index tensor); returns
    (age_new, lnterms [L]).  "Mixed" coalescences in population h
    (descendants of both children) map affinely between [tau_from,
    tau_upper] and [tau_to, tau_upper]; each maximal pure subtree below a
    mixed node scales with its governing mixed ancestor.  ``pops``: the
    populations of the gene nodes (the migration-aware ones under MSC-M),
    by default from the ages."""
    gt, sp = state.gt, state.sp
    L, N, T = gt.n_loci, gt.n_nodes, gt.n_tips
    dev = gt.age.device
    lidx = torch.arange(L, device=dev)
    nodes_idx = torch.arange(N, device=dev)[None, :]
    if pops is None:
        pops = assign_populations(gt, sp, ctx.tip_pop)
    age = gt.age
    valid_inner = (nodes_idx >= T) & (nodes_idx < T + ctx.n_seq[:, None] - 1)
    order = inner_order(gt)                          # youngest..oldest
    tip_l = _at(sp.pptable, _at(sp.left, h).clamp(min=0), 1)[ctx.tip_pop]
    tip_r = _at(sp.pptable, _at(sp.right, h).clamp(min=0), 1)[ctx.tip_pop]
    hasL = topo_scan(gt, tip_l, torch.logical_or, order)
    hasR = topo_scan(gt, tip_r, torch.logical_or, order)
    mixed = hasL & hasR & (pops == h) & valid_inner

    rubber = (tau_upper - tau_to) / (tau_upper - tau_from)
    affine = tau_upper - rubber * (tau_upper - age)
    ratio = torch.where(age > 0, affine / torch.clamp(age, min=1e-300),
                        torch.ones_like(age))

    # governing scale for pure subtrees: the nearest mixed ancestor's
    # ratio, broken (= 1) at mixed nodes (rubber_update recursion);
    # oldest node first
    gov = torch.ones_like(age)
    one = torch.ones_like(age[:, 0])
    for k in range(T - 1):
        node = order[:, T - 2 - k]
        par = gt.parent[lidx, node]
        par_s = par.clamp(min=0)
        own = mixed[lidx, node]
        g = torch.where(own, one, gov[lidx, par_s])
        pg = torch.where(mixed[lidx, par_s] & (par >= 0),
                         torch.where(own, one, ratio[lidx, par_s]), g)
        gov[lidx, node] = torch.where(valid_inner[lidx, node], pg, one)

    age_new = torch.where(mixed, affine, age * gov)
    n_mixed = mixed.sum(1).to(age.dtype)
    scaled = valid_inner & ~mixed & (torch.abs(gov - 1.0) > 0)
    lnterms = (n_mixed * torch.log(rubber)
               + torch.where(scaled, torch.log(gov),
                             torch.zeros_like(gov)).sum(1))
    return age_new, torch.where(ctx.locus_mask, lnterms,
                                torch.zeros_like(lnterms))


def _remap_event_times(gt, age_new, mig, locus_mask):
    """Per-edge linear remap of migration-event times after an age remap;
    returns (mig_new, per-locus log-Jacobian [L]).

    An event at time t on edge u -> parent(u) maps affinely between the
    edge's old and new endpoint ages, one log-slope Jacobian term an
    event: the bijection that keeps every event inside its rescaled edge.
    (The reference leaves event times alone in the rj move,
    ``rubber_proportional`` prop_rj.c:205, which can strand events
    outside their moved edges.)"""
    live = mig.node >= 0
    nd = mig.node.clamp(min=0)
    par = torch.gather(gt.parent, 1, nd)
    par_s = par.clamp(min=0)
    big = torch.full_like(mig.time, BIG_AGE)
    lo_o = torch.gather(gt.age, 1, nd)
    hi_o = torch.where(par >= 0, torch.gather(gt.age, 1, par_s), big)
    lo_n = torch.gather(age_new, 1, nd)
    hi_n = torch.where(par >= 0, torch.gather(age_new, 1, par_s), big)
    span_o = hi_o - lo_o
    moved = live & ((lo_n != lo_o) | (hi_n != hi_o))
    one = torch.ones_like(span_o)
    slope = torch.where(moved & (span_o > 0.0),
                        (hi_n - lo_n) / torch.where(span_o > 0.0, span_o,
                                                    one), one)
    t_new = torch.where(moved, lo_n + (mig.time - lo_o) * slope, mig.time)
    ljac = torch.where(moved & locus_mask[:, None],
                       torch.log(torch.clamp(slope, min=1e-300)),
                       torch.zeros_like(slope))
    return mig._replace(time=t_new), ljac.sum(dim=1)


def _prior_logpdf(prior, x):
    """Log density of a gamma or inverse-gamma ``Prior`` at ``x``."""
    a, b = prior.alpha, prior.beta
    if prior.dist == PriorDist.GAMMA:
        return rng.log_pdf_gamma(x, a, b)
    return (a * math.log(b) - math.lgamma(a) - (a + 1.0) * torch.log(x)
            - b / x)


def _child_theta_split(cfg: BppConfig, u, g, theta_h):
    """One child theta from the uniform ``u`` (algorithm 0) or the
    Gamma(alpha, 1) variate ``g`` (algorithm 1); returns (theta_c,
    log_thetafactor)."""
    if cfg.rjmcmc_method == 0:
        th = theta_h * torch.exp(cfg.rjmcmc_epsilon * (u - 0.5))
        return th, torch.log(cfg.rjmcmc_epsilon * th)
    a = cfg.rjmcmc_alpha
    b = a / (cfg.rjmcmc_mean * theta_h)
    th = g / b
    return th, -rng.log_pdf_gamma(th, a, b)


def _child_theta_join(cfg: BppConfig, theta_c, theta_h):
    """Reverse-direction factor; returns (log_thetafactor, disallowed)."""
    if cfg.rjmcmc_method == 0:
        y = math.exp(cfg.rjmcmc_epsilon * 0.5)
        bad = (theta_c < theta_h / y) | (theta_c > theta_h * y)
        return -torch.log(cfg.rjmcmc_epsilon * theta_c), bad
    a = cfg.rjmcmc_alpha
    b = a / (cfg.rjmcmc_mean * theta_h)
    return rng.log_pdf_gamma(theta_c, a, b), torch.zeros_like(theta_c,
                                                              dtype=torch.bool)


def rj_move(ctx: Ctx, cfg: BppConfig, state: McmcState, gen,
            root_age0: float, routes=None):
    """One rjMCMC step: split or join with probability 1/2 each
    (method.c:5420-5435, pr_split = 0.5, so the move-type term is 0).

    ``routes`` (a ``migration.RouteTensors``) switches on the MSC-M
    variant: a proposal that strands an event in a collapsed population's
    empty window has density 0 (the validity indicator), so a join is
    accepted only once the sim-SPR move has removed the gene flow among
    the merged populations' lineages."""
    sp = state.sp
    H = sp.n_nodes
    NS = (H + 1) // 2
    dev = sp.tau.device
    dt = sp.tau.dtype
    hidx = torch.arange(H, device=dev)
    logl_fn = make_logl_fn(ctx, cfg)
    integ = cfg.theta_integrated
    pops_rb = None
    if routes is None:
        logpr_fn = make_logpr_fn(ctx)
    else:
        from .mig_moves import make_logpr_fn_mig
        logpr_fn_mig = make_logpr_fn_mig(ctx, routes)
        pops_rb = mg.assign_populations_mig(state.gt, sp, ctx.tip_pop,
                                            state.mig, ctx.n_seq)

    # every draw of both branches, up front: direction, node, Beta(2, 8)
    # as two Gammas, the two child-theta variates
    u = rng.uniform(gen, (4,), dt, dev)
    a_rj = cfg.rjmcmc_alpha if cfg.rjmcmc_method == 1 else 1.0
    shapes = torch.stack([torch.full((), v, dtype=dt, device=dev)
                          for v in (2.0, 8.0, a_rj, a_rj)])
    g = rng.gamma(gen, shapes)
    do_split = u[0] < 0.5
    beta = g[0] / (g[0] + g[1])

    is_inner = hidx >= NS
    is_root = sp.parent < 0
    par_s = sp.parent.clamp(min=0)
    inf = torch.full_like(sp.tau, float("inf"))
    partau = torch.where(is_root, inf, sp.tau[par_s])
    l_ok = (sp.left < NS) | (sp.tau[sp.left.clamp(min=0)] == 0)
    r_ok = (sp.right < NS) | (sp.tau[sp.right.clamp(min=0)] == 0)
    feas_split = is_inner & (sp.tau == 0) & (is_root | (partau > 0))
    feas_join = is_inner & (sp.tau > 0) & l_ok & r_ok
    tau_count = (sp.tau[NS:] > 0).sum().to(dt)
    root_tau = _at(sp.tau, torch.argmax(is_root.to(torch.uint8)))

    def upper(h):
        h_is_root = _at(sp.parent, h) < 0
        return h_is_root, torch.where(
            h_is_root, torch.full_like(root_tau, root_age0 * 0.6),
            _at(partau, h))

    # --- split ------------------------------------------------------------
    h_s, fsplit = _pick_uniform(u[1], feas_split)
    root_s, up_s = upper(h_s)
    tau_new = up_s * beta
    ln_s = -_log_pdf_beta_scaled(tau_new, 2.0, 8.0, up_s)
    theta_s = sp.theta
    if not integ:
        # no thetas exist with them integrated out: the dimension change
        # is tau only (prop_rj.c:447)
        th_h = _at(sp.theta, h_s)
        lc, rc = _at(sp.left, h_s), _at(sp.right, h_s)
        th_l, f_l = _child_theta_split(cfg, u[2], g[2], th_h)
        th_r, f_r = _child_theta_split(cfg, u[3], g[3], th_h)
        fac_l = _prior_logpdf(cfg.thetaprior, th_l) + f_l
        fac_r = _prior_logpdf(cfg.thetaprior, th_r) + f_r
        link = ctx.theta_link
        if link is not None:
            # a linked child has no theta of its own: it takes its
            # owner's, with no prior or proposal factor (prop_rj.c:606)
            own_l = _at(link, lc.clamp(min=0))
            own_r = _at(link, rc.clamp(min=0))
            linked_l = own_l != lc
            linked_r = own_r != rc
            th_l = torch.where(linked_l, _at(sp.theta, own_l), th_l)
            th_r = torch.where(linked_r, _at(sp.theta, own_r), th_r)
            fac_l = torch.where(linked_l, torch.zeros_like(fac_l), fac_l)
            fac_r = torch.where(linked_r, torch.zeros_like(fac_r), fac_r)
        ln_s = ln_s + fac_l + fac_r
        theta_s = torch.where(hidx == lc, th_l,
                              torch.where(hidx == rc, th_r, sp.theta))
    ln_s = ln_s + torch.where(root_s, _prior_logpdf(cfg.tauprior, tau_new),
                              torch.log(tau_count / root_tau))  # Eq 2 YR2010
    tau_s = torch.where(hidx == h_s, tau_new, sp.tau)
    # feasible joins after the split, on the updated taus
    l_ok2 = (sp.left < NS) | (tau_s[sp.left.clamp(min=0)] == 0)
    r_ok2 = (sp.right < NS) | (tau_s[sp.right.clamp(min=0)] == 0)
    fjoin2 = (is_inner & (tau_s > 0) & l_ok2 & r_ok2).sum()
    ln_s = ln_s + torch.log(fsplit.to(dt) / fjoin2.to(dt))
    bad_s = fsplit == 0

    # --- join -------------------------------------------------------------
    h_j, fjoin = _pick_uniform(u[1], feas_join)
    root_j, up_j = upper(h_j)
    tau_old = _at(sp.tau, h_j)
    ln_j = _log_pdf_beta_scaled(tau_old, 2.0, 8.0, up_j)
    bad_j = (fjoin == 0) | (tau_old >= up_j)
    if not integ:
        th_h = _at(sp.theta, h_j)
        lc, rc = (_at(sp.left, h_j).clamp(min=0),
                  _at(sp.right, h_j).clamp(min=0))
        th_l, th_r = _at(sp.theta, lc), _at(sp.theta, rc)
        f_l, bad_l = _child_theta_join(cfg, th_l, th_h)
        f_r, bad_r = _child_theta_join(cfg, th_r, th_h)
        fac_l = f_l - _prior_logpdf(cfg.thetaprior, th_l)
        fac_r = f_r - _prior_logpdf(cfg.thetaprior, th_r)
        link = ctx.theta_link
        if link is not None:
            linked_l = _at(link, lc) != lc
            linked_r = _at(link, rc) != rc
            fac_l = torch.where(linked_l, torch.zeros_like(fac_l), fac_l)
            fac_r = torch.where(linked_r, torch.zeros_like(fac_r), fac_r)
            bad_l = bad_l & ~linked_l
            bad_r = bad_r & ~linked_r
        ln_j = ln_j + fac_l + fac_r
        bad_j = bad_j | bad_l | bad_r
    ln_j = ln_j - torch.where(root_j, _prior_logpdf(cfg.tauprior, tau_old),
                              torch.log((tau_count - 1.0) / root_tau))
    tau_j = torch.where(hidx == h_j, torch.zeros_like(sp.tau), sp.tau)
    fsplit2 = (is_inner & (tau_j == 0)
               & (is_root | (torch.where(is_root, inf, tau_j[par_s]) > 0))
               ).sum()
    ln_j = ln_j + torch.log(fjoin.to(dt) / fsplit2.to(dt))

    # --- the selected proposal: one rubber band, one pass --------------------
    h = torch.where(do_split, h_s, h_j)
    zero = torch.zeros_like(tau_new)
    age_new, lnterms = _rubber_band(
        ctx, state, h, torch.where(do_split, zero, tau_old),
        torch.where(do_split, tau_new, zero),
        torch.where(do_split, up_s, up_j), pops=pops_rb)
    sp_new = sp._replace(tau=torch.where(do_split, tau_s, tau_j),
                         theta=torch.where(do_split, theta_s, sp.theta))
    gt_new = state.gt._replace(age=age_new)
    lnacc = torch.where(do_split, ln_s, ln_j)
    bad = torch.where(do_split, bad_s, bad_j)

    if routes is None:
        mig_new = None
        logl_new = logl_fn(gt_new, state.subst, sp_new, state.clock)
        logpr_new, c_new, t2_new = logpr_fn(gt_new, sp_new,
                                            state.subst.heredity)
    else:
        mig_new, jac_e = _remap_event_times(state.gt, age_new, state.mig,
                                            ctx.locus_mask)
        lnterms = lnterms + jac_e
        logl_new = logl_fn(gt_new, state.subst, sp_new, state.clock,
                           mig=mig_new)
        logpr_new = logpr_fn_mig(gt_new, sp_new, mig_new,
                                 state.subst.heredity)[0]
    cand = state._replace(gt=gt_new, sp=sp_new, logl=logl_new,
                          logpr=logpr_new, mig=mig_new)
    if integ:
        # the integrated density couples the loci (prop_rj.c:539)
        lnacc = (lnacc + _integrated_delta(ctx, cfg, state, c_new, t2_new)
                 + _masked_sum(ctx, lnterms + (logl_new - state.logl)))
        cand = cand._replace(logpr=state.logpr, coal=c_new, t2h=t2_new)
    else:
        lnacc = lnacc + _masked_sum(ctx, lnterms + (logl_new - state.logl)
                                    + (logpr_new - state.logpr))
    # species-model prior ratio (prop_rj.c:510 lnprior_species_model)
    lnacc = lnacc + (log_species_model_prior(cfg, sp_new, ctx.prior_a11_log)
                     - log_species_model_prior(cfg, sp, ctx.prior_a11_log)
                     ).to(dt)
    # morphological traits re-scored at the split or joined taus
    # (prop_rj.c:727-774); under A11 on the current sampled topology (the
    # rj move never changes it)
    if ctx.has_traits:
        tl_new = _trait_eval(ctx, sp, sp_new.tau, state.trait.brate)
        lnacc = lnacc + torch.sum(tl_new - state.trait.logl)
        cand = cand._replace(trait=state.trait._replace(logl=tl_new))
    lnacc = torch.where(bad, torch.full_like(lnacc, -float("inf")), lnacc)
    accept = rng.mh_accept(gen, lnacc)
    return tree_where(accept, cand, state), (1, accept.to(torch.int64))
