"""MCMC moves, batched over loci (PyTorch).

Port of ``bpp_tpu/mcmc/moves.py`` without migration (``mig_moves``):
plain species trees and MSC-I networks (whose tau move is
``msci_moves.tau_move_net``), with estimated, linked or integrated-out
thetas, any clock, dated tips and morphological traits (the tau and
mixing moves re-score them):

  * gene-node ages    — gtree.c:4585 ``propose_ages`` (blocked by depth
                        parity: two jointly proposed phases)
  * gene-tree SPR     — gtree.c:6531 ``propose_spr`` (one pruned node
                        per locus per round)
  * theta slide/Gibbs — stree.c:3826/3645
  * tau rubber band   — stree.c:5512 + 4338 (two parity phases)
  * mixing            — prop_mixing.c:275

Per-locus moves take independent accept decisions per locus with
``torch.where``; global moves sum per-locus terms and take one decision.
No move reads a device value on the host, so a step runs without a
synchronisation.  Under integrated-out thetas the density couples the
loci, and the per-locus moves take their decisions in a serial chain
(``notheta.scan_accept``: kernel K3 on the card).  Under locus sharding
(``ctx.shard``) every sum over loci is a cross-rank sum
(:func:`_psum_if_sharded`) and every per-locus draw is taken at the
global shape (``rng``'s ``shard``), so each rank takes the decisions of
the unsharded run.
"""

from __future__ import annotations

import torch

from ..config import BppConfig, Clock, PriorDist
from ..parallel.mesh import psum, psum_counts
from ..trees.coalescent import locus_sum
from ..trees.gtree import (
    BIG_AGE, GTrees, assign_populations, edge_passes,
    lift_population, lift_population_net, mrca_and_leaves, mrca_species,
    node_depths,
)
from . import notheta, rng
from .clock_moves import lnprior_rates
from .gibbs import gamma_conditional_approx
from .state import (
    FT_GTAGE, FT_GTSPR, FT_MIX, FT_TAU, FT_THETA, Ctx, McmcState,
    make_logl_fn, make_logpr_fn, tree_where,
)

MAXAGE_CAP = 999.0  # reference's "999 for compatibility" upper bound


def _trait_eval(ctx: Ctx, sp, tau, brate):
    """The trait log-likelihoods [n_part] through whichever closure the
    run carries (the fixed topology's ``trait_fn`` for A00/A10,
    ``trait_fn_topo`` on ``sp``'s topology for A01/A11)."""
    if ctx.trait_fn is not None:
        return ctx.trait_fn(tau, brate)
    return ctx.trait_fn_topo(sp.left, sp.right, sp.parent, tau, brate)


def _psum_if_sharded(ctx: Ctx, *xs):
    """The sums over this rank's loci ``xs``, summed over the ranks (one
    all-reduce) when the run is sharded; the identity on one process."""
    return psum(ctx.shard, *xs)


def _suff_stats(ctx: Ctx, c, t2, heredity):
    """Per-population coalescence counts and heredity-scaled waiting
    sums over the real loci: (ksum [H], csum [H])."""
    mask_l = ctx.locus_mask[:, None]
    ksum, csum = _psum_if_sharded(
        ctx, torch.where(mask_l, c, torch.zeros_like(c)).sum(0),
        locus_sum(torch.where(mask_l, t2 / heredity[:, None],
                              torch.zeros_like(t2))))
    return ksum.to(t2.dtype), csum


def _pool_linked(ctx: Ctx, ksum, csum):
    """Linked thetas (thetamodel; init_theta_linkage stree.c:2427): the
    statistics of every owner group, summed, on each of its members.
    The members are added in index order with elementwise adds, so that
    the sum rounds alike batched or not (``index_add_`` adds with atomics
    on CUDA, in no fixed order)."""
    link = ctx.theta_link
    if link is None:
        return ksum, csum
    same = link[:, None] == link[None, :]            # [H, H] same owner
    x = torch.stack([ksum, csum])                     # [2, H]
    zero = torch.zeros_like(x)
    acc = zero
    for m in range(link.shape[0]):
        acc = acc + torch.where(same[:, m], x[:, m:m + 1], zero)
    return acc[0], acc[1]


def _corr_ln(cfg: BppConfig, state: McmcState) -> bool:
    """The correlated clock's lognormal rate prior depends on the taus
    (branch midpoints), so moves that change taus carry its delta
    (stree.c:4763-4768, prop_mixing.c:189-194)."""
    return (state.clock is not None and cfg.clock == Clock.CORRELATED
            and cfg.clock_rate_prior == 0)


def _integrated_delta(ctx: Ctx, cfg: BppConfig, state: McmcState, c_new,
                      t2_new):
    """Change of the coupled integrated-theta density when the caches move
    from the state's to (c_new, t2_new)."""
    hered = state.subst.heredity
    return (notheta.total_integrated(cfg, c_new, t2_new, hered,
                                     ctx.locus_mask, ctx.shard)
            - notheta.total_integrated(cfg, state.coal, state.t2h, hered,
                                       ctx.locus_mask, ctx.shard))


# --------------------------------------------------------------------------
# theta moves (stree.c:3957 propose_theta -> slide:3826 / gibbs:3645)
# --------------------------------------------------------------------------


def theta_move(ctx: Ctx, cfg: BppConfig, state: McmcState, gen):
    """Update every population's theta (slide or Metropolized Gibbs)."""
    sp = state.sp
    H = sp.n_nodes
    logpr_fn = make_logpr_fn(ctx)
    _, c, t2 = logpr_fn(state.gt, sp, state.subst.heredity)
    ksum, csum = _suff_stats(ctx, c, t2, state.subst.heredity)
    # linked thetas: one parameter a group, from the group's statistics
    ksum, csum = _pool_linked(ctx, ksum, csum)
    link = ctx.theta_link

    a = cfg.thetaprior.alpha
    b = cfg.thetaprior.beta
    gamma_prior = cfg.thetaprior.dist == PriorDist.GAMMA
    eps = state.finetune[FT_THETA]
    theta = sp.theta
    dt, dev = theta.dtype, theta.device

    use_slide = rng.uniform(gen, (H,), dt, dev) < cfg.theta_slide_prob
    th_slide = torch.abs(theta + eps * rng.bactrian(gen, (H,), dt, dev))
    th_slide = torch.clamp(th_slide, min=1e-300)
    if gamma_prior:
        a1, b1 = gamma_conditional_approx(a, b, ksum, csum)
    else:
        a1 = a + ksum
        b1 = b + csum
    th_gibbs = b1 / rng.gamma(gen, a1)
    th_new = torch.where(use_slide, th_slide, th_gibbs)
    if link is not None:
        # every member takes its owner's proposal; with pooled statistics
        # each member's ratio is its group's
        use_slide = use_slide[link]
        th_new = th_new[link]

    dlogpr = ksum * torch.log(theta / th_new) \
        + csum * (1.0 / theta - 1.0 / th_new)
    if gamma_prior:
        prior_ratio = (a - 1.0) * torch.log(th_new / theta) \
            - b * (th_new - theta)
    else:
        prior_ratio = (-a - 1.0) * torch.log(th_new / theta) - b * (
            1.0 / th_new - 1.0 / theta)
    prop_ratio = torch.where(
        use_slide, torch.zeros_like(theta),
        (-a1 - 1.0) * torch.log(theta / th_new)
        - b1 * (1.0 / theta - 1.0 / th_new))
    lnacc = dlogpr + prior_ratio + prop_ratio
    if not gamma_prior:
        # exact conjugate Gibbs: always accept the Gibbs draws
        lnacc = torch.where(use_slide, lnacc,
                            torch.full_like(lnacc, float("inf")))
    accept = rng.mh_accept(gen, lnacc)
    if link is not None:
        accept = accept[link]            # one decision a group
    th_fin = torch.where(accept, th_new, theta)

    # recompute the cached per-locus logpr exactly (a float32 delta
    # update random-walks away from the truth)
    new_sp = sp._replace(theta=th_fin)
    logpr, _, _ = logpr_fn(state.gt, new_sp, state.subst.heredity)
    return (state._replace(sp=new_sp, logpr=logpr),
            (H, accept.sum()))


# --------------------------------------------------------------------------
# tau rubber-band move (stree.c:5512 + 4338)
# --------------------------------------------------------------------------


def tau_move(ctx: Ctx, cfg: BppConfig, state: McmcState, gen):
    """Blocked tau rubber-band move: species inner nodes at even/odd
    depth form independent sets, so the NS-1 per-node passes collapse
    into two jointly proposed phases with one likelihood pass each."""
    sp0 = state.sp
    H = sp0.n_nodes
    NS = sp0.n_tips
    gt = state.gt
    dev = gt.age.device
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    if NS == 1:
        return state, (zero, zero)
    T = gt.n_tips
    N = gt.n_nodes
    logl_fn = make_logl_fn(ctx, cfg)
    logpr_fn = make_logpr_fn(ctx)
    gamma_tau = cfg.tauprior.dist == PriorDist.GAMMA
    a, b = cfg.tauprior.alpha, cfg.tauprior.beta
    eps = state.finetune[FT_TAU]
    nodes_idx = torch.arange(N, device=dev)[None, :]
    hidx = torch.arange(H, device=dev)
    # topology is fixed across the whole move: one species-MRCA pass
    msp = mrca_species(gt, sp0, ctx.tip_pop)
    parity = (sp0.pptable.sum(1) + 1) % 2
    is_inner_sp = hidx >= NS
    is_inner_g = (nodes_idx >= T) & (nodes_idx < T + ctx.n_seq[:, None] - 1)
    gmask = is_inner_g & ctx.locus_mask[:, None]

    age, tau = gt.age, sp0.tau
    dt = tau.dtype
    logl, logpr = state.logl, state.logpr
    integ = cfg.theta_integrated
    corr_ln = _corr_ln(cfg, state)
    coal_c, t2_c = state.coal, state.t2h
    lnrates = state.clock.lnrates if corr_ln else None
    traits = ctx.has_traits
    tlogl = state.trait.logl if traits else None
    nprop = zero
    nacc = zero
    par = sp0.parent
    par_s = par.clamp(min=0)
    lh = sp0.left.clamp(min=0)
    rh = sp0.right.clamp(min=0)
    root = sp0.root

    n_phases = 1 if NS == 2 else 2
    for phase in range(n_phases):
        prop = is_inner_sp & (parity == phase) & (tau > 0.0)
        minage = torch.maximum(tau[lh], tau[rh])
        if ctx.date_lmax is not None:
            # tip dating: tau stays above the oldest dated sample below
            # it (stree.c:5619 l_constraint check)
            minage = torch.maximum(minage, ctx.date_lmax * state.mubar)
        maxage = torch.where(par >= 0, tau[par_s],
                             torch.full_like(tau, MAXAGE_CAP))
        # a degenerate window would make reflect() divide by zero
        prop = prop & (maxage > minage)
        tnew = rng.reflect(tau + eps * rng.bactrian(gen, (H,), dt, dev),
                           minage, maxage)
        tnew = torch.where(prop, tnew, tau)
        # delta form: "maxage + maxf*(age-maxage)" cancels in float32
        dtau = tnew - tau
        tau_new = torch.where(prop, tnew, tau)
        sp_cur = sp0._replace(tau=tau)
        sp_new = sp0._replace(tau=tau_new)

        # governing proposed node per population: itself or its parent
        gov = torch.where(prop, hidx,
                          torch.where((par >= 0) & prop[par_s], par_s,
                                      torch.full_like(hidx, -1)))
        pops = lift_population(sp_cur, msp, age.clamp(0.0, BIG_AGE * 0.5))
        gov_ok = gov >= 0
        gov_s = gov.clamp(min=0)
        one = torch.ones_like(tau)
        ln_maxf = torch.log1p(dtau / torch.where(prop, tau - maxage, one))
        ln_minf = torch.log1p(dtau / torch.where(prop, tau - minage, one))
        zt = torch.zeros_like(tau)
        params = torch.stack([
            torch.where(gov_ok, minage[gov_s], zt),
            torch.where(gov_ok, maxage[gov_s], one),
            torch.where(gov_ok, tau[gov_s], torch.full_like(tau, 0.5)),
            torch.where(gov_ok, dtau[gov_s], zt),
            gov_ok.to(dt),
            torch.where(gov_ok, ln_maxf[gov_s], zt),
            torch.where(gov_ok, ln_minf[gov_s], zt),
        ], dim=-1)                                          # [H, 7]
        gp = params[pops]                                   # [L, N, 7]
        g_min, g_max, g_told, g_dt, g_gov, g_lmaxf, g_lminf = gp.unbind(-1)

        cond = gmask & (g_gov > 0.5) & (age > g_min) & (age < g_max)
        above = cond & (age >= g_told)
        below = cond & (age < g_told)
        age_new = torch.where(
            above, age + g_dt * (g_max - age) / (g_max - g_told),
            torch.where(below,
                        age + g_dt * (age - g_min) / (g_told - g_min), age))
        zg = torch.zeros_like(age)
        jac = locus_sum((torch.where(above, g_lmaxf, zg)
                         + torch.where(below, g_lminf, zg)).reshape(-1))

        gtn = gt._replace(age=age_new)
        logl_new = logl_fn(gtn, state.subst, sp_new, state.clock)
        logpr_new, c_new, t2_new = logpr_fn(gtn, sp_new,
                                            state.subst.heredity, msp=msp)
        jac, dlogl, dlogpr = _psum_if_sharded(
            ctx, jac, torch.sum(logl_new - logl), torch.sum(logpr_new - logpr))
        lnacc = jac + dlogl + dlogpr
        if integ:
            lnacc = lnacc + _integrated_delta(
                ctx, cfg, state._replace(coal=coal_c, t2h=t2_c), c_new,
                t2_new)
        # root-tau prior term (only when the root proposes this phase)
        cand = torch.sum(tau[NS:] > 0).to(dt)
        t_r, tn_r = tau[root], tau_new[root]
        t_rs = torch.clamp(t_r, min=1e-300)
        tn_rs = torch.clamp(tn_r, min=1e-300)
        if gamma_tau:
            root_term = (a - 1.0 - cand + 1.0) * torch.log(tn_rs / t_rs) \
                - b * (tn_r - t_r)
        else:
            root_term = (-a - 1.0 - cand + 1.0) * torch.log(tn_rs / t_rs) \
                - b * (1.0 / tn_rs - 1.0 / t_rs)
        lnacc = lnacc + torch.where(prop[root], root_term,
                                    torch.zeros_like(root_term))
        if corr_ln:
            lnr_new = lnprior_rates(cfg, sp_new, state.subst.mu, state.clock)
            lnacc = lnacc + _psum_if_sharded(ctx, torch.sum(lnr_new - lnrates))
        if traits:
            tl_new = _trait_eval(ctx, sp0, tau_new, state.trait.brate)
            lnacc = lnacc + torch.sum(tl_new - tlogl)

        accept = rng.mh_accept(gen, lnacc) & prop.any()
        age = torch.where(accept, age_new, age)
        tau = torch.where(accept, tau_new, tau)
        logl = torch.where(accept, logl_new, logl)
        logpr = torch.where(accept, logpr_new, logpr)
        if integ:
            coal_c = torch.where(accept, c_new, coal_c)
            t2_c = torch.where(accept, t2_new, t2_c)
        if corr_ln:
            lnrates = torch.where(accept, lnr_new, lnrates)
        if traits:
            tlogl = torch.where(accept, tl_new, tlogl)
        np_ = prop.sum()
        nprop = nprop + np_
        nacc = nacc + torch.where(accept, np_, zero)

    new_state = state._replace(
        gt=gt._replace(age=age), sp=sp0._replace(tau=tau),
        logl=logl, logpr=logpr, coal=coal_c, t2h=t2_c)
    if corr_ln:
        new_state = new_state._replace(
            clock=state.clock._replace(lnrates=lnrates))
    if traits:
        new_state = new_state._replace(
            trait=state.trait._replace(logl=tlogl))
    return new_state, (nprop, nacc)


# --------------------------------------------------------------------------
# mixing move (prop_mixing.c:275)
# --------------------------------------------------------------------------


def mixing_move(ctx: Ctx, cfg: BppConfig, state: McmcState, gen):
    """Scale all gene-node ages and taus by one factor c, refreshing the
    thetas from their conditionals at the scaled waiting times."""
    gt, sp = state.gt, state.sp
    N, T = gt.n_nodes, gt.n_tips
    NS = sp.n_tips
    dev = gt.age.device
    logl_fn = make_logl_fn(ctx, cfg)
    logpr_fn = make_logpr_fn(ctx)
    nodes_idx = torch.arange(N, device=dev)[None, :]
    a, b = cfg.thetaprior.alpha, cfg.thetaprior.beta
    gamma_prior = cfg.thetaprior.dist == PriorDist.GAMMA
    ta, tb = cfg.tauprior.alpha, cfg.tauprior.beta
    gamma_tau = cfg.tauprior.dist == PriorDist.GAMMA
    eps = state.finetune[FT_MIX]
    dt = eps.dtype

    lnc = eps * rng.bactrian(gen, (), dt, dev)
    c = torch.exp(lnc)
    # topology-only species MRCAs (a network routes by the flags instead)
    msp = None if sp.is_network else mrca_species(gt, sp, ctx.tip_pop)

    if sp.is_network:
        # only free taus are dimensions: mirrors and htau == 0 parents
        # shadow a hybridization's tau (prop_mixing.c tau_count)
        tau_count = torch.sum((sp.tau > 0) & sp.tau_free)
    elif NS > 1:
        tau_count = torch.sum(sp.tau[NS:] > 0)
    else:
        tau_count = torch.zeros((), dtype=torch.int64, device=dev)
    inner_count = _psum_if_sharded(ctx, torch.sum(torch.where(
        ctx.locus_mask, ctx.n_seq - 1, torch.zeros_like(ctx.n_seq))))
    lnacc = (tau_count + inner_count).to(dt) * lnc

    is_inner = (nodes_idx >= T) & (nodes_idx < T + ctx.n_seq[:, None] - 1)
    age_new = torch.where(is_inner, gt.age * c, gt.age)
    tau_new = torch.where(sp.tau > 0, sp.tau * c, sp.tau)

    if NS > 1:
        rt_old = sp.tau[sp.root]
        rt_new = tau_new[sp.root]
        rts = torch.clamp(rt_old, min=1e-300)
        rtn = torch.clamp(rt_new, min=1e-300)
        tcf = tau_count.to(dt)
        if gamma_tau:
            root_term = (ta - 1.0 - tcf + 1.0) * lnc - tb * (rt_new - rt_old)
        else:
            root_term = (-ta - 1.0 - tcf + 1.0) * lnc \
                - tb * (1.0 / rtn - 1.0 / rts)
        lnacc = lnacc + torch.where(rt_old > 0, root_term,
                                    torch.zeros_like(root_term))

    if cfg.theta_integrated:
        # no thetas to refresh (prop_mixing.c:339, gated on opt_est_theta)
        th_new = sp.theta
    else:
        # Gibbs-style theta refresh at the scaled waiting times
        _, cc, t2 = logpr_fn(gt, sp, state.subst.heredity, msp=msp)
        ksum, csum = _suff_stats(ctx, cc, t2, state.subst.heredity)
        # linked thetas: pooled statistics, density terms of owners only
        ksum, csum = _pool_linked(ctx, ksum, csum)
        link = ctx.theta_link
        owner = (torch.ones_like(ksum, dtype=torch.bool) if link is None
                 else link == torch.arange(len(link), device=dev))
        cstar = csum * c
        if gamma_prior:
            a1, b1 = gamma_conditional_approx(a, b, ksum, cstar)
            a1o, b1o = gamma_conditional_approx(a, b, ksum, csum)
        else:
            a1, b1 = a + ksum, b + cstar
            a1o, b1o = a + ksum, b + csum
        th_new = b1 / rng.gamma(gen, a1)
        if link is not None:
            th_new = th_new[link]
        th_old = sp.theta
        zt = torch.zeros_like(th_old)
        lnacc = lnacc + torch.sum(torch.where(
            owner, rng.log_pdf_invgamma(th_old, a1o, b1o)
            - rng.log_pdf_invgamma(th_new, a1, b1), zt))
        if gamma_prior:
            prior = (a - 1.0) * torch.log(th_new / th_old) \
                - b * (th_new - th_old)
        else:
            prior = (-a - 1.0) * torch.log(th_new / th_old) \
                - b * (1.0 / th_new - 1.0 / th_old)
        lnacc = lnacc + torch.sum(torch.where(owner, prior, zt))

    gtn = gt._replace(age=age_new)
    spn = sp._replace(tau=tau_new, theta=th_new)
    logl_new = logl_fn(gtn, state.subst, spn, state.clock)
    logpr_new, c_new, t2_new = logpr_fn(gtn, spn, state.subst.heredity,
                                        msp=msp)
    dlogl, dlogpr = _psum_if_sharded(ctx, torch.sum(logl_new - state.logl),
                                     torch.sum(logpr_new - state.logpr))
    lnacc = lnacc + dlogl
    lnacc = lnacc + dlogpr
    cand = state._replace(gt=gtn, sp=spn, logl=logl_new, logpr=logpr_new)
    if cfg.theta_integrated:
        lnacc = lnacc + _integrated_delta(ctx, cfg, state, c_new, t2_new)
        cand = cand._replace(coal=c_new, t2h=t2_new)
    if ctx.has_traits:
        # the taus scale, and the trait branch lengths with them
        # (prop_mixing.c:642-647)
        tl_new = _trait_eval(ctx, sp, tau_new, state.trait.brate)
        lnacc = lnacc + torch.sum(tl_new - state.trait.logl)
        cand = cand._replace(trait=state.trait._replace(logl=tl_new))
    if _corr_ln(cfg, state):
        lnr_new = lnprior_rates(cfg, spn, state.subst.mu, state.clock)
        lnacc = lnacc + _psum_if_sharded(
            ctx, torch.sum(lnr_new - state.clock.lnrates))
        cand = cand._replace(clock=state.clock._replace(lnrates=lnr_new))

    accept = rng.mh_accept(gen, lnacc)
    return tree_where(accept, cand, state), (1, accept.to(torch.int64))


# --------------------------------------------------------------------------
# blocked full-recompute variants of the gene-tree moves: whole
# independent sets are proposed jointly with one accept decision per
# locus (exact MH: windows come from the out-of-block state).
# --------------------------------------------------------------------------


def age_block_move(ctx: Ctx, cfg: BppConfig, state: McmcState, gen):
    """Gene-node ages, in two phases of nodes at even/odd depth."""
    gt, sp = state.gt, state.sp
    L, N, T = gt.n_loci, gt.n_nodes, gt.n_tips
    dev = gt.age.device
    nodes_idx = torch.arange(N, device=dev)[None, :]
    logl_fn = make_logl_fn(ctx, cfg)
    logpr_fn = make_logpr_fn(ctx)
    eps = state.finetune[FT_GTAGE]
    net = sp.is_network
    msp = None if net else mrca_species(gt, sp, ctx.tip_pop)
    depths = node_depths(gt)
    inner_valid = (nodes_idx >= T) & (nodes_idx < T + ctx.n_seq[:, None] - 1)

    age = gt.age
    dt = age.dtype
    logl, logpr = state.logl, state.logpr
    integ = cfg.theta_integrated
    coal_c, t2_c = state.coal, state.t2h
    hered = state.subst.heredity
    nprop = torch.zeros((), dtype=torch.int64, device=dev)
    nacc = torch.zeros((), dtype=torch.int64, device=dev)
    lc = gt.left.clamp(min=0)
    rc = gt.right.clamp(min=0)
    par_s = gt.parent.clamp(min=0)
    if not net:
        msp_l = torch.gather(msp, 1, lc)
        msp_r = torch.gather(msp, 1, rc)
    cap = torch.full_like(age, MAXAGE_CAP)

    for phase in (0, 1):
        mask = inner_valid & (depths % 2 == phase) & ctx.locus_mask[:, None]
        la = torch.gather(age, 1, lc)
        ra = torch.gather(age, 1, rc)
        if net:
            # no species-MRCA bound on a network: an age below where the
            # children's routes meet breaks route consistency, and the
            # density's -inf rejects it
            minage = torch.maximum(la, ra)
        else:
            pop_lc = lift_population(sp, msp_l, la)
            pop_rc = lift_population(sp, msp_r, ra)
            mrca_pop = sp.mrca[pop_lc, pop_rc]
            minage = torch.maximum(torch.maximum(la, ra),
                                   sp.tau[mrca_pop])
        maxage = torch.where(gt.parent >= 0, torch.gather(age, 1, par_s), cap)
        # degenerate window (float32 parent == child tie): skip the node
        mask = mask & (maxage > minage)
        tnew = rng.reflect(age + eps * rng.bactrian(gen, (L, N), dt, dev,
                                                    ctx.shard),
                           minage, maxage)
        age_new = torch.where(mask, tnew, age)
        gtn = gt._replace(age=age_new)
        logl_new = logl_fn(gtn, state.subst, sp, state.clock)
        logpr_new, c_new, t2_new = logpr_fn(gtn, sp, hered, msp=msp)
        amask = ctx.locus_mask & mask.any(1)
        lnacc = (logl_new - logl) + (logpr_new - logpr)
        if integ:
            accept = notheta.scan_accept(
                gen, cfg, lnacc, coal_c, t2_c, hered, c_new, t2_new, hered,
                amask, ctx.locus_mask, ctx.shard)
            coal_c = torch.where(accept[:, None], c_new, coal_c)
            t2_c = torch.where(accept[:, None], t2_new, t2_c)
        else:
            accept = rng.mh_accept(gen, lnacc, ctx.shard) & amask
        logpr = torch.where(accept, logpr_new, logpr)
        age = torch.where(accept[:, None], age_new, age)
        logl = torch.where(accept, logl_new, logl)
        nprop = nprop + amask.sum()
        nacc = nacc + accept.sum()

    new_state = state._replace(gt=gt._replace(age=age), logl=logl,
                               logpr=logpr, coal=coal_c, t2h=t2_c)
    return new_state, psum_counts(ctx.shard, nprop, nacc)


def _select_uniform(gen, mask, shard=None):
    """Uniformly select one True index per row of mask [L, N]:
    (index [L], count [L]); ``shard`` when the rows are loci."""
    L = mask.shape[0]
    count = mask.sum(dim=1)
    r = rng.uniform(gen, (L,), torch.float64, mask.device, shard)
    sel_rank = torch.floor(r * count).to(torch.int64)
    sel_rank = torch.minimum(sel_rank, torch.clamp(count - 1, min=0))
    mi = mask.to(torch.int64)
    cum = torch.cumsum(mi, dim=1) - mi          # rank of each True element
    hit = mask & (cum == sel_rank[:, None])
    return torch.argmax(hit.to(torch.uint8), dim=1), count


def _write(arr, lidx, row_ok, col, val):
    """In place: ``arr[l, col[l]] = val[l]`` where ``row_ok[l]``."""
    arr[lidx, col] = torch.where(row_ok, val, arr[lidx, col])


def spr_round_move(ctx: Ctx, cfg: BppConfig, state: McmcState, gen):
    """One SPR proposal per locus (pruned node chosen uniformly among
    non-root nodes), full-batch evaluation, per-locus accept."""
    gt0, sp = state.gt, state.sp
    L, N, T = gt0.n_loci, gt0.n_nodes, gt0.n_tips
    dev = gt0.age.device
    lidx = torch.arange(L, device=dev)
    nodes_idx = torch.arange(N, device=dev)[None, :]
    logl_fn = make_logl_fn(ctx, cfg)
    logpr_fn = make_logpr_fn(ctx)
    eps = state.finetune[FT_GTSPR]

    left, right, parent, age = gt0.left, gt0.right, gt0.parent, gt0.age
    dt = age.dtype
    logl, logpr = state.logl, state.logpr

    tipmask = nodes_idx[:, :T] < ctx.n_seq[:, None]
    glv = (sp.pptable[ctx.tip_pop] & tipmask[..., None]).sum(1)   # [L, H]
    depth = sp.pptable.sum(-1)                                    # [H]
    valid_nodes = (nodes_idx < ctx.n_seq[:, None]) | (
        (nodes_idx >= T) & (nodes_idx < T + ctx.n_seq[:, None] - 1))

    cand_mask = valid_nodes & (parent >= 0)
    i, _ = _select_uniform(gen, cand_mask, ctx.shard)

    net = sp.is_network
    if net:
        pops = assign_populations(gt0, sp, ctx.tip_pop)
        passes = edge_passes(gt0, sp, pops)                      # [L, N, H]
    else:
        msp, leaves = mrca_and_leaves(gt0, sp, ctx.tip_pop, ctx.n_seq)
        pops = lift_population(sp, msp, age.clamp(0.0, BIG_AGE * 0.5))

    father = parent[lidx, i]
    is_valid = (father >= 0) & ctx.locus_mask
    father_s = father.clamp(min=0)
    fleft = left[lidx, father_s]
    sibling = torch.where(fleft == i, right[lidx, father_s], fleft)

    cur_pop = pops[lidx, i]
    if net:
        # the pruned node's own age: heights no route allows reject
        # through tcount == 0 or the route-consistency indicator
        minage = age[lidx, i]
    else:
        i_leaves = leaves[lidx, i]
        cand = sp.pptable[cur_pop] & (glv > i_leaves[:, None])
        score = torch.where(cand, depth[None, :], -1)
        pop_min = torch.argmax(score, dim=1)
        minage = torch.maximum(age[lidx, i], sp.tau[pop_min])

    f_age = age[lidx, father_s]
    tnew = rng.reflect(f_age + eps * rng.bactrian(gen, (L,), dt, dev,
                                                  ctx.shard),
                       minage, MAXAGE_CAP)
    if net:
        pop_target = lift_population_net(sp, cur_pop, tnew,
                                         gt0.hpath[lidx, i])
    else:
        pop_target = lift_population(sp, cur_pop, tnew)

    page = torch.where(parent >= 0, torch.gather(age, 1, parent.clamp(min=0)),
                       torch.full_like(age, float("-inf")))
    order_root = torch.argmax(torch.where(
        valid_nodes & (nodes_idx >= T), age,
        torch.full_like(age, float("-inf"))), dim=1)
    root_age = age[lidx, order_root]
    spans = (age <= tnew[:, None]) & (tnew[:, None] < page)
    if net:
        in_pop = torch.gather(
            passes, 2, pop_target[:, None, None].expand(-1, N, 1))[..., 0]
    else:
        in_pop = sp.pptable[pops, pop_target[:, None].expand_as(pops)]
    tmask = (valid_nodes & spans & in_pop
             & (nodes_idx != i[:, None])
             & (nodes_idx != order_root[:, None]))
    above_root = tnew >= root_age
    tsel, tcount = _select_uniform(gen, tmask, ctx.shard)
    target = torch.where(above_root, order_root, tsel)
    tcount = torch.where(above_root, torch.ones_like(tcount), tcount)
    target = torch.where(target == father, sibling, target)

    f_pop = pops[lidx, father_s]
    sspans = (age <= f_age[:, None]) & (f_age[:, None] < page)
    if net:
        s_in_pop = torch.gather(
            passes, 2, f_pop[:, None, None].expand(-1, N, 1))[..., 0]
    else:
        s_in_pop = sp.pptable[pops, f_pop[:, None].expand_as(pops)]
    smask = (valid_nodes & sspans & s_in_pop
             & (nodes_idx != i[:, None]) & (nodes_idx != order_root[:, None])
             & (nodes_idx != sibling[:, None])
             & (nodes_idx != father_s[:, None]))
    father_is_root = father_s == order_root
    scount = 1 + torch.where(father_is_root, torch.zeros_like(tcount),
                             smask.sum(dim=1))

    ok = is_valid & (tcount > 0)
    do_topo = ok & (target != sibling) & (target != father_s)

    grandpa = parent[lidx, father_s]
    has_gp = grandpa >= 0
    gp_s = grandpa.clamp(min=0)

    nl, nr, np_, na = left.clone(), right.clone(), parent.clone(), age.clone()
    repl_l = do_topo & has_gp & (left[lidx, gp_s] == father_s)
    repl_r = do_topo & has_gp & (right[lidx, gp_s] == father_s)
    _write(nl, lidx, repl_l, gp_s, sibling)
    _write(nr, lidx, repl_r, gp_s, sibling)
    _write(np_, lidx, do_topo, sibling, grandpa)
    zl = torch.zeros_like(target)
    tgt0 = torch.where(do_topo, target, zl)
    tpar = torch.where(do_topo, parent[lidx, tgt0], zl)
    tpar_s = tpar.clamp(min=0)
    repl_tl = do_topo & (tpar >= 0) & (nl[lidx, tpar_s] == target)
    repl_tr = do_topo & (tpar >= 0) & (nr[lidx, tpar_s] == target)
    _write(nl, lidx, repl_tl, tpar_s, father_s)
    _write(nr, lidx, repl_tr, tpar_s, father_s)
    _write(np_, lidx, do_topo, father_s, tpar)
    # father's sibling slot takes the target
    fl = nl[lidx, father_s]
    new_fl = torch.where(fl == i, fl, target)
    fr = nr[lidx, father_s]
    new_fr = torch.where(fl == i, target, fr)
    _write(nl, lidx, do_topo, father_s, new_fl)
    _write(nr, lidx, do_topo, father_s, new_fr)
    _write(np_, lidx, do_topo, tgt0, father_s)
    # father age update (also for the no-topology-change case)
    _write(na, lidx, ok, father_s, tnew)

    gtn = GTrees(nl, nr, np_, na, gt0.hpath)
    logl_new = logl_fn(gtn, state.subst, sp, state.clock)
    logpr_new, c_new, t2_new = logpr_fn(gtn, sp, state.subst.heredity)
    dprop = torch.log(torch.clamp(tcount, min=1).to(dt)
                      / torch.clamp(scount, min=1).to(dt))
    lnacc = (logl_new - logl) + (logpr_new - logpr) + dprop
    new_state = state
    if cfg.theta_integrated:
        hered = state.subst.heredity
        accept = notheta.scan_accept(
            gen, cfg, lnacc, state.coal, state.t2h, hered, c_new, t2_new,
            hered, ok, ctx.locus_mask, ctx.shard)
        new_state = state._replace(
            coal=torch.where(accept[:, None], c_new, state.coal),
            t2h=torch.where(accept[:, None], t2_new, state.t2h))
    else:
        accept = rng.mh_accept(gen, lnacc, ctx.shard) & ok
    am = accept[:, None]
    new_state = new_state._replace(
        gt=GTrees(torch.where(am, nl, left), torch.where(am, nr, right),
                  torch.where(am, np_, parent), torch.where(am, na, age),
                  gt0.hpath),
        logl=torch.where(accept, logl_new, logl),
        logpr=torch.where(accept, logpr_new, logpr))
    return new_state, psum_counts(ctx.shard, ok.sum(), accept.sum())
