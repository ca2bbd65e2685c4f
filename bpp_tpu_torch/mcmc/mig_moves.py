"""MSC-M (isolation-with-migration) MCMC moves on fixed routes, batched
over loci (PyTorch).

Port of ``bpp_tpu/mcmc/mig_moves.py``.  Reference counterparts:

  * theta Gibbs/slide under migration     stree.c:3464 propose_theta_gibbs_im
  * migration rates: W Gibbs, Mbar and    stree.c:11627 migrate_gibbs,
    per-locus slides                      11676, 11822
  * migration-event age slide             gtree.c:5766 propose_migevent_ages
  * gene-node ages with event clamps      gtree.c:4585 (opt_migration paths)
  * simulation-based SPR                  gtree.c:9090 propose_spr_sim +
                                          8742 simulate_coalescent_mig
  * tau under migration                   stree.c:6725 propose_tau_mig
  * mixing incl. event times              prop_mixing.c:275
  * heredity scalars                      gtree.c:8214 prop_heredity
  * geneflow rjMCMC: route add/remove     stree.c:15419 stree_migration_rj,
    and direction flip                    15204 (method.c:5658-5695)

The likelihood depends on migration events only under a relaxed clock
(branch lengths are age differences otherwise), so event-only moves
accept on the density delta alone under the strict clock.  The sim-SPR
proposal draws the pruned lineage's path from the structured-coalescent
prior given the rest of the gene tree, so its acceptance is the
likelihood ratio only (gtree.c:9368).

``bpp_tpu`` walks the sim-SPR lineages in a ``lax.while_loop``; here
the walk is kernel K5 (``csrc/simwalk_kernel.cu``, one warp a locus)
on the card and :func:`simspr_walk_ref` on the CPU, both reading one
block of uniforms drawn before the walk, so the step reads nothing back
to the host.  Under ``chains = K`` (the batched step) one K5 launch walks
every chain's loci (:func:`simspr_walk`).  The coalescence rate's floor
on ``theta * heredity`` is ``rng.tiny_floor`` (``bpp_tpu``'s 1e-300 is 0
in float32, where a lineage alone in a population of theta 0 would get
rate 0 / 0).
"""

from __future__ import annotations

import torch

from ..config import BppConfig, Clock, PriorDist
from ..core import chains
from ..core.pack import chain_pass
from ..parallel.mesh import psum_counts
from ..trees import migration as mg
from ..trees.gtree import BIG_AGE, GTrees, lift_population, node_depths
from . import rng
from .gibbs import gamma_conditional_approx
from .moves import (
    MAXAGE_CAP, _psum_if_sharded, _select_uniform, _suff_stats, _write,
    locus_sum,
)
from .state import (
    FT_GTAGE, FT_LRHT, FT_MIG_AGES, FT_MIGRATES, FT_MIX, FT_TAU, Ctx,
    McmcState, make_logl_fn, tree_where,
)
from .stree_moves import _at


def make_logpr_fn_mig(ctx: Ctx, routes: mg.RouteTensors):
    """Returns logpr(gt, sp, mig, heredity) ->
    (lp [L], coal [L, H], C2 [L, H], W [L, K], mc [L, K], pops [L, N]);
    -inf at a locus whose routes or events are inconsistent."""
    def fn(gt: GTrees, sp, mig: mg.MigState, heredity):
        pops = mg.assign_populations_mig(gt, sp, ctx.tip_pop, mig,
                                         ctx.n_seq)
        coal, C2, W, mc, _ = mg.mig_stats(gt, sp, pops, mig, routes.si,
                                          routes.ti, ctx.n_seq)
        lp = mg.msc_logprob_mig(coal, C2, W, mc, sp.theta, heredity,
                                mg.eff_rates(routes, mig), on=mig.on)
        ok = mg.route_consistent_mig(gt, sp, mig, pops, ctx.n_seq)
        bad = torch.where(ctx.locus_mask,
                          torch.full_like(lp, -float("inf")),
                          torch.zeros_like(lp))
        lp = torch.where(ok & ctx.locus_mask, lp, bad)
        return lp, coal, C2, W, mc, pops

    return fn


# --------------------------------------------------------------------------
# theta under migration: the same conjugacy, statistics from the sweep
# --------------------------------------------------------------------------


def theta_move_mig(ctx: Ctx, cfg: BppConfig, routes, state: McmcState, gen):
    sp = state.sp
    H = sp.n_nodes
    hered = state.subst.heredity
    logpr_fn = make_logpr_fn_mig(ctx, routes)
    _, c, t2, _, _, _ = logpr_fn(state.gt, sp, state.mig, hered)
    ksum, csum = _suff_stats(ctx, c, t2, hered)

    a, b = cfg.thetaprior.alpha, cfg.thetaprior.beta
    gamma_prior = cfg.thetaprior.dist == PriorDist.GAMMA
    theta = sp.theta
    if gamma_prior:
        a1, b1 = gamma_conditional_approx(a, b, ksum, csum, True)
    else:
        a1, b1 = a + ksum, b + csum
    th_new = b1 / rng.gamma(gen, a1)
    if gamma_prior:
        dlogpr = ksum * torch.log(theta / th_new) \
            + csum * (1.0 / theta - 1.0 / th_new)
        prior_r = (a - 1.0) * torch.log(th_new / theta) \
            - b * (th_new - theta)
        prop_r = (-a1 - 1.0) * torch.log(theta / th_new) \
            - b1 * (1.0 / theta - 1.0 / th_new)
        accept = rng.mh_accept(gen, dlogpr + prior_r + prop_r)
    else:
        # the exact conjugate draw
        accept = torch.ones_like(theta, dtype=torch.bool)
    new_sp = sp._replace(theta=torch.where(accept, th_new, theta))
    logpr = logpr_fn(state.gt, new_sp, state.mig, hered)[0]
    return state._replace(sp=new_sp, logpr=logpr), (H, accept.sum())


# --------------------------------------------------------------------------
# migration rates (stree.c:11627 migrate_gibbs, 11676, 11822)
# --------------------------------------------------------------------------


def migrate_move(ctx: Ctx, cfg: BppConfig, routes, state: McmcState, gen):
    """M_k | rest ~ Gamma(alpha + sum_l mc_lk, beta + sum_l W_lk).

    Routes with a variable-rates shape (am > 0) keep their mean rate:
    it moves by :func:`mig_mbar_move`, the per-locus Mi by
    :func:`mig_vrates_move` (migrate_gibbs asserts !spec->am,
    stree.c:11636)."""
    logpr_fn = make_logpr_fn_mig(ctx, routes)
    _, _, _, W, mc, _ = logpr_fn(state.gt, state.sp, state.mig,
                                 state.subst.heredity)
    wsum, csum = _route_sums(ctx, W, mc)
    if state.mig.on is not None:
        # geneflow: an inactive route takes a prior draw (zeroed
        # statistics), the Carlin-Chib pseudo-prior that makes toggling a
        # route a plain within-space MH move
        csum = torch.where(state.mig.on, csum, torch.zeros_like(csum))
        wsum = torch.where(state.mig.on, wsum, torch.zeros_like(wsum))
    a1 = routes.alpha + csum
    b1 = routes.beta + wsum
    M_new = torch.clamp(rng.gamma(gen, a1) / b1, min=1e-30)
    M_new = torch.where(routes.has_am, state.mig.M, M_new)
    mig_new = state.mig._replace(M=M_new)
    logpr = logpr_fn(state.gt, state.sp, mig_new, state.subst.heredity)[0]
    K = M_new.shape[0]
    return state._replace(mig=mig_new, logpr=logpr), (K, K)


def mig_mbar_move(ctx: Ctx, cfg: BppConfig, routes, state: McmcState, gen):
    """Mean-rate slide of the variable-rate routes (migrate_mbar_slide
    stree.c:11676): Mbar_k has its Gamma(alpha, beta) prior, and
    Mi[l, k] ~ Gamma(am, am / Mbar_k) iid over loci.  The density reads
    Mi only, so there is no density term."""
    mig = state.mig
    dt, dev = mig.M.dtype, mig.M.device
    K = mig.M.shape[0]
    eps = state.finetune[FT_MIGRATES]
    lnc = eps * rng.bactrian(gen, (K,), dt, dev)
    mbar_new = mig.M * torch.exp(lnc)
    am = routes.am
    lnacc = lnc + lnc * (routes.alpha - 1.0) - (mbar_new - mig.M) * routes.beta
    bnew = am / mbar_new
    bold = am / mig.M
    n_real, misum = _psum_if_sharded(
        ctx, ctx.locus_mask.sum(), locus_sum(torch.where(
            ctx.locus_mask[:, None], mig.Mi, torch.zeros_like(mig.Mi))))
    n_real = n_real.to(dt)
    lnacc = lnacc + n_real * am * torch.log(bnew / bold) \
        - (bnew - bold) * misum
    accept = rng.mh_accept(gen, torch.where(
        routes.has_am, lnacc, torch.full_like(lnacc, -float("inf"))))
    return (state._replace(mig=mig._replace(
        M=torch.where(accept, mbar_new, mig.M))),
        (routes.has_am.sum(), accept.sum()))


def mig_vrates_move(ctx: Ctx, cfg: BppConfig, routes, state: McmcState,
                    gen):
    """Per-locus migration-rate slide (prop_mig_vrates_slide
    stree.c:11822): Mi[l, k] *= e^(eps z) under the Gamma(am, am/Mbar_k)
    prior and the per-(locus, route) density delta mc dlog(Mi) - dMi W;
    the coalescent terms do not involve the rates, so every (l, k)
    coordinate updates at once."""
    mig = state.mig
    dt, dev = mig.Mi.dtype, mig.Mi.device
    L, K = mig.Mi.shape
    logpr_fn = make_logpr_fn_mig(ctx, routes)
    _, _, _, W, mc, _ = logpr_fn(state.gt, state.sp, mig,
                                 state.subst.heredity)
    eps = state.finetune[FT_MIGRATES]
    lnc = eps * rng.bactrian(gen, (L, K), dt, dev, ctx.shard)
    mi_new = mig.Mi * torch.exp(lnc)
    am = routes.am[None, :]
    beta = am / torch.clamp(mig.M, min=1e-300)[None, :]
    lnacc = lnc + lnc * (am - 1.0) - (mi_new - mig.Mi) * beta
    lnacc = lnacc + mc * torch.log(mi_new / mig.Mi) - (mi_new - mig.Mi) * W
    has_am = routes.has_am[None, :] & ctx.locus_mask[:, None]
    accept = rng.mh_accept(gen, torch.where(
        has_am, lnacc, torch.full_like(lnacc, -float("inf"))), ctx.shard)
    mig_new = mig._replace(Mi=torch.where(accept, mi_new, mig.Mi))
    logpr = logpr_fn(state.gt, state.sp, mig_new, state.subst.heredity)[0]
    return (state._replace(mig=mig_new, logpr=logpr),
            psum_counts(ctx.shard, has_am.sum(), accept.sum()))


# --------------------------------------------------------------------------
# migration-event age slide (gtree.c:5766)
# --------------------------------------------------------------------------


def migevent_age_move(ctx: Ctx, cfg: BppConfig, routes, state: McmcState,
                      gen):
    """Sweep the event slots; each live event slides within the window
    bounded by its edge's span, its neighbours on the same edge and both
    populations' lifetimes.  Under a relaxed clock the event moves the
    boundary between two differently rated pieces of its edge, so the
    likelihood delta counts too (one pass a slot)."""
    gt, sp, mig = state.gt, state.sp, state.mig
    L, ME = mig.time.shape
    dev = gt.age.device
    logpr_fn = make_logpr_fn_mig(ctx, routes)
    relaxed = cfg.clock != Clock.GLOBAL
    logl_fn = make_logl_fn(ctx, cfg) if relaxed else None
    eps = state.finetune[FT_MIG_AGES]
    dt = eps.dtype
    lidx = torch.arange(L, device=dev)
    tau = sp.tau
    partau = mg._partau(sp, MAXAGE_CAP)
    inf = torch.full_like(mig.time, float("inf"))
    logpr, logl = state.logpr, state.logl
    nprop = torch.zeros((), dtype=torch.int64, device=dev)
    nacc = torch.zeros((), dtype=torch.int64, device=dev)
    for m in range(ME):
        live = mig.node[:, m] >= 0
        nd = mig.node[:, m].clamp(min=0)
        t = mig.time[:, m]
        e_lo = gt.age[lidx, nd]
        par = gt.parent[lidx, nd]
        e_hi = torch.where(par >= 0, gt.age[lidx, par.clamp(min=0)],
                           torch.full_like(t, MAXAGE_CAP))
        same = (mig.node == mig.node[:, m][:, None]) & (mig.node >= 0)
        prev = torch.where(same & (mig.time < t[:, None]), mig.time,
                           -inf).amax(dim=1)
        nxt = torch.where(same & (mig.time > t[:, None]), mig.time,
                          inf).amin(dim=1)
        s, d = mig.src[:, m], mig.dst[:, m]
        lo = torch.maximum(torch.maximum(e_lo, prev),
                           torch.maximum(tau[s], tau[d]))
        hi = torch.minimum(torch.minimum(e_hi, nxt),
                           torch.minimum(partau[s], partau[d]))
        ok = live & (hi > lo) & ctx.locus_mask
        tnew = rng.reflect(t + eps * rng.bactrian(gen, (L,), dt, dev,
                                                  ctx.shard),
                           lo, torch.maximum(hi, lo + 1e-300))
        tnew = torch.where(ok, tnew, t)
        time_new = mig.time.clone()
        time_new[:, m] = tnew
        mign = mig._replace(time=time_new)
        logpr_new = logpr_fn(gt, sp, mign, state.subst.heredity)[0]
        lnacc = logpr_new - logpr
        if relaxed:
            logl_new = logl_fn(gt, state.subst, sp, state.clock, mig=mign)
            lnacc = lnacc + (logl_new - logl)
        accept = rng.mh_accept(gen, lnacc, ctx.shard) & ok
        mig = mig._replace(time=torch.where(accept[:, None], time_new,
                                            mig.time))
        logpr = torch.where(accept, logpr_new, logpr)
        if relaxed:
            logl = torch.where(accept, logl_new, logl)
        nprop = nprop + ok.sum()
        nacc = nacc + accept.sum()
    return (state._replace(mig=mig, logpr=logpr, logl=logl),
            psum_counts(ctx.shard, nprop, nacc))


# --------------------------------------------------------------------------
# gene-node age phases with migration-event clamps
# --------------------------------------------------------------------------


def age_block_mig(ctx: Ctx, cfg: BppConfig, routes, state: McmcState, gen):
    """Gene-node ages in two phases of nodes at even/odd depth, each age
    clamped by its children, the last events on the child edges, the
    species MRCA of the populations above those events, its parent and
    the first event on its own edge."""
    gt, sp, mig = state.gt, state.sp, state.mig
    L, N, T = gt.n_loci, gt.n_nodes, gt.n_tips
    dev = gt.age.device
    nodes_idx = torch.arange(N, device=dev)[None, :]
    logl_fn = make_logl_fn(ctx, cfg)
    logpr_fn = make_logpr_fn_mig(ctx, routes)
    eps = state.finetune[FT_GTAGE]
    dt = eps.dtype
    depths = node_depths(gt)
    inner_valid = (nodes_idx >= T) & (nodes_idx < T + ctx.n_seq[:, None] - 1)
    lc = gt.left.clamp(min=0)
    rc = gt.right.clamp(min=0)
    hered = state.subst.heredity

    age = gt.age
    logl, logpr = state.logl, state.logpr
    nprop = torch.zeros((), dtype=torch.int64, device=dev)
    nacc = torch.zeros((), dtype=torch.int64, device=dev)

    # the last event time on every edge [L, N] (-inf if none), its dst
    # population, and the first event time (+inf if none)
    on = (mig.node >= 0)[:, None, :] & (mig.node[:, None, :]
                                        == nodes_idx[:, :, None])
    ev = mig.time[:, None, :].expand_as(on)
    ev_t = torch.where(on, ev, torch.full_like(ev, -float("inf")))
    last_t = ev_t.amax(dim=2)
    last_i = torch.argmax(ev_t, dim=2)
    has_ev = last_t > -float("inf")
    last_dst = torch.where(has_ev, torch.gather(mig.dst, 1, last_i),
                           torch.zeros_like(last_i))
    first_t = torch.where(on, ev, torch.full_like(ev, float("inf"))
                          ).amin(dim=2)
    pops0 = mg.assign_populations_mig(gt, sp, ctx.tip_pop, mig, ctx.n_seq)
    base_pop = torch.where(has_ev, last_dst, pops0)   # above the last event
    cap = torch.full_like(age, MAXAGE_CAP)

    for phase in (0, 1):
        mask = inner_valid & (depths % 2 == phase) & ctx.locus_mask[:, None]
        la = torch.gather(age, 1, lc)
        ra = torch.gather(age, 1, rc)
        low_ev = torch.maximum(torch.maximum(la, ra), torch.maximum(
            torch.gather(last_t, 1, lc), torch.gather(last_t, 1, rc)))
        low0 = torch.clamp(low_ev, min=0.0)
        pl = lift_population(sp, torch.gather(base_pop, 1, lc), low0)
        pr = lift_population(sp, torch.gather(base_pop, 1, rc), low0)
        minage = torch.maximum(low_ev, sp.tau[sp.mrca[pl, pr]])
        maxage = torch.where(gt.parent >= 0,
                             torch.gather(age, 1, gt.parent.clamp(min=0)),
                             cap)
        maxage = torch.minimum(maxage, first_t)
        tnew = rng.reflect(age + eps * rng.bactrian(gen, (L, N), dt, dev,
                                                    ctx.shard),
                           minage, torch.maximum(maxage, minage + 1e-300))
        mask_ok = mask & (maxage > minage)
        age_new = torch.where(mask_ok, tnew, age)
        gtn = gt._replace(age=age_new)
        logl_new = logl_fn(gtn, state.subst, sp, state.clock, mig=mig)
        logpr_new = logpr_fn(gtn, sp, mig, hered)[0]
        lnacc = (logl_new - logl) + (logpr_new - logpr)
        amask = ctx.locus_mask & mask_ok.any(1)
        accept = rng.mh_accept(gen, lnacc, ctx.shard) & amask
        age = torch.where(accept[:, None], age_new, age)
        logl = torch.where(accept, logl_new, logl)
        logpr = torch.where(accept, logpr_new, logpr)
        nprop = nprop + amask.sum()
        nacc = nacc + accept.sum()

    return (state._replace(gt=gt._replace(age=age), logl=logl, logpr=logpr),
            psum_counts(ctx.shard, nprop, nacc))


# --------------------------------------------------------------------------
# tau rubber band under migration (stree.c:6725 propose_tau_mig)
# --------------------------------------------------------------------------


def tau_move_mig(ctx: Ctx, cfg: BppConfig, routes, state: McmcState, gen):
    """Blocked tau rubber band under migration: the parity-blocked
    piecewise-linear remap of ``moves.tau_move``, extended to event
    times.  Every gene-node age and event time inside a governed
    population's (minage, maxage) window moves with the window's map
    (events by their source population, the one the migrating lineage
    occupies below the event).  The map is a bijection, so MH needs the
    summed log-slopes only; configurations the remap strands reject
    through the density's validity indicator."""
    sp0 = state.sp
    H = sp0.n_nodes
    NS = sp0.n_tips
    gt = state.gt
    dev = gt.age.device
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    if NS == 1:
        return state, (zero, zero)
    T, N = gt.n_tips, gt.n_nodes
    logpr_fn = make_logpr_fn_mig(ctx, routes)
    logl_fn = make_logl_fn(ctx, cfg)
    gamma_tau = cfg.tauprior.dist == PriorDist.GAMMA
    a, b = cfg.tauprior.alpha, cfg.tauprior.beta
    eps = state.finetune[FT_TAU]
    nodes_idx = torch.arange(N, device=dev)[None, :]
    hidx = torch.arange(H, device=dev)
    parity = (sp0.pptable.sum(1) + 1) % 2
    is_inner_sp = hidx >= NS
    is_inner_g = (nodes_idx >= T) & (nodes_idx < T + ctx.n_seq[:, None] - 1)
    gmask = is_inner_g & ctx.locus_mask[:, None]
    ev_live0 = (state.mig.node >= 0) & ctx.locus_mask[:, None]

    age, tau, ev_time = gt.age, sp0.tau, state.mig.time
    dt = tau.dtype
    logl, logpr = state.logl, state.logpr
    traits = ctx.trait_fn is not None
    tlogl = state.trait.logl if traits else None
    nprop = zero
    nacc = zero
    par = sp0.parent
    par_s = par.clamp(min=0)
    lh = sp0.left.clamp(min=0)
    rh = sp0.right.clamp(min=0)
    root = sp0.root

    for phase in range(1 if NS == 2 else 2):
        prop = is_inner_sp & (parity == phase) & (tau > 0.0)
        minage = torch.maximum(tau[lh], tau[rh])
        maxage = torch.where(par >= 0, tau[par_s],
                             torch.full_like(tau, MAXAGE_CAP))
        prop = prop & (maxage > minage)
        tnew = rng.reflect(tau + eps * rng.bactrian(gen, (H,), dt, dev),
                           minage, maxage)
        tau_new = torch.where(prop, tnew, tau)
        dtau = tau_new - tau
        sp_cur = sp0._replace(tau=tau)
        sp_new = sp0._replace(tau=tau_new)

        # governing proposed node per population: itself or its parent
        gov = torch.where(prop, hidx,
                          torch.where((par >= 0) & prop[par_s], par_s,
                                      torch.full_like(hidx, -1)))
        pops = mg.assign_populations_mig(
            gt._replace(age=age), sp_cur, ctx.tip_pop,
            state.mig._replace(time=ev_time), ctx.n_seq)
        gov_ok = gov >= 0
        gov_s = gov.clamp(min=0)
        one = torch.ones_like(tau)
        zt = torch.zeros_like(tau)
        ln_maxf = torch.log1p(dtau / torch.where(prop, tau - maxage, one))
        ln_minf = torch.log1p(dtau / torch.where(prop, tau - minage, one))
        params = torch.stack([
            torch.where(gov_ok, minage[gov_s], zt),
            torch.where(gov_ok, maxage[gov_s], one),
            torch.where(gov_ok, tau[gov_s], torch.full_like(tau, 0.5)),
            torch.where(gov_ok, dtau[gov_s], zt),
            gov_ok.to(dt),
            torch.where(gov_ok, ln_maxf[gov_s], zt),
            torch.where(gov_ok, ln_minf[gov_s], zt),
        ], dim=-1)                                          # [H, 7]

        def remap(times, popidx, live):
            """The piecewise rubber map and each item's log-slope."""
            g_min, g_max, g_told, g_dt, g_gov, g_lmaxf, g_lminf = \
                params[popidx].unbind(-1)
            cond = live & (g_gov > 0.5) & (times > g_min) & (times < g_max)
            above = cond & (times >= g_told)
            below = cond & (times < g_told)
            t_new = torch.where(
                above, times + g_dt * (g_max - times) / (g_max - g_told),
                torch.where(below,
                            times + g_dt * (times - g_min) / (g_told - g_min),
                            times))
            z = torch.zeros_like(times)
            return t_new, (torch.where(above, g_lmaxf, z)
                           + torch.where(below, g_lminf, z))

        age_new, jac_a = remap(age, pops, gmask)
        # events by their source population; empty slots carry BIG_AGE,
        # outside every window, and are masked by ev_live0 too
        ev_new, jac_e = remap(ev_time, state.mig.src, ev_live0)
        gtn = gt._replace(age=age_new)
        mign = state.mig._replace(time=ev_new)
        logpr_new = logpr_fn(gtn, sp_new, mign, state.subst.heredity)[0]
        logl_new = logl_fn(gtn, state.subst, sp_new, state.clock, mig=mign)
        jac, dlogpr, dlogl = _psum_if_sharded(
            ctx, locus_sum(jac_a.reshape(-1)) + locus_sum(jac_e.reshape(-1)),
            torch.sum(logpr_new - logpr), torch.sum(logl_new - logl))
        lnacc = jac + dlogpr + dlogl
        if traits:
            # the trait likelihood sees the species taus only
            # (stree.c:5675): the same delta as the plain tau move
            tl_new = ctx.trait_fn(tau_new, state.trait.brate)
            lnacc = lnacc + torch.sum(tl_new - tlogl)

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

        accept = rng.mh_accept(gen, lnacc) & prop.any()
        age = torch.where(accept, age_new, age)
        ev_time = torch.where(accept, ev_new, ev_time)
        tau = torch.where(accept, tau_new, tau)
        logl = torch.where(accept, logl_new, logl)
        logpr = torch.where(accept, logpr_new, logpr)
        if traits:
            tlogl = torch.where(accept, tl_new, tlogl)
        np_ = prop.sum()
        nprop = nprop + np_
        nacc = nacc + torch.where(accept, np_, zero)

    out = state._replace(gt=gt._replace(age=age), sp=sp0._replace(tau=tau),
                         mig=state.mig._replace(time=ev_time),
                         logl=logl, logpr=logpr)
    if traits:
        out = out._replace(trait=state.trait._replace(logl=tlogl))
    return out, (nprop, nacc)


# --------------------------------------------------------------------------
# mixing with event times (prop_mixing.c:275, migration Jacobian :319-327)
# --------------------------------------------------------------------------


def mixing_mig(ctx: Ctx, cfg: BppConfig, routes, state: McmcState, gen):
    """Scale every gene-node age, tau and event time by one factor c."""
    gt, sp, mig = state.gt, state.sp, state.mig
    N, T = gt.n_nodes, gt.n_tips
    NS = sp.n_tips
    dev = gt.age.device
    logl_fn = make_logl_fn(ctx, cfg)
    logpr_fn = make_logpr_fn_mig(ctx, routes)
    nodes_idx = torch.arange(N, device=dev)[None, :]
    ta, tb = cfg.tauprior.alpha, cfg.tauprior.beta
    eps = state.finetune[FT_MIX]
    dt = eps.dtype

    lnc = eps * rng.bactrian(gen, (), dt, dev)
    c = torch.exp(lnc)
    tau_count = torch.sum(sp.tau[NS:] > 0)
    live = mig.node >= 0
    inner_count, ev_count = _psum_if_sharded(
        ctx, torch.sum(torch.where(ctx.locus_mask, ctx.n_seq - 1,
                                   torch.zeros_like(ctx.n_seq))),
        torch.sum(ctx.locus_mask[:, None] & live))
    lnacc = (tau_count + inner_count + ev_count).to(dt) * lnc

    is_inner = (nodes_idx >= T) & (nodes_idx < T + ctx.n_seq[:, None] - 1)
    age_new = torch.where(is_inner, gt.age * c, gt.age)
    tau_new = torch.where(sp.tau > 0, sp.tau * c, sp.tau)
    time_new = torch.where(live, mig.time * c, mig.time)

    rt_old = sp.tau[sp.root]
    rt_new = tau_new[sp.root]
    tcf = tau_count.to(dt)
    if cfg.tauprior.dist == PriorDist.GAMMA:
        root_term = (ta - 1.0 - tcf + 1.0) * lnc - tb * (rt_new - rt_old)
    else:
        root_term = (-ta - 1.0 - tcf + 1.0) * lnc \
            - tb * (1.0 / torch.clamp(rt_new, min=1e-300)
                    - 1.0 / torch.clamp(rt_old, min=1e-300))
    lnacc = lnacc + torch.where(rt_old > 0, root_term,
                                torch.zeros_like(root_term))

    gtn = gt._replace(age=age_new)
    mign = mig._replace(time=time_new)
    spn = sp._replace(tau=tau_new)
    logl_new = logl_fn(gtn, state.subst, spn, state.clock, mig=mign)
    logpr_new = logpr_fn(gtn, spn, mign, state.subst.heredity)[0]
    dlogl, dlogpr = _psum_if_sharded(ctx, torch.sum(logl_new - state.logl),
                                     torch.sum(logpr_new - state.logpr))
    lnacc = lnacc + dlogl + dlogpr
    cand = state._replace(gt=gtn, sp=spn, mig=mign, logl=logl_new,
                          logpr=logpr_new)
    if ctx.trait_fn is not None:
        # the taus scale, and the trait branch lengths with them
        tl_new = ctx.trait_fn(tau_new, state.trait.brate)
        lnacc = lnacc + torch.sum(tl_new - state.trait.logl)
        cand = cand._replace(trait=state.trait._replace(logl=tl_new))
    accept = rng.mh_accept(gen, lnacc)
    return tree_where(accept, cand, state), (1, accept.to(torch.int64))


# --------------------------------------------------------------------------
# geneflow rjMCMC: route add/remove and direction flip (stree.c:15419
# stree_migration_rj, the flip wrapper :15204, method.c:5658-5695)
# --------------------------------------------------------------------------
#
# ``bpp_tpu``'s redesign, kept: the parameter space is saturated (Carlin &
# Chib).  Every candidate route keeps a rate; an inactive route's rate
# follows its prior (migrate_move draws it with zeroed statistics), so
# toggling a route is a within-space MH move whose pseudo-prior terms
# cancel, as the reference's prior-matched draw does.  Gene trees are not
# modified: a route with events on it cannot be removed or flipped.  The
# count Hastings uses the exact per-state counts of feasible routes.


def _route_sums(ctx: Ctx, W, mc):
    """(sum_l W_lk, sum_l mc_lk) over the real loci: [K] each."""
    mask_l = ctx.locus_mask[:, None]
    return _psum_if_sharded(
        ctx, locus_sum(torch.where(mask_l, W, torch.zeros_like(W))),
        torch.where(mask_l, mc, torch.zeros_like(mc)).sum(0))


def _route_overlap(routes, sp):
    """[K] bool: the source's and the target's time intervals overlap
    (select_migpair stree.c:15275)."""
    tau = sp.tau
    partau = torch.where(sp.parent >= 0, tau[sp.parent.clamp(min=0)],
                         torch.full_like(tau, float("inf")))
    si, ti = routes.si, routes.ti
    return (torch.maximum(tau[si], tau[ti])
            < torch.minimum(partau[si], partau[ti]))


def _pick(gen, mask):
    """(index, count): a uniform choice among the True entries of mask
    [K] (index 0 when there is none)."""
    idx, count = _select_uniform(gen, mask[None, :])
    return idx[0], count[0]


def geneflow_rj_move(ctx: Ctx, cfg: BppConfig, routes, state: McmcState,
                     gen):
    """Toggle one route's activation: append or remove by a fair coin,
    among the feasible routes only (append: an inactive route whose
    populations coexist; remove: an active one without events).  Routes
    of variable rates (am > 0) are frozen."""
    mig, sp = state.mig, state.sp
    logpr_fn = make_logpr_fn_mig(ctx, routes)
    _, _, _, W, mc, _ = logpr_fn(state.gt, sp, mig, state.subst.heredity)
    wsum, mcsum = _route_sums(ctx, W, mc)
    dt = wsum.dtype
    on = mig.on
    ov = _route_overlap(routes, sp)
    do_append = rng.uniform(gen, (), dt, wsum.device) < 0.5
    avail = ov & ~on
    n_avail = avail.sum()
    n_act = on.sum()
    k, _ = _pick(gen, torch.where(do_append, avail, on))

    # density delta: -+ M_k sum_l W_lk (an appended route has no events
    # yet, and a route with events is never removed)
    dW = _at(mig.M, k) * _at(wsum, k)
    lnacc = torch.where(do_append, -dW, dW)
    # exact count Hastings: append picks 1 / n_avail, its reverse removal
    # 1 / (n_act + 1); removal picks 1 / n_act, its reverse 1 / n_avail
    # after it
    n_avail_after = n_avail + _at(ov, k).to(n_avail.dtype)
    one = torch.ones((), dtype=dt, device=wsum.device)
    lnacc = lnacc + torch.where(
        do_append,
        torch.log(torch.maximum(n_avail.to(dt), one) / (n_act.to(dt) + 1.0)),
        torch.log(torch.maximum(n_act.to(dt), one)
                  / torch.maximum(n_avail_after.to(dt), one)))
    feasible = torch.where(do_append, n_avail > 0,
                           (n_act > 0) & (_at(mcsum, k) == 0) & _at(ov, k))
    feasible = feasible & ~_at(routes.has_am, k)
    accept = rng.mh_accept(gen, torch.where(
        feasible, lnacc, torch.full_like(lnacc, -float("inf"))))
    on_new = on.scatter(0, k[None], torch.where(accept, do_append,
                                                _at(on, k))[None])
    mig_new = mig._replace(on=on_new)
    logpr_new = logpr_fn(state.gt, sp, mig_new, state.subst.heredity)[0]
    return (state._replace(mig=mig_new,
                           logpr=torch.where(accept, logpr_new, state.logpr)),
            (1, accept.to(torch.int64)))


def geneflow_flip_move(ctx: Ctx, cfg: BppConfig, routes, state: McmcState,
                       gen):
    """Flip one route's direction s -> t to t -> s, carrying its rate over
    (stree_migration_flip_wrapper stree.c:15204; the candidates are the
    active routes whose reverse is inactive, :15225-15232)."""
    mig, sp = state.mig, state.sp
    logpr_fn = make_logpr_fn_mig(ctx, routes)
    _, _, _, W, mc, _ = logpr_fn(state.gt, sp, mig, state.subst.heredity)
    wsum, mcsum = _route_sums(ctx, W, mc)
    on = mig.on
    rev = routes.rev
    has_rev = rev >= 0
    rev_s = rev.clamp(min=0)
    am0 = ~routes.has_am

    def flippable(on):
        return on & has_rev & ~on[rev_s] & am0 & am0[rev_s]

    k, n_flip = _pick(gen, flippable(on))
    r = _at(rev_s, k)
    Mk, Mr = _at(mig.M, k), _at(mig.M, r)
    # deactivate k, activate r, and swap the rate slots so that the
    # active rate carries over (migspec_flip keeps spec->M)
    idx = torch.stack([k, r])
    # [False, True] made on the device: a host tensor would be a
    # pageable copy, which a captured step cannot hold
    on_new = on.scatter(0, idx, torch.arange(2, device=on.device) == 1)
    M_new = mig.M.scatter(0, idx, torch.stack([Mr, Mk]))
    # density delta: k's exposure leaves, r's (at rate Mk) enters; the
    # pseudo-prior terms of the swapped values (the slots may carry
    # different priors)
    ak, bk = _at(routes.alpha, k), _at(routes.beta, k)
    ar, br = _at(routes.alpha, r), _at(routes.beta, r)
    lpg = rng.log_pdf_gamma
    lnacc = Mk * _at(wsum, k) - Mk * _at(wsum, r) \
        + (lpg(Mk, ar, br) + lpg(Mr, ak, bk)
           - lpg(Mk, ak, bk) - lpg(Mr, ar, br))
    # the reverse selection: the flippable set after the flip
    one = torch.ones((), dtype=wsum.dtype, device=wsum.device)
    n_after = flippable(on_new).sum()
    lnacc = lnacc + torch.log(torch.maximum(n_flip.to(one.dtype), one)
                              / torch.maximum(n_after.to(one.dtype), one))
    feasible = (n_flip > 0) & (_at(mcsum, k) == 0)
    accept = rng.mh_accept(gen, torch.where(
        feasible, lnacc, torch.full_like(lnacc, -float("inf"))))
    mig_new = mig._replace(on=torch.where(accept, on_new, on),
                           M=torch.where(accept, M_new, mig.M))
    logpr_new = logpr_fn(state.gt, sp, mig_new, state.subst.heredity)[0]
    return (state._replace(mig=mig_new,
                           logpr=torch.where(accept, logpr_new, state.logpr)),
            (1, accept.to(torch.int64)))


# --------------------------------------------------------------------------
# simulation-based SPR (gtree.c:9090 propose_spr_sim +
# 8742 simulate_coalescent_mig): prune one lineage a locus, drop its
# migration events, simulate its path again under the structured
# coalescent given the rest of the gene tree, and reattach it to a
# uniformly chosen contemporary lineage.  The proposal density is the
# MSC-M prior of the new path, so lnacceptance = dlogl.
# --------------------------------------------------------------------------


def _sim_rate(n, theta_p, heredity, mrs):
    """The walking lineage's coalescence rate 2 n / (theta heredity) and
    its total rate with the migration rate ``mrs``.  The floor on
    ``theta * heredity`` is ``rng.tiny_floor``: where ``bpp_tpu``'s 1e-300
    is 0 (float32), a lineage alone (n = 0) in a population of theta 0
    would get the rate 0 / 0 and never migrate."""
    th = torch.clamp(theta_p * heredity, min=rng.tiny_floor(theta_p.dtype))
    crate = 2.0 * n.to(th.dtype) / th
    return crate, crate + mrs


def simspr_walk_ref(t_lo, t_hi, pop_lo, live_e, pptable, tau, partau_f,
                    theta, parent, si, ti, d_lo, d_hi, route_M, heredity, t0,
                    p0, is_valid, unif, ME: int, margin=None, steps=None):
    """The sim-SPR walk of every locus in torch ops: the plain version of
    kernel K5 (``bpp_tpu``'s ``while_loop``, mig_moves.py:765).

    The rest of the gene tree is its sub-edges ``t_lo``, ``t_hi``,
    ``pop_lo``, ``live_e`` [L, E]; the species tree ``pptable`` [H, H],
    ``tau``, ``partau_f`` (parents' taus, the root's finite),
    ``theta``, ``parent`` [H]; the routes ``si``, ``ti``, their sources'
    lifetimes ``d_lo``, ``d_hi`` [K] and rates ``route_M`` [L, K];
    ``heredity`` [L].  Each locus's lineage starts at ``t0`` in ``p0``
    where ``is_valid``.  Step s reads the uniforms ``unif[:, s]`` [3, L]:
    the waiting time is -log1p(-u0) / rate, the event a migration when u1
    x rate < the migration rate, the donor the first route whose
    cumulative rate exceeds u2 x the total.  Returns (t, p, done, fail,
    nt, ns, nd, nn): the end of each walk, its events (time, source and
    destination population) [L, ME] and their count.  A lineage that is
    done or failed takes no more steps, so the loop stops once every
    lineage is (a host read a step: this version runs on the CPU and in
    the card's comparisons).  ``margin`` (a tensor [L]), when given,
    receives each locus's least relative margin over its decisions (the
    event against the next boundary, its kind, its donor): a locus above
    1e-6 decides alike in float32 whatever the order of its sums.
    ``steps`` (an int64 tensor [L]), when given, receives the steps each
    locus took."""
    L, E = t_lo.shape
    dtype, dev = t_lo.dtype, t_lo.device
    lidx = torch.arange(L, device=dev)
    big = mg._FINITE_BIG
    anc_e = pptable[pop_lo] & live_e[..., None]           # [L, E, H]
    t, p = t0, p0
    done = torch.zeros(L, dtype=torch.bool, device=dev)
    fail = torch.zeros_like(done)
    nt = torch.full((L, ME), BIG_AGE, dtype=dtype, device=dev)
    ns = torch.zeros((L, ME), dtype=torch.int64, device=dev)
    nd = torch.zeros_like(ns)
    nn = torch.zeros(L, dtype=torch.int64, device=dev)
    inf = torch.full_like(t, float("inf"))
    if margin is not None:
        margin.fill_(float("inf"))
    if steps is not None:
        steps.zero_()
    for s in range(unif.shape[1]):
        act = ~done & ~fail & is_valid
        if not bool(act.any()):
            break
        if steps is not None:
            steps.add_(act.to(torch.int64))
        ph = torch.gather(anc_e, 2, p[:, None, None].expand(L, E, 1))[..., 0]
        lo = torch.maximum(t_lo, tau[p][:, None])
        hi = torch.minimum(t_hi, partau_f[p][:, None])
        n = (ph & (lo <= t[:, None]) & (t[:, None] < hi)).sum(1)
        # the next boundary time (> t): a lineage's start or end in p,
        # p's end, a donor's birth or death
        pts = torch.cat([lo, hi], dim=1)                  # [L, 2E]
        pm = torch.cat([ph, ph], dim=1)
        nb = torch.where(pm & (pts > t[:, None]), pts,
                         torch.full_like(pts, big)).amin(dim=1)
        nb = torch.minimum(nb, partau_f[p])
        don = (ti[None, :] == p[:, None])[..., None]     # [L, K, 1]
        dpts = torch.stack([d_lo, d_hi], dim=1)[None].expand(L, -1, -1)
        dpts = torch.where(don & (dpts > t[:, None, None]), dpts,
                           torch.full_like(dpts, big))
        nb = torch.minimum(nb, dpts.amin(dim=(1, 2)))
        alive = (d_lo[None, :] <= t[:, None]) & (t[:, None] < d_hi[None, :])
        route_ok = (ti[None, :] == p[:, None]) & alive
        w = torch.where(route_ok, route_M, torch.zeros_like(route_M))
        cum = torch.cumsum(w, dim=1)
        mrs = cum[:, -1]
        _, rate = _sim_rate(n, theta[p], heredity, mrs)
        delta = torch.where(rate > 0, -torch.log1p(-unif[0, s]) / rate, inf)
        t_ev = t + delta
        hit = t_ev < nb
        u = unif[1, s] * rate
        is_coal = hit & (u >= mrs)
        is_mig = hit & (u < mrs)
        # the donor route: categorical over the live routes' rates
        r = unif[2, s] * torch.clamp(mrs, min=1e-300)
        dpick = si[torch.argmax((cum > r[:, None]).to(torch.uint8), dim=1)]
        if margin is not None:
            rel = torch.where(hit, (nb - t_ev).abs() / nb.abs(),
                              (t_ev - nb).abs() / nb.abs())
            rel = torch.minimum(rel, torch.where(
                hit, (u - mrs).abs() / rate, inf))
            rel = torch.minimum(rel, torch.where(
                is_mig, ((cum - r[:, None]).abs()
                         / torch.clamp(mrs, min=1e-300)[:, None]).amin(1),
                inf))
            margin.copy_(torch.where(act, torch.minimum(margin, rel), margin))
        # record the migration event
        can_rec = is_mig & act & (nn < ME)
        fail = fail | (is_mig & act & (nn >= ME))
        slot = nn.clamp(max=ME - 1)
        _write(nt, lidx, can_rec, slot, t_ev)
        _write(ns, lidx, can_rec, slot, p)
        _write(nd, lidx, can_rec, slot, dpick)
        nn = nn + can_rec.to(torch.int64)
        # a boundary crossing at the population's end lifts to its
        # parent
        p_next = torch.where(is_mig & act, dpick, p)
        at_end = ~hit & (nb >= partau_f[p]) & act
        p_next = torch.where(at_end, parent[p].clamp(min=0), p_next)
        t = torch.where(act, torch.where(hit, t_ev, nb), t)
        p = torch.where(act, p_next, p)
        done = done | (is_coal & act)
    return t, p, done, fail, nt, ns, nd, nn


# the walk's arguments in order; all but the route table (si, ti) are a
# chain's own under chains = K
WALK_ARGS = ("t_lo", "t_hi", "pop_lo", "live_e", "pptable", "tau", "partau_f",
             "theta", "parent", "si", "ti", "d_lo", "d_hi", "route_M",
             "heredity", "t0", "p0", "is_valid", "unif")
WALK_PER_CHAIN = tuple(a for a in WALK_ARGS if a not in ("si", "ti"))


def simspr_walk(t_lo, t_hi, pop_lo, live_e, pptable, tau, partau_f, theta,
                parent, si, ti, d_lo, d_hi, route_M, heredity, t0, p0,
                is_valid, unif, ME: int):
    """The sim-SPR walk (arguments and result as
    :func:`simspr_walk_ref`) through :func:`simspr_walk_chains`.  Inside
    the batched step of ``chains = K`` (``torch.func.vmap`` over the
    chains) the K chains' walks go to one call (``pack.chain_pass``): one
    K5 launch over the chains."""
    args = (t_lo, t_hi, pop_lo, live_e, pptable, tau, partau_f, theta,
            parent, si, ti, d_lo, d_hi, route_M, heredity, t0, p0, is_valid,
            unif)
    return chain_pass(simspr_walk_chains, dict(zip(WALK_ARGS, args)),
                      per_chain=WALK_PER_CHAIN, ME=ME)


def simspr_walk_chains(t_lo, t_hi, pop_lo, live_e, pptable, tau, partau_f,
                       theta, parent, si, ti, d_lo, d_hi, route_M, heredity,
                       t0, p0, is_valid, unif, ME: int):
    """The sim-SPR walk of one chain (arguments as :func:`simspr_walk_ref`)
    or of K chains (the arguments of ``WALK_PER_CHAIN`` with a leading
    chain axis, ``t_lo [K, L, E]`` ..., the outputs likewise): on CUDA
    tensors kernel K5 (``csrc/simwalk_kernel.cu``, one warp a locus and
    one launch over the chains, no host read), on CPU tensors the plain
    version, once a chain (its host read cannot be batched)."""
    args = (t_lo, t_hi, pop_lo, live_e, pptable, tau, partau_f, theta,
            parent, si, ti, d_lo, d_hi, route_M, heredity, t0, p0, is_valid,
            unif)
    if t_lo.device.type == "cuda":
        return chains.launch_simwalk(*args, ME, mg._FINITE_BIG,
                                     rng.tiny_floor(t_lo.dtype))
    if t_lo.dim() == 3:
        outs = [simspr_walk_ref(*(a[k] if n in WALK_PER_CHAIN else a
                                  for n, a in zip(WALK_ARGS, args)), ME)
                for k in range(t_lo.shape[0])]
        return tuple(torch.stack(x) for x in zip(*outs))
    return simspr_walk_ref(*args, ME)


def spr_sim_move(ctx: Ctx, cfg: BppConfig, routes, state: McmcState, gen,
                 max_steps: int | None = None):
    gt0, sp, mig0 = state.gt, state.sp, state.mig
    L, N, T = gt0.n_loci, gt0.n_nodes, gt0.n_tips
    H = sp.n_nodes
    ME = mig0.cap
    K = mig0.M.shape[0]
    dtype = gt0.age.dtype
    dev = gt0.age.device
    lidx = torch.arange(L, device=dev)
    nodes_idx = torch.arange(N, device=dev)[None, :]
    logl_fn = make_logl_fn(ctx, cfg)
    logpr_fn = make_logpr_fn_mig(ctx, routes)
    si, ti = routes.si, routes.ti
    tau = sp.tau
    partau_f = mg._partau(sp, mg._FINITE_BIG)
    if max_steps is None:
        max_steps = 2 * (N + ME) + 2 * H + 2 * K + 8
    heredity = state.subst.heredity

    # --- the pruned node of every locus ---------------------------------------
    valid_nodes = (nodes_idx < ctx.n_seq[:, None]) | (
        (nodes_idx >= T) & (nodes_idx < T + ctx.n_seq[:, None] - 1))
    i, _ = _select_uniform(gen, valid_nodes & (gt0.parent >= 0), ctx.shard)
    is_valid = (gt0.parent[lidx, i] >= 0) & ctx.locus_mask
    father = gt0.parent[lidx, i].clamp(min=0)
    fleft = gt0.left[lidx, father]
    sibling = torch.where(fleft == i, gt0.right[lidx, father], fleft)
    grandpa = gt0.parent[lidx, father]
    gp_s = grandpa.clamp(min=0)

    # --- prune ----------------------------------------------------------------
    pl, pr, pp = gt0.left.clone(), gt0.right.clone(), gt0.parent.clone()
    repl_l = is_valid & (grandpa >= 0) & (gt0.left[lidx, gp_s] == father)
    repl_r = is_valid & (grandpa >= 0) & (gt0.right[lidx, gp_s] == father)
    _write(pl, lidx, repl_l, gp_s, sibling)
    _write(pr, lidx, repl_r, gp_s, sibling)
    _write(pp, lidx, is_valid, sibling, grandpa)   # -1 when father was root
    _write(pp, lidx, is_valid, father, torch.full_like(father, -1))
    gt_p = GTrees(pl, pr, pp, gt0.age, gt0.hpath)

    # events: the father's edge's go to the sibling's, the pruned edge's go
    on_father = (mig0.node == father[:, None]) & is_valid[:, None]
    on_i = (mig0.node == i[:, None]) & is_valid[:, None]
    node_p = torch.where(on_father, sibling[:, None], mig0.node)
    node_p = torch.where(on_i, torch.full_like(node_p, -1), node_p)
    time_p = torch.where(on_i, torch.full_like(mig0.time, BIG_AGE),
                         mig0.time)
    mig_p = mig0._replace(node=node_p, time=time_p)

    # the pruned lineage starts in node i's own population
    pops_p = mg.assign_populations_mig(gt_p, sp, ctx.tip_pop, mig_p,
                                       ctx.n_seq)

    # --- the rest of the tree's sub-edges (i's and father's edges out) --------
    t_lo, t_hi, pop_lo, live_e = mg._subedges(
        gt_p, mig_p, pops_p, ctx.n_seq, exclude=torch.stack([i, father], 1),
        include_root_edge=True)
    E = t_lo.shape[1]
    route_M = mg.eff_rates(routes, mig0)                  # [L, K]
    d_lo = tau[si]
    d_hi = partau_f[si]

    # --- walk the pruned lineage up until it coalesces -------------------------
    # the walk's draws, made before it: three uniforms a step and a locus
    unif = rng.uniform_loci_last(gen, (3, max_steps), L, dtype, dev,
                                 ctx.shard)
    t_new, p, done, fail, nt, ns, nd, nn = simspr_walk(
        t_lo, t_hi, pop_lo, live_e, sp.pptable, tau, partau_f, sp.theta,
        sp.parent, si, ti, d_lo, d_hi, route_M, heredity,
        gt0.age[lidx, i], pops_p[lidx, i], is_valid, unif, ME)
    fail = fail | ~done

    # --- the target edge, uniform among the lineages there ---------------------
    ph = sp.pptable[pop_lo, p[:, None].expand(L, E)] & live_e
    lo = torch.maximum(t_lo, tau[p][:, None])
    hi = torch.minimum(t_hi, partau_f[p][:, None])
    inside = ph & (lo <= t_new[:, None]) & (t_new[:, None] < hi)
    esel, ecount = _select_uniform(gen, inside, ctx.shard)
    fail = fail | (ecount < 1)
    target = torch.where(esel < N, esel,
                         mig_p.node[lidx, (esel - N).clamp(min=0)])
    target = target.clamp(min=0)

    # --- regraft ----------------------------------------------------------------
    ok = is_valid & ~fail
    nl, nr, np_ = pl.clone(), pr.clone(), pp.clone()
    na = gt0.age.clone()
    tpar = pp[lidx, target]
    tpar_s = tpar.clamp(min=0)
    repl_tl = ok & (tpar >= 0) & (pl[lidx, tpar_s] == target)
    repl_tr = ok & (tpar >= 0) & (pr[lidx, tpar_s] == target)
    _write(nl, lidx, repl_tl, tpar_s, father)
    _write(nr, lidx, repl_tr, tpar_s, father)
    _write(np_, lidx, ok, father, tpar)
    _write(nl, lidx, ok, father, i)
    _write(nr, lidx, ok, father, target)
    _write(np_, lidx, ok, target, father)
    _write(np_, lidx, ok, i, father)
    _write(na, lidx, ok, father, t_new)
    gt_n = GTrees(nl, nr, np_, na, gt0.hpath)

    # events on the target's edge above t_new move to the father's edge
    on_tgt = (mig_p.node == target[:, None]) & ok[:, None] & (
        mig_p.time > t_new[:, None])
    node_n = torch.where(on_tgt, father[:, None], mig_p.node)
    # the new events go to the pruned edge i, in free slots (free first)
    free_order = torch.argsort((node_n >= 0).to(torch.int64), dim=1,
                               stable=True)
    ok = ok & (nn <= (node_n < 0).sum(1))
    put = ok[:, None] & (torch.arange(ME, device=dev)[None, :] < nn[:, None])

    def place(arr, new):
        # out of place: vmap batches scatter, not scatter_
        return arr.scatter(1, free_order, torch.where(
            put, new, torch.gather(arr, 1, free_order)))

    mig_n = mig_p._replace(
        time=place(mig_p.time, nt),
        node=place(node_n, i[:, None].expand(L, ME)),
        src=place(mig_p.src, ns), dst=place(mig_p.dst, nd))

    # --- accept (dlogl only: prior == proposal) ---------------------------------
    logl_new = logl_fn(gt_n, state.subst, sp, state.clock, mig=mig_n)
    logpr_new = logpr_fn(gt_n, sp, mig_n, heredity)[0]
    ok = ok & torch.isfinite(logpr_new)
    accept = rng.mh_accept(gen, logl_new - state.logl, ctx.shard) & ok
    am = accept[:, None]
    new_state = state._replace(
        gt=GTrees(torch.where(am, nl, gt0.left),
                  torch.where(am, nr, gt0.right),
                  torch.where(am, np_, gt0.parent),
                  torch.where(am, na, gt0.age), gt0.hpath),
        mig=mig0._replace(
            time=torch.where(am, mig_n.time, mig0.time),
            node=torch.where(am, mig_n.node, mig0.node),
            src=torch.where(am, mig_n.src, mig0.src),
            dst=torch.where(am, mig_n.dst, mig0.dst)),
        logl=torch.where(accept, logl_new, state.logl),
        logpr=torch.where(accept, logpr_new, state.logpr))
    return new_state, psum_counts(ctx.shard, is_valid.sum(), accept.sum())


def heredity_move_mig(ctx: Ctx, cfg: BppConfig, routes, state: McmcState,
                      gen):
    """Per-locus heredity-scalar slide under migration (prop_heredity
    gtree.c:8214; the MSC-M density scales every theta by h_l)."""
    L = state.gt.n_loci
    eps = state.finetune[FT_LRHT]
    h = state.subst.heredity
    h_new = torch.abs(h + eps * rng.bactrian(gen, (L,), h.dtype, h.device,
                                             ctx.shard))
    h_new = torch.where(ctx.locus_mask, torch.clamp(h_new, min=1e-300), h)
    dprior = (cfg.heredity_alpha - 1.0) * torch.log(h_new / h) \
        - cfg.heredity_beta * (h_new - h)
    logpr_new = make_logpr_fn_mig(ctx, routes)(state.gt, state.sp,
                                               state.mig, h_new)[0]
    accept = rng.mh_accept(gen, dprior + (logpr_new - state.logpr),
                           ctx.shard) & ctx.locus_mask
    return (state._replace(
        subst=state.subst._replace(heredity=torch.where(accept, h_new, h)),
        logpr=torch.where(accept, logpr_new, state.logpr)),
        psum_counts(ctx.shard, ctx.locus_mask.sum(), accept.sum()))
