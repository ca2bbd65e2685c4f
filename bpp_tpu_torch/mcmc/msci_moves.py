"""MSC-I (introgression network) moves: phi, network taus, hpath (PyTorch).

Port of ``bpp_tpu/mcmc/msci_moves.py``, on the route representation
(gene-node populations come from ages and the per-edge hybridization
flags ``GTrees.hpath``; nothing is book-kept):

  * phi Gibbs     — stree.c:1593 ``propose_phi_gibbs``: given the routes
    the full conditional of a hybridization's phi is Beta(p + sum_l
    n_hinner, q + sum_l n_mirror), since the density's phi terms are
    n_hinner log(phi) + n_mirror log(1 - phi) a locus
    (gtree.c:3925-3931); an exact draw, always accepted.
  * network tau   — the MSC-I variants of ``propose_tau`` (stree.c:5512,
    5544-5611): the taus of a hybridization move as one (hinner, mirror
    and the parents htau == 0 ties to them; a BDI pair's four nodes), and
    the gene-node ages in the populations it bounds follow by the rubber
    band (stree.c:4413-4422); one likelihood pass for each inner node.
  * repath        — the MSC-I part of ``propose_ages`` (gtree.c:4726-4905):
    for blocks of independent coalescences, a new population among those
    the node's (unchanged) age and routes allow, and new flags on the
    three edges at the node, drawn phi-weighted towards their ends
    (``sample_hpath`` gtree.c:4225); the Hastings ratio is the reverse
    over the forward path probability.  Ages and topology stay, so under
    the strict clock the likelihood does not change; under a relaxed
    clock the re-routed edges change their lengths and a likelihood pass
    is part of the move.

Every walk takes H steps, so a move reads nothing back to the host;
under integrated thetas the per-locus decisions of repath take
``notheta.scan_accept``'s serial chain (kernel K3 on the card).
"""

from __future__ import annotations

import torch

from ..config import BppConfig, Clock, PriorDist
from ..parallel.mesh import psum_counts
from ..trees import coalescent as coalmod
from ..trees.gtree import SpeciesArrays, assign_populations, node_depths
from . import notheta, rng
from .moves import MAXAGE_CAP, _psum_if_sharded
from .state import FT_TAU, Ctx, McmcState, make_logl_fn, make_logpr_fn


# --------------------------------------------------------------------------
# phi Gibbs
# --------------------------------------------------------------------------


def phi_beta_params(ctx: Ctx, cfg: BppConfig, state: McmcState):
    """(a [HY], b [HY]): the Beta full conditional of each hybridization's
    phi, the prior's (p, q) plus the route counts into its hinner and its
    mirror over the real loci (BDI-corrected, ``phi_entry_counts``)."""
    gt, sp = state.gt, state.sp
    pops = assign_populations(gt, sp, ctx.tip_pop)
    _, _, n_in = coalmod.per_pop_stats(gt, sp, pops, ctx.n_seq)
    n_in = coalmod.phi_entry_counts(sp, n_in)
    n_in = torch.where(ctx.locus_mask[:, None], n_in, torch.zeros_like(n_in))
    tot = _psum_if_sharded(ctx, n_in.sum(0)).to(sp.phi.dtype)  # [H]
    p0 = cfg.phiprior.alpha if cfg.phiprior else 1.0
    q0 = cfg.phiprior.beta if cfg.phiprior else 1.0
    hin = sp.hslot
    mir = sp.hybrid[hin]
    return p0 + tot[hin], q0 + tot[mir]


def phi_gibbs_move(ctx: Ctx, cfg: BppConfig, state: McmcState, gen):
    """Exact Gibbs update of every hybridization's phi (a Beta draw as a
    ratio of two Gamma draws)."""
    sp = state.sp
    HY = sp.n_hybrids
    a, b = phi_beta_params(ctx, cfg, state)
    ga, gb = rng.gamma(gen, a), rng.gamma(gen, b)
    draw = torch.clamp(ga / (ga + gb), 1e-9, 1.0 - 1e-9)
    hin = sp.hslot
    phi = sp.phi.clone()
    phi[hin] = draw
    phi[sp.hybrid[hin]] = 1.0 - draw
    sp_new = sp._replace(phi=phi)
    # phi enters the density's phi terms only: refresh the cached logpr
    logpr_new, _, _ = make_logpr_fn(ctx)(state.gt, sp_new,
                                         state.subst.heredity)
    return state._replace(sp=sp_new, logpr=logpr_new), (HY, HY)


# --------------------------------------------------------------------------
# network tau slide
# --------------------------------------------------------------------------


def tied_groups(sp: SpeciesArrays):
    """``[NI, H]`` bool: row k marks the taus that move with inner node
    ``NS + k``'s: the node, its mirror if it is a hinner, the parents an
    htau == 0 ties to either, and for a BDI pair both hinners and both
    mirrors (one tau, stree.c:5652)."""
    H, NS = sp.n_nodes, sp.n_tips
    dev = sp.parent.device
    hs = torch.arange(H, device=dev)
    hv = torch.arange(NS, H - sp.n_hybrids, device=dev)
    grp = hv[:, None] == hs
    is_hin = sp.hindex[hv] >= 0
    mir = torch.where(is_hin, sp.hybrid[hv], hv)
    grp = grp | ((mir[:, None] == hs) & is_hin[:, None])
    if sp.bdi_partner is not None:
        part = sp.bdi_partner[hv]
        is_bdi = (part >= 0)[:, None]
        part_s = part.clamp(min=0)
        grp = grp | ((part_s[:, None] == hs) & is_bdi)
        grp = grp | ((sp.hybrid[part_s][:, None] == hs) & is_bdi)
    for side in (hv, mir):
        par = sp.parent[side]
        par_s = par.clamp(min=0)
        tie = is_hin & (par >= 0) & ~sp.tau_free[par_s]
        grp = grp | ((par_s[:, None] == hs) & tie[:, None])
    return grp


def tau_move_net(ctx: Ctx, cfg: BppConfig, state: McmcState, gen):
    """Rubber-band slide of every free tau of a network, one inner node
    after another, each with its tied group.

    The window of a group is [the largest tau of a child outside it, the
    smallest tau of a parent outside it] (999 at the root).  Gene-node
    ages in the group's populations and their children's inside the
    window are rubber-banded with the group's min/max factors, with the
    Jacobian count_above log(maxf) + count_below log(minf) (the general
    form of the reference's per-model H1/H2/H3 sets, stree.c:5718-5830).
    A node that is not free (a tied parent, a BDI pair's second hinner)
    still costs its pass and is never accepted, as in ``bpp_tpu``."""
    sp0 = state.sp
    H, NS = sp0.n_nodes, sp0.n_tips
    T, N = state.gt.n_tips, state.gt.n_nodes
    n_inner = H - NS - sp0.n_hybrids
    dev = state.gt.age.device
    logl_fn = make_logl_fn(ctx, cfg)
    logpr_fn = make_logpr_fn(ctx)
    gamma_tau = cfg.tauprior.dist == PriorDist.GAMMA
    a, b = cfg.tauprior.alpha, cfg.tauprior.beta
    eps = state.finetune[FT_TAU]
    dt = eps.dtype
    nodes_idx = torch.arange(N, device=dev)[None, :]
    is_inner = (nodes_idx >= T) & (nodes_idx < T + ctx.n_seq[:, None] - 1)
    gmask = is_inner & ctx.locus_mask[:, None]
    groups = tied_groups(sp0)
    integ = cfg.theta_integrated
    hered = state.subst.heredity

    lc, rc, par = sp0.left, sp0.right, sp0.parent
    lcs, rcs, par_s = lc.clamp(min=0), rc.clamp(min=0), par.clamp(min=0)
    age, tau = state.gt.age, sp0.tau
    logl, logpr = state.logl, state.logpr
    coal_c, t2_c = state.coal, state.t2h
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    nprop, nacc = zero, zero
    inf = torch.full_like(tau, float("inf"))
    zt = torch.zeros_like(tau)
    for k in range(n_inner):
        h = NS + k
        grp = groups[k]
        free = sp0.tau_free[h]
        told = tau[h]
        child_tau = torch.maximum(
            torch.where((lc >= 0) & ~grp[lcs], tau[lcs], zt),
            torch.where((rc >= 0) & ~grp[rcs], tau[rcs], zt))
        minage = torch.where(grp, child_tau, zt).max()
        ptau = torch.where((par >= 0) & ~grp[par_s], tau[par_s], inf)
        maxage = torch.where(grp, ptau, inf).min()
        maxage = torch.where(torch.isinf(maxage),
                             torch.full_like(maxage, MAXAGE_CAP), maxage)
        is_root = par[h] < 0

        tnew = rng.reflect(told + eps * rng.bactrian(gen, (), dt, dev),
                           minage, maxage)
        dtau = tnew - told
        tau_new = torch.where(grp, tnew, tau)
        sp_cur = sp0._replace(tau=tau)
        sp_new = sp0._replace(tau=tau_new)

        # the affected populations: the group and its children
        aff = grp | ((par >= 0) & grp[par_s])
        pops = assign_populations(state.gt._replace(age=age), sp_cur,
                                  ctx.tip_pop)
        cond = gmask & aff[pops] & (age > minage) & (age < maxage)
        above = cond & (age >= told)
        below = cond & (age < told)
        # delta form (no float32 cancellation at the 999 cap)
        age_new = torch.where(
            above, age + dtau * (maxage - age) / (maxage - told),
            torch.where(below, age + dtau * (age - minage) / (told - minage),
                        age))
        gtn = state.gt._replace(age=age_new)
        logl_new = logl_fn(gtn, state.subst, sp_new, state.clock)
        logpr_new, c_new, t2_new = logpr_fn(gtn, sp_new, hered)
        ca, cb, dpr, dlogl = _psum_if_sharded(
            ctx, above.sum(), below.sum(), torch.sum(logpr_new - logpr),
            torch.sum(logl_new - logl))
        ca, cb = ca.to(dt), cb.to(dt)
        if integ:
            # logpr is the theta-free part (phi terms, validity); the
            # coupled part comes from the (coal, t2h) caches
            dpr = dpr + (
                notheta.total_integrated(cfg, c_new, t2_new, hered,
                                         ctx.locus_mask, ctx.shard)
                - notheta.total_integrated(cfg, coal_c, t2_c, hered,
                                           ctx.locus_mask, ctx.shard))
        ln_maxf = torch.log1p(dtau / (told - maxage))
        ln_minf = torch.log1p(dtau / (told - minage))
        cand = torch.sum((tau > 0) & sp0.tau_free).to(dt)
        if gamma_tau:
            root_term = (a - 1.0 - cand + 1.0) * torch.log(tnew / told) \
                - b * (tnew - told)
        else:
            root_term = (-a - 1.0 - cand + 1.0) * torch.log(tnew / told) \
                - b * (1.0 / tnew - 1.0 / told)
        lnacc = (ca * ln_maxf + cb * ln_minf
                 + dlogl + dpr
                 + torch.where(is_root, root_term,
                               torch.zeros_like(root_term)))

        accept = rng.mh_accept(gen, lnacc) & free & (told > 0)
        age = torch.where(accept, age_new, age)
        tau = torch.where(accept, tau_new, tau)
        logl = torch.where(accept, logl_new, logl)
        logpr = torch.where(accept, logpr_new, logpr)
        if integ:
            coal_c = torch.where(accept, c_new, coal_c)
            t2_c = torch.where(accept, t2_new, t2_c)
        nprop = nprop + free.to(torch.int64)
        nacc = nacc + accept.to(torch.int64)

    new_state = state._replace(
        gt=state.gt._replace(age=age), sp=sp0._replace(tau=tau),
        logl=logl, logpr=logpr, coal=coal_c, t2h=t2_c)
    return new_state, (nprop, nacc)


# --------------------------------------------------------------------------
# hpath repath move
# --------------------------------------------------------------------------


def _path_step(sp: SpeciesArrays, p, end):
    """What a path walk needs at ``p`` on its way to ``end``: (par_s,
    is_hin, slot, mir_s, both, main_ok, phi) — the next population on the
    hinner side, whether the step is a choice point's (a hinner parent;
    not from a BDI mirror, whose lineages have switched already), its
    flag slot, the mirror side, whether both sides reach ``end``, whether
    the hinner side does, and the hinner side's phi."""
    par = sp.parent[p]
    par_s = par.clamp(min=0)
    hidx = sp.hindex[par_s]
    is_hin = (hidx >= 0) & (par >= 0) & (p != end)
    if sp.bdi_mirror is not None:
        is_hin = is_hin & ~sp.bdi_mirror[p]
    mir = sp.hybrid[par_s]
    mir_s = mir.clamp(min=0)
    main_ok = sp.pptable[par_s, end]
    mir_ok = sp.pptable[mir_s, end] & (mir >= 0)
    both = is_hin & main_ok & mir_ok
    return par_s, is_hin, hidx.clamp(min=0), mir_s, both, main_ok, \
        sp.phi[par_s]


def _log_side(both, take_mirror, phi_m):
    """The log probability of the side taken at a choice point where both
    sides reach the end (0 elsewhere)."""
    side = torch.where(take_mirror, 1.0 - phi_m, phi_m)
    lq = torch.log(torch.clamp(side, min=rng.tiny_floor(phi_m.dtype)))
    return torch.where(both, lq, torch.zeros_like(lq))


def _sample_path(sp: SpeciesArrays, start, end, flags, u01):
    """New flags along the walk ``start -> end`` (``sample_hpath``).

    At a hinner whose both sides reach ``end`` (the network's pptable)
    the hinner side is taken with probability phi, adding its log to the
    proposal density; where one side reaches it, that side is forced (no
    term).  ``u01`` [..., HY] are uniforms, one a slot: an edge crosses a
    hybridization at most once.  Returns (flags, logq, failed)."""
    slots = torch.arange(flags.shape[-1], device=flags.device)
    logq = torch.zeros(start.shape, dtype=sp.phi.dtype, device=start.device)
    p = start
    for _ in range(sp.n_nodes):
        par_s, is_hin, slot, mir_s, both, main_ok, phi_m = \
            _path_step(sp, p, end)
        u = torch.gather(u01, -1, slot[..., None])[..., 0]
        take_mirror = torch.where(both, u >= phi_m, is_hin & ~main_ok)
        write = is_hin[..., None] & (slots == slot[..., None])
        flags = torch.where(write, take_mirror.to(flags.dtype)[..., None],
                            flags)
        logq = logq + _log_side(both, take_mirror, phi_m)
        nxt = torch.where(is_hin & take_mirror, mir_s, par_s)
        p = torch.where((p == end) | (sp.parent[p] < 0), p, nxt)
    return flags, logq, p != end


def _replay_path(sp: SpeciesArrays, start, end, flags):
    """The log proposal probability of the existing path ``start -> end``
    under the phi-weighted scheme (``sample_hpath_reverse``,
    gtree.c:4342), and whether the walk failed to reach ``end``."""
    logq = torch.zeros(start.shape, dtype=sp.phi.dtype, device=start.device)
    p = start
    for _ in range(sp.n_nodes):
        par_s, is_hin, slot, mir_s, both, _, phi_m = _path_step(sp, p, end)
        flag = torch.gather(flags, -1, slot[..., None])[..., 0]
        take_mirror = is_hin & (flag == 1)
        logq = logq + _log_side(both, take_mirror, phi_m)
        nxt = torch.where(take_mirror, mir_s, par_s)
        p = torch.where((p == end) | (sp.parent[p] < 0), p, nxt)
    return logq, p != end


def _choose_uniform(gen, cand, shard=None):
    """One True entry of each row of ``cand`` [..., H], uniformly (an
    arbitrary index where a row has none): (index [...], count [...]);
    ``shard`` when the leading axis is loci."""
    count = cand.sum(-1)
    u = rng.uniform(gen, count.shape, torch.float64, cand.device, shard)
    rank = torch.minimum(torch.floor(u * count).to(torch.int64),
                         (count - 1).clamp(min=0))
    ci = cand.to(torch.int64)
    hit = cand & ((torch.cumsum(ci, -1) - ci) == rank[..., None])
    return torch.argmax(hit.to(torch.uint8), dim=-1), count


def repath_move(ctx: Ctx, cfg: BppConfig, state: McmcState, gen):
    """Blocked re-choice of coalescence populations and edge flags.

    Two depth-parity phases: node u touches only its three incident
    edges, and the nodes of one parity share none, so a phase's nodes are
    independent.  Each edge's new flags have one writer, its parent when
    the parent moves in the phase, else the node itself; flags are
    gathered from the writer, never scattered."""
    gt, sp = state.gt, state.sp
    L, N, T = gt.n_loci, gt.n_nodes, gt.n_tips
    HY = sp.n_hybrids
    dev = gt.age.device
    lidx = torch.arange(L, device=dev)[:, None]
    nodes = torch.arange(N, device=dev)[None, :]
    logpr_fn = make_logpr_fn(ctx)
    depths = node_depths(gt)
    inner_valid = (nodes >= T) & (nodes < T + ctx.n_seq[:, None] - 1)
    tau = sp.tau
    par_pop_tau = torch.where(sp.parent >= 0, tau[sp.parent.clamp(min=0)],
                              torch.full_like(tau, float("inf")))
    hered = state.subst.heredity
    integ = cfg.theta_integrated
    coal_c, t2_c = state.coal, state.t2h
    # a relaxed clock prices an edge by the populations it passes, so a
    # new route changes the likelihood; the strict clock's does not
    relaxed = cfg.clock != Clock.GLOBAL
    logl_fn = make_logl_fn(ctx, cfg) if relaxed else None
    hpath, logpr, logl = gt.hpath, state.logpr, state.logl
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    nprop, nacc = zero, zero
    lc, rc = gt.left.clamp(min=0), gt.right.clamp(min=0)
    par_s = gt.parent.clamp(min=0)
    has_par = gt.parent >= 0
    age = gt.age

    for phase in (0, 1):
        mask = inner_valid & (depths % 2 == phase) & ctx.locus_mask[:, None]
        pops = assign_populations(gt._replace(hpath=hpath), sp, ctx.tip_pop)
        pop_lc = pops[lidx, lc]
        pop_rc = pops[lidx, rc]
        pop_pu = torch.where(has_par, pops[lidx, par_s],
                             torch.full_like(pops, sp.root))
        # the populations node u may sit in at its age: reached by both
        # children's populations, its interval holding the age, and the
        # parent's population reachable from it (gtree.c:4740-4757)
        has_time = (tau <= age[..., None]) & (age[..., None] < par_pop_tau)
        cand = (sp.pptable[pop_lc] & sp.pptable[pop_rc] & has_time
                & sp.pptable.T[pop_pu])
        choice, ccount = _choose_uniform(gen, cand, ctx.shard)

        # new flags on the three edges at u, and the old paths replayed
        # towards the old population
        u01 = rng.uniform(gen, (L, N, 3, HY), sp.phi.dtype, dev, ctx.shard)
        fl_l, ql_f, bad_l = _sample_path(sp, pop_lc, choice,
                                         hpath[lidx, lc], u01[:, :, 0])
        fl_r, qr_f, bad_r = _sample_path(sp, pop_rc, choice,
                                         hpath[lidx, rc], u01[:, :, 1])
        fl_u, qu_f, bad_u = _sample_path(sp, choice, pop_pu, hpath,
                                         u01[:, :, 2])
        ql_r, _ = _replay_path(sp, pop_lc, pops, hpath[lidx, lc])
        qr_r, _ = _replay_path(sp, pop_rc, pops, hpath[lidx, rc])
        qu_r, _ = _replay_path(sp, pops, pop_pu, hpath)
        ok = mask & (ccount > 0) & ~(bad_l | bad_r | bad_u)

        # an edge's writer: its parent (as left or right child) when the
        # parent moves, else the node itself when it moves
        pok = ok[lidx, par_s] & has_par
        r_is_lc = gt.left[lidx, par_s] == nodes
        from_parent = torch.where(r_is_lc[..., None], fl_l[lidx, par_s],
                                  fl_r[lidx, par_s])
        hp_new = torch.where(pok[..., None], from_parent,
                             torch.where(ok[..., None], fl_u, hpath))
        zq = torch.zeros_like(ql_f)
        q_fwd = torch.where(ok, ql_f + qr_f + qu_f, zq).sum(-1)
        q_rev = torch.where(ok, ql_r + qr_r + qu_r, zq).sum(-1)

        gtn = gt._replace(hpath=hp_new)
        logpr_new, c_new, t2_new = logpr_fn(gtn, sp, hered)
        lnacc = (logpr_new - logpr) + (q_rev - q_fwd)
        if relaxed:
            logl_new = logl_fn(gtn, state.subst, sp, state.clock)
            lnacc = lnacc + (logl_new - logl)
        amask = ctx.locus_mask & ok.any(1)
        if integ:
            # re-routing moves coalescences between populations: the
            # per-locus decisions couple through the pooled sums
            accept = notheta.scan_accept(
                gen, cfg, lnacc, coal_c, t2_c, hered, c_new, t2_new, hered,
                amask, ctx.locus_mask, ctx.shard)
            coal_c = torch.where(accept[:, None], c_new, coal_c)
            t2_c = torch.where(accept[:, None], t2_new, t2_c)
        else:
            accept = rng.mh_accept(gen, lnacc, ctx.shard) & amask
        hpath = torch.where(accept[:, None, None], hp_new, hpath)
        logpr = torch.where(accept, logpr_new, logpr)
        if relaxed:
            logl = torch.where(accept, logl_new, logl)
        nprop = nprop + amask.sum()
        nacc = nacc + accept.sum()

    new_state = state._replace(gt=gt._replace(hpath=hpath), logpr=logpr,
                               logl=logl, coal=coal_c, t2h=t2_c)
    return new_state, psum_counts(ctx.shard, nprop, nacc)
