"""Species-tree topology moves (A01/A11): species SPR and SNL (PyTorch).

Port of ``bpp_tpu/mcmc/stree_moves.py`` (``stree_propose_spr``
src/stree.c:7747 and ``stree_propose_stree_snl`` stree.c:11354).
Populations are derived from ages and the species tree, so a move is
the species-level choice, the gene-tree surgery batched over loci, one
likelihood pass and one MSC-density pass on the proposed trees, and one
accept decision; an infeasible proposal still runs its pass and is
rejected, so a move launches the pruning kernel exactly once.
Morphological traits are re-scored on the proposed topology
(:func:`_traits_on`).

What the eager step changes against ``bpp_tpu``:

  * no device value is read on the host inside SPR.  The per-inner-node
    identification scans are one batched pass over all inner nodes at
    once (each node's targets and counts depend on the original trees
    only); the application pass stays a loop over the inner nodes in
    node order (each prune and regraft sees the topology the earlier ones
    left), and its ``while_loop`` that lifts a receiver up the evolving
    tree is pointer jumping over ``ceil(log2 N)`` gathers (the fixed
    point of the same one-step map, the no-lift case included);
  * SNL's species-level part (focal choice, the delta walk of at most
    4H + 16 steps, the proposal densities and the new species arrays)
    runs in torch ops on the species arrays' device, in float64, from
    uniforms drawn with the driver's SNL-or-SPR draw from the run's
    generator (:func:`snl_species`); each branch of ``bpp_tpu``'s code is
    a ``torch.where``, so nothing is read on the host.  The walk keeps
    ``bpp_tpu``'s bookkeeping but for one fault: ``bpp_tpu`` goes on
    checking for an invalid tip landing after the walk has stopped, which
    rejects every landing on a tip branch (ROADMAP Queue 3).  And SNL's
    gene-tree part counts the branch above each gene tree's root among
    the targets, where ``bpp_tpu`` rejects a proposal that lifts a gene
    node above its tree's root (Queue 3; the prior is recovered only with
    both fixes);
  * when SNL moves the species root off index H - 1, the proposal swaps
    the labels of the old and the new root, so the root stays the last
    node, where ``tau_move``, ``mixing_move`` and the clock moves read
    it (``bpp_tpu`` keeps reading index H - 1).  Under the correlated
    clock the rate column stays with the index, so the root keeps mu_i.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import BppConfig, Clock, PriorDist
from ..parallel.mesh import pany, psum
from ..trees.gtree import assign_populations, inner_order, topo_scan
from . import rng
from .clock_moves import lnprior_rates
from .moves import _integrated_delta
from .state import Ctx, McmcState, make_logl_fn, make_logpr_fn, tree_where

NEG = -1e30


def _at(x, i, dim=0):
    """``x`` at the 0-dim index tensor ``i`` along ``dim``, with no host
    read (plain indexing by a 0-dim tensor reads it on the host)."""
    return torch.index_select(x, dim, i.reshape(1)).squeeze(dim)


def _sp_depth(pptable):
    """#ancestors per species node from the ancestor-or-self table."""
    return pptable.sum(-1) - 1


def _recompute_pptable(parent, H: int):
    """Ancestor-or-self table by repeated squaring (stree.c:2840 analog)."""
    dev = parent.device
    hidx = torch.arange(H, device=dev)
    P = hidx[None, :] == torch.where(parent < 0, H, parent)[:, None]
    reach = torch.eye(H, dtype=torch.bool, device=dev) | P
    for _ in range(max(1, H.bit_length())):
        r = reach.to(torch.float32)
        reach = reach | (r @ r > 0)
    return reach


def _recompute_mrca(pptable):
    depth = _sp_depth(pptable)
    common = pptable[:, None, :] & pptable[None, :, :]
    score = torch.where(common, depth[None, None, :], -1)
    return torch.argmax(score, dim=-1)


def log_histories_tau(sp) -> torch.Tensor:
    """log #labeled histories of the (possibly partially collapsed)
    species tree, counting only ACTIVE inner nodes (tau > 0), like
    ``histories`` (delimit.c:729): the product over active inner nodes v
    of C(e_l + e_r, e_l), e_* the active-event counts of the child
    subtrees; float64."""
    H = sp.tau.shape[0]
    NS = (H + 1) // 2
    act = (torch.arange(H, device=sp.tau.device) >= NS) & (sp.tau > 0)
    e = (sp.pptable & act[:, None]).sum(0).to(torch.float64)
    el = e[sp.left.clamp(min=0)]
    er = e[sp.right.clamp(min=0)]
    lc = (torch.lgamma(el + er + 1.0) - torch.lgamma(el + 1.0)
          - torch.lgamma(er + 1.0))
    return torch.where(act, lc, torch.zeros_like(lc)).sum()


def log_species_model_prior(cfg, sp, prior_a11_log=None) -> torch.Tensor:
    """lnprior_species_model (delimit.c:709): 0 for the LH/SLH priors
    (0/2), -log(histories) for the uniform-tree priors (1/3), plus the
    A11 species-count normalization -log prior_A11[tau_count] for
    priors >= 2; float64."""
    lp = torch.zeros((), dtype=torch.float64, device=sp.tau.device)
    if cfg.delimit_prior in (1, 3):
        lp = lp - log_histories_tau(sp)
    if prior_a11_log is not None and cfg.delimit_prior >= 2:
        NS = (sp.tau.shape[0] + 1) // 2
        tau_count = (sp.tau[NS:] > 0).sum()
        lp = lp - _at(prior_a11_log, tau_count).to(torch.float64)
    return lp


def _log_histories(pptable, tips_mask):
    """log #labeled histories = log (n-1)! - sum_v log(#inner below v)
    (delimit.c ``histories``); the uniform-tree priors 2/3."""
    ntips_below = (pptable.to(torch.float64).T
                   @ tips_mask.to(torch.float64))
    inner_below = torch.clamp(ntips_below - 1, min=0)
    inner_mask = ~tips_mask & (inner_below > 0)
    n = tips_mask.sum().to(torch.float64)
    return (torch.lgamma(n) - torch.where(
        inner_mask, torch.log(torch.clamp(inner_below, min=1)),
        torch.zeros_like(inner_below)).sum())


def _pick_categorical(gen, logw, mask):
    """One index drawn with probability softmax(logw) over ``mask``
    (inverse CDF of one uniform), and its log probability."""
    logits = torch.where(mask, logw, torch.full_like(logw, NEG))
    cdf = torch.cumsum(torch.softmax(logits.to(torch.float64), 0), 0)
    u = rng.uniform(gen, (1,), torch.float64, logw.device)
    idx = torch.searchsorted(cdf, u * cdf[-1], right=True)
    idx = idx.clamp(max=logw.shape[0] - 1)[0]
    return idx, _at(logits, idx) - torch.logsumexp(logits, 0)


def _constraint_feasible(cids, sp, partau, is_inner):
    """Per-node Y-feasibility under topology constraints
    (fill_feasible_flags stree.c:7697): Y's children and sister share
    Y's group, and some branch with Y's group spans tau_Y."""
    H = cids.shape[0]
    hidx = torch.arange(H, device=cids.device)
    x = sp.parent.clamp(min=0)
    lc = sp.left.clamp(min=0)
    rc = sp.right.clamp(min=0)
    sib = torch.where(sp.left[x] == hidx, sp.right[x], sp.left[x])
    sib = sib.clamp(min=0)
    neigh = (cids == cids[lc]) & (cids == cids[rc]) & (cids == cids[sib])
    # any same-group branch (c, parent(c)) spanning tau_y, c not a
    # descendant-or-self of y (check_age_feasibility_recursive
    # stree.c:7676; group regions are connected)
    spans = ((sp.tau[None, :] < sp.tau[:, None])
             & (partau[None, :] > sp.tau[:, None]))         # [y, c]
    ok_c = spans & (cids[None, :] == cids[:, None]) & ~sp.pptable.T
    return is_inner & neigh & ok_c.any(dim=1)


def _select_rows(mask, r):
    """Uniformly select one True index along the last axis of ``mask``
    with the uniforms ``r`` (one per row)."""
    count = mask.sum(-1)
    sel = torch.minimum(torch.floor(r * count).to(torch.int64),
                        torch.clamp(count - 1, min=0))
    mi = mask.to(torch.int64)
    cum = torch.cumsum(mi, dim=-1) - mi
    hit = mask & (cum == sel[..., None])
    return torch.argmax(hit.to(torch.uint8), dim=-1), count


def _branch_frame(gt, ctx, age, with_root=False):
    """(parent age [L, N] (inf at roots), valid branch mask [L, N], valid
    inner-node mask [L, N]) for the ages ``age``; ``with_root`` counts the
    branch above each gene tree's root (up to infinity) as a branch."""
    N, T = gt.n_nodes, gt.n_tips
    nodes_idx = torch.arange(N, device=age.device)[None, :]
    valid_inner = (nodes_idx >= T) & (nodes_idx < T + ctx.n_seq[:, None] - 1)
    page = torch.where(gt.parent >= 0,
                       torch.gather(age, 1, gt.parent.clamp(min=0)),
                       torch.full_like(age, float("inf")))
    valid_branch = (nodes_idx < ctx.n_seq[:, None]) | valid_inner
    if not with_root:
        valid_branch = valid_branch & (gt.parent >= 0)
    return page, valid_branch, valid_inner


def _identify(gen, moved, tmask, smask, T, dtype, shard=None):
    """Targets and the Hastings ratio of every inner node at once: one
    target drawn uniformly from ``tmask`` ``[L, T-1, N]`` per moved node,
    log(#targets / #sources) summed per locus, and the loci where a moved
    node has no target.  Returns (lnhr [L], bad [L], targets [L, N])."""
    L, K, N = tmask.shape
    is_m = moved[:, T:]
    r = rng.uniform(gen, (L, K), torch.float64, moved.device, shard)
    tgt, tcount = _select_rows(tmask, r)
    scount = smask.sum(-1) + 1
    ok = is_m & (tcount > 0)
    term = torch.log(tcount.to(dtype)) - torch.log(scount.to(dtype))
    lnhr = torch.where(ok, term, torch.zeros_like(term)).sum(1)
    bad = (is_m & (tcount == 0)).any(1)
    targets = torch.full((L, N), -1, dtype=torch.int64, device=moved.device)
    targets[:, T:] = torch.where(is_m, tgt, torch.full_like(tgt, -1))
    return lnhr, bad, targets


def _jump(nxt, rounds):
    """Fixed point of the map ``nxt`` [L, N] (node -> node) by pointer
    jumping: ``rounds`` squarings cover chains of up to 2**rounds steps."""
    for _ in range(rounds):
        nxt = torch.gather(nxt, 1, nxt)
    return nxt


def _prune_regraft(gt, is_m_all, pruned, targets, lift_age, mtime_all):
    """Sequential prune + regraft of every moved inner node, in node
    order, on the evolving topology (stree.c:8208-8290).  A moved node
    keeps its pruned child; its current other child takes its place
    under its parent; the stored target lifts up the current tree while
    its parent is no older than the node's time ``mtime_all``; the node
    then sits between the receiver and the receiver's parent."""
    L, N = gt.left.shape
    T = gt.n_tips
    dev = gt.left.device
    lidx = torch.arange(L, device=dev)
    nodes = torch.arange(N, device=dev)[None, :].expand(L, N)
    rounds = max(1, (N - 1).bit_length())
    left, right, parent = gt.left.clone(), gt.right.clone(), gt.parent.clone()
    for k in range(T - 1):
        node = T + k
        is_m = is_m_all[:, node]
        prn = pruned[:, node]
        lcur = left[:, node]
        itc = torch.where(lcur == prn, right[:, node], lcur)
        par = parent[:, node].clone()
        par_s = par.clamp(min=0)
        # prune: the current other child replaces the node under its parent
        lval = left[lidx, par_s]
        left[lidx, par_s] = torch.where(is_m & (lval == node), itc, lval)
        rval = right[lidx, par_s]
        right[lidx, par_s] = torch.where(is_m & (rval == node), itc, rval)
        parent[lidx, itc] = torch.where(is_m, par, parent[lidx, itc])
        # receiver: lift the target while its parent is no older than the
        # node's time
        up = (is_m[:, None] & (parent >= 0)
              & (torch.gather(lift_age, 1, parent.clamp(min=0))
                 <= mtime_all[:, node, None]))
        top = _jump(torch.where(up, parent, nodes), rounds)
        t0 = targets[:, node]
        rcv = torch.where(is_m, torch.gather(top, 1, t0.clamp(min=0)[:, None])
                          [:, 0], t0)
        rcv_s = rcv.clamp(min=0)
        # regraft: the node replaces the receiver under its parent
        rp = parent[lidx, rcv_s]
        rp_s = rp.clamp(min=0)
        ok = is_m & (rp >= 0)
        lval = left[lidx, rp_s]
        left[lidx, rp_s] = torch.where(ok & (lval == rcv), node, lval)
        rval = right[lidx, rp_s]
        right[lidx, rp_s] = torch.where(ok & (rval == rcv), node, rval)
        parent[:, node] = torch.where(is_m, rp, parent[:, node])
        # the node's other slot takes the receiver; the pruned slot stays
        lval = left[:, node].clone()
        rval = right[:, node].clone()
        keep_l = lval == prn
        left[:, node] = torch.where(is_m & ~keep_l, rcv, lval)
        right[:, node] = torch.where(is_m & keep_l, rcv, rval)
        parent[lidx, rcv_s] = torch.where(is_m, node, parent[lidx, rcv_s])
    return left, right, parent


def _masked_sum(ctx, x):
    """The sum of ``x`` [L] over the real loci (of every rank)."""
    return psum(ctx.shard,
                torch.where(ctx.locus_mask, x, torch.zeros_like(x)).sum())


def _traits_on(ctx: Ctx, state: McmcState, sp_new, lnacc, cand_state):
    """Morphological traits re-scored on the proposed topology
    (stree.c:727-736 subtracts trait_old_logl and adds
    loglikelihood_trait inside the acceptance): (lnacc, candidate)."""
    if ctx.trait_fn_topo is None or state.trait is None:
        return lnacc, cand_state
    tl_new = ctx.trait_fn_topo(sp_new.left, sp_new.right, sp_new.parent,
                               sp_new.tau, state.trait.brate)
    return (lnacc + torch.sum(tl_new - state.trait.logl),
            cand_state._replace(trait=state.trait._replace(logl=tl_new)))


def species_spr_move(ctx: Ctx, cfg: BppConfig, state: McmcState, gen):
    """Species-tree SPR with gene-tree surgery (stree.c:7747): prune the
    focal node Y (weight 1/sqrt(branch length)) with its child A and
    regraft it on a branch C spanning tau_Y (weight 1/path length);
    gene lineages of A that coalesce with non-A lineages between Y and
    Z = LCA(X, C) move to branches of the C..Z populations."""
    gt, sp = state.gt, state.sp
    L, N, T = gt.n_loci, gt.n_nodes, gt.n_tips
    H = sp.n_nodes
    NS = (H + 1) // 2
    dev = gt.age.device
    hidx = torch.arange(H, device=dev)
    nodes_idx = torch.arange(N, device=dev)[None, :]
    dt = sp.tau.dtype
    logl_fn = make_logl_fn(ctx, cfg)
    logpr_fn = make_logpr_fn(ctx)
    inf = torch.full_like(sp.tau, float("inf"))

    partau = torch.where(sp.parent >= 0, sp.tau[sp.parent.clamp(min=0)], inf)
    depth = _sp_depth(sp.pptable)
    is_inner = hidx >= NS

    # --- focal node Y (init_weights: 1/sqrt(branch length)) ----------------
    feas_y = is_inner & (sp.parent >= 0) & (sp.tau > 0)
    cids = ctx.sp_constraint
    if cids is not None:
        feas_y = feas_y & _constraint_feasible(cids, sp, partau, is_inner)
    w = torch.where(feas_y, 1.0 / torch.sqrt(torch.clamp(partau - sp.tau,
                                                          min=1e-30)),
                    torch.zeros_like(sp.tau))
    y, logp_y = _pick_categorical(gen, torch.log(torch.clamp(w, min=1e-300)),
                                  feas_y)
    x = _at(sp.parent, y).clamp(min=0)
    swap = rng.uniform(gen, (), dt, dev) < 0.5
    ly, ry = _at(sp.left, y), _at(sp.right, y)
    a = torch.where(swap, ry, ly).clamp(min=0)
    b = torch.where(swap, ly, ry).clamp(min=0)
    tau_y = _at(sp.tau, y)

    # --- target C (weight 1/path length) ------------------------------------
    # candidates: not a descendant-or-self of Y, tau < tau_Y < parent tau
    cand = ~_at(sp.pptable, y, 1) & (sp.tau < tau_y) & (partau > tau_y)
    if cids is not None:
        cand = cand & (cids == _at(cids, y))        # stree.c:7847
    # z(c) = LCA(x, c): deepest common ancestor
    common = _at(sp.pptable, x)[None, :] & sp.pptable
    zc = torch.argmax(torch.where(common, depth[None, :], -1), dim=-1)
    pathlen = 1 + (_at(depth, y) - depth[zc]) + (depth - depth[zc])
    c, logp_c = _pick_categorical(
        gen, -torch.log(torch.clamp(pathlen, min=1).to(dt)), cand)
    z = _at(zc, c)

    # --- new species topology ------------------------------------------------
    def replace_child(left, right, par, old, new):
        at = hidx == par
        return (torch.where(at & (left == old), new, left),
                torch.where(at & (right == old), new, right))

    cp = _at(sp.parent, c)
    # detach: B replaces Y under X
    nleft, nright = replace_child(sp.left, sp.right, x, y, b)
    nparent = torch.where(hidx == b, x, sp.parent)
    # regraft: Y replaces C under C's parent; Y's B-slot takes C
    nleft, nright = replace_child(nleft, nright, cp, c, y)
    nparent = torch.where(hidx == y, cp, nparent)
    nleft = torch.where((hidx == y) & (ly == b), c, nleft)
    nright = torch.where((hidx == y) & (ry == b), c, nright)
    nparent = torch.where(hidx == c, y, nparent)
    npptable = _recompute_pptable(nparent, H)
    sp_new = sp._replace(left=nleft, right=nright, parent=nparent,
                         pptable=npptable, mrca=_recompute_mrca(npptable))

    # --- gene-tree marks on the current state --------------------------------
    order = inner_order(gt)
    pops = assign_populations(gt, sp, ctx.tip_pop)
    age = gt.age
    col_z = _at(sp.pptable, z, 1)
    path_yz = _at(sp.pptable, y) & col_z & (hidx != z)      # y..z exclusive
    path_cz = _at(sp.pptable, c) & col_z & (hidx != z)      # c..z exclusive
    tip_under_a = _at(sp.pptable, a, 1)[ctx.tip_pop]        # [L, T]
    ge_zmask = _at(sp.pptable, z)[pops]                     # pop >= z
    hasA = topo_scan(gt, tip_under_a, torch.logical_or, order)
    markA = hasA & ~ge_zmask
    tip_qual = ~tip_under_a & (sp.pptable[ctx.tip_pop]
                               & path_yz[None, None, :]).any(-1)
    hasO = topo_scan(gt, tip_qual, torch.logical_or, order)
    markO = hasO & ~ge_zmask
    pureA = markA & ~markO
    page, valid_branch, valid_inner = _branch_frame(gt, ctx, age)
    lc = gt.left.clamp(min=0)
    rc = gt.right.clamp(min=0)
    lA, rA = torch.gather(pureA, 1, lc), torch.gather(pureA, 1, rc)
    lO, rO = torch.gather(markO, 1, lc), torch.gather(markO, 1, rc)
    square = (pops == y) & lO & rO
    moved = (valid_inner & path_yz[pops] & (lA ^ rA) & ~square
             & ctx.locus_mask[:, None])
    pruned = torch.where(lA, gt.left, gt.right)
    intact = torch.where(lA, gt.right, gt.left)
    # pop_cz per node: the highest c..z-path node with tau < age
    elig = path_cz[None, None, :] & (sp.tau[None, None, :] < age[..., None])
    pop_cz = torch.argmax(torch.where(elig, sp.tau[None, None, :],
                                      torch.full_like(elig, -1.0, dtype=dt)),
                          dim=-1)

    # identification: every inner node's target and Hastings term at once
    mtime = age[:, T:, None]
    spans = (valid_branch[:, None, :] & (age[:, None, :] < mtime)
             & (page[:, None, :] > mtime))                       # [L, K, N]
    tmask = spans & sp.pptable[pops[:, None, :], pop_cz[:, T:, None]]
    smask = (spans & sp.pptable[pops[:, None, :], pops[:, T:, None]]
             & ~pureA[:, None, :]
             & (nodes_idx[:, None, :] != intact[:, T:, None]))
    lnhr, badmask, targets = _identify(gen, moved, tmask, smask, T, dt,
                                       ctx.shard)

    # application: sequential prune + regraft on the evolving topology
    gl, gr, gp = _prune_regraft(gt, moved & ~badmask[:, None], pruned,
                                targets, age, age)
    gt_new = gt._replace(left=gl, right=gr, parent=gp)

    # --- full re-evaluation --------------------------------------------------
    logl_new = logl_fn(gt_new, state.subst, sp_new, state.clock)
    logpr_new, c_new, t2_new = logpr_fn(gt_new, sp_new, state.subst.heredity)

    # --- reverse species-level weights ---------------------------------------
    npartau = torch.where(nparent >= 0, sp.tau[nparent.clamp(min=0)], inf)
    ndepth = _sp_depth(npptable)
    feas2 = is_inner & (nparent >= 0) & (sp.tau > 0)
    if cids is not None:
        feas2 = feas2 & _constraint_feasible(cids, sp_new, npartau, is_inner)
    w2 = torch.where(feas2, 1.0 / torch.sqrt(torch.clamp(npartau - sp.tau,
                                                          min=1e-30)),
                     torch.zeros_like(sp.tau))
    logits2 = torch.where(feas2, torch.log(torch.clamp(w2, min=1e-300)),
                          torch.full_like(w2, NEG))
    logp_y_rev = _at(logits2, y) - torch.logsumexp(logits2, 0)
    cand2 = ~_at(npptable, y, 1) & (sp.tau < tau_y) & (npartau > tau_y)
    if cids is not None:
        cand2 = cand2 & (cids == _at(cids, y))
    nx = _at(nparent, y).clamp(min=0)
    common2 = _at(npptable, nx)[None, :] & npptable
    zc2 = torch.argmax(torch.where(common2, ndepth[None, :], -1), dim=-1)
    pathlen2 = 1 + (_at(ndepth, y) - ndepth[zc2]) + (ndepth - ndepth[zc2])
    logits3 = torch.where(cand2,
                          -torch.log(torch.clamp(pathlen2, min=1).to(dt)),
                          torch.full_like(sp.tau, NEG))
    logp_b_rev = _at(logits3, b) - torch.logsumexp(logits3, 0)

    # species-model prior ratio (stree.c:8630; tau_count is unchanged by
    # SPR, so the A11 prior_A11 term cancels)
    prior_ratio = (log_species_model_prior(cfg, sp_new)
                   - log_species_model_prior(cfg, sp)).to(dt)

    # no feasible focal node or target (e.g. A11 states with everything
    # collapsed): the picks are garbage; reject outright
    bad_any = (pany(ctx.shard, (badmask & ctx.locus_mask).any())
               | ~feas_y.any() | ~cand.any())
    if cfg.theta_integrated:
        dpr = _integrated_delta(ctx, cfg, state, c_new, t2_new)
    else:
        dpr = _masked_sum(ctx, logpr_new - state.logpr)
    lnacc = (logp_y_rev - logp_y + logp_b_rev - logp_c
             + _masked_sum(ctx, lnhr) + _masked_sum(ctx, logl_new - state.logl)
             + dpr + prior_ratio)
    cand_state = state._replace(gt=gt_new, sp=sp_new, logl=logl_new,
                                logpr=logpr_new)
    if cfg.theta_integrated:
        cand_state = cand_state._replace(coal=c_new, t2h=t2_new)
    # the correlated clock's rate prior depends on the species topology
    # and taus (stree.c:8839-8844)
    if state.clock is not None and cfg.clock == Clock.CORRELATED:
        lnr_new = lnprior_rates(cfg, sp_new, state.subst.mu, state.clock)
        lnacc = lnacc + _masked_sum(ctx, lnr_new - state.clock.lnrates)
        cand_state = cand_state._replace(
            clock=state.clock._replace(lnrates=lnr_new))
    lnacc, cand_state = _traits_on(ctx, state, sp_new, lnacc, cand_state)
    lnacc = torch.where(bad_any, torch.full_like(lnacc, -float("inf")), lnacc)
    accept = rng.mh_accept(gen, lnacc)
    return (tree_where(accept, cand_state, state),
            (1, accept.to(torch.int64)))


# --------------------------------------------------------------------------
# SNL: SubNet Leap (stree_propose_stree_snl, stree.c:11354; core
# snl_expand_and_shrink:10597).  An SPR of Y (keeping child A) onto a
# branch found by a delta walk from the attachment point, combined with
# rescaling clade A's species taus and pure-A gene subtrees by
# taufactor = tau_Y_new / tau_Y_old.
# --------------------------------------------------------------------------


def _logpdf_power(y, b, lam):
    """pdf of delta = b(1-u^(1/lam)) (stree.c:10496)."""
    return (torch.log(lam / b)
            + (lam - 1.0) * torch.log(torch.clamp(1.0 - y / b, min=1e-300)))


def _log_ratio(num: float, den: float) -> float:
    """log(num / den) of two floats as float64 arithmetic gives it (-inf at
    num 0, inf at den 0): a constant of a proposal branch that may be
    computed and not taken."""
    with np.errstate(all="ignore"):
        return float(np.log(np.float64(num) / np.float64(den)))


def snl_uniform_count(H: int) -> int:
    """Uniforms an SNL proposal consumes: move type, focal node, child
    split, delta, and two a walk step over 4H + 16 steps."""
    return 4 + 2 * (4 * H + 16)


class SnlSpecies(NamedTuple):
    """SNL's species-level proposal (0-dim tensors unless noted; labels of
    the current tree).  ``lnacc`` is its part of ln acceptance, float64:
    the focal choice, the proposal densities, the reverse choice, the
    rescaled species taus' Jacobian and the root-tau prior."""

    sel: torch.Tensor
    shrink: torch.Tensor
    y: torch.Tensor
    x: torch.Tensor
    a: torch.Tensor
    b_node: torch.Tensor
    c: torch.Tensor
    lca: torch.Tensor
    went_down: torch.Tensor
    done: torch.Tensor          # the walk stopped within its steps
    wbad: torch.Tensor          # it stopped on a tip branch too short
    tau_new: torch.Tensor       # float64
    taufactor: torch.Tensor     # float64
    left: torch.Tensor          # [H] the proposed tree
    right: torch.Tensor
    parent: torch.Tensor
    tau: torch.Tensor           # [H] float64
    sp_scaled: torch.Tensor     # inner species taus rescaled
    root_new: torch.Tensor
    lnacc: torch.Tensor
    bad: torch.Tensor           # reject whatever the gene trees give


def snl_species(cfg, sp, u) -> SnlSpecies:
    """SNL's species-level part (stree.c:10406-11110, as in ``bpp_tpu``'s
    ``snl_move``) on the species arrays' device, in float64, from the
    uniforms ``u`` (``snl_uniform_count(H)`` of them, float64): the focal
    choice, the delta walk of at most 4H + 16 steps, the proposal
    densities, the new species arrays and the reverse terms.  Nothing is
    read on the host: each branch of ``bpp_tpu``'s code is a
    ``torch.where``.  The walk keeps ``bpp_tpu``'s bookkeeping but for the
    tip-landing check after the walk has stopped (module docstring)."""
    H = sp.tau.shape[0]
    NS = (H + 1) // 2
    dev = sp.tau.device
    f64 = torch.float64
    hidx = torch.arange(H, device=dev)
    left, right, parent = sp.left, sp.right, sp.parent
    tau = sp.tau.to(f64)
    pp = sp.pptable
    lam_e, lam_s = cfg.snl_lambda_expand, cfg.snl_lambda_shrink
    p_shrink = cfg.prob_snl_shrink
    inf = torch.full((), float("inf"), dtype=f64, device=dev)

    def at(x, i):
        # a read at a possibly negative label wraps, as numpy's does
        return _at(x, torch.remainder(i, H))

    partau = torch.where(parent >= 0, tau[parent.clamp(min=0)], inf)
    is_inner = hidx >= NS

    # --- weights + focal selection (init_weights, stree.c:10406) ------------
    feas = is_inner & (parent >= 0) & (tau > 0)
    w = torch.where(feas, 1.0 / torch.sqrt(torch.clamp(partau - tau,
                                                       min=1e-30)),
                    torch.zeros_like(tau))
    wnorm = w / torch.clamp(w.sum(), min=1e-300)
    logits = torch.where(feas, torch.log(torch.clamp(wnorm, min=1e-300)),
                         torch.full_like(tau, NEG))
    m = logits.max()
    cdf = torch.cumsum(torch.exp(logits - m), 0)
    sel = torch.searchsorted(cdf, (u[1] * cdf[-1]).reshape(1),
                             right=True).clamp(max=H - 1)[0]
    logp_sel = _at(logits, sel) - (m + torch.log(cdf[-1]))
    shrink = u[0] < p_shrink

    # EXPAND: y = sel, x = parent(y), (a, b) random child split,
    #         delta ~ power(x.tau, lam_e), walk starts at x
    # SHRINK: c0 = sel, y = parent(c0), a = other child of y,
    #         delta ~ power(c0.tau, lam_s), walk starts at c0, downward
    y = torch.where(shrink, at(parent, sel), sel)
    x = at(parent, y)                 # -1 possible for a shrink at the root
    left_y, right_y = at(left, y), at(right, y)
    a_exp = torch.where(u[2] < 0.5, right_y, left_y)
    a_shr = torch.where(left_y == sel, right_y, left_y)
    a = torch.where(shrink, a_shr, a_exp)
    start = torch.where(shrink, sel, x)
    xs = x.clamp(min=0)
    tau_sel, tau_x = _at(tau, sel), _at(tau, xs)
    dscale = torch.where(shrink, tau_sel, tau_x)
    lam = torch.where(shrink, torch.full_like(tau_sel, lam_s),
                      torch.full_like(tau_sel, lam_e))
    delta = dscale * (1.0 - u[3] ** (1.0 / lam))

    # --- delta walk (stree.c:11450-11510), bounded at 4H + 16 steps ------
    walk = u[4:].reshape(-1, 2)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    wbad = done
    target, prevnode, down = start, y, shrink
    tau_new = torch.zeros((), dtype=f64, device=dev)
    lca = torch.full_like(y, -1)
    zero = torch.zeros_like(delta)
    for k in range(walk.shape[0]):
        go_up = ~down & (walk[k, 0] < 0.5)
        par = at(parent, target)
        up_has_par = par >= 0
        par_s = par.clamp(min=0)
        tau_t = at(tau, target)
        dist_up = torch.where(up_has_par, _at(tau, par_s) - tau_t, inf)
        up_fits = dist_up > delta
        first_down = ~down
        lt, rt = at(left, target), at(right, target)
        other = torch.where(lt == prevnode, rt, lt)
        rand_child = torch.where(walk[k, 1] < 0.5, lt, rt)
        nxt = torch.where(first_down, other, rand_child).clamp(min=0)
        dist_dn = tau_t - _at(tau, nxt)
        # in exact arithmetic the remaining delta is always smaller than
        # the distance to any tip below; rounding can break it: stop on a
        # tip edge and flag the landing.  (bpp_tpu keeps making this check
        # after the walk has stopped, so it flags, and rejects, every
        # landing on a tip branch: from a tip, the "child" it reads is
        # tip 0 at distance 0.)
        tip_nxt = nxt < NS
        dn_fits = (dist_dn > delta) | tip_nxt
        stop = torch.where(go_up, up_fits | ~up_has_par, dn_fits)
        live = ~done
        wbad = wbad | (live & ~go_up & tip_nxt & (dist_dn <= delta))
        tau_new = torch.where(live, torch.where(go_up, tau_t + delta,
                                                tau_t - delta), tau_new)
        lca = torch.where(live & ~go_up & first_down, target, lca)
        nxt_target = torch.where(go_up, torch.where(stop, target, par_s),
                                 nxt)
        prevnode = torch.where(live, torch.where(go_up, target, nxt),
                               prevnode)
        delta = torch.where(live, torch.where(
            go_up, torch.where(up_fits, zero, delta - dist_up),
            torch.where(dn_fits, zero, delta - dist_dn)), delta)
        down = down | (live & ~go_up)
        target = torch.where(live, nxt_target, target)
        done = done | stop
    went_down = down
    c = target
    tpar = at(parent, c)
    tpar_s = tpar.clamp(min=0)

    # A11 guard: SNL needs >= 3 delimited species and a feasible focal
    # node (method.c:5438 ndspecies > 2); degenerate landings (c == y)
    ndsp_cur = (tau[NS:] > 0).sum() + 1
    bad = ~done | wbad | ~feas.any() | (ndsp_cur <= 2) | (c == y)

    # --- proposal-density corrections (stree.c:11512-11552) ------------------
    tau_y, tau_c = at(tau, y), at(tau, c)
    tau_tp = _at(tau, tpar_s)
    tiny = 1e-300
    # shrink (--)
    d_rev = tau_y - tau_tp
    bad_sh = (d_rev >= tau_tp) | (tpar < 0)
    term_sh = (_logpdf_power(torch.clamp(d_rev, min=tiny),
                             torch.clamp(tau_tp, min=tiny), lam_e)
               + math.log(0.5)
               - _logpdf_power(tau_sel - tau_new, tau_sel, lam_s)
               + _log_ratio(1 - p_shrink, p_shrink))
    # pure expand (++)
    d_rev_pe = tau_c - tau_y
    bad_pe = d_rev_pe >= tau_c
    term_pe = (_logpdf_power(torch.clamp(d_rev_pe, min=tiny), tau_c, lam_s)
               - math.log(0.5)
               - _logpdf_power(tau_new - tau_x, tau_x, lam_e)
               + _log_ratio(p_shrink, 1 - p_shrink))
    # expand with downward steps (+-)
    tau_lca = _at(tau, lca.clamp(min=0))
    dist_fw = tau_lca - tau_x + tau_lca - tau_new
    dist_rev = tau_lca - tau_y + tau_lca - tau_tp
    bad_ed = (dist_rev >= tau_tp) | (tpar < 0)
    term_ed = (_logpdf_power(torch.clamp(dist_rev, min=tiny),
                             torch.clamp(tau_tp, min=tiny), lam_e)
               - _logpdf_power(torch.clamp(dist_fw, min=tiny), tau_x, lam_e))
    pure_expand = ~shrink & ~went_down
    bad = bad | torch.where(shrink, bad_sh,
                            torch.where(pure_expand, bad_pe, bad_ed))
    term = torch.where(shrink, term_sh,
                       torch.where(pure_expand, term_pe, term_ed))
    lnacc = -logp_sel.to(f64) + term
    taufactor = tau_new / tau_y

    # --- species-tree surgery (stree.c:11000-11060) --------------------------
    b_node = torch.where(left_y == a, right_y, left_y)

    def put(arr, i, v):
        return arr.index_copy(0, torch.remainder(i, H).reshape(1),
                              v.reshape(1))

    def replace_child(nl, nr, par, old, new):
        has = par >= 0
        lv, rv = at(nl, par), at(nr, par)
        nl = put(nl, par, torch.where(has & (lv == old), new, lv))
        nr = put(nr, par, torch.where(has & (rv == old), new, rv))
        return nl, nr

    nleft, nright = replace_child(left, right, x, y, b_node)
    nparent = put(parent, b_node, x)
    nleft, nright = replace_child(nleft, nright, tpar, c, y)
    nparent = put(nparent, y, tpar)
    a_left = left_y == a
    nright = put(nright, y, torch.where(a_left, c, at(nright, y)))
    nleft = put(nleft, y, torch.where(a_left, at(nleft, y), c))
    nparent = put(nparent, c, y)
    # taus: y at tau_new, clade-A species taus scaled
    in_a = at(pp.T, a)
    scaled = in_a & (tau > 0)
    ntau = put(torch.where(scaled, tau * taufactor, tau), y, tau_new)
    sp_scaled = (scaled & is_inner).sum()

    # reverse-weight term (new tree): expand-down -> weight of the
    # target's new parent (y), pure expand -> the target's, shrink -> y's
    npartau = torch.where(nparent >= 0, ntau[nparent.clamp(min=0)], inf)
    feas2 = is_inner & (nparent >= 0) & (ntau > 0)
    w2 = torch.where(feas2, 1.0 / torch.sqrt(torch.clamp(npartau - ntau,
                                                         min=1e-30)),
                     torch.zeros_like(ntau))
    w2 = w2 / torch.clamp(w2.sum(), min=1e-300)
    rev_node = torch.where(shrink | went_down, y, c)
    lnacc = lnacc + torch.log(torch.clamp(at(w2, rev_node), min=tiny))
    lnacc = lnacc + sp_scaled.to(f64) * torch.log(taufactor)
    # root-tau prior (stree.c:11090-11110); the root is node H - 1
    tau0 = tau[H - 1]
    root_new = torch.argmax((nparent < 0).to(torch.uint8))
    tau0n = _at(ntau, root_new)
    ta, tb = cfg.tauprior.alpha, cfg.tauprior.beta
    nd2 = (ndsp_cur - 2).to(f64)
    if cfg.tauprior.dist == PriorDist.INVGAMMA:
        rt = ((-ta - 1 - nd2) * torch.log(tau0n / tau0)
              - tb * (1 / tau0n - 1 / tau0))
    else:
        rt = ((ta - 1 - nd2) * torch.log(tau0n / tau0) - tb * (tau0n - tau0))
    lnacc = lnacc + torch.where((tau0n - tau0).abs() > 1e-20, rt, zero)
    return SnlSpecies(
        sel=sel, shrink=shrink, y=y, x=x, a=a, b_node=b_node, c=c, lca=lca,
        went_down=went_down, done=done, wbad=wbad, tau_new=tau_new,
        taufactor=taufactor, left=nleft, right=nright, parent=nparent,
        tau=ntau, sp_scaled=sp_scaled, root_new=root_new, lnacc=lnacc,
        bad=bad | ~torch.isfinite(lnacc))


def _root_last(root_new, H: int):
    """The label permutation (an involution, the identity when the root is
    already last) that brings ``root_new`` to index H - 1."""
    hidx = torch.arange(H, device=root_new.device)
    last = torch.full_like(hidx, H - 1)
    return torch.where(hidx == root_new, last,
                       torch.where(hidx == H - 1, root_new, hidx))


def _relabel(arr, perm):
    """Node pointers ``arr`` [H] under the label permutation ``perm``."""
    out = arr[perm]
    return torch.where(out >= 0, perm[out.clamp(min=0)], out)


def snl_move(ctx: Ctx, cfg: BppConfig, state: McmcState, gen, u=None):
    """SNL proposal.  ``u``: the ``snl_uniform_count`` float64 uniforms of
    the species-level part, drawn by the caller with its SNL-or-SPR draw;
    without it the move draws them from ``gen``."""
    gt, sp = state.gt, state.sp
    L, N, T = gt.n_loci, gt.n_nodes, gt.n_tips
    H = sp.n_nodes
    dev = gt.age.device
    dt = sp.tau.dtype
    hidx = torch.arange(H, device=dev)
    nodes_idx = torch.arange(N, device=dev)[None, :]
    logl_fn = make_logl_fn(ctx, cfg)
    logpr_fn = make_logpr_fn(ctx)
    if u is None:
        u = rng.uniform(gen, (snl_uniform_count(H),), torch.float64, dev)
    spc = snl_species(cfg, sp, u)
    y, a, b_node, c = spc.y, spc.a, spc.b_node, spc.c
    bad = spc.bad
    # a degenerate factor only comes with a rejected proposal
    tf = spc.taufactor
    taufactor = torch.where(bad | ~(torch.isfinite(tf) & (tf > 0)),
                            torch.ones_like(tf), tf)
    # the new tree in the current labels (the gene-tree part reads them)
    nparent, ntau = spc.parent, spc.tau.to(dt)
    npptable = _recompute_pptable(nparent, H)

    # --- gene-tree painting --------------------------------------------------
    order = inner_order(gt)
    pops = assign_populations(gt, sp, ctx.tip_pop)
    age = gt.age
    # a proposal with no feasible focal node (rejected) may carry label -1
    tip_under_a = _at(sp.pptable, torch.remainder(a, H), 1)[ctx.tip_pop]
    pureA = topo_scan(gt, tip_under_a, torch.logical_and, order)
    # the branch above a gene tree's root is a target (and a source) too:
    # a rescaled node may rise above its tree's root (bpp_tpu rejects
    # those proposals, whose reverse moves it accepts: ROADMAP Queue 3)
    page, valid_branch, valid_inner = _branch_frame(gt, ctx, age,
                                                    with_root=True)
    lc = gt.left.clamp(min=0)
    rc = gt.right.clamp(min=0)
    lA, rA = torch.gather(pureA, 1, lc), torch.gather(pureA, 1, rc)
    moved = valid_inner & (lA ^ rA) & ctx.locus_mask[:, None]
    pruned = torch.where(lA, gt.left, gt.right)
    intact = torch.where(lA, gt.right, gt.left)
    # new ages: pure-A inner and moved nodes scale by taufactor
    scale_mask = (pureA | moved) & valid_inner
    tnew_all = age * taufactor.to(dt)
    age_new = torch.where(scale_mask, tnew_all, age)
    g_scaled = psum(ctx.shard, (scale_mask & ctx.locus_mask[:, None]).sum())

    # newpop of every node at its new age (stree.c:10680-10700): y and the
    # target's new ancestors, the deepest with tau <= tnew, mapped back to
    # the current labels (y -> c, b -> y)
    anc_t_new = _at(npptable, torch.remainder(c, H)) & (hidx != c)
    inf = torch.full_like(ntau, float("inf"))
    rway_tau = torch.where(anc_t_new, ntau, inf)
    below = rway_tau[None, None, :] <= tnew_all[..., None]
    score = torch.where(below, torch.where(rway_tau == float("inf"), -inf,
                                           rway_tau)[None, None, :],
                        -float("inf"))
    npop_new = torch.argmax(score, dim=-1)
    npop_new = torch.where(below.any(-1), npop_new, y)
    npop_old = torch.where(npop_new == y, c,
                           torch.where(npop_new == b_node, y, npop_new))

    # --- identification: targets at the new times, sources at the old ----
    page_new, _, _ = _branch_frame(gt, ctx, age_new, with_root=True)
    tnew = tnew_all[:, T:, None]
    spans = (valid_branch[:, None, :] & (age_new[:, None, :] < tnew)
             & (page_new[:, None, :] > tnew))
    tmask = (spans & ~pureA[:, None, :]
             & sp.pptable[pops[:, None, :], npop_old[:, T:, None]])
    otime = age[:, T:, None]
    spans_o = (valid_branch[:, None, :] & (age[:, None, :] < otime)
               & (page[:, None, :] > otime))
    inner_ids = torch.arange(T, N, device=dev)[None, :, None]
    smask = (spans_o & ~pureA[:, None, :]
             & sp.pptable[pops[:, None, :], pops[:, T:, None]]
             & (nodes_idx[:, None, :] != intact[:, T:, None])
             & (nodes_idx[:, None, :] != inner_ids))
    lnhr, badmask, targets = _identify(gen, moved, tmask, smask, T, dt,
                                       ctx.shard)
    # targets that are themselves moved nodes resolve down to their
    # intact child (stree.c:10725 "trace towards tips until BLACK")
    down = _jump(torch.where(moved, intact, nodes_idx.expand(L, N)),
                 max(1, (N - 1).bit_length()))
    targets = torch.where(targets >= 0,
                          torch.gather(down, 1, targets.clamp(min=0)),
                          targets)

    # --- application: sequential prune + regraft with the new ages ----------
    gl, gr, gp = _prune_regraft(gt, moved & ~badmask[:, None], pruned,
                                targets, age_new, tnew_all)
    gt_new = gt._replace(left=torch.where(bad, gt.left, gl),
                         right=torch.where(bad, gt.right, gr),
                         parent=torch.where(bad, gt.parent, gp), age=age_new)

    # keep the root at index H - 1 (see the module docstring): the labels
    # of the old and the new root swap (the identity when it stays)
    perm = _root_last(spc.root_new, H)
    clock = state.clock
    theta = sp.theta[perm]
    if clock is not None and cfg.clock != Clock.CORRELATED:
        clock = clock._replace(brate=clock.brate[:, perm])
    nparent = _relabel(spc.parent, perm)
    npptable = _recompute_pptable(nparent, H)
    sp_new = sp._replace(left=_relabel(spc.left, perm),
                         right=_relabel(spc.right, perm), parent=nparent,
                         tau=ntau[perm], theta=theta, pptable=npptable,
                         mrca=_recompute_mrca(npptable))

    # --- full re-evaluation + remaining acceptance terms ---------------------
    logl_new = logl_fn(gt_new, state.subst, sp_new, clock)
    logpr_new, c_new, t2_new = logpr_fn(gt_new, sp_new, state.subst.heredity)
    # Jacobian of the gene-node rescaling + species-model prior
    lnacc = (spc.lnacc.to(dt) + g_scaled.to(dt) * torch.log(taufactor).to(dt)
             + (log_species_model_prior(cfg, sp_new)
                - log_species_model_prior(cfg, sp)).to(dt)
             + psum(ctx.shard, lnhr.sum())
             + _masked_sum(ctx, (logl_new - state.logl)
                           + (logpr_new - state.logpr)))
    cand_state = state._replace(gt=gt_new, sp=sp_new, logl=logl_new,
                                logpr=logpr_new, clock=clock)
    if cfg.theta_integrated:
        lnacc = (lnacc + _integrated_delta(ctx, cfg, state, c_new, t2_new)
                 - _masked_sum(ctx, logpr_new - state.logpr))
        cand_state = cand_state._replace(coal=c_new, t2h=t2_new)
    # the correlated clock's rate prior (stree.c:11314-11318)
    if clock is not None and cfg.clock == Clock.CORRELATED:
        lnr_new = lnprior_rates(cfg, sp_new, state.subst.mu, clock)
        lnacc = lnacc + _masked_sum(ctx, lnr_new - state.clock.lnrates)
        cand_state = cand_state._replace(
            clock=clock._replace(lnrates=lnr_new))
    bad_any = (pany(ctx.shard, badmask.any()) | ~torch.isfinite(lnacc)
               | bad)
    lnacc, cand_state = _traits_on(ctx, state, sp_new, lnacc, cand_state)
    lnacc = torch.where(bad_any, torch.full_like(lnacc, -float("inf")), lnacc)
    accept = rng.mh_accept(gen, lnacc)
    return (tree_where(accept, cand_state, state),
            (1, accept.to(torch.int64)))
