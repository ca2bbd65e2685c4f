"""MSC (multispecies coalescent) log-density, batched over loci (PyTorch).

Port of ``bpp_tpu/trees/coalescent.py`` (``per_pop_stats``,
``per_pop_stats_dated``, ``phi_entry_counts``, ``msc_contrib``,
``msc_logprob``, ``msc_logprob_integrated``) for plain species trees and
MSC-I networks; on a network an edge's populations are those its route
visits (``gtree.edge_passes``).  Per
population h with n_in entering lineages and k coalescences at sorted
times t_1..t_k inside [tau_h, tau_parent_h):

  T2h      = sum_i n_i (n_i - 1) (t_i+1 - t_i)      (n decrements at events)
  contrib  = k log(2 / (heredity * theta_h)) - T2h / (heredity * theta_h)
"""

from __future__ import annotations

import torch

from ..parallel.mesh import psum
from .gtree import GTrees, SpeciesArrays, edge_passes

_FINITE_BIG = 1.0e12


def _parent_age(gt: GTrees):
    page = torch.gather(gt.age, 1, gt.parent.clamp(min=0))
    return torch.where(gt.parent >= 0, page,
                       torch.full_like(page, _FINITE_BIG))


def _pop_end(sp: SpeciesArrays):
    par = sp.parent
    partau = torch.where(par >= 0, sp.tau[par.clamp(min=0)],
                         torch.full_like(sp.tau, float("inf")))
    return torch.clamp(partau, max=_FINITE_BIG)                # [H]


def _visits(gt: GTrees, sp: SpeciesArrays, pops):
    """``[L, N, H]`` bool: the populations each edge passes through (its
    population's ancestors on a tree, its route on a network)."""
    if sp.is_network:
        return edge_passes(gt, sp, pops)
    return sp.pptable[pops]


def per_pop_stats(gt: GTrees, sp: SpeciesArrays, pops, n_seq):
    """Coalescent counts and waiting-time sums per (locus, population).

    Returns (coal ``[L, H]`` int64, T2h ``[L, H]`` float, n_in ``[L, H]``
    int64).  Every lineage enters population h at ``tau_h`` and the
    count only decreases, so Abel summation gives the closed event-rank
    form

      T2h = (n_in - k)(n_in - k - 1) end_h - n_in (n_in - 1) tau_h
            + sum_events 2 (n_in - rank_e) t_e

    with ``rank_e`` the event's 1-based time rank within its population.
    Batches hold at least two tip slots (``pack_loci`` pads to two).
    """
    L, N = pops.shape
    T = gt.n_tips
    H = sp.n_nodes
    dev = pops.device
    node_idx = torch.arange(N, device=dev)[None, :]
    is_tip = node_idx < n_seq[:, None]
    is_inner = (node_idx >= T) & (node_idx < T + n_seq[:, None] - 1)
    valid = is_tip | is_inner

    tau = sp.tau
    end = _pop_end(sp)
    page = _parent_age(gt)
    pres = _visits(gt, sp, pops) & valid[..., None]     # [L, N, H]

    # lineages entering each population (at tau_h)
    inh = pres & (gt.age[..., None] <= tau) & (tau < page[..., None])
    n_in = inh.sum(dim=1)                                      # [L, H]

    # coalescent events per population
    ev_pop = torch.where(is_inner, pops, -1)                   # [L, N]
    ev_oh = ev_pop[:, T:, None] == torch.arange(H, device=dev)  # [L, T-1, H]
    coal = ev_oh.sum(dim=1)                                    # [L, H]

    # event ranks within their population: 1 + #(earlier same-pop events)
    ia = gt.age[:, T:]                                         # [L, T-1]
    inn = is_inner[:, T:]
    same = (ev_pop[:, T:, None] == ev_pop[:, None, T:]) \
        & inn[:, :, None] & inn[:, None, :]
    iidx = torch.arange(T - 1, device=dev)
    earlier = (ia[:, None, :] < ia[:, :, None]) | (
        (ia[:, None, :] == ia[:, :, None])
        & (iidx[None, None, :] < iidx[None, :, None]))
    rank = 1 + (same & earlier).sum(dim=2).to(ia.dtype)        # [L, T-1]

    ev_ohf = ev_oh.to(ia.dtype)
    n_inf = n_in.to(ia.dtype)
    n_in_e = torch.einsum("leh,lh->le", ev_ohf, n_inf)
    contrib = 2.0 * (n_in_e - rank) * ia * inn.to(ia.dtype)
    # each population's events summed over the innermost axis of [L, H,
    # E], in an order set by E alone: a batched matmul (einsum) picks its
    # kernel, and so its order, from the batch shape, and inside the
    # batched step (vmap over the chains) would round otherwise than one
    # chain's step
    ev_sum = torch.sum(ev_ohf.transpose(1, 2) * contrib[:, None, :], dim=2)

    k_f = coal.to(ia.dtype)
    nk = n_inf - k_f
    T2h = nk * (nk - 1.0) * end - n_inf * (n_inf - 1.0) * tau + ev_sum
    # pops with no entering lineages contribute exactly 0
    T2h = torch.where(n_in > 0, T2h, torch.zeros_like(T2h))
    return coal, T2h, n_in


def per_pop_stats_dated(gt: GTrees, sp: SpeciesArrays, pops, n_seq):
    """Serial-sampling (dated tips) variant of :func:`per_pop_stats`.

    A dated tip enters its population at its own age, not at ``tau_h``,
    so the count does not only decrease and the Abel form does not hold.
    T2h is the summed pairwise coexistence time of distinct lineage
    edges inside ``[tau_h, end_h)`` instead (O(N^2 H)); equal to
    :func:`per_pop_stats` when every tip age is 0."""
    L, N = pops.shape
    T = gt.n_tips
    H = sp.n_nodes
    dev = pops.device
    node_idx = torch.arange(N, device=dev)[None, :]
    is_tip = node_idx < n_seq[:, None]
    is_inner = (node_idx >= T) & (node_idx < T + n_seq[:, None] - 1)
    valid = is_tip | is_inner

    tau = sp.tau
    end = _pop_end(sp)
    page = _parent_age(gt)
    pres = _visits(gt, sp, pops) & valid[..., None]     # [L, N, H]

    inh = pres & (gt.age[..., None] <= tau) & (tau < page[..., None])
    n_in = inh.sum(dim=1)                                      # [L, H]
    ev_in_h = (torch.where(is_inner, pops, -1)[..., None]
               == torch.arange(H, device=dev))                  # [L, N, H]
    coal = ev_in_h.sum(dim=1)                                  # [L, H]

    # presence interval of edge u inside pop h (empty: lo == hi == end)
    lo = torch.minimum(torch.maximum(gt.age[..., None], tau), end)
    hi = torch.minimum(torch.maximum(page[..., None], tau), end)
    lo = torch.where(pres, lo, end.expand_as(lo))
    hi = torch.where(pres, hi, end.expand_as(hi))
    ov = torch.clamp(
        torch.minimum(hi[:, :, None], hi[:, None, :])
        - torch.maximum(lo[:, :, None], lo[:, None, :]), min=0.0)
    # the diagonal is excluded, not subtracted: root intervals reach 1e12
    # and a subtraction would cancel catastrophically in float32
    off = 1.0 - torch.eye(N, dtype=ov.dtype, device=dev)
    T2h = (ov * off[None, :, :, None]).sum((1, 2))             # [L, H]
    return coal, T2h, n_in


def phi_entry_counts(sp: SpeciesArrays, n_in):
    """Entry counts of the phi terms, ``[L, H]``.

    Lineages entering a hinner pay log(phi), those entering a mirror
    log(1 - phi), so these are ``n_in``.  But ``n_in`` of a BDI hinner X
    also counts the switchers from the partner side, which enter X at the
    shared tau after passing the partner's mirror and paid
    log(phi[mirror_Y]) there already: they are taken off (the reference
    counts them through per-mirror seqin, gtree.c:3925)."""
    if sp.bdi_partner is None:
        return n_in
    part = sp.bdi_partner
    has = part >= 0
    pmir = torch.where(has, sp.hybrid[part.clamp(min=0)],
                       torch.zeros_like(part))
    sub = torch.where(has[None, :], n_in[:, pmir], torch.zeros_like(n_in))
    return n_in - sub


def msc_contrib(coal, T2h, theta, heredity):
    """Per-(locus, population) MSC log-density contributions ``[L, H]``."""
    th = torch.clamp(theta[None, :] * heredity[:, None], min=1e-300)
    return coal * torch.log(2.0 / th) - T2h / th


def msc_logprob(gt: GTrees, sp: SpeciesArrays, pops, n_seq, heredity):
    """Total MSC log-density per locus ``[L]`` (theta-estimated path)."""
    coal, T2h, _ = per_pop_stats(gt, sp, pops, n_seq)
    return msc_contrib(coal, T2h, sp.theta, heredity).sum(dim=1)


def locus_sum(x):
    """``x`` [L, ...] summed over its leading (locus) axis by pairwise
    adds of whole halves, in an order set by L alone.  A CUDA reduction
    picks its order from the shape it is given: inside the batched step
    (``vmap``, which hands it the K chains' rows together) a sum over
    the loci of an [L, X] tensor rounds otherwise than the one-chain
    step's, and a chain drifts from its one-chain run; elementwise adds
    round alike either way."""
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        pair = x[:h] + x[h:2 * h]
        x = pair if x.shape[0] == 2 * h else torch.cat([pair, x[2 * h:]])
    return x[0]


def msc_logprob_integrated(coal, T2h, heredity, a, b, locus_mask,
                           shard=None):
    """The theta-integrated-out total log density over all loci (scalar).

    Each population's theta is marginalized under InvGamma(a, b):
      2^K b^a Gamma(a+K) / (Gamma(a) (b+C)^(a+K)) * prod_l h_l^(-k_l)
    with K = sum_l k_l and C = sum_l T2_l / h_l over the real loci
    (over every rank's loci under locus sharding, ``shard``), each sum in
    :func:`locus_sum`'s fixed order."""
    mask = locus_mask[:, None]
    zero = torch.zeros_like(T2h)
    K, C, hterm = locus_sum(torch.stack([
        torch.where(mask, coal.to(T2h.dtype), zero),
        torch.where(mask, T2h / heredity[:, None], zero),
        torch.where(mask, coal * torch.log(2.0 / heredity[:, None]), zero)],
        1))                                                     # [3, H]
    if shard is not None:
        K, C, hterm = psum(shard, K, C, hterm)
    a_t = torch.full_like(C, a)
    lg = (a * torch.log(torch.full_like(C, b)) - torch.lgamma(a_t)
          + torch.lgamma(a + K) - (a + K) * torch.log(b + C))
    return torch.sum(hterm + lg)
