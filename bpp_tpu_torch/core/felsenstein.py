"""Batched Felsenstein pruning over ``[loci, sites, cats, states]`` (PyTorch).

Port of ``bpp_tpu/core/felsenstein.py``, at 4 or 20 states.  All loci
are processed together by an age-ordered loop: step ``k`` updates inner
node ``order[l, k]`` of every locus ``l`` at once, and every level is
rescaled by the per-site max (log-scale accumulator).  This is the CPU
path, the plain version that kernels K1 (``core/pack.py``) and K2
(``core/fels.py``) are held against, and the 20-state pass on any
device.
"""

from __future__ import annotations

import torch

from ..trees.gtree import BIG_AGE, GTrees, edge_passes, inner_order


def branch_lengths(gt: GTrees, rate):
    """Per-node branch length to parent, scaled by per-locus ``rate [L]``.

    Root/padded nodes (parent == -1) get 0; transient parent-child
    inversions of a few ulps read as zero-length branches."""
    page = torch.gather(gt.age, 1, gt.parent.clamp(min=0))
    blen = torch.where(gt.parent >= 0, torch.clamp(page - gt.age, min=0.0),
                       torch.zeros_like(page))
    return blen * rate[:, None]


def relaxed_segments(gt: GTrees, sp, pops):
    """Time each gene-tree edge spends in each population, ``[L, N, H]``.

    The edge of node u spans ``[age_u, age_parent_u)`` and climbs from
    population ``pops[u]``; its overlap with a population h it passes
    through is ``max(0, min(t_parent, tau_top(h)) - max(t_u, tau_h))``,
    and 0 with every other population.  On a plain tree it passes through
    the ancestors of ``pops[u]`` (``pptable[pops]``), on an MSC-I network
    through the populations of its route (``gtree.edge_passes``); a
    zero-length hybridization segment (htau == 0) adds 0 by itself.
    Depends on the gene trees, the taus and the populations only, so a
    sweep over branch rates computes it once."""
    tau = sp.tau
    par = sp.parent
    partau = torch.where(par >= 0, tau[par.clamp(min=0)],
                         torch.full_like(tau, BIG_AGE))
    page = torch.gather(gt.age, 1, gt.parent.clamp(min=0))      # [L, N]
    visits = (edge_passes(gt, sp, pops) if sp.is_network
              else sp.pptable[pops])                            # [L, N, H]
    lo = torch.maximum(gt.age[..., None], tau[None, None, :])
    hi = torch.minimum(page[..., None], partau[None, None, :])
    seg = torch.clamp(hi - lo, min=0.0)
    return torch.where(visits, seg, torch.zeros_like(seg))


def relaxed_branch_lengths(gt: GTrees, sp, pops, brate):
    """Per-node branch lengths under a relaxed clock ``[L, N]``.

    Port of ``bpp_tpu/core/felsenstein.py`` ``relaxed_branch_lengths``
    (src/locus.c:1151): the rate-weighted sum of an edge's overlap with
    every population it crosses,

      len_u = sum_h visits[u, h] * brate[l, owner(h)] * overlap(u, h),

    where a BDI mirror's rate is its hinner partner's (``rate_owner``)."""
    return segment_lengths(gt, relaxed_segments(gt, sp, pops), brate,
                           sp.rate_owner)


def segment_lengths(gt: GTrees, seg, brate, owner=None):
    """:func:`relaxed_branch_lengths` from the segments ``seg`` of
    :func:`relaxed_segments`: the same numbers, bit for bit.  ``owner``
    is the network's ``rate_owner`` (None: every population its own)."""
    if owner is not None:
        brate = brate[:, owner]
    blen = torch.sum(seg * brate[:, None, :], dim=-1)
    return torch.where(gt.parent >= 0, blen, torch.zeros_like(blen))


def tip_partials_from_codes(codes, dtype=torch.float32, n_states=4):
    """Expand ambiguity masks ``[L, T, S]`` to 0/1 partials
    ``[L, T, S, A]``."""
    codes = codes.to(torch.int64)
    bits = torch.arange(n_states, dtype=torch.int64, device=codes.device)
    return ((codes[..., None] >> bits) & 1).to(dtype)


def reduce_root(site_logl, weights, res_map=None, res_count=None):
    """Weighted per-site reduction ``[L]`` with diploid resolution
    averaging: a flat per-locus sum.

    ``site_logl [L, S]`` are per-likelihood-pattern log-likelihoods; with
    ``res_map [L, W, R]`` / ``res_count [L, W]`` each weight pattern
    averages its resolution columns (locus.c:2587-2614), in log space by
    a masked log-mean-exp so that per-pattern scaling is respected.
    Without a map ``site_logl`` may be wider than ``weights``; the tail
    is padding."""
    if res_map is None:
        return torch.sum(weights * site_logl[:, :weights.shape[1]], dim=1)
    L, W, R = res_map.shape
    if R == 1:
        gathered = torch.gather(site_logl, 1, res_map[..., 0])
        return torch.sum(weights * gathered, dim=1)
    vals = torch.gather(site_logl, 1, res_map.reshape(L, W * R))
    vals = vals.reshape(L, W, R)
    valid = torch.arange(R, device=vals.device) < res_count[..., None]
    vals = torch.where(valid, vals, torch.full_like(vals, -1e30))
    m = torch.amax(vals, dim=-1)
    sumexp = torch.sum(torch.where(valid, torch.exp(vals - m[..., None]),
                                   torch.zeros_like(vals)), dim=-1)
    logmean = m + torch.log(sumexp) - torch.log(res_count.to(vals.dtype))
    return torch.sum(weights * logmean, dim=1)


def _pclv(P, x):
    """Parent partial ``sum_b P[l,c,a,b] x[l,s,c,b] -> [L, S, C, A]``: a
    broadcast multiply-sum at 4 states, a batched matmul at 20 (full
    float32 on the card: ``driver.resolve_device`` turns TF32 off)."""
    if P.shape[-1] >= 20:
        return torch.einsum("lcab,lscb->lsca", P, x)
    return torch.sum(P[:, None] * x[:, :, :, None, :], dim=-1)


def site_loglikelihood(
    gt: GTrees,
    tip_partials,      # [L, T, S, A]
    n_seq,             # [L]
    pmats,             # [L, N, C, A, A] P(branch above node i)
    freqs,             # [L, A]
    cat_weights,       # [C] or [L, C]
    order=None,        # [L, T-1] precomputed schedule (optional)
):
    """Log-likelihood of every likelihood pattern: ``[L, S]``."""
    L, T, S, A = tip_partials.shape
    N = 2 * T - 1
    C = pmats.shape[2]
    dtype = tip_partials.dtype
    dev = tip_partials.device
    lidx = torch.arange(L, device=dev)
    if order is None:
        order = inner_order(gt)

    clv = torch.zeros((L, N, S, C, A), dtype=dtype, device=dev)
    clv[:, :T] = tip_partials[:, :, :, None, :]
    logscale = torch.zeros((L, S), dtype=dtype, device=dev)
    tiny = 1e-30
    for k in range(T - 1):
        node = order[:, k]
        lc = gt.left[lidx, node]
        rc = gt.right[lidx, node]
        y = _pclv(pmats[lidx, lc], clv[lidx, lc]) \
            * _pclv(pmats[lidx, rc], clv[lidx, rc])
        m = torch.amax(y, dim=(2, 3), keepdim=True)
        msafe = torch.clamp(m, min=tiny)
        y = y / msafe
        valid = k < n_seq - 1
        logscale = logscale + torch.where(
            valid[:, None], torch.log(msafe[:, :, 0, 0]),
            torch.zeros_like(logscale))
        clv[lidx, node] = y

    root = order[lidx, n_seq - 2]
    root_clv = clv[lidx, root]                                  # [L,S,C,A]
    cw = cat_weights if cat_weights.dim() == 2 else cat_weights[None, :]
    cw = cw.expand(L, C)
    site_lik = torch.sum(root_clv * freqs[:, None, None, :]
                         * cw[:, None, :, None], dim=(2, 3))
    return torch.log(torch.clamp(site_lik, min=tiny)) + logscale


def loglikelihood(
    gt: GTrees,
    tip_partials,      # [L, T, S, A]
    weights,           # [L, W]
    n_seq,             # [L]
    pmats,             # [L, N, C, A, A] P(branch above node i)
    freqs,             # [L, A]
    cat_weights,       # [C] or [L, C]
    order=None,        # [L, T-1] precomputed schedule (optional)
    return_site=False,
    res_map=None,      # [L, W, R] resolution columns per weight pattern
    res_count=None,    # [L, W]
):
    """Log-likelihood of every locus: ``[L]``."""
    site_logl = site_loglikelihood(gt, tip_partials, n_seq, pmats, freqs,
                                   cat_weights, order=order)
    logl = reduce_root(site_logl, weights, res_map, res_count)
    if return_site:
        return logl, site_logl
    return logl
