"""The theta-integrated-out ("notheta") MSC density, PyTorch.

Port of ``bpp_tpu/mcmc/notheta.py``.  ``thetaprior = invgamma a b int``
integrates every population's theta out of the MSC density under its
conjugate inverse-gamma prior (reference gtree.c:3780
``update_logpg_contrib``).  The density no longer factorizes over loci:
each population's term couples all loci through the aggregated
coalescent counts K_h and waiting-time sums C_h,

  logPG = sum_h [ K_h log 2 - sum_l k_lh log(h_l) + a log b - lgamma(a)
                  + lgamma(a + K_h) - (a + K_h) log(b + C_h) ].

Batched per-locus proposals stay batched: the likelihood deltas and the
candidate (k, T2) rows of all loci are computed together on the device.
Only the accept decisions form an exact serial chain over loci, carrying
the running K/C sums.  On the card that chain would be thousands of tiny
launches, so :func:`scan_accept` runs it on the host in float64 numpy:
one copy of its inputs to the host and one copy of the accept mask back
per move, the pattern of the Gamma-Dirichlet locus-rate chain
(``clock_moves._gammadir_chain``).  Under locus sharding every rank runs
the whole chain on the gathered inputs of all loci and keeps its rows of
the decisions, and the K/C sums are all-reduced.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..parallel.mesh import gather_loci, psum
from ..trees import coalescent as coalmod
from . import rng


def total_integrated(cfg, coal, t2h, heredity, locus_mask, shard=None):
    """Scalar integrated logPG over all loci (notheta_logpr); ``shard``:
    the sums run over every rank's loci."""
    return coalmod.msc_logprob_integrated(
        coal, t2h, heredity, cfg.thetaprior.alpha, cfg.thetaprior.beta,
        locus_mask, shard)


def pop_sums(coal, t2h, heredity, locus_mask):
    """Aggregated (K [H], C [H]) over the real loci."""
    mask = locus_mask[:, None]
    zero = torch.zeros_like(t2h)
    K = torch.where(mask, coal.to(t2h.dtype), zero).sum(0)
    C = torch.where(mask, t2h / heredity[:, None], zero).sum(0)
    return K, C


def accept_chain(a: float, b: float, K0, C0, co, cn, to, tn, dother, dh,
                 logu, mask) -> np.ndarray:
    """The serial accept chain of :func:`scan_accept` in float64 numpy.

    ``K0``/``C0`` [H] the starting sums; per locus ``co``/``cn`` the old
    and candidate counts [L, H], ``to``/``tn`` the old and candidate
    heredity-scaled waiting sums, ``dother`` the locus-factorizing part of
    ln acceptance, ``dh`` the heredity/log 2 term delta, ``logu`` the log
    of the uniform draw, ``mask`` whether the locus proposes.  A locus
    whose rows are unchanged contributes 0 to the coupled term, so only
    the changed populations are evaluated."""
    def term(k, c):
        return math.lgamma(a + k) - (a + k) * math.log(b + c)

    # plain Python floats: H is a handful of populations, and numpy's
    # per-call cost would dominate a loop over a thousand loci
    K = [float(k) for k in K0]
    C = [float(c) for c in C0]
    g = [term(k, c) for k, c in zip(K, C)]
    dK = (np.asarray(cn) - np.asarray(co)).tolist()
    dC = (np.asarray(tn) - np.asarray(to)).tolist()
    lhs = np.asarray(logu, np.float64).tolist()
    rhs = (np.asarray(dother, np.float64)
           + np.asarray(dh, np.float64)).tolist()
    accept = np.zeros(len(lhs), bool)
    for i in np.flatnonzero(mask).tolist():
        dk, dc = dK[i], dC[i]
        dlg = 0.0
        upd = []
        for h in range(len(K)):
            if dk[h] != 0.0 or dc[h] != 0.0:
                k, c = K[h] + dk[h], C[h] + dc[h]
                x = term(k, c)
                dlg += x - g[h]
                upd.append((h, k, c, x))
        if lhs[i] < rhs[i] + dlg:
            accept[i] = True
            for h, k, c, x in upd:
                K[h], C[h], g[h] = k, c, x
    return accept


def scan_accept(gen, cfg, dother, coal_o, t2_o, h_o, coal_n, t2_n, h_n,
                mask, locus_mask, shard=None):
    """Exact serial MH accept chain over loci for per-locus proposals.

    Args:
      dother: [L] the locus-factorizing part of ln acceptance
        (likelihood delta + proposal asymmetry + per-locus priors).
      coal_o/t2_o/h_o: current per-locus stats [L,H]/[L,H]/[L].
      coal_n/t2_n/h_n: candidate stats (rows where ``mask`` is False
        must equal the old rows).
      mask: [L] which loci propose.
      locus_mask: [L] real (non-padded) loci.
      shard: the locus sharding (``parallel.mesh.Shard``) or None.

    Returns accept [L] bool on the device.  The uniforms are drawn on the
    device from ``gen``; the chain runs on the host."""
    H = coal_o.shape[1]
    dev, dt = t2_o.device, t2_o.dtype
    t2c_o = t2_o / h_o[:, None]
    t2c_n = t2_n / h_n[:, None]
    K0, C0 = pop_sums(coal_o, t2_o, h_o, locus_mask)
    dh = (coal_n.sum(1) * torch.log(2.0 / h_n)
          - coal_o.sum(1) * torch.log(2.0 / h_o))
    us = rng.uniform(gen, (coal_o.shape[0],), dt, dev, shard)
    cols = torch.cat([
        coal_o.to(torch.float64), coal_n.to(torch.float64),
        t2c_o.double(), t2c_n.double(),
        torch.stack([dother, dh, torch.log(us)], 1).double(),
        mask[:, None].double()], 1)
    sums = torch.cat([K0, C0]).double()
    if shard is not None:
        # the chain runs over every locus, in order, on each rank
        cols, sums = gather_loci(shard, cols), psum(shard, sums)
    L = cols.shape[0]
    host = torch.cat([cols.reshape(-1), sums]).cpu().numpy()
    cols = host[:L * (4 * H + 4)].reshape(L, 4 * H + 4)
    sums = host[L * (4 * H + 4):]
    co, cn, to, tn = (cols[:, k * H:(k + 1) * H] for k in range(4))
    dother_h, dh_h, logu, m = cols[:, 4 * H:].T
    accept = accept_chain(cfg.thetaprior.alpha, cfg.thetaprior.beta,
                          sums[:H], sums[H:], co, cn, to, tn, dother_h,
                          dh_h, logu, m > 0.5)
    if shard is not None:
        accept = shard.rows(accept)
    return torch.as_tensor(accept).to(dev)
