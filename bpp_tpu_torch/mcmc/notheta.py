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
the running K/C sums (``bpp_tpu``'s ``lax.scan``).  :func:`chain_accept`
runs that chain where its inputs lie: on the card as kernel K3
(``csrc/chain_kernel.cu``, in float64, resolving several loci a round by
lookahead over their accept/reject patterns; no host read), on the CPU
as :func:`accept_chain`, its plain version in float64 Python floats.
Under locus sharding every rank runs the whole chain on the gathered
inputs of all loci and keeps its rows of the decisions, and the K/C sums
are all-reduced.  Inside the batched step of ``chains = K``
(``torch.func.vmap`` over the chains) the K chains' inputs go to one call
(``pack.chain_pass``): one K3 launch, a block a chain, or the plain
version once a chain.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import chains
from ..core.pack import chain_pass
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
    """Aggregated (K [H], C [H]) over the real loci, in
    ``coalescent.locus_sum``'s fixed order."""
    mask = locus_mask[:, None]
    zero = torch.zeros_like(t2h)
    K, C = coalmod.locus_sum(torch.stack([
        torch.where(mask, coal.to(t2h.dtype), zero),
        torch.where(mask, t2h / heredity[:, None], zero)], 1))
    return K, C


def accept_chain(a: float, b: float, K0, C0, co, cn, to, tn, dother, dh,
                 logu, mask, margin=None) -> np.ndarray:
    """The serial accept chain of :func:`scan_accept` in float64 numpy:
    the plain version of kernel K3.

    ``K0``/``C0`` [H] the starting sums; per locus ``co``/``cn`` the old
    and candidate counts [L, H], ``to``/``tn`` the old and candidate
    heredity-scaled waiting sums, ``dother`` the locus-factorizing part of
    ln acceptance, ``dh`` the heredity/log 2 term delta, ``logu`` the log
    of the uniform draw, ``mask`` whether the locus proposes.  A locus
    whose rows are unchanged contributes 0 to the coupled term, so only
    the changed populations are evaluated.  ``margin`` (an array [L]),
    when given, receives |log u - (dother + dh + dlg)| at each proposing
    locus (inf elsewhere): how far each decision is from its tie."""
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
        if margin is not None:
            margin[i] = abs(lhs[i] - (rhs[i] + dlg))
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
    device from ``gen``; the chain runs in :func:`chain_accept`."""
    H = coal_o.shape[1]
    dt = t2_o.dtype
    t2c_o = t2_o / h_o[:, None]
    t2c_n = t2_n / h_n[:, None]
    K0, C0 = pop_sums(coal_o, t2_o, h_o, locus_mask)
    dh = (coal_n.sum(1) * torch.log(2.0 / h_n)
          - coal_o.sum(1) * torch.log(2.0 / h_o))
    us = rng.uniform(gen, (coal_o.shape[0],), dt, t2_o.device, shard)
    cols = torch.cat([
        coal_o.to(torch.float64), coal_n.to(torch.float64),
        t2c_o.double(), t2c_n.double(),
        torch.stack([dother, dh, torch.log(us)], 1).double(),
        mask[:, None].double()], 1)
    sums = torch.cat([K0, C0]).double()
    if shard is not None:
        # the chain runs over every locus, in order, on each rank
        cols, sums = gather_loci(shard, cols), psum(shard, sums)
    accept = chain_pass(chain_accept, {"cols": cols, "sums": sums},
                        per_chain=("cols", "sums"), a=cfg.thetaprior.alpha,
                        b=cfg.thetaprior.beta, H=H)
    if shard is not None:
        accept = shard.rows(accept)
    return accept


def chain_accept(a: float, b: float, cols, sums, H: int, margin=None):
    """The accept chain over ``cols`` ``[L, 4H + 4]`` float64 (per locus
    co, cn, to, tn [H] each, then dother, dh, log u, mask) from the sums
    ``sums`` ``[2H]`` (K0, C0): accept ``[L]`` bool on their device; over
    K chains (``cols [K, L, 4H + 4]``, ``sums [K, 2H]``) accept ``[K, L]``,
    each chain's walk its own.  CUDA tensors: kernel K3 (one launch, a
    block a chain), with no host read; CPU tensors: the plain version
    :func:`accept_chain` a chain (``margin`` as there, ``[K, L]`` over K
    chains; the CPU only)."""
    if cols.device.type == "cuda":
        return chains.launch_notheta(cols.contiguous(), sums.contiguous(),
                                     H, a, b)
    if cols.dim() == 3:
        return torch.stack([_host_chain(
            a, b, c, s, H, None if margin is None else margin[k])
            for k, (c, s) in enumerate(zip(cols, sums))])
    return _host_chain(a, b, cols, sums, H, margin)


def _host_chain(a, b, cols, sums, H, margin):
    """:func:`accept_chain` on one chain's CPU tensors."""
    host = cols.numpy()
    sums = sums.numpy()
    co, cn, to, tn = (host[:, k * H:(k + 1) * H] for k in range(4))
    dother, dh, logu, m = host[:, 4 * H:].T
    return torch.from_numpy(accept_chain(a, b, sums[:H], sums[H:], co, cn,
                                         to, tn, dother, dh, logu, m > 0.5,
                                         margin))
