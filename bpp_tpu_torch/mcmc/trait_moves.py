"""Trait branch-rate moves (prop_branch_rates_trait, morph.c:1177),
PyTorch.

Port of ``bpp_tpu/mcmc/trait_moves.py``.  Under the strict clock each
trait partition carries ONE rate shared by every species branch
(prop_branch_rates_strict morph.c:1100); under a relaxed clock every
(partition, branch) has its own rate with an iid Gamma(a, b) prior
(prop_branch_rates_relax morph.c:1032).  Both are log-scale Bactrian
slides reflected into [-99, 99], one MH decision a rate, in
``bpp_tpu``'s order; no move here runs a likelihood pass.
"""

from __future__ import annotations

import torch

from ..config import BppConfig, Clock
from . import rng
from .clock_moves import _logslide
from .moves import _trait_eval
from .state import FT_BRATE_M, Ctx, McmcState


def trait_brate_move(ctx: Ctx, cfg: BppConfig, state: McmcState, gen):
    sp = state.sp
    brate = state.trait.brate
    tlogl = state.trait.logl
    n_part, H = brate.shape
    a = cfg.trait_brate_alpha
    b = cfg.trait_brate_beta
    eps = state.finetune[FT_BRATE_M]
    tau = sp.tau
    zero = torch.zeros((), dtype=torch.int64, device=tau.device)
    nprop = nacc = zero

    def propose(n, h, brate, tlogl):
        """One slide of rate (n, h) (h = None: the partition's shared
        rate); returns (brate, tlogl, accepted)."""
        old = brate[n, 0] if h is None else brate[n, h]
        new, dlog = _logslide(gen, old, eps)
        brate_new = brate.clone()
        if h is None:
            brate_new[n] = new
        else:
            brate_new[n, h] = new
        tl_new = _trait_eval(ctx, sp, tau, brate_new)
        lnacc = (dlog + (a - 1.0) * torch.log(new / old)
                 - b * (new - old) + tl_new[n] - tlogl[n])
        accept = rng.mh_accept(gen, lnacc)
        return (torch.where(accept, brate_new, brate),
                torch.where(accept, tl_new, tlogl), accept)

    if cfg.clock == Clock.GLOBAL:
        # one shared rate a partition (morph.c:1100)
        for n in range(n_part):
            brate, tlogl, accept = propose(n, None, brate, tlogl)
            nprop = nprop + 1
            nacc = nacc + accept.to(torch.int64)
    else:
        # one rate a (partition, branch); the root's branch has none
        for n in range(n_part):
            for h in range(H):
                active = sp.parent[h] >= 0
                b_new, t_new, accept = propose(n, h, brate, tlogl)
                accept = accept & active
                brate = torch.where(active, b_new, brate)
                tlogl = torch.where(active, t_new, tlogl)
                nprop = nprop + active.to(torch.int64)
                nacc = nacc + accept.to(torch.int64)
    return (state._replace(trait=state.trait._replace(brate=brate,
                                                      logl=tlogl)),
            (nprop, nacc))
