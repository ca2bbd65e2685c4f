"""MCMC state and likelihood glue (PyTorch).

Port of ``bpp_tpu/mcmc/state.py`` for plain species trees: the strict
and the relaxed clocks, estimated or integrated-out thetas, tip dating,
species-tree search and species delimitation.
The sampler state is one NamedTuple of tensors; moves return a new state
and reject by ``torch.where(accept, new, old)``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..config import BppConfig, Clock, SubstModel
from ..core import felsenstein as fe
from ..core.fels import site_logl_fels
from ..core.pack import site_logl_packed
from ..core.pmatrix import gtr_eigen, pmatrix_model
from ..core.units import Units
from ..trees import coalescent as coal
from ..trees.gtree import (
    BIG_AGE, GTrees, SpeciesArrays, assign_populations, inner_order,
    lift_population,
)

# finetune slot indices (the reference's finetune vector order)
FT_GTAGE = 0
FT_GTSPR = 1
FT_THETA = 2
FT_TAU = 3
FT_MIX = 4
FT_LRHT = 5
FT_PHI = 6
FT_FREQS = 7
FT_QRATES = 8
FT_ALPHA = 9
FT_MUI = 10
FT_NUI = 11
FT_MUBAR = 12
FT_NUBAR = 13
FT_BRATE = 14
FT_MIGRATES = 15
FT_MIG_AGES = 16
FT_BRATE_M = 17
N_FINETUNE = 18

# move-statistics slots (proposed, accepted) per move family
MV_GTAGE = 0
MV_GTSPR = 1
MV_THETA = 2
MV_TAU = 3
MV_MIX = 4
MV_LRHT = 5
MV_FREQS = 6
MV_QRATES = 7
MV_ALPHA = 8
MV_RJ = 10           # rjMCMC split/join (A10/A11)
MV_SSPR = 11         # species-tree SPR (A01/A11)
MV_SNL = 12          # species-tree SNL (A01/A11)
MV_MUI = 14
MV_NUI = 15
MV_MUBAR = 16
MV_NUBAR = 17
MV_BRATE = 18
N_MOVES = 23


class SubstState(NamedTuple):
    """Per-locus substitution-model parameters."""

    freqs: torch.Tensor     # [L, 4]
    kappa1: torch.Tensor    # [L]
    kappa2: torch.Tensor    # [L]
    qrates: torch.Tensor    # [L, 6]
    alpha: torch.Tensor     # [L] gamma shape (unused when C == 1)
    rates: torch.Tensor     # [L, C] category rates
    mu: torch.Tensor        # [L] locus rate
    heredity: torch.Tensor  # [L]
    eigw: torch.Tensor      # [L, 4] cached GTR eigensystem
    eigT: torch.Tensor      # [L, 4, 4]
    eigTi: torch.Tensor     # [L, 4, 4]


def refresh_eigen(subst: SubstState, model: SubstModel) -> SubstState:
    """Recompute the cached eigendecomposition (GTR only)."""
    if model != SubstModel.GTR:
        return subst
    w, T, Tinv = gtr_eigen(subst.freqs, subst.qrates)
    return subst._replace(eigw=w, eigT=T, eigTi=Tinv)


class ClockState(NamedTuple):
    """Rate-hierarchy state (clock = 2 IID / 3 CORR / 4 SIMPLE, or the
    strict clock with estimated locus rates, where only ``mubar`` is
    read).  ``brate[l, h]`` is the rate of species branch h at locus l;
    under the SIMPLE clock the leading axis is 1 (one shared rate per
    branch, scaled by mu_i)."""

    brate: torch.Tensor     # [L, H] (or [1, H] for SIMPLE)
    nu: torch.Tensor        # [L] per-locus rate variances
    mubar: torch.Tensor     # [] mean locus rate
    nubar: torch.Tensor     # [] mean rate variance
    lnrates: torch.Tensor   # [L] (or [1]) cached branch-rate log prior


class McmcState(NamedTuple):
    gt: GTrees
    sp: SpeciesArrays
    subst: SubstState
    logl: torch.Tensor       # [L] cached log-likelihood
    logpr: torch.Tensor      # [L] cached MSC log-density
    finetune: torch.Tensor   # [N_FINETUNE]
    clock: ClockState | None = None
    # theta-integrated-out caches (None with estimated thetas): per-locus
    # coalescent counts and waiting-time sums per population, the tensors
    # behind notheta.total_integrated
    coal: torch.Tensor | None = None    # [L, H] int64
    t2h: torch.Tensor | None = None     # [L, H]
    # tip dating (locusrate = 3): the mutation rate that turns calendar
    # dates into substitution units; tip ages are tip_dates * mubar
    mubar: torch.Tensor | None = None   # []


def tree_where(cond, new, old):
    """``torch.where(cond, new, old)`` over every tensor of two states of
    the same structure (NamedTuples of tensors); ``None`` stays ``None``
    and a field the candidate shares with the old state is kept as is."""
    if new is old or new is None:
        return old
    if isinstance(new, tuple):
        return type(new)(*(tree_where(cond, n, o) for n, o in zip(new, old)))
    return torch.where(cond, new, old)


@dataclasses.dataclass(frozen=True)
class Ctx:
    """Static per-run tensors."""

    tip_partials: torch.Tensor   # [L, T, S, 4]
    weights: torch.Tensor        # [L, W]
    n_seq: torch.Tensor          # [L] int64
    tip_pop: torch.Tensor        # [L, T] int64
    locus_mask: torch.Tensor     # [L] bool
    # diploid resolution map: weight pattern -> its likelihood patterns;
    # None for a batch whose map is the identity
    res_map: torch.Tensor | None = None     # [L, W, R] int64
    res_count: torch.Tensor | None = None   # [L, W] int64
    n_pat: torch.Tensor | None = None       # [L] int64 likelihood patterns
    # the pruning kernels' static unit table (CUDA runs only)
    units: Units | None = None
    # tip dating (datefile): calendar sample dates per sequence (tip age =
    # date * mubar) and the oldest date below each species node
    tip_dates: torch.Tensor | None = None   # [L, T]
    date_lmax: torch.Tensor | None = None   # [H]
    # thetas integrated out: logpr_fn's per-locus value is 0 (plain
    # trees have no theta-free terms) and the density lives in
    # notheta.total_integrated over the (coal, t2h) caches
    integrated: bool = False
    # A01/A11 topology constraints: a group id per species node (SPR only
    # regrafts within a group; io.constraints.build_constraint_ids)
    sp_constraint: torch.Tensor | None = None    # [H] int64
    # A11 under speciesmodelprior 2/3: log prior mass per species count
    # minus one (driver.prior_a11_masses)
    prior_a11_log: torch.Tensor | None = None    # [NS]


def compute_pmats(gt: GTrees, subst: SubstState, model: SubstModel,
                  blen=None):
    """Transition matrices for every (node, category): [L, N, C, 4, 4]."""
    if blen is None:
        blen = fe.branch_lengths(gt, subst.mu)
    t_eff = blen[:, :, None] * subst.rates[:, None, :]
    return pmatrix_model(model, t_eff, subst.freqs, subst.kappa1,
                         subst.kappa2, subst.eigw, subst.eigT, subst.eigTi)


def make_logl_fn(ctx: Ctx, cfg: BppConfig):
    """Returns logl(gt, subst, sp=None, clock=None, seg=None) -> [L].

    A batch whose resolution map is the identity goes through
    ``core.pack.site_logl_packed`` (kernel K1).  A batch with a diploid
    resolution map goes wholly through ``core.fels.site_logl_fels``
    (kernel K2), then ``felsenstein.reduce_root`` averages the phase
    resolutions.  Either wrapper launches its kernel on CUDA tensors and
    computes its plain version on CPU tensors.

    Under a relaxed clock (``cfg.clock != GLOBAL``) ``sp`` and ``clock``
    are required: the branch lengths ``relaxed_branch_lengths`` (times
    mu_i under the SIMPLE clock) go to the same kernels as ``blen``.
    ``seg`` is ``felsenstein.relaxed_segments`` of (gt, sp), for callers
    that hold it across several rate proposals."""
    usedata = cfg.usedata
    model = cfg.model
    bfbeta = cfg.bfbeta
    relaxed = cfg.clock != Clock.GLOBAL
    simple = cfg.clock == Clock.SIMPLE

    def logl_fn(gt: GTrees, subst: SubstState, sp=None, clock=None,
                seg=None):
        if not usedata:
            return torch.zeros_like(ctx.weights[:, 0])
        blen = None
        if relaxed:
            if sp is None or clock is None:
                raise ValueError("relaxed clock: logl_fn requires (sp, clock)")
            brate = clock.brate
            if simple:
                brate = brate * subst.mu[:, None]       # locus.c:1142
            if seg is None:
                seg = fe.relaxed_segments(
                    gt, sp, assign_populations(gt, sp, ctx.tip_pop))
            blen = fe.segment_lengths(gt, seg, brate)
        rk = torch.cat([subst.rates, subst.kappa1[:, None],
                        subst.kappa2[:, None]], dim=1)
        tree = (inner_order(gt), gt.left, gt.right, gt.parent, ctx.n_seq,
                gt.age, subst.mu, rk, subst.freqs, subst.eigw, subst.eigT,
                subst.eigTi, ctx.tip_partials)
        n_cats = subst.rates.shape[1]
        if ctx.res_map is None:
            ll = site_logl_packed(*tree, ctx.weights, model=model,
                                  n_cats=n_cats, blen=blen, units=ctx.units)
        else:
            site = site_logl_fels(*tree, model=model, n_cats=n_cats,
                                  blen=blen, n_pat=ctx.n_pat,
                                  units=ctx.units)
            ll = fe.reduce_root(site.to(ctx.weights.dtype), ctx.weights,
                                ctx.res_map, ctx.res_count)
        if bfbeta != 1.0:
            ll = ll * bfbeta
        return torch.where(ctx.locus_mask, ll, torch.zeros_like(ll))

    return logl_fn


def make_logpr_fn(ctx: Ctx):
    """Returns logpr(gt, sp, heredity, msp=None) -> ([L], coal [L,H],
    T2h [L,H]) for plain species trees.

    ``msp`` is the optional [L, N] species-MRCA of every gene node, a
    topology-only quantity that moves fixing the topology compute once.
    Dated tips take ``per_pop_stats_dated``.  With integrated thetas the
    per-locus value is 0 (plain trees have no theta-free terms) and the
    density is ``notheta.total_integrated`` of the returned stats."""
    stats = (coal.per_pop_stats if ctx.tip_dates is None
             else coal.per_pop_stats_dated)

    def logpr_fn(gt: GTrees, sp: SpeciesArrays, heredity, msp=None):
        if msp is not None:
            pops = lift_population(sp, msp,
                                   gt.age.clamp(0.0, BIG_AGE * 0.5))
        else:
            pops = assign_populations(gt, sp, ctx.tip_pop)
        c, t2, _ = stats(gt, sp, pops, ctx.n_seq)
        if ctx.integrated:
            return torch.zeros_like(t2[:, 0]), c, t2
        lp = coal.msc_contrib(c, t2, sp.theta, heredity).sum(dim=1)
        lp = torch.where(ctx.locus_mask, lp, torch.zeros_like(lp))
        return lp, c, t2

    return logpr_fn


def finetune_array(cfg: BppConfig, dtype=torch.float64, device="cpu"):
    ft = cfg.finetune
    vals = np.zeros(N_FINETUNE)
    vals[FT_GTAGE] = ft.gtage
    vals[FT_GTSPR] = ft.gtspr
    vals[FT_THETA] = ft.theta
    vals[FT_TAU] = ft.tau
    vals[FT_MIX] = ft.mix
    vals[FT_LRHT] = ft.locusrate
    vals[FT_PHI] = ft.phi
    vals[FT_FREQS] = ft.freqs
    vals[FT_QRATES] = ft.qrates
    vals[FT_ALPHA] = ft.alpha
    vals[FT_MUI] = ft.mui
    vals[FT_NUI] = ft.nui
    vals[FT_MUBAR] = ft.mubar
    vals[FT_NUBAR] = ft.nubar
    vals[FT_BRATE] = ft.branchrate
    vals[FT_MIGRATES] = ft.migrates
    vals[FT_MIG_AGES] = ft.mig_ages
    vals[FT_BRATE_M] = ft.brate_m
    return torch.as_tensor(vals, dtype=dtype, device=device)
