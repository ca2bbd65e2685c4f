"""MCMC state and likelihood glue (PyTorch).

Port of ``bpp_tpu/mcmc/state.py``: plain species trees, MSC-I networks
and MSC-M migration (fixed routes or geneflow rjMCMC), morphological
traits, the strict and the relaxed clocks,
estimated, linked or integrated-out thetas, tip dating, species-tree
search and species delimitation, one substitution model for all loci
(DNA or amino acids) or one per locus (``model = custom``).
The sampler state is one NamedTuple of tensors; moves return a new state
and reject by ``torch.where(accept, new, old)``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import BppConfig, Clock, SubstModel
from ..core import felsenstein as fe
from ..core.fels import site_logl_fels, site_logl_fels_ref
from ..core.pack import chain_pass, site_logl_packed
from ..core.pmatrix import aa_eigen, gtr_eigen, pmatrix_model
from ..core.units import Units
from ..trees import coalescent as coal
from ..trees import migration as mg
from ..trees.gtree import (
    BIG_AGE, GTrees, SpeciesArrays, assign_populations, inner_order,
    lift_population, route_consistent,
)
from . import rng

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
MV_PHI = 9           # MSC-I phi Gibbs
MV_RJ = 10           # rjMCMC split/join (A10/A11)
MV_SSPR = 11         # species-tree SPR (A01/A11)
MV_SNL = 12          # species-tree SNL (A01/A11)
MV_HPATH = 13        # MSC-I population and hybridization-flag re-choice
MV_MUI = 14
MV_NUI = 15
MV_MUBAR = 16
MV_NUBAR = 17
MV_BRATE = 18
MV_MIGRATES = 19     # MSC-M route rates (Gibbs, variable-rate slides)
MV_MIG_AGES = 20     # MSC-M migration-event ages
MV_TRAIT = 21        # trait branch rates (prop_branch_rates_trait)
MV_GFRJ = 22         # geneflow rjMCMC route add/remove and flip
N_MOVES = 23


class SubstState(NamedTuple):
    """Per-locus substitution-model parameters."""

    freqs: torch.Tensor     # [L, A] (A = 4, or 20 with amino acids)
    kappa1: torch.Tensor    # [L]
    kappa2: torch.Tensor    # [L]
    qrates: torch.Tensor    # [L, 6]
    alpha: torch.Tensor     # [L] gamma shape (unused when C == 1)
    rates: torch.Tensor     # [L, C] category rates
    mu: torch.Tensor        # [L] locus rate
    heredity: torch.Tensor  # [L]
    eigw: torch.Tensor      # [L, A] cached eigensystem (GTR, custom)
    eigT: torch.Tensor      # [L, A, A]
    eigTi: torch.Tensor     # [L, A, A]


@dataclasses.dataclass(frozen=True)
class CustomModels:
    """Per-locus substitution models (``model = custom`` partition file),
    constant over a run (method.c:3344-3352).  Every DNA model is put in
    the GTR parameterization, so one eigendecomposition covers the batch.

    kind codes: 0 JC69/F81, 1 the two-parameter kappa family (K80, HKY,
    T92, F84), 2 TN93, 3 GTR, 4 an empirical amino-acid model."""

    kind: torch.Tensor        # [L] int64
    freqs_free: torch.Tensor  # [L] bool: the locus samples frequencies
    q_free: torch.Tensor      # [L, 6] bool: the qrates slot is a target
    q_ref: torch.Tensor       # [L] int64 reference slot per locus
    # [L] the reference slot's exponent in subst_moves.GTR_DIR_ALPHA
    q_ref_alpha: torch.Tensor
    is_dna: torch.Tensor      # [L] bool
    # fixed eigensystems of the amino-acid loci (zeros on DNA loci); None
    # when no locus is amino acids
    aa_w: torch.Tensor | None
    aa_T: torch.Tensor | None
    aa_Ti: torch.Tensor | None
    n_states: int             # 4, or 20 with any amino-acid locus
    any_freqs: bool           # the freqs move runs
    q_slots: tuple            # qrates slots free at one locus or more


def build_custom_models(locus_models, n_loci: int, dtype,
                        device="cpu") -> CustomModels:
    """The per-locus model constants of a partition (copied from
    ``bpp_tpu/mcmc/state.py``).  ``locus_models`` covers the real loci;
    padding loci are JC69 with no free parameter."""
    kinds = {SubstModel.JC69: 0, SubstModel.F81: 0, SubstModel.K80: 1,
             SubstModel.HKY: 1, SubstModel.T92: 1, SubstModel.F84: 1,
             SubstModel.TN93: 2, SubstModel.GTR: 3}
    with_freqs = {SubstModel.F81, SubstModel.HKY, SubstModel.T92,
                  SubstModel.TN93, SubstModel.F84, SubstModel.GTR}
    kind = np.zeros(n_loci, np.int64)
    freqs_free = np.zeros(n_loci, bool)
    q_free = np.zeros((n_loci, 6), bool)
    q_ref = np.ones(n_loci, np.int64)
    is_dna = np.ones(n_loci, bool)
    has_aa = any(m.is_aa for m in locus_models)
    S = 20 if has_aa else 4
    aa_w = np.zeros((n_loci, S)) if has_aa else None
    aa_T = np.zeros((n_loci, S, S)) if has_aa else None
    aa_Ti = np.zeros((n_loci, S, S)) if has_aa else None
    for i, m in enumerate(locus_models):
        if m.is_aa:
            kind[i] = 4
            is_dna[i] = False
            aa_w[i], aa_T[i], aa_Ti[i], _ = aa_eigen(m.name)
            continue
        k = kinds[m]
        kind[i] = k
        freqs_free[i] = m in with_freqs
        if k == 1:                       # (alpha, beta): slot 0 vs ref 1
            q_free[i, 0] = True
            q_ref[i] = 1
        elif k == 2:                     # TN93 (a1, a2, b): ref slot 2
            q_free[i, [0, 1]] = True
            q_ref[i] = 2
        elif k == 3:                     # GTR: all but the AG reference
            q_free[i, :] = True
            q_free[i, 1] = False
            q_ref[i] = 1

    def t(a, dt=None):
        return None if a is None else torch.as_tensor(a, dtype=dt,
                                                      device=device)

    return CustomModels(
        kind=t(kind), freqs_free=t(freqs_free), q_free=t(q_free),
        q_ref=t(q_ref), q_ref_alpha=t(np.asarray(
            (2.0, 4.0, 2.0, 2.0, 4.0, 2.0))[q_ref], dtype),
        is_dna=t(is_dna), aa_w=t(aa_w, dtype),
        aa_T=t(aa_T, dtype), aa_Ti=t(aa_Ti, dtype), n_states=S,
        any_freqs=bool(freqs_free.any()),
        q_slots=tuple(j for j in range(6) if q_free[:, j].any()))


def custom_kappas(qrates, kind):
    """Per-locus (kappa1, kappa2) of a partition: q0/q1 for the kappa
    family, (q0/q2, q1/q2) for TN93, 1 elsewhere."""
    q = qrates
    one = torch.ones_like(q[:, 0])
    k1 = torch.where(kind == 1, q[:, 0] / q[:, 1],
                     torch.where(kind == 2, q[:, 0] / q[:, 2], one))
    k2 = torch.where(kind == 1, q[:, 0] / q[:, 1],
                     torch.where(kind == 2, q[:, 1] / q[:, 2], one))
    return k1, k2


def expand_qrates(subst: SubstState, custom: CustomModels):
    """Per-locus GTR-layout (AC, AG, AT, CG, CT, GT) exchangeabilities:
    kappa on the transition slots for the kappa family and TN93, the
    qrates themselves for GTR, all ones for JC69 and amino acids."""
    q = subst.qrates
    k1, k2 = custom_kappas(q, custom.kind)
    one = torch.ones_like(k1)
    tn = torch.stack([one, k1, one, one, k2, one], dim=1)
    return torch.where((custom.kind == 3)[:, None], q, tn)


def refresh_eigen(subst: SubstState, model: SubstModel,
                  custom: CustomModels | None = None,
                  jacobi: bool = False) -> SubstState:
    """Recompute the cached eigendecomposition (GTR and custom loci);
    ``jacobi``: by ``pmatrix.eigh_jacobi`` (``Ctx.captured``)."""
    if model == SubstModel.CUSTOM:
        exp = expand_qrates(subst, custom)
        if custom.n_states == 4:
            w, T, Tinv = gtr_eigen(subst.freqs, exp, jacobi)
            return subst._replace(eigw=w, eigT=T, eigTi=Tinv)
        # mixed DNA/AA: each DNA locus's 4-state eigensystem embedded in
        # the 20-state space (zero eigenvalues, the identity on the other
        # 16 states); amino-acid loci keep their fixed eigensystems
        d = custom.is_dna
        f4 = torch.where(d[:, None], subst.freqs[:, :4],
                         torch.full_like(subst.freqs[:, :4], 0.25))
        w4, T4, Ti4 = gtr_eigen(f4, exp, jacobi)
        S = custom.n_states
        # padded out of place (inside the batched step the 4 x 4 blocks
        # carry the chain axis): the identity's other rows added to 0
        rest = torch.eye(S, dtype=w4.dtype, device=w4.device)
        rest[:4, :4] = 0.0
        w = F.pad(w4, (0, S - 4))
        T = F.pad(T4, (0, S - 4, 0, S - 4)) + rest
        Tinv = F.pad(Ti4, (0, S - 4, 0, S - 4)) + rest
        w = torch.where(d[:, None], w, custom.aa_w)
        T = torch.where(d[:, None, None], T, custom.aa_T)
        Tinv = torch.where(d[:, None, None], Tinv, custom.aa_Ti)
        return subst._replace(eigw=w, eigT=T, eigTi=Tinv)
    if model != SubstModel.GTR:
        return subst
    w, T, Tinv = gtr_eigen(subst.freqs, subst.qrates, jacobi)
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
    # MSC-M: migration events and route rates (None without migration)
    mig: object | None = None           # trees.migration.MigState
    # morphological traits (traitfile; morph.c trait_t per snode): the
    # per-partition branch rates and cached trait log-likelihoods
    trait: object | None = None         # trees.traits.TraitState


def tree_where(cond, new, old):
    """``torch.where(cond, new, old)`` over every tensor of two states of
    the same structure (NamedTuples of tensors); ``None`` stays ``None``
    and a field the candidate shares with the old state is kept as is."""
    if new is old or new is None:
        return old
    if isinstance(new, tuple):
        return type(new)(*(tree_where(cond, n, o) for n, o in zip(new, old)))
    return torch.where(cond, new, old)


# the likelihood routes of a batch: 4 states without a diploid resolution
# map (kernel K1), 4 states with one (kernel K2 and reduce_root), 20
# states (K2's plain version and reduce_root; no TPU kernel exists for it)
ROUTE_K1 = "K1"
ROUTE_K2 = "K2"
ROUTE_PLAIN = "plain"


@dataclasses.dataclass(frozen=True)
class Ctx:
    """Static per-run tensors."""

    tip_partials: torch.Tensor   # [L, T, S, A]
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
    # thetas integrated out: logpr_fn's per-locus value holds only the
    # theta-free terms (a network's phi terms and route validity; 0 on a
    # plain tree) and the rest of the density lives in
    # notheta.total_integrated over the (coal, t2h) caches
    integrated: bool = False
    # A01/A11 topology constraints: a group id per species node (SPR only
    # regrafts within a group; io.constraints.build_constraint_ids)
    sp_constraint: torch.Tensor | None = None    # [H] int64
    # A11 under speciesmodelprior 2/3: log prior mass per species count
    # minus one (driver.prior_a11_masses)
    prior_a11_log: torch.Tensor | None = None    # [NS]
    # linked thetas (thetamodel; init_theta_linkage stree.c:2427): the
    # theta owner of every node; the thetas of a group are one parameter
    theta_link: torch.Tensor | None = None       # [H] int64
    # per-locus substitution models (model = custom partition file)
    custom: CustomModels | None = None
    # the likelihood pass, chosen once per run (driver.likelihood_route)
    route: str = ROUTE_K1
    # morphological traits: trait_logl(tau, brate) -> [n_part] on the
    # fixed species topology (trees.traits.make_trait_logl); under
    # species-tree search trait_fn is None and trait_fn_topo(left, right,
    # parent, tau, brate) scores the topology it is given
    trait_fn: object | None = None
    trait_fn_topo: object | None = None
    # locus sharding (parallel.mesh.Shard): the per-locus tensors above
    # hold this rank's block of loci; None when one process holds them all
    shard: object | None = None
    # the step is captured into a CUDA graph (driver.step_route's graph
    # route on the card): GTR's eigensystem takes pmatrix.eigh_jacobi,
    # which reads nothing back to the host; an eager step takes
    # torch.linalg.eigh, in far fewer kernels (PERF.md §6)
    captured: bool = False
    # the batched step of chains = K (driver.Engine._step_batched, vmap of
    # the one-chain step over the chains): each pruning pass is one call of
    # its kernel's wrapper over the K chains (pack.chain_pass); 0 otherwise
    chains: int = 0

    @property
    def has_traits(self) -> bool:
        return self.trait_fn is not None or self.trait_fn_topo is not None



def compute_pmats(gt: GTrees, subst: SubstState, model: SubstModel,
                  blen=None):
    """Transition matrices for every (node, category): [L, N, C, A, A]."""
    if blen is None:
        blen = fe.branch_lengths(gt, subst.mu)
    t_eff = blen[:, :, None] * subst.rates[:, None, :]
    return pmatrix_model(model, t_eff, subst.freqs, subst.kappa1,
                         subst.kappa2, subst.eigw, subst.eigT, subst.eigTi)


def make_logl_fn(ctx: Ctx, cfg: BppConfig):
    """Returns logl(gt, subst, sp=None, clock=None, seg=None, mig=None)
    -> [L].

    ``ctx.route`` picks the pass.  A 4-state batch whose resolution map
    is the identity goes through ``core.pack.site_logl_packed`` (kernel
    K1).  A 4-state batch with a diploid resolution map goes wholly
    through ``core.fels.site_logl_fels`` (kernel K2), then
    ``felsenstein.reduce_root`` averages the phase resolutions.  Either
    wrapper launches its kernel on CUDA tensors and computes its plain
    version on CPU tensors; per-locus DNA models reach both kernels
    through their GTR family.  A 20-state batch (amino acids, or a
    partition with an amino-acid locus) takes K2's plain version,
    ``core.fels.site_logl_fels_ref``, on any device, then ``reduce_root``:
    ``bpp_tpu`` has no Pallas kernel for it either.

    Under a relaxed clock (``cfg.clock != GLOBAL``) ``sp`` and ``clock``
    are required: the branch lengths ``relaxed_branch_lengths`` (times
    mu_i under the SIMPLE clock) go to the same kernels as ``blen``.
    Under migration (``cfg.migration``) an edge changes population at its
    events, so ``mig`` is required there too and the segments are
    ``migration.relaxed_segments_mig``'s sub-edge sweep (``bpp_tpu``'s
    ``relaxed_branch_lengths_mig``).  ``seg`` is the segments of (gt, sp,
    mig), for callers that hold them across several rate proposals."""
    usedata = cfg.usedata
    model = cfg.model
    bfbeta = cfg.bfbeta
    relaxed = cfg.clock != Clock.GLOBAL
    simple = cfg.clock == Clock.SIMPLE
    migration = cfg.migration

    def logl_fn(gt: GTrees, subst: SubstState, sp=None, clock=None,
                seg=None, mig=None):
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
                seg = relaxed_segments(ctx, gt, sp, mig, migration)
            blen = fe.segment_lengths(gt, seg, brate, sp.rate_owner)
        rk = torch.cat([subst.rates, subst.kappa1[:, None],
                        subst.kappa2[:, None]], dim=1)
        tree = (inner_order(gt), gt.left, gt.right, gt.parent, ctx.n_seq,
                gt.age, subst.mu, rk, subst.freqs, subst.eigw, subst.eigT,
                subst.eigTi, ctx.tip_partials)
        n_cats = subst.rates.shape[1]
        if ctx.route == ROUTE_K1:
            ll = kernel_pass(ctx, site_logl_packed, tree, blen,
                             weights=ctx.weights, model=model, n_cats=n_cats,
                             units=ctx.units)
        else:
            if ctx.route == ROUTE_K2:
                site = kernel_pass(ctx, site_logl_fels, tree, blen,
                                   model=model, n_cats=n_cats,
                                   n_pat=ctx.n_pat, units=ctx.units)
            else:
                site = kernel_pass(ctx, site_logl_fels_ref, tree, blen,
                                   model=model, n_cats=n_cats,
                                   n_pat=ctx.n_pat)
            ll = fe.reduce_root(site.to(ctx.weights.dtype), ctx.weights,
                                ctx.res_map, ctx.res_count)
        if bfbeta != 1.0:
            ll = ll * bfbeta
        return torch.where(ctx.locus_mask, ll, torch.zeros_like(ll))

    return logl_fn


# the pruning wrappers' tree arguments, in the order make_logl_fn's
# logl_fn passes them
TREE_ARGS = ("order", "left", "right", "parent", "n_seq", "age", "mu",
             "rates_kappa", "freqs", "eigw", "eigT", "eigTi", "tips")


def kernel_pass(ctx: Ctx, fn, tree, blen, **kw):
    """``fn`` (``site_logl_packed``, ``site_logl_fels`` or the 20-state
    plain pass ``site_logl_fels_ref``) on ``tree``: inside the batched
    step of K chains one call over all of them (``pack.chain_pass``), so
    that K1 or K2 launches once a pass and the plain pass takes the K x L
    loci as one batch."""
    if not ctx.chains:
        return fn(*tree, blen=blen, **kw)
    tensors = dict(zip(TREE_ARGS, tree), blen=blen)
    static = {}
    for k, v in kw.items():
        (tensors if v is None or torch.is_tensor(v) else static)[k] = v
    return chain_pass(fn, tensors, **static)


def relaxed_segments(ctx: Ctx, gt: GTrees, sp, mig=None, migration=False):
    """The per-population segments of every edge a relaxed clock's
    branch lengths weigh: ``felsenstein.relaxed_segments``, or under
    migration the sub-edge sweep ``migration.relaxed_segments_mig``."""
    if not migration:
        return fe.relaxed_segments(gt, sp,
                                   assign_populations(gt, sp, ctx.tip_pop))
    if mig is None:
        raise ValueError("relaxed clock under migration: logl_fn requires "
                         "mig")
    pops = mg.assign_populations_mig(gt, sp, ctx.tip_pop, mig, ctx.n_seq)
    return mg.relaxed_segments_mig(gt, sp, mig, pops, ctx.n_seq)


def make_logpr_fn(ctx: Ctx):
    """Returns logpr(gt, sp, heredity, msp=None) -> ([L], coal [L,H],
    T2h [L,H]).

    ``msp`` is the optional [L, N] species-MRCA of every gene node, a
    topology-only quantity that moves fixing the topology compute once
    (plain trees only; a network routes by ``gt.hpath``).  Dated tips
    take ``per_pop_stats_dated``.  On an MSC-I network the density adds
    the phi terms, n_in * log(phi) per hinner and mirror
    (gtree.c:3925-3931), and is -inf at a locus whose coalescences'
    child routes disagree (``route_consistent``).  The phi floor is
    ``rng.tiny_floor``: bpp_tpu's 1e-300 in float64, the smallest normal
    number in float32, where 1e-300 is 0 and a phi of 0 would give
    0 * -inf.  With integrated thetas the per-locus value holds only the
    theta-free terms (0 on a plain tree) and the density is
    ``notheta.total_integrated`` of the returned stats."""
    stats = (coal.per_pop_stats if ctx.tip_dates is None
             else coal.per_pop_stats_dated)

    def logpr_fn(gt: GTrees, sp: SpeciesArrays, heredity, msp=None):
        if msp is not None and not sp.is_network:
            pops = lift_population(sp, msp,
                                   gt.age.clamp(0.0, BIG_AGE * 0.5))
        else:
            pops = assign_populations(gt, sp, ctx.tip_pop)
        c, t2, n_in = stats(gt, sp, pops, ctx.n_seq)
        if ctx.integrated:
            lp = torch.zeros_like(t2[:, 0])
        else:
            lp = coal.msc_contrib(c, t2, sp.theta, heredity).sum(dim=1)
        if sp.is_network:
            floor = rng.tiny_floor(sp.phi.dtype)
            lphi = torch.where(sp.hindex >= 0,
                               torch.log(torch.clamp(sp.phi, min=floor)),
                               torch.zeros_like(sp.phi))
            n_eff = coal.phi_entry_counts(sp, n_in)
            lp = lp + (n_eff * lphi).sum(dim=1)
            ok = route_consistent(gt, sp, pops, ctx.n_seq)
            lp = torch.where(ok, lp, torch.full_like(lp, -float("inf")))
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
