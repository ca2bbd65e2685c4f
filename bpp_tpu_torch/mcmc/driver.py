"""MCMC driver: the cmd_run equivalent (src/method.c:4939), PyTorch.

Port of ``bpp_tpu/mcmc/driver.py``: A00 on a fixed species tree, an
MSC-I network (with bidirectional introgression) or under MSC-M
migration (fixed routes of constant or variable rates, or the geneflow
rjMCMC over every candidate route), species-tree search (A01: SPR and
SNL, topology constraints), species delimitation on a guide tree (A10,
with or without migration) and both together (A11), on haploid, phased
or unphased diploid DNA or on amino acids, with one substitution model
for all loci or one per locus (``model = custom``), morphological traits
beside the sequences (``traitfile``), Γ rates, locus rates and heredity
scalars, the strict or a relaxed clock (2, 3, 4), estimated, linked
(``thetamodel``) or integrated-out thetas, tip dating, checkpoint/resume,
the runtime check of the caches (``check = N``) and K replicate chains
(``chains = K``, :meth:`Engine.run_mcmc_multi`), in float32 or float64.
``bpp_tpu``'s combination guards are kept with its messages
(:func:`_reference_guards`).

``bpp_tpu`` jits its step and runs a chunk as one ``lax.scan``.  Here
:func:`step_route`, once per engine, sends a run one of two ways.  On the
``"graph"`` route a chunk of n iterations is n replays of one captured
CUDA graph of :meth:`Engine._step` (``mcmc.graph.StepGraph``).  Under
``chains = K`` :func:`chain_route` picks how the chains step: batched,
one step over the K stacked chains (:meth:`Engine._step_batched`,
``vmap`` of the step as ``bpp_tpu``'s ``_chunk_multi`` vmaps its chunk;
one graph), or per-chain (one graph a chain).
The ``"eager"`` route is a Python loop over :meth:`Engine._step`, taken
by locus sharding alone (its all-reduces go through the host over gloo);
``eng.route = "eager"`` forces it for a comparison.  The device control
flow of ``bpp_tpu``'s step has device counterparts, so every one-card
schedule is captured: the serial accept chains over loci (integrated
thetas, the Gamma-Dirichlet mu_i and nu_i) are kernels K3 and K4, the
SNL-or-SPR choice computes both moves and selects (``lax.cond`` under
``vmap``), SNL's species-level part runs in torch ops on the device, and
MSC-M's sim-SPR walk (a ``while_loop``) is kernel K5.  Either way a chunk
synchronises once, at its end (and once more at a check).

Locus sharding (``--multihost``, ``parallel.mesh``): an engine given a
``Shard`` keeps its block of loci in ``ctx`` and in every state, and its
moves all-reduce what they sum over loci; every rank draws what the
unsharded run draws, so the chain is the unsharded chain.  The sample
trace's sums over loci are all-reduced once a chunk.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..config import BppConfig, Clock, PriorDist, SubstModel
from ..core import felsenstein as fe
from ..core.gammarates import discrete_gamma_rates
from ..core.pmatrix import aa_eigen
from ..core.units import Units
from ..io.constraints import build_constraint_ids
from ..loader import RunData, init_tau_theta
from ..parallel.mesh import gather_loci, psum, shard_by_locus
from ..trees import migration as mg
from ..trees import traits as trmod
from ..trees.gtree import init_gtrees, species_arrays
from ..trees.stree import theta_link_map
from . import (
    clock_moves, mig_moves, moves, msci_moves, rj_moves, rng, stree_moves,
    subst_moves, trait_moves,
)
from .gibbs import gamma_conditional_approx
from .graph import StepGraph, chain_views, flatten, stack_states, unflatten
from .state import (
    FT_ALPHA, FT_BRATE, FT_BRATE_M, FT_FREQS, FT_GTAGE, FT_GTSPR, FT_LRHT,
    FT_MIG_AGES, FT_MIX, FT_MUBAR, FT_MUI, FT_NUBAR, FT_NUI, FT_QRATES,
    FT_TAU, FT_THETA, MV_ALPHA, MV_BRATE, MV_FREQS, MV_GFRJ, MV_GTAGE,
    MV_GTSPR, MV_HPATH, MV_LRHT, MV_MIG_AGES, MV_MIGRATES, MV_MIX, MV_MUBAR,
    MV_MUI, MV_NUBAR, MV_NUI, MV_PHI, MV_QRATES, MV_RJ, MV_SNL, MV_SSPR,
    MV_TAU, MV_THETA, MV_TRAIT, N_MOVES, ROUTE_K1, ROUTE_K2, ROUTE_PLAIN,
    Ctx, McmcState, SubstState, build_custom_models, finetune_array,
    make_logl_fn, make_logpr_fn, refresh_eigen, tree_where,
)

PJ_OPTIMUM = 0.30     # method.c:45 target pjump
NO_CUDA = ("no CUDA device: bpp_tpu_torch runs on the GPU by default; "
           "pass --device cpu (or device='cpu') to run on the CPU")

# the keys of a trace row that sum over loci (all-reduced under sharding)
_LOCUS_SUMS = ("lnl", "logpr", "nu_sum", "nu_n")

# the species moves (MV_RJ, MV_SSPR, MV_SNL) have no step length to tune,
# in bpp_tpu as in the reference
MOVE_TO_FT = {
    MV_MIG_AGES: FT_MIG_AGES,
    MV_GTAGE: FT_GTAGE,
    MV_GTSPR: FT_GTSPR,
    MV_THETA: FT_THETA,
    MV_TAU: FT_TAU,
    MV_MIX: FT_MIX,
    MV_LRHT: FT_LRHT,
    MV_FREQS: FT_FREQS,
    MV_QRATES: FT_QRATES,
    MV_ALPHA: FT_ALPHA,
    MV_MUI: FT_MUI,
    MV_NUI: FT_NUI,
    MV_MUBAR: FT_MUBAR,
    MV_NUBAR: FT_NUBAR,
    MV_BRATE: FT_BRATE,
    MV_TRAIT: FT_BRATE_M,
}


def _root_age_scale(cfg: BppConfig, run: RunData) -> float:
    """Beta-proposal scale for rjMCMC at the root (stree.c:7534-7642);
    copied from ``bpp_tpu/mcmc/driver.py`` (numpy).

    Prior-based: 0.9 gamma quantile, or 4*beta/(alpha-1) for invgamma.
    With data: mean cross-root pairwise divergence md minus theta/2, where
    theta solves the within-population diversity from the across-locus
    variance vd of the divergences.
    """
    tp = cfg.tauprior
    if tp.dist == PriorDist.INVGAMMA:
        prior_age = tp.beta / (tp.alpha - 1.0) * 4.0
    else:
        from scipy.stats import gamma as sgamma
        prior_age = float(sgamma.ppf(0.9, tp.alpha, scale=1.0 / tp.beta))
    if not cfg.usedata:
        return prior_age
    st, batch = run.stree, run.batch
    anc = st.pptable()
    lroot = st.left[st.root]
    md = vd = 0.0
    used = 0
    for li in range(batch.n_loci):
        if not batch.locus_mask[li]:
            continue
        ns = int(batch.n_seq[li])
        codes = batch.tip_codes[li, :ns]               # [T, S] masks
        w = batch.weights[li]
        # diploid data: the weight patterns index expanded code columns
        # through res_map; take each weight pattern's first resolution
        if codes.shape[1] != w.shape[0]:
            codes = codes[:, batch.res_map[li, :, 0]]
        pops = batch.tip_pop[li, :ns]
        on_left = anc[pops, lroot]                     # [T] bool
        # weighted mismatch of the cross-root upper-triangle pairs
        cross = np.triu(on_left[:, None] != on_left[None, :], 1)
        diff_count = int(cross.sum())
        if not diff_count:
            continue
        w64 = np.asarray(w, np.float64)
        if codes.shape[0] * codes.shape[0] * codes.shape[1] <= 5e7:
            D = (codes[:, None, :] != codes[None, :, :]) @ w64
        else:
            D = np.empty((ns, ns))
            step = max(1, int(5e7 // (ns * codes.shape[1])))
            for j0 in range(0, ns, step):
                D[j0:j0 + step] = (codes[j0:j0 + step, None, :]
                                   != codes[None, :, :]) @ w64
        diff_locus = float(D[cross].sum()) / float(batch.n_sites[li])
        used += 1
        diff_locus /= 2 * diff_count
        vd += (diff_locus - md) ** 2 * (used - 1) / used
        md = (md * (used - 1) + diff_locus) / used
    if not used:
        return prior_age
    n_real = int(batch.locus_mask.sum())
    vd /= max(n_real, 1)
    if used >= 2:
        theta = (2 * np.sqrt(vd) + np.sqrt(vd * 4 + 1) - 1) / 2
        if md - theta / 2 > 0:
            return float(md - theta / 2)
    return float(md)


def prior_a11_masses(n: int, delimit_prior: int) -> np.ndarray:
    """Normalized per-species-count prior masses for A11
    (partition_fast + print_pinfo, delimit.c:88-215); copied from
    ``bpp_tpu/mcmc/driver.py``.

    masses[k-1] = sum over integer partitions a of n with k parts of
      nd(a) * #rooted_trees(k) * prod_{a_i>2} #rooted_trees(a_i) * wlh
    where nd(a) = n! / prod a_i! / prod mult(a)! (#set partitions of
    that shape), and wlh = mean labeled histories per k-taxon tree for
    the SLH prior (delimit.c:118-123, prior 2 only, k > 3).
    """
    from math import factorial

    def trees(k):       # rooted labeled topologies: (2k-3)!!
        if k < 3:
            return 1.0
        out = 1.0
        for i in range(3, 2 * k - 2, 2):
            out *= i
        return out

    def lh(k):          # total labeled histories: k! (k-1)! / 2^(k-1)
        return factorial(k) * factorial(k - 1) / 2.0 ** (k - 1)

    masses = np.zeros(n)

    def partitions(total, maxpart):
        if total == 0:
            yield []
            return
        for first in range(min(total, maxpart), 0, -1):
            for rest in partitions(total - first, first):
                yield [first] + rest

    for a in partitions(n, n):
        k = len(a)
        nd = float(factorial(n))
        for ai in a:
            nd /= factorial(ai)
        for v in set(a):
            nd /= factorial(a.count(v))
        guide = 1.0
        for ai in a:
            if ai > 2:
                guide *= trees(ai)
        wlh = 1.0
        if k > 3 and delimit_prior == 2:
            wlh = lh(k) / trees(k)
        masses[k - 1] += nd * trees(k) * guide * wlh
    return masses / masses.sum()


def reset_finetune_onestep(pjump: float, val: float) -> float:
    """method.c:1122 reset_finetune_onestep."""
    maxstep = 99.0
    minstep = 1e-10
    if pjump < 0.001:
        return max(minstep, val / 100.0)
    if pjump > 0.999:
        return min(maxstep, val * 100.0)
    return min(maxstep, max(minstep, val * np.tan(np.pi / 2 * pjump)
                            / np.tan(np.pi / 2 * PJ_OPTIMUM)))


def resolve_device(device=None) -> torch.device:
    """The run's device: CUDA unless the caller asks for the CPU.  A
    missing GPU is an error, never a silent CPU run.  Sets full-f32
    matmul precision (no TF32) on the device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(NO_CUDA)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def _reference_guards(cfg: BppConfig, run: RunData):
    """The combination guards of ``bpp_tpu``'s Engine, unchanged."""
    st = run.stree
    if cfg.est_delimit and not 0 <= cfg.delimit_prior <= 3:
        raise ValueError("speciesmodelprior must be 0..3 (bpp.h:190)")
    if st.n_hybrids > 0 and (cfg.est_delimit or cfg.est_stree):
        raise NotImplementedError(
            "species delimitation / species-tree search cannot be "
            "combined with an MSC-I network (reference asserts, "
            "method.c:3871)")
    if cfg.clock != Clock.GLOBAL:
        if st.n_hybrids > 0 and cfg.clock == Clock.CORRELATED:
            raise NotImplementedError(
                "MSC-I networks with the auto-correlated relaxed "
                "clock are not supported (matches the reference, "
                "method.c:3291)")
        if cfg.est_delimit and cfg.clock == Clock.CORRELATED:
            raise NotImplementedError(
                "the auto-correlated clock (clock=3) cannot be "
                "combined with rjMCMC species delimitation: the "
                "correlated rate prior depends on the taus the rj "
                "move changes (the reference ignores this delta; "
                "see VALIDATION.md round 3). Use clock = 2 or 4.")
    if (cfg.est_locusrate == 1 and cfg.locusrate_prior == 3
            and cfg.clock != Clock.GLOBAL):
        raise NotImplementedError(
            "locusrate Dir prior cannot be combined with a relaxed "
            "clock (matches the reference's cfile fatal); use the "
            "Gamma-Dirichlet or hierarchical prior instead")
    if cfg.usedata_fix_gtree and (cfg.est_stree or cfg.est_delimit):
        raise NotImplementedError(
            "usedata = 2 (fixed gene trees) works with A00 only "
            "(method.c:3279)")
    if cfg.usedata_fix_gtree and st.n_hybrids > 0:
        raise NotImplementedError(
            "usedata = 2 (fixed gene trees) is not supported with "
            "MSC-I networks (method.c:3279: MSC-A00 only)")
    if cfg.usedata_fix_gtree and cfg.geneflow:
        raise NotImplementedError(
            "usedata = 2 cannot be combined with geneflow route "
            "rjMCMC (method.c:3279)")
    if cfg.migration:
        if cfg.est_stree:
            # cfile.c:2884 fatal (delimitation on a fixed guide tree is
            # available: prop_rj.c:599-656)
            raise NotImplementedError(
                "species-tree search (A01/A11) is not available "
                "under the MSC-M model (cfile.c:2884)")
        if cfg.est_delimit and cfg.geneflow:
            raise NotImplementedError(
                "geneflow route rjMCMC with species delimitation is "
                "not yet supported in bpp_tpu (the route windows "
                "change under a moving delimitation; fixed-route "
                "migration with A10 is supported)")
        if st.n_hybrids > 0:
            raise NotImplementedError(
                "MSC-I networks cannot be combined with MSC-M "
                "migration (reference: assert in stree.c:7452)")
        if cfg.clock == Clock.CORRELATED:
            raise NotImplementedError(
                "the auto-correlated clock with migration is not "
                "supported; use clock = 2 (iid) or 4 (simple)")
        if cfg.theta_integrated:
            raise NotImplementedError(
                "thetas cannot be integrated out under migration "
                "(gtree.c:9271 fatal)")
        routes = mg.build_routes(cfg, st)
        if (routes.si == st.root).any() or (routes.ti == st.root).any():
            raise ValueError("migration to/from the root population "
                             "is impossible (no contemporaries)")
        anc = st.pptable()
        for s_, t_ in zip(routes.si.tolist(), routes.ti.tolist()):
            if anc[s_, t_] or anc[t_, s_]:
                raise ValueError(
                    "migration route between ancestor and descendant "
                    "populations: they never coexist")
        if cfg.geneflow and (routes.am > 0).any():
            raise NotImplementedError(
                "variable-rates routes (am > 0) cannot be "
                "combined with geneflow rjMCMC (the reference "
                "disables rate variation on rj-managed routes, "
                "stree.c:14194)")
    if cfg.theta_integrated and cfg.thetaprior.dist != PriorDist.INVGAMMA:
        raise ValueError(
            "theta integration ('e' flag) requires an inverse-"
            "gamma thetaprior (the conjugate form the analytic "
            "marginalization uses)")
    if cfg.datefile:
        # reference restrictions (cfile.c:2878-2891, 3486-3490): A00
        # only, global clock, locusrate = 3 (MUTRATE_ONLY)
        if cfg.est_stree or cfg.est_delimit:
            raise NotImplementedError(
                "tip dating (datefile) requires a fixed species tree (A00)")
        if cfg.clock != Clock.GLOBAL:
            raise NotImplementedError(
                "tip dating requires the strict molecular clock")
        if cfg.est_locusrate != 3:
            raise ValueError(
                "tip dating requires 'locusrate = 3 a_mubar b_mubar' "
                "(mutation-rate-only mode)")
        if st.n_hybrids > 0 or cfg.migration:
            raise NotImplementedError(
                "tip dating with MSC-I/MSC-M not yet supported")
        if st.n_tips < 2:
            # stree.c:9426 "Mu proposal not yet implemented for single
            # population"
            raise NotImplementedError(
                "tip dating needs at least two species")
        if run.tip_dates is None:
            raise ValueError("datefile given but no dates were loaded")
    if cfg.linked_theta and cfg.theta_integrated:
        raise NotImplementedError(
            "thetamodel cannot be combined with analytically "
            "integrated-out thetas")
    if (cfg.linked_theta and (cfg.est_stree or cfg.est_delimit)
            and cfg.linked_theta not in (1, 2)):
        raise NotImplementedError(
            "species-tree search / delimitation support "
            "thetamodel = linked-all / linked-inner only")
    if cfg.migration and cfg.linked_theta and cfg.linked_theta != 4:
        raise NotImplementedError(
            "use thetamodel = linked-mscm with migration")
    if cfg.traitfile and st.n_hybrids > 0:
        # the contrast recursion (morph.c:888) is defined on a tree;
        # traits with MSC-M are supported (they see only the taus)
        raise NotImplementedError(
            "traits with MSC-I networks are not supported")
    if cfg.constraintfile and cfg.est_stree and cfg.prob_snl > 0:
        # stree.c:11395: SNL has no constraint support
        raise NotImplementedError(
            "constraints are not implemented for the SNL move; "
            "use 'speciestree = 1 0' to disable SNL")


def likelihood_route(n_states: int, res_map) -> str:
    """The likelihood pass of a batch, chosen once per run: kernel K1 for
    4 states without a diploid resolution map, K2 (and ``reduce_root``)
    with one, the plain pass at 20 states (amino acids, or a partition
    with an amino-acid locus).  A per-locus DNA partition has 4 states and
    takes K1 or K2 through the GTR family."""
    if n_states != 4:
        return ROUTE_PLAIN
    return ROUTE_K1 if res_map is None else ROUTE_K2


ROUTE_GRAPH = "graph"
ROUTE_EAGER = "eager"


def step_route(cfg: BppConfig, shard=None) -> tuple[str, str]:
    """How an engine runs its chunks, chosen once from the configuration:
    ``("graph", why)`` where the step reads nothing back to the host, so
    that a chunk is n replays of one captured CUDA graph, else
    ``("eager", the host read)``.  Every one-card schedule is captured:
    the accept chains over loci are kernels K3/K4, SNL's species-level
    part and the SNL-or-SPR choice run on the device, and MSC-M's sim-SPR
    walk is kernel K5.  This table alone decides; a failed capture raises
    and never falls back to the eager step."""
    if shard is not None:
        return ROUTE_EAGER, (
            "--multihost: each sum over loci is all-reduced between the "
            "ranks (over gloo through the host, parallel/mesh.py:120-127)")
    return ROUTE_GRAPH, "the step reads nothing back to the host"


ROUTE_BATCHED = "batched"
ROUTE_PER_CHAIN = "per-chain"

def chain_route(cfg: BppConfig, run: RunData) -> tuple[str, str]:
    """How ``chains = K`` steps, chosen once from the configuration:
    ``("batched", why)``, one step over a leading chain axis of the K
    stacked states (``bpp_tpu``'s ``_chunk_multi``, which vmaps its chunk:
    :meth:`Engine._step_batched`, K1 or K2 launched once a pass, K3, K4
    and K5 once a call, for all K chains), or ``("per-chain", what is not
    batched)``, the chains' steps one after another.  The batched step
    takes every configuration that ``bpp_tpu``'s ``_run_multichain``
    takes: A00 and A10 (the rj move on a fixed guide tree) on a species
    tree or an MSC-I network (BDI among them), any substitution model
    (GTR and ``model = custom`` with a per-chain eigensystem, amino acids
    through the plain 20-state pass), haploid (K1) or diploid (K2 and
    ``reduce_root``) data, Gamma rates, heredity scalars, locus rates
    under any of their priors (Gamma-Dirichlet K4), estimated, integrated
    (K3) or linked thetas, tip dating, traits, ``usedata = 2``, and MSC-M
    (the sim-SPR walk K5) on fixed routes of constant or variable rate or
    under geneflow.  Only species-tree moves and relaxed clocks, which
    both CLIs refuse under ``chains > 1``, step one chain after another.
    This table alone decides: a batched step that fails to capture or
    launch raises, and nothing reruns the chains one by one."""
    why = None
    if cfg.est_stree:
        why = "species-tree moves (SPR, SNL)"
    elif cfg.clock != Clock.GLOBAL:
        why = "a relaxed clock"
    if why is not None:
        return ROUTE_PER_CHAIN, f"{why}: one chain's step after another"
    return ROUTE_BATCHED, ("one step over a chain axis: each kernel call "
                           "one launch for every chain")


@dataclass
class SampleLog:
    """Posterior samples collected on host."""

    gen: list = field(default_factory=list)
    theta: list = field(default_factory=list)     # [H]
    tau: list = field(default_factory=list)       # [H]
    lnL: list = field(default_factory=list)
    logpr: list = field(default_factory=list)
    mubar: list = field(default_factory=list)     # scalar; tip dating only
    sptrees: list = field(default_factory=list)   # (left, right, parent) per
                                                  # sample; A01/A11 only
    phi: list = field(default_factory=list)       # [H]; MSC-I only
    migM: list = field(default_factory=list)      # [K]; MSC-M only

    def add(self, g, row):
        """One sample: generation ``g`` and a trace row of host values."""
        self.gen.append(g)
        self.theta.append(row["theta"])
        self.tau.append(row["tau"])
        self.lnL.append(float(row["lnl"]))
        self.logpr.append(float(row["logpr"]))
        if "mubar" in row:
            self.mubar.append(float(row["mubar"]))
        if "phi" in row:
            self.phi.append(row["phi"])
        if "migM" in row:
            self.migM.append(row["migM"])
        if "sp_left" in row:
            self.sptrees.append((row["sp_left"], row["sp_right"],
                                 row["sp_parent"]))

    def arrays(self):
        return (np.asarray(self.gen), np.stack(self.theta),
                np.stack(self.tau), np.asarray(self.lnL),
                np.asarray(self.logpr))


class Engine:
    """Owns device data and the step for one inference run; with
    ``shard`` (``parallel.mesh.Shard``) one rank's block of its loci."""

    def __init__(self, run: RunData, seed: int | None = None, device=None,
                 shard=None):
        self.run = run
        self.shard = None
        self.cfg = cfg = run.cfg
        _reference_guards(cfg, run)
        self.device = dev = resolve_device(device)
        self.seed = seed if seed is not None else (
            cfg.seed if cfg.seed > 0
            else np.random.SeedSequence().entropy % (2**31))
        self.dtype = torch.float64 if cfg.dtype == "float64" else torch.float32
        self.root_age0 = None         # rjMCMC root-age scale (init_state)
        batch = run.batch
        # static data, checked once: the pruning kernels walk n_seq - 1
        # levels of a tree of at most tip_codes.shape[1] tips unchecked
        n_seq = np.asarray(batch.n_seq)
        if n_seq.min() < 0 or n_seq.max() > batch.tip_codes.shape[1]:
            raise ValueError(
                f"n_seq spans {n_seq.min()}..{n_seq.max()}; the batch holds "
                f"{batch.tip_codes.shape[1]} tips a locus")
        # non-diploid batches carry an identity resolution map (one
        # column per weight pattern): drop it, so that they take the
        # per-locus kernel K1; any other map sends the whole batch through
        # the per-pattern kernel K2 and reduce_root
        rm, rcnt = batch.res_map, batch.res_count
        if (rm.shape[2] == 1 and rm.shape[1] == batch.tip_codes.shape[-1]
                and ((rm[..., 0] == np.arange(rm.shape[1])[None, :])
                     | (batch.weights == 0)).all()):
            rm = rcnt = None

        def t(a, dtype=None):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        # morphological traits: the likelihood on the fixed topology, or
        # on the topology it is given under species-tree search (the
        # species SPR and SNL moves re-score the proposed topology; under
        # A11 the rj move re-scores the current one)
        trait_fn = trait_fn_topo = self.trait_data = None
        if cfg.traitfile:
            parts = trmod.parse_traitfile(cfg.traitfile)
            self.trait_data = trmod.build_trait_data(parts, run.stree,
                                                     self.dtype, dev)
            if cfg.est_stree:
                trait_fn_topo = trmod.make_trait_logl_topo(
                    run.stree.n_tips, run.stree.n_nodes, self.trait_data)
            else:
                trait_fn = trmod.make_trait_logl(run.stree, self.trait_data)
        custom = None
        if run.locus_models is not None:
            custom = build_custom_models(run.locus_models, batch.n_loci,
                                         self.dtype, dev)
        self.n_states = (custom.n_states if custom is not None
                         else cfg.model.n_states)
        self.route, self.route_reason = step_route(cfg)
        self.chains_route, self.chains_route_reason = chain_route(cfg, run)
        self.ctx = Ctx(
            tip_partials=fe.tip_partials_from_codes(
                t(batch.tip_codes.astype(np.int64)), dtype=self.dtype,
                n_states=self.n_states),
            weights=t(batch.weights, self.dtype),
            n_seq=t(batch.n_seq, torch.int64),
            tip_pop=t(batch.tip_pop, torch.int64),
            locus_mask=t(batch.locus_mask, torch.bool),
            res_map=None if rm is None else t(rm, torch.int64),
            res_count=None if rcnt is None else t(rcnt, torch.int64),
            n_pat=t(batch.n_pat, torch.int64),
            units=Units(batch.n_pat, batch.max_patterns, dev)
            if dev.type == "cuda" else None,
            tip_dates=None if run.tip_dates is None
            else t(run.tip_dates, self.dtype),
            date_lmax=None if run.date_lmax is None
            else t(run.date_lmax, self.dtype),
            integrated=bool(cfg.theta_integrated),
            sp_constraint=None if not (cfg.constraintfile and cfg.est_stree)
            else t(build_constraint_ids(run.stree, cfg.constraintfile),
                   torch.int64),
            prior_a11_log=None if not (cfg.est_delimit and cfg.est_stree
                                       and cfg.delimit_prior >= 2)
            else t(np.log(prior_a11_masses(run.stree.n_tips,
                                           cfg.delimit_prior)), self.dtype),
            # linked thetas: the owner map is defined by node classes
            # (tips, inner, root; a network's hybridizations), which no
            # species move changes (bpp_tpu driver.py:391-411)
            theta_link=None if not cfg.linked_theta
            else t(theta_link_map(run.stree, cfg.linked_theta), torch.int64),
            custom=custom,
            route=likelihood_route(self.n_states, rm),
            trait_fn=trait_fn,
            trait_fn_topo=trait_fn_topo,
            captured=self.route == ROUTE_GRAPH and dev.type == "cuda",
        )
        self._logl_fn = make_logl_fn(self.ctx, cfg)
        self._logpr_fn = make_logpr_fn(self.ctx)
        # MSC-M: the route table on the host and on the device; geneflow
        # rjMCMC takes the saturated candidate table, in which the
        # configured routes start active
        self.routes = self.mig_routes = self.route_on0 = None
        if cfg.migration:
            if cfg.geneflow:
                self.routes, self.route_on0 = mg.build_routes_geneflow(
                    cfg, run.stree)
            else:
                self.routes = mg.build_routes(cfg, run.stree)
            self.mig_routes = self.routes.to(dev, self.dtype)
            self._logpr_mig_fn = mig_moves.make_logpr_fn_mig(
                self.ctx, self.mig_routes)
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(int(self.seed))
        self.record_samples()
        self._graphs = {}     # generators' ids -> their StepGraph
        self._chain_idx = None    # the batched step's chain index
        if shard is not None:
            self.set_shard(shard)

    def set_shard(self, shard):
        """Keep only ``shard``'s block of the loci: the context's per-locus
        tensors and the kernels' unit table are rebuilt from its rows, and
        the likelihood and density closures rebound to them.  States come
        from :meth:`init_state` (or ``parallel.mesh.shard_by_locus``) in
        the same block."""
        if shard.n_loci != self.run.batch.n_loci:
            raise ValueError(f"the shard splits {shard.n_loci} loci, the run "
                             f"has {self.run.batch.n_loci}")
        self.shard = shard
        self.route, self.route_reason = step_route(self.cfg, shard)
        self._graphs = {}
        self.ctx = dataclasses.replace(
            shard_by_locus(self.ctx, shard),
            captured=self.route == ROUTE_GRAPH and self.device.type == "cuda")
        self._logl_fn = make_logl_fn(self.ctx, self.cfg)
        self._logpr_fn = make_logpr_fn(self.ctx)
        if self.cfg.migration:
            self._logpr_mig_fn = mig_moves.make_logpr_fn_mig(
                self.ctx, self.mig_routes)

    # --- state construction ---------------------------------------------------

    def _parse_doubles_file(self, path: str, what: str) -> np.ndarray:
        """Whitespace-separated per-locus doubles (parsefile_doubles,
        method.c:3942/3986); must match the real locus count exactly."""
        with open(path) as fh:
            vals = np.asarray([float(tok) for tok in fh.read().split()])
        n_real = int(np.asarray(self.run.batch.locus_mask).sum())
        if len(vals) != n_real:
            raise ValueError(
                f"{path} contains {'more' if len(vals) > n_real else 'fewer'}"
                f" {what} ({len(vals)}) than loci ({n_real})")
        return vals

    def _init_mu(self, L: int) -> np.ndarray:
        cfg = self.cfg
        out = np.ones(L)
        if cfg.est_locusrate == 2 and cfg.locusrate_file:
            # fixed rates from file, normalized to mean 1
            # (MUTRATE_FROMFILE, method.c:3984-4008)
            vals = self._parse_doubles_file(cfg.locusrate_file, "rates")
            out[:len(vals)] = vals / vals.mean()
        elif cfg.est_locusrate == 1:
            out[:] = cfg.locusrate_mubar
        return out

    def _init_heredity(self, L: int) -> np.ndarray:
        cfg = self.cfg
        out = np.ones(L)
        if cfg.est_heredity == 2 and cfg.heredity_file:
            # fixed heredity scalars (HEREDITY_FROMFILE, method.c:3938)
            vals = self._parse_doubles_file(cfg.heredity_file, "scalars")
            out[:len(vals)] = vals
        return out

    def init_state(self) -> McmcState:
        """Initial tau/theta from the priors, gene trees from the MSC
        prior, near-uniform frequencies and exchangeabilities and the rate
        hierarchy, all drawn from the same numpy stream, in the same
        order, as ``bpp_tpu``.  (``bpp_tpu`` also carries the hierarchical
        start's mean rate in ``state.mubar`` under a relaxed clock, where
        its summary then reports a constant ``mu_bar``; the port keeps
        ``mubar`` for tip dating only.)  A sharded engine draws the
        global state and keeps its block before the first likelihood
        pass, which runs on its own loci."""
        cfg, run = self.cfg, self.run
        dev, dt = self.device, self.dtype
        rng = np.random.default_rng(self.seed)
        mubar0 = tip_ages0 = None
        if run.tip_dates is not None:
            # dated tips: ages date * mubar, every tau above its oldest
            # dated descendant
            mubar0 = cfg.locusrate_mubar_a / cfg.locusrate_mubar_b
            tip_ages0 = run.tip_dates * mubar0
            init_tau_theta(cfg, run.stree, rng,
                           lconstraint=run.date_lmax * mubar0)
        else:
            init_tau_theta(cfg, run.stree, rng)
        # the rjMCMC Beta proposal's scale at the root (prop_rj.c:431-435)
        self.root_age0 = _root_age_scale(cfg, run)
        gt = init_gtrees(int(rng.integers(2**31)), run.batch, run.stree,
                         dtype=dt, device=dev, tip_ages=tip_ages0)
        sp = species_arrays(run.stree, dtype=dt, device=dev)
        L = run.batch.n_loci
        C = cfg.gamma_cats

        # near-uniform random starting freqs/qrates (locus.c:961-975);
        # amino-acid models keep their fixed frequencies (locus.c:985)
        S = self.n_states
        qrates = np.ones((L, 6))
        if cfg.model == SubstModel.CUSTOM:
            freqs = np.zeros((L, S))
            freqs[:, :4] = 0.25
            for i, m in enumerate(run.locus_models):
                if m.is_aa:
                    freqs[i] = aa_eigen(m.name)[3]
                elif m in subst_moves.FREQS_MODELS:
                    f = 0.8 + 0.4 * rng.random(4)
                    freqs[i, :4] = f / f.sum()
                if m in subst_moves.QRATES_COUNT:
                    cnt, _ = subst_moves.QRATES_COUNT[m]
                    q = 0.8 + 0.4 * rng.random(cnt)
                    qrates[i, :cnt] = q / q.sum()
        elif cfg.model.is_aa:
            freqs = np.tile(aa_eigen(cfg.model.name)[3], (L, 1))
        elif cfg.model in subst_moves.FREQS_MODELS:
            f = 0.8 + 0.4 * rng.random((L, 4))
            freqs = f / f.sum(1, keepdims=True)
        else:
            freqs = np.full((L, 4), 0.25)
        if cfg.model in subst_moves.QRATES_COUNT:
            cnt, _ = subst_moves.QRATES_COUNT[cfg.model]
            q = 0.8 + 0.4 * rng.random((L, cnt))
            qrates[:, :cnt] = q / q.sum(1, keepdims=True)
        alpha0 = cfg.alphaprior.mean() if cfg.alphaprior else 0.0
        if cfg.alphaprior and C > 1:
            rates0 = discrete_gamma_rates(
                torch.tensor(alpha0, dtype=torch.float64), C).expand(L, C)
        else:
            rates0 = np.ones((L, C))
        mu0 = self._init_mu(L)

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

        def full(shape, v):
            return torch.full(shape, v, dtype=dt, device=dev)

        subst = SubstState(
            freqs=t(freqs), kappa1=full((L,), 1.0), kappa2=full((L,), 1.0),
            qrates=t(qrates), alpha=full((L,), alpha0), rates=t(rates0),
            mu=t(mu0), heredity=t(self._init_heredity(L)),
            eigw=full((L, S), 0.0), eigT=full((L, S, S), 0.0),
            eigTi=full((L, S, S), 0.0))
        clock = None
        if cfg.clock != Clock.GLOBAL or (
                cfg.est_locusrate == 1 and cfg.locusrate_prior in (0, 1)):
            if (cfg.clock != Clock.GLOBAL and cfg.est_locusrate == 1
                    and cfg.locusrate_prior == 1):
                # hierarchical start: mu_i jittered around mubar
                # (method.c:4212-4214)
                mub = (cfg.locusrate_mubar_a / cfg.locusrate_mubar_b
                       if cfg.locusrate_mubar_b > 0 else cfg.locusrate_mubar)
                mu0 = mub * (0.9 + 0.2 * rng.random(L))
                subst = subst._replace(mu=t(mu0))
            clock = clock_moves.init_clock_state(cfg, sp, mu0, rng)
        trait = None
        if self.ctx.has_traits:
            # brates start at 1 (trait_init morph.c:832)
            brate0 = full((len(self.trait_data), run.stree.n_nodes), 1.0)
            trait = trmod.TraitState(
                brate=brate0,
                logl=moves._trait_eval(self.ctx, sp, sp.tau, brate0))
        mig = None
        if cfg.migration:
            # no events at the start (a valid support point; the sim-SPR
            # move makes them), route rates at their prior means
            routes = self.routes
            mig = mg.empty_mig_state(
                L, max(16, 2 * run.batch.max_tips), routes.n_routes,
                routes.alpha / routes.beta, dt, on=self.route_on0,
                device=dev)
        state = McmcState(
            gt=gt, sp=sp, subst=subst, logl=None, logpr=None,
            finetune=finetune_array(cfg, dt, dev), clock=clock,
            mubar=None if mubar0 is None else t(mubar0), mig=mig,
            trait=trait)
        if self.shard is not None:
            state = shard_by_locus(state, self.shard,
                                   shared_clock=cfg.clock == Clock.SIMPLE)
            gt, subst, clock, mig = (state.gt, state.subst, state.clock,
                                     state.mig)
        subst = subst_moves._derive_kappas(subst, cfg.model, self.ctx.custom)
        subst = refresh_eigen(subst, cfg.model, self.ctx.custom,
                              self.ctx.captured)
        state = state._replace(subst=subst)
        if cfg.migration:
            return state._replace(
                logl=self._logl_fn(gt, subst, sp, clock, mig=mig),
                logpr=self._logpr_mig_fn(gt, sp, mig, subst.heredity)[0])
        logl = self._logl_fn(gt, subst, sp, clock)
        logpr, c0, t20 = self._logpr_fn(gt, sp, subst.heredity)
        integ = cfg.theta_integrated
        return state._replace(logl=logl, logpr=logpr,
                              coal=c0 if integ else None,
                              t2h=t20 if integ else None)

    # --- one iteration --------------------------------------------------------

    def _step(self, state: McmcState):
        """One iteration of the main-path move schedule; returns (state,
        stats [N_MOVES, 2] on the device)."""
        cfg, ctx, gen = self.cfg, self.ctx, self.gen
        # made from the state, so that inside the batched step (vmap) the
        # statistics carry the chain axis: [K, N_MOVES, 2]
        stats = state.logl.new_zeros((N_MOVES, 2), dtype=torch.int64)

        def count(mv, pa):
            stats[mv, 0] += pa[0]
            stats[mv, 1] += pa[1]

        if cfg.migration:
            return self._step_mig(state, count), stats

        # rjMCMC split/join (A10/A11; method.c:5420-5435)
        if cfg.est_delimit:
            state, pa = rj_moves.rj_move(ctx, cfg, state, gen, self.root_age0)
            count(MV_RJ, pa)
        # species-tree SPR or SNL (A01/A11; method.c:5438-5477 picks SNL
        # with probability pSNL); with < 3 species there is no other
        # rooted topology
        if cfg.est_stree and self.run.stree.n_tips >= 3:
            state, counts = self._species_move(state)
            for mv, pa in counts:
                count(mv, pa)

        # usedata = 2 freezes the gene trees and taus (method.c:5490,
        # 5524, 5572, 5600)
        if not cfg.usedata_fix_gtree:
            state, pa = moves.age_block_move(ctx, cfg, state, gen)
            count(MV_GTAGE, pa)
            for _ in range(3):
                state, pa = moves.spr_round_move(ctx, cfg, state, gen)
                count(MV_GTSPR, pa)
        if not cfg.theta_integrated:
            state, pa = moves.theta_move(ctx, cfg, state, gen)
            count(MV_THETA, pa)
        if state.sp.is_network:
            # MSC-I: the network tau slide, then the population and flag
            # re-choice and the phi draw (bpp_tpu driver.py:823-835)
            state, pa = msci_moves.tau_move_net(ctx, cfg, state, gen)
            count(MV_TAU, pa)
            state, pa = msci_moves.repath_move(ctx, cfg, state, gen)
            count(MV_HPATH, pa)
            state, pa = msci_moves.phi_gibbs_move(ctx, cfg, state, gen)
            count(MV_PHI, pa)
        elif not cfg.usedata_fix_gtree:
            state, pa = moves.tau_move(ctx, cfg, state, gen)
            count(MV_TAU, pa)
        if not cfg.usedata_fix_gtree:
            # mixing would move the fixed tip dates (method.c:5600); the
            # tip-dating mubar move takes its global-rescaling role
            if ctx.tip_dates is None:
                state, pa = moves.mixing_move(ctx, cfg, state, gen)
                count(MV_MIX, pa)
            else:
                state, pa = clock_moves.tipdate_mubar_move(ctx, cfg, state,
                                                           gen)
                count(MV_MUBAR, pa)

        # substitution and rate moves (method.c:5616-5736); inclusion is
        # static per cfg.  The Dirichlet prior (3) uses the compensating-
        # pair move; Gamma-Dirichlet (0) and hierarchical (1) use the mu_i
        # log-slide (prop_locusrate_mui, method.c:5745)
        if cfg.est_locusrate == 1 and cfg.locusrate_prior == 3:
            state, pa = subst_moves.locusrate_move(ctx, cfg, state, gen)
            count(MV_LRHT, pa)
        if cfg.est_heredity == 1:
            state, pa = subst_moves.heredity_move(ctx, cfg, state, gen)
            count(MV_LRHT, pa)
        if cfg.model in subst_moves.FREQS_MODELS or (
                ctx.custom is not None and ctx.custom.any_freqs):
            state, pa = subst_moves.freqs_move(ctx, cfg, state, gen)
            count(MV_FREQS, pa)
        if cfg.model in subst_moves.QRATES_COUNT or (
                ctx.custom is not None and ctx.custom.q_slots):
            state, pa = subst_moves.qrates_move(ctx, cfg, state, gen)
            count(MV_QRATES, pa)
        if cfg.alphaprior is not None:
            state, pa = subst_moves.alpha_move(ctx, cfg, state, gen)
            count(MV_ALPHA, pa)
        if cfg.est_locusrate == 1 and cfg.locusrate_prior in (0, 1):
            state, pa = clock_moves.mui_move(ctx, cfg, state, gen)
            count(MV_MUI, pa)
            if cfg.locusrate_prior == 1 and cfg.locusrate_mubar_est:
                state, pa = clock_moves.mubar_move(ctx, cfg, state, gen)
                count(MV_MUBAR, pa)
        # relaxed clocks: nu_i, nubar and the branch rates
        # (method.c:5745-5835 order)
        if cfg.clock not in (Clock.GLOBAL, Clock.SIMPLE):
            state, pa = clock_moves.nui_move(ctx, cfg, state, gen)
            count(MV_NUI, pa)
            if cfg.locusrate_prior == 1:
                state, pa = clock_moves.nubar_move(ctx, cfg, state, gen)
                count(MV_NUBAR, pa)
            state, pa = clock_moves.brate_move(ctx, cfg, state, gen)
            count(MV_BRATE, pa)
        elif cfg.clock == Clock.SIMPLE:
            state, pa = clock_moves.brate_simple_move(ctx, cfg, state, gen)
            count(MV_BRATE, pa)
        # move #16: the trait branch rates (method.c:5838, morph.c:1177)
        if ctx.has_traits:
            state, pa = trait_moves.trait_brate_move(ctx, cfg, state, gen)
            count(MV_TRAIT, pa)
        return state, stats

    def _step_mig(self, state: McmcState, count):
        """The MSC-M move schedule (method.c order with the migration
        variants; ``bpp_tpu``'s ``Engine._step_mig``)."""
        cfg, ctx, gen, routes = self.cfg, self.ctx, self.gen, self.mig_routes
        # rjMCMC split/join under the IM model (A10 x MSC-M)
        if cfg.est_delimit:
            state, pa = rj_moves.rj_move(ctx, cfg, state, gen,
                                         self.root_age0, routes=routes)
            count(MV_RJ, pa)
        # usedata = 2 freezes the gene trees, event ages and taus
        # (method.c:5490, 5515, 5524, 5572)
        fixed = cfg.usedata_fix_gtree
        if not fixed:
            state, pa = mig_moves.age_block_mig(ctx, cfg, routes, state, gen)
            count(MV_GTAGE, pa)
            state, pa = mig_moves.migevent_age_move(ctx, cfg, routes, state,
                                                    gen)
            count(MV_MIG_AGES, pa)
            for _ in range(3):
                state, pa = mig_moves.spr_sim_move(ctx, cfg, routes, state,
                                                   gen)
                count(MV_GTSPR, pa)
        state, pa = mig_moves.theta_move_mig(ctx, cfg, routes, state, gen)
        count(MV_THETA, pa)
        if not fixed:
            state, pa = mig_moves.tau_move_mig(ctx, cfg, routes, state, gen)
            count(MV_TAU, pa)
        state, pa = mig_moves.migrate_move(ctx, cfg, routes, state, gen)
        count(MV_MIGRATES, pa)
        # variable-rate routes (am > 0): the per-locus Mi slides and the
        # Mbar hyper-rate slide (stree.c:11932, 11676)
        if routes.any_am:
            state, pa = mig_moves.mig_vrates_move(ctx, cfg, routes, state,
                                                  gen)
            count(MV_MIGRATES, pa)
            state, pa = mig_moves.mig_mbar_move(ctx, cfg, routes, state, gen)
            count(MV_MIGRATES, pa)
        if not fixed:
            state, pa = mig_moves.mixing_mig(ctx, cfg, routes, state, gen)
            count(MV_MIX, pa)
        # geneflow rjMCMC: the flip, then add/remove (method.c:5658-5695)
        if cfg.geneflow:
            state, pa = mig_moves.geneflow_flip_move(ctx, cfg, routes, state,
                                                     gen)
            count(MV_GFRJ, pa)
            state, pa = mig_moves.geneflow_rj_move(ctx, cfg, routes, state,
                                                   gen)
            count(MV_GFRJ, pa)
        if cfg.model in subst_moves.FREQS_MODELS or (
                ctx.custom is not None and ctx.custom.any_freqs):
            state, pa = subst_moves.freqs_move(ctx, cfg, state, gen)
            count(MV_FREQS, pa)
        if cfg.model in subst_moves.QRATES_COUNT or (
                ctx.custom is not None and ctx.custom.q_slots):
            state, pa = subst_moves.qrates_move(ctx, cfg, state, gen)
            count(MV_QRATES, pa)
        if cfg.alphaprior is not None:
            state, pa = subst_moves.alpha_move(ctx, cfg, state, gen)
            count(MV_ALPHA, pa)
        if cfg.est_locusrate == 1 and cfg.locusrate_prior == 3:
            state, pa = subst_moves.locusrate_move(ctx, cfg, state, gen)
            count(MV_LRHT, pa)
        if cfg.est_heredity == 1:
            state, pa = mig_moves.heredity_move_mig(ctx, cfg, routes, state,
                                                    gen)
            count(MV_LRHT, pa)
        # locus rates and the relaxed clocks (method.c:5745-5835); their
        # passes take the branch lengths of the sub-edge sweep
        if cfg.est_locusrate == 1 and cfg.locusrate_prior in (0, 1):
            state, pa = clock_moves.mui_move(ctx, cfg, state, gen)
            count(MV_MUI, pa)
            if cfg.locusrate_prior == 1 and cfg.locusrate_mubar_est:
                state, pa = clock_moves.mubar_move(ctx, cfg, state, gen)
                count(MV_MUBAR, pa)
        if cfg.clock == Clock.SIMPLE:
            state, pa = clock_moves.brate_simple_move(ctx, cfg, state, gen)
            count(MV_BRATE, pa)
        elif cfg.clock != Clock.GLOBAL:
            state, pa = clock_moves.nui_move(ctx, cfg, state, gen)
            count(MV_NUI, pa)
            if cfg.locusrate_prior == 1:
                state, pa = clock_moves.nubar_move(ctx, cfg, state, gen)
                count(MV_NUBAR, pa)
            state, pa = clock_moves.brate_move(ctx, cfg, state, gen)
            count(MV_BRATE, pa)
        # move #16: the trait branch rates; the trait likelihood sees only
        # the taus, so it composes with migration
        if ctx.trait_fn is not None:
            state, pa = trait_moves.trait_brate_move(ctx, cfg, state, gen)
            count(MV_TRAIT, pa)
        return state

    def _step_batched(self, state: McmcState, gens):
        """One iteration of K chains at once: ``state`` holds the K
        chains' states stacked (every tensor with a leading chain axis,
        :func:`stack_states`) and chain k draws from ``gens[k]``.  The
        counterpart of ``bpp_tpu``'s ``_chunk_multi``: ``torch.func.vmap``
        of the one-chain :meth:`_step` over the chain axis, in which every
        draw is chain k's draw from its own generator
        (``rng.ChainGens``), every pruning pass one call of K1 or K2
        over all K chains (``Ctx.chains``) and every accept chain or
        sim-SPR walk one call of K3, K4 or K5 (``pack.chain_pass``); an
        MSC-M run steps :meth:`_step_mig`.  Returns (state, stats [K,
        N_MOVES, 2]).  Only configurations :func:`chain_route` sends to
        the batched route run here."""
        K = len(gens)
        if self.chains_route != ROUTE_BATCHED:
            raise ValueError("chains = K of this configuration step one "
                             "chain after another "
                             f"({self.chains_route_reason})")
        spec, leaves = flatten(state)
        idx = self._chain_index(K)
        own_gen, own_ctx = self.gen, self.ctx

        def one(leaves, i):
            self.gen = rng.ChainGens(gens, i)
            new, stats = self._step(unflatten(spec, iter(leaves)))
            out_spec, out = flatten(new)
            if out_spec != spec:
                raise ValueError("the step changed the state's structure")
            return out, stats

        self.ctx = dataclasses.replace(own_ctx, chains=K)
        try:
            out, stats = torch.func.vmap(one)(leaves, idx)
        finally:
            self.gen, self.ctx = own_gen, own_ctx
        return unflatten(spec, iter(out)), stats

    def _trace_batched(self, state: McmcState):
        """:meth:`_trace_of` of K stacked chains: rows ``{key: [K, ...]}``."""
        spec, leaves = flatten(state)
        return torch.func.vmap(
            lambda lv: self._trace_of(unflatten(spec, iter(lv))))(leaves)

    def _chain_index(self, K):
        """The chain index 0..K-1 the batched step is vmapped over (kept,
        so that a captured step reads the same tensor)."""
        if self._chain_idx is None or self._chain_idx.shape[0] != K:
            self._chain_idx = torch.arange(K, device=self.device)
        return self._chain_idx

    def _chunk_multi(self, state: McmcState, gens, n: int):
        """n batched iterations of the K stacked chains ``state`` on the
        eager route (a Python loop over :meth:`_step_batched`); returns
        (state, stats [K, N_MOVES, 2], the K chains' traces {key: [n,
        ...]})."""
        K = len(gens)
        acc = torch.zeros((K, N_MOVES, 2), dtype=torch.int64,
                          device=self.device)
        rows = []
        for _ in range(n):
            state, stats = self._step_batched(state, gens)
            acc += stats
            rows.append(self._trace_batched(state))
        rows = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
        return state, acc, [{k: v[:, c] for k, v in rows.items()}
                            for c in range(K)]

    def _species_move(self, state: McmcState):
        """One species SPR or SNL; returns (state, [(move slot, (proposed,
        accepted))]).  With SNL on, the choice is drawn on the device and
        both moves are computed from the same state; the state and the
        MV_SNL / MV_SSPR statistics are selected with ``torch.where``, as
        ``bpp_tpu``'s ``lax.cond`` computes under ``vmap``, so nothing is
        read on the host."""
        cfg, ctx, gen = self.cfg, self.ctx, self.gen
        if cfg.prob_snl <= 0:
            state, pa = stree_moves.species_spr_move(ctx, cfg, state, gen)
            return state, [(MV_SSPR, pa)]
        H = state.sp.n_nodes
        u = rng.uniform(gen, (1 + stree_moves.snl_uniform_count(H),),
                        torch.float64, self.device)
        use_snl = u[0] < cfg.prob_snl
        snl, (_, acc_snl) = stree_moves.snl_move(ctx, cfg, state, gen,
                                                 u=u[1:])
        spr, (_, acc_spr) = stree_moves.species_spr_move(ctx, cfg, state,
                                                         gen)
        on = use_snl.to(torch.int64)
        return tree_where(use_snl, snl, spr), [
            (MV_SNL, (on, on * acc_snl)),
            (MV_SSPR, (1 - on, (1 - on) * acc_spr))]

    def _trace_of(self, state: McmcState):
        """Per-iteration sample record, kept on the device: what the
        columns of mcmc.txt need (``bpp_tpu/cli.py:232-281``).  The sums
        over loci (``_LOCUS_SUMS``) are this rank's under sharding;
        :meth:`_chunk` all-reduces them."""
        cfg = self.cfg
        tr = {"theta": state.sp.theta, "tau": state.sp.tau,
              "lnl": torch.sum(state.logl), "logpr": torch.sum(state.logpr)}
        if state.sp.phi is not None:
            tr["phi"] = state.sp.phi
        if state.mig is not None:
            # geneflow: an inactive route logs 0 (its slot holds a
            # pseudo-prior draw, not a posterior rate)
            M = state.mig.M
            tr["migM"] = (M if state.mig.on is None else
                          torch.where(state.mig.on, M, torch.zeros_like(M)))
        if state.mubar is not None:
            # tip dating: mu_bar and the calendar-unit taus
            tr["mubar"] = state.mubar
        if (cfg.est_locusrate == 1 and cfg.locusrate_prior == 1
                and cfg.locusrate_mubar_est):
            # the mu_bar column under the hierarchical locus-rate prior
            tr["mubar_h"] = state.clock.mubar
        if cfg.clock == Clock.SIMPLE:
            tr["brate0"] = state.clock.brate[0]
        elif cfg.clock != Clock.GLOBAL:
            # one nu_bar (hierarchical) or nu (mean nu_i) column
            nu, m = state.clock.nu, self.ctx.locus_mask
            if cfg.locusrate_prior == 1:
                tr["nu_col"] = state.clock.nubar
            else:
                tr["nu_sum"] = torch.where(m, nu, torch.zeros_like(nu)).sum()
                tr["nu_n"] = m.sum()
        if cfg.est_stree:
            tr["sp_left"] = state.sp.left
            tr["sp_right"] = state.sp.right
            tr["sp_parent"] = state.sp.parent
        return tr

    def record_samples(self, a1b1=False, loci=(), gtrees=False,
                       params=False):
        """Ask each sample for more than the columns of mcmc.txt: the
        conditional (a1, b1) of every population (``a1b1``, the
        ``conditional_a1b1.txt`` log), and, of the loci ``loci``
        (0-based), the gene trees (``gtrees``) and the heredity scalar,
        locus rate, nu_i and branch rates (``params``: the per-locus print
        files).  They are computed at sample generations only and reach
        the host with the chunk's trace; unasked, nothing more is computed
        or copied."""
        self._rec = (bool(a1b1), bool(gtrees), bool(params))
        self._rec_loci = torch.as_tensor(np.asarray(loci, np.int64),
                                         device=self.device)

    def _sample_record(self, state: McmcState):
        """The records :meth:`record_samples` asks for, of one state."""
        a1b1, gtrees, params = self._rec
        out = {}
        if a1b1:
            out["a1"], out["b1"] = self.a1b1_stats(state)
            if self.cfg.migration:
                out["wa1"], out["wb1"] = self.mig_a1b1_stats(state)
        idx = self._rec_loci
        if (gtrees or params) and self.shard is not None:
            raise ValueError("per-locus records are not taken under locus "
                             "sharding")
        if gtrees:
            gt = state.gt
            out.update(gt_left=gt.left[idx], gt_right=gt.right[idx],
                       gt_parent=gt.parent[idx], gt_age=gt.age[idx])
        if params:
            out["heredity"] = state.subst.heredity[idx]
            out["mu"] = state.subst.mu[idx]
            if state.clock is not None and self.cfg.clock != Clock.GLOBAL:
                br = state.clock.brate
                out["nu"] = state.clock.nu[idx]
                out["brate"] = br[idx.clamp(max=br.shape[0] - 1)]
        return out

    def a1b1_stats(self, state: McmcState):
        """The conditional posterior of every population's theta given
        the gene trees (log_a1b1, method.c:4829), computed on the device:
        InvGamma(a + K_h, b + C_h) with K_h and C_h summed over the real
        loci (C_h / heredity), or under a Gamma(a, b) prior the
        moment-matched gamma of ``gibbs.gamma_conditional_approx``.
        Returns (a1 [H], b1 [H]); under migration the statistics come
        from the MSC-M sweep, and :meth:`mig_a1b1_stats` gives the rates'
        rows.  Port of ``bpp_tpu``'s ``Engine.a1b1_stats``."""
        cfg = self.cfg
        a, b = cfg.thetaprior.alpha, cfg.thetaprior.beta
        if cfg.migration:
            _, c, t2, _, _, _ = self._logpr_mig_fn(
                state.gt, state.sp, state.mig, state.subst.heredity)
        else:
            _, c, t2 = self._logpr_fn(state.gt, state.sp,
                                      state.subst.heredity)
        ksum, csum = moves._suff_stats(self.ctx, c, t2, state.subst.heredity)
        # linked thetas: each member gets its group's pooled statistics
        ksum, csum = moves._pool_linked(self.ctx, ksum, csum)
        if cfg.thetaprior.dist == PriorDist.GAMMA:
            return gamma_conditional_approx(a, b, ksum, csum,
                                            invgamma_proposal=False)
        return a + ksum, b + csum

    def mig_a1b1_stats(self, state: McmcState):
        """The conditional posterior of every route's migration rate
        given the gene trees and events, M_k | G ~ Gamma(alpha + mc_k,
        beta + W_k) with mc_k and W_k summed over the real loci (the W:
        rows of the a1b1 log): (wa1 [K], wb1 [K])."""
        _, _, _, W, mc, _ = self._logpr_mig_fn(
            state.gt, state.sp, state.mig, state.subst.heredity)
        wsum, mcsum = mig_moves._route_sums(self.ctx, W, mc)
        r = self.mig_routes
        return r.alpha + mcsum, r.beta + wsum

    def validate_state(self, state: McmcState, it=None):
        """``check = N [tol]``: recompute every cached per-locus quantity
        (logl, logpr and, with integrated-out thetas, the coal/T2h caches)
        from scratch and raise on drift beyond ``tol`` (default 0.5 in
        float32, 1e-6 in float64): the reference's CHECK_LOGL/CHECK_LOGPR
        (method.c:4699), and the cached trait log-likelihoods.  Port of
        ``bpp_tpu``'s ``Engine.validate_state``; the comparison reads the
        device once (every rank's loci, gathered, under sharding, so that
        the ranks agree on the verdict)."""
        cfg = self.cfg
        tol = cfg.check_tol or (
            1e-6 if self.dtype == torch.float64 else 0.5)
        where = f" at iteration {it}" if it is not None else ""
        logl2 = self._logl_fn(state.gt, state.subst, state.sp, state.clock,
                              mig=state.mig)
        if cfg.migration:
            lp2 = self._logpr_mig_fn(state.gt, state.sp, state.mig,
                                     state.subst.heredity)[0]
            pairs = [("logl", state.logl, logl2),
                     ("logpr (MSC-M density)", state.logpr, lp2)]
        else:
            lp2, c2, t22 = self._logpr_fn(state.gt, state.sp,
                                          state.subst.heredity)
            pairs = [("logl", state.logl, logl2),
                     ("logpr (MSC density)", state.logpr, lp2)]
        if cfg.theta_integrated:
            pairs += [("coal counts (notheta K cache)", state.coal, c2),
                      ("T2h sums (notheta C cache)", state.t2h, t22)]
        if state.trait is not None:
            # the partitions as row 0 (a real locus) of an [L, n_part]
            # block, in the layout of the others
            fresh = moves._trait_eval(self.ctx, state.sp, state.sp.tau,
                                      state.trait.brate)

            def row0(x):
                return torch.cat([x[None], x.new_zeros(
                    (state.logl.shape[0] - 1, x.shape[0]))])

            pairs.append(("trait logl", row0(state.trait.logl), row0(fresh)))
        L = state.logl.shape[0]
        flat = [x.reshape(L, -1).to(torch.float64)
                for _, c, f in pairs for x in (c, f)]
        host = gather_loci(self.shard, torch.cat(flat, dim=1)).cpu().numpy()
        mask = np.asarray(self.run.batch.locus_mask, bool)
        off = 0
        for (what, _, _), c in zip(pairs, flat[::2]):
            k = c.shape[1]
            cached, fresh = host[:, off:off + k], host[:, off + k:off + 2 * k]
            off += 2 * k
            d = np.abs(np.where(mask[:, None], cached - fresh, 0.0))
            finite = np.isfinite(np.where(mask[:, None], cached, 0.0)).all()
            if finite and not (d > tol).any():
                continue
            worst = int(np.argmax(d.max(axis=1)))
            raise RuntimeError(
                f"check{where}: cached {what} drifted from full "
                f"recompute (max |delta| = {d.max():.6g} > tol {tol:g}, "
                f"worst locus {worst}: cached {cached[worst][:4]} fresh "
                f"{fresh[worst][:4]})")
        return True

    def step_graph(self, states, gens=None, batched=False) -> StepGraph:
        """The captured step of the chains ``states``, chain c drawing
        from ``gens[c]`` (default: one chain on the engine's generator),
        made once and kept, with ``states`` loaded (its own views stay).
        ``batched``: ``states`` is ``[the K chains stacked]`` and the step
        :meth:`_step_batched`."""
        gens = [self.gen] if gens is None else list(gens)
        # the graph holds its generators, so these ids stay theirs
        key = (batched,) + tuple(id(g) for g in gens)
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = StepGraph(self, states, gens,
                                                  batched)
        else:
            graph.load(states)
        return graph

    def _chunk(self, state: McmcState, n: int, it=None):
        """n iterations after iteration ``it``; returns (state, stats,
        trace, samples): the trace leaves stacked [n, ...] on the device,
        and, with ``it`` given, the records :meth:`record_samples` asks
        for, stacked [one a sample generation in (it, it + n], ...].  On
        the graph route the state returned is the captured step's static
        state (:meth:`StepGraph.state`), which the next chunk overwrites."""
        K = max(1, self.cfg.sampfreq)
        want = it is not None and any(self._rec)
        recs = []
        if self.route == ROUTE_GRAPH:
            graph = self.step_graph([state])
            state = graph.state()

            def record(i):
                if want and it + i + 1 > 0 and (it + i + 1) % K == 0:
                    recs.append(self._sample_record(state))
            accs, traces = graph.run(n, record)
            acc, trace = accs[0], traces[0]
        else:
            acc = torch.zeros((N_MOVES, 2), dtype=torch.int64,
                              device=self.device)
            rows = []
            for i in range(n):
                state, stats = self._step(state)
                acc += stats
                rows.append(self._trace_of(state))
                if want and it + i + 1 > 0 and (it + i + 1) % K == 0:
                    recs.append(self._sample_record(state))
            trace = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
        if self.shard is not None:
            keys = [k for k in _LOCUS_SUMS if k in trace]
            trace.update(zip(keys, psum(self.shard,
                                        *[trace[k] for k in keys])))
        samples = ({k: torch.stack([r[k] for r in recs]) for k in recs[0]}
                   if recs else {})
        return state, acc, _nu_column(trace), samples

    def chunk_step(self, state: McmcState, n: int, it=None):
        """n iterations; with ``it`` (the iteration before the chunk) the
        sample records :meth:`record_samples` asks for are taken as a run
        takes them.  The state returned is the caller's own on either
        route (on the graph route a copy of the static state)."""
        state, stats, _, _ = self._chunk(state, n, it)
        if self.route == ROUTE_GRAPH:
            state = clone_state(state)
        return state, stats

    # --- full run -------------------------------------------------------------

    def run_mcmc(self, progress_every: int = 1000, log_fp=None,
                 on_sample=None, resume=None, on_checkpoint=None,
                 mesh=None) -> SampleLog:
        """Run the chain.  ``on_sample(gen, row)`` receives each sample as
        a dict of host values (theta, tau, lnl, logpr and what
        :meth:`_trace_of` adds for the run's columns) when its chunk
        ends; chunks end at the finetune marks, at it = 0, at the
        checkpoint generations and at most every 500 iterations, each
        with one device-to-host copy.

        A sample's row also holds the records :meth:`record_samples`
        asks for.  With ``check = N`` every Nth iteration from the start
        of burn-in is a chunk bound where :meth:`validate_state` runs.

        ``resume = (state, rng_state, it, stats_acc)`` continues from a
        checkpoint: the state as :meth:`init_state`'s template restored
        it (so init_state has run), the generator's bytes, the iteration
        and the move statistics.  ``on_checkpoint(state, gen, it,
        stats_acc)`` fires at the generations ``checkpoint = initial
        [step]`` schedules (method.c:6183-6188; generation 1 is the first
        iteration after burn-in); each is a chunk bound, so a resumed
        chain lands on them and draws exactly what the uninterrupted one
        draws.

        ``mesh``: a ``parallel.mesh.Shard``; the engine keeps its block of
        the loci (:meth:`set_shard`) before the initial state is drawn,
        and every rank runs this loop in step.  ``on_sample`` then gets
        rows whose sums over loci cover every rank."""
        cfg = self.cfg
        if mesh is not None and self.shard is None:
            self.set_shard(mesh)
        if resume is None:
            state = self.init_state()
            self.gen.manual_seed(int(self.seed))
            it = -cfg.burnin
            stats_acc = np.zeros((N_MOVES, 2), np.float64)
        else:
            state, rng_state, it, stats_acc = resume
            self.gen.set_state(rng_state)
            stats_acc = np.array(stats_acc, np.float64)
        log = SampleLog()
        t0 = time.time()
        last_print = [0]

        def progress(it, lnl):
            if not progress_every:
                return
            if it - last_print[0] < progress_every and it != 0:
                return
            last_print[0] = it
            with np.errstate(invalid="ignore", divide="ignore"):
                pj = stats_acc[:, 1] / np.maximum(stats_acc[:, 0], 1)
            print(f"  it {it:>8d}  lnL {float(lnl):.4f}"
                  f"  pjump " + " ".join(f"{x:.2f}" for x in pj[:5])
                  + f"  [{time.time()-t0:.1f}s]", file=log_fp or sys.stderr)

        K = max(1, cfg.sampfreq)
        total_burn = cfg.burnin
        total_main = cfg.nsample * cfg.sampfreq
        auto_ft = cfg.finetune.auto and total_burn >= 8
        quarter = max(1, total_burn // 4)
        marks = sorted({-total_burn + q * quarter for q in (1, 2, 3)}
                       | {0}) if auto_ft else [0]
        next_ck = 1 << 60
        if cfg.checkpoint and on_checkpoint is not None:
            ck_initial, ck_step = cfg.checkpoint
            next_ck = (ck_initial if it < ck_initial else
                       it + ck_step if ck_step > 0 else 1 << 60)
        # the runtime check (check = N): every Nth iteration, counted from
        # the start of burn-in
        chk_n = cfg.check_every
        next_chk = it + chk_n if chk_n > 0 else 1 << 60

        while it < total_main:
            bounds = [m for m in marks if m > it] + [total_main, next_ck,
                                                     next_chk]
            n = max(1, min(500, min(bounds) - it))
            state, stats, trace, samples = self._chunk(state, n, it)
            stats_acc += stats.cpu().numpy()
            prev = it
            it += n
            progress(it, trace["lnl"][-1])
            if auto_ft and it in marks and it <= 0:
                state = self._reset_finetune(state, stats_acc)
                stats_acc[:] = 0.0
            first = K * (max(prev, 0) // K + 1)
            if first <= it:
                htr = {k: v.cpu().numpy() for k, v in trace.items()}
                hrec = {k: v.cpu().numpy() for k, v in samples.items()}
                for j, g in enumerate(range(first, it + 1, K)):
                    row = {k: v[g - prev - 1] for k, v in htr.items()}
                    row.update((k, v[j]) for k, v in hrec.items())
                    log.add(g, row)
                    if on_sample is not None:
                        on_sample(g, row)
            if it >= next_chk:
                self.validate_state(state, it=it)
                if self.shard is None or self.shard.rank == 0:
                    print(f"  check at it {it:>8d}: caches consistent",
                          file=log_fp or sys.stderr)
                next_chk = it + chk_n
            if it >= next_ck:
                on_checkpoint(state, self.gen, it, stats_acc)
                ck_step = cfg.checkpoint[1]
                next_ck = it + ck_step if ck_step > 0 else 1 << 60
        return log

    # --- replicate chains (chains = K) ---------------------------------------

    def chain_seed(self, k: int) -> int:
        """Chain k's seed (0-based): ``bpp_tpu``'s ``seed + 1000003 k``."""
        return int(self.seed) + 1000003 * k

    def init_states(self, n_chains: int) -> list:
        """The K chains' initial states, chain k's as :meth:`init_state`
        makes it at :meth:`chain_seed`, so that each equals ``bpp_tpu``'s
        (``Engine.init_states``, which stacks them on a leading axis)."""
        base = self.seed
        states = []
        try:
            for k in range(n_chains):
                self.seed = self.chain_seed(k)
                states.append(self.init_state())
        finally:
            self.seed = base
        return states

    def run_mcmc_multi(self, n_chains: int, progress_every: int = 1000,
                       log_fp=None, resume=None, on_checkpoint=None,
                       gens=None):
        """Run K replicate chains; returns their K :class:`SampleLog`.

        ``bpp_tpu`` vmaps the chunk over the chains.  Here chain k draws
        from its own ``torch.Generator`` seeded at :meth:`chain_seed`.  On
        the batched route (:func:`chain_route`) the K states are stacked
        and a chunk is n batched steps (:meth:`_step_batched`, as n
        replays of one captured graph on the graph route, else
        :meth:`_chunk_multi`); on the per-chain route the chains take each
        chunk in turn (on the graph route as n replays of their captured
        steps, :meth:`step_graph`).  Either way chain k draws what its
        one-chain step draws.  Each chain tunes its finetune steps at the
        single-chain marks from its own move statistics (written into its
        row of the stacked state).  The records of :meth:`record_samples`
        and ``check = N`` are single-chain features.

        ``resume = (states, rng_states, it, stats_acc, logs)`` continues
        from a checkpoint (the K states as :meth:`init_states`' templates
        restored them, the K generators' bytes, the iteration, the
        per-chain move statistics [K, N_MOVES, 2] and the samples so
        far); ``on_checkpoint(states, gens, it, stats_acc, logs)`` fires at
        the generations ``checkpoint = initial [step]`` schedules, each a
        chunk bound, so a resumed run draws what the uninterrupted one
        draws.  Under ``--multihost`` each process runs every chain on all
        the loci (an unsharded engine).  ``gens``: the K generators to
        draw from (seeded here as new ones are), so that a run may take
        a step graph already captured with them (:meth:`step_graph`)."""
        cfg = self.cfg
        if self.shard is not None:
            raise ValueError("replicate chains run on unsharded engines")
        if gens is None:
            gens = [torch.Generator(device=self.device)
                    for _ in range(n_chains)]
        if resume is None:
            states = self.init_states(n_chains)
            for k, g in enumerate(gens):
                g.manual_seed(self.chain_seed(k))
            it = -cfg.burnin
            stats_acc = np.zeros((n_chains, N_MOVES, 2), np.float64)
            logs = [SampleLog() for _ in range(n_chains)]
        else:
            states, rng_states, it, stats_acc, logs = resume
            states = list(states)
            for g, r in zip(gens, rng_states):
                g.set_state(r)
            stats_acc = np.array(stats_acc, np.float64)
        next_ck = 1 << 60
        if cfg.checkpoint and on_checkpoint is not None:
            ck_initial, ck_step = cfg.checkpoint
            next_ck = (ck_initial if it < ck_initial else
                       it + ck_step if ck_step > 0 else 1 << 60)
        total_burn = cfg.burnin
        total_main = cfg.nsample * cfg.sampfreq
        auto_ft = cfg.finetune.auto and total_burn >= 8
        quarter = max(1, total_burn // 4)
        marks = sorted({-total_burn + q * quarter for q in (1, 2, 3)}
                       | {0}) if auto_ft else [0]
        K = max(1, cfg.sampfreq)
        t0 = time.time()
        last_print = 0
        own_gen = self.gen
        graph = stacked = None
        batched = self.chains_route == ROUTE_BATCHED
        if batched:
            stacked = stack_states(states)
            if self.route == ROUTE_GRAPH:
                graph = self.step_graph([stacked], gens, batched=True)
                states = graph.chain_states()
            else:
                states = chain_views(stacked, n_chains)
        elif self.route == ROUTE_GRAPH:
            graph = self.step_graph(states, gens)
            states = list(graph.states())
        try:
            while it < total_main:
                bounds = ([m for m in marks if m > it]
                          + ([next_ck] if it < next_ck <= total_main else [])
                          + [total_main])
                n = max(1, min(500, min(bounds) - it))
                if graph is not None:
                    accs, traces = graph.run(n)
                    traces = [_nu_column(tr) for tr in traces]
                    stats_acc += accs.cpu().numpy()
                elif batched:
                    stacked, accs, traces = self._chunk_multi(stacked, gens,
                                                              n)
                    states = chain_views(stacked, n_chains)
                    traces = [_nu_column(tr) for tr in traces]
                    stats_acc += accs.cpu().numpy()
                else:
                    traces = []
                    for c in range(n_chains):
                        self.gen = gens[c]
                        states[c], stats, trace, _ = self._chunk(states[c],
                                                                 n)
                        stats_acc[c] += stats.cpu().numpy()
                        traces.append(trace)
                prev = it
                it += n
                if progress_every and (it - last_print >= progress_every
                                       or it == 0):
                    last_print = it
                    print(f"  it {it:>8d} x{n_chains} chains  lnL "
                          f"{float(traces[0]['lnl'][-1]):.4f}  "
                          f"[{time.time() - t0:.1f}s]",
                          file=log_fp or sys.stderr)
                if auto_ft and it in marks and it <= 0:
                    states = [self._reset_finetune(st, acc)
                              for st, acc in zip(states, stats_acc)]
                    stats_acc[:] = 0.0
                first = K * (max(prev, 0) // K + 1)
                if first <= it:
                    for log, trace in zip(logs, traces):
                        htr = {k: v.cpu().numpy() for k, v in trace.items()}
                        for g in range(first, it + 1, K):
                            log.add(g, {k: v[g - prev - 1]
                                        for k, v in htr.items()})
                if it >= next_ck:
                    on_checkpoint(states, gens, it, stats_acc, logs)
                    ck_step = cfg.checkpoint[1]
                    next_ck = it + ck_step if ck_step > 0 else 1 << 60
        finally:
            self.gen = own_gen
        return logs

    def _reset_finetune(self, state: McmcState, stats_acc) -> McmcState:
        """The finetune steps tuned from ``stats_acc``, written through
        into ``state.finetune`` (the captured step's buffer on the graph
        route); returns ``state``."""
        ft = state.finetune.cpu().numpy().copy()
        for mv, fti in MOVE_TO_FT.items():
            prop, acc = stats_acc[mv]
            # too few proposals make the pjump estimate useless
            if prop >= 30:
                ft[fti] = reset_finetune_onestep(acc / prop, ft[fti])
        state.finetune.copy_(torch.as_tensor(ft, dtype=self.dtype))
        return state


def _nu_column(trace):
    """The nu column of mcmc.txt from the trace's sums over loci."""
    if "nu_sum" in trace:
        trace["nu_col"] = trace.pop("nu_sum") / trace.pop("nu_n")
    return trace


def clone_state(state):
    """A copy of every tensor of a state (a NamedTuple tree)."""
    if state is None or torch.is_tensor(state):
        return None if state is None else state.clone()
    return type(state)(*(clone_state(v) for v in state))
