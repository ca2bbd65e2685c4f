"""Runs and parameters made from a seed, for tests and smoke runs.

``synthetic_run`` is a copy of ``bpp_tpu/testing.py``'s (numpy; the same
seed gives the same data) that also takes per-locus sequence counts.
``write_simulated_run`` simulates a dataset (4 species by default,
haploid, or with unphased diploid species; on the MSC-I network
``NET_SIM_TREE`` with ``NET_GUIDE``; with the migration routes of
``MIG_SIM`` and the run routes ``MIG_RUN``) with the port's simulator and
writes a run control file for it; ``state_arrays`` and ``port_state``
hand a sampler state (``bpp_tpu``'s too) to the port;
``write_partition_file`` writes the partition file of ``model =
custom``; ``synthetic_walks`` makes the inputs of MSC-M's sim-SPR walk;
``generate_aa_benchmark`` (a copy of ``bpp_tpu/testing.py``'s)
writes the WAG amino-acid dataset of ``bench.py``; ``fixed_subst`` builds
a substitution state per DNA model family with fixed parameters;
``ess`` is a chain's effective sample size, for prior-recovery bands.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .config import BppConfig, Prior, PriorDist, SpeciesTreeSpec, SubstModel
from .data.msa import ProcessedLocus
from .data.packing import pack_loci
from .loader import RunData
from .trees.stree import SpeciesTree

SIM_CTL = """\
seed = {seed}
seqfile = sim.phy
treefile = sim.tre
Imapfile = sim.Imap.txt
modelparafile = sim.para.txt
species&tree = {n_sp} {names}
                 {seqs}
                {sim_tree};
loci&length = {nloci} {nsites}
{extra}"""

RUN_CTL = """\
seed = 11
seqfile = {dir}/sim.phy
Imapfile = {dir}/sim.Imap.txt
jobname = {dir}/{job}
species&tree = {n_sp} {names}
                 {seqs}
                {guide};
usedata = {usedata}
nloci = {nloci}
cleandata = 0
thetaprior = {thetaprior}
tauprior = {tauprior}
finetune = 1
burnin = {burnin}
sampfreq = 1
nsample = {nsample}
{extra}"""


def synthetic_species_tree(n_species: int, rng: np.random.Generator,
                           tau_root: float = 0.004, theta: float = 0.002
                           ) -> SpeciesTree:
    names = [f"S{i}" for i in range(n_species)]
    if n_species == 1:
        st = SpeciesTree.single_population(names[0])
        st.theta[:] = theta
        return st
    nodes = list(range(n_species))
    ns = n_species
    nst = 2 * ns - 1
    left = np.full(nst, -1, np.int32)
    right = np.full(nst, -1, np.int32)
    parent = np.full(nst, -1, np.int32)
    nxt = ns
    while len(nodes) > 1:
        i, j = rng.choice(len(nodes), 2, replace=False)
        a, b = nodes[i], nodes[j]
        left[nxt], right[nxt] = a, b
        parent[a] = parent[b] = nxt
        nodes = [x for x in nodes if x not in (a, b)] + [nxt]
        nxt += 1
    st = SpeciesTree(names=names, left=left, right=right, parent=parent,
                     tau=np.zeros(nst), theta=np.full(nst, theta))

    def rec(i, t):
        st.tau[i] = t
        for ch in (st.left[i], st.right[i]):
            if ch >= ns:
                rec(ch, t * (0.5 + 0.3 * rng.random()))
    rec(st.root, tau_root)
    return st


def synthetic_run(n_loci: int = 8, n_seq=6, n_patterns=16,
                  n_species: int = 4, seed: int = 0,
                  pad_loci_to: int | None = None, locus_models=None,
                  **cfg_kw) -> RunData:
    """Random (non-simulated) data; ``n_seq`` and ``n_patterns`` may be
    per-locus lists to build heterogeneous batches; ``locus_models`` are
    the per-locus models of ``model = custom``."""
    rng = np.random.default_rng(seed)
    st = synthetic_species_tree(n_species, rng)
    pat_of = list(n_patterns) if isinstance(n_patterns, (list, tuple)) \
        else [n_patterns] * n_loci
    seq_of = list(n_seq) if isinstance(n_seq, (list, tuple)) \
        else [n_seq] * n_loci
    loci = []
    for li in range(n_loci):
        ns = seq_of[li]
        codes = rng.choice(
            np.array([1, 2, 4, 8, 15], np.uint8),
            size=(ns, pat_of[li]),
            p=[0.24, 0.24, 0.24, 0.24, 0.04])
        weights = rng.integers(1, 30, size=pat_of[li]).astype(np.int32)
        tip_species = rng.integers(0, n_species, size=ns).astype(np.int32)
        tip_species[0] = 0
        loci.append(ProcessedLocus(
            index=li, labels=[f"t{li}_{i}" for i in range(ns)],
            codes=codes, weights=weights, tip_species=tip_species,
            n_sites=int(weights.sum())))
    batch = pack_loci(loci, site_block=8, pad_loci_to=pad_loci_to)
    cfg = BppConfig(
        species=SpeciesTreeSpec(
            count=n_species, names=tuple(st.names),
            max_seqs=tuple([max(seq_of)] * n_species), newick=None),
        nloci=n_loci,
        thetaprior=Prior(PriorDist.GAMMA, 2.0, 1000.0),
        tauprior=Prior(PriorDist.GAMMA, 2.0, 500.0),
        burnin=2, nsample=2, sampfreq=1,
        **cfg_kw,
    )
    return RunData(cfg=cfg, batch=batch, stree=st, loci=loci,
                   locus_models=locus_models)


def _lines(*items) -> str:
    return "".join(f"{line}\n" for line in items if line)


SIM_TREE4 = ("((A #0.01, B #0.01) :0.01 #0.01, (C #0.01, D #0.01) :0.012 "
             "#0.01) :0.02 #0.01")


# an MSC-I network on four species: B introgresses into the T lineage
# (H, phi 0.3), with every population's theta 0.01; the simulator's tree
# and the run's species tree (``write_simulated_run(..., sim_tree=
# NET_SIM_TREE, guide=NET_GUIDE, priors=("phiprior = 1 1", ...))``)
NET_SIM_TREE = (
    "(((A #0.01, (B #0.01)H[&phi=0.3,&tau-parent=yes] :0.005 #0.01) S "
    ":0.01 #0.01, (H[&tau-parent=yes], C #0.01) T :0.008 #0.01) U :0.015 "
    "#0.01, D #0.01) R :0.02 #0.01")
NET_GUIDE = ("(((A,(B)H[&phi=0.3,&tau-parent=yes])S,"
             "(H[&tau-parent=yes],C)T)U,D)R")


# MSC-M: two migration routes between the sister species A and B on
# ((A,B),(C,D)), in both directions, for the simulator (rate M = 0.5) and
# for a run (``write_simulated_run(..., sim_model="model = 0\n" +
# MIG_SIM, priors=(MIG_RUN,))``; the rates take the wprior, 2 1 unless
# the run sets ``wprior``)
MIG_SIM = "migration = 2\nA B 0.5\nB A 0.5\n"
MIG_RUN = "migration = 2\nA B\nB A\n"


def write_simulated_run(directory, n_loci: int, seqs=(2, 2, 2, 2),
                        n_sites: int = 200, seed: int = 137,
                        job: str = "out", usedata: int = 1,
                        thetaprior: str = "3 0.03",
                        tauprior: str = "3 0.06", burnin: int = 10,
                        nsample: int = 10, diploid=None,
                        sim_model: str = "model = 0", model: str = "JC69",
                        priors=(), names: str = "ABCD",
                        sim_tree: str = SIM_TREE4,
                        guide: str = "((A, B), (C, D))") -> str:
    """Simulate a dataset on ``sim_tree`` (by default ((A,B),(C,D))) into
    ``directory`` and write ``<job>.ctl`` for it, with the species tree
    ``guide``; returns the control file's path.

    ``seqs`` counts individuals per species; ``diploid`` (one 0/1 per
    species) makes a species' individuals unphased diploids, and becomes
    the run's ``phase`` line.  ``sim_model`` holds the simulator's model
    lines (``model``, ``kappa``, ``basefreqs``, ``locusrate``, a
    ``migration`` block such as ``MIG_SIM`` ...);
    ``model`` and ``priors`` (``alphaprior``, ``locusrate``, ``heredity``
    ... lines) go into the run control file."""
    from .sim.simulate import run_simulation

    directory = os.path.abspath(str(directory))
    seq_line = " ".join(str(s) for s in seqs)
    flags = " ".join(str(int(d)) for d in diploid) if diploid else ""
    cwd = os.getcwd()
    os.chdir(directory)
    try:
        with open("sim.ctl", "w") as f:
            f.write(SIM_CTL.format(
                seed=seed, seqs=seq_line, nloci=n_loci, nsites=n_sites,
                n_sp=len(names), names=" ".join(names), sim_tree=sim_tree,
                extra=_lines(sim_model, flags and f"diploid = {flags}")))
        run_simulation("sim.ctl")
    finally:
        os.chdir(cwd)
    path = os.path.join(directory, f"{job}.ctl")
    with open(path, "w") as f:
        f.write(RUN_CTL.format(
            dir=directory, job=job, seqs=seq_line, usedata=usedata,
            n_sp=len(names), names=" ".join(names), guide=guide,
            nloci=n_loci, thetaprior=thetaprior, tauprior=tauprior,
            burnin=burnin, nsample=nsample,
            extra=_lines(f"model = {model}", flags and f"phase = {flags}",
                         *priors)))
    return path


def write_trait_file(path, names="ABCD", n_cont: int = 20,
                     n_disc: int = 50, seed: int = 137) -> str:
    """A traitfile (morph.c's format) for the species ``names``: one
    continuous partition of ``n_cont`` standardized characters (v_pop 0.5,
    ldetRs 0) and one discrete partition of ``n_disc`` characters of 2-4
    states, each variable, with some missing (``?``) values; made with
    numpy from ``seed``.  Returns ``path``."""
    rng = np.random.default_rng(seed)
    ns = len(names)
    lines = [f"{ns} {n_cont} C 0.5 0.0"]
    cont = rng.standard_normal((ns, n_cont))
    lines += [f"{nm} " + " ".join(f"{v:.6f}" for v in row)
              for nm, row in zip(names, cont)]
    disc = np.zeros((ns, n_disc), np.int64)
    for j in range(n_disc):
        k = int(rng.integers(2, 5))
        col = rng.integers(0, k, ns)
        col[:2] = rng.permutation(k)[:2]     # two states: variable
        disc[:, j] = col
    miss = rng.random((ns, n_disc)) < 0.1
    miss[:2] = False                         # keep the column variable
    lines += ["", f"{ns} {n_disc} D"]
    lines += [f"{nm} " + " ".join("?" if m else str(v)
                                  for v, m in zip(row, mrow))
              for nm, row, mrow in zip(names, disc, miss)]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return str(path)


def generate_aa_benchmark(nloci: int, nsites: int, out_dir: str,
                          seed: int = 137) -> float:
    """Deterministic WAG amino-acid benchmark dataset (PHYLIP + Imap).

    4 species x 4 sequences, MSC gene trees on the same ((A,B),(C,D))
    tree/taus as the DNA bench; evolution via the WAG eigensystem
    (P(t) = V e^{wt} V^-1).  Used by bench.py's AA head-to-head against
    the reference's 20x20 AVX kernels (core_partials_avx.c
    pll_core_update_partial_ti_20x20_avx, bpp.h:2827).  Returns the
    generation wall time.  A copy of ``bpp_tpu/testing.py``'s (numpy; the
    same seed writes the same files)."""
    import time as _time

    from .core.aa_matrices import AA_MODELS

    t0 = _time.time()

    rng = np.random.default_rng(seed)
    AAS = "ARNDCQEGHILKMFPSTWYV"
    rates, freqs = AA_MODELS["WAG"]
    Q = np.zeros((20, 20))
    iu = np.triu_indices(20, 1)
    Q[iu] = rates[iu] if rates.ndim == 2 else rates
    Q = Q + Q.T
    Q = Q * freqs[None, :]
    np.fill_diagonal(Q, -Q.sum(1))
    Q /= -(freqs * np.diag(Q)).sum()
    # reversible: symmetrize with sqrt(pi), eigendecompose once
    sp = np.sqrt(freqs)
    S = Q * sp[:, None] / sp[None, :]
    w, U = np.linalg.eigh((S + S.T) / 2)
    V = U / sp[:, None]          # Q = V diag(w) Vinv
    Vinv = U.T * sp[None, :]

    TAUS_AB, TAUS_CD, TAU_R, THETA = 0.01, 0.012, 0.02, 0.01

    def sim_gtree():
        nodes = {}
        ages = {i: 0.0 for i in range(16)}
        def coalesce(lin, t0_, t1):
            t = t0_
            while len(lin) > 1:
                t = t + rng.exponential(THETA / (len(lin) * (len(lin) - 1)))
                if t >= t1:
                    return lin, t1
                i, j = sorted(rng.choice(len(lin), 2, replace=False))
                a, b = lin[i], lin[j]
                n = 16 + len(nodes)
                nodes[n] = (t, a, b)
                ages[n] = t
                lin = [x for x in lin if x not in (a, b)] + [n]
            return lin, t1
        act = {s: list(range(4 * i, 4 * i + 4))
               for i, s in enumerate("ABCD")}
        for s in "ABCD":
            act[s], _ = coalesce(act[s],
                                 0.0, TAUS_AB if s in "AB" else TAUS_CD)
        ab, _ = coalesce(act["A"] + act["B"], TAUS_AB, TAU_R)
        cd, _ = coalesce(act["C"] + act["D"], TAUS_CD, TAU_R)
        root_lin, _ = coalesce(ab + cd, TAU_R, np.inf)
        return nodes, ages, root_lin[0]

    import os
    os.makedirs(out_dir, exist_ok=True)
    labels = [f"{s}{k}^{s}{k}" for s in "ABCD" for k in range(1, 5)]
    cumfreq = freqs.cumsum()
    with open(f"{out_dir}/aa.phy", "w") as f:
        for li in range(nloci):
            nodes, ages, root = sim_gtree()
            seqs = {}
            stack = [(root, (rng.random(nsites)[:, None]
                             > cumfreq[None, :]).sum(1))]
            while stack:
                node, seq = stack.pop()
                if node < 16:
                    seqs[node] = seq
                    continue
                age, l, r = nodes[node]
                for ch in (l, r):
                    t = max(age - ages.get(ch, 0.0), 1e-9)
                    P = (V * np.exp(w * t)[None, :]) @ Vinv
                    P = np.maximum(P, 0.0)
                    P /= P.sum(1, keepdims=True)
                    cum = P.cumsum(1)
                    u = rng.random(nsites)
                    stack.append((ch, (u[:, None] > cum[seq]).sum(1)))
            f.write(f"16 {nsites}\n")
            for i, lab in enumerate(labels):
                f.write(f"{lab}  {''.join(AAS[x] for x in seqs[i])}\n")
            f.write("\n")
    with open(f"{out_dir}/Imap.txt", "w") as f:
        for s in "ABCD":
            for k in range(1, 5):
                f.write(f"{s}{k} {s}\n")
    return _time.time() - t0


def write_partition_file(path, models, n_loci: int) -> str:
    """Write a partition file for ``model = custom`` (``io.partition``'s
    grammar): ``models`` (names, DNA or amino acids) take the loci in
    equal consecutive blocks, the last block to ``n_loci``.  Returns the
    path."""
    from .io.partition import _AA_MODELS
    k = len(models)
    with open(path, "w") as fh:
        for j, name in enumerate(models):
            lo = 1 + j * n_loci // k
            hi = (j + 1) * n_loci // k
            kind = "AA" if name.upper() in _AA_MODELS else "DNA"
            fh.write(f"{lo} - {hi}, {kind}, {name}\n")
    return str(path)


def fixed_subst(model_name: str, n_cats: int, L: int, dtype, device="cpu"):
    """(SubstModel, SubstState) with fixed parameters: freqs 0.3/0.2/0.2/
    0.3, kappa 2.5 (HKY) or 3/6 (TN93), GTR exchangeabilities
    6:4:2:3:5:8, Gamma shape 0.5 over ``n_cats`` categories; computed in
    float64 and cast to ``dtype``."""
    from .core.gammarates import discrete_gamma_rates
    from .mcmc.state import SubstState, refresh_eigen

    model = SubstModel[model_name]
    f64 = torch.float64

    def full(shape, v):
        return torch.full(shape, v, dtype=f64, device=device)

    freqs = torch.tensor([0.3, 0.2, 0.2, 0.3], dtype=f64, device=device)
    qrates = torch.tensor([6.0, 4.0, 2.0, 3.0, 5.0, 8.0], dtype=f64,
                          device=device)
    k1, k2 = {"HKY": (2.5, 2.5), "TN93": (3.0, 6.0)}.get(model_name,
                                                         (1.0, 1.0))
    subst = SubstState(
        freqs=freqs.expand(L, 4).contiguous(),
        kappa1=full((L,), k1), kappa2=full((L,), k2),
        qrates=(qrates / qrates.sum()).expand(L, 6).contiguous(),
        alpha=full((L,), 0.5),
        rates=discrete_gamma_rates(full((L,), 0.5), n_cats),
        mu=full((L,), 1.0), heredity=full((L,), 1.0),
        eigw=full((L, 4), 0.0), eigT=full((L, 4, 4), 0.0),
        eigTi=full((L, 4, 4), 0.0))
    subst = refresh_eigen(subst, model)
    return model, type(subst)(*(x.to(dtype).contiguous() for x in subst))


def shaped_batch(n_tips: int = 16, n_cols: int = 200, seed: int = 0,
                 dtype=torch.float32, device="cpu"):
    """A batch of fixed gene trees that simulated data lacks: for every
    sequence count 1..``n_tips`` one caterpillar and one balanced tree in
    a capacity of ``n_tips`` tips, with pattern counts that run through 0,
    1, 31, 32, 33, 130 and ``n_cols``.

    Returns ``(gt, n_seq [L], n_pat [L], tips [L, T, S, 4], weights
    [L, S])``; columns past ``n_pat`` are all-ambiguous with weight 0."""
    from .trees.gtree import BIG_AGE, GTrees

    rng = np.random.default_rng(seed)
    T, N, S = n_tips, 2 * n_tips - 1, n_cols
    L = 2 * T
    left = np.zeros((L, N), np.int64)
    right = np.zeros((L, N), np.int64)
    parent = np.full((L, N), -1, np.int64)
    age = np.zeros((L, N))
    age[:, T:] = BIG_AGE
    n_seq = np.repeat(np.arange(1, T + 1), 2)
    counts = [0, 1, 31, 32, 33, 130, S, 7]
    n_pat = np.asarray([counts[i % len(counts)] for i in range(L)])
    for l in range(L):
        roots = list(range(n_seq[l]))
        for k in range(n_seq[l] - 1):
            # even loci: join the newest node with the next tip; odd
            # loci: join the two oldest roots
            a, b = (roots[-1], roots[0]) if l % 2 == 0 and k else roots[:2]
            node = T + k
            left[l, node], right[l, node] = a, b
            parent[l, a] = parent[l, b] = node
            age[l, node] = 0.002 * (k + 1 + 0.5 * rng.random())
            roots = [r for r in roots if r not in (a, b)] + [node]
    codes = rng.choice(np.array([1, 2, 4, 8, 15]), size=(L, T, S),
                       p=[0.24, 0.24, 0.24, 0.24, 0.04])
    live = np.arange(S) < n_pat[:, None]
    codes = np.where(live[:, None, :], codes, 15)
    tips = ((codes[..., None] >> np.arange(4)) & 1).astype(np.float64)
    weights = np.where(live, rng.integers(1, 30, size=(L, S)), 0)

    def t(a, dt):
        return torch.as_tensor(a, dtype=dt, device=device)

    gt = GTrees(t(left, torch.int64), t(right, torch.int64),
                t(parent, torch.int64), t(age, dtype))
    return (gt, t(n_seq, torch.int64), t(n_pat, torch.int64),
            t(tips, dtype), t(weights, dtype))


# the kinds of locus :func:`synthetic_walks` makes
WALK_KINDS = ("walks", "invalid", "no live sub-edge", "fills ME")


# (E sub-edges, L loci, H populations, routes between every sister pair)
# of the walk tests: sub-edge counts about a warp's 32 lanes and past the
# 64 a locus K5 keeps in registers; the most populations whose float64
# tables fit K5's 48 KB of shared memory (at K = 4 routes); more routes
# (62) than a warp has lanes
WALK_SHAPES = tuple((E, L, 7, False) for E in (1, 31, 32, 33, 63, 97)
                    for L in (1, 33, 1000)) + ((63, 200, 207, False),
                                               (63, 200, 63, True))


def walk_seed(shape) -> int:
    """The seed of a walk test's shape (E, L, H, every_pair)."""
    E, L, H, every_pair = shape
    return 1000 * E + L + H + 7 * every_pair


def walk_id(shape) -> str:
    """A walk test's name for ``shape``."""
    E, L, H, every_pair = shape
    return f"E{E}-L{L}-H{H}" + ("-every-pair" if every_pair else "")


def synthetic_walks(L: int, E: int, H: int = 7, ME: int = 8, seed: int = 0,
                    dtype=torch.float64, device="cpu", every_pair=False,
                    locus_seed=None, scale: float = 1.0):
    """Random inputs of MSC-M's sim-SPR walk (kernel K5 and
    ``mig_moves.simspr_walk_ref``): L loci of E sub-edges each on a random
    species tree of H populations (H odd; the root is H - 1), routes both
    ways between the root's children and, where it is another pair,
    between the two tips of a cherry (``every_pair``: between the children
    of every inner node), and the walk's S = 2 E + 2 H + 2 K + 8 steps of
    uniforms (``spr_sim_move``'s S, E standing for N + ME).

    Every locus has one lineage that reaches the root (sub-edge 0, up to
    ``BIG_AGE``), so a walk ends; a sub-edge's population is written as a
    negative index (counting from the end) at random.  Each locus is of a
    kind (``WALK_KINDS``): "walks" (a lineage starting in a random
    population at a random time, 85% of the sub-edges live, moderate
    route rates), "invalid" (``is_valid`` False), "no live sub-edge" (no
    lineage to coalesce with; it starts where a route's source is alive,
    at a rate that fills the ME event slots and fails) and "fills ME"
    (the same start and rate with live sub-edges).  Where L >= 33, loci
    1, 2 and 3 are of the last three kinds, and above 100 loci each of
    them takes 5% more at random.  ``locus_seed``: the loci (and thetas)
    drawn from a generator of their own, the species tree and its routes
    from ``seed``; ``scale``: every time and theta multiplied by it and
    the route rates divided by it (the same walks in other units).

    Returns (the walk's arguments: the 19 tensors of
    ``simspr_walk_ref`` and ME, the kinds [L] as indices into
    ``WALK_KINDS``)."""
    from .trees.gtree import BIG_AGE
    from .trees.migration import _FINITE_BIG
    rng = np.random.default_rng(seed)
    tau_root = 0.02
    st = synthetic_species_tree((H + 1) // 2, rng, tau_root=tau_root)
    if len(st.tau) != H:
        raise ValueError(f"H = {H}: a species tree has an odd node count")
    par = st.parent.astype(np.int64)
    tau = st.tau.astype(np.float64)
    top = np.where(par >= 0, tau[np.maximum(par, 0)], 1.5 * tau_root)
    partau = np.where(par >= 0, top, _FINITE_BIG)
    anc = np.zeros((H, H), bool)
    for q in range(H):
        a = q
        while a >= 0:
            anc[q, a] = True
            a = par[a]
    pairs = []
    if H > 1:
        root = H - 1
        pairs.append((int(st.left[root]), int(st.right[root])))
        for v in range(H):
            kids = (int(st.left[v]), int(st.right[v]))
            if kids[0] < 0 or kids in pairs:
                continue
            if every_pair:
                pairs.append(kids)
            elif max(kids) < (H + 1) // 2:
                pairs.append(kids)
                break
    si = np.array([x for a, b in pairs for x in (a, b)], np.int64)
    ti = np.array([x for a, b in pairs for x in (b, a)], np.int64)
    K = len(si)
    S = 2 * E + 2 * H + 2 * K + 8
    if locus_seed is not None:
        rng = np.random.default_rng(locus_seed)

    kind = np.zeros(L, np.int64)
    if L >= 33:
        kind[1:4] = (1, 2, 3)
    if L > 100:
        pick = rng.random(L)
        for k in (1, 2, 3):
            kind[(pick >= 0.05 * (k - 1)) & (pick < 0.05 * k)] = k
    q = rng.integers(0, H, (L, E))
    lo = tau[q] + rng.random((L, E)) * (top[q] - tau[q])
    hi = lo + rng.exponential(0.3 * tau_root, (L, E))
    hi[:, 0] = BIG_AGE
    live = rng.random((L, E)) < 0.85
    live[:, 0] = True
    live[kind == 2] = False
    pop_lo = np.where(rng.random((L, E)) < 0.5, q - H, q)
    p0 = rng.integers(0, H, L)
    t0 = tau[p0] + rng.random(L) * (top[p0] - tau[p0])
    route_M = rng.uniform(0.0, 500.0, (L, K))
    heredity = rng.uniform(0.5, 2.0, L)
    trap = (kind == 2) | (kind == 3)
    if K and trap.any():
        a, b = int(si[0]), int(ti[0])
        p0[trap] = b
        start = max(tau[a], tau[b])
        t0[trap] = start + rng.random(int(trap.sum())) * (top[b] - start)
        route_M[trap] = 1e8
    unif = rng.random((3, S, L))
    theta = rng.uniform(0.002, 0.02, H)
    if scale != 1.0:
        finite = hi < BIG_AGE
        lo, tau, top, t0, theta = (x * scale for x in (lo, tau, top, t0,
                                                       theta))
        hi = np.where(finite, hi * scale, hi)
        partau = np.where(par >= 0, top, _FINITE_BIG)
        route_M = route_M / scale

    def f(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype,
                               device=device)

    def i(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=device)

    def b(x):
        return torch.as_tensor(np.asarray(x, bool), device=device)

    args = (f(lo), f(hi), i(pop_lo), b(live), b(anc), f(tau), f(partau),
            f(theta), i(par), i(si), i(ti), f(tau[si]), f(partau[si]),
            f(route_M), f(heredity), f(t0), i(p0), b(kind != 1), f(unif), ME)
    return args, kind


def synthetic_walk_chains(C: int, L: int, E: int, H: int = 7, ME: int = 8,
                          seed: int = 0, dtype=torch.float64, device="cpu",
                          every_pair=False):
    """C chains' :func:`synthetic_walks` on one species tree and route
    table (``seed``), chain c's loci from a seed of its own and its times
    in units 1 + c / 4 (so that the chains' species tables differ too):
    the arguments of ``mig_moves.simspr_walk_chains`` over a chain axis
    (every tensor but the route table ``si``, ``ti`` stacked ``[C, ...]``),
    and each chain's one-chain arguments and kinds."""
    ones = [synthetic_walks(L, E, H, ME, seed, dtype, device, every_pair,
                            locus_seed=seed * 31 + c, scale=1.0 + c / 4)
            for c in range(C)]
    per = [a for a, _ in ones]
    stacked = tuple(per[0][j] if j in (9, 10) else
                    torch.stack([a[j] for a in per]) for j in range(19))
    return stacked + (ME,), per, [k for _, k in ones]


def gene_tree_faults(gt, n_seq) -> list:
    """What is wrong with a batch of gene trees (empty when nothing is):
    each valid inner node's children name it as their parent, each valid
    node but one root is a child of its parent, and no child is older
    than its parent."""
    L, N = gt.left.shape
    T = (N + 1) // 2
    left, right, parent, age = (x.detach().cpu().numpy() for x in gt[:4])
    n_seq = np.asarray(n_seq.cpu() if torch.is_tensor(n_seq) else n_seq)
    faults = []
    for li in range(L):
        n = int(n_seq[li])
        nodes = list(range(n)) + list(range(T, T + n - 1))
        roots = [v for v in nodes if parent[li, v] < 0]
        if n > 1 and len(roots) != 1:
            faults.append((li, "roots", roots))
        for v in range(T, T + n - 1):
            for ch in (left[li, v], right[li, v]):
                if parent[li, ch] != v:
                    faults.append((li, "child", v, int(ch)))
                elif not age[li, ch] <= age[li, v]:
                    faults.append((li, "age", v, int(ch)))
        for v in nodes:
            p = parent[li, v]
            if p >= 0 and v not in (left[li, p], right[li, p]):
                faults.append((li, "parent", v, int(p)))
    return faults


def state_arrays(state) -> dict:
    """The ``{"gt", "sp", "subst", "clock", "mig"}`` numpy field
    dictionaries of a sampler state (the port's, or ``bpp_tpu``'s, whose
    arrays numpy reads), with ``coal``/``t2h``/``mubar`` where the state
    has them: what ``convert.state_from_numpy`` takes."""
    def fields(x):
        return None if x is None else {
            f: (None if v is None else np.asarray(v))
            for f, v in x._asdict().items()}

    out = {k: fields(getattr(state, k, None))
           for k in ("gt", "sp", "subst", "clock", "mig", "trait")}
    for k in ("coal", "t2h", "mubar"):
        v = getattr(state, k, None)
        if v is not None:
            out[k] = np.asarray(v)
    return out


def port_state(state, cfg, device="cpu", dtype=torch.float64):
    """A port ``McmcState`` holding ``state``'s arrays and its cached
    ``logl``/``logpr`` (on a network: its gene trees with their
    hybridization flags and every network field of the species arrays;
    under MSC-M its migration events and rates).  A state of K chains
    stacked on a leading axis (``bpp_tpu``'s ``init_states``, or K states
    stacked with ``jax.tree.map``) gives the port's stacked state."""
    from .convert import state_from_numpy
    st = state_from_numpy(state_arrays(state), device=device, dtype=dtype,
                          cfg=cfg)
    return st._replace(
        logl=torch.as_tensor(np.array(state.logl), dtype=dtype,
                             device=device),
        logpr=torch.as_tensor(np.array(state.logpr), dtype=dtype,
                              device=device))


def ess(x) -> float:
    """Effective sample size of a chain's trace, from its initial
    positive autocorrelations."""
    x = np.asarray(x, float) - np.mean(x)
    n = len(x)
    f = np.fft.rfft(x, 2 * n)
    ac = np.fft.irfft(f * np.conj(f))[:n] / (np.arange(n, 0, -1) * x.var())
    s = 0.0
    for k in range(1, n):
        if ac[k] <= 0:
            break
        s += ac[k]
    return n / (1 + 2 * s)
