"""MSC-M (isolation-with-migration) state and density, batched over loci
(PyTorch).

Port of ``bpp_tpu/trees/migration.py``: the host route tables
(``build_routes``, ``build_routes_geneflow``) and the structured-coalescent
simulator ``simulate_gtree_mig_host`` are numpy copies; the device half
(populations through migration events, route consistency, the sub-edge
sweep and the density) works on tensors.  The one-hot and vmap forms of
``bpp_tpu`` are plain indexing here.

Representation.  Migration events live in a fixed-capacity per-locus
buffer ``time/node/src/dst [L, ME]``: ``node`` is the gene-tree edge (the
node whose branch to its parent carries the event; -1 marks an empty
slot), ``src`` the population the lineage occupies below the event and
``dst`` the population above it (a backward-in-time jump src -> dst is a
forward-time migrant dst -> src; the reference's migevent_t source /
target, miginfo.c:165).

Density (gtree.c:3620-3663): with K_h coalescences and waiting sums C2_h
per population, mc_k migration events and lineage-time overlaps W_k per
route k = (s -> t forward),

  logPG = sum_h [K_h log(2/(hered*theta_h)) - C2_h/(hered*theta_h)]
        + sum_k [mc_k log M_k - M_k W_k]

where W_k = integral over time of (#lineages in t) * 1[s alive]
(``Wsji``, stree.c:779-843).  Each migration event splits its edge into
sub-edges; a sub-edge starting in population p visits p's ancestors
through speciation boundaries like a plain edge, so the per-population
lineage count n_h(x) is a sum of sub-edge interval indicators.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .gtree import BIG_AGE, GTrees, SpeciesArrays, inner_order, lift_population

_FINITE_BIG = 1.0e12


@dataclass(frozen=True)
class MigRoutes:
    """Static route table resolved against the species tree (host)."""

    si: np.ndarray        # [K] forward-source population index
    ti: np.ndarray        # [K] forward-target population index
    alpha: np.ndarray     # [K] Gamma prior shape for M_k
    beta: np.ndarray      # [K] Gamma prior rate
    am: np.ndarray        # [K] per-locus variable-rate shape (0 = fixed)
    index: np.ndarray     # [H, H] (si, ti) -> route k, -1 if absent

    @property
    def n_routes(self) -> int:
        return len(self.si)

    def to(self, device, dtype) -> "RouteTensors":
        """The table's tensors on ``device``, made once a run."""
        def t(a, dt=None):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

        return RouteTensors(
            si=t(self.si, torch.int64), ti=t(self.ti, torch.int64),
            alpha=t(self.alpha, dtype), beta=t(self.beta, dtype),
            am=t(self.am, dtype), has_am=t(self.am > 0),
            rev=t(self.index[self.ti, self.si], torch.int64),
            any_am=bool((self.am > 0).any()))


class RouteTensors(NamedTuple):
    """A :class:`MigRoutes` on the device (what the moves read)."""

    si: torch.Tensor       # [K] int64
    ti: torch.Tensor       # [K] int64
    alpha: torch.Tensor    # [K]
    beta: torch.Tensor     # [K]
    am: torch.Tensor       # [K]
    has_am: torch.Tensor   # [K] bool
    rev: torch.Tensor      # [K] int64 the opposite route's index, or -1
    any_am: bool


def _wprior(cfg):
    if cfg.wprior:
        return cfg.wprior.alpha, cfg.wprior.beta
    if cfg.migprior:
        return cfg.migprior.alpha, cfg.migprior.beta
    return 2.0, 1.0


def build_routes(cfg, st) -> MigRoutes:
    """Resolve MigSpec source/target labels to node indices.

    Labels follow the reference's naming: tip names, or ancestral
    populations named by the concatenation of their descendant tip
    labels in the control-file order (output.node_label)."""
    from ..output import node_label

    H = st.n_nodes
    names = {node_label(st, i): i for i in range(H)}
    K = len(cfg.mig_specs)
    si = np.zeros(K, np.int32)
    ti = np.zeros(K, np.int32)
    al = np.zeros(K)
    be = np.zeros(K)
    am = np.zeros(K)
    wa, wb = _wprior(cfg)
    index = np.full((H, H), -1, np.int32)
    for k, s in enumerate(cfg.mig_specs):
        for label, attr in ((s.source, "source"), (s.target, "target")):
            if label not in names:
                raise ValueError(
                    f"migration {attr} {label!r} is not a population "
                    f"(known: {sorted(names)})")
        si[k] = names[s.source]
        ti[k] = names[s.target]
        al[k] = s.alpha if s.alpha > 0 else wa
        be[k] = s.beta if s.beta > 0 else wb
        am[k] = s.am
        index[si[k], ti[k]] = k
    return MigRoutes(si=si, ti=ti, alpha=al, beta=be, am=am, index=index)


def build_routes_geneflow(cfg, st):
    """Saturated candidate route table for geneflow rjMCMC.

    Candidates are every ordered population pair (s, t), neither the
    root, s != t, neither an ancestor of the other.  Routes from an
    explicit ``migration`` block keep their configured priors/am and
    start active; all other candidates get the wprior defaults and start
    off.  Returns (routes, on0 [K] bool)."""
    base = build_routes(cfg, st)
    H = st.n_nodes
    anc = st.pptable()
    root = st.root
    wa, wb = _wprior(cfg)
    si, ti, al, be, am, on0 = [], [], [], [], [], []
    index = np.full((H, H), -1, np.int32)
    for s in range(H):
        for t in range(H):
            if s == t or s == root or t == root:
                continue
            if anc[s, t] or anc[t, s]:
                continue
            k0 = base.index[s, t]
            index[s, t] = len(si)
            si.append(s)
            ti.append(t)
            al.append(base.alpha[k0] if k0 >= 0 else wa)
            be.append(base.beta[k0] if k0 >= 0 else wb)
            am.append(base.am[k0] if k0 >= 0 else 0.0)
            on0.append(k0 >= 0)
    routes = MigRoutes(si=np.asarray(si, np.int32),
                       ti=np.asarray(ti, np.int32),
                       alpha=np.asarray(al), beta=np.asarray(be),
                       am=np.asarray(am), index=index)
    return routes, np.asarray(on0, bool)


class MigState(NamedTuple):
    """Per-locus migration events and route rates."""

    time: torch.Tensor    # [L, ME] event times (BIG_AGE in empty slots)
    node: torch.Tensor    # [L, ME] int64 gene-tree edge (-1 empty)
    src: torch.Tensor     # [L, ME] int64 population below the event
    dst: torch.Tensor     # [L, ME] int64 population above the event
    M: torch.Tensor       # [K] route rates (forward s -> t); for routes
                          # with a variable-rates shape am > 0 the mean
                          # rate Mbar (migspec_t.M, bpp.h:1036)
    Mi: torch.Tensor      # [L, K] per-locus rates, read where am > 0
    # geneflow rjMCMC: which candidate routes are in the model; None in
    # fixed-route mode (every configured route always on)
    on: torch.Tensor | None = None    # [K] bool

    @property
    def cap(self) -> int:
        return self.time.shape[1]

    def count(self):
        """[L] live event counts."""
        return (self.node >= 0).sum(dim=1)


def empty_mig_state(L: int, cap: int, K: int, M0, dtype, on=None,
                    device="cpu") -> MigState:
    M = torch.as_tensor(np.asarray(M0, np.float64), dtype=dtype,
                        device=device)
    return MigState(
        time=torch.full((L, cap), BIG_AGE, dtype=dtype, device=device),
        node=torch.full((L, cap), -1, dtype=torch.int64, device=device),
        src=torch.zeros((L, cap), dtype=torch.int64, device=device),
        dst=torch.zeros((L, cap), dtype=torch.int64, device=device),
        M=M, Mi=M[None, :].expand(L, K).clone(),
        on=None if on is None else torch.as_tensor(np.asarray(on, bool),
                                                   device=device))


def eff_rates(routes: RouteTensors, mig: MigState):
    """Effective per-locus route rates [L, K]: Mi where the route has a
    variable-rates shape (am > 0), the shared M otherwise; routes the
    geneflow mask switches off get rate 0."""
    r = torch.where(routes.has_am[None, :], mig.Mi, mig.M[None, :])
    if mig.on is not None:
        r = torch.where(mig.on[None, :], r, torch.zeros_like(r))
    return r


def _partau(sp: SpeciesArrays, top):
    """Each population's upper bound: its parent's tau, ``top`` at the
    root."""
    par = sp.parent
    return torch.where(par >= 0, sp.tau[par.clamp(min=0)],
                       torch.full_like(sp.tau, top))


# --------------------------------------------------------------------------
# population assignment with migration
# --------------------------------------------------------------------------


def edge_top_pop(sp: SpeciesArrays, mig: MigState, pops, node_ids, t_top):
    """Population of edge ``node_ids [L]`` just below time ``t_top [L]``:
    the latest migration event on the edge below ``t_top`` sets the base
    population, speciation boundaries lift it the rest of the way."""
    lidx = torch.arange(pops.shape[0], device=pops.device)
    on_edge = (mig.node == node_ids[:, None]) & (mig.time < t_top[:, None])
    t_ev = torch.where(on_edge, mig.time,
                       torch.full_like(mig.time, -float("inf")))
    last = torch.argmax(t_ev, dim=1)
    has = on_edge[lidx, last]
    base = torch.where(has, mig.dst[lidx, last], pops[lidx, node_ids])
    return lift_population(sp, base, t_top)


def assign_populations_mig(gt: GTrees, sp: SpeciesArrays, tip_pop,
                           mig: MigState, n_seq):
    """[L, N] population of every gene node under migration events.

    Age-ordered (children before parents): node u's population is its
    left child's edge population at age_u."""
    L, N = gt.age.shape
    T = gt.n_tips
    lidx = torch.arange(L, device=gt.age.device)
    # made from the ages, so that inside the batched step (vmap) it
    # carries the chain axis the node writes below take
    pops = torch.zeros_like(gt.age, dtype=torch.int64)
    pops[:, :T] = tip_pop
    order = inner_order(gt)
    for k in range(T - 1):
        node = order[:, k]
        lc = gt.left[lidx, node].clamp(min=0)
        p = edge_top_pop(sp, mig, pops, lc, gt.age[lidx, node])
        pops[lidx, node] = torch.where(k < n_seq - 1, p, pops[lidx, node])
    return pops


def route_consistent_mig(gt: GTrees, sp: SpeciesArrays, mig: MigState,
                         pops, n_seq):
    """[L] validity: every coalescence's right-child edge arrives in the
    population assigned from the left child, and every event lies inside
    both its populations' lifetimes and its edge's time span."""
    L, N = gt.age.shape
    T = gt.n_tips
    dev = gt.age.device
    nodes = torch.arange(N, device=dev)[None, :]
    is_inner = (nodes >= T) & (nodes < T + n_seq[:, None] - 1)

    rc = gt.right.clamp(min=0)
    age = gt.age
    # the right child's arrival population at every inner node
    on_edge = (mig.node[:, None, :] == rc[:, :, None]) & (
        mig.time[:, None, :] < age[:, :, None])            # [L, N, ME]
    t_ev = torch.where(on_edge, mig.time[:, None, :].expand_as(on_edge),
                       torch.full_like(on_edge, -float("inf"),
                                       dtype=age.dtype))
    last = torch.argmax(t_ev, dim=2)                       # [L, N]
    has = torch.gather(on_edge, 2, last[:, :, None])[..., 0]
    base = torch.where(has, torch.gather(mig.dst, 1, last),
                       torch.gather(pops, 1, rc))
    lifted = lift_population(sp, base, age)
    ok_nodes = torch.where(is_inner, lifted == pops,
                           torch.ones_like(is_inner)).all(dim=1)

    live = mig.node >= 0
    nd = mig.node.clamp(min=0)
    e_lo = torch.gather(gt.age, 1, nd)
    par = torch.gather(gt.parent, 1, nd)
    e_hi = torch.where(par >= 0, torch.gather(gt.age, 1, par.clamp(min=0)),
                       torch.full_like(e_lo, BIG_AGE))
    tau = sp.tau
    partau = _partau(sp, float("inf"))
    t = mig.time
    ok_ev = ((t > e_lo) & (t < e_hi)
             & (t >= tau[mig.src]) & (t < partau[mig.src])
             & (t >= tau[mig.dst]) & (t < partau[mig.dst]))
    ok_ev = torch.where(live, ok_ev, torch.ones_like(ok_ev)).all(dim=1)
    return ok_nodes & ok_ev


# --------------------------------------------------------------------------
# interval sweep: coalescent and migration waiting statistics
# --------------------------------------------------------------------------


def _subedges(gt: GTrees, mig: MigState, pops, n_seq, exclude=None,
              include_root_edge=False):
    """Split edges at migration events.

    Returns (t_lo [L, E], t_hi [L, E], pop_lo [L, E], live [L, E]) with
    E = N + ME: the base piece of every edge plus one piece per event.
    ``exclude [L, X]``: node columns whose edges are masked out (the
    sim-SPR prune set).  ``include_root_edge``: the root's edge extends to
    +inf (the "rest" lineage pool of sim-SPR)."""
    N = gt.age.shape[1]
    T = gt.n_tips
    dev = gt.age.device
    nodes = torch.arange(N, device=dev)[None, :]
    valid_edge = ((nodes < n_seq[:, None])
                  | ((nodes >= T) & (nodes < T + n_seq[:, None] - 1)))
    if not include_root_edge:
        valid_edge = valid_edge & (gt.parent >= 0)
    if exclude is not None:
        for j in range(exclude.shape[1]):
            valid_edge = valid_edge & (nodes != exclude[:, j:j + 1])
    page = torch.where(gt.parent >= 0,
                       torch.gather(gt.age, 1, gt.parent.clamp(min=0)),
                       torch.full_like(gt.age, BIG_AGE))
    inf = float("inf")
    live = mig.node >= 0
    nd = mig.node.clamp(min=0)

    # base piece: [age_u, first event on the edge, else the parent's age)
    on = live[:, None, :] & (mig.node[:, None, :] == nodes[:, :, None])
    first_ev = torch.where(on, mig.time[:, None, :],
                           torch.full_like(on, inf, dtype=gt.age.dtype)
                           ).amin(dim=2)
    base_hi = torch.minimum(page, first_ev)

    # event pieces: [t_e, next event above on the same edge, else the
    # parent's age)
    et = mig.time
    same = ((mig.node[:, :, None] == mig.node[:, None, :])
            & live[:, :, None] & live[:, None, :])
    above = same & (et[:, None, :] > et[:, :, None])          # [L, ME, ME]
    nxt = torch.where(above, et[:, None, :].expand_as(above),
                      torch.full_like(above, inf, dtype=et.dtype)).amin(dim=2)
    ev_hi = torch.minimum(nxt, torch.gather(page, 1, nd))

    t_lo = torch.cat([gt.age, et], dim=1)
    t_hi = torch.cat([base_hi, ev_hi], dim=1)
    pop_lo = torch.cat([pops, mig.dst], dim=1)
    lv = torch.cat([valid_edge, live], dim=1)
    return t_lo, t_hi, pop_lo, lv


def mig_stats(gt: GTrees, sp: SpeciesArrays, pops, mig: MigState,
              routes_si, routes_ti, n_seq):
    """Per-locus structured-coalescent statistics.

    Returns (coal [L, H] int64, C2 [L, H], W [L, K], mc [L, K] int64,
    n_in [L, H] int64)."""
    N = gt.age.shape[1]
    T = gt.n_tips
    H = sp.n_nodes
    dev = gt.age.device
    dtype = gt.age.dtype
    tau = sp.tau
    partau = _partau(sp, _FINITE_BIG)
    si = torch.as_tensor(routes_si, dtype=torch.int64, device=dev)
    ti = torch.as_tensor(routes_ti, dtype=torch.int64, device=dev)

    # the root lineage counts toward migration waiting sums (n = 1 adds
    # nothing to C2 but Wsji_epoch += n*t includes it, gtree.c:3604)
    t_lo, t_hi, pop_lo, live = _subedges(gt, mig, pops, n_seq,
                                         include_root_edge=True)  # [L, E]
    anc = sp.pptable[pop_lo] & live[..., None]                    # [L, E, H]

    # the interval of sub-edge e inside population h
    lo = torch.maximum(t_lo[..., None], tau)
    hi = torch.clamp(torch.minimum(t_hi[..., None], partau),
                     max=_FINITE_BIG)
    zero = torch.zeros_like(lo)
    seg = torch.where(anc, torch.clamp(hi - lo, min=0.0), zero)
    inh = seg > 0.0

    # lineages entering h at tau_h
    n_in = (anc & (t_lo[..., None] <= tau) & (tau < t_hi[..., None])).sum(1)

    # coalescences per population
    nodes = torch.arange(N, device=dev)[None, :]
    is_inner = (nodes >= T) & (nodes < T + n_seq[:, None] - 1)
    ev_pop = torch.where(is_inner, pops, torch.full_like(pops, -1))
    coal = (ev_pop[..., None] == torch.arange(H, device=dev)).sum(1)

    # the n_h(x) sweep: C2 = sum n(n - 1) dt over 2E boundary points a
    # population (interval starts +1, ends -1)
    big = torch.full_like(lo, _FINITE_BIG)
    times = torch.cat([torch.where(inh, lo, big), torch.where(inh, hi, big)],
                      dim=1).transpose(1, 2)                      # [L, H, 2E]
    one = inh.to(torch.int64)
    deltas = torch.cat([one, -one], dim=1).transpose(1, 2)
    o = torch.argsort(times, dim=2, stable=True)
    ts = torch.gather(times, 2, o)
    ds = torch.gather(deltas, 2, o)
    n_run = torch.cumsum(ds, dim=2)                               # after point
    nxt = torch.cat([ts[..., 1:], torch.full_like(ts[..., :1], _FINITE_BIG)],
                    dim=2)
    dt = torch.clamp(nxt - ts, min=0.0)
    nn = n_run.to(dtype)
    C2 = torch.sum(nn * (nn - 1.0) * dt, dim=2)                   # [L, H]

    # route waiting sums W_k = int n_t(x) 1[s alive] dx: the sweep
    # segments of population t_k, clipped to s_k's life
    a_lo = torch.maximum(ts[:, ti, :], tau[si][None, :, None])
    a_hi = torch.minimum(nxt[:, ti, :], partau[si][None, :, None])
    W = torch.sum(nn[:, ti, :] * torch.clamp(a_hi - a_lo, min=0.0), dim=2)

    # migration events per route (forward s = dst above, t = src below)
    match = ((mig.dst[:, :, None] == si) & (mig.src[:, :, None] == ti)
             & (mig.node >= 0)[:, :, None])
    mc = match.sum(1)                                             # [L, K]
    return coal, C2, W, mc, n_in


def msc_logprob_mig(coal, C2, W, mc, theta, heredity, M, on=None):
    """Per-locus MSC-M log density [L] (gtree.c:3637-3663).

    ``M`` is [K] (shared route rates) or [L, K] (per-locus effective
    rates from :func:`eff_rates`).  ``on`` [K] bool masks the terms of
    switched-off routes (geneflow rjMCMC); an event on an off route makes
    the density -inf."""
    th = torch.clamp(theta[None, :] * heredity[:, None], min=1e-300)
    pop_terms = torch.sum(coal * torch.log(2.0 / th) - C2 / th, dim=1)
    Msafe = torch.clamp(M, min=1e-300)
    if Msafe.dim() == 1:
        Msafe = Msafe[None, :]
    per_route = mc * torch.log(Msafe) - Msafe * W
    if on is not None:
        per_route = torch.where(on[None, :], per_route,
                                torch.zeros_like(per_route))
        bad = (~on[None, :] & (mc > 0)).any(dim=1)
        pop_terms = torch.where(bad, torch.full_like(pop_terms,
                                                     -float("inf")),
                                pop_terms)
    return pop_terms + per_route.sum(dim=1)


# --------------------------------------------------------------------------
# host-side structured-coalescent simulator with migration
# (simulate.c + gtree_simulate gtree.c:2242 with opt_migration); copied
# from bpp_tpu (numpy), so that the same seed simulates the same trees
# --------------------------------------------------------------------------


def simulate_gtree_mig_host(rng, tip_species, st_parent, tau, theta,
                            routes_si, routes_ti, M):
    """Simulate one gene tree under the MSC-M prior (numpy, host).

    Backward-in-time event-driven simulation: within each epoch the total
    rate is sum_h k_h(k_h-1)/theta_h + sum_k k_{t_k} M_k over routes whose
    donor is alive; a migration moves one random lineage from the route's
    target to its source population (backward jump).

    Returns (left, right, parent, age) over 2n-1 nodes, tips first."""
    n = len(tip_species)
    H = len(st_parent)
    nnodes = 2 * n - 1
    left = np.zeros(nnodes, np.int32)
    right = np.zeros(nnodes, np.int32)
    parent = np.full(nnodes, -1, np.int32)
    age = np.zeros(nnodes, np.float64)
    partau = np.where(st_parent >= 0, tau[np.maximum(st_parent, 0)], np.inf)

    lineages = {h: [] for h in range(H)}
    for i, spx in enumerate(tip_species):
        lineages[int(spx)].append(i)
    next_node = n
    t = 0.0
    boundaries = sorted({float(tau[h]) for h in range(H) if tau[h] > 0})
    K = len(routes_si)

    def alive(h, x):
        return tau[h] <= x < partau[h]

    while next_node < nnodes:
        crates = {h: len(v) * (len(v) - 1) / max(theta[h], 1e-300)
                  for h, v in lineages.items() if len(v) >= 2 and alive(h, t)}
        mrates = {}
        for k in range(K):
            s, d = int(routes_si[k]), int(routes_ti[k])
            if alive(s, t) and alive(d, t) and lineages[d]:
                mrates[k] = len(lineages[d]) * M[k]
        rate = sum(crates.values()) + sum(mrates.values())
        nb = min([b for b in boundaries if b > t], default=np.inf)
        if rate > 0:
            dt = rng.exponential(1.0 / rate)
        else:
            dt = np.inf
        if t + dt < nb:
            t = t + dt
            u = rng.random() * rate
            acc = 0.0
            done = False
            for h, r in crates.items():
                acc += r
                if u < acc:
                    k_ = len(lineages[h])
                    i_, j_ = rng.choice(k_, size=2, replace=False)
                    a, b = lineages[h][i_], lineages[h][j_]
                    node = next_node
                    next_node += 1
                    left[node], right[node] = a, b
                    parent[a] = parent[b] = node
                    age[node] = t
                    lineages[h] = [x for x in lineages[h]
                                   if x not in (a, b)] + [node]
                    done = True
                    break
            if not done:
                for k, r in mrates.items():
                    acc += r
                    if u < acc:
                        s, d = int(routes_si[k]), int(routes_ti[k])
                        pick = rng.integers(len(lineages[d]))
                        lin = lineages[d].pop(pick)
                        lineages[s].append(lin)
                        break
        else:
            if not np.isfinite(nb):
                # cannot happen: the root population coalesces everything
                break
            t = nb
            for h in range(H):
                p = st_parent[h]
                if p >= 0 and abs(tau[p] - nb) < 1e-300 and lineages[h]:
                    lineages[p].extend(lineages[h])
                    lineages[h] = []
        if next_node == nnodes:
            break
    return left, right, parent, age


# --------------------------------------------------------------------------
# relaxed-clock branch lengths under migration
# --------------------------------------------------------------------------


def relaxed_segments_mig(gt: GTrees, sp: SpeciesArrays, mig: MigState,
                         pops, n_seq):
    """Time each gene-tree edge spends in each population, ``[L, N, H]``,
    under migration: a migrating edge occupies different populations
    along its span, so its row is the sum over its sub-edges
    (:func:`_subedges`) of each sub-edge's overlap with every population
    it ascends through.  ``felsenstein.segment_lengths`` of it is
    :func:`relaxed_branch_lengths_mig`; like ``relaxed_segments`` it
    depends on the trees, taus and events only, so a sweep over branch
    rates computes it once."""
    N = gt.age.shape[1]
    tau = sp.tau
    partau = _partau(sp, BIG_AGE)
    t_lo, t_hi, pop_lo, live = _subedges(gt, mig, pops, n_seq)  # [L, E]
    anc = sp.pptable[pop_lo] & live[..., None]                   # [L, E, H]
    lo = torch.maximum(t_lo[..., None], tau)
    hi = torch.minimum(t_hi[..., None], partau)
    seg = torch.where(anc, torch.clamp(hi - lo, min=0.0),
                      torch.zeros_like(lo))
    # event pieces go to their gene node (mig.node); base pieces are the
    # first N columns
    ev_oh = ((mig.node[:, :, None] == torch.arange(N, device=lo.device))
             & (mig.node >= 0)[:, :, None]).to(seg.dtype)         # [L, ME, N]
    return seg[:, :N] + torch.bmm(ev_oh.transpose(1, 2), seg[:, N:])


def relaxed_branch_lengths_mig(gt: GTrees, sp: SpeciesArrays,
                               mig: MigState, pops, n_seq, brate):
    """Per-node relaxed-clock branch lengths under migration ``[L, N]``:
    the rate-weighted overlap of every sub-edge with every population it
    crosses (locus.c:1151 with the miginfo walks), the migration-aware
    form of ``felsenstein.relaxed_branch_lengths``."""
    from ..core.felsenstein import segment_lengths
    return segment_lengths(
        gt, relaxed_segments_mig(gt, sp, mig, pops, n_seq), brate)
