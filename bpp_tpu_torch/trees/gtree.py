"""Batched gene-tree state and topology operations (PyTorch).

Port of ``bpp_tpu/trees/gtree.py``, plain species trees and MSC-I
networks.  Per-locus gene trees live in fixed-shape ``[L, N]`` index
tensors; on a plain tree a gene node's population is the ancestor of the
species-MRCA of its descendant tips whose tau interval contains the node
age, and on a network it is found by walking the route that the
per-edge hybridization flags (``GTrees.hpath``) choose.  The one-hot
gather/scatter forms the TPU needed are plain indexing here, and the
age-sorted schedule is a stable sort.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

BIG_AGE = 1.0e30  # age sentinel for padded inner-node slots


class GTrees(NamedTuple):
    """Batched gene trees as index tensors.

    Node indexing per locus: tips ``0..T-1`` (only ``0..n_seq-1``
    valid), inner nodes ``T..2T-2`` (only ``T..T+n_seq-2`` occupied;
    padded slots keep ``age=BIG_AGE``, ``parent=-1``, children 0).
    Index tensors are int64.
    """

    left: torch.Tensor      # [L, N]
    right: torch.Tensor     # [L, N]
    parent: torch.Tensor    # [L, N], -1 for root & padded
    age: torch.Tensor       # [L, N] float
    # MSC-I: per-edge hybridization flags [L, N, HY] int8 (0 = the hinner
    # side, 1 = the mirror side); the flag of slot k on node u says which
    # parent the lineage u -> parent(u) takes where it crosses
    # hybridization k.  None on plain species trees.
    hpath: torch.Tensor = None

    @property
    def n_loci(self):
        return self.left.shape[0]

    @property
    def n_nodes(self):
        return self.left.shape[1]

    @property
    def n_tips(self):
        return (self.left.shape[1] + 1) // 2


class SpeciesArrays(NamedTuple):
    """Species-tree or network state on the device.

    Node indexing: tips ``0..NS-1``, inner ``NS..NS+NI-1`` with the root
    last, MSC-I mirror nodes after; ``pptable[i, j]`` is True iff j is i
    or an ancestor of i (through either parent of a hybridization);
    ``mrca[i, j]`` is the species MRCA.  A hybridization adds one
    one-child inner node (the hinner), one binary join and one mirror, so
    ``H = 2 NS - 1 + 3 HY``; a bidirectional pair (BDI) adds two nodes a
    slot instead of three (``bdi_pairs`` corrects the count).  The
    network fields are None on a plain tree.
    """

    left: torch.Tensor      # [H] int64
    right: torch.Tensor     # [H] int64
    parent: torch.Tensor    # [H] int64 (-1 root)
    tau: torch.Tensor       # [H] float
    theta: torch.Tensor     # [H] float
    pptable: torch.Tensor   # [H, H] bool
    mrca: torch.Tensor      # [H, H] int64
    # --- MSC-I network fields --------------------------------------------
    hslot: torch.Tensor = None      # [HY] int64 hinner of each slot
    hybrid: torch.Tensor = None     # [H] int64 partner (hinner<->mirror), -1
    phi: torch.Tensor = None        # [H] float: phi on the hinner, 1 - phi
                                    # on the mirror
    hindex: torch.Tensor = None     # [H] int64 hybridization slot or -1
    tau_free: torch.Tensor = None   # [H] bool: the node carries its own tau
                                    # (inner non-mirror nodes, minus parents
                                    # tied by htau == 0; a hinner counts
                                    # once for its pair)
    # --- bidirectional introgression (treeparse.c:1232) ------------------
    bdi_partner: torch.Tensor = None    # [H] int64 partner hinner, or -1
    bdi_mirror: torch.Tensor = None     # [H] bool: zero-width BDI mirrors
    bdi_pairs: torch.Tensor = None      # [n_pairs, 2] int64 (X, Y) hinners
    # relaxed clocks: the populations that carry a rate (all but the
    # zero-length htau == 0 segments and the BDI mirrors,
    # stree.c:10293-10298), and the rate owner of each population (a BDI
    # mirror reads its hinner partner's rate; method.c:4235)
    rate_nodes: torch.Tensor = None     # [H] bool
    rate_owner: torch.Tensor = None     # [H] int64

    @property
    def n_nodes(self):
        return self.left.shape[0]

    @property
    def n_hybrids(self):
        return 0 if self.hslot is None else self.hslot.shape[0]

    @property
    def n_bdi_slots(self):
        return 0 if self.bdi_pairs is None else 2 * self.bdi_pairs.shape[0]

    @property
    def n_tips(self):
        return (self.left.shape[0] + 1 - 3 * self.n_hybrids
                + self.n_bdi_slots) // 2

    @property
    def root(self):
        return self.left.shape[0] - 1 - self.n_hybrids

    @property
    def is_network(self):
        return self.n_hybrids > 0


def species_arrays(st, dtype=torch.float64, device="cpu") -> SpeciesArrays:
    """Build device tensors from a host-side SpeciesTree (a tree or an
    MSC-I network; ``bpp_tpu/trees/gtree.py`` ``species_arrays``)."""

    # copies: a float64 CPU tensor made by as_tensor would share its
    # memory with the host tree's arrays, which init_tau_theta rewrites
    # for the next chain
    def idx(a):
        return torch.tensor(np.asarray(a, np.int64), device=device)

    def flt(a):
        return torch.tensor(np.asarray(a, np.float64), dtype=dtype,
                            device=device)

    def flag(a):
        return torch.tensor(np.asarray(a, bool), device=device)

    kw = {}
    if st.n_hybrids > 0:
        hslot = np.full(st.n_hybrids, -1, np.int64)
        mirror_start = st.n_tips + st.n_inner
        free = np.zeros(st.n_nodes, bool)
        free[st.n_tips:mirror_start] = True
        rate_nodes = np.ones(st.n_nodes, bool)
        for i in range(st.n_nodes):
            if st.hindex[i] >= 0:
                if i < mirror_start:
                    hslot[st.hindex[i]] = i
                else:
                    free[i] = False               # mirror: tau of its hinner
                if not st.htau[i]:
                    free[st.parent[i]] = False    # tied parent
                    rate_nodes[i] = False         # zero-length segment
        if st.bdi is not None and (st.bdi >= 0).any():
            bdi = np.asarray(st.bdi, np.int64)
            pairs = [(i, int(bdi[i])) for i in range(st.n_nodes)
                     if bdi[i] >= 0 and i < bdi[i]]
            bdi_mirror = np.zeros(st.n_nodes, bool)
            rate_owner = np.arange(st.n_nodes, dtype=np.int64)
            for i in range(st.n_nodes):
                if bdi[i] >= 0:
                    bdi_mirror[st.hybrid[i]] = True
                    rate_nodes[st.hybrid[i]] = False   # stree.c:10298
                    rate_owner[st.hybrid[i]] = i
                    free[i] = i < bdi[i]     # one shared tau a pair
            kw = dict(bdi_partner=idx(bdi), bdi_mirror=flag(bdi_mirror),
                      bdi_pairs=idx(np.asarray(pairs, np.int64)
                                    .reshape(-1, 2)),
                      rate_owner=idx(rate_owner))
        kw.update(hslot=idx(hslot), hybrid=idx(st.hybrid), phi=flt(st.phi),
                  hindex=idx(st.hindex), tau_free=flag(free),
                  rate_nodes=flag(rate_nodes))
    return SpeciesArrays(
        left=idx(st.left), right=idx(st.right), parent=idx(st.parent),
        tau=flt(st.tau), theta=flt(st.theta),
        pptable=torch.as_tensor(st.pptable(), device=device),
        mrca=idx(st.mrca_table()), **kw)


# --- schedules -----------------------------------------------------------------


def anc_matrix(gt: GTrees):
    """Ancestor-or-self indicator ``M [L, N, N]`` float32.

    ``M[l, v, a] = 1`` iff node a is v or an ancestor of v; built by
    log-depth squaring of the (parent + identity) adjacency."""
    N = gt.n_nodes
    T = gt.n_tips
    ar = torch.arange(N, device=gt.parent.device)
    M = (gt.parent[:, :, None] == ar).to(torch.float32)
    M = M + torch.eye(N, dtype=torch.float32, device=M.device)
    steps = max(1, int(np.ceil(np.log2(max(T, 2)))))
    for _ in range(steps):
        M = torch.clamp(torch.bmm(M, M), max=1.0)
    return M


def node_depths(gt: GTrees):
    """Topological depth (#ancestors) per node, ``[L, N]`` int64."""
    return torch.round(anc_matrix(gt).sum(-1)).to(torch.int64) - 1


def inner_order(gt: GTrees):
    """Age-sorted inner-node schedule ``[L, T-1]`` (values are node ids).

    Ties in age are broken by topological depth, deepest first, then by
    node index, so a child always precedes its equal-aged parent; padded
    slots (BIG_AGE) sort last.  Two stable sorts give the lexicographic
    order of (age, -depth, index)."""
    T = gt.n_tips
    ia = gt.age[:, T:]
    dep = node_depths(gt)[:, T:]
    by_depth = torch.sort(-dep, dim=1, stable=True).indices
    by_age = torch.sort(torch.gather(ia, 1, by_depth), dim=1,
                        stable=True).indices
    return torch.gather(by_depth, 1, by_age) + T


def root_index(gt: GTrees, n_seq, order=None):
    if order is None:
        order = inner_order(gt)
    lidx = torch.arange(gt.n_loci, device=order.device)
    return order[lidx, n_seq - 2]


def detie_ages(gt: GTrees, n_seq):
    """Restore strict child < parent age ordering after float rounding.

    Bumps every inner node at least one ulp above its children, in
    tie-broken age order (``bpp_tpu/trees/gtree.py`` ``detie_ages``)."""
    L = gt.n_loci
    lidx = torch.arange(L, device=gt.age.device)
    order = inner_order(gt)
    age = gt.age.clone()
    inf = torch.full_like(age[:, 0], float("inf"))
    tiny = torch.finfo(age.dtype).tiny
    N = gt.n_nodes
    for k in range(order.shape[1]):
        node = order[:, k]
        valid = k < n_seq - 1
        lc = gt.left[lidx, node].clamp(0, N - 1)
        rc = gt.right[lidx, node].clamp(0, N - 1)
        cm = torch.maximum(age[lidx, lc], age[lidx, rc])
        above = torch.nextafter(cm, inf)
        # a subnormal step is floored at the smallest normal, as on XLA,
        # which flushes subnormals to zero
        above = torch.where((above <= cm) | (above < tiny), cm + tiny, above)
        cur = age[lidx, node]
        bumped = torch.where(valid, torch.maximum(cur, above), cur)
        age[lidx, node] = bumped
    return gt._replace(age=age)


def topo_scan(gt: GTrees, tip_vals, combine, order=None):
    """Bottom-up accumulation: ``out[u] = combine(out[l], out[r])``.

    ``tip_vals``: [L, T]; returns [L, N] (padded inner slots receive
    garbage)."""
    L, T = tip_vals.shape
    if order is None:
        order = inner_order(gt)
    lidx = torch.arange(L, device=tip_vals.device)
    # made from the ages, so that inside the batched step (vmap) the
    # buffer carries the chain axis the node writes below take
    buf = torch.zeros_like(gt.age, dtype=tip_vals.dtype)
    buf[:, :T] = tip_vals
    for k in range(T - 1):
        node = order[:, k]
        lv = buf[lidx, gt.left[lidx, node]]
        rv = buf[lidx, gt.right[lidx, node]]
        buf[lidx, node] = combine(lv, rv)
    return buf


def mrca_and_leaves(gt: GTrees, sp: SpeciesArrays, tip_pop, n_seq, M=None):
    """(msp [L, N], leaves [L, N]): species-MRCA of, and number of valid
    tips below, every gene node, from the ancestor matrix."""
    T = gt.n_tips
    if M is None:
        M = anc_matrix(gt)
    dev = M.device
    desc_t = M.transpose(1, 2)[:, :, :T]                      # [L, u, t]
    tipvalid = (torch.arange(T, device=dev)[None, :]
                < n_seq[:, None]).to(torch.float32)
    dt = desc_t * tipvalid[:, None, :]
    leaves = torch.round(dt.sum(-1)).to(torch.int64)
    pp_t = sp.pptable[tip_pop].to(torch.float32)              # [L, t, h]
    bad = torch.bmm(dt, 1.0 - pp_t)                            # [L, u, h]
    ok = bad < 0.5
    depth_sp = sp.pptable.sum(1)                               # deeper = larger
    msp = torch.argmax(torch.where(ok, depth_sp, 0), dim=2)
    return msp, leaves


def mrca_species(gt: GTrees, sp: SpeciesArrays, tip_pop):
    """Species-MRCA of the tips below every gene node: ``[L, N]``.

    Every tip slot counts (padded tips carry tip_pop = 0, a valid
    species), as in ``bpp_tpu``."""
    n_seq = torch.full((gt.n_loci,), gt.n_tips, dtype=torch.int64,
                       device=gt.left.device)
    msp, _ = mrca_and_leaves(gt, sp, tip_pop, n_seq)
    return msp


def leaf_counts(gt: GTrees, n_seq):
    """Number of valid gene-tree tips below each node: ``[L, N]``."""
    T = gt.n_tips
    M = anc_matrix(gt)
    tipvalid = (torch.arange(T, device=M.device)[None, :]
                < n_seq[:, None]).to(torch.float32)
    dt = M.transpose(1, 2)[:, :, :T] * tipvalid[:, None, :]
    return torch.round(dt.sum(-1)).to(torch.int64)


def lift_population(sp: SpeciesArrays, base, age):
    """Population containing ``age`` on the ancestor chain of ``base``:
    the unique ancestor h with ``tau_h <= age < tau_parent(h)`` (root
    interval open above)."""
    anc = sp.pptable[base]                                    # [..., H]
    par = sp.parent
    inf = torch.full_like(sp.tau, float("inf"))
    partau = torch.where(par >= 0, sp.tau[par.clamp(min=0)], inf)
    a = age[..., None]
    ok = anc & (sp.tau <= a) & (a < partau)
    return torch.argmax(ok.to(torch.uint8), dim=-1)


def assign_populations(gt: GTrees, sp: SpeciesArrays, tip_pop):
    """Population of every gene node: ``[L, N]``.  On a plain tree from
    ages alone; on a network by :func:`assign_populations_net`."""
    if sp.is_network:
        return assign_populations_net(gt, sp, tip_pop)
    msp = mrca_species(gt, sp, tip_pop)
    age = gt.age.clamp(0.0, BIG_AGE * 0.5)      # padded slots -> root pop
    return lift_population(sp, msp, age)


# --- MSC-I network routing ------------------------------------------------------
#
# A lineage's path up the species network depends on its edge's
# hybridization flags (gt.hpath): where it enters a hybridization from
# below, it leaves through the hinner (flag 0) or the mirror (flag 1).
# Gene-node populations, the per-population entry counts and the phi
# terms of the density all come from these walks (the reference keeps
# them by seqin bookkeeping, gtree.c increase/decrease_seqin_count).
# Each walk is H steps of route_step, so it reads nothing back to the
# host; a step not taken leaves the lineage where it is.


def _step_map(sp: SpeciesArrays):
    """``(slot, nxt)``, what :func:`route_step` reads: ``slot[p]`` is the
    flag a lineage in population p reads on its next step (that of its
    parent's hybridization; 0 where it reads none), and ``nxt[p, f]`` the
    population it steps to when that flag is 1 (f = 1) or not (f = 0):
    the parent, or the mirror where the parent is a hinner and f = 1; at
    the root, p itself.  A lineage leaving a BDI mirror has switched sides
    already: it enters the partner hinner without reading that hinner's
    flag."""
    par = sp.parent
    par_s = par.clamp(min=0)
    hidx = sp.hindex[par_s]                  # >= 0 iff the parent is a hinner
    choose = (par >= 0) & (hidx >= 0)
    if sp.bdi_mirror is not None:
        choose = choose & ~sp.bdi_mirror
    up = torch.where(par >= 0, par_s, torch.arange(sp.n_nodes,
                                                   device=par.device))
    side = torch.where(choose, sp.hybrid[par_s], up)
    return hidx.clamp(min=0), torch.stack([up, side], dim=-1)


def _step(step_map, p, flags):
    slot, nxt = step_map
    flag = torch.gather(flags, -1, slot[p][..., None])[..., 0]
    return nxt[p, (flag == 1).to(torch.int64)]


def route_step(sp: SpeciesArrays, p, flags):
    """One population step up from ``p`` following the edge ``flags``
    (``p`` int [...], ``flags`` int [..., HY]): the parent, or the side of
    the hybridization the flag chooses where the parent is a hinner.  At
    the root, ``p`` itself."""
    return _step(_step_map(sp), p, flags)


def lift_population_net(sp: SpeciesArrays, base, age, flags):
    """Route-aware population containing ``age``, walking up from the
    population ``base`` along the edge ``flags``: H steps, each taken
    while the next population starts at or below ``age`` (at the root the
    step stays put)."""
    step_map = _step_map(sp)
    p = base
    for _ in range(sp.n_nodes):
        nxt = _step(step_map, p, flags)
        p = torch.where(sp.tau[nxt] <= age, nxt, p)
    return p


def assign_populations_net(gt: GTrees, sp: SpeciesArrays, tip_pop):
    """Populations of every gene node on an MSC-I network, ``[L, N]``.

    An inner node's population is its left child's route read at the
    node's age; that the right child's route reaches the same population
    is checked apart, by :func:`route_consistent`."""
    L = gt.left.shape[0]
    T = gt.n_tips
    lidx = torch.arange(L, device=gt.left.device)
    order = inner_order(gt)
    # made from the state, so that inside the batched step (vmap) it
    # carries the chain axis the node writes below take
    pops = torch.zeros_like(gt.left, dtype=torch.int64)
    pops[:, :T] = tip_pop
    for k in range(T - 1):
        node = order[:, k]
        lc = gt.left[lidx, node]
        pops[lidx, node] = lift_population_net(
            sp, pops[lidx, lc], gt.age[lidx, node], gt.hpath[lidx, lc])
    return pops


def route_consistent(gt: GTrees, sp: SpeciesArrays, pops, n_seq):
    """``[L]`` bool: at every valid coalescence the right child's route
    reaches the population of the left child's (the MSC-I state-validity
    indicator, which the reference keeps structurally)."""
    L, N = gt.left.shape
    T = gt.n_tips
    dev = pops.device
    lidx = torch.arange(L, device=dev)[:, None]
    nodes = torch.arange(N, device=dev)[None, :]
    is_inner = (nodes >= T) & (nodes < T + n_seq[:, None] - 1)
    rc = gt.right
    pr = lift_population_net(sp, pops[lidx, rc], gt.age, gt.hpath[lidx, rc])
    return torch.where(is_inner, pr == pops, True).all(dim=1)


def edge_passes(gt: GTrees, sp: SpeciesArrays, pops):
    """``[L, N, H]`` bool: the populations each edge's route visits.

    The edge of node u spans ``[age_u, age_parent_u)`` and starts in
    ``pops[u]``; it climbs along u's flags up to the population that holds
    the parent's age (the root edge climbs to the species root)."""
    H = sp.n_nodes
    dev = pops.device
    page = torch.where(gt.parent >= 0,
                       torch.gather(gt.age, 1, gt.parent.clamp(min=0)),
                       torch.full_like(gt.age, float("inf")))
    step_map = _step_map(sp)
    hs = torch.arange(H, device=dev)
    p = pops
    mark = pops[..., None] == hs
    for _ in range(H):
        nxt = _step(step_map, p, gt.hpath)
        p = torch.where(sp.tau[nxt] < page, nxt, p)
        # where the step is not taken p stays put, marked already
        mark = mark | (p[..., None] == hs)
    return mark


# --- host-side initial simulation from the MSC prior ---------------------------


def host_bdi_mirror(st):
    """[NSt] bool mask of BDI mirror nodes of a host SpeciesTree, or
    None when the tree has no bidirectional introgressions."""
    if getattr(st, "bdi", None) is None or not (st.bdi >= 0).any():
        return None
    m = np.zeros(st.n_nodes, bool)
    for i in range(st.n_nodes):
        if st.bdi[i] >= 0:
            m[st.hybrid[i]] = True
    return m


def simulate_gtree_host(
    rng: np.random.Generator,
    tip_species: np.ndarray,       # [n] species tip index per sequence
    st_left, st_right, st_parent,  # species tree arrays
    tau, theta,
    hindex=None, hybrid=None, phi=None,   # MSC-I network arrays
    tip_ages=None,                 # [n] serial-sampling tip ages (dating)
    bdi_mirror=None,               # [H] bool: zero-width BDI mirrors
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray | None]:
    """Simulate one gene tree from the MSC prior (gtree.c:2242 analog).

    Copied from ``bpp_tpu/trees/gtree.py`` (numpy).  Returns (left,
    right, parent, age, hpath) over ``2n-1`` nodes, tips first; hpath is
    None for plain trees, else ``[2n-1, HY]`` int8 with the
    hybridization side each lineage edge took.
    """
    n = len(tip_species)
    H = len(st_parent)
    nnodes = 2 * n - 1
    left = np.full(nnodes, 0, np.int32)
    right = np.full(nnodes, 0, np.int32)
    parent = np.full(nnodes, -1, np.int32)
    age = np.zeros(nnodes, np.float64)
    hy = 0 if hindex is None else int(hindex.max(initial=-1)) + 1
    hpath = np.zeros((nnodes, hy), np.int8) if hy else None
    if tip_ages is None:
        tip_ages = np.zeros(n)
    age[:n] = tip_ages

    lineages: dict[int, list[int]] = {h: [] for h in range(H)}
    pending: dict[int, list[int]] = {h: [] for h in range(H)}
    for i, spx in enumerate(tip_species):
        if tip_ages[i] > 0:
            pending[int(spx)].append(i)
        else:
            lineages[int(spx)].append(i)
    for h in pending:
        pending[h].sort(key=lambda i: tip_ages[i])

    def _mirror_first(h):
        return 0 if (bdi_mirror is not None and bdi_mirror[h]) else 1

    epoch_order = sorted(range(H), key=lambda h: (tau[h], _mirror_first(h),
                                                  h))
    next_node = n
    t_now = {h: tau[h] for h in range(H)}

    def coalesce_in(h: int, t_end: float):
        nonlocal next_node
        t = t_now[h]
        while pending[h] and tip_ages[pending[h][0]] <= t:
            lineages[h].append(pending[h].pop(0))
        while True:
            t_act = tip_ages[pending[h][0]] if pending[h] else np.inf
            k = len(lineages[h])
            if k > 1:
                rate = k * (k - 1) / max(theta[h], 1e-300)
                t_next = t + rng.exponential(1.0 / rate)
                if t_next < min(t_act, t_end):
                    i, j = rng.choice(k, size=2, replace=False)
                    a, b = lineages[h][i], lineages[h][j]
                    node = next_node
                    next_node += 1
                    left[node], right[node] = a, b
                    parent[a] = parent[b] = node
                    age[node] = t_next
                    lineages[h] = [x for x in lineages[h]
                                   if x not in (a, b)]
                    lineages[h].append(node)
                    t = t_next
                    continue
            if t_act < t_end:
                t = t_act
                while pending[h] and tip_ages[pending[h][0]] <= t:
                    lineages[h].append(pending[h].pop(0))
                continue
            break
        t_now[h] = t_end
        p = st_parent[h]
        if p >= 0 and pending[h]:
            pending[p].extend(pending[h])
            pending[p].sort(key=lambda i: tip_ages[i])
            pending[h] = []

    for h in epoch_order:
        p = st_parent[h]
        t_end = tau[p] if p >= 0 else np.inf
        coalesce_in(h, t_end)
        if p >= 0:
            if hy and hindex[p] >= 0 and hybrid[p] >= 0 and not (
                    bdi_mirror is not None and bdi_mirror[h]):
                slot = int(hindex[p])
                mirror = int(hybrid[p])
                for u in lineages[h]:
                    if rng.random() < phi[p]:
                        hpath[u, slot] = 0
                        lineages[p].append(u)
                    else:
                        hpath[u, slot] = 1
                        lineages[mirror].append(u)
            else:
                lineages[p].extend(lineages[h])
            lineages[h] = []
    assert next_node == nnodes, "simulation did not fully coalesce"
    return left, right, parent, age, hpath


def init_gtrees(seed: int, batch, st, dtype=torch.float64,
                device="cpu", tip_ages=None) -> GTrees:
    """Simulate starting gene trees for every locus (incl. padded ones)
    on the host, with the same numpy stream as ``bpp_tpu``; on a network
    with the hybridization flags each edge took.  ``tip_ages`` ``[L, T]``
    are the ages of dated tips (tip dating)."""
    rng = np.random.default_rng(seed)
    L, T = batch.n_loci, batch.max_tips
    N = 2 * T - 1
    hy = st.n_hybrids
    left = np.zeros((L, N), np.int64)
    right = np.zeros((L, N), np.int64)
    parent = np.full((L, N), -1, np.int64)
    age = np.full((L, N), BIG_AGE, np.float64)
    age[:, :T] = 0.0 if tip_ages is None else tip_ages
    hpath = np.zeros((L, N, hy), np.int8) if hy else None
    theta = np.maximum(st.theta, 1e-6)
    bdi_mirror = host_bdi_mirror(st)
    for li in range(L):
        n = int(batch.n_seq[li])
        gl, gr, gp, ga, gh = simulate_gtree_host(
            rng, batch.tip_pop[li, :n], st.left, st.right, st.parent,
            st.tau, theta, hindex=st.hindex, hybrid=st.hybrid, phi=st.phi,
            tip_ages=None if tip_ages is None else tip_ages[li, :n],
            bdi_mirror=bdi_mirror)
        # local inner ids n..2n-2 -> global T..T+n-2
        local = np.arange(2 * n - 1)
        gmap = np.where(local < n, local, local - n + T)
        parent[li, gmap] = np.where(gp >= 0, gmap[np.maximum(gp, 0)], -1)
        age[li, gmap] = ga
        inner = np.arange(n, 2 * n - 1)
        left[li, gmap[inner]] = gmap[gl[inner]]
        right[li, gmap[inner]] = gmap[gr[inner]]
        if gh is not None:
            hpath[li, gmap] = gh

    def t(a, dt=None):
        return torch.as_tensor(a, dtype=dt, device=device)

    return GTrees(left=t(left), right=t(right), parent=t(parent),
                  age=t(age, dtype),
                  hpath=None if hpath is None else t(hpath))
