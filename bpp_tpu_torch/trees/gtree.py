"""Batched gene-tree state and topology operations (PyTorch).

Port of ``bpp_tpu/trees/gtree.py``, main-path subset: plain species
trees (no MSC-I network routing).  Per-locus gene trees live in
fixed-shape ``[L, N]`` index tensors; a gene node's population is the
ancestor of the species-MRCA of its descendant tips whose tau interval
contains the node age.  The one-hot gather/scatter forms the TPU needed
are plain indexing here, and the age-sorted schedule is a stable sort.
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
    """Species-tree state on the device (plain trees).

    Node indexing: tips ``0..NS-1``, inner ``NS..2NS-2`` with the root
    last; ``pptable[i, j]`` is True iff j is i or an ancestor of i;
    ``mrca[i, j]`` is the species MRCA.
    """

    left: torch.Tensor      # [H] int64
    right: torch.Tensor     # [H] int64
    parent: torch.Tensor    # [H] int64 (-1 root)
    tau: torch.Tensor       # [H] float
    theta: torch.Tensor     # [H] float
    pptable: torch.Tensor   # [H, H] bool
    mrca: torch.Tensor      # [H, H] int64

    @property
    def n_nodes(self):
        return self.left.shape[0]

    @property
    def n_tips(self):
        return (self.left.shape[0] + 1) // 2

    @property
    def root(self):
        return self.left.shape[0] - 1


def species_arrays(st, dtype=torch.float64, device="cpu") -> SpeciesArrays:
    """Build device tensors from a host-side SpeciesTree."""
    if st.n_hybrids > 0:
        raise NotImplementedError(
            "MSC-I networks are not ported yet (ROADMAP Queue 1 item 10f)")

    def idx(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    return SpeciesArrays(
        left=idx(st.left), right=idx(st.right), parent=idx(st.parent),
        tau=torch.as_tensor(np.asarray(st.tau, np.float64), dtype=dtype,
                            device=device),
        theta=torch.as_tensor(np.asarray(st.theta, np.float64), dtype=dtype,
                              device=device),
        pptable=torch.as_tensor(st.pptable(), device=device),
        mrca=idx(st.mrca_table()),
    )


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
    buf = torch.zeros((L, gt.n_nodes), dtype=tip_vals.dtype,
                      device=tip_vals.device)
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
    """Population of every gene node from ages alone: ``[L, N]``."""
    msp = mrca_species(gt, sp, tip_pop)
    age = gt.age.clamp(0.0, BIG_AGE * 0.5)      # padded slots -> root pop
    return lift_population(sp, msp, age)


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
    on the host, with the same numpy stream as ``bpp_tpu``.  ``tip_ages``
    ``[L, T]`` are the ages of dated tips (tip dating)."""
    if st.n_hybrids > 0:
        raise NotImplementedError(
            "MSC-I networks are not ported yet (ROADMAP Queue 1 item 10f)")
    rng = np.random.default_rng(seed)
    L, T = batch.n_loci, batch.max_tips
    N = 2 * T - 1
    left = np.zeros((L, N), np.int64)
    right = np.zeros((L, N), np.int64)
    parent = np.full((L, N), -1, np.int64)
    age = np.full((L, N), BIG_AGE, np.float64)
    age[:, :T] = 0.0 if tip_ages is None else tip_ages
    theta = np.maximum(st.theta, 1e-6)
    for li in range(L):
        n = int(batch.n_seq[li])
        gl, gr, gp, ga, _ = simulate_gtree_host(
            rng, batch.tip_pop[li, :n], st.left, st.right, st.parent,
            st.tau, theta,
            tip_ages=None if tip_ages is None else tip_ages[li, :n])
        # local inner ids n..2n-2 -> global T..T+n-2
        local = np.arange(2 * n - 1)
        gmap = np.where(local < n, local, local - n + T)
        parent[li, gmap] = np.where(gp >= 0, gmap[np.maximum(gp, 0)], -1)
        age[li, gmap] = ga
        inner = np.arange(n, 2 * n - 1)
        left[li, gmap[inner]] = gmap[gl[inner]]
        right[li, gmap[inner]] = gmap[gr[inner]]

    def t(a, dt=None):
        return torch.as_tensor(a, dtype=dt, device=device)

    return GTrees(left=t(left), right=t(right), parent=t(parent),
                  age=t(age, dtype))
