"""Copied from ``bpp_tpu/output.py`` (numpy / pure Python, unchanged but for
its imports and the SIMPLE clock's rate columns, which are every node of a
plain species tree here) so that the PyTorch port never loads that
package.

Run outputs: mcmc.txt sample log and the A00 summary report.

Matches the reference's file layout (``src/method.c``
``mcmc_printheader:1851`` / ``mcmc_logsample:2339``): tab-separated
``Gen  theta:i:label ...  tau:i:label ...  lnL`` with BPP's node
numbering (tips 1..NS in control-file order; inner nodes numbered
pre-order from the root, which gets index NS+1).
"""

from __future__ import annotations

import numpy as np

from .config import BppConfig, Method
from .summary.allfixed import format_summary, summary_table
from .trees.stree import SpeciesTree


def bpp_inner_order(st: SpeciesTree) -> list[int]:
    """Non-mirror inner nodes in BPP output order: pre-order from the
    root (MSC-I hinner nodes are unary: right == -1)."""
    order = []

    def rec(i: int):
        if st.left[i] == -1:
            return
        order.append(i)
        rec(st.left[i])
        if st.right[i] != -1:
            rec(st.right[i])

    if st.n_tips > 1:
        rec(st.root)
    return order


def bdi_mirror_set(st: SpeciesTree) -> set:
    """Indices of BDI mirror nodes (zero-width populations: no theta
    column, phi displayed on the mirror like the reference)."""
    out = set()
    if getattr(st, "bdi", None) is not None:
        for i in range(st.n_nodes):
            if st.bdi[i] >= 0:
                out.add(int(st.hybrid[i]))
    return out


def has_theta_mask(cfg: BppConfig, st: SpeciesTree) -> list[bool]:
    """Which nodes carry a theta parameter (stree_init_theta
    stree.c:2610-2680):

    * tips need >= 2 effective sequences (diploid phase doubles the
      count) unless involved in a migration route or geneflow rjMCMC,
    * MSC-I hinner/mirror sides carry a theta iff their htau == 1
      (zero-width populations have none); BDI mirrors never do,
    * ordinary inner nodes always do.
    """
    NS = st.n_tips
    out = [True] * st.n_nodes
    eff = []
    if cfg.species is not None:
        for i in range(NS):
            n = cfg.species.max_seqs[i] if i < len(cfg.species.max_seqs) \
                else 2
            if i < len(cfg.phase) and cfg.phase[i]:
                n *= 2
            eff.append(n)
    else:
        eff = [2] * NS
    mig_names = set()
    for spec in cfg.mig_specs:
        mig_names.add(spec.source)
        mig_names.add(spec.target)
    for i in range(NS):
        involved = cfg.geneflow or st.names[i] in mig_names
        out[i] = involved or eff[i] >= 2
    if st.hindex is not None:
        bdi_m = bdi_mirror_set(st)
        for i in range(st.n_nodes):
            if st.hindex[i] >= 0:
                if i in bdi_m:
                    out[i] = False
                elif getattr(st, "bdi", None) is not None \
                        and st.bdi[i] >= 0:
                    out[i] = True               # BDI hinner
                else:
                    out[i] = bool(st.htau[i])
    return out


def output_nodes(cfg: BppConfig, st: SpeciesTree, inner: list[int]):
    """(theta_nodes, tau_nodes, phi_cols) in reference column order.

    ``phi_cols`` lists the DISPLAY node per hybridization slot: the
    hinner for plain hybridizations, the mirror for BDI (method.c
    has_phi selection; BDI mirrors carry the phi, method.c:541).
    """
    bdi_m = bdi_mirror_set(st)
    mirrors = [m for m in range(st.n_tips + st.n_inner, st.n_nodes)
               if m not in bdi_m]
    has_th = has_theta_mask(cfg, st)
    theta_nodes = [i for i in list(range(st.n_tips)) + inner + mirrors
                   if has_th[i]]
    if cfg.theta_integrated:
        theta_nodes = []
    elif cfg.linked_theta:
        # linked thetas: only group owners carry a column
        # (method.c:2395 "linked_theta == NULL" check)
        from .trees.stree import theta_link_map
        owner = theta_link_map(st, cfg.linked_theta)
        theta_nodes = [i for i in theta_nodes if owner[i] == i]
    tau_nodes = list(inner)
    phi_cols = []
    if st.hindex is not None:
        for m in range(st.n_tips + st.n_inner, st.n_nodes):
            hin = int(st.hybrid[m])
            phi_cols.append(m if m in bdi_m else hin)
    return theta_nodes, tau_nodes, phi_cols


def node_label(st: SpeciesTree, i: int) -> str:
    """Reference-style node name: the newick label when one was given,
    else the comma-join of the child labels (method.c print headers)."""
    if st.labels is not None and st.labels[i]:
        return st.labels[i]
    if i < st.n_tips:
        return st.names[i]
    parts = [node_label(st, int(st.left[i]))]
    if st.right[i] != -1:
        parts.append(node_label(st, int(st.right[i])))
    return ",".join(parts)


class McmcWriter:
    """Streams samples to <jobname>.mcmc.txt in the reference layout."""

    def __init__(self, path: str, cfg: BppConfig, st: SpeciesTree,
                 append: bool = False):
        self.cfg = cfg
        self.st = st
        self.fp = open(path, "a" if append else "w")
        self.inner = bpp_inner_order(st)
        self._anc = st.pptable()
        # node output order: all nodes with theta (tips, inner pre-order,
        # then MSC-I mirror nodes minus theta-less BDI mirrors); phi
        # columns per hybridization slot (method.c:1928-1936
        # "phi:h<-p:lab<-lab"; BDI displays the mirror)
        self.theta_nodes, self.tau_nodes, self.phi_nodes = output_nodes(
            cfg, st, self.inner)
        # migration-rate columns (method.c:1999 "W:%d->%d:%s->%s")
        self.mig_routes = []
        if cfg.migration:
            from .trees.migration import build_routes, build_routes_geneflow
            if cfg.geneflow:
                # geneflow rjMCMC: one column per CANDIDATE route;
                # inactive samples print 0 so P(route on) and E[M | on]
                # fall out of the trace (the reference writes ragged
                # name=value pairs for active routes, method.c:2477)
                r, _ = build_routes_geneflow(cfg, st)
            else:
                r = build_routes(cfg, st)
            self.mig_routes = list(zip(r.si.tolist(), r.ti.tolist()))
        # tip dating (locusrate = 3 + datefile): overall rate mu_bar
        # plus calendar-unit taus r_tau = tau/mu_bar (method.c:1944-1960)
        self.dated = bool(cfg.datefile) and cfg.est_locusrate == 3
        # relaxed-clock columns (method.c:1938-1988): mu_bar for the
        # hierarchical locus-rate mean; one nu_bar (hierarchical) or nu
        # (mean nu_i) column for clock 2/3; per-branch r: columns for
        # the SIMPLE clock (rate nodes only)
        from .config import Clock
        self.mubar_h = (cfg.est_locusrate == 1 and cfg.locusrate_prior == 1
                        and cfg.locusrate_mubar_est)
        self.clock_simple = cfg.clock == Clock.SIMPLE
        self.clock_relaxed = cfg.clock != Clock.GLOBAL
        self._nu_bar_col = cfg.locusrate_prior == 1
        self.rate_nodes = []
        if self.clock_simple:
            # the rate-carrying populations, in output order (a network's
            # zero-length segments and BDI mirrors carry none)
            from .trees.gtree import species_arrays
            rn = species_arrays(st).rate_nodes
            rn = (np.ones(st.n_nodes, bool) if rn is None
                  else rn.cpu().numpy())
            order = (list(range(st.n_tips)) + self.inner
                     + list(range(st.n_tips + st.n_inner, st.n_nodes)))
            self.rate_nodes = [i for i in order if rn[i]]
        if not append:
            self._write_header()
        else:
            self.columns = self._header_cols()

    def _header_cols(self):
        cols = ["Gen"]
        for i in self.theta_nodes:
            cols.append(f"theta:{self._bpp_index(i)}:{self._label(i)}")
        for i in self.tau_nodes:
            cols.append(f"tau:{self._bpp_index(i)}:{self._label(i)}")
        for i in self.phi_nodes:
            p = int(self.st.parent[i])
            cols.append(f"phi:{self._bpp_index(i)}<-{self._bpp_index(p)}"
                        f":{self._label(i)}<-{self._label(p)}")
        if self.dated:
            cols.append("mu_bar")
            for i in self.tau_nodes:
                cols.append(f"r_tau:{self._bpp_index(i)}:{self._label(i)}")
        if self.mubar_h:
            cols.append("mu_bar")
        if self.clock_relaxed:
            if self.clock_simple:
                for i in self.rate_nodes:
                    cols.append(f"r:{self._bpp_index(i)}:{self._label(i)}")
            else:
                cols.append("nu_bar" if self._nu_bar_col else "nu")
        for s, t in self.mig_routes:
            cols.append(f"W:{self._bpp_index(s)}->{self._bpp_index(t)}"
                        f":{self._label(s)}->{self._label(t)}")
        cols.append("lnL")
        return cols

    def _bpp_index(self, i: int) -> int:
        """1-based output index: tips keep their index; inner nodes are
        numbered NS+1.. in pre-order; mirrors follow the inner nodes."""
        st = self.st
        if i < st.n_tips:
            return i + 1
        if i >= st.n_tips + st.n_inner:          # mirror
            return st.n_tips + len(self.inner) + 1 + (
                i - st.n_tips - st.n_inner)
        return st.n_tips + 1 + self.inner.index(i)

    def _label(self, i: int) -> str:
        return node_label(self.st, i)

    def _write_header(self):
        cols = self._header_cols()
        self.fp.write("\t".join(cols) + "\n")
        self.columns = cols

    def write_sample(self, gen: int, theta: np.ndarray, tau: np.ndarray,
                     lnl: float, phi: np.ndarray | None = None,
                     migM: np.ndarray | None = None,
                     mubar: float | None = None,
                     mubar_h: float | None = None,
                     nu_col: float | None = None,
                     brate0: np.ndarray | None = None):
        vals = [str(gen)]
        vals += [f"{theta[i]:.6f}" for i in self.theta_nodes]
        prec = 10 if self.dated else 6           # method.c:2401
        vals += [f"{tau[i]:.{prec}f}" for i in self.tau_nodes]
        vals += [f"{phi[i]:.6f}" for i in self.phi_nodes]
        if self.dated and mubar is not None:
            vals.append(f"{mubar:.12f}")
            vals += [f"{tau[i] / mubar:.6f}" for i in self.tau_nodes]
        if self.mubar_h:
            vals.append(f"{mubar_h:.6f}" if mubar_h is not None else "nan")
        if self.clock_relaxed:
            if self.clock_simple:
                vals += ([f"{brate0[i]:.6f}" for i in self.rate_nodes]
                         if brate0 is not None
                         else ["nan"] * len(self.rate_nodes))
            else:
                vals.append(f"{nu_col:.6f}" if nu_col is not None else "nan")
        if migM is not None:
            vals += [f"{m:.6f}" for m in migM]
        vals.append(f"{lnl:.3f}")
        self.fp.write("\t".join(vals) + "\n")

    def close(self):
        self.fp.close()


def species_newick(left, right, parent, tau, names) -> str:
    """Newick with branch lengths from taus (A01 sample lines,
    method.c mcmc_logsample tree output)."""
    ns = len(names)
    root = int(np.nonzero(np.asarray(parent) < 0)[0][0])

    def rec(i):
        if i < ns:
            s = names[i]
            h = 0.0
        else:
            a, ha = rec(int(left[i]))
            b, hb = rec(int(right[i]))
            s = f"({a}, {b})"
            h = float(tau[i])
            s_a, s_b = sorted([f"{a}", f"{b}"])
            s = f"({s_a}, {s_b})"
        p = int(parent[i])
        if p >= 0:
            s += f": {float(tau[p]) - h:.6f}"
        return s, h

    return rec(root)[0] + ";"


class A01McmcWriter:
    """Streams A01 samples: one newick per line (mcmc_logsample)."""

    def __init__(self, path: str, cfg: BppConfig, st: SpeciesTree,
                 append: bool = False):
        self.fp = open(path, "a" if append else "w")
        self.names = st.names

    def write_sample(self, gen, left, right, parent, tau):
        self.fp.write(species_newick(left, right, parent, tau,
                                     self.names) + "\n")

    def close(self):
        self.fp.close()


def read_mcmc_samples(cfg: BppConfig, st: SpeciesTree, path: str):
    """Parse a <jobname>.mcmc.txt back into sample arrays (resume path:
    the summary must cover pre-checkpoint samples too).

    Returns (gen, theta [n,H], tau [n,H], lnl, sptrees, phi [n,H]|None)
    with sptrees a list of (left, right, parent) for A01/A11 else [].
    """
    H = st.n_nodes
    gen, thetas, taus, lnls, sptrees = [], [], [], [], []
    if cfg.est_stree:
        from .io.newick import parse_newick
        with open(path) as fh:
            g = 0
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                root = parse_newick(line)
                left = np.full(H, -1, np.int64)
                right = np.full(H, -1, np.int64)
                parent = np.full(H, -1, np.int64)
                tau = np.zeros(H)
                nxt = [st.n_tips]

                def rec(node):
                    if node.is_leaf:
                        i = st.names.index(node.label)
                        h = 0.0
                    else:
                        a, ha = rec(node.children[0])
                        b, hb = rec(node.children[1])
                        i = nxt[0]
                        nxt[0] += 1
                        left[i], right[i] = a, b
                        parent[a] = parent[b] = i
                        h = ha + (node.children[0].length or 0.0)
                        tau[i] = h
                    return i, h

                rec(root)
                g += cfg.sampfreq
                gen.append(g)
                taus.append(tau)
                thetas.append(np.zeros(H))
                lnls.append(0.0)
                sptrees.append((left, right, parent))
        return (np.asarray(gen), np.stack(thetas) if thetas else
                np.zeros((0, H)), np.stack(taus) if taus else
                np.zeros((0, H)), np.asarray(lnls), sptrees, None)

    inner = bpp_inner_order(st)
    theta_nodes, tau_nodes, phi_nodes = output_nodes(cfg, st, inner)
    phis = []
    with open(path) as fh:
        header = fh.readline()
        for line in fh:
            parts = line.split()
            if len(parts) < 2:
                continue
            gen.append(int(parts[0]))
            vals = [float(x) for x in parts[1:]]
            th = np.zeros(H)
            ta = np.zeros(H)
            for k, i in enumerate(theta_nodes):
                th[i] = vals[k]
            off = len(theta_nodes)
            for k, i in enumerate(tau_nodes):
                ta[i] = vals[off + k]
            off += len(tau_nodes)
            ph = np.zeros(H)
            for k, i in enumerate(phi_nodes):
                ph[i] = vals[off + k]
                m = int(st.hybrid[i])
                ph[m] = 1.0 - vals[off + k]
            taus.append(ta)
            thetas.append(th)
            phis.append(ph)
            lnls.append(vals[-1])
    return (np.asarray(gen), np.stack(thetas) if thetas else np.zeros((0, H)),
            np.stack(taus) if taus else np.zeros((0, H)),
            np.asarray(lnls), sptrees,
            np.stack(phis) if (phis and phi_nodes) else None)


def a00_summary(cfg: BppConfig, st: SpeciesTree, gen, theta, tau, lnl,
                phi=None, migM=None, mubar=None) -> str:
    """Posterior summary text for an A00 run (allfixed.c analog)."""
    inner = bpp_inner_order(st)
    cols: dict[str, np.ndarray] = {}
    mirror0 = st.n_tips + st.n_inner
    theta_nodes, _, phi_cols = output_nodes(cfg, st, inner)
    for i in theta_nodes:
        if i < st.n_tips:
            idx = i + 1
        elif i < mirror0:
            idx = st.n_tips + 1 + inner.index(i)
        else:
            idx = st.n_tips + len(inner) + 1 + (i - mirror0)
        cols[f"theta:{idx}"] = theta[:, i]
    for i in inner:
        if tau[:, i].max() > 0:
            cols[f"tau:{st.n_tips + 1 + inner.index(i)}"] = tau[:, i]
    if phi is not None and st.hindex is not None:
        for i in phi_cols:
            idx = (st.n_tips + 1 + inner.index(i) if i < mirror0
                   else st.n_tips + len(inner) + 1 + (i - mirror0))
            cols[f"phi:{idx}"] = phi[:, i]
    if mubar is not None and len(mubar):
        mubar = np.asarray(mubar)
        cols["mu_bar"] = mubar
        for i in inner:
            if tau[:, i].max() > 0:
                cols[f"r_tau:{st.n_tips + 1 + inner.index(i)}"] = \
                    tau[:, i] / mubar
    if migM is not None and cfg.migration:
        from .trees.migration import build_routes
        r = build_routes(cfg, st)
        for k in range(r.n_routes):
            cols[f"W:{node_label(st, int(r.si[k]))}->"
                 f"{node_label(st, int(r.ti[k]))}"] = migM[:, k]
    cols["lnL"] = np.asarray(lnl)
    return format_summary(summary_table(cols))


def figtree_export(st: SpeciesTree, tau_mean, tau_hpd_lo, tau_hpd_hi,
                   theta_mean) -> str:
    """FigTree.tre (allfixed.c:571-717): species tree with posterior-
    mean taus as branch lengths, per-node 95% HPD bars and theta
    labels."""
    def rec(i):
        h = float(tau_mean[i]) if i >= st.n_tips else 0.0
        if i < st.n_tips:
            s = st.names[i]
        else:
            a, _ = rec(int(st.left[i]))
            b, _ = rec(int(st.right[i]))
            lab = "|".join(
                st.names[j] for j in range(st.n_tips)
                if st.pptable()[j, i])
            s = (f"({a}, {b}){lab}"
                 f"[&height_95%_HPD={{{tau_hpd_lo[i]:.8f}, "
                 f"{tau_hpd_hi[i]:.8f}}}, theta={theta_mean[i]:.7f}]")
        p = int(st.parent[i])
        if p >= 0:
            s += f": {float(tau_mean[p]) - h:.6f}"
        return s, h

    body = rec(st.root)[0]
    return ("#NEXUS\nBEGIN TREES;\n\tUTREE 1 = " + body + ";\nEND;\n\n"
            "[Species tree with tau as branch lengths and theta as "
            "labels, for FigTree.\nIn FigTree, choose 95%HPD for Node "
            "Bars and label for Node Labels]\n")


def gene_tree_newick(left, right, parent, age, labels, n_seq) -> str:
    """One locus's gene tree as newick with time branch lengths
    (print_gtree, method.c:5860 sample logging)."""
    T = (len(left) + 1) // 2
    root = int(np.argmax(age[T:T + n_seq - 1])) + T if n_seq > 1 else 0

    def rec(u):
        if u < n_seq:
            s = labels[u]
        else:
            a = rec(int(left[u]))
            b = rec(int(right[u]))
            s = f"({a}, {b})"
        p = int(parent[u])
        if p >= 0 and u != root:
            s += f":{float(age[p] - age[u]):.6f}"
        return s

    return rec(root) + ";"
