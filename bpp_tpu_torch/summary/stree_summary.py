"""Copied from ``bpp_tpu/summary/stree_summary.py`` (numpy / pure
Python, unchanged) so that the PyTorch port never loads that package.

A01 species-tree posterior summary (src/summary.c analog).

Computes, from sampled species trees:
  * posterior probability of each sampled topology (best trees list,
    ``stree_summary`` summary.c:677),
  * split (bipartition) posteriors (``bipartitions_init`` summary.c:151),
  * the majority-rule consensus tree with support values.
"""

from __future__ import annotations

from collections import Counter, defaultdict

import numpy as np


def canonical_newick(left, right, parent, names, tau=None) -> str:
    """Canonical (sorted-children) newick; lengths omitted."""
    ns = len(names)
    root = int(np.nonzero(np.asarray(parent) < 0)[0][0])

    def rec(i):
        if i < ns:
            return names[i]
        a, c = rec(int(left[i])), rec(int(right[i]))
        return "(" + ",".join(sorted([a, c])) + ")"

    return rec(root) + ";"


def _clades(left, right, parent, ns):
    """Set of clades (frozensets of tip ids) for the inner nodes."""
    H = len(left)
    below = [set() for _ in range(H)]
    for t in range(ns):
        below[t] = {t}
    order = sorted(range(ns, H), key=lambda i: _depth(parent, i),
                   reverse=True)
    clades = []
    for i in order:
        below[i] = below[int(left[i])] | below[int(right[i])]
        if len(below[i]) < ns:          # skip the root clade
            clades.append(frozenset(below[i]))
    return clades


def _depth(parent, i):
    d = 0
    while parent[i] >= 0:
        i = int(parent[i])
        d += 1
    return d


def summarize_sptrees(sptrees, names):
    """sptrees: list of (left, right, parent) numpy triples."""
    ns = len(names)
    topo_counts: Counter = Counter()
    first_tree: dict = {}
    clade_counts: Counter = Counter()
    n = len(sptrees)
    for (l, r, p) in sptrees:
        key = canonical_newick(l, r, p, names)
        topo_counts[key] += 1
        if key not in first_tree:
            first_tree[key] = (l, r, p)
        for cl in _clades(l, r, p, ns):
            clade_counts[cl] += 1
    return topo_counts, clade_counts, n


def majority_consensus(clade_counts, n_samples, names):
    """Greedy majority-rule consensus newick with support labels."""
    ns = len(names)
    accepted: list[frozenset] = []
    for cl, cnt in sorted(clade_counts.items(), key=lambda kv: -kv[1]):
        if cnt * 2 <= n_samples:
            break
        if all(cl <= o or o <= cl or not (cl & o) for o in accepted):
            accepted.append(cl)

    # build the consensus tree from nested clades
    support = {cl: clade_counts[cl] / n_samples for cl in accepted}
    all_tips = frozenset(range(ns))

    def build(clade):
        children = []
        used: set = set()
        # maximal accepted sub-clades
        for cl in sorted(accepted, key=lambda c: -len(c)):
            if cl < clade and not (cl & used):
                children.append(cl)
                used |= cl
        singles = sorted(clade - used)
        parts = [build(c) for c in children] + [names[t] for t in singles]
        parts.sort()
        s = "(" + ",".join(parts) + ")"
        if clade in support:
            s += f" #{support[clade]:.6f}"
        return s

    return build(all_tips) + ";"


def format_a01_summary(topo_counts, clade_counts, n, names) -> str:
    lines = [f"Species tree posterior ({n} samples)", ""]
    lines.append(f"{'P':>9} {'cum':>9}  tree")
    cum = 0.0
    for topo, cnt in topo_counts.most_common():
        p = cnt / n
        cum += p
        lines.append(f"{p:9.5f} {cum:9.5f}  {topo}")
        if cum > 0.99 and len(lines) > 25:
            lines.append(f"   ... ({len(topo_counts)} distinct topologies)")
            break
    lines.append("")
    lines.append("Split (clade) posteriors:")
    ns = len(names)
    for cl, cnt in clade_counts.most_common():
        if cnt / n < 0.01:
            break
        tips = ",".join(names[t] for t in sorted(cl))
        lines.append(f"{cnt / n:9.5f}  ({tips})")
    lines.append("")
    lines.append("Majority-rule consensus:")
    lines.append(majority_consensus(clade_counts, n, names))
    return "\n".join(lines)
