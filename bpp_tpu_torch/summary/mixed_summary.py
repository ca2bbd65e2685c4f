"""Copied from ``bpp_tpu/summary/mixed_summary.py`` (numpy / pure
Python, unchanged) so that the PyTorch port never loads that package.

A11 joint tree + delimitation summary (src/summary11.c mixed_summary).

Each sample is reduced to its *delimited tree*: collapsed nodes
(tau == 0) merge their subtree tips into one species unit; the
canonical newick over units identifies the joint model.  Reports
posterior per delimited tree, per #species, and per species-unit
composition.
"""

from __future__ import annotations

from collections import Counter

import numpy as np


def delimited_newick(left, right, parent, tau, names) -> str:
    ns = len(names)
    root = int(np.nonzero(np.asarray(parent) < 0)[0][0])

    def tipset(i):
        if i < ns:
            return [names[i]]
        return tipset(int(left[i])) + tipset(int(right[i]))

    def rec(i):
        if i < ns:
            return names[i]
        if tau[i] <= 0:                      # collapsed: one species unit
            return "".join(sorted(tipset(i)))
        a, b = rec(int(left[i])), rec(int(right[i]))
        return "(" + ",".join(sorted([a, b])) + ")"

    return rec(root) + ";"


def n_units(left, right, parent, tau, ns) -> int:
    H = len(left)
    return 1 + int(sum(1 for i in range(ns, H) if tau[i] > 0))


def summarize_mixed(sptrees, tau_samples, names):
    trees: Counter = Counter()
    nsp: Counter = Counter()
    for (l, r, p), tau in zip(sptrees, tau_samples):
        trees[delimited_newick(l, r, p, tau, names)] += 1
        nsp[n_units(l, r, p, tau, len(names))] += 1
    return trees, nsp


def format_a11_summary(trees, nsp, n) -> str:
    lines = [f"Joint species-delimitation + tree posterior ({n} samples)", ""]
    lines.append(f"{'P':>9} {'cum':>9}  delimited tree")
    cum = 0.0
    for t, cnt in trees.most_common():
        p = cnt / n
        cum += p
        lines.append(f"{p:9.5f} {cum:9.5f}  {t}")
        if cum > 0.99 and len(lines) > 30:
            lines.append(f"   ... ({len(trees)} distinct models)")
            break
    lines.append("")
    lines.append(f"{'P':>9}  #species")
    for k in sorted(nsp):
        lines.append(f"{nsp[k] / n:9.5f}  {k}")
    return "\n".join(lines)
