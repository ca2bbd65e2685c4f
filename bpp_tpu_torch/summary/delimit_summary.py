"""Copied from ``bpp_tpu/summary/delimit_summary.py`` (numpy / pure
Python, unchanged) so that the PyTorch port never loads that package.

A10 delimitation posterior summary (src/delimit.c delimit_summary).

A delimitation is the binary split-vector over inner guide-tree nodes
(tau > 0), written in BPP's order (pre-order from the root, matching
``delimitation_getparam_string``).  Reports posterior per model and per
number of species.
"""

from __future__ import annotations

from collections import Counter

import numpy as np


def delim_string(tau, st) -> str:
    """Binary split flags for inner nodes in pre-order from the root."""
    order = []

    def rec(i):
        if st.left[i] == -1:
            return
        order.append(i)
        rec(st.left[i])
        rec(st.right[i])

    rec(st.root)
    return "".join("1" if tau[i] > 0 else "0" for i in order)


def n_species(tau, st) -> int:
    """#species units = 1 + #split inner nodes (binary guide tree)."""
    ns = st.n_tips
    return 1 + int(sum(1 for i in range(ns, 2 * ns - 1) if tau[i] > 0))


def summarize_delimitations(tau_samples, st):
    models: Counter = Counter()
    nsp: Counter = Counter()
    for tau in tau_samples:
        models[delim_string(tau, st)] += 1
        nsp[n_species(tau, st)] += 1
    return models, nsp


def format_a10_summary(models, nsp, n, st) -> str:
    lines = [f"Species delimitation posterior ({n} samples)", ""]
    lines.append(f"{'P':>9}  model (pre-order split flags)")
    for m, cnt in models.most_common():
        lines.append(f"{cnt / n:9.5f}  {m}")
    lines.append("")
    lines.append(f"{'P':>9}  #species")
    for k in sorted(nsp):
        lines.append(f"{nsp[k] / n:9.5f}  {k}")
    return "\n".join(lines)
