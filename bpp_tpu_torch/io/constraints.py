"""Copied from ``bpp_tpu/io/constraints.py`` (numpy / pure
Python, unchanged) so that the PyTorch port never loads that package.

A01/A11 topology constraints and outgroup (reference
src/constraint.c).

Constraint file syntax, one entry per line (parse_constdefs
constraint.c:325):

    define <tag> as <newick-clade>;
    constraint [=] <newick-clade>;
    outgroup [=] <label>[, <label> ...];

``define`` names a group that may appear as a leaf in later entries
(definitions_expand constraint.c:740); an ``outgroup`` line becomes a
constraint over the complementary (ingroup) taxa
(convert_outgroup_to_constraint constraint.c:1546).

Application (constraint_process_recursive constraint.c:861): every
internal node of a constraint tree is processed children-first; its tip
set must form a clade of the STARTING species tree, and all unmarked
strict descendants of that clade's LCA receive a fresh integer id.  The
SPR move then only regrafts within a constraint group (stree.c:7847
``c_cand->constraint != y->constraint``) and only prunes nodes whose
whole neighborhood shares one group (fill_feasible_flags
stree.c:7697-7741).  SNL is incompatible with constraints, like the
reference (stree.c:11395).
"""

from __future__ import annotations

import numpy as np

from .newick import Node, parse_newick


def parse_constraintfile(path: str):
    """Returns (defines: dict tag->Node, constraints: list[(lineno,
    Node)], outgroups: list[(lineno, [labels])])."""
    defines: dict[str, Node] = {}
    constraints: list[tuple[int, Node]] = []
    outgroups: list[tuple[int, list[str]]] = []
    with open(path) as fh:
        for ln, raw in enumerate(fh, 1):
            line = raw.split("#")[0].split("//")[0].strip()
            if not line:
                continue
            kw, _, rest = line.partition(" ")
            kw = kw.lower()
            rest = rest.strip()
            if kw == "define":
                tag, _, tree = rest.partition(" as ")
                tag = tag.strip()
                tree = tree.strip().rstrip(";") + ";"
                if not tag or tree == ";":
                    raise ValueError(f"{path}:{ln}: bad define syntax")
                defines[tag] = parse_newick(tree)
            elif kw == "constraint":
                tree = rest.lstrip("=").strip().rstrip(";") + ";"
                constraints.append((ln, parse_newick(tree)))
            elif kw == "outgroup":
                labels = [t.strip() for t in
                          rest.lstrip("=").rstrip(";").split(",")
                          if t.strip()]
                if not labels:
                    raise ValueError(f"{path}:{ln}: empty outgroup")
                outgroups.append((ln, labels))
            else:
                raise ValueError(
                    f"{path}:{ln}: expected define/constraint/outgroup, "
                    f"got {kw!r}")
    return defines, constraints, outgroups


def _expand(node: Node, defines: dict) -> Node:
    """Substitute defined tags appearing as leaves (constraint.c:740)."""
    if node.is_leaf:
        if node.label in defines:
            return _expand(defines[node.label], defines)
        return node
    node.children = [_expand(c, defines) for c in node.children]
    return node


def _tipset(node: Node) -> set[str]:
    return {leaf.label for leaf in node.leaves()}


def build_constraint_ids(st, path: str) -> np.ndarray:
    """Parse + apply a constraint file against the starting species tree
    ``st``; returns int ids [H] (0 = unconstrained).

    The starting tree must comply with every constraint (each constraint
    tip set must be a clade); conflicting/overlapping constraints raise,
    mirroring constraint.c:885 "Conflicting constraints".
    """
    defines, constraints, outgroups = parse_constraintfile(path)
    names = list(st.names)
    name_to_tip = {n: i for i, n in enumerate(names)}
    H = st.n_nodes
    pptable = st.pptable()
    ids = np.zeros(H, np.int64)
    lineno_of = np.zeros(H, np.int64)
    next_id = [0]

    # outgroup -> flat ingroup constraint (constraint.c:1546)
    for ln, labels in outgroups:
        for lab in labels:
            if lab not in name_to_tip:
                raise ValueError(
                    f"{path}:{ln}: unknown outgroup taxon {lab!r}")
        ingroup = [n for n in names if n not in labels]
        if len(ingroup) < 2:
            raise ValueError(
                f"{path}:{ln}: at least two taxa must form the ingroup")
        root = Node()
        root.children = [Node(label=n) for n in ingroup]
        constraints.append((ln, root))

    def lca_of(tips: list[int]) -> int:
        anc = pptable[tips[0]].copy()
        for t in tips[1:]:
            anc &= pptable[t]
        depth = pptable.sum(1)
        cands = np.nonzero(anc)[0]
        return int(cands[np.argmax(depth[cands])])

    def process(node: Node, ln: int):
        if node.is_leaf:
            return
        for ch in node.children:
            process(ch, ln)
        tips = sorted(_tipset(node))
        for lab in tips:
            if lab not in name_to_tip:
                raise ValueError(
                    f"{path}:{ln}: unknown taxon {lab!r} in constraint")
        tipidx = [name_to_tip[t] for t in tips]
        lca = lca_of(tipidx)
        under = {names[j] for j in range(st.n_tips) if pptable[j, lca]}
        if under != set(tips):
            raise ValueError(
                f"{path}:{ln}: the starting species tree does not "
                f"contain ({','.join(tips)}) as a clade (found "
                f"{sorted(under)} under its MRCA); provide a compliant "
                "starting tree")
        l, r = int(st.left[lca]), int(st.right[lca])
        if ids[l] != ids[r]:
            raise ValueError(
                f"{path}: conflicting constraints (lines "
                f"{int(lineno_of[l]) or int(lineno_of[r])} and {ln})")
        next_id[0] += 1

        def mark(i: int):
            if ids[i]:
                return
            ids[i] = next_id[0]
            lineno_of[i] = ln
            if st.left[i] != -1:
                mark(int(st.left[i]))
            if st.right[i] != -1:
                mark(int(st.right[i]))

        mark(l)
        mark(r)

    for ln, tree in constraints:
        process(_expand(tree, defines), ln)
    return ids
