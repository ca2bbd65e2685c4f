"""Copied from ``bpp_tpu/tools/msci_create.py`` (pure Python, unchanged) so
that the PyTorch port never loads that package.

``--msci-create``: MSC-I network definition language -> extended newick.

Re-implementation of the reference's network constructor
(``src/msci_gen.c`` ``cmd_msci_create:1867``).  A definitions file
contains, one per line (case-insensitive tags, ``#``/``//`` comments):

  tree (A,(B,C));
  define T as B,C                      # label the LCA of B,C as T
  hybridization X1 X2, Y1 Y2 as S H tau=yes,no phi=0.3
  hybridization X1 X2 as S H phi=0.3   # parallel edges (one edge given)
  bidirection X1 X2, Y1 Y2 as S T phi=0.3,0.4
  bl                                   # show branch lengths

``X1 X2`` name an edge by its two endpoint node labels (either order).
For ``hybridization``, the FIRST edge is the source and the SECOND the
target (msci_gen.c:1262-1306 swaps into internal order); ``S`` labels
the new node on the source edge, ``H`` the hybridization node on the
target edge; ``tau=source,target`` flags whether each new node's
parent keeps an independent tau; ``phi`` is the introgression
probability of the new horizontal edge.  The output is the extended
newick consumed by ``species&tree`` (hybridization nodes appear twice
with ``[&phi=..,tau-parent=..]`` annotations, msci_gen.c
msci_export_newick:1540-1700).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..io.newick import Node, parse_newick


@dataclass
class _Defs:
    tree: Node | None = None
    show_bl: bool = False
    events: list = field(default_factory=list)


def _parse_edge_pair(tok: list[str]) -> tuple[str, str]:
    if len(tok) != 2:
        raise ValueError(f"an edge needs two endpoint labels, got {tok}")
    return tok[0], tok[1]


def _split_commas(s: str) -> list[list[str]]:
    return [part.split() for part in s.split(",")]


def parse_definitions(text: str) -> _Defs:
    defs = _Defs()
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.split("#")[0].split("//")[0].strip()
        if not line:
            continue
        tag, _, rest = line.partition(" ")
        tag = tag.lower()
        rest = rest.strip()
        if tag == "tree":
            if defs.tree is not None:
                raise ValueError(f"duplicate tree (line {lineno})")
            defs.tree = parse_newick(rest)
        elif tag == "bl":
            defs.show_bl = True
        elif tag == "define":
            lca_label, _, tail = rest.partition(" ")
            kw, _, tips = tail.strip().partition(" ")
            if kw.lower() != "as":
                raise ValueError(f"define: expected 'as' (line {lineno})")
            tipnames = [t.strip() for t in tips.replace(",", " ").split()]
            defs.events.append(("define", lineno, lca_label, tipnames))
        elif tag in ("hybridization", "bidirection"):
            head, _, tail = rest.partition(" as ")
            if not tail:
                raise ValueError(f"{tag}: expected 'as' (line {lineno})")
            edges = _split_commas(head)
            toks = tail.split()
            if len(toks) < 2:
                raise ValueError(f"{tag}: expected two labels (line {lineno})")
            lab1, lab2 = toks[0], toks[1]
            opts = " ".join(toks[2:])
            taus = (True, True)
            phis: tuple = (None, None)
            # parse "tau=a,b" / "phi=x[,y]"
            import re
            m = re.search(r"tau\s*=\s*(yes|no)\s*,\s*(yes|no)", opts, re.I)
            if m:
                taus = (m.group(1).lower() == "yes",
                        m.group(2).lower() == "yes")
            m = re.search(r"phi\s*=\s*([0-9.eE+-]+)(?:\s*,\s*([0-9.eE+-]+))?",
                          opts)
            if m:
                phis = (float(m.group(1)),
                        float(m.group(2)) if m.group(2) else None)
            if tag == "hybridization":
                if len(edges) not in (1, 2):
                    raise ValueError(
                        f"hybridization: 1 or 2 edges (line {lineno})")
                defs.events.append(("hybrid", lineno,
                                    [_parse_edge_pair(e) for e in edges],
                                    lab1, lab2, taus, phis[0]))
            else:
                if len(edges) != 2:
                    raise ValueError(f"bidirection: 2 edges (line {lineno})")
                if phis[0] is None or phis[1] is None:
                    raise ValueError(
                        f"bidirection: phi=a,b required (line {lineno})")
                defs.events.append(("bidir", lineno,
                                    [_parse_edge_pair(e) for e in edges],
                                    lab1, lab2, phis))
        else:
            raise ValueError(f"unknown definition tag {tag!r} (line {lineno})")
    if defs.tree is None:
        raise ValueError("definitions file has no tree line")
    return defs


# --- tree surgery -----------------------------------------------------------


def _find_by_label(root: Node, label: str) -> Node:
    hits = [n for n in root.walk() if n.label == label]
    if not hits:
        raise ValueError(f"no node labeled {label!r}")
    if len(hits) > 1:
        raise ValueError(f"label {label!r} is ambiguous")
    return hits[0]


def _edge_basenode(root: Node, ep1: str, ep2: str, lineno: int) -> Node:
    """The child endpoint of the edge named by its two node labels
    (msci_gen.c edge_basenode)."""
    a = _find_by_label(root, ep1)
    b = _find_by_label(root, ep2)
    if a.parent is b:
        return a
    if b.parent is a:
        return b
    raise ValueError(
        f"nodes {ep1!r} and {ep2!r} do not form an edge (line {lineno})")


def _replace_child(parent: Node, old: Node, new: Node) -> None:
    parent.children[parent.children.index(old)] = new
    new.parent = parent


def _is_ancestor(anc: Node, node: Node) -> bool:
    while node is not None:
        if node is anc:
            return True
        node = node.parent
    return False


def apply_define(root: Node, label: str, tipnames: list[str],
                 lineno: int) -> None:
    """Label the LCA of the named tips (msci_gen.c label_inner_nodes)."""
    tips = [_find_by_label(root, t) for t in tipnames]
    node = tips[0]
    while not all(_is_ancestor(node, t) for t in tips):
        if node.parent is None:
            break
        node = node.parent
    if node.label and node.label != label:
        raise ValueError(
            f"define: LCA of {tipnames} already labeled {node.label!r} "
            f"(line {lineno})")
    node.label = label


def apply_hybridization(root: Node, edges, lab1: str, lab2: str,
                        taus, phi, lineno: int) -> None:
    """Insert a hybridization (msci_gen.c process_hybrid:1419).

    User order: edges[0] = source, edges[1] = target; lab1 = source
    node label, lab2 = target (hybrid) label; taus = (source, target).
    """
    parallel = len(edges) == 1
    if parallel:
        a = _edge_basenode(root, *edges[0], lineno)
        b = None
        hyb_label, src_label = lab2, lab1
        tau_target = tau_source = True
    else:
        b = _edge_basenode(root, *edges[0], lineno)   # source child
        a = _edge_basenode(root, *edges[1], lineno)   # target child
        hyb_label, src_label = lab2, lab1
        tau_source, tau_target = taus
    pa = a.parent
    if pa is None or (not parallel and b.parent is None):
        raise ValueError(
            f"cannot create hybridization on the root (line {lineno})")

    # hl: hybridization node inserted on the target edge (unary);
    # hr: its mirror, attached under t on the source edge
    hl = Node(label=hyb_label)
    hr = Node(label=hyb_label)
    hl.attributes["is_hyb_main"] = "1"
    hr.attributes["is_hyb_mirror"] = "1"

    if not parallel:
        pb = b.parent
        t = Node(label=src_label)
        _replace_child(pb, b, t)
        t.children = [hr, b]
        hr.parent = b.parent = t
        _replace_child(pa, a, hl)
        hl.children = [a]
        a.parent = hl
        hl.attributes["tau-parent"] = "yes" if tau_target else "no"
        hr.attributes["tau-parent"] = "yes" if tau_source else "no"
    else:
        # parallel edges: both new nodes between a and (a new or the
        # existing unary) parent
        if pa.parent is None and len(pa.children) == 1:
            pa.children = [hl, hr]
            hl.parent = hr.parent = pa
            hl.children = [a]
            a.parent = hl
        else:
            t = Node(label=src_label)
            _replace_child(pa, a, t)
            t.children = [hl, hr]
            hl.parent = hr.parent = t
            hl.children = [a]
            a.parent = hl
        hl.attributes["tau-parent"] = "yes"
        hr.attributes["tau-parent"] = "yes"

    if phi is not None:
        # phi names the contribution of the new horizontal edge (mirror)
        hr.attributes["phi"] = f"{phi:.6f}"
        hl.attributes["phi"] = f"{1.0 - phi:.6f}"


def apply_bidirection(root: Node, edges, lab1: str, lab2: str, phis,
                      lineno: int) -> None:
    """Insert a bidirectional introgression (process_bidir:1201)."""
    a = _edge_basenode(root, *edges[0], lineno)
    b = _edge_basenode(root, *edges[1], lineno)
    if a is b:
        raise ValueError(f"bidirection needs two distinct edges "
                         f"(line {lineno})")
    if _is_ancestor(a, b) or _is_ancestor(b, a):
        raise ValueError(
            f"bidirection endpoints may not be ancestral (line {lineno})")
    pa, pb = a.parent, b.parent
    sh = Node(label=lab1)
    sm = Node(label=lab1)
    th = Node(label=lab2)
    tm = Node(label=lab2)
    _replace_child(pb, b, th)
    th.children = [b, sm]
    b.parent = sm.parent = th
    _replace_child(pa, a, sh)
    sh.children = [a, tm]
    a.parent = tm.parent = sh
    phi1, phi2 = phis
    sm.attributes["phi"] = f"{phi1:.6f}"
    sh.attributes["phi"] = f"{1.0 - phi1:.6f}"
    tm.attributes["phi"] = f"{phi2:.6f}"
    th.attributes["phi"] = f"{1.0 - phi2:.6f}"
    for n in (sh, th):
        n.attributes["is_bd_main"] = "1"
    for n in (sm, tm):
        n.attributes["is_bd_mirror"] = "1"


# --- export -----------------------------------------------------------------


def export_extended_newick(node: Node, show_bl: bool = False) -> str:
    """Extended newick string (msci_export_newick_recursive)."""
    at = node.attributes

    def ann(n: Node, with_tau: bool = True) -> str:
        parts = []
        if "phi" in n.attributes:
            parts.append(f"&phi={float(n.attributes['phi']):.6f}")
        if with_tau and "tau-parent" in n.attributes:
            key = "tau-parent" if parts else "&tau-parent"
            parts.append(f"{key}={n.attributes['tau-parent']}")
        return f"[{','.join(parts)}]" if parts else ""

    if at.get("is_hyb_mirror"):
        return f"{node.label}{ann(node)}"
    if at.get("is_bd_mirror"):
        return f"{node.label}{ann(node, with_tau=False)}"
    if at.get("is_hyb_main"):
        sub = export_extended_newick(node.children[0], show_bl)
        return f"({sub}){node.label}{ann(node)}"
    if at.get("is_bd_main"):
        sub = export_extended_newick(node.children[0], show_bl)
        mir = node.children[1]
        return (f"({sub},{mir.label}{ann(mir, with_tau=False)})"
                f"{node.label}")
    if not node.children:
        s = node.label or ""
    else:
        s = "(" + ",".join(export_extended_newick(c, show_bl)
                           for c in node.children) + ")"
        if node.label:
            s += node.label
    if show_bl and node.length is not None:
        s += f":{node.length:g}"
    return s


def msci_create(text: str) -> str:
    """Definitions text -> extended newick (the tool's whole pipeline)."""
    defs = parse_definitions(text)
    root = defs.tree
    for ev in defs.events:
        kind, lineno = ev[0], ev[1]
        if kind == "define":
            apply_define(root, ev[2], ev[3], lineno)
        elif kind == "hybrid":
            apply_hybridization(root, ev[2], ev[3], ev[4], ev[5], ev[6],
                                lineno)
        else:
            apply_bidirection(root, ev[2], ev[3], ev[4], ev[5], lineno)
    return export_extended_newick(root, defs.show_bl) + ";"


def cmd_msci_create(path: str) -> int:
    with open(path) as fh:
        text = fh.read()
    print("Newick tree:")
    print(msci_create(text))
    return 0
