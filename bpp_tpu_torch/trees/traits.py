"""Morphological trait likelihoods (reference: src/morph.c), PyTorch.

Port of ``bpp_tpu/trees/traits.py``.  Two data types per partition of a
``traitfile``:

* **continuous**: Brownian motion on the species tree scored by
  phylogenetic independent contrasts (``loglikelihood_trait_c_bm``
  morph.c:888, ``trait_update_pic_part`` morph.c:413; Alvarez-Carretero
  et al. 2019 eq. 5).  The data matrix arrives standardized, with the
  population variance ``v_pop`` and the log-determinant of the shrinkage
  correlation estimate ``ldetRs`` in the partition header.
* **discrete**: the Mk model (Lewis 2001) with per-character state counts
  and the Mkv variable-only ascertainment correction
  (``loglikelihood_trait_d_mkv`` morph.c:924, transition probabilities
  ``trait_trprob_mk`` morph.c:462).

A partition's characters are pruned together as ``[nchar, K]`` tensors,
the Mk transition applied in closed form (``P @ cl = pdiff * sum(cl) +
(psame - pdiff) * cl``).  ``bpp_tpu``'s ``lax.scan`` over the post-order
is a loop over the NS - 1 inner species nodes, each step indexing with
0-d device tensors, so the loop reads nothing back to the host.  Branch
lengths are ``(tau_parent - tau_node) * brate``, so every tau move
re-scores the traits through these functions.  Parsing and the
matching of rows to species (``parse_traitfile``, ``build_trait_data``)
are host code copied from ``bpp_tpu``.
"""

from __future__ import annotations

import math
import re
from typing import NamedTuple

import numpy as np
import torch

MISSING = 1023          # '?' / '-' bitmask (all ten states)


class TraitPartition(NamedTuple):
    """One parsed block of the traitfile (host)."""

    dtype: str                    # "cont" | "disc"
    labels: list                  # species labels, file order
    values: np.ndarray            # cont: [ntaxa, p] float; disc: [ntaxa,
                                  # nchar] state bitmasks
    v_pop: float                  # cont only: population variance
    ldetRs: float                 # cont only: log|R*|


class TraitPartData(NamedTuple):
    """One partition's tensors, rows in species order."""

    dtype: str
    # continuous
    m_tip: torch.Tensor | None    # [NS, p] trait values
    v_pop: float
    ldetRs: float
    # discrete
    tipprob: torch.Tensor | None  # [NS, nchar, K] 0/1 compatibility
    nstate: torch.Tensor | None   # [nchar] int64 states per character
    kmax: int                     # the largest state count (2..10)


class TraitState(NamedTuple):
    """Per-partition trait branch rates and cached log-likelihoods."""

    brate: torch.Tensor           # [n_part, H] per species branch
    logl: torch.Tensor            # [n_part]


def _state_bin(x: int) -> int:
    return 1 << x


def parse_traitfile(path: str) -> list[TraitPartition]:
    """Parse every partition (parse_traitfile morph.c:270).

    A block's header is ``ntaxa nchar C v_pop ldetRs`` or ``ntaxa nchar
    D``, then one row a species: ``label v1 v2 ...``.  Discrete values
    are digits 0-9, ``?``/``-`` missing, ``{..}``/``(..)`` ambiguity
    sets."""
    with open(path) as fh:
        text = fh.read()
    # strip /* */ comments (parse_comment)
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    toks = text.split()
    pos = 0
    parts: list[TraitPartition] = []

    def take():
        nonlocal pos
        t = toks[pos]
        pos += 1
        return t

    while pos < len(toks):
        ntaxa, nchar = int(take()), int(take())
        if ntaxa <= 0 or nchar <= 0:
            raise ValueError(f"{path}: bad partition header")
        ty = take().upper()
        if ty == "C":
            v_pop, ldetRs = float(take()), float(take())
            vals = np.zeros((ntaxa, nchar))
            labels = []
            for i in range(ntaxa):
                labels.append(take())
                for j in range(nchar):
                    t = take()
                    vals[i, j] = np.nan if t in ("?", "-") else float(t)
            parts.append(TraitPartition("cont", labels, vals, v_pop, ldetRs))
        elif ty == "D":
            vals = np.zeros((ntaxa, nchar), np.int32)
            labels = []
            for i in range(ntaxa):
                labels.append(take())
                j = 0
                while j < nchar:
                    t = take()
                    # an ambiguity set may arrive as one token "{01}" or
                    # split: join up to the closing brace
                    if t[0] in "{(":
                        while not t.endswith(("}", ")")):
                            t += take()
                        mask = 0
                        for ch in t[1:-1]:
                            if ch.isdigit():
                                mask |= _state_bin(int(ch))
                        if mask == 0:
                            raise ValueError(
                                f"{path}: empty ambiguity set {t!r}")
                        vals[i, j] = mask
                        j += 1
                    else:
                        for ch in t:
                            if ch.isdigit():
                                vals[i, j] = _state_bin(int(ch))
                            elif ch in "?-":
                                vals[i, j] = MISSING
                            else:
                                raise ValueError(
                                    f"{path}: bad trait value {ch!r}")
                            j += 1
            parts.append(TraitPartition("disc", labels, vals, 0.0, 0.0))
        else:
            raise ValueError(f"{path}: unknown data type {ty!r}")
    return parts


def build_trait_data(parts: list[TraitPartition], st,
                     dtype=torch.float64,
                     device="cpu") -> tuple[TraitPartData, ...]:
    """Match partition rows to the species tree's tips (trait_fill_tip
    morph.c:616) and make the tensors."""
    out = []
    for n, part in enumerate(parts):
        idx = []
        for i in range(st.n_tips):
            name = st.names[i]
            if name not in part.labels:
                raise ValueError(
                    f"species {name!r} not found in trait partition {n+1}")
            idx.append(part.labels.index(name))
        if part.dtype == "cont":
            out.append(TraitPartData(
                dtype="cont",
                m_tip=torch.as_tensor(part.values[idx], dtype=dtype,
                                      device=device),
                v_pop=float(part.v_pop), ldetRs=float(part.ldetRs),
                tipprob=None, nstate=None, kmax=0))
        else:
            states = part.values[idx]                    # [NS, nchar]
            ntax, nchar = states.shape
            nstate = np.zeros(nchar, np.int64)
            for j in range(nchar):
                col = states[:, j]
                obs = col[col != MISSING]
                if obs.size and np.all(obs == obs[0]) and \
                        bin(int(obs[0])).count("1") == 1:
                    raise ValueError(
                        f"constant character at column {j+1} of trait "
                        f"partition {n+1} (Mkv needs variable data)")
                max_state = 0
                for v in obs:
                    max_state = max(max_state, int(v).bit_length() - 1)
                nstate[j] = max(2, max_state + 1)
            kmax = int(nstate.max())
            tipprob = np.zeros((ntax, nchar, kmax))
            for x in range(kmax):
                tipprob[:, :, x] = (states & _state_bin(x)) > 0
            out.append(TraitPartData(
                dtype="disc", m_tip=None, v_pop=0.0, ldetRs=0.0,
                tipprob=torch.as_tensor(tipprob, dtype=dtype, device=device),
                nstate=torch.as_tensor(nstate, device=device), kmax=kmax))
    return tuple(out)


def _postorder(st) -> np.ndarray:
    """Host post-order of the inner species nodes (children first)."""
    order = []

    def rec(i):
        if st.left[i] == -1:
            return
        rec(int(st.left[i]))
        rec(int(st.right[i]))
        order.append(i)

    rec(int(st.root))
    return np.asarray(order, np.int64)


def make_trait_logl(st, data: tuple[TraitPartData, ...]):
    """Returns ``trait_logl(tau, brate [n_part, H]) -> [n_part]`` on the
    FIXED species topology of ``st`` (A00/A10 guide trees)."""
    topo = make_trait_logl_topo(st.n_tips, st.n_nodes, data)
    dev = next(p.m_tip if p.m_tip is not None else p.tipprob
               for p in data).device

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=dev)

    left, right, parent = t(st.left), t(st.right), t(st.parent)

    def trait_logl(tau, brate):
        return topo(left, right, parent, tau, brate)

    return trait_logl


def _at(x, i):
    """``x[i]`` for a 0-dim index tensor ``i`` on the device, gathered
    there: indexing with the 0-dim tensor itself reads it on the host."""
    return x[i[None]][0]


def make_trait_logl_topo(NS: int, H: int, data: tuple[TraitPartData, ...]):
    """Returns ``trait_logl(left, right, parent, tau, brate) -> [n_part]``
    over a species topology held in tensors: the form the species SPR and
    SNL moves re-score inside their acceptance (stree.c:727-736 subtracts
    trait_old_logl and adds loglikelihood_trait on the proposed tree).

    The post-order is found on the device: inner nodes by tau ascending
    (children are never older), depth descending among equal taus."""

    def derive(left, right, parent, tau):
        root = torch.argmin(parent)                      # parent == -1
        depth = torch.zeros_like(parent)
        p = parent
        for _ in range(H):
            depth = depth + (p >= 0).to(depth.dtype)
            p = torch.where(p >= 0, parent[p.clamp(min=0)], p)
        key_tau = torch.where(left >= 0, tau,
                              torch.full_like(tau, float("inf")))
        # lexsort((-depth, key_tau)): by key_tau, ties by -depth, ties by
        # index (two stable sorts)
        o1 = torch.argsort(-depth, stable=True)
        o2 = torch.argsort(key_tau[o1], stable=True)
        return o1[o2][:NS - 1], root

    def one_cont(left, right, parent, porder, tau, brate, part):
        p = part.m_tip.shape[1]
        partau = torch.where(parent >= 0, tau[parent.clamp(min=0)], tau)
        vk = (partau - tau) * brate
        m = torch.zeros((H, p), dtype=tau.dtype, device=tau.device)
        m[:NS] = part.m_tip.to(tau.dtype)
        tip = torch.arange(H, device=tau.device) < NS
        brlen = torch.where(tip, vk + part.v_pop, torch.zeros_like(vk))
        logl = torch.zeros((), dtype=tau.dtype, device=tau.device)
        for i in range(NS - 1):
            node = porder[i]
            lch, rch = _at(left, node), _at(right, node)
            v1, v2 = _at(brlen, lch), _at(brlen, rch)
            v12 = v1 + v2
            contrast = _at(m, lch) - _at(m, rch)
            zz = torch.sum(contrast * contrast)
            logl = logl - 0.5 * (p * torch.log(2.0 * math.pi * v12)
                                 + part.ldetRs + zz / v12)
            m = m.index_copy(0, node[None], ((v2 * _at(m, lch) + v1 * _at(
                m, rch)) / v12)[None])
            brlen = brlen.index_copy(0, node[None],
                                     (_at(vk, node) + v1 * v2 / v12)[None])
        return logl

    def one_disc(left, right, parent, porder, root, tau, brate, part):
        K = part.kmax
        dt, dev = tau.dtype, tau.device
        ks = torch.arange(2, K + 1, device=dev)          # [K-1] state counts
        partau = torch.where(parent >= 0, tau[parent.clamp(min=0)], tau)
        # morph.c:478: v floored at 1e-8 (the root included)
        v = torch.clamp((partau - tau) * brate, min=1e-8)     # [H]
        kf = ks.to(dt)
        e = torch.exp(-v[:, None] * kf / (kf - 1.0))     # [H, K-1]
        psame = 1.0 / kf + (kf - 1.0) / kf * e           # morph.c:467
        pdiff = 1.0 / kf - 1.0 / kf * e
        arK = torch.arange(K, device=dev)
        xmask = (arK[None, :] < part.nstate[:, None]).to(dt)  # [nchar, K]
        kidx = part.nstate - 2                           # [nchar]
        # the real characters [H, nchar, K], and one dummy constant
        # character a state count (constant at state 0: Mk symmetry makes
        # every constant state alike, morph.c:935 sums k copies)
        nchar = part.tipprob.shape[1]
        cl = torch.zeros((H, nchar, K), dtype=dt, device=dev)
        cl[:NS] = part.tipprob.to(dt) * xmask
        dmask = (arK[None, :] < ks[:, None]).to(dt)      # [K-1, K]
        dl = torch.zeros((H, K - 1, K), dtype=dt, device=dev)
        dl[:NS] = (arK == 0).to(dt)[None, None, :]
        kall = torch.arange(K - 1, device=dev)

        def prune(cl_child, child, kindex):
            # (P @ cl)[x] = pdiff * S + (psame - pdiff) * cl[x]
            ps = _at(psame, child)[kindex]
            pd = _at(pdiff, child)[kindex]
            s = cl_child.sum(-1)
            return pd[:, None] * s[:, None] + (ps - pd)[:, None] * cl_child

        for i in range(NS - 1):
            node = porder[i]
            lch, rch = _at(left, node), _at(right, node)
            clp = (prune(_at(cl, lch) * xmask, lch, kidx)
                   * prune(_at(cl, rch) * xmask, rch, kidx)) * xmask
            dlp = (prune(_at(dl, lch) * dmask, lch, kall)
                   * prune(_at(dl, rch) * dmask, rch, kall)) * dmask
            cl = cl.index_copy(0, node[None], clp[None])
            dl = dl.index_copy(0, node[None], dlp[None])
        prob = _at(cl, root).sum(-1) / part.nstate.to(dt)     # uniform root
        # p_const(k) = sum_a sum_x rootprob_a[x] / k (morph.c:935): the k
        # dummies are alike, so it is sum_x of the one dummy's root
        pc = _at(dl, root).sum(-1)[kidx]                 # [nchar]
        return torch.sum(torch.log(torch.clamp(prob, min=1e-300))
                         - torch.log(torch.clamp(1.0 - pc, min=1e-300)))

    def trait_logl(left, right, parent, tau, brate):
        porder, root = derive(left, right, parent, tau)
        vals = []
        for n, part in enumerate(data):
            if part.dtype == "cont":
                vals.append(one_cont(left, right, parent, porder, tau,
                                     brate[n], part))
            else:
                vals.append(one_disc(left, right, parent, porder, root, tau,
                                     brate[n], part))
        return torch.stack(vals)

    return trait_logl
