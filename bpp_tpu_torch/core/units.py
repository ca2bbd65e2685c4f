"""Static launch tables of the pruning kernels, and the numpy statement of
their CLV slot plan.

A *unit* is the work of one warp: one locus and a chunk of up to 32 of its
real site patterns.  The tables depend only on the data (``n_pat``), so a
run builds them once (``Engine``) and every likelihood pass reads
them; no warp is launched on the padded part of the pattern axis.

:func:`slot_plan` is the plan by which ``csrc/contract.cuh`` places inner
CLVs in ``floor(T/2)`` reusable slots, written in numpy so that the CPU
tests can hold it to its invariants and walk a tree through it.
"""

from __future__ import annotations

import numpy as np
import torch

WARP = 32


def unit_table(n_pat, n_cols: int):
    """Units of a batch: ``(units [U, 4] int32, locus_unit0 [L + 1] int32)``.

    A row is (locus, first pattern, real patterns in the chunk, 1 if it is
    the locus's last unit).  Locus ``l`` owns rows ``locus_unit0[l] ..
    locus_unit0[l + 1]``, in pattern order.  Every locus has at least one
    unit, with no real pattern when ``n_pat[l] == 0`` (an empty or masked
    locus): its last unit is the one that zero-fills the columns past
    ``n_pat[l]`` of a per-pattern output.  ``n_pat`` is clipped to the
    ``n_cols`` columns there are."""
    n_pat = np.clip(np.asarray(n_pat, dtype=np.int64), 0, n_cols)
    per = np.maximum(-(-n_pat // WARP), 1)
    locus_unit0 = np.concatenate([[0], np.cumsum(per)])
    locus = np.repeat(np.arange(len(n_pat)), per)
    chunk = np.arange(locus_unit0[-1]) - locus_unit0[locus]
    first = chunk * WARP
    units = np.stack([locus, first,
                      np.clip(n_pat[locus] - first, 0, WARP),
                      chunk == per[locus] - 1], axis=1)
    return units.astype(np.int32), locus_unit0.astype(np.int32)


def block_table(locus_unit0, warps: int):
    """Blocks of ``warps`` warps over whole loci: ``[B, 4] int32`` rows
    (first unit, end unit, first locus, end locus).

    Loci are taken in order while their units fit the block's warps, so a
    locus never spans two blocks and a block owns at most ``warps`` loci;
    a locus with more units than warps is a block of its own, walked in
    rounds."""
    lu = np.asarray(locus_unit0, dtype=np.int64)
    rows = []
    l0 = 0
    for l in range(1, len(lu)):
        if l == len(lu) - 1 or lu[l + 1] - lu[l0] > warps:
            rows.append((lu[l0], lu[l], l0, l))
            l0 = l
    return np.asarray(rows, dtype=np.int32).reshape(-1, 4)


def slot_plan(order, left, right, n_seq: int, n_tips: int):
    """CLV slots of one locus's inner nodes: ``(src_left, src_right, dst,
    n_slots)``, one entry per level ``k < n_seq - 1``.

    A child source ``>= 0`` is a tip's index, ``< 0`` is slot ``-1 -
    source``; ``dst[k]`` is the slot that level ``k`` writes after it has
    read both children.  A node writes into the slot of its left inner
    child, else of its right inner child, else into a slot of its own,
    numbered in schedule order.  The nodes that share a slot form a chain
    up the tree; a chain starts at a node with two tips below it, so
    ``n_slots`` is never more than ``floor(n_tips / 2)``.  The kernel finds
    every node's chain at once by pointer jumping; the slots are the
    same."""
    T = n_tips
    nlev = max(int(n_seq) - 1, 0)
    slot_of = {}
    n_slots = 0
    src_l, src_r, dst = [], [], []
    for k in range(nlev):
        node = int(order[k])
        lc, rc = int(left[node]), int(right[node])
        ls = slot_of[lc] if lc >= T else -1
        rs = slot_of[rc] if rc >= T else -1
        if ls >= 0:
            d = ls
        elif rs >= 0:
            d = rs
        else:
            d = n_slots
            n_slots += 1
        slot_of[node] = d
        src_l.append(-1 - ls if ls >= 0 else lc)
        src_r.append(-1 - rs if rs >= 0 else rc)
        dst.append(d)
    return (np.asarray(src_l, dtype=np.int64),
            np.asarray(src_r, dtype=np.int64),
            np.asarray(dst, dtype=np.int64), n_slots)


class Units:
    """The unit table of one batch on a device, with the per-locus block
    tables K1 needs, one per block size asked for."""

    def __init__(self, n_pat, n_cols: int, device):
        self.n_loci = len(n_pat)
        self.n_cols = int(n_cols)
        units, self._locus_unit0 = unit_table(n_pat, n_cols)
        self.n_units = len(units)
        self.units = torch.as_tensor(units, device=device)
        self.locus_unit0 = torch.as_tensor(self._locus_unit0, device=device)
        self._blocks = {}

    def blocks(self, warps: int):
        """K1's block table ``[B, 4] int32`` on the device."""
        if warps not in self._blocks:
            self._blocks[warps] = torch.as_tensor(
                block_table(self._locus_unit0, warps),
                device=self.units.device)
        return self._blocks[warps]
