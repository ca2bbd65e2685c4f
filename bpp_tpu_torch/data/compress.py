"""Copied from ``bpp_tpu/data/compress.py`` (numpy / pure Python, unchanged but for
its imports) so that the PyTorch port never loads that package.  The
native fast path goes through the port's own bridge, ``data.cnative``
(``csrc/compress.cpp``), and the numpy path below runs where it does not.

Site-pattern compression.

Replaces the reference's column string-sort compressor (``src/compress.c``
``compress_site_patterns``, JC69 symmetry folding ``encode_jc69``
``compress.c:161``) with vectorized numpy.  Runs on host at data-load
time; output feeds the fixed-shape locus tensors.

JC69 folding: for columns whose characters are all unambiguous single
states, relabel states canonically by first appearance so that columns
equal up to a state permutation collapse to one pattern.  Valid because
the JC69 likelihood is invariant under state relabeling.
"""

from __future__ import annotations

import numpy as np


def compress_patterns(
    codes: np.ndarray, jc69_fold: bool = False, sorted_order: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """Compress alignment columns into unique patterns + weights.

    Args:
      codes: ``[n_seq, n_sites]`` uint8 ambiguity bitmasks.
      jc69_fold: also merge columns equal up to state relabeling.
      sorted_order: emit patterns in lexicographic byte order of the
        encoded column, matching the reference's column string sort
        (``compress.c:35`` ssort1 after charmap encoding) — required for
        bit-reproducing the diploid het-site pinning walk.

    Returns:
      (patterns ``[n_seq, n_patterns]`` uint8, weights ``[n_patterns]`` int32)
    """
    if codes.ndim != 2:
        raise ValueError("codes must be [n_seq, n_sites]")
    # native fast path (compress.cpp; the reference's compress.c analog)
    from .cnative import compress_patterns_native
    out = compress_patterns_native(codes, jc69_fold, sorted_order)
    if out is not None:
        return out
    work = np.ascontiguousarray(codes)
    if jc69_fold:
        work = fold_jc69(work)
    # unique over columns
    cols = np.ascontiguousarray(work.T)
    view = cols.view([("", cols.dtype)] * cols.shape[1]).ravel()
    _, idx, counts = np.unique(view, return_index=True, return_counts=True)
    if not sorted_order:
        # first-appearance order (stable)
        order = np.argsort(idx, kind="stable")
        idx = idx[order]
        counts = counts[order]
    patterns = work[:, idx]
    return patterns.astype(codes.dtype), counts.astype(np.int32)


_SINGLE = np.zeros(256, dtype=bool)
for _m in (1, 2, 4, 8, 15):
    _SINGLE[_m] = True     # unambiguous states and gaps (pll_map_validjc69)
_STATE_OF = np.zeros(256, dtype=np.int64)
for _s, _m in enumerate((1, 2, 4, 8)):
    _STATE_OF[_m] = _s
_STATE_OF[15] = 4          # gap pseudo-state: never relabeled


def fold_jc69(codes: np.ndarray) -> np.ndarray:
    """Canonically relabel states within unambiguous columns.

    Columns whose characters are all single states or gaps
    (``compress.c`` ``pll_map_validjc69``) are re-encoded by order of
    first appearance; gaps stay gaps.  Columns equal up to a state
    permutation then compress together.
    """
    n_seq, n_sites = codes.shape
    unamb = _SINGLE[codes].all(axis=0) & (codes != 15).any(axis=0)
    if not unamb.any():
        return codes
    s = _STATE_OF[codes[:, unamb]]               # [n_seq, U] states 0..3, 4=gap
    U = s.shape[1]
    cols = np.arange(U)
    # first row index where each state occurs, per column
    first = np.full((5, U), n_seq, dtype=np.int64)
    for i in range(n_seq - 1, -1, -1):
        first[s[i], cols] = i
    # rank the 4 real states by first appearance
    order = np.argsort(first[:4], axis=0, kind="stable")  # [4, U]
    mapping = np.empty((5, U), dtype=np.int64)
    mapping[order, cols[None, :]] = np.arange(4)[:, None]
    mapping[4] = 4
    new_s = mapping[s, cols[None, :]]             # [n_seq, U]
    out = codes.copy()
    folded = np.where(new_s == 4, np.uint8(15),
                      np.uint8(1) << new_s.clip(0, 3).astype(np.uint8))
    out[:, unamb] = folded
    return out
