"""ctypes bridge to the native pattern compressor (``csrc/compress.cpp``).

Port of ``bpp_tpu/data/cnative.py``: the reference compresses site
patterns in native C (src/compress.c: ternary string sort + JC69
folding), and so does the port when it can.  The library is built on
first use with the host compiler into ``bpp_tpu_torch/_build/`` under a
hash of its source and flags (``core._build.build_host``), never into
``native/``.  When the compiler or the library fails, or
``BPP_TPU_NATIVE=0`` is set (read at every call), the numpy path of
``data.compress`` runs instead: it is bit-equal, and both run on the host
at load time.  The fallback is not silent: :func:`available` says whether
the native path is in use, and ``CALLS`` counts the compressions it did.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False
# native compressions since import (reset by callers that count a load)
CALLS = 0
# why the native path is unavailable (None while it is available)
ERROR = None


def _enabled() -> bool:
    return os.environ.get("BPP_TPU_NATIVE", "1") != "0"


def _load():
    global _LIB, _TRIED, ERROR
    if not _enabled():
        return None
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        from ..core._build import build_host
        lib = ctypes.CDLL(str(build_host("compress")))
        lib.bpp_compress_patterns.restype = ctypes.c_int
        lib.bpp_compress_patterns.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.bpp_compress_patterns_u32.restype = ctypes.c_int
        lib.bpp_compress_patterns_u32.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        _LIB = lib
    except Exception as exc:        # no compiler, a failed build or load
        _LIB = None
        ERROR = f"{type(exc).__name__}: {exc}"
    return _LIB


def available() -> bool:
    """Whether compressions take the native path (the library loads and
    ``BPP_TPU_NATIVE`` is not 0)."""
    return _load() is not None


def compress_patterns_native(codes: np.ndarray, jc69_fold: bool,
                             sorted_order: bool):
    """Native compress_patterns; returns None when unavailable or where
    the native path does not apply (u32 codes with folding or the sorted
    order, whose numpy struct order differs from memcmp)."""
    global CALLS
    lib = _load()
    if lib is None or codes.ndim != 2 or codes.size == 0:
        return None
    n_seq, n_sites = codes.shape
    npat = ctypes.c_int64(0)
    weights = np.zeros(n_sites, np.int32)
    if codes.dtype == np.uint8:
        c = np.ascontiguousarray(codes)
        pats = np.zeros((n_sites, n_seq), np.uint8)
        rc = lib.bpp_compress_patterns(
            c.ctypes.data, n_seq, n_sites, int(jc69_fold),
            int(sorted_order), pats.ctypes.data, weights.ctypes.data,
            ctypes.byref(npat))
    elif codes.dtype == np.uint32:
        if sorted_order or jc69_fold:
            return None
        c = np.ascontiguousarray(codes)
        pats = np.zeros((n_sites, n_seq), np.uint32)
        rc = lib.bpp_compress_patterns_u32(
            c.ctypes.data, n_seq, n_sites, int(sorted_order),
            pats.ctypes.data, weights.ctypes.data, ctypes.byref(npat))
    else:
        return None
    if rc != 0:
        return None
    CALLS += 1
    n = int(npat.value)
    return (np.ascontiguousarray(pats[:n].T),
            weights[:n].astype(np.int32))
