"""The port's native pattern compressor (``bpp_tpu_torch/csrc/compress.cpp``
through ``bpp_tpu_torch.data.cnative``): bit-equal to the numpy path and
to ``bpp_tpu``'s bridge on ``test_native.py``'s random cases, built
under ``bpp_tpu_torch/_build/``, and switched off by ``BPP_TPU_NATIVE=0``."""

from pathlib import Path

import numpy as np
import pytest

from bpp_tpu.data.cnative import compress_patterns_native as jax_native
from bpp_tpu_torch.core import _build
from bpp_tpu_torch.data import cnative
from bpp_tpu_torch.data import compress as C

MASKS = np.array([1, 2, 4, 8, 15, 3, 5, 12, 7, 14], np.uint8)


def _numpy(codes, fold, sorted_order, monkeypatch):
    monkeypatch.setenv("BPP_TPU_NATIVE", "0")
    try:
        return C.compress_patterns(codes, jc69_fold=fold,
                                   sorted_order=sorted_order)
    finally:
        monkeypatch.delenv("BPP_TPU_NATIVE")


def _cases(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        n_seq = int(rng.integers(2, 40))
        n_sites = int(rng.integers(1, 400))
        pool = 5 if rng.random() < 0.5 else len(MASKS)
        yield MASKS[rng.integers(0, pool, (n_seq, n_sites))]


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("sorted_order", [False, True])
def test_native_matches_numpy_and_bpp_tpu(fold, sorted_order, monkeypatch):
    assert cnative.available(), cnative.ERROR
    for codes in _cases(42):
        calls = cnative.CALLS
        nat = cnative.compress_patterns_native(codes, fold, sorted_order)
        assert cnative.CALLS == calls + 1
        pats, w = _numpy(codes, fold, sorted_order, monkeypatch)
        np.testing.assert_array_equal(nat[0], pats)
        np.testing.assert_array_equal(nat[1], w)
        assert nat[0].dtype == pats.dtype and nat[1].dtype == w.dtype
        ref = jax_native(codes, fold, sorted_order)
        if ref is not None:          # bpp_tpu's library may fail to build
            np.testing.assert_array_equal(nat[0], ref[0])
            np.testing.assert_array_equal(nat[1], ref[1])


def test_native_u32_and_where_it_does_not_apply(monkeypatch):
    rng = np.random.default_rng(3)
    codes = rng.integers(1, 1 << 20, (10, 200)).astype(np.uint32)
    codes[:, 50] = codes[:, 10]          # force duplicates
    nat = cnative.compress_patterns_native(codes, False, False)
    pats, w = _numpy(codes, False, False, monkeypatch)
    np.testing.assert_array_equal(nat[0], pats)
    np.testing.assert_array_equal(nat[1], w)
    assert nat[1].sum() == 200 and nat[0].shape[1] == 199
    # u32 with folding or the sorted order, other dtypes and empty inputs
    # take the numpy path
    assert cnative.compress_patterns_native(codes, False, True) is None
    assert cnative.compress_patterns_native(codes, True, False) is None
    assert cnative.compress_patterns_native(codes.astype(np.int64), False,
                                            False) is None
    assert cnative.compress_patterns_native(
        np.zeros((3, 0), np.uint8), False, False) is None


def test_library_is_built_under_the_port_build_dir():
    assert cnative.available(), cnative.ERROR
    lib = Path(cnative._LIB._name).resolve()
    assert lib.parent == _build.BUILD.resolve()
    assert lib == _build.build_host("compress").resolve()
    assert lib.name.startswith("compress-") and lib.suffix == ".so"


def test_env_switch_forces_the_numpy_path(monkeypatch):
    codes = MASKS[np.random.default_rng(1).integers(0, 5, (8, 100))]
    nat = C.compress_patterns(codes, jc69_fold=True)
    monkeypatch.setenv("BPP_TPU_NATIVE", "0")
    assert not cnative.available()
    calls = cnative.CALLS
    assert cnative.compress_patterns_native(codes, True, False) is None
    pats, w = C.compress_patterns(codes, jc69_fold=True)
    assert cnative.CALLS == calls
    np.testing.assert_array_equal(pats, nat[0])
    np.testing.assert_array_equal(w, nat[1])
    assert w.sum() == 100 and pats.shape[0] == 8
    monkeypatch.delenv("BPP_TPU_NATIVE")
    assert cnative.available()
