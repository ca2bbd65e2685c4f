"""Per-locus pruning log-likelihoods through kernel K1 (CUDA) or its plain
PyTorch version.

Port of ``bpp_tpu/core/pallas_pack.py`` ``site_logl_packed``: the same
argument convention minus the TPU lane-packing layout.  On a CUDA
tensor :func:`site_logl_packed` launches the hand-written kernel in
``csrc/pack_kernel.cu`` or raises; it never falls back.  On a CPU
tensor it computes the same function with :func:`site_logl_packed_ref`,
the port's ``felsenstein.loglikelihood`` over ``compute_pmats``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..config import SubstModel
from ..trees.gtree import GTrees
from . import felsenstein as fe
from .efactors import efactors, model_family
from .pmatrix import pmatrix_model

# kernel launches since import (reset by callers that count a run)
LAUNCHES = 0

_FAM_CODE = {"jc69": 0, "tn93": 1, "gtr": 2}


def scaled_lengths(order, left, right, parent, age, mu, rates_kappa, n_cats,
                   blen):
    """Rate-scaled branch lengths ``[L, N, C]`` of every (node, category);
    ``blen`` overrides the strict-clock lengths."""
    if blen is None:
        blen = fe.branch_lengths(GTrees(left, right, parent, age), mu)
    return blen[:, :, None] * rates_kappa[:, None, :n_cats]


def site_logl_packed_ref(order, left, right, parent, n_seq, age, mu,
                         rates_kappa, freqs, eigw, eigT, eigTi, tips,
                         weights, *, model: SubstModel, n_cats: int,
                         blen=None):
    """Plain PyTorch per-locus log-likelihoods ``[L]`` (same signature as
    :func:`site_logl_packed`).

    ``tips [L, T, S, 4]`` tip partials, ``weights [L, S]`` pattern
    counts, ``rates_kappa [L, C+2]`` category rates with kappa1, kappa2
    appended."""
    C = n_cats
    t_eff = scaled_lengths(order, left, right, parent, age, mu, rates_kappa,
                           C, blen)
    pmats = pmatrix_model(model, t_eff, freqs, rates_kappa[:, C],
                          rates_kappa[:, C + 1], eigw, eigT, eigTi)
    cw = torch.full((C,), 1.0 / C, dtype=tips.dtype, device=tips.device)
    return fe.loglikelihood(GTrees(left, right, parent, age), tips, weights,
                            n_seq, pmats, freqs, cw, order=order)


def check_tensor(who, name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{who}: {name} is on {t.device}, "
                         f"expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{who}: {name} has dtype {t.dtype}, "
                        f"the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{who}: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{who}: {name} is not contiguous")


def tree_tensors(who, max_cats, order, left, right, parent, n_seq, age, mu,
                 rates_kappa, freqs, eigw, eigT, eigTi, tips, *,
                 model: SubstModel, n_cats: int, blen=None):
    """What kernels K1 and K2 both read, checked and prepared on the card:
    (tips, efac, coefs, eigT, eigTi, freqs, order, left, right, n_seq,
    CLV scratch) and the model family's code.  ``max_cats()`` asks the
    built kernel for the most rate categories it takes."""
    if tips.device.type != "cuda":
        raise ValueError(f"{who}: the kernel takes CUDA tensors, "
                         f"got {tips.device}")
    dev = tips.device
    L, T, S, A = tips.shape
    N = 2 * T - 1
    C = n_cats
    f32 = torch.float32
    if A != 4:
        raise ValueError(f"{who}: the kernel takes 4-state data")
    if not 1 <= C <= max_cats():
        raise ValueError(f"{who}: {C} rate categories; the kernel "
                         f"takes 1..{max_cats()}")
    check_tensor(who, "tips", tips, f32, (L, T, S, 4), dev)
    for nm, t in (("order", order), ("left", left), ("right", right)):
        check_tensor(who, nm, t, torch.int64,
                     (L, T - 1) if nm == "order" else (L, N), dev)
    check_tensor(who, "n_seq", n_seq, torch.int64, (L,), dev)
    for nm, t in (("age", age), ("mu", mu), ("rates_kappa", rates_kappa),
                  ("freqs", freqs), ("eigw", eigw), ("eigT", eigT),
                  ("eigTi", eigTi)):
        if t.dtype != f32 or t.device != dev:
            raise TypeError(f"{who}: {nm} must be float32 on "
                            f"{dev}, got {t.dtype} on {t.device}")

    t_eff = scaled_lengths(order, left, right, parent, age, mu, rates_kappa,
                           C, blen)
    efac, coefs = efactors(model, t_eff, freqs, rates_kappa[:, C],
                           rates_kappa[:, C + 1], eigw)
    if coefs is None:
        coefs = torch.zeros((L, 10), dtype=f32, device=dev)
    tensors = (tips, efac.contiguous(), coefs.contiguous(),
               eigT.reshape(L, 16).contiguous(),
               eigTi.reshape(L, 16).contiguous(), freqs[:, :4].contiguous(),
               order, left, right, n_seq,
               torch.empty((L, T - 1, C, S, 4), dtype=f32, device=dev))
    return tensors, _FAM_CODE[model_family(model)]


def _kernel_lib():
    """The built K1 library, with its C signature declared."""
    from ._build import load
    lib = load("pack_kernel")
    fn = lib.bpp_pack_logl
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
    return lib


class KernelArgs(NamedTuple):
    """Everything one launch of K1 reads and writes (tensors on the card)."""

    tensors: tuple          # tips, efac, coefs, eigT, eigTi, freqs, weights,
    #                         order, left, right, n_seq, scratch, out
    dims: tuple             # L, T, S, W, C, family code


def site_logl_packed(order, left, right, parent, n_seq, age, mu,
                     rates_kappa, freqs, eigw, eigT, eigTi, tips, weights,
                     *, model: SubstModel, n_cats: int, blen=None):
    """Per-locus log-likelihoods ``[L]`` of 4-state, non-diploid data.

    CUDA tensors: f32 state, int64 indices; the rate-scaled branch
    lengths and exponential factors are one elementwise pass here, the
    pruning, rescaling, root reduction and pattern weighting are one
    kernel launch.  CPU tensors: the plain version."""
    if tips.device.type == "cpu":
        return site_logl_packed_ref(
            order, left, right, parent, n_seq, age, mu, rates_kappa, freqs,
            eigw, eigT, eigTi, tips, weights, model=model, n_cats=n_cats,
            blen=blen)
    return launch(kernel_args(
        order, left, right, parent, n_seq, age, mu, rates_kappa, freqs,
        eigw, eigT, eigTi, tips, weights, model=model, n_cats=n_cats,
        blen=blen))


def kernel_args(order, left, right, parent, n_seq, age, mu, rates_kappa,
                freqs, eigw, eigT, eigTi, tips, weights, *,
                model: SubstModel, n_cats: int, blen=None) -> KernelArgs:
    """Check the inputs of one K1 launch and prepare its factors, scratch
    and output on the card."""
    who = "site_logl_packed"
    tree, fam = tree_tensors(
        who, lambda: _kernel_lib().bpp_pack_max_cats(), order, left, right,
        parent, n_seq, age, mu, rates_kappa, freqs, eigw, eigT, eigTi, tips,
        model=model, n_cats=n_cats, blen=blen)
    L, T, S, _ = tips.shape
    W = weights.shape[1]
    check_tensor(who, "weights", weights, torch.float32, (L, W), tips.device)
    if W > S:
        raise ValueError(f"{who}: more weights than patterns")
    out = torch.empty((L,), dtype=torch.float32, device=tips.device)
    # the C signature's order: ..., freqs, weights, order, ..., scratch, out
    tensors = tree[:6] + (weights,) + tree[6:] + (out,)
    return KernelArgs(tensors, (L, T, S, W, n_cats, fam))


def launch(args: KernelArgs):
    """One launch of K1 on the current stream; returns the ``[L]`` output."""
    global LAUNCHES
    out = args.tensors[-1]
    stream = torch.cuda.current_stream(out.device).cuda_stream
    rc = _kernel_lib().bpp_pack_logl(
        *(t.data_ptr() for t in args.tensors), *args.dims, stream)
    if rc != 0:
        raise RuntimeError(f"pack_kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out
