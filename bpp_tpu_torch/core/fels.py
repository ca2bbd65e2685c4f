"""Per-pattern pruning log-likelihoods through kernel K2 (CUDA) or its
plain PyTorch version.

Port of ``bpp_tpu/core/pallas_fels.py`` ``site_logl_pallas``: the same
argument convention, with the tips as the port lays them out
(``[L, T, S, 4]``; the A-major transpose and the padding of the pattern
axis to 128 lanes were TPU tiling).  This is the likelihood pass of
batches with a diploid resolution map: the ``[L, S]`` output goes through
``felsenstein.reduce_root``, which averages each weight pattern's phase
resolutions.  On a CUDA tensor :func:`site_logl_fels` launches the
hand-written kernel in ``csrc/fels_kernel.cu`` or raises; it never falls
back.  On a CPU tensor it computes the same function with
:func:`site_logl_fels_ref`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..config import SubstModel
from ..trees.gtree import GTrees
from . import felsenstein as fe
from .pack import check_tensor, scaled_lengths, tree_tensors
from .pmatrix import pmatrix_model

# kernel launches since import (reset by callers that count a run)
LAUNCHES = 0


def site_logl_fels_ref(order, left, right, parent, n_seq, age, mu,
                       rates_kappa, freqs, eigw, eigT, eigTi, tips, *,
                       model: SubstModel, n_cats: int, blen=None,
                       n_pat=None):
    """Plain PyTorch per-pattern log-likelihoods ``[L, S]`` (same signature
    as :func:`site_logl_fels`).

    ``tips [L, T, S, 4]`` tip partials, ``rates_kappa [L, C+2]`` category
    rates with kappa1, kappa2 appended, ``n_pat [L]`` real patterns per
    locus: columns ``s >= n_pat[l]`` are exactly 0."""
    C = n_cats
    t_eff = scaled_lengths(order, left, right, parent, age, mu, rates_kappa,
                           C, blen)
    pmats = pmatrix_model(model, t_eff, freqs, rates_kappa[:, C],
                          rates_kappa[:, C + 1], eigw, eigT, eigTi)
    cw = torch.full((C,), 1.0 / C, dtype=tips.dtype, device=tips.device)
    site = fe.site_loglikelihood(GTrees(left, right, parent, age), tips,
                                 n_seq, pmats, freqs, cw, order=order)
    if n_pat is None:
        return site
    live = torch.arange(site.shape[1], device=site.device) < n_pat[:, None]
    return torch.where(live, site, torch.zeros_like(site))


def _kernel_lib():
    """The built K2 library, with its C signature declared."""
    from ._build import load
    lib = load("fels_kernel")
    fn = lib.bpp_fels_site_logl
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
    return lib


class KernelArgs(NamedTuple):
    """Everything one launch of K2 reads and writes (tensors on the card)."""

    tensors: tuple          # tips, efac, coefs, eigT, eigTi, freqs, order,
    #                         left, right, n_seq, n_pat, scratch, out
    dims: tuple             # L, T, S, C, family code


def site_logl_fels(order, left, right, parent, n_seq, age, mu, rates_kappa,
                   freqs, eigw, eigT, eigTi, tips, *, model: SubstModel,
                   n_cats: int, blen=None, n_pat=None):
    """Per-pattern log-likelihoods ``[L, S]`` of 4-state data.

    CUDA tensors: f32 state, int64 indices; the rate-scaled branch
    lengths and exponential factors are one elementwise pass here, the
    pruning, rescaling and root value of every pattern are one kernel
    launch.  CPU tensors: the plain version."""
    if tips.device.type == "cpu":
        return site_logl_fels_ref(
            order, left, right, parent, n_seq, age, mu, rates_kappa, freqs,
            eigw, eigT, eigTi, tips, model=model, n_cats=n_cats, blen=blen,
            n_pat=n_pat)
    return launch(kernel_args(
        order, left, right, parent, n_seq, age, mu, rates_kappa, freqs,
        eigw, eigT, eigTi, tips, model=model, n_cats=n_cats, blen=blen,
        n_pat=n_pat))


def kernel_args(order, left, right, parent, n_seq, age, mu, rates_kappa,
                freqs, eigw, eigT, eigTi, tips, *, model: SubstModel,
                n_cats: int, blen=None, n_pat=None) -> KernelArgs:
    """Check the inputs of one K2 launch and prepare its factors, scratch
    and output on the card."""
    who = "site_logl_fels"
    tree, fam = tree_tensors(
        who, lambda: _kernel_lib().bpp_fels_max_cats(), order, left, right,
        parent, n_seq, age, mu, rates_kappa, freqs, eigw, eigT, eigTi, tips,
        model=model, n_cats=n_cats, blen=blen)
    L, T, S, _ = tips.shape
    if n_pat is None:
        n_pat = torch.full((L,), S, dtype=torch.int64, device=tips.device)
    check_tensor(who, "n_pat", n_pat, torch.int64, (L,), tips.device)
    out = torch.empty((L, S), dtype=torch.float32, device=tips.device)
    # the C signature's order: ..., n_seq, n_pat, scratch, out
    tensors = tree[:-1] + (n_pat, tree[-1], out)
    return KernelArgs(tensors, (L, T, S, n_cats, fam))


def launch(args: KernelArgs):
    """One launch of K2 on the current stream; returns the ``[L, S]``
    output."""
    global LAUNCHES
    out = args.tensors[-1]
    stream = torch.cuda.current_stream(out.device).cuda_stream
    rc = _kernel_lib().bpp_fels_site_logl(
        *(t.data_ptr() for t in args.tensors), *args.dims, stream)
    if rc != 0:
        raise RuntimeError(f"fels_kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out
