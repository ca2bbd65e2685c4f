"""Per-pattern pruning log-likelihoods through kernel K2 (CUDA) or its
plain PyTorch version.

Port of ``bpp_tpu/core/pallas_fels.py`` ``site_logl_pallas``: the same
argument convention, with the tips as the port lays them out
(``[L, T, S, 4]``; the A-major transpose and the padding of the pattern
axis to 128 lanes were TPU tiling).  This is the likelihood pass of
batches with a diploid resolution map: the ``[L, S]`` output goes through
``felsenstein.reduce_root``, which averages each weight pattern's phase
resolutions.  On a CUDA tensor :func:`site_logl_fels` checks its inputs and
launches the hand-written kernel in ``csrc/fels_kernel.cu``, which computes
branch lengths and exponential factors itself, or raises; it never falls
back; the kernel has a float32 and a float64 build, and the inputs' dtype
picks one.  On a CPU tensor it computes the same function with
:func:`site_logl_fels_ref`.
"""

from __future__ import annotations

import torch

from ..config import SubstModel
from ..trees.gtree import GTrees
from . import felsenstein as fe
from .pack import (
    BLOCK_THREADS, KernelArgs, chain_count, check_tensor, data_ptrs,
    flatten_chains, kernel_lib, occupancy, refuse_under_capture,
    scaled_lengths, tree_tensors,
)
from .pmatrix import pmatrix_model
from .units import Units

# kernel launches since import (reset by callers that count a run), and
# those of the float64 build among them; a replayed CUDA graph adds the
# launches it captured (mcmc.graph.StepGraph)
LAUNCHES = 0
LAUNCHES_F64 = 0
# the CLV store of the last launch: "shared" or "global"
CLV_STORE = None


def site_logl_fels_ref(order, left, right, parent, n_seq, age, mu,
                       rates_kappa, freqs, eigw, eigT, eigTi, tips, *,
                       model: SubstModel, n_cats: int, blen=None,
                       n_pat=None):
    """Plain PyTorch per-pattern log-likelihoods ``[L, S]`` (same signature
    as :func:`site_logl_fels`); also the likelihood pass of 20-state
    batches on any device, which no kernel takes.

    ``tips [L, T, S, A]`` tip partials (A = 4, or 20), ``rates_kappa [L, C+2]`` category
    rates with kappa1, kappa2 appended, ``n_pat [L]`` real patterns per
    locus: columns ``s >= n_pat[l]`` are exactly 0.  Over K chains
    (``pack.PER_CHAIN`` arguments ``[K, L, ...]``) the K x L loci are one
    batch, and the result is ``[K, L, S]``."""
    K = chain_count(age)
    if K is not None:
        (order, left, right, parent, age, mu, rates_kappa, freqs, eigw, eigT,
         eigTi, blen), (n_seq, tips, n_pat) = flatten_chains(
            K, (order, left, right, parent, age, mu, rates_kappa, freqs,
                eigw, eigT, eigTi, blen), (n_seq, tips, n_pat))
        site = site_logl_fels_ref(
            order, left, right, parent, n_seq, age, mu, rates_kappa, freqs,
            eigw, eigT, eigTi, tips, model=model, n_cats=n_cats, blen=blen,
            n_pat=n_pat)
        return site.reshape((K, -1) + tuple(site.shape[1:]))
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
    """The built K2 library."""
    return kernel_lib("fels_kernel", "bpp_fels", "bpp_fels_site_logl", 16, 10)


def site_logl_fels(order, left, right, parent, n_seq, age, mu, rates_kappa,
                   freqs, eigw, eigT, eigTi, tips, *, model: SubstModel,
                   n_cats: int, blen=None, n_pat=None,
                   units: Units | None = None, clv_store=None):
    """Per-pattern log-likelihoods ``[L, S]`` of 4-state data.

    CUDA tensors: float32 or float64 state (the kernel's build of that
    type), int64 indices; checks and one kernel launch,
    which computes branch lengths, exponential factors, pruning, rescaling
    and the root value of every real pattern, and writes 0 to the columns
    past ``n_pat``.  ``units`` is the batch's static unit table
    (:class:`core.units.Units`, built once per run from the same
    ``n_pat``); without it the wrapper builds one from ``n_pat``, which
    copies ``n_pat`` to the host.  ``clv_store`` forces the kernel's
    ``"shared"`` or ``"global"`` CLV store; by default the wrapper takes
    the shared one where the tree fits, in float64 only up to
    ``pack.F64_SHARED_MAX_CATS`` categories (``pack.plan_launch``).  CPU
    tensors: the plain version.

    Over K chains (chains = K) the ``pack.PER_CHAIN`` arguments are ``[K,
    L, ...]`` and the result ``[K, L, S]``: on the card one launch for all
    K, chain k's rows bit-equal to a launch on chain k's tensors alone."""
    if tips.device.type == "cpu":
        return site_logl_fels_ref(
            order, left, right, parent, n_seq, age, mu, rates_kappa, freqs,
            eigw, eigT, eigTi, tips, model=model, n_cats=n_cats, blen=blen,
            n_pat=n_pat)
    return launch(kernel_args(
        order, left, right, parent, n_seq, age, mu, rates_kappa, freqs,
        eigw, eigT, eigTi, tips, model=model, n_cats=n_cats, blen=blen,
        n_pat=n_pat, units=units, clv_store=clv_store))


def kernel_args(order, left, right, parent, n_seq, age, mu, rates_kappa,
                freqs, eigw, eigT, eigTi, tips, *, model: SubstModel,
                n_cats: int, blen=None, n_pat=None,
                units: Units | None = None, clv_store=None,
                threads: int | None = None) -> KernelArgs:
    """Check the inputs of one K2 launch, plan it and allocate its output
    (and, under the global CLV store only, its scratch).  ``threads``
    overrides the block size."""
    who = "site_logl_fels"
    if units is None and tips.device.type == "cuda":
        refuse_under_capture(who)
        L, _, S, _ = tips.shape
        if n_pat is not None:
            check_tensor(who, "n_pat", n_pat, torch.int64, (L,), tips.device)
        units = Units([S] * L if n_pat is None else n_pat.cpu().numpy(), S,
                      tips.device)
    tree, fam, plan = tree_tensors(
        who, "bpp_fels", _kernel_lib(), order, left, right, parent, n_seq,
        age, mu, rates_kappa, freqs, eigw, eigT, eigTi, tips, units,
        model=model, n_cats=n_cats, blen=blen, clv_store=clv_store,
        threads=threads or BLOCK_THREADS)
    L, T, S, _ = tips.shape
    K = chain_count(age)
    out = torch.empty((L, S) if K is None else (K, L, S), dtype=tips.dtype,
                      device=tips.device)
    dims = (T, S, units.n_units, n_cats, fam,
            int(plan.clv_store == "shared"), plan.threads,
            int(tips.dtype == torch.float64), K or 1, L)
    return KernelArgs(tree + (out,), dims, plan)


def launch(args: KernelArgs):
    """One launch of K2 on the current stream; returns the ``[L, S]``
    output (``[K, L, S]`` over K chains)."""
    global LAUNCHES, LAUNCHES_F64, CLV_STORE
    out = args.tensors[-1]
    stream = torch.cuda.current_stream(out.device).cuda_stream
    rc = _kernel_lib().bpp_fels_site_logl(*data_ptrs(args.tensors),
                                          *args.dims, stream)
    if rc != 0:
        raise RuntimeError(f"fels_kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    LAUNCHES_F64 += int(out.dtype == torch.float64)
    CLV_STORE = args.plan.clv_store
    return out


def blocks_per_sm(args: KernelArgs) -> int:
    """Blocks of one K2 launch an SM holds."""
    return occupancy(_kernel_lib().bpp_fels_occupancy, args)
