"""Per-locus pruning log-likelihoods through kernel K1 (CUDA) or its plain
PyTorch version.

Port of ``bpp_tpu/core/pallas_pack.py`` ``site_logl_packed``: the same
argument convention minus the TPU lane-packing layout.  On a CUDA
tensor :func:`site_logl_packed` checks its inputs and launches the
hand-written kernel in ``csrc/pack_kernel.cu``, which computes branch
lengths and exponential factors itself, or raises; it never falls back.
The kernel has a float32 and a float64 build (``--x64``): the inputs'
dtype picks one, and the CLV store is planned for its element size.
On a CPU tensor it computes the same function with
:func:`site_logl_packed_ref`, the port's ``felsenstein.loglikelihood``
over ``compute_pmats``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..config import SubstModel
from ..trees.gtree import GTrees
from . import felsenstein as fe
from .efactors import model_family
from .pmatrix import pmatrix_model
from .units import Units

# kernel launches since import (reset by callers that count a run), and
# those of the float64 build among them; counted per Python call, so a
# replayed CUDA graph adds the launches it captured (mcmc.graph.StepGraph)
LAUNCHES = 0
LAUNCHES_F64 = 0
# the CLV store of the last launch: "shared" or "global"
CLV_STORE = None
# threads per block of both kernels.  Shared memory sets how many warps an SM holds, and
# small blocks pack it best: measured on an H100, 64 and 128 threads tie up
# to 4 rate categories and 64 wins at 8 (three 70 KB blocks an SM against
# one of 140 KB); 256 loses from 4 categories on (PERF.md)
BLOCK_THREADS = 64
# shared memory a block may use on sm_90 (227 KB), less K1's partials
BLOCK_SHARED = 232448 - 256
# the most rate categories for which the float64 build keeps its CLVs in
# shared memory; above it they go to the device scratch (plan_launch).
# Measured at 1000 loci on an NVIDIA H100 80GB HBM3, 700 W (PERF.md §6):
# K2 at HKY, shared against global, 0.0283 / 0.0367 ms at C = 1,
# 0.0335 / 0.0506 at 2, 0.0517 / 0.0612 at 3, then 0.0820 / 0.0714 at 4 and
# 0.2836 / 0.1363 at 8, where a warp's CLVs leave an SM 6 and 2 warps; K1
# at JC69 likewise (C = 4: 0.0245 / 0.0193)
F64_SHARED_MAX_CATS = 3

_FAM_CODE = {"jc69": 0, "tn93": 1, "gtr": 2}
# the dtypes the kernels are built for
KERNEL_DTYPES = (torch.float32, torch.float64)


def scaled_lengths(order, left, right, parent, age, mu, rates_kappa, n_cats,
                   blen):
    """Rate-scaled branch lengths ``[L, N, C]`` of every (node, category);
    ``blen`` overrides the strict-clock lengths."""
    if blen is None:
        blen = fe.branch_lengths(GTrees(left, right, parent, age), mu)
    return blen[:, :, None] * rates_kappa[:, None, :n_cats]


# the arguments of K1 and K2 that are a chain's own under chains = K
# ([K, L, ...] in a call over K chains); the others (tips, weights, n_seq,
# n_pat and the unit table) are the batch's, one copy for every chain
PER_CHAIN = ("order", "left", "right", "parent", "age", "mu", "rates_kappa",
             "freqs", "eigw", "eigT", "eigTi", "blen")


def chain_count(age):
    """K of a call over K chains (ages ``[K, L, N]``), None for one chain
    (``[L, N]``)."""
    return age.shape[0] if age.dim() == 3 else None


def flatten_chains(K, per_chain, shared):
    """A call over K chains as one call over K x L loci (the plain
    versions: on the CPU, and the 20-state pass on either device): the
    per-chain tensors ``[K, L, ...]`` merged to ``[K L, ...]``, the
    batch's repeated for every chain."""
    return ([None if t is None else t.reshape((-1,) + tuple(t.shape[2:]))
             for t in per_chain],
            [None if t is None else
             t.expand((K,) + tuple(t.shape)).reshape((-1,)
                                                     + tuple(t.shape[1:]))
             for t in shared])


def site_logl_packed_ref(order, left, right, parent, n_seq, age, mu,
                         rates_kappa, freqs, eigw, eigT, eigTi, tips,
                         weights, *, model: SubstModel, n_cats: int,
                         blen=None):
    """Plain PyTorch per-locus log-likelihoods ``[L]`` (same signature as
    :func:`site_logl_packed`).

    ``tips [L, T, S, 4]`` tip partials, ``weights [L, S]`` pattern
    counts, ``rates_kappa [L, C+2]`` category rates with kappa1, kappa2
    appended.  Over K chains (``PER_CHAIN`` arguments ``[K, L, ...]``)
    the K x L loci are one batch, and the result is ``[K, L]``."""
    K = chain_count(age)
    if K is not None:
        (order, left, right, parent, age, mu, rates_kappa, freqs, eigw, eigT,
         eigTi, blen), (n_seq, tips, weights) = flatten_chains(
            K, (order, left, right, parent, age, mu, rates_kappa, freqs,
                eigw, eigT, eigTi, blen), (n_seq, tips, weights))
        return site_logl_packed_ref(
            order, left, right, parent, n_seq, age, mu, rates_kappa, freqs,
            eigw, eigT, eigTi, tips, weights, model=model, n_cats=n_cats,
            blen=blen).reshape(K, -1)
    C = n_cats
    t_eff = scaled_lengths(order, left, right, parent, age, mu, rates_kappa,
                           C, blen)
    pmats = pmatrix_model(model, t_eff, freqs, rates_kappa[:, C],
                          rates_kappa[:, C + 1], eigw, eigT, eigTi)
    cw = torch.full((C,), 1.0 / C, dtype=tips.dtype, device=tips.device)
    return fe.loglikelihood(GTrees(left, right, parent, age), tips, weights,
                            n_seq, pmats, freqs, cw, order=order)


class _ChainPass(torch.autograd.Function):
    """A kernel call of the batched step (``torch.func.vmap`` over the
    chains): :meth:`vmap` hands the wrapper the K chains' tensors of
    ``per_chain`` on a leading chain axis, so that one call (one launch
    on the card) covers every chain, where ``vmap`` would otherwise run
    the wrapper's ops chain by chain or refuse its launch."""

    @staticmethod
    def forward(fn, static, names, per_chain, *tensors):
        return fn(**dict(zip(names, tensors)), **static)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, fn, static, names, per_chain, *tensors):
        K = info.batch_size
        args = {}
        for name, t, d in zip(names, tensors, in_dims[4:]):
            if t is not None and name in per_chain:
                # the kernels read [K, L, ...] rows chain after chain
                t = (t.movedim(d, 0).contiguous() if d is not None
                     else t.expand((K,) + tuple(t.shape)))
            elif d is not None:
                raise ValueError(f"{name} is the batch's, one copy for every "
                                 "chain; it came with a chain axis")
            args[name] = t
        return fn(**args, **static), 0


def chain_pass(fn, tensors: dict, per_chain=PER_CHAIN, **static):
    """``fn(**tensors, **static)`` inside the batched step: one call over
    the K chains (:class:`_ChainPass`), in which the tensors ``per_chain``
    names carry a leading chain axis and the others are the batch's, one
    copy for every chain.  ``fn`` is :func:`site_logl_packed` or
    ``fels.site_logl_fels`` (``per_chain``: :data:`PER_CHAIN`), or an
    accept chain's wrapper (``mcmc.notheta.chain_accept``,
    ``mcmc.clock_moves.gammadir_chain``).  Outside ``vmap`` it is the
    plain call."""
    return _ChainPass.apply(fn, static, tuple(tensors), tuple(per_chain),
                            *tensors.values())


def refuse_under_capture(who):
    """A wrapper given no unit table builds one, which copies to the card:
    under CUDA-graph capture that copy would be recorded from host memory
    that is gone at replay, so the captured path must pass the batch's
    static table."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{who}: pass the batch's static unit table "
                           "(units=...) under CUDA-graph capture")


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


class LaunchPlan(NamedTuple):
    """How one launch is laid out on the card."""

    clv_store: str          # "shared" or "global"
    threads: int            # per block
    shared_bytes: int       # dynamic shared memory per block


def plan_launch(who, warp_bytes, T, C, fam, clv_store, threads,
                dbl=False) -> LaunchPlan:
    """Lay out one launch.  ``warp_bytes(T, C, family, shared)`` asks the
    built kernel for one warp's shared memory under either store; ``dbl``
    says the launch is of the float64 build.

    The CLVs go to shared memory where one warp's CLV slots, factors and
    plan fit a block's shared memory, else to the device scratch; the
    float64 build takes the device scratch also above
    ``F64_SHARED_MAX_CATS`` categories, where it measured faster.  The
    block shrinks to the warps that fit; a tree too large even for the
    global store's factors and plan is refused."""
    if clv_store not in (None, "shared", "global"):
        raise ValueError(f"{who}: clv_store is {clv_store!r}; 'shared', "
                         "'global' or None")
    if threads % 32 or not 32 <= threads <= 1024:
        raise ValueError(f"{who}: {threads} threads per block; a multiple "
                         "of 32 up to 1024")
    if clv_store is None:
        fits = warp_bytes(T, C, fam, 1) <= BLOCK_SHARED
        clv_store = ("shared" if fits and not (dbl and C > F64_SHARED_MAX_CATS)
                     else "global")
    per_warp = warp_bytes(T, C, fam, int(clv_store == "shared"))
    warps = min(threads // 32, BLOCK_SHARED // per_warp)
    if warps < 1:
        raise ValueError(
            f"{who}: a tree of {T} tips with {C} rate categories needs "
            f"{per_warp} B of shared memory per warp under the {clv_store} "
            f"CLV store; a block has {BLOCK_SHARED}")
    return LaunchPlan(clv_store, 32 * warps, warps * per_warp)


def tree_tensors(who, lib_prefix, lib, order, left, right, parent, n_seq, age,
                 mu, rates_kappa, freqs, eigw, eigT, eigTi, tips, units, *,
                 model: SubstModel, n_cats: int, blen, clv_store, threads):
    """What kernels K1 and K2 both read, checked: the tensors in the order
    of the C signature up to the CLV scratch (tips, age, blen, mu,
    rates_kappa, freqs, eigw, eigT, eigTi, order, left, right, n_seq,
    units, scratch), the model family's code and the launch plan.  The
    tips' dtype (float32 or float64) picks the kernel's build, and every
    parameter must have it.  Over K chains the ``PER_CHAIN`` tensors are
    ``[K, L, ...]`` and the scratch holds K chains' units.  Nothing is
    computed here: branch lengths and factors are the kernel's prologue.
    The scratch exists only under the global CLV store."""
    if tips.device.type != "cuda":
        raise ValueError(f"{who}: the kernel takes CUDA tensors, "
                         f"got {tips.device}")
    dev = tips.device
    L, T, S, A = tips.shape
    N = 2 * T - 1
    C = n_cats
    dt = tips.dtype
    K = chain_count(age)
    # a chain's tensors carry the chain axis first over K chains
    lead = (L,) if K is None else (K, L)
    if dt not in KERNEL_DTYPES:
        raise TypeError(f"{who}: tips have dtype {dt}, the kernel takes "
                        "float32 or float64")
    if A != 4:
        raise ValueError(f"{who}: the kernel takes 4-state data")
    if T < 2:
        raise ValueError(f"{who}: the kernel takes a tip capacity >= 2")
    max_cats = getattr(lib, f"{lib_prefix}_max_cats")()
    if not 1 <= C <= max_cats:
        raise ValueError(f"{who}: {C} rate categories; the kernel "
                         f"takes 1..{max_cats}")
    check_tensor(who, "tips", tips, dt, (L, T, S, 4), dev)
    for nm, t, shape in (("order", order, lead + (T - 1,)),
                         ("left", left, lead + (N,)),
                         ("right", right, lead + (N,)),
                         ("parent", parent, lead + (N,)),
                         ("n_seq", n_seq, (L,))):
        check_tensor(who, nm, t, torch.int64, shape, dev)

    def param(name, t, shape):
        # a view (an expanded prior mean, say) is copied; a contiguous
        # tensor is passed as it is
        t = t.contiguous()
        check_tensor(who, name, t, dt, shape, dev)
        return t

    age = param("age", age, lead + (N,))
    mu = param("mu", mu, lead)
    rates_kappa = param("rates_kappa", rates_kappa, lead + (C + 2,))
    freqs = param("freqs", freqs, lead + (4,))
    eigw = param("eigw", eigw, lead + (4,))
    eigT = param("eigT", eigT, lead + (4, 4))
    eigTi = param("eigTi", eigTi, lead + (4, 4))
    if blen is not None:
        blen = param("blen", blen, lead + (N,))
    if (units.n_loci, units.n_cols, units.units.device) != (L, S, dev):
        raise ValueError(
            f"{who}: the unit table is for {units.n_loci} loci of "
            f"{units.n_cols} columns on {units.units.device}, the tips have "
            f"{L} loci of {S} columns on {dev}")
    fam = _FAM_CODE[model_family(model)]
    dbl = int(dt == torch.float64)
    warp_bytes = getattr(lib, f"{lib_prefix}_warp_bytes")
    plan = plan_launch(who, lambda *a: warp_bytes(*a, dbl), T, C, fam,
                       clv_store, threads, bool(dbl))
    scratch = None
    if plan.clv_store == "global":
        scratch = torch.empty(((K or 1) * units.n_units, T // 2, C, 32, 4),
                              dtype=dt, device=dev)
    tensors = (tips, age, blen, mu, rates_kappa, freqs, eigw, eigT, eigTi,
               order, left, right, n_seq, units.units, scratch)
    return tensors, fam, plan


def kernel_lib(name, prefix, entry, n_ptrs, n_ints):
    """The built library ``name`` of one pruning kernel, with its C
    signatures declared: ``entry`` takes ``n_ptrs`` pointers, ``n_ints``
    ints and the stream; ``<prefix>_warp_bytes``, ``<prefix>_max_cats`` and
    ``<prefix>_occupancy`` are the same in both libraries."""
    from ._build import load
    lib = load(name)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints \
            + [ctypes.c_void_p]
        warp_bytes = getattr(lib, f"{prefix}_warp_bytes")
        warp_bytes.restype = ctypes.c_longlong
        warp_bytes.argtypes = [ctypes.c_int] * 5
        max_cats = getattr(lib, f"{prefix}_max_cats")
        max_cats.restype = ctypes.c_int
        max_cats.argtypes = []
        occupancy = getattr(lib, f"{prefix}_occupancy")
        occupancy.restype = ctypes.c_int
        occupancy.argtypes = [ctypes.c_int] * 5 + [ctypes.c_longlong]
    return lib


def _kernel_lib():
    """The built K1 library."""
    lib = kernel_lib("pack_kernel", "bpp_pack", "bpp_pack_logl", 19, 12)
    if lib.bpp_pack_empty.argtypes is None:
        lib.bpp_pack_empty.restype = ctypes.c_int
        lib.bpp_pack_empty.argtypes = [ctypes.c_void_p]
    return lib


class KernelArgs(NamedTuple):
    """Everything one launch of K1 or K2 reads and writes (tensors on the
    card; ``None`` for an absent ``blen`` or scratch)."""

    tensors: tuple          # tree_tensors' 15, then the kernel's own; the
    #                         output last
    dims: tuple             # the C signature's ints; the last two are
    #                         the chains K and the loci L a chain
    plan: LaunchPlan


def site_logl_packed(order, left, right, parent, n_seq, age, mu,
                     rates_kappa, freqs, eigw, eigT, eigTi, tips, weights,
                     *, model: SubstModel, n_cats: int, blen=None,
                     units: Units | None = None, clv_store=None):
    """Per-locus log-likelihoods ``[L]`` of 4-state, non-diploid data.

    CUDA tensors: float32 or float64 state (the kernel's build of that
    type), int64 indices; checks and one kernel launch,
    which computes branch lengths, exponential factors, pruning, rescaling,
    root reduction and pattern weighting.  ``units`` is the batch's static
    unit table (:class:`core.units.Units`, built once per run from
    ``n_pat``); without it every column counts as a real pattern.
    ``clv_store`` forces the kernel's ``"shared"`` or ``"global"`` CLV
    store; by default the wrapper takes the shared one where the tree
    fits, in float64 only up to ``F64_SHARED_MAX_CATS`` categories
    (:func:`plan_launch`).  CPU tensors: the plain version.

    Over K chains (chains = K) the ``PER_CHAIN`` arguments are ``[K, L,
    ...]``, the rest the batch's, and the result ``[K, L]``: on the card
    one launch for all K (a grid row a chain), chain k's row bit-equal to
    a launch on chain k's tensors alone."""
    if tips.device.type == "cpu":
        return site_logl_packed_ref(
            order, left, right, parent, n_seq, age, mu, rates_kappa, freqs,
            eigw, eigT, eigTi, tips, weights, model=model, n_cats=n_cats,
            blen=blen)
    return launch(kernel_args(
        order, left, right, parent, n_seq, age, mu, rates_kappa, freqs,
        eigw, eigT, eigTi, tips, weights, model=model, n_cats=n_cats,
        blen=blen, units=units, clv_store=clv_store))


def kernel_args(order, left, right, parent, n_seq, age, mu, rates_kappa,
                freqs, eigw, eigT, eigTi, tips, weights, *,
                model: SubstModel, n_cats: int, blen=None,
                units: Units | None = None, clv_store=None,
                threads: int | None = None) -> KernelArgs:
    """Check the inputs of one K1 launch, plan it and allocate its output
    (and, under the global CLV store only, its scratch).  ``threads``
    overrides the block size."""
    who = "site_logl_packed"
    if units is None and tips.device.type == "cuda":
        refuse_under_capture(who)
        units = Units([tips.shape[2]] * tips.shape[0], tips.shape[2],
                      tips.device)
    tree, fam, plan = tree_tensors(
        who, "bpp_pack", _kernel_lib(), order, left, right, parent, n_seq,
        age, mu, rates_kappa, freqs, eigw, eigT, eigTi, tips, units,
        model=model, n_cats=n_cats, blen=blen, clv_store=clv_store,
        threads=threads or BLOCK_THREADS)
    L, T, S, _ = tips.shape
    K = chain_count(age)
    W = weights.shape[1]
    check_tensor(who, "weights", weights, tips.dtype, (L, W), tips.device)
    if W > S:
        raise ValueError(f"{who}: more weights than patterns")
    out = torch.empty((L,) if K is None else (K, L), dtype=tips.dtype,
                      device=tips.device)
    blocks = units.blocks(plan.threads // 32)
    tensors = tree + (weights, blocks, units.locus_unit0, out)
    dims = (T, S, units.n_units, W, blocks.shape[0], n_cats, fam,
            int(plan.clv_store == "shared"), plan.threads,
            int(tips.dtype == torch.float64), K or 1, L)
    return KernelArgs(tensors, dims, plan)


def data_ptrs(tensors):
    return [None if t is None else t.data_ptr() for t in tensors]


def launch(args: KernelArgs):
    """One launch of K1 on the current stream; returns the ``[L]`` output
    (``[K, L]`` over K chains)."""
    global LAUNCHES, LAUNCHES_F64, CLV_STORE
    out = args.tensors[-1]
    stream = torch.cuda.current_stream(out.device).cuda_stream
    rc = _kernel_lib().bpp_pack_logl(*data_ptrs(args.tensors), *args.dims,
                                     stream)
    if rc != 0:
        raise RuntimeError(f"pack_kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    LAUNCHES_F64 += int(out.dtype == torch.float64)
    CLV_STORE = args.plan.clv_store
    return out


def occupancy(query, args: KernelArgs) -> int:
    """Blocks of ``args``' launch one SM holds: ``query`` is a kernel
    library's ``<prefix>_occupancy`` (the CUDA occupancy API), asked at
    the plan's threads and shared memory with the part both kernels' dims
    share before the chains: (C, family, shared, threads, dbl)."""
    blocks = query(*args.dims[-7:-2], args.plan.shared_bytes)
    if blocks < 0:
        raise RuntimeError("the occupancy query failed")
    return blocks


def blocks_per_sm(args: KernelArgs) -> int:
    """Blocks of one K1 launch an SM holds."""
    return occupancy(_kernel_lib().bpp_pack_occupancy, args)


def launch_empty(device):
    """Launch a kernel that does nothing: the card's launch floor, timed
    beside K1.  Not counted in ``LAUNCHES``."""
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = _kernel_lib().bpp_pack_empty(stream)
    if rc != 0:
        raise RuntimeError(f"empty kernel launch failed: cudaError {rc}")
