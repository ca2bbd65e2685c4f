"""Launches of the kernels that replace ``bpp_tpu``'s device control flow
over loci: K3 ``notheta_chain`` and K4 ``gammadir_chain``
(``csrc/chain_kernel.cu``, the serial accept chains of integrated thetas
and of Gamma-Dirichlet locus rates, each resolving several loci a round
by lookahead: :func:`chain_depth`) and K5 ``simspr_walk``
(``csrc/simwalk_kernel.cu``, MSC-M's sim-SPR walk, a warp a locus).

Each ``launch_*`` checks its CUDA tensors, allocates the outputs and
launches on the current stream; a refused launch raises.  K3, K4 and K5
take an optional leading chain axis (``chains = K``'s batched step): one
launch over the K chains, K3's and K4's block k (K5's grid row k) walking
chain k's rows alone, so that each chain's decisions are those of a
one-chain launch on its rows, bit for bit.  The wrappers
that choose between a kernel and its plain version are beside the plain
versions: ``mcmc.notheta.chain_accept``, ``mcmc.clock_moves.
gammadir_accept`` and ``mcmc.mig_moves.simspr_walk``.  The counters count
launches per Python call, as ``pack.LAUNCHES`` does (a replayed CUDA graph
adds the launches it captured, ``mcmc.graph.StepGraph``).
"""

from __future__ import annotations

import ctypes

import torch

from ..trees.gtree import BIG_AGE
from .pack import check_tensor

# launches since import, per kernel (reset by callers that count a run)
LAUNCHES_NOTHETA = 0
LAUNCHES_GAMMADIR = 0
LAUNCHES_SIMWALK = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double


def _lib(name):
    from ._build import load
    return load(name)


def _chain_lib():
    lib = _lib("chain_kernel")
    if lib.bpp_notheta_chain.argtypes is None:
        lib.bpp_notheta_depth.restype = _I
        lib.bpp_notheta_depth.argtypes = [_I]
        lib.bpp_notheta_chain.restype = _I
        lib.bpp_notheta_chain.argtypes = [_P, _P, _I, _I, _I, _D, _D, _P,
                                          _P]
        lib.bpp_gammadir_chain.restype = _I
        lib.bpp_gammadir_chain.argtypes = [_P, _I, _I, _D, _D, _D, _P, _P]
    return lib


def _walk_lib():
    lib = _lib("simwalk_kernel")
    if lib.bpp_simwalk.argtypes is None:
        lib.bpp_simwalk.restype = _I
        lib.bpp_simwalk.argtypes = [_P] * 27 + [_I] * 7 + [_D, _D, _I, _P]
    return lib


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _check_rc(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def chain_depth(H: int = 1) -> int:
    """The loci a K3 launch over ``H`` populations resolves a round:
    the kernels' depth (K4's, and K3's at one population), lower where H
    populations leave too little shared memory for its round; 0 where not
    even one locus a round fits (K3 refuses).  Builds the kernel."""
    return _chain_lib().bpp_notheta_depth(H)


def _chain_axis(who, x, row_dims):
    """(K, the chain axis's shape) of ``x``: ``x`` holds ``row_dims``
    dimensions a chain, after an optional leading chain axis of K."""
    if x.dim() == row_dims:
        return 1, ()
    if x.dim() == row_dims + 1 and x.shape[0] > 0:
        return x.shape[0], (x.shape[0],)
    raise ValueError(f"{who}: {tuple(x.shape)}: {row_dims} dimensions a "
                     "chain, after an optional leading chain axis")


def launch_notheta(cols, sums, H: int, a: float, b: float):
    """K3 on ``cols`` ``[L, 4H + 4]`` float64 (per locus the old and
    candidate counts and scaled waiting sums of the H populations, then
    dother, dh, log u, mask) and ``sums`` ``[2H]`` (K0, C0),
    ``chain_depth(H)`` loci a round; returns accept ``[L]`` bool.  Over K
    chains (``cols [K, L, 4H + 4]``, ``sums [K, 2H]``) one launch of K
    blocks, accept ``[K, L]``."""
    global LAUNCHES_NOTHETA
    who = "notheta_chain"
    dev = cols.device
    if dev.type != "cuda":
        raise ValueError(f"{who}: the kernel takes CUDA tensors, got {dev}")
    K, lead = _chain_axis(who, cols, 2)
    L = cols.shape[-2]
    check_tensor(who, "cols", cols, torch.float64, lead + (L, 4 * H + 4),
                 dev)
    check_tensor(who, "sums", sums, torch.float64, lead + (2 * H,), dev)
    lib = _chain_lib()
    if lib.bpp_notheta_depth(H) <= 0:
        raise ValueError(f"{who}: {H} populations do not fit the kernel's "
                         "shared memory")
    out = torch.empty(lead + (L,), dtype=torch.bool, device=dev)
    _check_rc(lib.bpp_notheta_chain(cols.data_ptr(), sums.data_ptr(), K, L,
                                    H, float(a), float(b), out.data_ptr(),
                                    _stream(dev)), who)
    LAUNCHES_NOTHETA += 1
    return out


def launch_gammadir(terms, a_bar: float, b_bar: float, a_i: float):
    """K4 on ``terms`` ``[L, 6]`` float64 (per locus the old and new
    value, log proposal ratio, locus-factorizing density delta, uniform,
    mask), ``chain_depth()`` loci a round; returns accept ``[L]`` bool.
    Over K chains (``terms [K, L, 6]``) one launch of K blocks, accept
    ``[K, L]``."""
    global LAUNCHES_GAMMADIR
    who = "gammadir_chain"
    dev = terms.device
    if dev.type != "cuda":
        raise ValueError(f"{who}: the kernel takes CUDA tensors, got {dev}")
    K, lead = _chain_axis(who, terms, 2)
    L = terms.shape[-2]
    check_tensor(who, "terms", terms, torch.float64, lead + (L, 6), dev)
    out = torch.empty(lead + (L,), dtype=torch.bool, device=dev)
    _check_rc(_chain_lib().bpp_gammadir_chain(
        terms.data_ptr(), K, L, float(a_bar), float(b_bar), float(a_i),
        out.data_ptr(), _stream(dev)), who)
    LAUNCHES_GAMMADIR += 1
    return out


def launch_simwalk(t_lo, t_hi, pop_lo, live_e, pptable, tau, partau_f,
                   theta, parent, si, ti, d_lo, d_hi, route_M, heredity, t0,
                   p0, is_valid, unif, ME: int, big: float, tiny: float):
    """K5: the sim-SPR walk of every locus (see
    ``mcmc.mig_moves.simspr_walk_ref`` for the arguments); returns (t, p,
    done, fail, nt, ns, nd, nn).  Over C chains every argument but the
    route table ``si``, ``ti`` carries a leading chain axis of C (``t_lo
    [C, L, E]``, ``pptable [C, H, H]``, ``d_lo [C, K]``, ``unif [C, 3, S,
    L]``, ...; K counts the routes) and so does every output: one launch,
    a grid row a chain."""
    global LAUNCHES_SIMWALK
    who = "simspr_walk"
    dev = t_lo.device
    if dev.type != "cuda":
        raise ValueError(f"{who}: the kernel takes CUDA tensors, got {dev}")
    dt = t_lo.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"{who}: {dt}; the kernel takes float32 or float64")
    C, lead = _chain_axis(who, t_lo, 2)
    L, E = t_lo.shape[-2:]
    H = tau.shape[-1]
    K = si.shape[0]
    S = unif.shape[-2]
    i64, bl = torch.int64, torch.bool
    args = []
    for name, x, dtype, shape in (
            ("t_lo", t_lo, dt, lead + (L, E)),
            ("t_hi", t_hi, dt, lead + (L, E)),
            ("pop_lo", pop_lo, i64, lead + (L, E)),
            ("live_e", live_e, bl, lead + (L, E)),
            ("pptable", pptable, bl, lead + (H, H)),
            ("tau", tau, dt, lead + (H,)),
            ("partau_f", partau_f, dt, lead + (H,)),
            ("theta", theta, dt, lead + (H,)),
            ("parent", parent, i64, lead + (H,)), ("si", si, i64, (K,)),
            ("ti", ti, i64, (K,)), ("d_lo", d_lo, dt, lead + (K,)),
            ("d_hi", d_hi, dt, lead + (K,)),
            ("route_M", route_M, dt, lead + (L, K)),
            ("heredity", heredity, dt, lead + (L,)),
            ("t0", t0, dt, lead + (L,)), ("p0", p0, i64, lead + (L,)),
            ("is_valid", is_valid, bl, lead + (L,)),
            ("unif", unif, dt, lead + (3, S, L))):
        x = x.contiguous()
        check_tensor(who, name, x, dtype, shape, dev)
        args.append(x)
    t = torch.empty(lead + (L,), dtype=dt, device=dev)
    p = torch.empty(lead + (L,), dtype=i64, device=dev)
    done = torch.empty(lead + (L,), dtype=bl, device=dev)
    fail = torch.empty(lead + (L,), dtype=bl, device=dev)
    nt = torch.full(lead + (L, ME), BIG_AGE, dtype=dt, device=dev)
    ns = torch.zeros(lead + (L, ME), dtype=i64, device=dev)
    nd = torch.zeros(lead + (L, ME), dtype=i64, device=dev)
    nn = torch.empty(lead + (L,), dtype=i64, device=dev)
    outs = (t, p, done, fail, nt, ns, nd, nn)
    _check_rc(_walk_lib().bpp_simwalk(
        *(x.data_ptr() for x in args), *(x.data_ptr() for x in outs), C, L,
        E, H, K, ME, S, float(big), float(tiny), int(dt == torch.float64),
        _stream(dev)), who)
    LAUNCHES_SIMWALK += 1
    return outs


def launch_counts():
    """(K3, K4, K5) launches since import."""
    return LAUNCHES_NOTHETA, LAUNCHES_GAMMADIR, LAUNCHES_SIMWALK


def set_launch_counts(counts):
    global LAUNCHES_NOTHETA, LAUNCHES_GAMMADIR, LAUNCHES_SIMWALK
    LAUNCHES_NOTHETA, LAUNCHES_GAMMADIR, LAUNCHES_SIMWALK = counts
