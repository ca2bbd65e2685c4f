"""Proposal kernels and random-variate helpers on a torch.Generator.

Port of ``bpp_tpu/mcmc/rng.py``: an explicit ``torch.Generator``
(Philox on CUDA) replaces the JAX keys.  The proposal kernels mirror the
reference math: the Bactrian-Laplace symmetric kernel
(``random.c:191-208``, m=0.90) and boundary reflection
(``src/gtree.c:3982`` ``reflect``).  Every draw takes the run's generator
(``torch.rand``, ``randint``, ``exponential_``, ``_standard_gamma``), never
the default one: ``mcmc.graph.StepGraph`` registers it with its CUDA
graph, so each replay advances its Philox offset as an eager step does.

Under ``chains = K`` the batched step (``driver.Engine._step_batched``,
``torch.func.vmap`` of the one-chain step) hands every draw a
:class:`ChainGens`: the K chains' generators and the batched chain index.
A draw there is chain k's draw from generator k at that site, stacked on
the chain axis (one small launch a chain, :class:`_ChainDraw`), so each
chain draws exactly the numbers its own one-chain step draws.

Per-locus draws take ``shard`` (``parallel.mesh.Shard``, None when the
run is not sharded): the variate is drawn at the global shape, the
locus axis first, and this rank's rows are kept, so the generator
advances alike on every rank and each locus gets the value the
unsharded run gives it.
"""

from __future__ import annotations

import math

import torch

M_BACTRIAN = 0.90
S_BACTRIAN = (1.0 - M_BACTRIAN * M_BACTRIAN) ** 0.5


def tiny_floor(dtype) -> float:
    """``max(1e-300, finfo(dtype).tiny)``: bpp_tpu's 1e-300 floor where the
    dtype can hold it, else the smallest normal number (in float32 1e-300
    is 0, and a log of it -inf)."""
    return max(1e-300, torch.finfo(dtype).tiny)


class ChainGens:
    """The K chains' generators inside the batched step: ``gens[k]`` is
    chain k's, ``idx`` the chain index, a tensor batched over the chains
    by ``vmap`` (so that a draw, which takes it as its tensor input, is
    batched too)."""

    def __init__(self, gens, idx):
        self.gens = list(gens)
        self.idx = idx


# draws a batched step makes, counted per Python call (a replayed graph
# does not call): one per draw site, each K launches
CHAIN_DRAWS = 0


def _fill(kind, out, g, param):
    """One chain's draw of ``kind`` into ``out``, as the one-chain helpers
    below make it: ``torch.rand`` is ``empty().uniform_()``,
    ``torch.randint(0, n)`` is ``empty().random_(0, n)``."""
    if kind == "uniform":
        out.uniform_(generator=g)
    elif kind == "exponential":
        out.exponential_(generator=g)
    else:
        out.random_(0, param, generator=g)


class _ChainDraw(torch.autograd.Function):
    """A draw of the batched step.  ``vmap`` calls :meth:`vmap` with the
    chain index unbatched: chain k draws from ``gens[k]`` in chain order,
    each into its row of the ``[K, ...]`` result (one launch a chain).
    Outside ``vmap`` there is no chain axis to draw on."""

    @staticmethod
    def forward(idx, gens, kind, shape, dtype, device, param, alpha):
        raise RuntimeError("a ChainGens draw runs inside the batched step "
                           "(torch.func.vmap over the chains)")

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, idx, gens, kind, shape, dtype, device, param,
             alpha):
        global CHAIN_DRAWS
        if in_dims[0] != 0 or idx.shape[0] != len(gens):
            raise ValueError("the chain index must be batched over the "
                             f"{len(gens)} chains")
        CHAIN_DRAWS += 1
        if kind == "gamma":
            a = alpha.movedim(in_dims[7], 0) if in_dims[7] is not None \
                else alpha.expand((len(gens),) + alpha.shape)
            return torch.stack([torch._standard_gamma(a[k], generator=g)
                                for k, g in enumerate(gens)]), 0
        if kind == "randperm":
            return torch.stack([torch.randperm(param, generator=g,
                                               device=device)
                                for g in gens]), 0
        out = torch.empty((len(gens),) + tuple(shape), dtype=dtype,
                          device=device)
        for k, g in enumerate(gens):
            _fill(kind, out[k], g, param)
        return out, 0


def _chain_draw(gen, kind, shape, dtype=None, device=None, param=0,
                alpha=None):
    return _ChainDraw.apply(gen.idx, gen.gens, kind, tuple(shape), dtype,
                            device, param, alpha)


def _global(shape, shard):
    """The draw's shape: ``shape`` with the global locus count first."""
    shape = tuple(shape)
    return shape if shard is None else (shard.n_loci,) + shape[1:]


def _local(x, shard):
    return x if shard is None else x[shard.lo:shard.hi]


def uniform(gen, shape, dtype, device, shard=None):
    if isinstance(gen, ChainGens):
        return _local(_chain_draw(gen, "uniform", _global(shape, shard),
                                  dtype, device), shard)
    return _local(torch.rand(_global(shape, shard), generator=gen,
                             dtype=dtype, device=device), shard)


def uniform_loci_last(gen, lead, n_loci, dtype, device, shard=None):
    """Uniforms ``[*lead, n_loci]`` with the locus axis last (a block of
    draws a kernel reads, one column a locus): drawn at the global locus
    count under ``shard``, this rank's columns kept."""
    L = n_loci if shard is None else shard.n_loci
    x = uniform(gen, tuple(lead) + (L,), dtype, device)
    return x if shard is None else x[..., shard.lo:shard.hi]


def exponential(gen, shape, dtype, device, shard=None):
    """Exponential(1) variates."""
    if isinstance(gen, ChainGens):
        return _local(_chain_draw(gen, "exponential", _global(shape, shard),
                                  dtype, device), shard)
    return _local(torch.empty(_global(shape, shard), dtype=dtype,
                              device=device).exponential_(generator=gen),
                  shard)


def randint(gen, high: int, shape, device, shard=None):
    """Integers uniform on [0, high)."""
    if isinstance(gen, ChainGens):
        return _local(_chain_draw(gen, "randint", _global(shape, shard),
                                  torch.int64, device, high), shard)
    return _local(torch.randint(0, high, _global(shape, shard),
                                generator=gen, device=device), shard)


def randperm(gen, n: int, device):
    """A uniform random permutation of 0..n-1."""
    if isinstance(gen, ChainGens):
        return _chain_draw(gen, "randperm", (n,), torch.int64, device, n)
    return torch.randperm(n, generator=gen, device=device)


def bactrian(gen, shape=(), dtype=torch.float64, device="cpu", shard=None):
    """Bactrian-Laplace variate: mean 0, variance 1, bimodal at ±m."""
    u = uniform(gen, shape, dtype, device, shard) - 0.5
    r = torch.log1p(-2.0 * torch.abs(u)) * 0.70710678118654752440
    lap = torch.where(u >= 0, -r, r)
    z = M_BACTRIAN + lap * S_BACTRIAN
    sign = torch.where(uniform(gen, shape, dtype, device, shard) < 0.5,
                       -1.0, 1.0)
    return (sign * z).to(dtype)


def reflect(x, a, b):
    """Reflect x into the open interval (a, b), nudged off the boundary
    by one ulp of the working dtype (floored at the smallest normal)."""
    # a Python bound becomes a filled tensor on x's device (a host-to-
    # device copy would synchronise the stream)
    a, b = (v if torch.is_tensor(v) else torch.full_like(x, v)
            for v in (a, b))
    x, a, b = torch.broadcast_tensors(x, a, b)
    diff = b - a
    zero = torch.zeros_like(x)
    excess = torch.where(x < a, a - x, torch.where(x > b, x - b, zero))
    side = (x > b).to(torch.int64)
    n = torch.floor(excess / diff)
    side = torch.where(torch.remainder(n, 2.0) > 0.1, 1 - side, side)
    excess = excess - n * diff
    y = torch.where(side == 1, b - excess, a + excess)
    y = torch.where(excess > 0, y, x)
    lo = torch.nextafter(a, b)
    hi = torch.nextafter(b, a)
    # a subnormal step is floored at the smallest normal, as on XLA,
    # which flushes subnormals to zero
    tiny = torch.finfo(y.dtype).tiny
    lo = torch.where((lo <= a) | (lo.abs() < tiny), a + tiny, lo)
    return torch.minimum(torch.maximum(y, lo), torch.maximum(lo, hi))


def mh_accept(gen, lnacceptance, shard=None):
    """Metropolis-Hastings accept decision (accept when lnacceptance >=
    ~0 or log(u) < lnacceptance); ``shard`` when ``lnacceptance`` is per
    locus."""
    u = uniform(gen, lnacceptance.shape, lnacceptance.dtype,
                lnacceptance.device, shard)
    return (lnacceptance >= -1e-10) | (torch.log(u) < lnacceptance)


def gamma(gen, alpha):
    """Gamma(alpha, 1) variates of ``alpha``'s shape and dtype."""
    if isinstance(gen, ChainGens):
        return _chain_draw(gen, "gamma", (), alpha=alpha)
    return torch._standard_gamma(alpha, generator=gen)


def log_pdf_invgamma(x, a, b):
    """Inverse-gamma log density; ``a``, ``b`` are tensors like ``x``."""
    return a * torch.log(b) - torch.lgamma(a) - (a + 1.0) * torch.log(x) - b / x


def log_pdf_gamma(x, a, b):
    """Gamma(a, rate b) log density; ``a`` and ``b`` are floats or tensors
    like ``x``."""
    lb = torch.log(b) if torch.is_tensor(b) else math.log(b)
    lga = torch.lgamma(a) if torch.is_tensor(a) else math.lgamma(a)
    return a * lb - lga + (a - 1.0) * torch.log(x) - b * x
