"""Locus sharding over torch.distributed processes.

Port of ``bpp_tpu/parallel/mesh.py``.  ``bpp_tpu`` shards the locus axis
of every ``[L, ...]`` array over a 1-D ``jax.sharding.Mesh`` and XLA
inserts the collectives into the jitted step.  Torch has no
single-process mesh idiom: the counterpart of ``make_mesh(n)`` is n
processes, one ``torch.distributed`` rank each (``parallel.multihost``
starts them), and a :class:`Shard` says which loci a rank owns.

Each rank owns one contiguous block of loci outright
(``bpp_tpu/parallel/multihost.py:97-105``: ``per = ceil(L / n)``, rank r
owns ``[r per, min((r + 1) per, L))``).  Its ``Ctx`` is rebuilt from its
rows (tips, weights, the pruning kernels' unit table), its state holds
its rows, and K1/K2 run on its block; species-tree state, step sizes and
the generator are replicated.  A rank stays in step with the others, and
the sharded chain equals the unsharded one, because

  * every sum over loci is :func:`psum`, an all-reduce SUM (:func:`pany`
    for "any locus");
  * every per-locus random draw is taken at the global shape from the
    replicated generator and sliced (``mcmc.rng``), so Philox offsets
    advance alike on every rank;
  * what couples loci in sequence (the serial accept chains, the pairs
    of the Dirichlet locus-rate move) runs on :func:`gather_loci`'s
    global copies, the same on every rank.

The per-locus fields are named, not guessed from the leading dimension
(``bpp_tpu``'s rule would shard the SIMPLE clock's ``[1, H]`` rates when
L = 1, and a ``[H]`` table when H == L).
"""

from __future__ import annotations

import dataclasses

import torch

LOCI_AXIS = "loci"

# per-locus fields (leading axis L) of the run's context and state; every
# other field is replicated
CTX_LOCUS_FIELDS = ("tip_partials", "weights", "n_seq", "tip_pop",
                    "locus_mask", "res_map", "res_count", "n_pat",
                    "tip_dates")
CUSTOM_LOCUS_FIELDS = ("kind", "freqs_free", "q_free", "q_ref",
                       "q_ref_alpha", "is_dna", "aa_w", "aa_T", "aa_Ti")
GTREE_LOCUS_FIELDS = ("left", "right", "parent", "age", "hpath")
SUBST_LOCUS_FIELDS = ("freqs", "kappa1", "kappa2", "qrates", "alpha",
                      "rates", "mu", "heredity", "eigw", "eigT", "eigTi")
STATE_LOCUS_FIELDS = ("logl", "logpr", "coal", "t2h")
# the SIMPLE clock's brate [1, H] and lnrates [1] are shared by the loci
CLOCK_LOCUS_FIELDS = ("brate", "nu", "lnrates")
CLOCK_SHARED_FIELDS = ("brate", "lnrates")
MIG_LOCUS_FIELDS = ("time", "node", "src", "dst", "Mi")


def block(n_loci: int, size: int, rank: int) -> tuple[int, int]:
    """Rank ``rank``'s loci ``[lo, hi)`` of ``n_loci`` split over ``size``
    ranks in contiguous blocks of ``ceil(n_loci / size)``."""
    per = -(-n_loci // size)
    return min(rank * per, n_loci), min((rank + 1) * per, n_loci)


def pad_loci_for_mesh(n_loci: int, size: int) -> int:
    """Smallest multiple of ``size`` >= ``n_loci`` (``bpp_tpu``'s helper,
    with the rank count for the mesh)."""
    return -(-n_loci // size) * size


@dataclasses.dataclass(frozen=True)
class Shard:
    """Rank ``rank`` of ``size`` owns loci ``[lo, hi)`` of ``n_loci``.
    ``host_reduce``: the collectives run on CPU copies (gloo), else on
    the tensors' device (NCCL)."""

    rank: int
    size: int
    n_loci: int
    group: object = None
    host_reduce: bool = True

    def __post_init__(self):
        lo, hi = block(self.n_loci, self.size, self.rank)
        if hi <= lo:
            fits = max(n for n in range(1, self.size + 1)
                       if n == 1 or block(self.n_loci, n, n - 1)[1]
                       > block(self.n_loci, n, n - 1)[0])
            raise ValueError(
                f"{self.size} processes for {self.n_loci} loci leave rank "
                f"{self.rank} without a locus (ranks own ceil(L / n) = "
                f"{-(-self.n_loci // self.size)} loci each); run at most "
                f"{fits} processes")

    @property
    def lo(self) -> int:
        return block(self.n_loci, self.size, self.rank)[0]

    @property
    def hi(self) -> int:
        return block(self.n_loci, self.size, self.rank)[1]

    @property
    def n_local(self) -> int:
        return self.hi - self.lo

    def rows(self, x):
        """This rank's rows of a global per-locus array."""
        return x[self.lo:self.hi]


def make_shard(n_loci: int, group=None) -> Shard:
    """The calling process's :class:`Shard` of ``n_loci`` under the
    initialised default process group (or ``group``)."""
    import torch.distributed as dist
    return Shard(rank=dist.get_rank(group), size=dist.get_world_size(group),
                 n_loci=int(n_loci), group=group,
                 host_reduce=dist.get_backend(group) != "nccl")


def _all_reduce(shard: Shard, buf):
    import torch.distributed as dist
    if shard.host_reduce and buf.device.type != "cpu":
        host = buf.cpu()
        dist.all_reduce(host, group=shard.group)
        return host.to(buf.device)
    dist.all_reduce(buf, group=shard.group)
    return buf


def psum(shard, *xs):
    """The cross-rank sum of each tensor (the identity when ``shard`` is
    None): one all-reduce for all of them.  Booleans come back as int64
    counts; several tensors travel as one float64 buffer (exact for
    counts below 2**53)."""
    if shard is None:
        return xs[0] if len(xs) == 1 else xs
    xs = [x.to(torch.int64) if x.dtype == torch.bool else x for x in xs]
    if len(xs) == 1:
        return _all_reduce(shard, xs[0].clone())
    flat = torch.cat([x.reshape(-1).to(torch.float64) for x in xs])
    flat = _all_reduce(shard, flat)
    out, k = [], 0
    for x in xs:
        out.append(flat[k:k + x.numel()].reshape(x.shape).to(x.dtype))
        k += x.numel()
    return tuple(out)


def psum_counts(shard, nprop, nacc):
    """A per-locus move's (proposed, accepted) counts over every rank."""
    return psum(shard, torch.as_tensor(nprop), torch.as_tensor(nacc))


def pany(shard, x):
    """Whether any rank's ``x`` (a boolean tensor, elementwise) is True."""
    if shard is None:
        return x
    return psum(shard, x.to(torch.int64)) > 0


def gather_loci(shard, x):
    """The global ``[n_loci, ...]`` tensor of every rank's rows of ``x``:
    an all-reduce SUM of a buffer that is zero outside this rank's block
    (gloo takes only all_reduce and broadcast on CUDA tensors).  The
    identity when ``shard`` is None."""
    if shard is None:
        return x
    dt = x.dtype
    work = torch.float64 if dt.is_floating_point else torch.int64
    buf = torch.zeros((shard.n_loci,) + tuple(x.shape[1:]), dtype=work,
                      device=x.device)
    buf[shard.lo:shard.hi] = x.to(work)
    return _all_reduce(shard, buf).to(dt)


def _rows(x, shard):
    return None if x is None else shard.rows(x).clone()


def _replace_rows(obj, fields, shard, skip=()):
    """``obj`` (a NamedTuple) with its named per-locus fields sliced."""
    return obj._replace(**{f: _rows(getattr(obj, f), shard)
                           for f in fields if f not in skip})


def shard_by_locus(obj, shard: Shard, shared_clock: bool = False):
    """This rank's part of the run's ``Ctx`` or of a ``McmcState``: the
    rows of every per-locus field (named in ``*_LOCUS_FIELDS``), the rest
    as it is.  A ``Ctx`` gets its kernels' unit table rebuilt from the
    local pattern counts and carries ``shard``.  ``shared_clock``: the
    state's clock is the SIMPLE clock, whose ``brate`` and ``lnrates``
    are shared by the loci."""
    from ..mcmc.state import Ctx, McmcState
    if isinstance(obj, Ctx):
        kw = {f: _rows(getattr(obj, f), shard) for f in CTX_LOCUS_FIELDS}
        if obj.custom is not None:
            kw["custom"] = dataclasses.replace(
                obj.custom, **{f: _rows(getattr(obj.custom, f), shard)
                               for f in CUSTOM_LOCUS_FIELDS})
        if obj.units is not None:
            from ..core.units import Units
            kw["units"] = Units(kw["n_pat"].cpu().numpy(), obj.units.n_cols,
                                obj.tip_partials.device)
        return dataclasses.replace(obj, shard=shard, **kw)
    if not isinstance(obj, McmcState):
        raise TypeError(f"shard_by_locus takes a Ctx or a McmcState, not "
                        f"{type(obj).__name__}")
    st = _replace_rows(obj, STATE_LOCUS_FIELDS, shard)
    st = st._replace(gt=_replace_rows(obj.gt, GTREE_LOCUS_FIELDS, shard),
                     subst=_replace_rows(obj.subst, SUBST_LOCUS_FIELDS,
                                         shard))
    if obj.clock is not None:
        st = st._replace(clock=_replace_rows(
            obj.clock, CLOCK_LOCUS_FIELDS, shard,
            skip=CLOCK_SHARED_FIELDS if shared_clock else ()))
    if obj.mig is not None:
        st = st._replace(mig=_replace_rows(obj.mig, MIG_LOCUS_FIELDS, shard))
    return st
