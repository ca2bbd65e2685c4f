"""Batched transition-probability matrices P(t) (PyTorch).

Port of ``bpp_tpu/core/pmatrix.py``: closed forms for JC69/K80/F81/HKY/
TN93 vectorized over arbitrary leading batch dims, the eigendecomposition
path for GTR and per-locus models (``P = T expm1(Λt) T⁻¹ + I``), and the
empirical amino-acid models over their constant eigensystems.  DNA state
order is A, C, G, T; matrices are rate-normalized so that
``-Σ π_i Q_ii = 1``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import SubstModel


def pmatrix_jc69(t):
    """JC69 P(t); t is any-shaped tensor -> [..., 4, 4].  Written with
    m = expm1(-4t/3), as the kernels' factors are: 1 - exp(-4t/3) keeps
    only about eps / t of an off-diagonal entry and is 0 below t ~ eps,
    where a change on the branch has probability about t / 3."""
    m = torch.expm1(-4.0 / 3.0 * t)[..., None, None]
    eye = torch.eye(4, dtype=m.dtype, device=m.device)
    return eye + m * (eye - 0.25)


def pmatrix_tn93(t, freqs, kappa1, kappa2):
    """TN93 P(t) closed form; HKY when kappa1 == kappa2, F81 at kappa=1.
    Written with the expm1 of each exponent (as the kernels' factors
    are), so that short branches keep their off-diagonal entries."""
    pa, pc, pg, pt = (freqs[..., i] for i in range(4))
    R = pa + pg
    Y = pc + pt
    m = 2.0 * (pa * pg * kappa1 + pc * pt * kappa2 + R * Y)
    ts = t / m
    e2 = torch.expm1(-ts)
    e3 = torch.expm1(-(R * kappa1 + Y) * ts)
    e4 = torch.expm1(-(Y * kappa2 + R) * ts)

    # with e = 1 + expm1: pi + pi (1 - pg) / pg e2 + pother / pg eg is 1 +
    # the expm1 terms (pi + pother = pg), and the within-group entry's
    # constants cancel
    def same(pi, pother, pgroup, egroup):
        return 1.0 + pi * (1.0 - pgroup) / pgroup * e2 \
            + pother / pgroup * egroup

    def within(pj, pgroup, egroup):
        return pj * (1.0 - pgroup) / pgroup * e2 - pj / pgroup * egroup

    cross = -e2

    paa = same(pa, pg, R, e3)
    pgg = same(pg, pa, R, e3)
    pcc = same(pc, pt, Y, e4)
    ptt = same(pt, pc, Y, e4)
    pag = within(pg, R, e3)
    pga = within(pa, R, e3)
    pct = within(pt, Y, e4)
    ptc = within(pc, Y, e4)

    row_a = torch.stack([paa, pc * cross, pag, pt * cross], dim=-1)
    row_c = torch.stack([pa * cross, pcc, pg * cross, pct], dim=-1)
    row_g = torch.stack([pga, pc * cross, pgg, pt * cross], dim=-1)
    row_t = torch.stack([pa * cross, ptc, pg * cross, ptt], dim=-1)
    return torch.stack([row_a, row_c, row_g, row_t], dim=-2)


def pmatrix_hky(t, freqs, kappa):
    return pmatrix_tn93(t, freqs, kappa, kappa)


def pmatrix_k80(t, kappa):
    q = torch.full(t.shape + (4,), 0.25, dtype=t.dtype, device=t.device)
    return pmatrix_tn93(t, q, kappa, kappa)


def pmatrix_f81(t, freqs):
    one = torch.ones_like(t)
    return pmatrix_tn93(t, freqs, one, one)


# the cyclic Jacobi method on a 4 x 4 symmetric matrix in rounds of two
# disjoint rotations that together cover the six off-diagonal pairs
JACOBI_ROUNDS = (((0, 1), (2, 3)), ((0, 2), (1, 3)), ((0, 3), (1, 2)))
# sweeps of the three rounds: Jacobi converges quadratically; four reached
# float64 roundoff on 20,000 random GTR systems (rates over 5 decades,
# frequencies down to 2e-4), one more is margin
JACOBI_SWEEPS = 5


@functools.lru_cache(maxsize=None)
def _jacobi_masks(dtype, device):
    """Per round, the 4 x 4 patterns of (c1, s1, c2, s2) in its rotation:
    c on (p, p) and (q, q), s on (p, q) and -s on (q, p)."""
    out = []
    for pairs in JACOBI_ROUNDS:
        masks = []
        for p, q in pairs:
            c = torch.zeros((4, 4), dtype=dtype)
            c[p, p] = c[q, q] = 1.0
            sn = torch.zeros((4, 4), dtype=dtype)
            sn[p, q], sn[q, p] = 1.0, -1.0
            masks += [c.to(device), sn.to(device)]
        out.append(tuple(masks))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _rate_slots(S, device):
    """``[S, S]``: the exchangeability of each pair of states as an index
    into (0, rates...): 1 + its upper-triangle position, 0 on the
    diagonal."""
    iu = torch.triu_indices(S, S, 1)
    slots = torch.zeros((S, S), dtype=torch.int64)
    slots[iu[0], iu[1]] = torch.arange(1, iu.shape[1] + 1)
    return (slots + slots.T).to(device)


def eigh_jacobi(B, sweeps=JACOBI_SWEEPS):
    """Eigenvalues ``[..., 4]`` (unordered) and orthonormal eigenvectors
    ``[..., 4, 4]`` (columns) of symmetric 4 x 4 matrices ``B``, by
    cyclic Jacobi rotations (Numerical Recipes' ``jacobi``, two disjoint
    pairs a round) in a fixed number of sweeps: every op runs on the
    device and nothing is read back, which ``torch.linalg.eigh`` does to
    check its solver's status (a CUDA graph cannot capture that read)."""
    A = B
    V = torch.eye(4, dtype=B.dtype, device=B.device).expand(B.shape).clone()
    masks = _jacobi_masks(B.dtype, B.device)
    for _ in range(sweeps):
        for pairs, (mc1, ms1, mc2, ms2) in zip(JACOBI_ROUNDS, masks):
            app = torch.stack([A[..., p, p] for p, _ in pairs], -1)
            aqq = torch.stack([A[..., q, q] for _, q in pairs], -1)
            apq = torch.stack([A[..., p, q] for p, q in pairs], -1)
            theta = (aqq - app) / (2.0 * apq)
            t = torch.where(theta >= 0, 1.0, -1.0) / (
                theta.abs() + torch.hypot(torch.ones_like(theta), theta))
            # a pair already zero (or theta out of range) is not rotated
            t = torch.where((apq == 0) | ~torch.isfinite(t),
                            torch.zeros_like(t), t)
            c = torch.rsqrt(t * t + 1.0)
            sn = t * c
            J = (c[..., 0, None, None] * mc1 + sn[..., 0, None, None] * ms1
                 + c[..., 1, None, None] * mc2
                 + sn[..., 1, None, None] * ms2)
            A = J.transpose(-1, -2) @ A @ J
            V = V @ J
    return torch.diagonal(A, dim1=-2, dim2=-1), V


def gtr_eigen(freqs, rates, jacobi=False):
    """Eigendecomposition of a reversible rate matrix.

    ``freqs [..., S]``, ``rates [..., S(S-1)/2]`` upper-triangle
    exchangeabilities (AC, AG, AT, CG, CT, GT for DNA).  Returns
    (eigvals ``[..., S]``, T, Tinv) with ``Q = T diag(w) Tinv`` and
    ``-Σ π_i Q_ii = 1``.  ``jacobi``: a 4-state system takes
    :func:`eigh_jacobi`, which reads nothing back to the host, so that a
    CUDA graph can capture it (``Ctx.captured``); otherwise
    ``torch.linalg.eigh``, one call where the sweeps are some six hundred
    small ops."""
    S = freqs.shape[-1]
    shape = torch.broadcast_shapes(freqs.shape[:-1], rates.shape[:-1])
    rates = rates.expand(shape + rates.shape[-1:])
    # gathered out of place (inside the batched step the rates carry the
    # chain axis): slot 0 is the diagonal's zero
    R = torch.cat([torch.zeros_like(rates[..., :1]), rates],
                  -1)[..., _rate_slots(S, freqs.device)]
    Q = R * freqs[..., None, :]
    diag = -Q.sum(-1)
    Q = Q + diag[..., None] * torch.eye(S, dtype=Q.dtype, device=Q.device)
    mu = (freqs * -diag).sum(-1)
    Q = Q / mu[..., None, None]
    # B = diag(sqrt(pi)) Q diag(1/sqrt(pi)) is symmetric
    sq = torch.sqrt(freqs)
    B = sq[..., :, None] * Q / sq[..., None, :]
    # a float32 proposal can leave the parameter space (a reference rate
    # or a frequency of 0 after a reflection onto its bound): its
    # eigensystem is NaN, as XLA's is, so the move rejects it, and the
    # solver, which refuses a non-finite matrix, sees the identity there
    bad = ~torch.isfinite(B).all(-1).all(-1)
    eye = torch.eye(S, dtype=B.dtype, device=B.device)
    B = torch.where(bad[..., None, None], eye, B)
    w, V = (eigh_jacobi(B) if jacobi and S == 4
            else torch.linalg.eigh(B))
    nan = torch.full_like(w[..., :1], float("nan"))
    w = torch.where(bad[..., None], nan, w)
    V = torch.where(bad[..., None, None], nan[..., None], V)
    T = V / sq[..., :, None]
    Tinv = V.transpose(-1, -2) * sq[..., None, :]
    return w, T, Tinv


def pmatrix_eigen(t, eigvals, T, Tinv):
    """P(t) = T expm1(Λt) Tinv + I: an elementwise broadcast-sum at 4
    states (full precision whatever the matmul settings), a matmul at 20
    (full float32 on the card: ``driver.resolve_device`` turns TF32 off)."""
    em1 = torch.expm1(eigvals[..., None, :] * t[..., None, None])
    S = T.shape[-1]
    if S >= 20:
        P = torch.matmul(T * em1, Tinv)
    else:
        P = torch.sum(T[..., :, None, :] * em1[..., 0, None, None, :]
                      * Tinv.transpose(-1, -2)[..., None, :, :], dim=-1)
    return P + torch.eye(S, dtype=P.dtype, device=P.device)


# --- empirical amino-acid models (locus.c:985-1110 model table) --------------

@functools.lru_cache(maxsize=None)
def aa_eigen(model_name: str):
    """Constant eigensystem of an empirical AA model (float64 numpy).

    Returns (w, T, Tinv, freqs) with Q = T diag(w) Tinv, mean rate 1.
    Symmetrized decomposition as in pll_update_eigen
    (core_pmatrix.c:239): B = D^1/2 Q D^-1/2 is symmetric for a
    reversible Q, so eigh is exact and stable."""
    from .aa_matrices import AA_MODELS, aa_qmatrix

    rates, freqs = AA_MODELS[model_name]
    Q = aa_qmatrix(rates, freqs)
    sq = np.sqrt(freqs)
    B = sq[:, None] * Q / sq[None, :]
    w, V = np.linalg.eigh((B + B.T) / 2.0)
    T = V / sq[:, None]
    Tinv = V.T * sq[None, :]
    return w, T, Tinv, freqs


@functools.lru_cache(maxsize=None)
def _aa_eigen_tensors(model_name: str, dtype, device):
    """The model's eigensystem on ``device``, copied there once: a copy a
    call would be recorded from host memory under CUDA-graph capture."""
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in aa_eigen(model_name)[:3])


def pmatrix_aa(t_eff, model_name: str):
    """P(t) for an empirical AA model: ``t_eff [...]`` -> ``[..., 20, 20]``.

    The 20-wide contraction is one matmul in ``t_eff``'s dtype: full
    float32 on the card, where ``driver.resolve_device`` turns TF32 off
    (the counterpart of ``bpp_tpu``'s ``Precision.HIGHEST``)."""
    dtype, dev = t_eff.dtype, t_eff.device
    wt, Tt, Tit = _aa_eigen_tensors(model_name, dtype, dev)
    em1 = torch.expm1(t_eff[..., None] * wt)               # [..., A]
    P = torch.matmul(Tt * em1[..., None, :], Tit)
    return P + torch.eye(20, dtype=dtype, device=dev)


TN93_FAMILY = (SubstModel.K80, SubstModel.F81, SubstModel.HKY,
               SubstModel.T92, SubstModel.TN93, SubstModel.F84)


def pmatrix_model(model: SubstModel, t_eff, freqs, kappa1, kappa2, eigw,
                  eigT, eigTi):
    """P(t) for every ``t_eff [L, N, C]`` entry: ``[L, N, C, A, A]``, with
    per-locus model parameters (``bpp_tpu``'s ``state.compute_pmats``).
    Per-locus models (CUSTOM) ride the per-locus eigensystem, 4 or 20
    states wide."""
    if model in (SubstModel.GTR, SubstModel.CUSTOM):
        return pmatrix_eigen(t_eff, eigw[:, None, None, :],
                             eigT[:, None, None, :, :],
                             eigTi[:, None, None, :, :])
    if model.is_aa:
        return pmatrix_aa(t_eff, model.name)
    if model == SubstModel.JC69:
        return pmatrix_jc69(t_eff)
    if model in TN93_FAMILY:
        return pmatrix_tn93(t_eff, freqs[:, None, None, :],
                            kappa1[:, None, None], kappa2[:, None, None])
    raise NotImplementedError(model)
