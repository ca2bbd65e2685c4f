"""Per-family exponential factors for the pruning kernel (PyTorch).

Port of ``_KFAC``, ``model_family`` and ``efactors`` from
``bpp_tpu/core/pallas_fels.py``.  The kernels apply P(t)·x by the spectral
structure of the model family, from these factors; they compute them in
their own prologue (``csrc/contract.cuh``), and :func:`efactors` is the
plain statement of that prologue, which the CPU tests hold against
``bpp_tpu``'s and walk a tree with.
"""

from __future__ import annotations

import torch

from ..config import SubstModel

# number of precomputed exponential factors per (node, category)
_KFAC = {"jc69": 1, "tn93": 3, "gtr": 4}


def model_family(model: SubstModel) -> str:
    """The kernels' family of a 4-state model.  Per-locus models
    (CUSTOM) read the per-locus eigensystem through the GTR family; a
    partition with an amino-acid locus has 20 states and no family (the
    wrappers refuse its tips)."""
    if model.is_aa:
        raise ValueError(f"{model.name} has 20 states; the kernels take 4")
    if model == SubstModel.JC69:
        return "jc69"
    if model in (SubstModel.GTR, SubstModel.CUSTOM):
        return "gtr"
    return "tn93"           # K80/F81/HKY/T92/F84/TN93 closed form


def efactors(model: SubstModel, t_eff, freqs, kappa1, kappa2, eigw):
    """Per-(locus, node, cat) exponential factors ``[L, N, C, K]`` and the
    per-locus contraction coefficients ``[L, 10]`` (TN93 family only).

    ``t_eff [L, N, C]`` are rate-scaled branch lengths.  Unlike
    ``bpp_tpu``'s, every factor is ``e - 1`` by ``expm1`` (GTR's already
    was): ``1 - e`` in float32 keeps few digits on short branches."""
    fam = model_family(model)
    if fam == "jc69":
        return torch.expm1(-4.0 / 3.0 * t_eff)[..., None], None
    if fam == "gtr":
        return torch.expm1(eigw[:, None, None, :] * t_eff[..., None]), None
    pa, pc, pg, pt = (freqs[:, a] for a in range(4))
    R = pa + pg
    Y = pc + pt
    m = 2.0 * (pa * pg * kappa1 + pc * pt * kappa2 + R * Y)
    ts = t_eff / m[:, None, None]
    e2 = torch.expm1(-ts)
    e3 = torch.expm1(-(R * kappa1 + Y)[:, None, None] * ts)
    e4 = torch.expm1(-(Y * kappa2 + R)[:, None, None] * ts)
    efac = torch.stack([e2, e3, e4], dim=-1)
    coefs = torch.stack([
        pa, pc, pg, pt,
        (1.0 - R) / R, (1.0 - Y) / Y,
        pg / R, pa / R, pt / Y, pc / Y,
    ], dim=-1)
    return efac, coefs
