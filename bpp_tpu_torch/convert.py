"""Carry sampler state across from flat numpy arrays.

:func:`state_from_numpy` builds the port's :class:`McmcState` from
``{"gt": {...}, "sp": {...}, "subst": {...}, "clock": {...}}``
dictionaries of numpy arrays keyed by the field names of ``bpp_tpu``'s
``GTrees``, ``SpeciesArrays``, ``SubstState`` and ``ClockState`` (as
``state.gt._asdict()`` with ``np.asarray`` on each value gives them), so
a test can hand a JAX chain's state to the port and compare densities on
the same trees.  ``"clock"`` is optional (the strict clock without
estimated locus rates carries none), and so are ``"mig"`` (MSC-M: the
fields of ``MigState``, events and rates) and the arrays ``"coal"`` and
``"t2h"`` (integrated-out thetas), ``"mubar"`` (tip dating) and
``"trait"`` (morphological traits: the fields of ``TraitState``).

Carried: every field of the four, the MSC-I network's too — the gene
trees' hybridization flags ``hpath`` (int8) and the species arrays'
``hslot``, ``hybrid``, ``phi``, ``hindex``, ``tau_free``,
``bdi_partner``, ``bdi_mirror``, ``bdi_pairs``, ``rate_nodes`` and
``rate_owner`` (index fields as int64, masks as bool) — and the
migration events' ``time``, ``node``, ``src``, ``dst`` and the rates
``M``, ``Mi`` and the geneflow mask ``on``, and the traits' branch
rates ``brate`` and cached ``logl``.  A field the port does not have
raises.

A stacked state of K chains (``chains = K``: every array with a leading
chain axis, as ``bpp_tpu``'s ``init_states`` stacks them; gene trees
``[K, L, N]``) gives the port's stacked state, which
``driver.Engine._step_batched`` steps.
"""

from __future__ import annotations

import numpy as np
import torch

from .mcmc.state import (
    N_FINETUNE, ClockState, McmcState, SubstState, finetune_array,
)
from .trees.gtree import GTrees, SpeciesArrays
from .trees.migration import MigState
from .trees.traits import TraitState

_INT_FIELDS = {"left", "right", "parent", "mrca", "hslot", "hybrid",
               "hindex", "bdi_partner", "bdi_pairs", "rate_owner", "node",
               "src", "dst"}


def _tensor(name, a, dtype, device):
    a = np.array(a)          # a writable copy (JAX arrays are read-only)
    if name == "hpath":
        return torch.as_tensor(a.astype(np.int8), device=device)
    if name in _INT_FIELDS:
        return torch.as_tensor(a.astype(np.int64), device=device)
    if a.dtype == bool:
        return torch.as_tensor(a, device=device)
    return torch.as_tensor(a, dtype=dtype, device=device)


def _build(cls, fields: dict, dtype, device):
    kw = {}
    for name in cls._fields:
        v = fields.get(name)
        if v is None:
            continue
        kw[name] = _tensor(name, v, dtype, device)
    extra = [k for k, v in fields.items()
             if k not in cls._fields and v is not None]
    if extra:
        raise NotImplementedError(
            f"{cls.__name__} fields {extra} are not carried by the port")
    return cls(**kw)


def state_from_numpy(arrays: dict[str, dict[str, np.ndarray]], device="cpu",
                     dtype=torch.float64, cfg=None) -> McmcState:
    """Port ``McmcState`` from numpy field dictionaries.

    The cached ``logl``/``logpr`` are zeros (recompute them with the
    port's ``logl_fn``/``logpr_fn``); the finetune steps are ``cfg``'s,
    or zeros without one.  Arrays with a leading chain axis (gene trees
    ``[K, L, N]``) give the K chains' stacked state: ``logl``/``logpr``
    ``[K, L]``, the finetune steps ``[K, N_FINETUNE]``."""
    gt = _build(GTrees, arrays["gt"], dtype, device)
    lead = tuple(gt.left.shape[:-1])        # (L,), or (K, L) stacked
    sp = _build(SpeciesArrays, arrays["sp"], dtype, device)
    subst = _build(SubstState, arrays["subst"], dtype, device)
    clock = mig = trait = None
    if arrays.get("clock") is not None:
        clock = _build(ClockState, arrays["clock"], dtype, device)
    if arrays.get("mig") is not None:
        mig = _build(MigState, arrays["mig"], dtype, device)
    if arrays.get("trait") is not None:
        trait = _build(TraitState, arrays["trait"], dtype, device)
    zeros = torch.zeros(lead, dtype=dtype, device=device)
    ft = (finetune_array(cfg, dtype, device) if cfg is not None
          else torch.zeros((N_FINETUNE,), dtype=dtype, device=device))
    if len(lead) == 2:
        ft = ft.expand(lead[:1] + ft.shape).clone()

    def opt(name, dt):
        a = arrays.get(name)
        return None if a is None else torch.as_tensor(
            np.array(a), dtype=dt, device=device)

    return McmcState(gt=gt, sp=sp, subst=subst, logl=zeros, logpr=zeros,
                     finetune=ft, clock=clock,
                     coal=opt("coal", torch.int64), t2h=opt("t2h", dtype),
                     mubar=opt("mubar", dtype), mig=mig, trait=trait)
