"""Checkpoint / resume (reference src/dump.c, src/load.c), PyTorch.

Port of ``bpp_tpu/checkpoint.py`` (``save_checkpoint``,
``load_checkpoint``, ``restore_state``, ``truncate_file``).  One ``.npz``
holds:

* ``__meta__``: JSON with the format version, the iteration ``it``, the
  seed, ``mcmc_offset`` (the byte length of the sample file when the
  checkpoint was taken) and ``extra``;
* ``__ctl__``: the control file's text;
* one array per leaf of the state, named by its path
  (``state.gt.left``, ``state.clock.brate``, ...; absent fields have no
  leaf): on an MSC-I network also the gene trees' int8 hybridization
  flags ``state.gt.hpath``, the species arrays' ``phi`` and their other
  network fields, under MSC-M the migration events and rates
  (``state.mig.time``, ``.node``, ``.src``, ``.dst``, ``.M``, ``.Mi``, and
  the geneflow mask ``.on``), with traits their branch rates and cached
  log-likelihoods (``state.trait.brate``, ``.logl``), each restored in
  its dtype and shape;
* ``rng_state``: the bytes of the run's ``torch.Generator``
  (``get_state()``; on CUDA, Philox's seed and offset), where ``bpp_tpu``
  stores its JAX PRNG key;
* ``stats_acc``: the move statistics since the last finetune reset.

CLVs are never stored: they are derived state.  The sequence files must
still be where the control file names them on resume.  A checkpoint of
the port does not load in ``bpp_tpu``, nor one of ``bpp_tpu`` here: the
random number generators differ.  The samples taken before a
checkpoint, phi among them, are read back from mcmc.txt on resume.

``save_checkpoint_multi`` (``chains = K``) stores the K chains' states
(``chain<k>.gt.left``, ..., k = 0..K-1), their generators' bytes
(``rng_state<k>``), the per-chain move statistics, ``multichain = K`` in
the meta and the samples taken so far (``log_gen``, ``log_theta``, ...),
because a chain batch writes its sample files at the end of the run;
``restore_states``, ``rng_states`` and ``restore_logs`` read them back.
"""

from __future__ import annotations

import json

import numpy as np
import torch

FORMAT_VERSION = 1


def _leaves(state, prefix="state"):
    """(name, tensor) of every tensor of a NamedTuple tree, by path."""
    for name, value in zip(state._fields, state):
        if value is None:
            continue
        path = f"{prefix}.{name}"
        if isinstance(value, tuple):
            yield from _leaves(value, path)
        else:
            yield path, value


def save_checkpoint(path, state, gen, it, stats_acc, *, cfg_text, seed,
                    mcmc_offset, extra=None):
    meta = {
        "version": FORMAT_VERSION,
        "it": int(it),
        "seed": int(seed),
        "mcmc_offset": int(mcmc_offset),
        "extra": extra or {},
    }
    arrays = {name: t.detach().cpu().numpy() for name, t in _leaves(state)}
    arrays["rng_state"] = gen.get_state().numpy()
    arrays["stats_acc"] = np.asarray(stats_acc)
    # np.savez appends ".npz" to a name without it: write where asked
    with open(path, "wb") as fh:
        np.savez_compressed(fh, __meta__=json.dumps(meta),
                            __ctl__=cfg_text, **arrays)


def save_checkpoint_multi(path, states, gens, it, stats_acc, logs, *,
                          cfg_text, seed, extra=None):
    """The checkpoint of K replicate chains (``bpp_tpu``'s
    ``save_checkpoint_multi`` with one generator a chain)."""
    meta = {
        "version": FORMAT_VERSION,
        "it": int(it),
        "seed": int(seed),
        "mcmc_offset": 0,
        "multichain": len(logs),
        "extra": extra or {},
    }
    arrays = {}
    for k, (state, gen) in enumerate(zip(states, gens)):
        arrays.update((name, t.detach().cpu().numpy())
                      for name, t in _leaves(state, f"chain{k}"))
        arrays[f"rng_state{k}"] = gen.get_state().numpy()
    arrays["stats_acc"] = np.asarray(stats_acc)
    if logs[0].gen:
        arrays["log_gen"] = np.asarray(logs[0].gen)
        arrays["log_theta"] = np.stack([np.stack(lg.theta) for lg in logs])
        arrays["log_tau"] = np.stack([np.stack(lg.tau) for lg in logs])
        arrays["log_lnl"] = np.asarray([lg.lnL for lg in logs])
        arrays["log_logpr"] = np.asarray([lg.logpr for lg in logs])
        for name in ("phi", "migM"):
            if getattr(logs[0], name):
                arrays[f"log_{name}"] = np.stack(
                    [np.stack(getattr(lg, name)) for lg in logs])
        if logs[0].mubar:
            arrays["log_mubar"] = np.asarray([lg.mubar for lg in logs])
    with open(path, "wb") as fh:
        np.savez_compressed(fh, __meta__=json.dumps(meta),
                            __ctl__=cfg_text, **arrays)


def restore_logs(arrays, n_chains, make_log):
    """The K sample logs :func:`save_checkpoint_multi` stored
    (``make_log`` makes an empty one)."""
    logs = [make_log() for _ in range(n_chains)]
    if "log_gen" not in arrays:
        return logs
    for c, lg in enumerate(logs):
        lg.gen = [int(g) for g in arrays["log_gen"]]
        lg.theta = list(arrays["log_theta"][c])
        lg.tau = list(arrays["log_tau"][c])
        lg.lnL = [float(x) for x in arrays["log_lnl"][c]]
        lg.logpr = [float(x) for x in arrays["log_logpr"][c]]
        for name in ("phi", "migM"):
            if f"log_{name}" in arrays:
                setattr(lg, name, list(arrays[f"log_{name}"][c]))
        if "log_mubar" in arrays:
            lg.mubar = [float(x) for x in arrays["log_mubar"][c]]
    return logs


def load_checkpoint(path):
    """(meta, control-file text, named arrays)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        if meta["version"] != FORMAT_VERSION:
            raise ValueError(
                f"unsupported checkpoint version {meta['version']}")
        arrays = {k: z[k] for k in z.files
                  if k not in ("__meta__", "__ctl__")}
        return meta, str(z["__ctl__"]), arrays


def restore_state(template_state, arrays, prefix="state"):
    """Rebuild the state from named arrays, on the template's device and in
    its dtypes; the template comes from ``Engine.init_state()`` under the
    same control file.  A missing leaf or a leaf of another shape raises."""

    def build(tmpl, prefix):
        out = []
        for name, value in zip(tmpl._fields, tmpl):
            path = f"{prefix}.{name}"
            if value is None:
                out.append(None)
            elif isinstance(value, tuple):
                out.append(build(value, path))
            else:
                if path not in arrays:
                    raise ValueError(f"checkpoint missing leaf {path}")
                arr = arrays[path]
                if tuple(arr.shape) != tuple(value.shape):
                    raise ValueError(
                        f"checkpoint leaf {path} shape {arr.shape} != "
                        f"expected {tuple(value.shape)} (different "
                        "data/config?)")
                out.append(torch.as_tensor(arr).to(device=value.device,
                                                   dtype=value.dtype))
        return type(tmpl)(*out)

    return build(template_state, prefix)


def restore_states(templates, arrays):
    """The K chains of :func:`save_checkpoint_multi`, from the templates
    of ``Engine.init_states(K)``."""
    return [restore_state(t, arrays, f"chain{k}")
            for k, t in enumerate(templates)]


def rng_state(arrays, name="rng_state") -> torch.Tensor:
    """The generator bytes to hand ``torch.Generator.set_state``."""
    return torch.as_tensor(arrays[name], dtype=torch.uint8)


def rng_states(arrays, n_chains):
    """The K chains' generator bytes."""
    return [rng_state(arrays, f"rng_state{k}") for k in range(n_chains)]


def truncate_file(path, offset):
    """Exactly-once logging: cut the sample file back to the offset the
    checkpoint was taken at (load.c:2319)."""
    try:
        with open(path, "r+b") as fh:
            fh.truncate(offset)
    except FileNotFoundError:
        pass
