"""Command-line interface of the PyTorch port.

Usage:
  python -m bpp_tpu_torch --cfile run.ctl [--seed N] [--device cpu]
  python -m bpp_tpu_torch --simulate sim.ctl [--seed N]

``--cfile`` runs on the GPU (``cuda``) unless ``--device cpu`` is given;
with no CUDA device it exits with an error.  It writes
``<jobname>.mcmc.txt``, the ``<jobname>.txt`` summary and
``<jobname>.FigTree.tre`` (port of ``bpp_tpu/cli.py`` ``cmd_run``; the
conditional a1b1 log, the species-tree PDF, checkpoints, chains and the
per-locus print files are later work).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="bpp-tpu-torch",
        description="Bayesian multispecies-coalescent inference "
        "(PyTorch/CUDA port)")
    ap.add_argument("--cfile", help="inference control file")
    ap.add_argument("--simulate", help="simulation control file")
    ap.add_argument("--seed", type=int, default=None, help="override seed")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; 'cpu' "
                    "runs the plain PyTorch path)")
    ap.add_argument("--x64", action="store_true",
                    help="run in float64 (CPU only in this version)")
    ap.add_argument("--quiet", action="store_true")
    return ap


def cmd_run(args) -> int:
    from .io.ctl import parse_ctl
    from .loader import load_run
    from .mcmc.driver import Engine, resolve_device
    from .output import McmcWriter, a00_summary, figtree_export
    from .summary.allfixed import hpd_interval

    device = resolve_device(args.device)
    cfg = parse_ctl(args.cfile)
    if args.x64:
        cfg = cfg.replace(dtype="float64")
    run = load_run(cfg)
    eng = Engine(run, seed=args.seed, device=device)
    if not args.quiet:
        b = run.batch
        print(f"bpp_tpu_torch: {len(run.loci)} loci | max seqs {b.max_tips} "
              f"| max patterns {b.max_patterns} | species {run.stree.n_tips}"
              f" | method {cfg.method.name} | seed {eng.seed} | device "
              f"{device}", file=sys.stderr)

    mcmc_path = cfg.mcmcfile or f"{cfg.jobname}.mcmc.txt"
    writer = McmcWriter(mcmc_path, cfg, run.stree)

    def on_sample(gen, row):
        mubar_h = row.get("mubar_h")
        writer.write_sample(
            gen, row["theta"], row["tau"], float(row["lnl"]),
            mubar_h=None if mubar_h is None else float(mubar_h))

    t0 = time.time()
    log = eng.run_mcmc(progress_every=0 if args.quiet else 1000,
                       on_sample=on_sample)
    writer.close()
    gen, theta, tau, lnl, _ = log.arrays()
    report = a00_summary(cfg, run.stree, gen, theta, tau, lnl)

    # FigTree.tre (allfixed.c:571): A00 fixed multi-species tree
    if run.stree.n_tips > 1 and len(gen):
        H = run.stree.n_nodes
        lo = np.zeros(H)
        hi = np.zeros(H)
        for i in range(run.stree.n_tips, H):
            lo[i], hi[i] = hpd_interval(tau[:, i])
        with open(f"{cfg.jobname}.FigTree.tre", "w") as fh:
            fh.write(figtree_export(run.stree, tau.mean(0), lo, hi,
                                    theta.mean(0)))
    out_path = f"{cfg.jobname}.txt"
    with open(out_path, "w") as fh:
        fh.write(f"bpp_tpu_torch {cfg.method.name} run summary ({len(gen)} "
                 f"samples, {time.time()-t0:.1f}s, device {device})\n\n")
        fh.write(report + "\n")
    if not args.quiet:
        print(report)
        print(f"\nwrote {mcmc_path}, {out_path}", file=sys.stderr)
    return 0


def cmd_simulate(args) -> int:
    from .sim.simulate import run_simulation

    return run_simulation(args.simulate, seed=args.seed)


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.cfile:
        import torch

        from .mcmc.driver import NO_CUDA
        if torch.device(args.device).type == "cuda" \
                and not torch.cuda.is_available():
            print(f"bpp_tpu_torch: {NO_CUDA}", file=sys.stderr)
            return 2
        return cmd_run(args)
    if args.simulate:
        return cmd_simulate(args)
    build_argparser().print_help()
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
