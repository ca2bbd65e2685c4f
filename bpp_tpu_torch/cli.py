"""Command-line interface of the PyTorch port.

Usage:
  python -m bpp_tpu_torch --cfile run.ctl [--seed N] [--device cpu]
  python -m bpp_tpu_torch --resume out.chk.npz [--extend N] [--device cpu]
  python -m bpp_tpu_torch --simulate sim.ctl [--seed N]
  python -m bpp_tpu_torch --msci-create defs.txt
  python -m bpp_tpu_torch --summary run.ctl
  python -m bpp_tpu_torch --bfdriver run.ctl [--points K]

``--cfile`` runs on the GPU (``cuda``) unless ``--device cpu`` is given;
with no CUDA device it exits with an error.  It writes
``<jobname>.mcmc.txt``, the ``<jobname>.txt`` summary,
``<jobname>.FigTree.tre`` and, with ``checkpoint = initial [step]``,
``<jobname>.chk.npz`` (port of ``bpp_tpu/cli.py`` ``cmd_run``).  An A00
run also writes the species-tree PDF ``<jobname>.pdf`` and, with data
and estimated thetas (not resumed), the conditional
``<jobname>.conditional_a1b1.txt`` log, whose Rao-Blackwellized summary
is appended to ``<jobname>.txt``.  The print flags (``print = s r h g
b``, ``printlocus``) write ``<jobname>.gtree.L<i>`` and
``<jobname>.locus_<i>_params_sample.txt`` for the real loci.  A01 and
A11 runs write one species tree (newick) per sample, and the A01, A10
and A11 reports replace the A00 summary and FigTree.tre.  ``--resume``
continues a run from its checkpoint: the sample file is cut back to the
checkpoint's offset and appended to, so every sample is written once,
and the summary reads all of them back.  ``--extend N`` adds N samples
to the resumed run.  ``--check N`` (``check = N`` in the control file)
recomputes the cached likelihoods and densities every N iterations and
stops on drift.  On an MSC-I network mcmc.txt has a phi column a
hybridization, and the run writes no a1b1 log and no FigTree.tre (as
``bpp_tpu``); with bidirectional introgression it also relabels the
samples against label switching (``summary.lswitch``), writes them to
``<mcmcfile>.processed`` and summarises the processed samples.
``--msci-create`` turns a network definitions file into the extended
newick a control file reads (``tools.msci_create``).  Under MSC-M
migration mcmc.txt has a ``W:`` column a route (its rate M), and the
a1b1 log a row a route.  ``--chains K`` (``chains = K``) runs K replicate
chains: chain 1 writes ``<jobname>.mcmc.txt``, chain k
``<jobname>.c<k>.mcmc.txt``, and ``<jobname>.txt`` pools them with a
split-R-hat table (``_run_multichain``).  ``--x64`` runs in float64, on
the card through the kernels' float64 builds.  ``--summary`` re-reads
``<jobname>.mcmc.txt`` and rewrites the ``<jobname>.txt`` report without
sampling (:func:`cmd_summary`); ``--bfdriver`` writes the control files
of a power-posterior run for the marginal likelihood
(``tools.bfdriver``).  ``--multihost host:port,N,i`` (or ``auto``) runs
this process as rank i of N that split the loci into contiguous blocks
(``parallel.multihost``): each runs the kernels on its own block, every
cross-locus quantity is all-reduced, and rank 0 alone prints and writes
the files; checkpoints and the per-locus print files are off, and
``--resume`` is refused, as in ``bpp_tpu``.  Under ``chains = K`` each
process runs every chain on all the loci and rank 0 writes.  The header
names the run's step route (``driver.step_route``): ``graph``, a chunk of
replays of one captured CUDA graph, or ``eager`` (``--multihost``) with
the reason; under ``chains = K`` also the chains' route
(``driver.chain_route``): ``batched``, one step over a chain axis (K1 or
K2 launched once a pass, K3, K4 or K5 once a call, for every chain), or
``per-chain``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from .config import PriorDist


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="bpp-tpu-torch",
        description="Bayesian multispecies-coalescent inference "
        "(PyTorch/CUDA port)")
    ap.add_argument("--cfile", help="inference control file")
    ap.add_argument("--resume", metavar="CHK",
                    help="continue the run checkpointed in CHK "
                    "(<jobname>.chk.npz)")
    ap.add_argument("--extend", type=int, default=0, metavar="N",
                    help="with --resume: take N more samples")
    ap.add_argument("--simulate", help="simulation control file")
    ap.add_argument("--msci-create", dest="msci_create",
                    help="MSC-I network definitions file -> extended newick")
    ap.add_argument("--summary", metavar="CTL",
                    help="re-read the run's mcmc file and rewrite its "
                    "summary without sampling (bpp.c:871 opt_onlysummary)")
    ap.add_argument("--bfdriver", metavar="CTL",
                    help="write K power-posterior control files and "
                    "<CTL>.betaweights.csv for marginal-likelihood "
                    "estimation (bfdriver.c:1161)")
    ap.add_argument("--points", type=int, default=8,
                    help="Gauss-Legendre points for --bfdriver (even)")
    ap.add_argument("--multihost", default=None, metavar="SPEC",
                    help="run as one process of N that share the loci: "
                    "'host:port,N,i' (rank i of N, rendezvous at host:port) "
                    "or 'auto' to read torch's MASTER_ADDR / MASTER_PORT / "
                    "WORLD_SIZE / RANK (env://, as torchrun sets them).  "
                    "Each rank takes one card (cuda:LOCAL_RANK, or the rank "
                    "modulo the cards) and NCCL, or gloo with --device cpu "
                    "or when ranks share a card; rank 0 writes the files.")
    ap.add_argument("--seed", type=int, default=None, help="override seed")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; 'cpu' "
                    "runs the plain PyTorch path)")
    ap.add_argument("--x64", action="store_true",
                    help="run in float64 (on the GPU through the float64 "
                    "builds of the pruning kernels)")
    ap.add_argument("--check", type=int, default=None, metavar="N",
                    help="every N iterations recompute the cached logl/"
                    "logpr (and integrated-theta caches) from scratch and "
                    "stop on drift (the reference's CHECK_LOGL/"
                    "CHECK_LOGPR, method.c:4699; as 'check = N' in the "
                    "control file)")
    ap.add_argument("--chains", type=int, default=None, metavar="K",
                    help="run K replicate chains and report their split-"
                    "R-hat (as 'chains = K' in the control file)")
    ap.add_argument("--quiet", action="store_true")
    return ap


def _column(path: str, name: str) -> np.ndarray:
    """One named column of a sample file."""
    with open(path) as fh:
        j = fh.readline().rstrip("\n").split("\t").index(name)
        return np.asarray([float(ln.split("\t")[j]) for ln in fh
                           if ln.strip()])


class LocusFiles:
    """The per-locus print files of ``print = s r h g b`` (method.c:2933
    ``%s.gtree.L%d``, method.c:59 ``%s.locus_%d_params_sample.txt``) for
    the real loci, or those ``printlocus`` names (1-based; cfile.c:2169):
    one gene tree, and one row of the heredity scalar, locus rate, nu_i
    and branch rates, a sample.  Port of ``bpp_tpu/cli.py``'s
    ``log_locus_files``; the engine's ``record_samples`` brings the
    values with each sample's trace row."""

    def __init__(self, cfg, run):
        b = run.batch
        loci = [i for i in range(b.n_loci) if b.locus_mask[i]]
        if cfg.print_locus:
            loci = [i for i in loci if i + 1 in cfg.print_locus]
        self.cfg, self.run = cfg, run
        want_params = ((cfg.print_locusrate and cfg.est_locusrate)
                       or (cfg.print_hscalars and cfg.est_heredity)
                       or cfg.print_rates)
        self.gtree_fps = {i: open(f"{cfg.jobname}.gtree.L{i + 1}", "w")
                          for i in loci} if cfg.print_genetrees else {}
        self.param_fps = {i: open(
            f"{cfg.jobname}.locus_{i + 1}_params_sample.txt", "w")
            for i in loci} if want_params else {}
        self.loci = loci if (self.gtree_fps or self.param_fps) else []

    def write(self, row):
        from .output import gene_tree_newick
        cfg, b = self.cfg, self.run.batch
        for k, i in enumerate(self.loci):
            if self.gtree_fps:
                self.gtree_fps[i].write(gene_tree_newick(
                    row["gt_left"][k], row["gt_right"][k],
                    row["gt_parent"][k], row["gt_age"][k], b.labels[i],
                    int(b.n_seq[i])) + "\n")
            if self.param_fps:
                vals = []
                if cfg.print_hscalars and cfg.est_heredity:
                    vals.append(f"{row['heredity'][k]:.6f}")
                if cfg.print_locusrate and cfg.est_locusrate:
                    vals.append(f"{row['mu'][k]:.6f}")
                if cfg.print_rates and "nu" in row:
                    vals.append(f"{row['nu'][k]:.6f}")
                    vals += [f"{x:.6f}" for x in row["brate"][k]]
                self.param_fps[i].write("\t".join(vals) + "\n")

    def close(self):
        for fp in (*self.gtree_fps.values(), *self.param_fps.values()):
            fp.close()


def method_report(cfg, st, gen, theta, tau, lnl, sptrees, phi=None,
                  migM=None, mubar=None) -> str:
    """The report of the run's method: A11, A01 or A10 from the species
    trees and taus, else the A00 posterior summary."""
    if cfg.est_stree and cfg.est_delimit:
        from .summary.mixed_summary import format_a11_summary, summarize_mixed
        trees, nsp = summarize_mixed(sptrees, tau, st.names)
        return format_a11_summary(trees, nsp, len(gen))
    if cfg.est_stree:
        from .summary.stree_summary import (
            format_a01_summary, summarize_sptrees,
        )
        topo, clades, n = summarize_sptrees(sptrees, st.names)
        return format_a01_summary(topo, clades, n, st.names)
    if cfg.est_delimit:
        from .summary.delimit_summary import (
            format_a10_summary, summarize_delimitations,
        )
        models, nsp = summarize_delimitations(tau, st)
        return format_a10_summary(models, nsp, len(gen), st)
    from .output import a00_summary
    return a00_summary(cfg, st, gen, theta, tau, lnl, phi=phi, migM=migM,
                       mubar=mubar)


def cmd_run(args) -> int:
    """``--cfile`` / ``--resume``; under ``--multihost`` inside this
    process's rank of the process group, which it leaves at the end."""
    if not args.multihost:
        return _cmd_run(args)
    from .parallel.multihost import MultihostSpec, init_multihost, shutdown
    spec = MultihostSpec.parse(args.multihost)
    device = init_multihost(spec, args.device, quiet=args.quiet)
    try:
        return _cmd_run(args, device)
    finally:
        shutdown()


def _broadcast_seed(device) -> int:
    """Rank 0's clock seed on every rank (the ctl leaves the seed to the
    clock, and the ranks' generators must be alike)."""
    import torch
    import torch.distributed as dist
    seed = int(np.random.SeedSequence().entropy % (2**31))
    buf = torch.tensor([seed], dtype=torch.int64,
                       device=device if dist.get_backend() == "nccl"
                       else "cpu")
    dist.broadcast(buf, src=0)
    return int(buf.item())


def _cmd_run(args, device=None) -> int:
    from . import checkpoint as ckpt
    from .io.ctl import parse_ctl_text
    from .loader import load_run
    from .mcmc.driver import Engine, resolve_device
    from .output import (
        A01McmcWriter, McmcWriter, figtree_export, read_mcmc_samples,
    )
    from .summary.allfixed import hpd_interval
    from .summary.lswitch import bdi_pairs_of

    multihost = device is not None
    is_main = True
    if multihost:
        import torch.distributed as dist
        is_main = dist.get_rank() == 0
        if args.resume:
            print("--multihost cannot resume yet", file=sys.stderr)
            return 1
    else:
        device = resolve_device(args.device)
    meta = arrays = None
    if args.resume:
        meta, cfg_text, arrays = ckpt.load_checkpoint(args.resume)
        extra = meta["extra"]
        ctl_dir = extra["ctl_dir"]
        cfg = parse_ctl_text(cfg_text, ctl_dir)
        seed = meta["seed"]
        # method.c:3194-3200: --extend lengthens a (finished) run
        cfg = cfg.replace(nsample=extra["nsample"] + args.extend)
    else:
        with open(args.cfile) as fh:
            cfg_text = fh.read()
        ctl_dir = os.path.dirname(os.path.abspath(args.cfile))
        cfg = parse_ctl_text(cfg_text, ctl_dir)
        seed = args.seed
    if args.x64:
        cfg = cfg.replace(dtype="float64")
    if args.check is not None:
        cfg = cfg.replace(check_every=args.check)
    if args.chains is not None:
        cfg = cfg.replace(n_chains=args.chains)
    shard = None
    if multihost:
        # the ranks hold the loci apart: no rank can write a checkpoint
        # or a per-locus file (bpp_tpu/cli.py:132-145)
        if cfg.checkpoint and is_main:
            print("multihost: checkpointing disabled (sharded state is "
                  "not host-addressable)", file=sys.stderr)
        cfg = cfg.replace(checkpoint=None, print_genetrees=False,
                          print_locusrate=False, print_hscalars=False,
                          print_rates=False)
        if seed is None and cfg.seed <= 0:
            seed = _broadcast_seed(device)
    run = load_run(cfg)
    if multihost and cfg.n_chains == 1:
        from .parallel.mesh import make_shard
        try:
            shard = make_shard(run.batch.n_loci)
        except ValueError as exc:
            if is_main:
                print(f"--multihost: {exc}", file=sys.stderr)
            return 1
    eng = Engine(run, seed=seed, device=device, shard=shard)
    if not args.quiet and is_main:
        b = run.batch
        print(f"bpp_tpu_torch: {len(run.loci)} loci | max seqs {b.max_tips} "
              f"| max patterns {b.max_patterns} | species {run.stree.n_tips}"
              f" | method {cfg.method.name} | seed {eng.seed} | device "
              f"{device}" + (f" | RESUMED at it {meta['it']}"
                             if args.resume else ""), file=sys.stderr)
        chains = (f"; chains = {cfg.n_chains}: {eng.chains_route} "
                  f"({eng.chains_route_reason})" if cfg.n_chains > 1 else "")
        print(f"step route: {eng.route} ({eng.route_reason}){chains}",
              file=sys.stderr)

    mcmc_path = cfg.mcmcfile or f"{cfg.jobname}.mcmc.txt"
    if cfg.n_chains > 1:
        return _run_multichain(args, cfg, run, eng, mcmc_path, cfg_text,
                               ctl_dir, meta, arrays, is_main)
    resume = None
    if args.resume:
        # exactly-once logging: cut back to the checkpointed offset
        ckpt.truncate_file(mcmc_path, meta["mcmc_offset"])
        state = ckpt.restore_state(eng.init_state(), arrays)
        resume = (state, ckpt.rng_state(arrays), meta["it"],
                  arrays["stats_acc"])
    a1b1 = None
    locus_files = None
    if not is_main:
        # another rank: it runs every collective of the chain, and its
        # trace rows (whose sums over loci are all-reduced) go nowhere
        writer = None

        def on_sample(gen, row):
            pass
    elif cfg.est_stree:
        writer = A01McmcWriter(mcmc_path, cfg, run.stree,
                               append=bool(args.resume))

        def on_sample(gen, row):
            writer.write_sample(gen, row["sp_left"], row["sp_right"],
                                row["sp_parent"], row["tau"])
    else:
        writer = McmcWriter(mcmc_path, cfg, run.stree,
                            append=bool(args.resume))
        # conditional (a1, b1) log and Rao-Blackwellized summary
        # (method.c:3838 opt_print_a1b1: A00, data, estimated thetas; not
        # under a mesh, bpp_tpu/cli.py:177)
        if (cfg.usedata and not cfg.theta_integrated
                and not cfg.est_delimit and not args.resume
                and run.stree.n_hybrids == 0 and shard is None):
            from .summary.a1b1 import DIST_GAMMA, DIST_INVGAMMA, A1b1Writer
            tdist = (DIST_GAMMA if cfg.thetaprior.dist == PriorDist.GAMMA
                     else DIST_INVGAMMA)
            labels = [(c, tdist) for c in writer.columns
                      if c.startswith("theta")]
            labels += [(c, DIST_GAMMA) for c in writer.columns
                       if c.startswith("W:")]
            if labels:
                a1b1 = A1b1Writer(f"{cfg.jobname}.conditional_a1b1.txt",
                                  labels)
        if not args.resume:
            locus_files = LocusFiles(cfg, run)
        eng.record_samples(
            a1b1=a1b1 is not None,
            loci=locus_files.loci if locus_files else (),
            gtrees=bool(locus_files and locus_files.gtree_fps),
            params=bool(locus_files and locus_files.param_fps))

        def on_sample(gen, row):
            def opt(key):
                v = row.get(key)
                return None if v is None else float(v)

            writer.write_sample(
                gen, row["theta"], row["tau"], float(row["lnl"]),
                phi=row.get("phi"), migM=row.get("migM"), mubar=opt("mubar"),
                mubar_h=opt("mubar_h"), nu_col=opt("nu_col"),
                brate0=row.get("brate0"))
            if locus_files is not None:
                locus_files.write(row)
            if a1b1 is not None:
                av = [row["a1"][i] for i in writer.theta_nodes]
                bv = [row["b1"][i] for i in writer.theta_nodes]
                if "wa1" in row:
                    av += list(row["wa1"])
                    bv += list(row["wb1"])
                a1b1.write_sample(gen, av, bv)

    chk_path = f"{cfg.jobname}.chk.npz"

    def on_checkpoint(state, gen, it, stats_acc):
        writer.fp.flush()
        ckpt.save_checkpoint(
            chk_path, state, gen, it, stats_acc, cfg_text=cfg_text,
            seed=eng.seed, mcmc_offset=writer.fp.tell(),
            extra={"ctl_dir": ctl_dir, "nsample": cfg.nsample})
        if not args.quiet:
            print(f"  checkpoint -> {chk_path} (it {it})", file=sys.stderr)

    t0 = time.time()
    log = eng.run_mcmc(progress_every=0 if args.quiet or not is_main
                       else 1000,
                       on_sample=on_sample, resume=resume,
                       on_checkpoint=on_checkpoint if cfg.checkpoint
                       else None)
    if writer is None:
        return 0      # a rank other than 0 writes no file
    writer.close()
    if locus_files is not None:
        locus_files.close()
    if args.resume:
        # the summary covers the samples from before the checkpoint too
        gen, theta, tau, lnl, sptrees, phi = read_mcmc_samples(
            cfg, run.stree, mcmc_path)
        mubar = (_column(mcmc_path, "mu_bar")
                 if not cfg.est_stree and writer.dated else None)
        # the migration rates of a resumed run are not read back (as
        # bpp_tpu): its summary has no W: rows
        migM = None
    else:
        gen, theta, tau, lnl, _ = log.arrays()
        sptrees = log.sptrees
        mubar = log.mubar
        phi = np.stack(log.phi) if log.phi else None
        migM = np.stack(log.migM) if log.migM else None
    a00 = not (cfg.est_stree or cfg.est_delimit)
    if a00 and phi is not None and bdi_pairs_of(run.stree) and len(gen):
        _relabel_bdi(cfg, run, mcmc_path, gen, theta, tau, lnl, phi,
                     args.quiet)
    report = method_report(cfg, run.stree, gen, theta, tau, lnl, sptrees,
                           phi=phi, migM=migM, mubar=mubar)

    # FigTree.tre (allfixed.c:571): A00 fixed multi-species tree only
    if (a00 and run.stree.n_tips > 1 and run.stree.n_hybrids == 0
            and len(gen)):
        H = run.stree.n_nodes
        lo = np.zeros(H)
        hi = np.zeros(H)
        for i in range(run.stree.n_tips, H):
            lo[i], hi[i] = hpd_interval(tau[:, i])
        with open(f"{cfg.jobname}.FigTree.tre", "w") as fh:
            fh.write(figtree_export(run.stree, tau.mean(0), lo, hi,
                                    theta.mean(0)))
    # species-tree PDF (visual.c stree_export_pdf, method.c:6528): A00
    if a00 and run.stree.n_tips > 1 and len(gen):
        from .visual import stree_export_pdf
        stree_export_pdf(
            run.stree, f"{cfg.jobname}.pdf",
            tau=tau.mean(0) if tau.size else None,
            theta=theta.mean(0) if theta.size else None,
            cmdline="bpp_tpu_torch --cfile " + (args.cfile or ""))
    out_path = f"{cfg.jobname}.txt"
    with open(out_path, "w") as fh:
        fh.write(f"bpp_tpu_torch {cfg.method.name} run summary ({len(gen)} "
                 f"samples, {time.time()-t0:.1f}s, device {device})\n\n")
        fh.write(report + "\n")
        if a1b1 is not None:
            a1b1.close()
            fh.write("\nSummarizing parameter estimates using file "
                     f"{cfg.jobname}.conditional_a1b1.txt ...\n\n")
            fh.write(a1b1.summary() + "\n")
    if not args.quiet:
        print(report)
        print(f"\nwrote {mcmc_path}, {out_path}", file=sys.stderr)
    return 0


def _relabel_bdi(cfg, run, mcmc_path, gen, theta, tau, lnl, phi, quiet):
    """The label-switching correction of bidirectional introgression
    (lswitch.c:336, called from allfixed.c:1853): relabel ``theta`` and
    ``phi`` in place for every BDI pair and write the processed samples
    to ``<mcmc_path>.processed`` (``bpp_tpu/cli.py:347-365``)."""
    from .output import McmcWriter
    from .summary.lswitch import lswitch_samples
    lines = []
    lswitch_samples(run.stree, theta, phi, est_theta=not cfg.theta_integrated,
                    log=lines.append)
    proc = McmcWriter(mcmc_path + ".processed", cfg, run.stree)
    for k, g in enumerate(gen):
        proc.write_sample(int(g), theta[k], tau[k], float(lnl[k]),
                          phi=phi[k])
    proc.close()
    if not quiet:
        print("\n".join(lines), file=sys.stderr)
        print(f"Printing processed sample into {mcmc_path}.processed",
              file=sys.stderr)


def write_chain_files(cfg, stree, logs, mcmc_path):
    """The K chains' samples ``logs`` (``SampleLog``) as ``chains = K``
    writes them: chain 1's into ``mcmc_path``, chain k's into
    ``<jobname>.c<k>.mcmc.txt``; returns the K closed writers (their
    columns and the nodes of the theta and tau columns)."""
    from .output import McmcWriter
    writers = []
    for c, log in enumerate(logs):
        path = mcmc_path if c == 0 else f"{cfg.jobname}.c{c + 1}.mcmc.txt"
        w = McmcWriter(path, cfg, stree)
        for i, g in enumerate(log.gen):
            w.write_sample(g, log.theta[i], log.tau[i], log.lnL[i],
                           phi=log.phi[i] if log.phi else None,
                           migM=log.migM[i] if log.migM else None,
                           mubar=log.mubar[i] if log.mubar else None)
        w.close()
        writers.append(w)
    return writers


def _run_multichain(args, cfg, run, eng, mcmc_path, cfg_text, ctl_dir,
                    meta=None, arrays=None, is_main=True) -> int:
    """``chains = K``: K replicate chains (port of ``bpp_tpu/cli.py``'s
    ``_run_multichain``; the reference runs one chain, method.c:5343).
    Chain 1 writes the normal mcmc file, chains 2..K
    ``<jobname>.c<k>.mcmc.txt``; the summary pools all chains and reports
    a between-chain split-R-hat table, and under A10 the pooled
    delimitation posterior and each chain's P(#species).  A00 and A10,
    with checkpoint/resume of the whole batch (the sample files are
    written at the end, from the samples the checkpoint carries)."""
    from . import checkpoint as ckpt
    from .config import Clock
    from .mcmc.driver import SampleLog
    from .summary.allfixed import format_summary, split_rhat, summary_table

    K = cfg.n_chains
    if cfg.est_stree:
        print("chains > 1 supports A00/A10 (fixed guide tree); species-"
              "tree search logs newick traces the chain batch does not "
              "carry yet", file=sys.stderr)
        return 1
    if cfg.check_every:
        print("chains > 1 cannot be combined with check = N "
              "(run chains = 1 for the validation mode)", file=sys.stderr)
        return 1
    if cfg.clock != Clock.GLOBAL:
        # the sample logs do not carry the nu / branch-rate columns
        print("chains > 1 does not support relaxed clocks yet "
              "(clock = 1 only)", file=sys.stderr)
        return 1
    resume = None
    if args.resume:
        if meta.get("multichain") != K:
            print(f"checkpoint holds {meta.get('multichain')} chains, "
                  f"ctl wants {K}", file=sys.stderr)
            return 1
        resume = (ckpt.restore_states(eng.init_states(K), arrays),
                  ckpt.rng_states(arrays, K), meta["it"],
                  arrays["stats_acc"], ckpt.restore_logs(arrays, K, SampleLog))
    chk_path = f"{cfg.jobname}.chk.npz"

    def on_checkpoint(states, gens, it, stats_acc, logs):
        ckpt.save_checkpoint_multi(
            chk_path, states, gens, it, stats_acc, logs, cfg_text=cfg_text,
            seed=eng.seed, extra={"ctl_dir": ctl_dir, "nsample": cfg.nsample})
        if not args.quiet:
            print(f"  checkpoint -> {chk_path} (it {it}, {K} chains)",
                  file=sys.stderr)

    t0 = time.time()
    logs = eng.run_mcmc_multi(
        K, progress_every=0 if args.quiet or not is_main else 1000,
        resume=resume, on_checkpoint=on_checkpoint if cfg.checkpoint
        else None)
    wall = time.time() - t0
    if not is_main:
        # --multihost: the replicas run the same chains; rank 0 writes
        return 0
    series_per_chain = []
    for log, w in zip(logs, write_chain_files(cfg, run.stree, logs,
                                              mcmc_path)):
        cols = {"lnL": np.asarray(log.lnL)}
        th = np.stack(log.theta)
        tu = np.stack(log.tau)
        tcols = [c0 for c0 in w.columns if c0.startswith("theta:")]
        for name, node in zip(tcols, w.theta_nodes):
            cols[name] = th[:, node]
        ucols = [c0 for c0 in w.columns if c0.startswith("tau:")]
        for name, node in zip(ucols, w.tau_nodes):
            cols[name] = tu[:, node]
        series_per_chain.append(cols)
    pooled = {k: np.concatenate([sc[k] for sc in series_per_chain])
              for k in series_per_chain[0]}
    rhat = {k: split_rhat(np.stack([sc[k] for sc in series_per_chain]))
            for k in series_per_chain[0]}
    total_iters = (cfg.burnin + cfg.nsample * cfg.sampfreq) * K
    lines = [format_summary(summary_table(pooled)), "",
             f"Between-chain split-R-hat over {K} chains "
             "(values near 1 = converged):"]
    lines += [f"  {k:<12s} {v:8.4f}" for k, v in rhat.items()]
    if cfg.est_delimit:
        from .summary.delimit_summary import (
            format_a10_summary, n_species, summarize_delimitations,
        )
        tau_pool = np.concatenate([np.stack(lg.tau) for lg in logs])
        models, nsp = summarize_delimitations(tau_pool, run.stree)
        lines += ["", format_a10_summary(models, nsp, len(tau_pool),
                                         run.stree)]
        lines += ["Per-chain P(#species):"]
        for c, lg in enumerate(logs):
            ns = np.asarray([n_species(t, run.stree) for t in lg.tau])
            probs = " ".join(f"{k}:{float((ns == k).mean()):.3f}"
                             for k in range(1, run.stree.n_tips + 1))
            lines.append(f"  chain {c + 1}: {probs}")
    lines += ["", f"{K} chains x {cfg.nsample} samples in {wall:.1f} s "
              f"({total_iters / wall:.1f} aggregate iters/s)"]
    out_txt = "\n".join(lines)
    with open(f"{cfg.jobname}.txt", "w") as fh:
        fh.write(out_txt + "\n")
    if not args.quiet:
        print(out_txt, file=sys.stderr)
        print(f"wrote {mcmc_path} (+{K - 1} chain files), {cfg.jobname}.txt",
              file=sys.stderr)
    return 0


def cmd_summary(args) -> int:
    """``--summary``: summarise an existing mcmc file without sampling
    (bpp.c:871-874 opt_onlysummary; port of ``bpp_tpu/cli.py``'s
    ``cmd_summary``): the A00, A01, A10 or A11 report into
    ``<jobname>.txt``."""
    from .io.ctl import parse_ctl
    from .loader import build_species_tree
    from .output import read_mcmc_samples

    cfg = parse_ctl(args.summary)
    st = build_species_tree(cfg)
    mcmc_path = cfg.mcmcfile or f"{cfg.jobname}.mcmc.txt"
    if not os.path.exists(mcmc_path):
        print(f"no mcmc file {mcmc_path!r} to summarize", file=sys.stderr)
        return 1
    gen, theta, tau, lnl, sptrees, phi = read_mcmc_samples(cfg, st,
                                                           mcmc_path)
    report = method_report(cfg, st, gen, theta, tau, lnl, sptrees, phi=phi)
    out_path = f"{cfg.jobname}.txt"
    with open(out_path, "w") as fh:
        fh.write(f"bpp_tpu_torch {cfg.method.name} summary-only re-run "
                 f"({len(gen)} samples)\n\n")
        fh.write(report + "\n")
    if not args.quiet:
        print(report)
        print(f"\nwrote {out_path}", file=sys.stderr)
    return 0


def cmd_simulate(args) -> int:
    from .sim.simulate import run_simulation

    return run_simulation(args.simulate, seed=args.seed)


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.extend and not args.resume:
        print("--extend can only be used with --resume", file=sys.stderr)
        return 1
    if args.extend < 0:
        print("--extend must not be negative", file=sys.stderr)
        return 1
    if args.summary:
        return cmd_summary(args)
    if args.cfile or args.resume:
        import torch

        from .mcmc.driver import NO_CUDA
        if torch.device(args.device).type == "cuda" \
                and not torch.cuda.is_available():
            print(f"bpp_tpu_torch: {NO_CUDA}", file=sys.stderr)
            return 2
        return cmd_run(args)
    if args.simulate:
        return cmd_simulate(args)
    if args.msci_create:
        from .tools.msci_create import cmd_msci_create
        return cmd_msci_create(args.msci_create)
    if args.bfdriver:
        from .tools.bfdriver import cmd_bfdriver
        return cmd_bfdriver(args.bfdriver, args.points)
    build_argparser().print_help()
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
