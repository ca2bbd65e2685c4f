#!/usr/bin/env python3
"""Does the batched ``chains = K`` step round as the one-chain step does?

    python3 chain_rounding.py [--device cpu] [--loci N] [--iters N]
                              [--configs LABEL,...] [--package DIR]

``Engine._step_batched`` is ``torch.func.vmap`` of the one-chain step, so
every op sees the K chains' rows at once; an op whose result depends on
the shape it is given (a CUDA reduction picks its summation order from
it) rounds otherwise batched, and a chain drifts from its one-chain run.
This script finds such ops and moves on one device (the card by default):

* ``[ops]``: single reductions over the shapes the steps sum (1-D and
  [L, X] sums, sums over either axis, cumsums), the sum of each locus's
  events into its populations (``per_pop_stats``, over the innermost
  axis) and of the pairwise coexistence times of dated tips
  (``per_pop_stats_dated``, over two outer axes), the 4 x 4 products of
  ``eigh_jacobi`` and the whole solver, and the 20-state plain pass's
  products at main 9's
  shapes (P(t) of WAG and of a per-locus eigensystem, a matmul each, and
  the pruning's broadcast-sum), each ``vmap``-ped over 4 random rows (or,
  where the batched step hands the K chains' loci over as one batch,
  called once on the 4 rows' loci) against 4 calls one row at a time,
  bit for bit.
* ``[moves]``: on configurations of ``chip_smoke.py`` with 4 chains
  (``--loci`` loci each, 30 on the BDI fixture and 100 on main 14's
  geneflow file): main 13's A00 JC69 run and main 25's integrated
  thetas on main 1's tree; linked-inner thetas there; main 28's MSC-I
  network (main 10's file) and main 11's BDI fixture with linked-msci
  thetas; main 26's MSC-M routes, main 27's A10 x MSC-M, variable-rate
  routes and main 14's geneflow file; main 29's GTR+G4 (main 20's file),
  main 5's dated file with integrated thetas, main 9's WAG file (100
  loci), main 8's five-model partition (100 loci, 20 a model) and main
  15's traits (100 loci).  After 3 batched iterations, each
  move of the configuration's schedule alone from the same states and
  generators, batched against the 4 one-chain calls; then ``--iters``
  whole iterations both ways.  Each line names the state leaves that
  differ: chains, elements, the largest relative difference.

``--configs`` takes a comma-separated subset of those labels.
``--package DIR`` imports ``bpp_tpu_torch`` from DIR (a checkout of
another commit, e.g. the parent's, whose batched route must take the
configurations asked for), so that one call compares two trees.  Prints
the card's name and power limit.  Exits non-zero without a CUDA device
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time

K = 4


def op_checks(dev, gen):
    """``[ops]`` lines: each reduction batched against one row at a
    time."""
    import torch

    def check(name, fn, shape, flat=False):
        x = torch.rand((K,) + shape, generator=gen, device=dev) - 0.3
        if flat:
            got = fn(x.reshape((-1,) + shape[1:]))
            got = got.reshape((K, -1) + tuple(got.shape[1:]))
        else:
            got = torch.func.vmap(fn)(x)
        ones = torch.stack([fn(x[k]) for k in range(K)])
        diff = (got.double() - ones.double()).abs().max().item()
        print(f"[ops] {name} over {shape} (float32): bit-equal "
              f"{torch.equal(got, ones)} (max |d| {diff:.3e})", flush=True)

    for shape in ((1000,), (4000,), (100,), (22,), (7,), (1000, 31),
                  (1000, 32), (1000, 7)):
        check("sum()", lambda x: x.sum(), shape)
    for shape in ((1000, 7), (1000, 22), (1000, 32), (1000, 126)):
        check("sum(0)", lambda x: x.sum(0), shape)
        check("sum(1)", lambda x: x.sum(1), shape)
    for shape in ((1000,), (22,)):
        check("cumsum(0)", lambda x: torch.cumsum(x, 0), shape)
    check("cumsum(1)", lambda x: torch.cumsum(x, 1), (1000, 22))
    # coalescent.per_pop_stats' sum of each locus's events into its
    # populations (the waiting-time terms of T2h): 1000 or 30 loci, 15
    # events, 10 or 13 populations, the event one-hot half of x
    for loci, pops in ((1000, 10), (30, 13)):
        check("sum over the innermost axis of [L, H, E] of per_pop_stats",
              lambda x, p=pops: torch.sum(
                  (x[..., :p] > 0.35).to(x.dtype).transpose(1, 2)
                  * x[:, None, :, p], dim=2), (loci, 15, pops + 1))
    # per_pop_stats_dated's pairwise coexistence times [L, N, N, H] of
    # main 5's batch (16 tip slots, 7 populations), summed over both edge
    # axes
    check("sum((1, 2)) of per_pop_stats_dated",
          lambda x: x.sum((1, 2)), (1000, 31, 31, 7))
    # eigh_jacobi's 4 x 4 products (a batched matmul), on a locus's GTR
    # system each (main 20's 1000 loci, main 8 x 4's 100), and the solver
    from bpp_tpu_torch.core import pmatrix
    for loci in (1000, 100):
        check("4 x 4 matmul a @ b of eigh_jacobi",
              lambda x: x[..., :4] @ x[..., 4:], (loci, 4, 8))
        check("eigh_jacobi (eigenvalues and vectors)",
              lambda x: torch.cat([t.reshape(x.shape[0], -1)
                                   for t in pmatrix.eigh_jacobi(_sym(x))],
                                  -1), (loci, 4, 4))
    # the 20-state plain pass at main 9's shapes (500 loci, 31 nodes, 1
    # category): the batched step hands fels.site_logl_fels_ref the K
    # chains' loci as one batch (pack.chain_pass), so these run once on
    # the 4 rows' loci against once a row
    check("20-state P(t) of WAG (matmul [L, N, C, 20, 20] @ [20, 20])",
          lambda x: pmatrix.pmatrix_aa(x, "WAG"), (500, 31, 1), flat=True)
    check("20-state P(t) of a per-locus eigensystem (batched matmul)",
          lambda x: torch.matmul(x[..., :20], x[:, :1, :1, :, 20:]),
          (100, 31, 1, 20, 40), flat=True)
    from bpp_tpu_torch.core import felsenstein as fe
    check("20-state pruning product (einsum 'lcab,lscb->lsca')",
          lambda x: fe._pclv(x[:, :20, :, :20].transpose(1, 2),
                             x[:, :, :, 20:]), (500, 40, 1, 40), flat=True)


def _sym(x):
    """Symmetric 4 x 4 matrices from ``x`` (elementwise, so that they are
    the same batched and one at a time): eigh_jacobi's inputs."""
    import torch
    return x + x.transpose(-1, -2) + 4.0 * torch.eye(4, device=x.device)


def leaf_names(tree, prefix=""):
    """Dotted names of a state's tensors, in ``graph.flatten`` order."""
    import torch
    if tree is None:
        return []
    if torch.is_tensor(tree):
        return [prefix]
    out = []
    for f, v in zip(tree._fields, tree):
        out += leaf_names(v, f"{prefix}.{f}" if prefix else f)
    return out


def compare(names, batched, ones):
    """'bit-equal', or each differing leaf: chain:elements@largest
    relative difference."""
    import torch

    from bpp_tpu_torch.mcmc.graph import flatten
    diffs = {}
    for k, one in enumerate(ones):
        for n, a, b in zip(names, batched, flatten(one)[1]):
            if torch.equal(a[k], b):
                continue
            d = ((a[k].double() - b.double()).abs()
                 / b.double().abs().clamp(min=1e-30))
            d = d[torch.isfinite(d)]
            diffs.setdefault(n, []).append(
                f"c{k}:{int((a[k] != b).sum())}@{d.max().item():.1e}"
                if d.numel() else f"c{k}")
    return ("bit-equal" if not diffs else
            "; ".join(f"{n} {' '.join(v)}" for n, v in diffs.items()))


CONFIGS = ("main 13", "main 25", "linked-inner", "main 28", "main 11 x 4",
           "main 26", "main 27", "am routes", "main 14 x 4", "main 29",
           "main 5 x 4", "main 9 x 4", "main 8 x 4", "main 15 x 4")
# the loci of the configurations chip_smoke.py's [chains-batch] cuts
CUT_LOCI = 100


def write_configs(n_loci, labels):
    """The control files of ``labels`` (their data simulated once each, in
    the current directory): {label: (control file, loci)}."""
    import chip_smoke as cs
    from bpp_tpu_torch.testing import MIG_RUN, NET_GUIDE

    def run_ctl(prefix, guide=None):
        text = cs.RUN_CTL.replace("seqfile = sim.phy",
                                  f"seqfile = {prefix}.phy").replace(
            "Imapfile = sim.Imap.txt", f"Imapfile = {prefix}.Imap.txt")
        return text if guide is None else text.replace(
            "((A, B), (C, D));", guide + ";")

    made = set()

    def data(prefix):
        if prefix in made:
            return
        made.add(prefix)
        if prefix == "sim1":
            with open("sim1.ctl", "w") as f:
                f.write(cs.SIM10_CTL.format(
                    prefix="sim1", seqs="4 4 4 4", tree=cs.MAIN1_TREE,
                    nloci=n_loci, extra="model = 0"))
            from bpp_tpu_torch.sim.simulate import run_simulation
            run_simulation("sim1.ctl")
        elif prefix == "sim10":
            cs.write_net_data("sim10", n_loci, "4 4 4 4", "model = 0")
        elif prefix == "aa":
            from bpp_tpu_torch.testing import generate_aa_benchmark
            generate_aa_benchmark(min(n_loci, CUT_LOCI), cs.AA_SITES, ".")
        else:
            cs.write_mig_data("sim12", n_loci, "4 4 4 4", "model = 0\n")

    mig = MIG_RUN + cs.MIG_WPRIOR
    table = {
        "main 13": ("sim1", None, n_loci, ""),
        "main 25": ("sim1", None, n_loci,
                    cs.INT_25.format(k=K).replace(f"chains = {K}\n", "")),
        "linked-inner": ("sim1", None, n_loci, "thetamodel = linked-inner\n"),
        "main 28": ("sim10", NET_GUIDE, n_loci, "phiprior = 1 1\n"),
        "main 11 x 4": ("bdi", None, 30, "thetamodel = linked-msci\n"),
        "main 26": ("sim12", None, n_loci, mig),
        "main 27": ("sim12", None, n_loci, mig + cs.A10_27),
        "am routes": ("sim12", None, n_loci,
                      "migration = 2\nA B 20 40 3\nB A 20 40 3\n"
                      + cs.MIG_WPRIOR),
        "main 14 x 4": ("sim12", None, min(n_loci, cs.N_LOCI_14B),
                        mig + cs.GENEFLOW),
        "main 29": ("sim1", None, n_loci, "model = GTR\n" + cs.GAMMA4),
        "main 5 x 4": ("sim1", None, n_loci, cs.DATED_RUN),
        "main 9 x 4": ("aa", None, min(n_loci, CUT_LOCI), ""),
        "main 8 x 4": ("sim1", None, min(n_loci, CUT_LOCI),
                       "model = custom parts8b.txt\n"),
        "main 15 x 4": ("sim1", None, min(n_loci, CUT_LOCI),
                        "traitfile = traits.txt\n"),
    }
    if "main 5 x 4" in labels:
        cs.write_dates("dates.txt")
    if "main 8 x 4" in labels:
        from bpp_tpu_torch.testing import write_partition_file
        write_partition_file("parts8b.txt", cs.CUSTOM_MODELS,
                             min(n_loci, CUT_LOCI))
    if "main 15 x 4" in labels:
        from bpp_tpu_torch.testing import write_trait_file
        write_trait_file("traits.txt", seed=137)
    out = {}
    for label in labels:
        prefix, guide, loci, extra = table[label]
        ctl = f"rounding_{label.replace(' ', '_')}.ctl"
        extra += f"chains = {K}\n"
        if prefix == "aa":
            data(prefix)
            text = cs.AA_CTL.format(nloci=loci, burnin=5,
                                    nsample=20) + extra
        elif prefix == "bdi":
            fix = os.path.join(os.path.dirname(os.path.abspath(
                cs.__file__)), "tests", "fixtures", "bdi")
            text = cs.BDI_CTL.format(fix=fix, job="rounding", burnin=5,
                                     nsample=20, extra=extra)
        else:
            data(prefix)
            text = run_ctl(prefix, guide).format(
                nloci=loci, burnin=5, nsample=20, job="rounding",
                extra=extra)
        with open(ctl, "w") as f:
            f.write(text)
        out[label] = (ctl, loci)
    return out


def schedule(eng):
    """(name, move(ctx, cfg, state, gen)) of each move of ``eng``'s
    schedule, one SPR round for three."""
    from bpp_tpu_torch.mcmc import clock_moves as cm
    from bpp_tpu_torch.mcmc import mig_moves as mm
    from bpp_tpu_torch.mcmc import moves as mv
    from bpp_tpu_torch.mcmc import msci_moves as mi
    from bpp_tpu_torch.mcmc import rj_moves
    from bpp_tpu_torch.mcmc import subst_moves as sm
    from bpp_tpu_torch.mcmc import trait_moves as tm
    cfg, routes = eng.cfg, eng.mig_routes

    def rj(ctx, cfg_, state, gen):
        return rj_moves.rj_move(ctx, cfg_, state, gen, eng.root_age0,
                                routes=routes)

    if cfg.migration:
        def with_routes(move):
            return lambda ctx, cfg_, state, gen: move(ctx, cfg_, routes,
                                                      state, gen)
        moves = [("age", mm.age_block_mig),
                 ("event ages", mm.migevent_age_move),
                 ("sim-SPR", mm.spr_sim_move), ("theta", mm.theta_move_mig),
                 ("tau", mm.tau_move_mig), ("rates", mm.migrate_move),
                 ("mixing", mm.mixing_mig)]
        if routes.any_am:
            moves += [("vrates", mm.mig_vrates_move),
                      ("mbar", mm.mig_mbar_move)]
        if cfg.geneflow:
            moves += [("flip", mm.geneflow_flip_move),
                      ("add/remove", mm.geneflow_rj_move)]
        moves = [(n, with_routes(m)) for n, m in moves]
    else:
        fixed = cfg.usedata_fix_gtree
        moves = [] if fixed else [("age", mv.age_block_move),
                                  ("SPR", mv.spr_round_move)]
        if not cfg.theta_integrated:
            moves.append(("theta", mv.theta_move))
        if eng.run.stree.n_hybrids:
            moves += [("tau", mi.tau_move_net), ("repath", mi.repath_move),
                      ("phi", mi.phi_gibbs_move)]
        elif not fixed:
            moves.append(("tau", mv.tau_move))
        if not fixed:
            moves.append(("mixing", mv.mixing_move)
                         if eng.ctx.tip_dates is None else
                         ("mubar (tip dating)", cm.tipdate_mubar_move))
    if cfg.est_delimit:
        moves.append(("rj", rj))
    # the substitution, locus-rate and trait moves (Engine._step's order)
    custom = eng.ctx.custom
    if cfg.est_locusrate == 1 and cfg.locusrate_prior == 3:
        moves.append(("locus rates", sm.locusrate_move))
    if cfg.model in sm.FREQS_MODELS or (custom is not None
                                        and custom.any_freqs):
        moves.append(("freqs", sm.freqs_move))
    if cfg.model in sm.QRATES_COUNT or (custom is not None
                                        and custom.q_slots):
        moves.append(("qrates", sm.qrates_move))
    if cfg.alphaprior is not None:
        moves.append(("alpha", sm.alpha_move))
    if cfg.est_locusrate == 1 and cfg.locusrate_prior in (0, 1):
        moves.append(("mu_i", cm.mui_move))
    if eng.ctx.has_traits:
        moves.append(("trait rates", tm.trait_brate_move))
    return moves


def move_checks(dev, n_loci, iters, labels):
    """``[moves]`` lines for the configurations ``labels``."""
    import torch

    import chip_smoke as cs
    from bpp_tpu_torch.mcmc import rng
    from bpp_tpu_torch.mcmc.driver import Engine, chain_views, stack_states
    from bpp_tpu_torch.mcmc.graph import flatten, unflatten

    def clone(gens):
        out = []
        for g in gens:
            c = torch.Generator(device=dev)
            c.set_state(g.get_state())
            out.append(c)
        return out

    for label, (ctl, loci) in write_configs(n_loci, labels).items():
        eng = Engine(cs.load_run(ctl), seed=1, device=dev)
        eng.route = "eager"
        cfg, ctx = eng.cfg, eng.ctx
        gens = [torch.Generator(device=dev).manual_seed(eng.chain_seed(c))
                for c in range(K)]
        st = stack_states(eng.init_states(K))
        for _ in range(3):
            st, _ = eng._step_batched(st, gens)
        spec, leaves = flatten(st)
        names = leaf_names(st)
        idx = torch.arange(K, device=dev)
        ctx_k = dataclasses.replace(ctx, chains=K)
        what = (f"{int((st.mig.node >= 0).sum())} migration events"
                if cfg.migration else f"route {eng.ctx.route}")
        print(f"[moves] {label}: {loci} loci, {K} chains, {what} after 3 "
              "batched iterations", flush=True)
        for name, move in schedule(eng):
            g1, g2 = clone(gens), clone(gens)

            def one(lv, i, move=move, g1=g1):
                new, _ = move(ctx_k, cfg, unflatten(spec, iter(lv)),
                              rng.ChainGens(g1, i))
                return flatten(new)[1]

            out = torch.func.vmap(one)(leaves, idx)
            ones = [move(ctx, cfg, view, g2[k])[0]
                    for k, view in enumerate(chain_views(st, K))]
            print(f"[moves] {label} {name}: {compare(names, out, ones)}",
                  flush=True)
        g1, g2 = clone(gens), clone(gens)
        batched, ones = st, chain_views(st, K)
        for it in range(iters):
            batched, stats = eng._step_batched(batched, g1)
            same = True
            for k in range(K):
                eng.gen = g2[k]
                ones[k], s1 = eng._step(ones[k])
                same = same and bool(torch.equal(stats[k], s1))
            print(f"[moves] {label} iteration {it + 1}: statistics equal "
                  f"{same}; {compare(names, flatten(batched)[1], ones)}",
                  flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--loci", type=int, default=1000)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--configs", default=",".join(CONFIGS))
    ap.add_argument("--package", default=None, metavar="DIR")
    args = ap.parse_args(argv)
    labels = [c.strip() for c in args.configs.split(",") if c.strip()]
    unknown = sorted(set(labels) - set(CONFIGS))
    if unknown:
        ap.error(f"unknown configurations {unknown}; known: {CONFIGS}")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.package:
        sys.path.insert(0, os.path.abspath(args.package))
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("chain_rounding: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    smi = (cs.nvidia_smi_line() if args.device == "cuda"
           else "the CPU (--device cpu)")
    import bpp_tpu_torch
    print(f"[device] {smi} | bpp_tpu_torch from "
          f"{os.path.dirname(bpp_tpu_torch.__file__)}", flush=True)
    t0 = time.perf_counter()
    op_checks(args.device, torch.Generator(device=args.device).manual_seed(3))
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="bpp_rounding_") as work:
        os.chdir(work)
        try:
            move_checks(args.device, args.loci, args.iters, labels)
        finally:
            os.chdir(cwd)
    print(f"[time] {time.perf_counter() - t0:.1f} s | {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
