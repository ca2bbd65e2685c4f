#!/usr/bin/env python3
"""Does the batched ``chains = K`` step round as the one-chain step does?

    python3 chain_rounding.py [--device cpu] [--loci N] [--iters N]

``Engine._step_batched`` is ``torch.func.vmap`` of the one-chain step, so
every op sees the K chains' rows at once; an op whose result depends on
the shape it is given (a CUDA reduction picks its summation order from
it) rounds otherwise batched, and a chain drifts from its one-chain run.
This script finds such ops and moves on one device (the card by default):

* ``[ops]``: single reductions over the shapes an MSC-M step sums (1-D
  and [L, X] sums, sums over either axis, cumsums), each ``vmap``-ped over
  4 random rows against 4 calls one row at a time, bit for bit.
* ``[moves]``: on four configurations of ``chip_smoke.py``'s MSC-M data
  (1000 loci simulated with migration A <-> B, 4 chains: main 26's
  routes, main 27's A10 x MSC-M, variable-rate routes, main 14's geneflow
  file on 100 loci), after 3 batched iterations, each move of the MSC-M
  schedule alone from the same states and generators, batched against
  the 4 one-chain calls; then ``--iters`` whole iterations both ways.
  Each line names the state leaves that differ: chains, elements, the
  largest relative difference.

Prints the card's name and power limit.  Exits non-zero without a CUDA
device unless ``--device cpu``.
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

    def check(name, fn, shape):
        x = torch.rand((K,) + shape, generator=gen, device=dev) - 0.3
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


def move_checks(dev, n_loci, iters):
    """``[moves]`` lines for the four MSC-M configurations."""
    import torch

    import chip_smoke as cs
    from bpp_tpu_torch.mcmc import mig_moves as mm
    from bpp_tpu_torch.mcmc import rj_moves, rng
    from bpp_tpu_torch.mcmc.driver import Engine, chain_views, stack_states
    from bpp_tpu_torch.mcmc.graph import flatten, unflatten
    from bpp_tpu_torch.testing import MIG_RUN

    def clone(gens):
        out = []
        for g in gens:
            c = torch.Generator(device=dev)
            c.set_state(g.get_state())
            out.append(c)
        return out

    cs.write_mig_data("sim12", n_loci, "4 4 4 4", "model = 0\n")
    run_ctl = cs.RUN_CTL.replace("seqfile = sim.phy", "seqfile = sim12.phy") \
        .replace("Imapfile = sim.Imap.txt", "Imapfile = sim12.Imap.txt")
    configs = {
        "main 26": (n_loci, MIG_RUN + cs.MIG_WPRIOR),
        "main 27": (n_loci, MIG_RUN + cs.MIG_WPRIOR + cs.A10_27),
        "am routes": (n_loci, "migration = 2\nA B 20 40 3\nB A 20 40 3\n"
                      + cs.MIG_WPRIOR),
        "main 14 x 4": (min(n_loci, cs.N_LOCI_14B),
                        MIG_RUN + cs.MIG_WPRIOR + cs.GENEFLOW),
    }
    for label, (loci, extra) in configs.items():
        ctl = f"rounding_{label.replace(' ', '_')}.ctl"
        with open(ctl, "w") as f:
            f.write(run_ctl.format(nloci=loci, burnin=5, nsample=20,
                                   job="rounding",
                                   extra=extra + f"chains = {K}\n"))
        eng = Engine(cs.load_run(ctl), seed=1, device=dev)
        eng.route = "eager"
        cfg, ctx, routes = eng.cfg, eng.ctx, eng.mig_routes
        gens = [torch.Generator(device=dev).manual_seed(eng.chain_seed(c))
                for c in range(K)]
        st = stack_states(eng.init_states(K))
        for _ in range(3):
            st, _ = eng._step_batched(st, gens)
        spec, leaves = flatten(st)
        names = leaf_names(st)
        idx = torch.arange(K, device=dev)
        ctx_k = dataclasses.replace(ctx, chains=K)
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
        if cfg.est_delimit:
            def rj(ctx_, cfg_, routes_, state, gen):
                return rj_moves.rj_move(ctx_, cfg_, state, gen,
                                        eng.root_age0, routes=routes_)
            moves.append(("rj", rj))
        print(f"[moves] {label}: {loci} loci, {K} chains, "
              f"{int((st.mig.node >= 0).sum())} migration events after 3 "
              "batched iterations", flush=True)
        for name, move in moves:
            g1, g2 = clone(gens), clone(gens)

            def one(lv, i, move=move, g1=g1):
                new, _ = move(ctx_k, cfg, routes, unflatten(spec, iter(lv)),
                              rng.ChainGens(g1, i))
                return flatten(new)[1]

            out = torch.func.vmap(one)(leaves, idx)
            ones = [move(ctx, cfg, routes, view, g2[k])[0]
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
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("chain_rounding: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    smi = (cs.nvidia_smi_line() if args.device == "cuda"
           else "the CPU (--device cpu)")
    print(f"[device] {smi}", flush=True)
    t0 = time.perf_counter()
    op_checks(args.device, torch.Generator(device=args.device).manual_seed(3))
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="bpp_rounding_") as work:
        os.chdir(work)
        try:
            move_checks(args.device, args.loci, args.iters)
        finally:
            os.chdir(cwd)
    print(f"[time] {time.perf_counter() - t0:.1f} s | {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
