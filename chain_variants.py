#!/usr/bin/env python3
"""Time variants of kernels K3 and K4 (``bpp_tpu_torch/csrc/chain_kernel.cu``)
and K5 (``csrc/simwalk_kernel.cu``) on one GPU, in one process, against the
sources as they stand.

    python3 chain_variants.py

Each variant is the source with one or two constants changed, built with nvcc
into a temporary directory (one nvcc a variant, all started together):
``D = 1`` .. ``D = 4`` (the loci a round resolves, ``kDepth``; the source
takes 5, the deepest whose round fits one warp), ``no table`` (K3 evaluates
every lgamma, its table of K0 +- 128 counts off), ``16 warps`` (a block of 16
warps: K3's round spread over 14 item warps, K4 with 15 staging warps).  The
inputs are the GPU tests' synthetic 1000-locus chains
(``tests/test_torch_kernel_gpu.py``'s ``_k3_case`` and ``_k4_case``, from a
seed): K3 with 7 populations, once as made (a proposing locus changes the
waiting sums of every population with a coalescence) and once cut to at
most one changed population a proposing locus (main 5 of ``chip_smoke.py``
changes 1.04), each labelled with its mean; and K4.
K5's variants set the lanes a locus (``kLanes``: 32, 16, 8) and the warps a
block (``kWarps``: 4, 8); its inputs are the GPU tests' synthetic sim-SPR
walks (``bpp_tpu_torch.testing.synthetic_walks``) at main 12's shape in
``chip_smoke.py`` (63 sub-edges, 7 populations, 32 event slots) on 1000 and
on 10,000 loci, and on 1000 loci with 63 populations and 62 routes, in
float32 (main 12's type) and float64.
Each line gives the milliseconds a launch (CUDA events over 20 launches back
to back, the median of 7, every variant timed in turn twice, the mean of the
two), checks each variant's decisions (K5: all eight outputs, bit for bit)
against the unchanged source's, and names the card and its power limit.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent
DEPTH = "constexpr int kDepth = 5;"
VARIANTS = {
    "D = 5 (source)": [],
    **{f"D = {d}": [(DEPTH, f"constexpr int kDepth = {d};")]
       for d in (4, 3, 2, 1)},
    "no table": [("constexpr int kTableHalf = 128;",
                  "constexpr int kTableHalf = 0;")],
    "16 warps": [("constexpr int kWarps = 8;", "constexpr int kWarps = 16;"),
                 ("constexpr int kHeader = 256;",
                  "constexpr int kHeader = 512;")],
}
L, H = 1000, 7
LANES = "constexpr int kLanes = 32;"
WARPS = "constexpr int kWarps = 4;"
WALK_VARIANTS = {
    f"{g} lanes, {w} warps" + (" (source)" if (g, w) == (32, 4) else ""):
    [(LANES, f"constexpr int kLanes = {g};"),
     (WARPS, f"constexpr int kWarps = {w};")]
    for g in (32, 16, 8) for w in (4, 8)}
# main 12's walk: 63 sub-edges (31 nodes, 32 event slots), 7 populations
# (4 routes), on 1000 and 10,000 loci; and 63 populations with routes
# between every sister pair (62, more than a warp's lanes)
WALK_E, WALK_ME = 63, 32
WALK_INPUTS = ((1000, 7, False), (10000, 7, False), (1000, 63, True))


def cases():
    """[(label, kernel, inputs, sums)] on the card."""
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_kernel_gpu import _k3_case, _k4_case
    rng = np.random.default_rng(15)
    cols, sums, _ = _k3_case(rng, L, H, "random")
    one = cols.clone()
    old, new = one[:, :2 * H].view(L, 2, H), one[:, 2 * H:4 * H].view(L, 2, H)
    changed = (old[:, 0] != old[:, 1]) | (new[:, 0] != new[:, 1])
    gen = torch.Generator().manual_seed(15)
    pick = torch.argmax(changed.double() * torch.rand(
        L, H, dtype=torch.float64, generator=gen), dim=1)
    keep = torch.arange(H)[None, :] != pick[:, None]
    old[:, 1][keep], new[:, 1][keep] = old[:, 0][keep], new[:, 0][keep]
    terms, _ = _k4_case(rng, L, "random")
    out = []
    for x in (cols, one):
        prop = x[:, 4 * H + 3] > 0.5
        per = ((x[:, :H] != x[:, H:2 * H])
               | (x[:, 2 * H:3 * H] != x[:, 3 * H:4 * H]))[prop]
        out.append((f"K3, H = {H}, {float(per.sum(1).double().mean()):.2f} "
                    "populations changed a proposing locus", "K3", x.cuda(),
                    sums.cuda()))
    return out + [("K4", "K4", terms.cuda(), None)]


def start(tmp, source, variants):
    """Start one nvcc a variant of ``csrc/<source>.cu`` (each variant's
    edits made to the source): {variant: (the library's path, the
    process)}.  Every source's nvcc processes are started before
    :func:`load` waits for any."""
    sys.path.insert(0, str(ROOT))
    from bpp_tpu_torch.core import _build
    src = (_build.CSRC / f"{source}.cu").read_text()
    jobs = {}
    for name, edits in variants.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        cu = os.path.join(tmp, f"{source}_v{len(jobs)}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = cu[:-3] + ".so"
        jobs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so, cu]))
    return jobs


def load(jobs):
    """{variant: loaded library} once every nvcc of ``jobs`` ended."""
    for name, (so, proc) in jobs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on the {name} variant")
    return {name: ctypes.CDLL(so) for name, (so, _) in jobs.items()}


def chain_libs(libs):
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for lib in libs.values():
        lib.bpp_notheta_depth.restype = I
        lib.bpp_notheta_depth.argtypes = [I]
        lib.bpp_notheta_chain.argtypes = [P, P, I, I, I, D, D, P, P]
        lib.bpp_gammadir_chain.argtypes = [P, I, I, D, D, D, P, P]
    return libs


def walk_libs(libs):
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for lib in libs.values():
        lib.bpp_simwalk.restype = I
        lib.bpp_simwalk.argtypes = [P] * 27 + [I] * 7 + [D, D, I, P]
    return libs


def walk_launcher(lib, args, outs, stream):
    """One K5 launch of ``lib`` on ``args`` (``synthetic_walks``' on the
    card) into ``outs``."""
    import torch

    from bpp_tpu_torch.mcmc import rng
    from bpp_tpu_torch.trees.migration import _FINITE_BIG
    xs, ME = args[:19], args[19]
    L, E = xs[0].shape
    H, K, S = xs[5].shape[0], xs[9].shape[0], xs[18].shape[1]
    dt = xs[0].dtype
    ptrs = [x.data_ptr() for x in xs] + [x.data_ptr() for x in outs]
    return lambda: lib.bpp_simwalk(
        *ptrs, 1, L, E, H, K, ME, S, _FINITE_BIG, rng.tiny_floor(dt),
        int(dt == torch.float64), stream)


def walk_outputs(args):
    """Empty outputs of a K5 launch on ``args``, as ``launch_simwalk``
    makes them."""
    import torch
    from bpp_tpu_torch.trees.gtree import BIG_AGE
    L, ME, dt = args[0].shape[0], args[19], args[0].dtype
    i64, bl = torch.int64, torch.bool
    return (torch.empty(L, dtype=dt, device="cuda"),
            torch.empty(L, dtype=i64, device="cuda"),
            torch.empty(L, dtype=bl, device="cuda"),
            torch.empty(L, dtype=bl, device="cuda"),
            torch.full((L, ME), BIG_AGE, dtype=dt, device="cuda"),
            torch.zeros((L, ME), dtype=i64, device="cuda"),
            torch.zeros((L, ME), dtype=i64, device="cuda"),
            torch.empty(L, dtype=i64, device="cuda"))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chain_variants: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    inputs = cases()
    out = torch.empty(L, dtype=torch.bool, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def launcher(lib, kernel, x, s):
        if kernel == "K3":
            return lambda: lib.bpp_notheta_chain(
                x.data_ptr(), s.data_ptr(), 1, L, H, 3.0, 0.03,
                out.data_ptr(), stream)
        return lambda: lib.bpp_gammadir_chain(
            x.data_ptr(), 1, L, 10.0, 10.0, 5.0, out.data_ptr(), stream)

    def ms(fn, reps=20):
        for _ in range(3):
            if fn() != 0:
                raise RuntimeError("launch refused")
        torch.cuda.synchronize()
        times = []
        for _ in range(7):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / reps)
        return statistics.median(times)

    with tempfile.TemporaryDirectory(prefix="bpp_variants_") as tmp:
        walk_jobs = start(tmp, "simwalk_kernel", WALK_VARIANTS)
        libs = chain_libs(load(start(tmp, "chain_kernel", VARIANTS)))
        walks = walk_libs(load(walk_jobs))
        names = list(libs)
        print("[variants] K3's depth at H = 7 by variant: " + ", ".join(
            f"{name} {lib.bpp_notheta_depth(H)}"
            for name, lib in libs.items()) + f" | {smi}", flush=True)
        for label, kernel, x, s in inputs:
            want = None
            for name in names:
                launcher(libs[name], kernel, x, s)()
                torch.cuda.synchronize()
                got = out.cpu()
                if want is None:
                    want = got
                elif not torch.equal(got, want):
                    raise AssertionError(f"{label}: the {name} variant "
                                         "decides otherwise")
            times = {name: [] for name in names}
            for turn in (names, names[::-1]):
                for name in turn:
                    times[name].append(ms(launcher(libs[name], kernel, x, s)))
            print(f"[variants] {label}, L = {L}, {int(want.sum())} accepted: "
                  + " | ".join(f"{name} {statistics.mean(t):.4f}"
                               for name, t in times.items())
                  + f" ms a launch; decisions equal | {smi}", flush=True)
        time_walks(walks, ms, stream, smi)
    return 0


def time_walks(libs, ms, stream, smi):
    """K5's lines: every variant on each input, outputs held bit-equal to
    the source's, timed in turns."""
    import torch

    from bpp_tpu_torch.mcmc.mig_moves import simspr_walk_ref
    from bpp_tpu_torch.testing import synthetic_walks
    from chip_smoke import bits
    names = list(libs)
    for n_loci, pops, every in WALK_INPUTS:
        for dt in (torch.float32, torch.float64):
            args, _ = synthetic_walks(n_loci, WALK_E, pops, ME=WALK_ME,
                                      seed=16, dtype=dt, device="cuda",
                                      every_pair=every)
            steps = torch.zeros(n_loci, dtype=torch.int64, device="cuda")
            simspr_walk_ref(*args, steps=steps)
            want, times = None, {name: [] for name in names}
            for name in names:
                outs = walk_outputs(args)
                if walk_launcher(libs[name], args, outs, stream)() != 0:
                    raise RuntimeError(f"{name}: launch refused")
                torch.cuda.synchronize()
                got = [bits(x).cpu() for x in outs]
                if want is None:
                    want = got
                elif not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"K5, {n_loci} loci, {dt}: the "
                                         f"{name} variant walks otherwise")
            for turn in (names, names[::-1]):
                for name in turn:
                    times[name].append(ms(walk_launcher(
                        libs[name], args, walk_outputs(args), stream)))
            print(f"[variants] K5, L = {n_loci}, E = {WALK_E}, H = {pops}, "
                  f"K = {args[9].shape[0]}, "
                  f"{str(dt).split('.')[-1]}, longest walk "
                  f"{int(steps.max())} steps (mean "
                  f"{float(steps.double().mean()):.1f}): "
                  + " | ".join(f"{name} {statistics.mean(t):.4f}"
                               for name, t in times.items())
                  + f" ms a launch; outputs bit-equal | {smi}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
