"""The port's main paths end to end on the CPU: 4 species x 2 sequences,
12 loci of 200 sites, JC69, A00; and unphased diploid data (species A, B
with one diploid individual each, C, D with two haploid sequences, 6 loci
of 120 sites) under HKY+G4 with hierarchical locus rates and heredity
scalars.

* ``python -m bpp_tpu_torch --cfile x.ctl --device cpu`` writes an
  mcmc.txt with bpp_tpu's header, finite lnL and moving theta/tau
  columns, the summary and FigTree.tre.
* The theta/tau posterior means of a port chain agree with a bpp_tpu
  chain on the same data within 4 combined Monte Carlo standard errors
  (batch means).
* The diploid chain, run through ``cli.main([... "--device", "cpu"])``,
  writes bpp_tpu's mcmc.txt header, ``mu_bar`` included, and its
  theta/tau means agree with a bpp_tpu chain in the same way.
* So do those of a relaxed-clock chain (clock = 2, 5 loci of 120 sites).
* A01 (species SPR + SNL) and A10 chains through ``cli.main([...,
  "--device", "cpu"])`` on 3 species x 4 sequences, 10 loci of 200 sites
  simulated on ((A,B),C): every mcmc.txt line is what ``bpp_tpu``'s
  writers print for the same sample (A10: the same header too); the
  posterior probability of the true topology / of three species agrees
  with a ``bpp_tpu`` chain on the same data (both >= 0.9, else within 4
  combined Monte Carlo standard errors); the A01 and A10 reports equal
  ``bpp_tpu``'s ``format_a01_summary`` / ``format_a10_summary`` of the
  same samples byte for byte; an A01 run resumed from its checkpoint
  writes an mcmc.txt byte-identical to the uninterrupted run's.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

torch.set_num_threads(1)     # tiny tensors; the suite runs in parallel


@pytest.fixture(scope="module")
def ctl(tmp_path_factory):
    from bpp_tpu_torch.testing import write_simulated_run
    tmp = tmp_path_factory.mktemp("torchengine")
    return write_simulated_run(tmp, n_loci=12, burnin=20, nsample=40)


def test_cli_device_cpu_writes_outputs(ctl):
    from bpp_tpu.loader import load_run_from_ctl
    from bpp_tpu.output import McmcWriter
    out = subprocess.run(
        [sys.executable, "-m", "bpp_tpu_torch", "--cfile", ctl,
         "--device", "cpu", "--quiet"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    job = Path(ctl).with_name("out")
    mcmc = Path(f"{job}.mcmc.txt")
    lines = mcmc.read_text().splitlines()
    run = load_run_from_ctl(ctl)
    ref = Path(ctl).with_name("ref_header.txt")
    McmcWriter(str(ref), run.cfg, run.stree).close()
    assert lines[0] == ref.read_text().rstrip("\n")
    header = lines[0].split("\t")
    data = np.array([[float(x) for x in ln.split("\t")] for ln in lines[1:]])
    assert data.shape == (40, len(header))
    assert np.isfinite(data).all()
    assert (data[:, -1] < 0).all()
    for j, col in enumerate(header):
        if col.startswith(("theta", "tau")):
            assert data[:, j].std() > 0, col
    assert "lnL" in Path(f"{job}.txt").read_text()
    assert Path(f"{job}.FigTree.tre").read_text().strip()


def _means_and_se(x, n_batches=20):
    n = len(x) // n_batches * n_batches
    b = x[:n].reshape(n_batches, -1, *x.shape[1:]).mean(1)
    return x.mean(0), b.std(0, ddof=1) / np.sqrt(n_batches)


def test_posterior_means_match_bpp_tpu(ctl):
    from bpp_tpu.loader import load_run_from_ctl as load_jax
    from bpp_tpu.mcmc.driver import Engine as EngineJ
    from bpp_tpu_torch.loader import load_run_from_ctl as load_port
    from bpp_tpu_torch.mcmc.driver import Engine as EngineP

    rj = load_jax(ctl)
    rj.cfg = rj.cfg.replace(dtype="float64", burnin=200, nsample=6000)
    _, th_j, tau_j, _, _ = EngineJ(rj, seed=5).run_mcmc(
        progress_every=0).arrays()
    rp = load_port(ctl)
    rp.cfg = rp.cfg.replace(dtype="float64", burnin=200, nsample=1000)
    _, th_p, tau_p, _, _ = EngineP(rp, seed=6, device="cpu").run_mcmc(
        progress_every=0).arrays()

    st = rp.stree
    cols = [("theta", i) for i in range(st.n_nodes)] + \
        [("tau", i) for i in range(st.n_tips, st.n_nodes)]
    for kind, i in cols:
        xj = (th_j if kind == "theta" else tau_j)[:, i]
        xp = (th_p if kind == "theta" else tau_p)[:, i]
        mj, sj = _means_and_se(xj)
        mp, sp = _means_and_se(xp)
        se = np.hypot(sj, sp)
        assert abs(mj - mp) < 4 * se, (kind, i, mj, mp, se)


DIPLOID_PRIORS = ("alphaprior = 1 1 4", "locusrate = 1 10 10 5 iid",
                  "heredity = 1 4 4")


@pytest.fixture(scope="module")
def diploid_run(tmp_path_factory):
    """The diploid HKY+G4 chain through the CLI, in float64 on the CPU:
    (control file, header, samples)."""
    from bpp_tpu_torch import cli
    from bpp_tpu_torch.testing import write_simulated_run
    tmp = tmp_path_factory.mktemp("torchdipengine")
    ctl = write_simulated_run(
        tmp, n_loci=6, n_sites=120, seqs=(1, 1, 2, 2), diploid=(1, 1, 0, 0),
        sim_model="model = 3\nkappa = 2\nbasefreqs = 0.3 0.2 0.2 0.3\n"
        "locusrate = 1 5", model="HKY", priors=DIPLOID_PRIORS, burnin=100,
        nsample=600)
    rc = cli.main(["--cfile", ctl, "--device", "cpu", "--x64", "--quiet"])
    assert rc == 0
    lines = Path(ctl).with_name("out.mcmc.txt").read_text().splitlines()
    data = np.array([[float(x) for x in ln.split("\t")] for ln in lines[1:]])
    return ctl, lines[0], data


def test_diploid_cli_writes_bpp_tpu_header_with_mu_bar(diploid_run):
    from bpp_tpu.loader import load_run_from_ctl
    from bpp_tpu.output import McmcWriter
    ctl, header, data = diploid_run
    run = load_run_from_ctl(ctl)
    assert run.batch.res_map.shape[2] >= 2
    ref = Path(ctl).with_name("ref_header.txt")
    McmcWriter(str(ref), run.cfg, run.stree).close()
    assert header == ref.read_text().rstrip("\n")
    cols = header.split("\t")
    assert "mu_bar" in cols
    assert data.shape == (600, len(cols))
    assert np.isfinite(data).all()
    for j, col in enumerate(cols):
        if col.startswith(("theta", "tau", "mu_bar")):
            assert data[:, j].std() > 0, col


def test_diploid_posterior_means_match_bpp_tpu(diploid_run):
    from bpp_tpu.loader import load_run_from_ctl as load_jax
    from bpp_tpu.mcmc.driver import Engine as EngineJ
    from bpp_tpu.output import McmcWriter
    ctl, header, data = diploid_run
    rj = load_jax(ctl)
    rj.cfg = rj.cfg.replace(dtype="float64", burnin=200, nsample=4000)
    _, th_j, tau_j, _, _ = EngineJ(rj, seed=5).run_mcmc(
        progress_every=0).arrays()
    w = McmcWriter(str(Path(ctl).with_name("cols.txt")), rj.cfg, rj.stree)
    w.close()
    # mcmc.txt: Gen, thetas, taus, mu_bar, lnL
    cols = [(th_j, i) for i in w.theta_nodes] + [(tau_j, i)
                                                 for i in w.tau_nodes]
    names = header.split("\t")
    for j, (xj, i) in enumerate(cols, start=1):
        assert names[j].startswith(("theta", "tau")), names[j]
        mj, sj = _means_and_se(xj[:, i])
        mp, sp = _means_and_se(data[:, j])
        se = np.hypot(sj, sp)
        assert abs(mj - mp) < 4 * se, (names[j], mj, mp, se)


def test_relaxed_clock_posterior_means_match_bpp_tpu(tmp_path):
    """An IID relaxed clock (clock = 2, gamma rates, hierarchical nu_i):
    the theta/tau posterior means of a port chain agree with a bpp_tpu
    chain on the same data within 4 combined Monte Carlo standard
    errors."""
    from bpp_tpu.loader import load_run_from_ctl as load_jax
    from bpp_tpu.mcmc.driver import Engine as EngineJ
    from bpp_tpu_torch.loader import load_run_from_ctl as load_port
    from bpp_tpu_torch.mcmc.driver import Engine as EngineP
    from bpp_tpu_torch.testing import write_simulated_run
    c = write_simulated_run(tmp_path, n_loci=5, n_sites=120,
                            priors=("clock = 2 10 100 5 iid G",))
    rj = load_jax(c)
    rj.cfg = rj.cfg.replace(dtype="float64", burnin=200, nsample=2000)
    _, th_j, tau_j, _, _ = EngineJ(rj, seed=5).run_mcmc(
        progress_every=0).arrays()
    rp = load_port(c)
    rp.cfg = rp.cfg.replace(dtype="float64", burnin=100, nsample=500)
    eng = EngineP(rp, seed=6, device="cpu")
    assert eng.cfg.clock.value == 2
    _, th_p, tau_p, _, _ = eng.run_mcmc(progress_every=0).arrays()
    st = rp.stree
    cols = [("theta", i) for i in range(st.n_nodes)] + \
        [("tau", i) for i in range(st.n_tips, st.n_nodes)]
    for kind, i in cols:
        xj = (th_j if kind == "theta" else tau_j)[:, i]
        xp = (th_p if kind == "theta" else tau_p)[:, i]
        mj, sj = _means_and_se(xj)
        mp, sp = _means_and_se(xp)
        se = np.hypot(sj, sp)
        assert abs(mj - mp) < 4 * se, (kind, i, mj, mp, se)


SIM3 = dict(names="ABC", seqs=(4, 4, 4), n_loci=10, n_sites=200,
            sim_tree="((A #0.01, B #0.01) :0.01 #0.01, C #0.01) :0.03 #0.01",
            guide="((A, B), C)")


@pytest.fixture(scope="module")
def species_runs(tmp_path_factory):
    """A01 and A10 chains through the CLI on the CPU, float64: {method:
    (control file, mcmc.txt lines, report text)}."""
    from bpp_tpu_torch import cli, output
    from bpp_tpu_torch.testing import write_simulated_run
    out = {}
    written = []
    orig = output.A01McmcWriter.write_sample

    def record(self, gen, left, right, parent, tau):
        written.append((left, right, parent, tau))
        return orig(self, gen, left, right, parent, tau)

    output.A01McmcWriter.write_sample = record
    try:
        for method, prior in (("A01", "speciestree = 1 0.5 0.33 0.1 0.2"),
                              ("A10", "speciesdelimitation = 1 0 2")):
            tmp = tmp_path_factory.mktemp(f"torch{method}")
            ctl = write_simulated_run(tmp, burnin=20, nsample=100,
                                      priors=(prior, "checkpoint = 60 0"),
                                      **SIM3)
            assert cli.main(["--cfile", ctl, "--device", "cpu", "--x64",
                             "--quiet"]) == 0
            job = Path(ctl).with_name("out")
            out[method] = (ctl,
                           Path(f"{job}.mcmc.txt").read_text().splitlines(),
                           Path(f"{job}.txt").read_text())
    finally:
        output.A01McmcWriter.write_sample = orig
    out["A01 samples"] = written
    return out


def test_a01_lines_and_report_match_bpp_tpu(species_runs):
    from bpp_tpu.loader import load_run_from_ctl
    from bpp_tpu.output import read_mcmc_samples, species_newick
    from bpp_tpu.summary.stree_summary import (
        format_a01_summary, summarize_sptrees,
    )
    ctl, lines, report = species_runs["A01"]
    run = load_run_from_ctl(ctl)
    samples = species_runs["A01 samples"]
    assert len(lines) == len(samples) == 100
    for line, sample in zip(lines, samples):
        assert species_newick(*sample, run.stree.names) == line
    _, _, tau, _, sptrees, _ = read_mcmc_samples(
        run.cfg, run.stree, str(Path(ctl).with_name("out.mcmc.txt")))
    topo, clades, n = summarize_sptrees(sptrees, run.stree.names)
    want = format_a01_summary(topo, clades, n, run.stree.names)
    assert want + "\n" in report
    assert report.split("\n", 2)[2] == want + "\n"


def test_a10_lines_and_report_match_bpp_tpu(species_runs):
    from bpp_tpu.loader import load_run_from_ctl
    from bpp_tpu.output import McmcWriter, read_mcmc_samples
    from bpp_tpu.summary.delimit_summary import (
        format_a10_summary, summarize_delimitations,
    )
    ctl, lines, report = species_runs["A10"]
    run = load_run_from_ctl(ctl)
    ref = Path(ctl).with_name("ref.mcmc.txt")
    gen, theta, tau, lnl, _, _ = read_mcmc_samples(
        run.cfg, run.stree, str(Path(ctl).with_name("out.mcmc.txt")))
    w = McmcWriter(str(ref), run.cfg, run.stree)
    for k, g in enumerate(gen):
        w.write_sample(int(g), theta[k], tau[k], float(lnl[k]))
    w.close()
    assert ref.read_text().splitlines() == lines
    assert len(lines) == 101
    models, nsp = summarize_delimitations(tau, run.stree)
    want = format_a10_summary(models, nsp, len(gen), run.stree)
    assert report.split("\n", 2)[2] == want + "\n"


def _true_share(method, run, log_or_samples):
    """Per-sample indicator of the true topology ((A,B),C) (A01) or of
    three species (A10)."""
    if method == "A01":
        ns = run.stree.n_tips
        out = []
        for left, right, parent in log_or_samples:
            root = int(np.nonzero(np.asarray(parent) < 0)[0][0])
            kids = {int(left[root]), int(right[root])}
            out.append(2 in kids)          # C joins at the root
        return np.asarray(out, float)
    return (np.asarray(log_or_samples)[:, run.stree.n_tips:] > 0).all(1) \
        .astype(float)


@pytest.mark.parametrize("method", ["A01", "A10"])
def test_species_posterior_matches_bpp_tpu(species_runs, method):
    from bpp_tpu.loader import load_run_from_ctl as load_jax
    from bpp_tpu.mcmc.driver import Engine as EngineJ
    from bpp_tpu.output import read_mcmc_samples
    ctl, _, _ = species_runs[method]
    rj = load_jax(ctl)
    rj.cfg = rj.cfg.replace(dtype="float64", burnin=50, nsample=200,
                            checkpoint=None)
    log = EngineJ(rj, seed=5).run_mcmc(progress_every=0)
    _, _, tau_p, _, sptrees_p, _ = read_mcmc_samples(
        rj.cfg, rj.stree, str(Path(ctl).with_name("out.mcmc.txt")))
    if method == "A01":
        xj = _true_share(method, rj, log.sptrees)
        xp = _true_share(method, rj, sptrees_p)
    else:
        xj = _true_share(method, rj, np.stack(log.tau))
        xp = _true_share(method, rj, tau_p)
    if xj.mean() >= 0.9 and xp.mean() >= 0.9:
        return
    mj, sj = _means_and_se(xj)
    mp, sp = _means_and_se(xp)
    assert abs(mj - mp) < 4 * np.hypot(sj, sp), (mj, mp, sj, sp)


def test_a01_resume_is_byte_identical(species_runs):
    from bpp_tpu_torch import cli
    ctl, lines, _ = species_runs["A01"]
    job = Path(ctl).with_name("out")
    whole = Path(f"{job}.mcmc.txt").read_bytes()
    assert cli.main(["--resume", f"{job}.chk.npz", "--device", "cpu",
                     "--x64", "--quiet"]) == 0
    assert Path(f"{job}.mcmc.txt").read_bytes() == whole
    assert "(100 samples" in Path(f"{job}.txt").read_text()
