"""The A00 outputs beside mcmc.txt: the per-locus print files, the
conditional a1b1 log and the species-tree PDF, against ``bpp_tpu``.

* Both CLIs run the same control file with the chain replaced by the
  same states (``bpp_tpu``'s initial states at three seeds, handed to the
  port through ``convert.state_from_numpy``): they write the same set of
  files, and ``<job>.gtree.L<i>``, ``<job>.locus_<i>_params_sample.txt``
  (``print = ...``, ``printlocus``), mcmc.txt, FigTree.tre, the a1b1 log
  and the summary text are equal, for the strict clock with heredity and
  locus rates and for the IID relaxed clock with branch rates.
* The port's real CLI run on the same control file writes the same set of
  files.
* ``stree_export_pdf`` is byte-equal to ``bpp_tpu.visual``'s but for the
  time stamp and the command line.
"""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)     # tiny tensors; the suite runs in parallel

PRIORS = {
    "strict": ("print = 1 1 1 1 0", "printlocus = 2 1 3",
               "heredity = 1 4 4", "locusrate = 1 10 10 5 iid"),
    "relaxed": ("print = 1 1 0 1 1", "locusrate = 1 10 10 5 iid",
                "clock = 2 10 100 5 iid G"),
}
SEEDS = (3, 4, 5)


def _states_j(ctl):
    """``bpp_tpu``'s initial states at ``SEEDS`` on ``ctl`` (float64)."""
    from bpp_tpu.loader import load_run_from_ctl
    from bpp_tpu.mcmc.driver import Engine
    run = load_run_from_ctl(ctl)
    run.cfg = run.cfg.replace(dtype="float64")
    eng = Engine(run, seed=SEEDS[0])
    states = []
    for s in SEEDS:
        eng.seed = s
        states.append(eng.init_state())
    return states


def _to_port(sj, cfg):
    from bpp_tpu_torch.convert import state_from_numpy

    def fields(x):
        return None if x is None else {
            f: (None if v is None else np.asarray(v))
            for f, v in x._asdict().items()}

    arrays = {k: fields(getattr(sj, k)) for k in ("gt", "sp", "subst",
                                                  "clock")}
    st = state_from_numpy(arrays, cfg=cfg)
    return st._replace(logl=torch.as_tensor(np.array(sj.logl)),
                       logpr=torch.as_tensor(np.array(sj.logpr)))


def _run_both(tmp_path, monkeypatch, name):
    """Both CLIs on one control file, each chain replaced by the same
    states; returns (port dir, bpp_tpu dir, job)."""
    import bpp_tpu.cli as cli_j
    import bpp_tpu.mcmc.driver as drv_j
    import bpp_tpu_torch.mcmc.driver as drv
    from bpp_tpu_torch import cli
    from bpp_tpu_torch.testing import write_simulated_run
    ctl = write_simulated_run(tmp_path, n_loci=3, n_sites=80,
                              priors=PRIORS[name], burnin=2, nsample=3)
    states = _states_j(ctl)

    def run_j(self, progress_every=0, on_sample=None, **kw):
        log = drv_j.SampleLog()
        for g, st in enumerate(states, 1):
            tr = {k: np.asarray(v) for k, v in self._trace_of(st).items()}
            log.gen.append(g)
            log.theta.append(tr["theta"])
            log.tau.append(tr["tau"])
            log.lnL.append(float(tr["lnl"]))
            log.logpr.append(float(tr["logpr"]))
            on_sample(g, st)
        return log

    def run_p(self, progress_every=0, on_sample=None, **kw):
        log = drv.SampleLog()
        for g, sj in enumerate(states, 1):
            st = _to_port(sj, self.cfg)
            row = {k: v.numpy() for k, v in self._trace_of(st).items()}
            row.update((k, v.numpy())
                       for k, v in self._sample_record(st).items())
            log.gen.append(g)
            log.theta.append(row["theta"])
            log.tau.append(row["tau"])
            log.lnL.append(float(row["lnl"]))
            log.logpr.append(float(row["logpr"]))
            on_sample(g, row)
        return log

    dirs = []
    for tag, mod, fake, argv in (
            ("port", drv.Engine, run_p, ["--device", "cpu", "--x64"]),
            ("jax", drv_j.Engine, run_j, ["--x64"])):
        d = tmp_path / tag
        d.mkdir()
        text = open(ctl).read().replace(f"jobname = {tmp_path}/",
                                        f"jobname = {d}/")
        (d / "run.ctl").write_text(text)
        monkeypatch.setattr(mod, "run_mcmc", fake)
        main = cli.main if tag == "port" else cli_j.main
        assert main(["--cfile", str(d / "run.ctl"), "--quiet"] + argv) == 0
        dirs.append(d)
    return dirs[0], dirs[1], ctl


def _outputs(d):
    return sorted(f for f in os.listdir(d) if f != "run.ctl")


@pytest.mark.parametrize("name", list(PRIORS))
def test_outputs_equal_bpp_tpus_on_the_same_states(tmp_path, monkeypatch,
                                                   name):
    port, jax_dir, _ = _run_both(tmp_path, monkeypatch, name)
    files = _outputs(port)
    assert files == _outputs(jax_dir)
    want = {"out.mcmc.txt", "out.txt", "out.FigTree.tre", "out.pdf",
            "out.conditional_a1b1.txt"}
    if name == "strict":
        want |= {"out.gtree.L1", "out.gtree.L3",
                 "out.locus_1_params_sample.txt",
                 "out.locus_3_params_sample.txt"}
    else:
        want |= {f"out.{k}" for i in (1, 2, 3)
                 for k in (f"gtree.L{i}", f"locus_{i}_params_sample.txt")}
    assert set(files) == want
    for f in files:
        a = (port / f).read_bytes()
        b = (jax_dir / f).read_bytes()
        if f.endswith(".pdf"):
            assert a.startswith(b"%PDF-1.4") and b"bpp_tpu_torch --cfile" in a
            continue
        if f == "out.txt":
            # the first line names the package, the a1b1 section the job
            a, b = (x.split(b"\n", 1)[1].replace(str(d).encode(), b"DIR")
                    for x, d in ((a, port), (b, jax_dir)))
            assert b"Summarizing parameter estimates using file" in a
        assert a == b, f
    rows = (port / "out.gtree.L1").read_text().splitlines()
    assert len(rows) == len(SEEDS) and rows[0].endswith(";")
    params = (port / "out.locus_1_params_sample.txt").read_text().split("\n")
    # strict: heredity and mu; relaxed: mu, nu and the 7 branch rates
    assert len(params[0].split("\t")) == (2 if name == "strict" else 9)


def test_real_run_writes_the_same_files(tmp_path):
    """The port's chain on the strict control file: the files of the
    replayed run above."""
    from bpp_tpu_torch import cli
    from bpp_tpu_torch.testing import write_simulated_run
    ctl = write_simulated_run(tmp_path, n_loci=3, n_sites=80,
                              priors=PRIORS["strict"], burnin=2, nsample=3)
    assert cli.main(["--cfile", ctl, "--device", "cpu", "--quiet"]) == 0
    files = {f for f in os.listdir(tmp_path) if f.startswith("out.")}
    assert files == {"out.ctl", "out.mcmc.txt", "out.txt", "out.FigTree.tre",
                     "out.pdf", "out.conditional_a1b1.txt", "out.gtree.L1",
                     "out.gtree.L3", "out.locus_1_params_sample.txt",
                     "out.locus_3_params_sample.txt"}
    for f in ("out.gtree.L1", "out.locus_3_params_sample.txt",
              "out.conditional_a1b1.txt"):
        assert len((tmp_path / f).read_text().splitlines()) == 3 + (
            f.startswith("out.cond"))


def test_pdf_equals_bpp_tpus_but_stamp_and_command(monkeypatch, tmp_path):
    import bpp_tpu.visual as vj
    import bpp_tpu_torch.visual as vp
    from bpp_tpu.trees.stree import SpeciesTree as SJ
    from bpp_tpu_torch.trees.stree import SpeciesTree
    newick = "(((A, B), C), (D, E));"
    rng = np.random.default_rng(2)
    tau = np.r_[np.zeros(5), np.sort(rng.uniform(0.001, 0.02, 4))[::-1]]
    theta = rng.uniform(0.001, 0.01, 9)
    for mod in (vj, vp):
        monkeypatch.setattr(mod._time, "strftime", lambda fmt: "STAMP")
    pj = vj.stree_export_pdf(SJ.from_newick(newick), str(tmp_path / "j.pdf"),
                             tau=tau, theta=theta, cmdline="CMD")
    pp = vp.stree_export_pdf(SpeciesTree.from_newick(newick),
                             str(tmp_path / "p.pdf"), tau=tau, theta=theta,
                             cmdline="CMD")
    a, b = open(pp, "rb").read(), open(pj, "rb").read()
    assert a == b and a.startswith(b"%PDF-1.4") and a.endswith(b"%%EOF\n")
