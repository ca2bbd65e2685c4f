"""The conditional (a1, b1) log and its Rao-Blackwellized summary in the
port, against ``bpp_tpu``.

* ``A1b1Writer``'s file and summary text equal ``bpp_tpu``'s on the same
  rows, under the inverse-gamma and the gamma conditional.
* ``Engine.a1b1_stats`` equals ``bpp_tpu``'s on the same state (carried by
  ``convert.state_from_numpy``, heredity scalars not 1) at rtol 1e-10,
  under an inverse-gamma and a gamma theta prior.
* A CLI A00 run writes ``<job>.conditional_a1b1.txt`` with ``bpp_tpu``'s
  header (the theta columns of mcmc.txt) and one row a sample, and the
  Rao-Blackwellized section of ``<job>.txt``; no log is written with
  integrated thetas, under A01, or by a resumed run.
"""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)     # tiny tensors; the suite runs in parallel


@pytest.mark.parametrize("dist", ["invgamma", "gamma"])
def test_writer_bytes_and_summary_equal_bpp_tpus(tmp_path, dist):
    from bpp_tpu.summary import a1b1 as aj
    from bpp_tpu_torch.summary import a1b1 as ap
    rng = np.random.default_rng(4)
    names = ["theta:1:A", "theta:5:A,B", "theta:6:C,D"]
    a = rng.uniform(4, 30, size=(60, 3))
    b = (rng.uniform(40, 60, size=(60, 3)) if dist == "gamma"
         else rng.uniform(0.01, 0.2, size=(60, 3)))
    out = []
    for mod, tag in ((ap, "p"), (aj, "j")):
        d = mod.DIST_GAMMA if dist == "gamma" else mod.DIST_INVGAMMA
        w = mod.A1b1Writer(str(tmp_path / f"{tag}.txt"),
                           [(n, d) for n in names])
        for g in range(len(a)):
            w.write_sample(g + 1, a[g], b[g])
        w.close()
        out.append(((tmp_path / f"{tag}.txt").read_bytes(), w.summary()))
    assert out[0] == out[1]
    assert len(out[0][1].splitlines()) == 2 + len(names)


def _runs(prior):
    from bpp_tpu.config import Prior as PJ
    from bpp_tpu.config import PriorDist as DJ
    from bpp_tpu.testing import synthetic_run as synj
    from bpp_tpu_torch.config import Prior, PriorDist
    from bpp_tpu_torch.testing import synthetic_run
    runs = []
    for syn, P, D in ((synthetic_run, Prior, PriorDist),
                      (synj, PJ, DJ)):
        run = syn(n_loci=5, n_seq=6, n_patterns=12, n_species=3, seed=8,
                  pad_loci_to=6, dtype="float64")
        if prior == "invgamma":
            run.cfg = run.cfg.replace(thetaprior=P(D.INVGAMMA, 3.0, 0.004))
        runs.append(run)
    return runs


@pytest.mark.parametrize("prior", ["invgamma", "gamma"])
def test_a1b1_stats_equal_bpp_tpus(prior):
    import jax.numpy as jnp
    from bpp_tpu.mcmc.driver import Engine as EngineJ
    from bpp_tpu_torch.convert import state_from_numpy
    from bpp_tpu_torch.mcmc.driver import Engine
    rp, rj = _runs(prior)
    ej = EngineJ(rj, seed=3)
    sj = ej.init_state()
    h = np.random.default_rng(1).uniform(0.5, 2.0, sj.subst.heredity.shape)
    sj = sj._replace(subst=sj.subst._replace(heredity=jnp.asarray(h)))
    arrays = {k: {f: (None if v is None else np.asarray(v))
                  for f, v in getattr(sj, k)._asdict().items()}
              for k in ("gt", "sp", "subst")}
    eng = Engine(rp, seed=3, device="cpu")
    st = state_from_numpy(arrays, cfg=rp.cfg)
    got = eng.a1b1_stats(st)
    want = ej.a1b1_stats(sj)
    assert want[2] is None
    for g, w in zip(got, want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10)
    # padding loci are left out: a1 counts the real loci's coalescences
    if prior == "invgamma":
        assert float(got[0].sum()) == pytest.approx(
            3.0 * len(got[0]) + sum(int(n) - 1 for n in rp.batch.n_seq[:5]))


def _header_j(ctl):
    """``bpp_tpu``'s a1b1 header for the control file ``ctl``."""
    from bpp_tpu.io.ctl import parse_ctl
    from bpp_tpu.loader import load_run
    from bpp_tpu.output import McmcWriter
    from bpp_tpu.summary.a1b1 import DIST_INVGAMMA, A1b1Writer
    cfg = parse_ctl(ctl)
    run = load_run(cfg)
    d = os.path.dirname(ctl)
    w = McmcWriter(os.path.join(d, "j.mcmc.txt"), cfg, run.stree)
    w.close()
    a = A1b1Writer(os.path.join(d, "j.a1b1.txt"),
                   [(c, DIST_INVGAMMA) for c in w.columns
                    if c.startswith("theta")])
    a.close()
    with open(os.path.join(d, "j.a1b1.txt")) as fh:
        return fh.readline()


def test_cli_writes_the_log_and_summary(tmp_path):
    from bpp_tpu_torch import cli
    from bpp_tpu_torch.testing import write_simulated_run
    ctl = write_simulated_run(tmp_path, n_loci=3, n_sites=60, burnin=2,
                              nsample=5)
    assert cli.main(["--cfile", ctl, "--device", "cpu", "--quiet"]) == 0
    job = tmp_path / "out"
    with open(f"{job}.conditional_a1b1.txt") as fh:
        lines = fh.readlines()
    assert lines[0] == _header_j(ctl)
    assert [ln.split("\t")[0] for ln in lines[1:]] == [
        str(g) for g in range(1, 6)]
    text = (tmp_path / "out.txt").read_text()
    head = (f"Summarizing parameter estimates using file "
            f"{job}.conditional_a1b1.txt ...")
    assert head in text
    # one row a population, its mean that of the logged conditionals
    # (which the log rounds)
    section = text.split(head)[1].splitlines()
    names = [n[:-3] for n in lines[0].rstrip("\n").split("\t")[1::2]]
    assert len(names) == 7
    v = np.asarray([[float(x) for x in ln.split("\t")[1:]]
                    for ln in lines[1:]])
    for j, n in enumerate(names):
        row = next(r for r in section if r.startswith(n + " "))
        want = np.mean(v[:, 2 * j + 1] / (v[:, 2 * j] - 1.0))
        assert float(row.split()[1]) == pytest.approx(want, rel=2e-3)


@pytest.mark.parametrize("case", ["integrated", "A01", "resume"])
def test_no_log_without_estimated_thetas_or_on_resume(tmp_path, case):
    from bpp_tpu_torch import cli
    from bpp_tpu_torch.testing import write_simulated_run
    kw = dict(burnin=2, nsample=4)
    if case == "integrated":
        kw["thetaprior"] = "invgamma 3 0.03 int"
    elif case == "A01":
        kw["priors"] = ("speciestree = 1 0.5 0.33 0.1 0.2",)
    else:
        kw["priors"] = ("checkpoint = 2 0",)
    ctl = write_simulated_run(tmp_path, n_loci=3, n_sites=60, **kw)
    log = tmp_path / "out.conditional_a1b1.txt"
    assert cli.main(["--cfile", ctl, "--device", "cpu", "--quiet"]) == 0
    if case == "resume":
        assert log.exists()
        log.unlink()
        assert cli.main(["--resume", str(tmp_path / "out.chk.npz"),
                         "--device", "cpu", "--quiet"]) == 0
    assert not log.exists()
    assert "Summarizing parameter estimates" not in (
        tmp_path / "out.txt").read_text()
