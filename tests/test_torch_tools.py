"""The CLI tools of the PyTorch port against ``bpp_tpu``'s.

* ``--bfdriver CTL --points K``: the K control files and
  ``CTL.betaweights.csv`` byte-equal to ``bpp_tpu``'s for K = 2, 8, 16;
  an odd K refused as ``bpp_tpu`` refuses it; ``estimate_logml`` equal.
* ``--summary CTL``: ``<jobname>.txt`` equal to ``bpp_tpu``'s after its
  first line (the program's name), on the same mcmc.txt, for A00, A01,
  A10 and A11.
* The power-posterior likelihood: ``logl_fn`` under ``BayesFactorBeta =
  0.3`` equal to ``bpp_tpu``'s (float64, rtol 1e-10), and 0.3 times the
  unscaled one.
* ``--multihost`` refuses what ``bpp_tpu`` refuses: a malformed spec
  (its ValueError) and ``--resume`` (its message, exit 1, on a one-rank
  gloo group).
"""

import io

import numpy as np
import pytest
import torch

torch.set_num_threads(1)     # tiny tensors; the suite runs in parallel

METHODS = {
    "A00": (),
    "A01": ("speciestree = 1 0.5 0.33 0.1 0.2",),
    "A10": ("speciesdelimitation = 1 0 2",),
    "A11": ("speciestree = 1 0.5 0.33 0.1 0.2",
            "speciesdelimitation = 1 0 2"),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from bpp_tpu_torch import cli
    from bpp_tpu_torch.testing import write_simulated_run
    d = tmp_path_factory.mktemp("tools")
    ctls = {}
    for name, lines in METHODS.items():
        ctls[name] = write_simulated_run(d, 3, n_sites=60, job=name,
                                         burnin=2, nsample=10, priors=lines)
        assert cli.main(["--cfile", ctls[name], "--device", "cpu",
                         "--quiet"]) == 0
    return d, ctls


@pytest.mark.parametrize("points", [2, 8, 16])
def test_bfdriver_files_equal(tmp_path, points, capsys):
    from bpp_tpu.tools.bfdriver import cmd_bfdriver as bf_j
    from bpp_tpu_torch import cli
    from bpp_tpu_torch.tools.bfdriver import beta_weights, estimate_logml
    ctl = tmp_path / "run.ctl"
    ctl.write_text("seed = 1\nseqfile = x.phy\nnloci = 3\n")
    names = [f"run.ctl.{i + 1}" for i in range(points)]
    names.append("run.ctl.betaweights.csv")
    bf_j(str(ctl), points, out=io.StringIO())
    want = {n: (tmp_path / n).read_bytes() for n in names}
    for n in names:
        (tmp_path / n).unlink()
    assert cli.main(["--bfdriver", str(ctl), "--points",
                     str(points)]) == 0
    assert "quadrature" in capsys.readouterr().out
    for n in names:
        assert (tmp_path / n).read_bytes() == want[n], n
    assert not (tmp_path / f"run.ctl.{points + 1}").exists()
    betas = [b for b, _ in beta_weights(points)]
    assert betas == sorted(betas) and 0 < betas[0] and betas[-1] < 1
    # the quadrature of a filled-in table, as bpp_tpu's
    from bpp_tpu.tools.bfdriver import estimate_logml as est_j
    csv = tmp_path / "filled.csv"
    rows = ["beta,weight,ElnfX"] + [f"{b:.6f},{w:.6f},{-100.0 * (1 + b):f}"
                                    for b, w in beta_weights(points)]
    csv.write_text("\n".join(rows) + "\n")
    assert estimate_logml(str(csv)) == est_j(str(csv))


def test_bfdriver_refuses_an_odd_count(tmp_path):
    from bpp_tpu.tools.bfdriver import cmd_bfdriver as bf_j
    from bpp_tpu_torch import cli
    ctl = tmp_path / "run.ctl"
    ctl.write_text("seed = 1\n")
    with pytest.raises(ValueError) as ej:
        bf_j(str(ctl), 5, out=io.StringIO())
    with pytest.raises(ValueError) as ep:
        cli.main(["--bfdriver", str(ctl), "--points", "5"])
    assert str(ep.value) == str(ej.value)
    assert not list(tmp_path.glob("run.ctl.*"))


@pytest.mark.parametrize("name", list(METHODS))
def test_summary_equal_to_bpp_tpus(runs, name):
    from bpp_tpu.cli import main as main_j
    from bpp_tpu_torch import cli
    d, ctls = runs
    out = d / f"{name}.txt"
    out.unlink()
    assert cli.main(["--summary", ctls[name], "--quiet"]) == 0
    got = out.read_text().splitlines()
    assert got[0].startswith("bpp_tpu_torch ")
    assert "(10 samples)" in got[0]
    assert main_j(["--summary", ctls[name], "--quiet"]) == 0
    want = out.read_text().splitlines()
    assert got[1:] == want[1:]
    assert len(got) > 5


def test_summary_without_a_sample_file(runs, tmp_path, capsys):
    from bpp_tpu_torch import cli
    d, ctls = runs
    text = open(ctls["A00"]).read().replace(str(d / "A00"),
                                            str(tmp_path / "none"))
    ctl = tmp_path / "none.ctl"
    ctl.write_text(text)
    assert cli.main(["--summary", str(ctl), "--quiet"]) == 1
    assert "no mcmc file" in capsys.readouterr().err


def test_bfbeta_scales_logl_as_bpp_tpu(runs):
    from bpp_tpu.loader import load_run_from_ctl as load_j
    from bpp_tpu.mcmc.driver import Engine as EJ
    from bpp_tpu_torch.loader import load_run_from_ctl as load_p
    from bpp_tpu_torch.mcmc.driver import Engine as EP
    ctl = runs[1]["A00"]
    vals = {}
    for beta in (1.0, 0.3):
        rj, rp = load_j(ctl), load_p(ctl)
        rj.cfg = rj.cfg.replace(dtype="float64", bfbeta=beta)
        rp.cfg = rp.cfg.replace(dtype="float64", bfbeta=beta)
        sj = EJ(rj, seed=4).init_state()
        eng = EP(rp, seed=4, device="cpu")
        sp = eng.init_state()
        np.testing.assert_allclose(sp.logl.numpy(), np.asarray(sj.logl),
                                   rtol=1e-10)
        again = eng._logl_fn(sp.gt, sp.subst, sp.sp, sp.clock)
        np.testing.assert_allclose(again.numpy(), sp.logl.numpy(),
                                   rtol=1e-12)
        vals[beta] = sp.logl.numpy()
    np.testing.assert_allclose(vals[0.3], 0.3 * vals[1.0], rtol=1e-12)
    assert (vals[1.0] < 0).all()


def test_multihost_refused(capsys):
    import socket

    from bpp_tpu_torch import cli
    with pytest.raises(ValueError, match="--multihost expects"):
        cli.main(["--multihost", "127.0.0.1:1,2", "--cfile", "x.ctl",
                  "--device", "cpu"])
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    assert cli.main(["--multihost", f"127.0.0.1:{port},1,0", "--resume",
                     "x.chk.npz", "--device", "cpu", "--quiet"]) == 1
    assert "--multihost cannot resume yet" in capsys.readouterr().err
