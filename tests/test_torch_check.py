"""The port's runtime check (``check = N`` / ``--check N``) and
``usedata = 2``.

* The checks of ``tests/test_check.py`` on the port: a consistent chain
  passes every check (counted from the start of burn-in); a corrupted
  logl, logpr or integrated-theta cache is caught; the keyword and the
  flag parse.
* ``usedata = 2`` freezes the gene trees and taus at their start, so
  theta_h's posterior is exactly InvGamma(a + K_h, b + C_h) over the
  frozen trees: a chain's theta means and variances within 5 Monte Carlo
  standard errors (batch means) of it, on simulated data.
"""

import numpy as np
import pytest
import torch

from bpp_tpu_torch.config import Prior, PriorDist

torch.set_num_threads(1)     # tiny tensors; the suite runs in parallel


def _engine(data_seed=2, **cfg):
    from bpp_tpu_torch.mcmc.driver import Engine
    from bpp_tpu_torch.testing import synthetic_run
    run = synthetic_run(n_loci=4, n_seq=6, n_patterns=16, n_species=3,
                        seed=data_seed, dtype="float64")
    run.cfg = run.cfg.replace(**cfg)
    return Engine(run, seed=1, device="cpu")


def test_check_passes_on_consistent_chain(capsys):
    eng = _engine(check_every=5)
    eng.cfg = eng.cfg.replace(burnin=4, nsample=3, sampfreq=2)
    log = eng.run_mcmc(progress_every=0)        # raises on drift
    assert len(log.gen) == 3
    # from it = -4: checks at 1 and 6
    err = capsys.readouterr().err
    assert err.count("caches consistent") == 2, err


def test_check_catches_corrupted_logl():
    eng = _engine()
    state = eng.init_state()
    assert eng.validate_state(state)
    with pytest.raises(RuntimeError,
                       match="iteration 7: cached logl drifted"):
        eng.validate_state(state._replace(logl=state.logl + 10.0), it=7)
    with pytest.raises(RuntimeError, match="logpr"):
        eng.validate_state(state._replace(logpr=state.logpr - 3.0))
    nan = state.logl.clone()
    nan[0] = float("nan")
    with pytest.raises(RuntimeError, match="logl drifted"):
        eng.validate_state(state._replace(logl=nan))


def test_check_catches_corrupted_notheta_caches():
    eng = _engine(data_seed=3, theta_integrated=True,
                  thetaprior=Prior(PriorDist.INVGAMMA, 3.0, 0.02))
    state = eng.init_state()
    assert eng.validate_state(state)
    with pytest.raises(RuntimeError, match="K cache"):
        eng.validate_state(state._replace(coal=state.coal + 1))
    with pytest.raises(RuntimeError, match="C cache"):
        eng.validate_state(state._replace(t2h=state.t2h + 5.0))


def test_check_keyword_and_flag_parse(tmp_path):
    from bpp_tpu_torch.cli import build_argparser
    from bpp_tpu_torch.io.ctl import parse_ctl_lines
    cfg = parse_ctl_lines([
        "seed = 1", "seqfile = x.phy", "jobname = out",
        "species&tree = 1 A", "          8", "usedata = 1", "nloci = 1",
        "thetaprior = 3 0.03", "check = 50 0.25",
    ])
    assert (cfg.check_every, cfg.check_tol) == (50, 0.25)
    args = build_argparser().parse_args(["--cfile", "x.ctl", "--check",
                                         "7"])
    assert args.check == 7


def test_cli_check_flag_runs_the_checks(tmp_path, capsys):
    from bpp_tpu_torch import cli
    from bpp_tpu_torch.testing import write_simulated_run
    ctl = write_simulated_run(tmp_path, n_loci=3, n_sites=60, burnin=4,
                              nsample=6)
    assert cli.main(["--cfile", ctl, "--device", "cpu", "--x64",
                     "--check", "5"]) == 0
    err = capsys.readouterr().err
    assert err.count("caches consistent") == 2, err     # it = 1, 6


def test_usedata2_theta_matches_conjugate_posterior(tmp_path):
    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.mcmc.driver import Engine
    from bpp_tpu_torch.testing import write_simulated_run
    ctl = write_simulated_run(tmp_path, n_loci=6, n_sites=50, usedata=2,
                              thetaprior="invgamma 3 0.02", burnin=20,
                              nsample=2000)
    run = load_run_from_ctl(ctl)
    run.cfg = run.cfg.replace(dtype="float64")
    eng = Engine(run, seed=5, device="cpu")
    state0 = eng.init_state()
    log = eng.run_mcmc(progress_every=0)
    theta = np.stack(log.theta)                       # [n, H]
    # the frozen trees' exact conditional, one per population
    a1, b1 = (x.numpy() for x in eng.a1b1_stats(state0))
    mean = b1 / (a1 - 1.0)
    var = b1 ** 2 / ((a1 - 1.0) ** 2 * (a1 - 2.0))
    n_batches = 20
    for stat, want in ((theta, mean), ((theta - mean) ** 2, var)):
        bm = stat.reshape(n_batches, -1, stat.shape[1]).mean(1)
        se = bm.std(0, ddof=1) / np.sqrt(n_batches)
        z = (bm.mean(0) - want) / se
        assert np.all(np.abs(z) < 5), (z, bm.mean(0), want)
    # the gene trees and taus did not move
    assert np.ptp(np.stack(log.tau), axis=0).max() == 0
