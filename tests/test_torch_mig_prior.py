"""Prior recovery of the port's MSC-M chain under ``usedata = 0``.

Two species with routes A -> B and B -> A (Gamma(2, 0.1) rate priors,
mean 20), one sequence a species at 20 loci, an inverse-gamma theta
prior InvGamma(3, 0.01) and tau prior InvGamma(3, 0.02).  300 iterations
after 100 of burn-in: the mean of log M of each route within 4 standard
errors (the chain's sd over the square root of its own ESS) of its prior
value psi(2) - log 0.1, those of log theta_A, log theta_B and log tau_R
of psi(3) less log 0.01, log 0.01 and log 0.02 (the log makes these
skewed marginals' short-chain means nearly symmetric about their
targets); the rates' spread that of their prior (sd 14.1); and the
sim-SPR move has made migration events.
"""

from scipy.special import digamma

import numpy as np
import torch

from bpp_tpu_torch.testing import ess

torch.set_num_threads(1)     # tiny tensors; the suite runs in parallel

CTL = """\
seed = 3
seqfile = {d}/d.txt
Imapfile = {d}/d.imap
jobname = {d}/out
species&tree = 2 A B
                 1 1
                (A, B);
usedata = 0
nloci = 20
thetaprior = invgamma 3 0.01
tauprior = invgamma 3 0.02
migration = 2
A B 2 0.1
B A 2 0.1
finetune = 1
burnin = 100
sampfreq = 1
nsample = 400
"""


def test_prior_recovery(tmp_path):
    from bpp_tpu_torch.io.ctl import parse_ctl_lines
    from bpp_tpu_torch.loader import load_run
    from bpp_tpu_torch.mcmc.driver import Engine
    (tmp_path / "d.txt").write_text("".join(
        "2 20\nA^a0 " + "ACGT" * 5 + "\nB^b0 " + "ACGA" * 5 + "\n\n"
        for _ in range(20)))
    (tmp_path / "d.imap").write_text("a0 A\nb0 B\n")
    cfg = parse_ctl_lines(CTL.format(d=tmp_path).splitlines()).replace(
        dtype="float64")
    eng = Engine(load_run(cfg), seed=3, device="cpu")
    state = eng.init_state()
    for _ in range(4):          # burn-in, retuning the steps every 25
        state, stats = eng.chunk_step(state, 25)
        state = eng._reset_finetune(state, stats.numpy().astype(float))
    rows, events = [], []
    for _ in range(6):
        state, _, trace, _ = eng._chunk(state, 50)
        rows.append(trace)
        events.append(int(state.mig.count().sum()))
    theta, tau, M = (torch.cat([r[k] for r in rows]).numpy()
                     for k in ("theta", "tau", "migM"))
    st = eng.run.stree
    assert max(events) > 0, events

    def near(x, target, what):
        x = np.log(x)
        se = x.std() / np.sqrt(ess(x))
        assert abs(x.mean() - target) < 4 * se, (what, x.mean(), target, se)

    for k in range(2):
        near(M[:, k], digamma(2.0) - np.log(0.1), f"M{k}")
        assert 8.0 < M[:, k].std() < 22.0, (k, M[:, k].std())
    near(theta[:, 0], np.log(0.01) - digamma(3.0), "theta A")
    near(theta[:, 1], np.log(0.01) - digamma(3.0), "theta B")
    near(tau[:, st.root], np.log(0.02) - digamma(3.0), "tau R")
