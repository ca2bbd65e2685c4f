"""Prior recovery of the port's chain on a bidirectional introgression.

The BDI network of ``tests/fixtures/bdi``,
``(((A,Y[&phi=0.3])X,(B,X[&phi=0.2])Y)S, C)R``, under ``usedata = 0``,
one sequence a species and an inverse-gamma theta prior (an exact Gibbs
theta refresh, as in ``test_torch_msci_prior.py``).  X, Y and both
mirrors share one tau, so the free taus are R, S and that one, and
given tau_R the other two are uniform on ``0 < tau_X < tau_S < tau_R``:
E tau_S = 2/3 E tau_R and E tau_X = 1/3 E tau_R, with tau_R ~
Gamma(4, 100) (mean 0.04).  400 iterations after 100 of burn-in:

* the four taus of the pair equal in every sample, and each phi plus its
  mirror's 1;
* tau_R, tau_S and tau_X within 4 standard errors (the chain's sd over
  the square root of its own ESS) of 0.04, 0.02667 and 0.01333;
* each pair's phi with the mean (same band) and sd (0.2887 +- 0.06) of
  Beta(1, 1).
"""


import numpy as np
import torch

from bpp_tpu_torch.testing import ess

torch.set_num_threads(1)     # tiny tensors; the suite runs in parallel

NWK = "(((A,Y[&phi=0.300000])X,(B,X[&phi=0.200000])Y)S, C)R;"
CTL = """seed = 7
seqfile = {d}/d.txt
Imapfile = {d}/d.imap
jobname = {d}/out
species&tree = 3 A B C
               1 1 1
               {nwk}
usedata = 0
nloci = 1
cleandata = 0
model = JC69
thetaprior = invgamma 3 0.004
tauprior = gamma 4 100
phiprior = 1 1
finetune = 1
burnin = 100
sampfreq = 1
nsample = 400
"""


def test_bdi_prior_recovery(tmp_path):
    from bpp_tpu_torch.io.ctl import parse_ctl_lines
    from bpp_tpu_torch.loader import load_run
    from bpp_tpu_torch.mcmc.driver import Engine
    (tmp_path / "d.txt").write_text(
        "3 20\nA^a0 " + "A" * 20 + "\nB^b0 " + "C" * 20 + "\nC^c0 "
        + "G" * 20 + "\n")
    (tmp_path / "d.imap").write_text("a0 A\nb0 B\nc0 C\n")
    cfg = parse_ctl_lines(CTL.format(d=tmp_path, nwk=NWK).splitlines()) \
        .replace(dtype="float64")
    eng = Engine(load_run(cfg), seed=5, device="cpu")
    log = eng.run_mcmc(progress_every=0)
    _, _, tau, _, _ = log.arrays()
    phi = np.stack(log.phi)
    st = eng.run.stree
    x, y, s = (st.labels.index(n) for n in "XYS")
    pair = [x, y, int(st.hybrid[x]), int(st.hybrid[y])]
    for i in pair[1:]:
        np.testing.assert_array_equal(tau[:, i], tau[:, x])
    for h in (x, y):
        np.testing.assert_allclose(phi[:, h] + phi[:, st.hybrid[h]], 1.0)
    assert (tau[:, x] < tau[:, s]).all()
    assert (tau[:, s] < tau[:, st.root]).all()

    def near(v, target, what):
        se = v.std() / np.sqrt(ess(v))
        assert abs(v.mean() - target) < 4 * se, (what, v.mean(), se)

    for node, target, what in ((st.root, 0.04, "tau_R"),
                               (s, 0.04 * 2 / 3, "tau_S"),
                               (x, 0.04 / 3, "tau_X")):
        near(tau[:, node], target, what)
    for h, what in ((x, "phi_X"), (y, "phi_Y")):
        near(phi[:, h], 0.5, what)
        assert abs(phi[:, h].std() - 0.2887) < 0.06, (what, phi[:, h].std())
