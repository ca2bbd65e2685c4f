"""Prior recovery of the port's MSC-I chain under ``usedata = 0``.

The network of ``tests/fixtures/msci/m.ctl``, one sequence a species and
an inverse-gamma theta prior (whose theta refresh in the mixing move is
an exact Gibbs draw; under the fixture's gamma prior the chain needs far
longer to mix, in ``bpp_tpu`` as here).  500 iterations after 100 of
burn-in: phi's mean and sd those of Beta(1, 1), and tau_R and tau_H
within 4 standard errors (the chain's sd over the square root of its own
ESS) of the exact rejection-sampled targets of ``tests/test_msci.py``:
tau_R 0.0200, tau_H 0.0050.
"""

import os

import numpy as np
import torch

from bpp_tpu_torch.testing import ess

torch.set_num_threads(1)     # tiny tensors; the suite runs in parallel

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def test_prior_recovery(tmp_path):
    from bpp_tpu_torch.io.ctl import parse_ctl_lines
    from bpp_tpu_torch.loader import load_run
    from bpp_tpu_torch.mcmc.driver import Engine
    (tmp_path / "d.txt").write_text(
        "3 20\nA^a0 " + "A" * 20 + "\nB^b0 " + "C" * 20 + "\nC^c0 "
        + "G" * 20 + "\n")
    (tmp_path / "d.imap").write_text("a0 A\nb0 B\nc0 C\n")
    text = open(os.path.join(FIX, "msci", "m.ctl")).read()
    for a, b in (("2 2 2", "1 1 1"),
                 ("thetaprior = gamma 2 200", "thetaprior = invgamma 3 0.01"),
                 ("seqfile = d.txt", f"seqfile = {tmp_path}/d.txt"),
                 ("Imapfile = d.imap", f"Imapfile = {tmp_path}/d.imap")):
        assert a in text
        text = text.replace(a, b)
    cfg = parse_ctl_lines(text.splitlines()).replace(
        dtype="float64", burnin=100, nsample=500, sampfreq=1)
    eng = Engine(load_run(cfg), seed=2, device="cpu")
    log = eng.run_mcmc(progress_every=0)
    _, _, tau, _, _ = log.arrays()
    phi = np.stack(log.phi)
    st = eng.run.stree
    hin = [i for i in range(st.n_nodes) if st.hindex[i] >= 0][0]
    # the mirror's phi is 1 - the hinner's, its tau the hinner's
    mir = int(st.hybrid[hin])
    np.testing.assert_allclose(phi[:, hin] + phi[:, mir], 1.0)
    np.testing.assert_array_equal(tau[:, hin], tau[:, mir])
    ph = phi[:, hin]
    se = ph.std() / np.sqrt(ess(ph))
    assert abs(ph.mean() - 0.5) < 4 * se, (ph.mean(), se)
    assert abs(ph.std() - 0.2887) < 0.06, ph.std()
    for node, target in ((st.root, 0.0200), (hin, 0.0050)):
        x = tau[:, node]
        se = x.std() / np.sqrt(ess(x))
        assert abs(x.mean() - target) < 4 * se, (node, x.mean(), se)
