"""Bidirectional introgression (BDI) in the PyTorch port against
``bpp_tpu``.

* ``lswitch_bdi`` and ``lswitch_samples`` (the label-switching
  correction) give ``bpp_tpu``'s towers and relabelled samples on
  ``tests/test_bdi.py::test_lswitch``'s synthetic towers.
* The partner-rate tie under clock = 2: a garbage rate on a BDI mirror
  leaves lnL unchanged and a changed partner rate changes it
  (``tests/test_bdi.py:138-170``), and a short chain keeps its caches.
* Both CLIs on the BDI fixture, with the chain replaced by the same
  samples, write the same mcmc.txt, ``mcmc.txt.processed`` and summary,
  and no FigTree.tre or a1b1 log.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)     # tiny tensors; the suite runs in parallel

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "bdi")
NWK = "(((A,Y[&phi=0.300000])X,(B,X[&phi=0.200000])Y)S, C)R;"
CTL = f"""seed = 7
seqfile = {FIX}/bdi_seqs.txt
Imapfile = {FIX}/bdi_imap.txt
jobname = {{job}}
species&tree = 3 A B C
               4 4 2
               {NWK}
usedata = 1
nloci = {{nloci}}
cleandata = 0
model = JC69
thetaprior = gamma 2 1000
tauprior = gamma 4 100
phiprior = 1 1
finetune = 1
burnin = 4
sampfreq = 1
nsample = {{nsample}}
{{extra}}"""


def _towers(n=800, seed=0):
    """test_lswitch's towers: 40% of the samples tower-switched."""
    rng = np.random.default_rng(seed)
    phi_x = rng.beta(20, 60, n)
    phi_y = rng.beta(10, 40, n)
    th_x = rng.gamma(40.0, 1 / 10000.0, n)
    th_y = rng.gamma(80.0, 1 / 10000.0, n)
    flip = rng.random(n) < 0.4
    return (np.where(flip, 1 - phi_x, phi_x), np.where(flip, 1 - phi_y, phi_y),
            np.where(flip, th_y, th_x), np.where(flip, th_x, th_y))


@pytest.mark.parametrize("est_theta", [True, False])
def test_lswitch_bdi_equal(est_theta):
    from bpp_tpu.summary.lswitch import lswitch_bdi as lj
    from bpp_tpu_torch.summary.lswitch import lswitch_bdi
    px, py, tx, ty = _towers()
    if not est_theta:
        tx = ty = None
    got = lswitch_bdi(px, py, tx, ty)
    want = lj(px, py, tx, ty)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g, w)
    assert (got[1] < 0.5).mean() > 0.97


def _samples(st, n=60, seed=1):
    """(theta, tau, phi) [n, H] matrices on the BDI network: towers on the
    pair's mirrors and thetas, the other nodes drawn around their
    values."""
    rng = np.random.default_rng(seed)
    H = st.n_nodes
    x = [i for i in range(H) if st.bdi[i] >= 0 and i < st.bdi[i]][0]
    y = int(st.bdi[x])
    px, py, tx, ty = _towers(n, seed)
    theta = rng.gamma(20.0, 1 / 10000.0, (n, H))
    theta[:, x], theta[:, y] = tx, ty
    phi = np.zeros((n, H))
    mx, my = int(st.hybrid[x]), int(st.hybrid[y])
    phi[:, mx], phi[:, x] = px, 1 - px
    phi[:, my], phi[:, y] = py, 1 - py
    tau = np.zeros((n, H))
    base = {"R": 0.06, "S": 0.03, "X": 0.02, "Y": 0.02}
    for i in range(st.n_tips, H):
        lab = st.labels[i]
        tau[:, i] = base[lab] * (1 + 0.05 * rng.standard_normal(n))
    tau[:, y] = tau[:, mx] = tau[:, my] = tau[:, x]
    return theta, tau, phi


def test_lswitch_samples_equal():
    from bpp_tpu.summary.lswitch import lswitch_samples as sj
    from bpp_tpu.trees.stree import SpeciesTree as SJ
    from bpp_tpu_torch.summary.lswitch import bdi_pairs_of, lswitch_samples
    from bpp_tpu_torch.trees.stree import SpeciesTree
    st = SpeciesTree.from_newick(NWK, ["A", "B", "C"])
    stj = SJ.from_newick(NWK, ["A", "B", "C"])
    assert len(bdi_pairs_of(st)) == 1
    theta, _, phi = _samples(st)
    th2, ph2 = theta.copy(), phi.copy()
    logs, logs_j = [], []
    got = lswitch_samples(st, theta, phi, log=logs.append)
    want = sj(stj, th2, ph2, log=logs_j.append)
    assert got == want and got[0] > 0
    np.testing.assert_array_equal(theta, th2)
    np.testing.assert_array_equal(phi, ph2)
    assert logs == logs_j


def test_partner_rate_tie():
    from bpp_tpu_torch.io.ctl import parse_ctl_lines
    from bpp_tpu_torch.loader import load_run
    from bpp_tpu_torch.mcmc.driver import Engine
    text = CTL.format(job="out", nloci=4, nsample=3,
                      extra="clock = 2 10 100 5 iid G\ncheck = 3")
    run = load_run(parse_ctl_lines(text.splitlines()).replace(
        dtype="float64"))
    eng = Engine(run, seed=3, device="cpu")
    state = eng.init_state()
    st = run.stree
    x = st.labels.index("X")
    mir_x = int(st.hybrid[x])
    assert not bool(state.sp.rate_nodes[mir_x])
    assert int(state.sp.rate_owner[mir_x]) == x
    ll0 = eng._logl_fn(state.gt, state.subst, state.sp, state.clock)
    br = state.clock.brate.clone()
    br[:, mir_x] = 777.0
    ll_g = eng._logl_fn(state.gt, state.subst, state.sp,
                        state.clock._replace(brate=br))
    assert torch.equal(ll0, ll_g)
    br = state.clock.brate.clone()
    br[:, x] *= 3.0
    ll_b = eng._logl_fn(state.gt, state.subst, state.sp,
                        state.clock._replace(brate=br))
    assert float((ll_b - ll0).abs().max()) > 1e-3
    # a short chain with the runtime check of the caches
    log = eng.run_mcmc(progress_every=0)
    assert len(log.gen) == 3 and np.isfinite(log.lnL).all()
    assert len(log.phi) == 3


def test_both_clis_write_the_same_processed_file(tmp_path, monkeypatch):
    import bpp_tpu.cli as cli_j
    import bpp_tpu.mcmc.driver as drv_j
    import bpp_tpu_torch.mcmc.driver as drv
    from bpp_tpu_torch import cli
    from bpp_tpu_torch.trees.stree import SpeciesTree
    st = SpeciesTree.from_newick(NWK, ["A", "B", "C"])
    theta, tau, phi = _samples(st)
    lnl = -19000.0 - np.arange(len(theta), dtype=float)

    def run_j(self, progress_every=0, on_sample=None, **kw):
        log = drv_j.SampleLog()
        for k in range(len(theta)):
            state = SimpleNamespace(
                sp=SimpleNamespace(theta=theta[k], tau=tau[k], phi=phi[k]),
                logl=np.asarray([lnl[k]]), mig=None, mubar=None, clock=None)
            log.gen.append(k + 1)
            log.theta.append(theta[k].copy())
            log.tau.append(tau[k].copy())
            log.lnL.append(lnl[k])
            log.logpr.append(0.0)
            log.phi.append(phi[k].copy())
            on_sample(k + 1, state)
        return log

    def run_p(self, progress_every=0, on_sample=None, **kw):
        log = drv.SampleLog()
        for k in range(len(theta)):
            row = {"theta": theta[k], "tau": tau[k], "phi": phi[k],
                   "lnl": lnl[k], "logpr": 0.0}
            log.gen.append(k + 1)
            log.theta.append(theta[k].copy())
            log.tau.append(tau[k].copy())
            log.lnL.append(lnl[k])
            log.logpr.append(0.0)
            log.phi.append(phi[k].copy())
            on_sample(k + 1, row)
        return log

    dirs = []
    for tag, mod, fake, main, argv in (
            ("port", drv.Engine, run_p, cli.main, ["--device", "cpu"]),
            ("jax", drv_j.Engine, run_j, cli_j.main, [])):
        d = tmp_path / tag
        d.mkdir()
        (d / "run.ctl").write_text(CTL.format(job=f"{d}/out", nloci=2,
                                              nsample=len(theta), extra=""))
        monkeypatch.setattr(mod, "run_mcmc", fake)
        assert main(["--cfile", str(d / "run.ctl"), "--quiet", "--x64"]
                    + argv) == 0
        dirs.append(d)
    port, jax_dir = dirs
    files = sorted(os.listdir(port))
    assert files == sorted(os.listdir(jax_dir))
    assert "out.mcmc.txt.processed" in files
    assert "out.FigTree.tre" not in files
    assert "out.conditional_a1b1.txt" not in files
    for f in ("out.mcmc.txt", "out.mcmc.txt.processed"):
        assert (port / f).read_bytes() == (jax_dir / f).read_bytes(), f
    a, b = ((d / "out.txt").read_text().split("\n", 1)[1]
            for d in (port, jax_dir))
    assert a == b
    assert "phi:" in a
    raw = (port / "out.mcmc.txt").read_text()
    assert raw != (port / "out.mcmc.txt.processed").read_text()
