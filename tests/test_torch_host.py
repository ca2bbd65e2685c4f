"""Host-side copies in the PyTorch port (parsing, loading, output,
simulation) reproduce ``bpp_tpu`` exactly on a simulated dataset."""

import os

import numpy as np
import pytest

SIM_CTL = """\
seed = 137
seqfile = sim.phy
treefile = sim.tre
Imapfile = sim.Imap.txt
modelparafile = sim.para.txt
species&tree = 4 A B C D
                 2 3 2 2
                ((A #0.01, B #0.01) :0.01 #0.01, (C #0.01, D #0.01) :0.012 #0.01) :0.02 #0.01;
loci&length = 9 150
model = {model}
{extra}"""

RUN_CTL = """\
seed = 11
seqfile = {tmp}/sim.phy
Imapfile = {tmp}/sim.Imap.txt
jobname = {tmp}/out
species&tree = 4 A B C D
                 2 3 2 2
                ((A, B), (C, D));
usedata = 1
nloci = 9
cleandata = 0
model = {model}
thetaprior = 3 0.03
tauprior = 3 0.06
burnin = 4
sampfreq = 1
nsample = 4
"""


# two migration routes (A -> B and B -> A forward in time, M = 0.5)
MIGRATION = "migration = 2\nA B 0.5\nB A 0.5\n"


def _simulate(tmp, sim_mod, model="0", extra=""):
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        with open("sim.ctl", "w") as f:
            f.write(SIM_CTL.format(model=model, extra=extra))
        sim_mod.run_simulation("sim.ctl")
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def simdir(tmp_path_factory):
    from bpp_tpu.sim import simulate
    tmp = tmp_path_factory.mktemp("torchhost")
    _simulate(tmp, simulate)
    return tmp


@pytest.mark.parametrize("model,extra", [("0", ""), ("HKY", ""),
                                         ("0", MIGRATION)],
                         ids=["0", "HKY", "migration"])
def test_simulator_writes_identical_files(tmp_path, model, extra):
    from bpp_tpu.sim import simulate as sim_jax
    from bpp_tpu_torch.sim import simulate as sim_port
    a, b = tmp_path / "jax", tmp_path / "port"
    a.mkdir()
    b.mkdir()
    _simulate(a, sim_jax, model, extra)
    _simulate(b, sim_port, model, extra)
    for name in ("sim.phy", "sim.Imap.txt", "sim.tre"):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


@pytest.mark.parametrize("model", ["0", "HKY"])
def test_load_run_matches(simdir, model):
    from bpp_tpu.loader import load_run_from_ctl as load_jax
    from bpp_tpu_torch.loader import load_run_from_ctl as load_port
    ctl = simdir / f"run_{model}.ctl"
    ctl.write_text(RUN_CTL.format(tmp=simdir, model=model))
    rj, rp = load_jax(str(ctl)), load_port(str(ctl))
    for f in ("tip_codes", "weights", "res_map", "res_count", "n_seq",
              "n_pat", "tip_pop", "locus_mask"):
        x, y = getattr(rj.batch, f), getattr(rp.batch, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert rj.batch.labels == rp.batch.labels
    for f in ("names", "left", "right", "parent", "tau", "theta"):
        np.testing.assert_array_equal(np.asarray(getattr(rj.stree, f)),
                                      np.asarray(getattr(rp.stree, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(rj.stree.pptable(), rp.stree.pptable())
    np.testing.assert_array_equal(rj.stree.mrca_table(),
                                  rp.stree.mrca_table())
    assert rj.cfg.model.name == rp.cfg.model.name
    assert rj.cfg.thetaprior.alpha == rp.cfg.thetaprior.alpha


def test_mcmc_writer_header_matches(simdir, tmp_path):
    from bpp_tpu.loader import load_run_from_ctl as load_jax
    from bpp_tpu.output import McmcWriter as WJ
    from bpp_tpu_torch.loader import load_run_from_ctl as load_port
    from bpp_tpu_torch.output import McmcWriter as WP
    ctl = simdir / "run_hdr.ctl"
    ctl.write_text(RUN_CTL.format(tmp=simdir, model="0"))
    rj, rp = load_jax(str(ctl)), load_port(str(ctl))
    WJ(str(tmp_path / "j.txt"), rj.cfg, rj.stree).close()
    WP(str(tmp_path / "p.txt"), rp.cfg, rp.stree).close()
    hj = (tmp_path / "j.txt").read_text()
    hp = (tmp_path / "p.txt").read_text()
    assert hj == hp
    assert hj.startswith("Gen\ttheta:1:A")
