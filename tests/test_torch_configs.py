"""The configurations ``chip_smoke.py`` mains 17-22 take to the card, on
the CPU at 5 loci x 80 sites (the simulator of the port on the scripts'
own simulation control files).

* (a) Each control file of mains 19-22 parses to the same configuration
  in the port and in ``bpp_tpu``; ``Engine.init_state``'s logl and logpr
  equal ``bpp_tpu``'s in float64 (rtol 1e-10), for the combinations no
  other test starts: TN93+G4, GTR+G4 on haploid data, diploid HKY+G4 x
  clock = 3 x Gamma-Dirichlet locus rates, and traits x clock = 2 x A01.
* (b) Five iterations of each of mains 17-22's control files through the
  port's CLI on the CPU, in float32 (the card's type), end with finite
  mcmc.txt rows (chains = 8: all eight files; A01: one newick a sample).
* (c) The simulator is prefix-stable: the first 5 loci of a 20-locus
  simulation are the 5-locus simulation at the same seed, and the port's
  loader with ``nloci = 5`` on the 20-locus file gives ``bpp_tpu``'s
  batch, which is the batch of the 5-locus file.
"""

import dataclasses
import enum
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

torch.set_num_threads(1)     # tiny tensors; the suite runs in parallel

N_LOCI, N_SITES = 5, 80
BATCH_FIELDS = ("tip_codes", "weights", "res_map", "res_count", "n_seq",
                "n_pat", "tip_pop", "locus_mask")


def _simulate(directory, text, nloci=N_LOCI, run_simulation=None):
    """One of chip_smoke's simulation control files at ``nloci`` loci of
    ``N_SITES`` sites, simulated in ``directory``."""
    if run_simulation is None:
        from bpp_tpu_torch.sim.simulate import run_simulation
    text = text.format(nloci=nloci).replace(f"{nloci} 500",
                                            f"{nloci} {N_SITES}")
    cwd = os.getcwd()
    os.chdir(directory)
    try:
        with open("sim.ctl", "w") as f:
            f.write(text)
        run_simulation("sim.ctl")
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Main 1's and main 2's data (``sim.phy``, ``sim2.phy``) and main
    15's trait file in one directory."""
    from bpp_tpu_torch.testing import write_trait_file
    d = tmp_path_factory.mktemp("configs")
    _simulate(d, cs.SIM_CTL)
    _simulate(d, cs.SIM2_CTL)
    write_trait_file(str(d / "traits.txt"), seed=137)
    return d


def _ctl(d, n, **kw):
    path = d / f"run{n}.ctl"
    path.write_text(cs.new_ctl(n, N_LOCI, **kw))
    return str(path)


def _plain(x):
    """A configuration value with each package's own enums and
    dataclasses turned into names and dicts."""
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name, x.value)
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


@pytest.mark.parametrize("n", [19, 20, 21, 22])
def test_config_and_init_state_equal_bpp_tpus(data, n, monkeypatch):
    from bpp_tpu.io.ctl import parse_ctl as parse_j
    from bpp_tpu.loader import load_run as load_j
    from bpp_tpu.mcmc.driver import Engine as EJ
    from bpp_tpu_torch.io.ctl import parse_ctl as parse_p
    from bpp_tpu_torch.loader import load_run as load_p
    from bpp_tpu_torch.mcmc.driver import Engine as EP
    monkeypatch.chdir(data)
    ctl = _ctl(data, n)
    cj, cp = parse_j(ctl), parse_p(ctl)
    assert _plain(cp) == _plain(cj)
    want = {19: ("TN93", 1, 4), 20: ("GTR", 1, 4), 21: ("HKY", 3, 4),
            22: ("JC69", 2, 1)}[n]
    assert (cp.model.name, cp.clock.value, cp.gamma_cats) == want
    rj, rp = load_j(cj.replace(dtype="float64")), \
        load_p(cp.replace(dtype="float64"))
    sj = EJ(rj, seed=7).init_state()
    sp = EP(rp, seed=7, device="cpu").init_state()
    for f in ("logl", "logpr"):
        np.testing.assert_allclose(getattr(sp, f).numpy(),
                                   np.asarray(getattr(sj, f)), rtol=1e-10,
                                   err_msg=f)
    assert np.isfinite(sp.logl.numpy()).all()
    if n == 22:
        np.testing.assert_allclose(sp.trait.logl.numpy(),
                                   np.asarray(sj.trait.logl), rtol=1e-10)


@pytest.mark.parametrize("n", [17, 18, 19, 20, 21, 22])
def test_five_iterations_through_the_cli_in_float32(data, n, monkeypatch):
    from bpp_tpu_torch import cli
    from bpp_tpu_torch.io.newick import parse_newick
    from bpp_tpu_torch.mcmc import driver
    monkeypatch.chdir(data)
    dtypes = []
    orig = driver.Engine.init_state

    def init_state(eng):
        dtypes.append(eng.dtype)
        return orig(eng)

    monkeypatch.setattr(driver.Engine, "init_state", init_state)
    ctl = _ctl(data, n, burnin=1, nsample=4)
    assert cli.main(["--cfile", ctl, "--device", "cpu", "--quiet"]) == 0
    assert set(dtypes) == {torch.float32}
    files = [f"out{n}.mcmc.txt"] + [f"out{n}.c{k}.mcmc.txt"
                                    for k in range(2, cs.CHAINS_18 + 1)
                                    if n == 18]
    for fn in files:
        lines = (data / fn).read_text().splitlines()
        if n == 22:
            assert len(lines) == 4
            for t in lines:
                parse_newick(t)
            continue
        rows = np.loadtxt(lines[1:], ndmin=2)
        assert rows.shape == (4, len(lines[0].split()))
        assert np.isfinite(rows).all()


def test_simulation_is_prefix_stable(tmp_path):
    from bpp_tpu.loader import load_run_from_ctl as load_j
    from bpp_tpu_torch.loader import load_run_from_ctl as load_p
    small, big = tmp_path / "small", tmp_path / "big"
    small.mkdir()
    big.mkdir()
    _simulate(small, cs.SIM_CTL)
    _simulate(big, cs.SIM_CTL, nloci=20)
    head = (small / "sim.phy").read_text()
    assert (big / "sim.phy").read_text().startswith(head)
    for d in (big, small):
        (d / "run.ctl").write_text(cs.RUN_CTL.format(
            nloci=N_LOCI, burnin=1, nsample=4, job="out", extra="").replace(
            "seqfile = sim.phy", f"seqfile = {d}/sim.phy").replace(
            "Imapfile = sim.Imap.txt", f"Imapfile = {d}/sim.Imap.txt"))
    rj = load_j(str(big / "run.ctl"))
    for rp in (load_p(str(big / "run.ctl")), load_p(str(small / "run.ctl"))):
        assert rp.batch.n_loci == N_LOCI
        for f in BATCH_FIELDS:
            x, y = getattr(rj.batch, f), getattr(rp.batch, f)
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
