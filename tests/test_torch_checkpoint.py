"""Checkpoint and resume in the port (``checkpoint = initial [step]``,
``--resume``, ``--extend``), on the CPU.

* save -> load restores every leaf of the state bit for bit, on the
  template's device and dtypes, and the generator draws what it would
  have drawn.
* ``cli.main --device cpu`` with a checkpoint, then ``--resume`` from it:
  mcmc.txt is byte-identical to the uninterrupted run's and the summary
  counts every sample; on the strict clock, and with a relaxed clock,
  integrated-out thetas and heredity (whose moves run host accept
  chains).
* ``--resume --extend N`` adds N samples.
* An MSC-I network run (phi columns, hybridization flags in the state)
  resumed gives the uninterrupted run's mcmc.txt byte for byte; the
  int8 flags keep their dtype and shape through the ``.npz``.
* A checkpoint restored under another data shape raises; ``--extend``
  without ``--resume`` is refused.
"""

import filecmp
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from bpp_tpu_torch import checkpoint as ckpt
from bpp_tpu_torch import cli

torch.set_num_threads(1)     # tiny tensors; the suite runs in parallel

CASES = {
    "strict": ("3 0.03", ("checkpoint = 12 0",)),
    "relaxed-integrated": ("invgamma 3 0.03 int", (
        "checkpoint = 8 10", "heredity = 1 4 4", "locusrate = 1 10 10 5",
        "clock = 2 10 100 5 gdir G")),
}


def _ctl(directory, name, n_loci=4, nsample=30):
    from bpp_tpu_torch.testing import write_simulated_run
    theta, priors = CASES[name]
    return write_simulated_run(directory, n_loci=n_loci, n_sites=60,
                               thetaprior=theta, priors=priors, burnin=10,
                               nsample=nsample)


def _engine(ctl, seed=7):
    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.mcmc.driver import Engine
    run = load_run_from_ctl(ctl)
    return Engine(run, seed=seed, device="cpu")


def test_save_load_round_trip(tmp_path):
    ctl = _ctl(tmp_path, "relaxed-integrated")
    eng = _engine(ctl)
    state, _ = eng.chunk_step(eng.init_state(), 3)
    stats = np.arange(46, dtype=np.float64).reshape(23, 2)
    path = tmp_path / "x.chk.npz"
    ckpt.save_checkpoint(path, state, eng.gen, 17, stats, cfg_text="seed = 1",
                         seed=eng.seed, mcmc_offset=123,
                         extra={"ctl_dir": "/d", "nsample": 9})
    meta, text, arrays = ckpt.load_checkpoint(path)
    assert meta["it"] == 17 and meta["mcmc_offset"] == 123
    assert meta["seed"] == eng.seed and meta["extra"]["nsample"] == 9
    assert text == "seed = 1"
    np.testing.assert_array_equal(arrays["stats_acc"], stats)
    back = ckpt.restore_state(_engine(ctl, seed=99).init_state(), arrays)
    names = [n for n, _ in ckpt._leaves(state)]
    assert "state.coal" in names and "state.clock.brate" in names
    for (name, a), (_, b) in zip(ckpt._leaves(state), ckpt._leaves(back)):
        assert a.dtype == b.dtype and a.device == b.device, name
        assert torch.equal(a, b), name
    gen = torch.Generator()
    gen.set_state(ckpt.rng_state(arrays))
    assert torch.equal(torch.rand(5, generator=gen),
                       torch.rand(5, generator=eng.gen))


@pytest.mark.parametrize("name", list(CASES))
def test_resume_is_byte_identical(tmp_path, name):
    ctl = _ctl(tmp_path, name)
    job = Path(ctl).with_name("out")
    assert cli.main(["--cfile", ctl, "--device", "cpu", "--quiet"]) == 0
    whole = Path(f"{job}.whole.txt")
    shutil.copy(f"{job}.mcmc.txt", whole)
    chk = Path(f"{job}.chk.npz")
    meta, _, _ = ckpt.load_checkpoint(chk)
    # checkpoint = 12 0: once, at 12; = 8 10: at 8, 18, 28 (the last)
    assert meta["it"] == (12 if name == "strict" else 28)
    if name != "strict":
        # resume from the first checkpoint too: write one at 8 only
        text = Path(ctl).read_text().replace("checkpoint = 8 10",
                                             "checkpoint = 8 0")
        Path(ctl).write_text(text)
        assert cli.main(["--cfile", ctl, "--device", "cpu", "--quiet"]) == 0
        assert filecmp.cmp(f"{job}.mcmc.txt", whole, shallow=False)
        assert ckpt.load_checkpoint(chk)[0]["it"] == 8
    assert cli.main(["--resume", str(chk), "--device", "cpu",
                     "--quiet"]) == 0
    assert filecmp.cmp(f"{job}.mcmc.txt", whole, shallow=False)
    assert len(whole.read_text().splitlines()) == 31
    assert "(30 samples" in Path(f"{job}.txt").read_text()


def test_extend_adds_samples(tmp_path):
    ctl = _ctl(tmp_path, "strict", nsample=20)
    job = Path(ctl).with_name("out")
    text = Path(ctl).read_text().replace("checkpoint = 12 0",
                                         "checkpoint = 20 0")
    Path(ctl).write_text(text)
    assert cli.main(["--cfile", ctl, "--device", "cpu", "--quiet"]) == 0
    first = Path(f"{job}.mcmc.txt").read_text().splitlines()
    assert len(first) == 21
    assert cli.main(["--resume", f"{job}.chk.npz", "--extend", "7",
                     "--device", "cpu", "--quiet"]) == 0
    lines = Path(f"{job}.mcmc.txt").read_text().splitlines()
    assert lines[:21] == first and len(lines) == 28
    assert [int(ln.split("\t")[0]) for ln in lines[21:]] == list(range(21, 28))
    assert "(27 samples" in Path(f"{job}.txt").read_text()


def test_restore_under_another_shape_raises(tmp_path):
    a = tmp_path / "a"
    b = tmp_path / "b"
    a.mkdir()
    b.mkdir()
    eng = _engine(_ctl(a, "strict", n_loci=4))
    state = eng.init_state()
    path = tmp_path / "a.chk.npz"
    ckpt.save_checkpoint(path, state, eng.gen, 0, np.zeros((23, 2)),
                         cfg_text="", seed=1, mcmc_offset=0)
    _, _, arrays = ckpt.load_checkpoint(path)
    other = _engine(_ctl(b, "strict", n_loci=5)).init_state()
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_state(other, arrays)
    with pytest.raises(ValueError, match="missing leaf"):
        ckpt.restore_state(_engine(_ctl(b, "relaxed-integrated", n_loci=4))
                           .init_state(), arrays)


def test_extend_needs_resume(capsys):
    assert cli.main(["--cfile", "x.ctl", "--extend", "3"]) == 1
    assert "--resume" in capsys.readouterr().err


def test_network_resume_is_byte_identical(tmp_path):
    from bpp_tpu_torch.testing import (
        NET_GUIDE, NET_SIM_TREE, write_simulated_run,
    )
    ctl = write_simulated_run(tmp_path, n_loci=3, n_sites=60, burnin=4,
                              nsample=12, sim_tree=NET_SIM_TREE,
                              guide=NET_GUIDE,
                              priors=("phiprior = 1 1", "checkpoint = 6 0"))
    job = Path(ctl).with_name("out")
    assert cli.main(["--cfile", ctl, "--device", "cpu", "--quiet"]) == 0
    whole = Path(f"{job}.whole.txt")
    shutil.copy(f"{job}.mcmc.txt", whole)
    head = whole.read_text().splitlines()[0]
    assert "phi:" in head
    chk = Path(f"{job}.chk.npz")
    meta, _, arrays = ckpt.load_checkpoint(chk)
    assert meta["it"] == 6
    hp = arrays["state.gt.hpath"]
    assert hp.dtype == np.int8 and hp.shape[2] == 1
    back = ckpt.restore_state(_engine(ctl).init_state(), arrays)
    assert back.gt.hpath.dtype == torch.int8
    np.testing.assert_array_equal(back.gt.hpath.numpy(), hp)
    assert cli.main(["--resume", str(chk), "--device", "cpu",
                     "--quiet"]) == 0
    assert filecmp.cmp(f"{job}.mcmc.txt", whole, shallow=False)
    assert "(12 samples" in Path(f"{job}.txt").read_text()
