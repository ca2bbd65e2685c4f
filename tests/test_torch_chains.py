"""``chains = K`` in the PyTorch port against ``bpp_tpu``.

* ``Engine.init_states(K)``: chain k starts at seed + 1000003 k, so each
  chain's initial state equals the corresponding slice of ``bpp_tpu``'s
  stacked states.
* The CLI (``--device cpu``) writes ``<job>.mcmc.txt`` and
  ``<job>.c2.mcmc.txt`` with ``bpp_tpu``'s headers; the split-R-hat table
  of ``<job>.txt`` holds ``bpp_tpu``'s ``split_rhat`` of the written
  series; under A10 the per-chain P(#species) lines are those of
  ``bpp_tpu``'s ``n_species`` on the written taus; and with
  ``checkpoint = 3 0`` a resumed run writes byte-identical files.
* The refusals (A01, ``check = N``, a relaxed clock) print ``bpp_tpu``'s
  messages.
* Under hierarchical locus rates every chain's ``mu_bar`` column is
  ``nan``, as ``bpp_tpu``'s ``_run_multichain`` writes it: the port's K
  sample logs written by ``bpp_tpu``'s ``_run_multichain`` are the port's
  files byte for byte.
"""

import shutil
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)     # tiny tensors; the suite runs in parallel

K = 2


@pytest.fixture(scope="module")
def simdir(tmp_path_factory):
    from bpp_tpu_torch.testing import write_simulated_run
    d = tmp_path_factory.mktemp("chains")
    write_simulated_run(d, 4, n_sites=60, burnin=4, nsample=6,
                        priors=(f"chains = {K}", "checkpoint = 3 0"))
    write_simulated_run(d, 4, n_sites=60, burnin=4, nsample=8, job="a10",
                        priors=(f"chains = {K}",
                                "speciesdelimitation = 1 0 2"))
    return d


def test_init_states_equal_bpp_tpus(simdir):
    from bpp_tpu.loader import load_run_from_ctl as load_j
    from bpp_tpu.mcmc.driver import Engine as EJ
    from bpp_tpu_torch.loader import load_run_from_ctl as load_p
    from bpp_tpu_torch.mcmc.driver import Engine as EP
    ctl = str(simdir / "out.ctl")
    rj, rp = load_j(ctl), load_p(ctl)
    rj.cfg = rj.cfg.replace(dtype="float64")
    rp.cfg = rp.cfg.replace(dtype="float64")
    engj, eng = EJ(rj, seed=9), EP(rp, seed=9, device="cpu")
    # bpp_tpu's init_states(K) is init_state at seed + 1000003 k, stacked;
    # each chain's arrays are copied here before the next chain's
    # init_tau_theta rewrites the host tree, which bpp_tpu's species
    # arrays may alias (jnp.asarray of an aligned numpy buffer on the CPU
    # backend; ROADMAP Queue 3)
    sj = []
    for k in range(K):
        engj.seed = 9 + 1000003 * k
        st = engj.init_state()
        sj.append({(part, f): np.array(getattr(getattr(st, part), f))
                   for part in ("gt", "sp")
                   for f in ("left", "right", "parent", "age", "tau",
                             "theta")
                   if getattr(getattr(st, part), f, None) is not None}
                  | {"logl": np.array(st.logl), "logpr": np.array(st.logpr)})
    engj.seed = 9
    sp = eng.init_states(K)
    assert len(sp) == K and eng.seed == 9
    for k, st in enumerate(sp):
        assert eng.chain_seed(k) == 9 + 1000003 * k
        for key, a in sj[k].items():
            if key in ("logl", "logpr"):
                continue
            part, f = key
            np.testing.assert_allclose(
                getattr(getattr(st, part), f).numpy(), a, rtol=1e-12,
                err_msg=f"chain {k} {part}.{f}")
        np.testing.assert_allclose(st.logl.numpy(), sj[k]["logl"],
                                   rtol=1e-10)
        np.testing.assert_allclose(st.logpr.numpy(), sj[k]["logpr"],
                                   rtol=1e-10)
    # the chains differ
    assert not torch.equal(sp[0].gt.age, sp[1].gt.age)


def _cli(simdir, *argv):
    from bpp_tpu_torch import cli
    assert cli.main([*argv, "--device", "cpu", "--quiet"]) == 0


def _series(path):
    with open(path) as fh:
        head = fh.readline().rstrip("\n").split("\t")
        rows = np.asarray([[float(x) for x in ln.split("\t")]
                           for ln in fh if ln.strip()])
    return head, rows


def test_files_headers_rhat_and_resume(simdir, tmp_path):
    from bpp_tpu.loader import load_run_from_ctl as load_j
    from bpp_tpu.output import McmcWriter as WJ
    from bpp_tpu.summary.allfixed import split_rhat
    from bpp_tpu_torch.summary.allfixed import split_rhat as split_rhat_p
    _cli(simdir, "--cfile", str(simdir / "out.ctl"))
    files = [simdir / "out.mcmc.txt", simdir / "out.c2.mcmc.txt"]
    whole = [f.read_bytes() for f in files]
    run = load_j(str(simdir / "out.ctl"))
    WJ(str(tmp_path / "h.txt"), run.cfg, run.stree).close()
    header = (tmp_path / "h.txt").read_text()
    series = []
    for f in files:
        assert f.read_text().startswith(header), f
        head, rows = _series(f)
        assert rows.shape[0] == 6 and np.isfinite(rows).all()
        series.append(rows)
    text = (simdir / "out.txt").read_text()
    assert f"split-R-hat over {K} chains" in text
    got = {ln.split()[0]: float(ln.split()[-1]) for ln in
           text.split("(values near 1 = converged):")[1].splitlines()
           if ln.startswith("  ")}
    # the table's values come from the unrounded samples, the files hold
    # six decimals
    for j, name in enumerate(head[1:], start=1):
        x = np.stack([s[:, j] for s in series])
        want = split_rhat(x)
        np.testing.assert_allclose(split_rhat_p(x), want, rtol=1e-12)
        assert abs(got[name] - want) < 2e-3, (name, got[name], want)
    # resume from the checkpoint at generation 3: the same files
    for f in files:
        shutil.move(f, tmp_path / f.name)
    _cli(simdir, "--resume", str(simdir / "out.chk.npz"))
    assert [f.read_bytes() for f in files] == whole


def test_a10_per_chain_species_counts(simdir):
    from bpp_tpu.loader import load_run_from_ctl as load_j
    from bpp_tpu.summary.delimit_summary import n_species
    _cli(simdir, "--cfile", str(simdir / "a10.ctl"))
    st = load_j(str(simdir / "a10.ctl")).stree
    text = (simdir / "a10.txt").read_text()
    lines = text.split("Per-chain P(#species):\n")[1].splitlines()[:K]
    for c, f in enumerate(["a10.mcmc.txt", "a10.c2.mcmc.txt"]):
        head, rows = _series(simdir / f)
        tau = np.zeros((rows.shape[0], st.n_nodes))
        for j, name in enumerate(head):
            if name.startswith("tau:"):
                tau[:, int(name.split(":")[1]) - 1] = rows[:, j]
        ns = np.asarray([n_species(t, st) for t in tau])
        want = " ".join(f"{k}:{float((ns == k).mean()):.3f}"
                        for k in range(1, st.n_tips + 1))
        assert lines[c] == f"  chain {c + 1}: {want}", (lines[c], want)


@pytest.mark.parametrize("extra", ["speciestree = 1", "check = 5",
                                   "clock = 2 10 100 5 iid G"])
def test_refusals_print_bpp_tpus_messages(simdir, capsys, extra):
    from bpp_tpu import cli as cj
    from bpp_tpu.io.ctl import parse_ctl_lines as parse_j
    from bpp_tpu_torch import cli as cp
    from bpp_tpu_torch.io.ctl import parse_ctl_lines as parse_p
    text = (simdir / "out.ctl").read_text() + extra + "\n"
    args = types.SimpleNamespace(resume=None, quiet=True)
    out = []
    for parse, run_multi, kw in (
            (parse_j, cj._run_multichain, {"is_main": True}),
            (parse_p, cp._run_multichain, {"cfg_text": text, "ctl_dir": ""})):
        cfg = parse(text.splitlines())
        assert run_multi(args, cfg, None, None, "x.mcmc.txt", **kw) == 1
        out.append(capsys.readouterr().err)
    assert out[0] == out[1] and out[0], out


def test_hierarchical_mu_bar_column_as_bpp_tpu_writes_it(tmp_path,
                                                         monkeypatch):
    """``bpp_tpu/cli.py``'s ``_run_multichain`` calls
    ``McmcWriter.write_sample`` without ``mubar_h``, so under ``chains =
    K`` with hierarchical locus rates (``locusrate = 1 a b alpha iid``)
    the ``mu_bar`` column of every chain's file reads ``nan``; the port
    copies that on purpose (ROADMAP Queue 3).  The samples of the port's
    run, handed to ``bpp_tpu``'s ``_run_multichain`` in place of its
    engine's, give the port's files byte for byte."""
    from bpp_tpu import cli as cj
    from bpp_tpu.loader import load_run_from_ctl as load_j
    from bpp_tpu_torch.mcmc.driver import Engine
    from bpp_tpu_torch.testing import write_simulated_run
    ctl = write_simulated_run(tmp_path, 3, n_sites=40, burnin=2, nsample=4,
                              priors=(f"chains = {K}",
                                      "locusrate = 1 10 10 5 iid"))
    logs = []
    real = Engine.run_mcmc_multi

    def kept(self, *a, **kw):
        logs.extend(real(self, *a, **kw))
        return logs

    monkeypatch.setattr(Engine, "run_mcmc_multi", kept)
    _cli(tmp_path, "--cfile", ctl)
    files = [tmp_path / "out.mcmc.txt", tmp_path / "out.c2.mcmc.txt"]
    ours = [f.read_bytes() for f in files]
    (tmp_path / "j").mkdir()
    run = load_j(ctl)
    cfg = run.cfg.replace(jobname=str(tmp_path / "j" / "out"))
    eng = types.SimpleNamespace(run_mcmc_multi=lambda *a, **kw: logs)
    args = types.SimpleNamespace(resume=None, quiet=True)
    assert cj._run_multichain(args, cfg, run, eng, cfg.jobname + ".mcmc.txt",
                              True) == 0
    theirs = [(tmp_path / "j" / f.name).read_bytes() for f in files]
    assert ours == theirs
    for raw in ours:
        head, *rows = raw.decode().splitlines()
        col = head.split("\t").index("mu_bar")
        assert len(rows) == 4
        assert all(r.split("\t")[col] == "nan" for r in rows)
