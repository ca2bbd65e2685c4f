"""The captured step (``mcmc.graph.StepGraph``) against the eager chunk,
on the CPU, where a replay runs the captured body eagerly.

* ``Engine._chunk`` on the graph route equals the eager route bit for
  bit at the same seed (states, move statistics, trace rows, the a1b1
  sample records and the generator's state) on A00 JC69 (K1's path) and
  diploid HKY+G4 (K2's plain version), in float32 and float64, and on
  the schedules whose device control flow the port runs on the card:
  integrated thetas (K3's plain version), A01 with SNL (both species
  moves computed, one selected), MSC-M (K5's) and clock = 3 with
  Gamma-Dirichlet mu_i and nu_i (K4's).
* ``cli.main --device cpu`` writes the same mcmc.txt on both routes: a
  run whose chunks cross the finetune marks, with ``check = N``, under
  ``--x64`` and with ``chains = 2``; a checkpointed run resumed on the
  graph route rewrites the uninterrupted run's files byte for byte (one
  chain and two).
* ``driver.step_route``: every schedule without ``--multihost`` goes to
  the graph, those whose step once read the device from the host among
  them, and the configurations of the main paths go to the graph (GTR and per-locus
  models among them: ``pmatrix.eigh_jacobi``, which GTR's eigensystem
  takes in a captured step, matches ``torch.linalg.eigh``, and a GTR+G4
  chain through it, on either route, matches ``bpp_tpu``).
* The static buffers: a state of another shape is refused, a step whose
  result aliases another buffer is written back right, and
  ``_reset_finetune`` writes through into the buffer.
"""

import dataclasses
import os
import sys
import types

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

torch.set_num_threads(1)     # tiny tensors; the suite runs in parallel


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from bpp_tpu_torch.testing import MIG_RUN, MIG_SIM, write_simulated_run
    d = tmp_path_factory.mktemp("graph")
    write_simulated_run(d, 4, n_sites=60, burnin=8, nsample=6,
                        priors=("check = 5",))
    write_simulated_run(d, 4, n_sites=60, seqs=(1, 1, 2, 2),
                        diploid=(1, 1, 0, 0), model="HKY", burnin=8,
                        nsample=6, job="dip", priors=(
                            "alphaprior = 1 1 4", "locusrate = 1 10 10 5 iid",
                            "heredity = 1 4 4"))
    write_simulated_run(d, 4, n_sites=60, burnin=4, nsample=6, job="ck",
                        priors=("checkpoint = 3 0",))
    write_simulated_run(d, 4, n_sites=60, burnin=4, nsample=6, job="c2",
                        priors=("chains = 2", "checkpoint = 3 0"))
    # the schedules whose device control flow the step runs on the card
    # (K3, K4, K5 and SNL's species-level part): integrated thetas, A01
    # with SNL, MSC-M, clock = 3 with Gamma-Dirichlet mu_i and nu_i
    write_simulated_run(d, 4, n_sites=60, burnin=8, nsample=6, job="int",
                        thetaprior="invgamma 3 0.03 int")
    write_simulated_run(d, 4, n_sites=60, burnin=8, nsample=6, job="snl",
                        priors=(cs.A01.strip(),))
    write_simulated_run(d, 4, n_sites=60, burnin=8, nsample=6, job="mig",
                        sim_model="model = 0\n" + MIG_SIM,
                        priors=(MIG_RUN.strip(),))
    write_simulated_run(d, 4, n_sites=60, burnin=8, nsample=6, job="gdir",
                        priors=("clock = 3 10 100 5 gdir LN",
                                "locusrate = 1 10 10 5"))
    return d


def _flat(state):
    from bpp_tpu_torch.mcmc.graph import flatten
    return flatten(state)[1]


def _engine(ctl, route, dtype):
    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.mcmc.driver import Engine
    run = load_run_from_ctl(ctl)
    run.cfg = run.cfg.replace(dtype=dtype)
    eng = Engine(run, seed=5, device="cpu")
    assert eng.route == "graph", eng.route_reason
    eng.route = route
    return eng


@pytest.mark.parametrize("job,dtype", [("out", "float32"), ("out", "float64"),
                                       ("dip", "float32"), ("dip", "float64"),
                                       ("int", "float32"), ("snl", "float32"),
                                       ("mig", "float32"),
                                       ("gdir", "float64")])
def test_graph_chunk_equals_eager(data, job, dtype):
    from bpp_tpu_torch.mcmc.driver import clone_state
    out = {}
    for route in ("eager", "graph"):
        eng = _engine(str(data / f"{job}.ctl"), route, dtype)
        eng.record_samples(a1b1=True)
        state = eng.init_state()
        eng.gen.manual_seed(5)
        state, st1, tr1, rec1 = eng._chunk(state, 6, it=-4)
        state = eng._reset_finetune(state, st1.numpy() * 20)
        # a state the host rebuilt is loaded into the buffers
        state = clone_state(state)
        state, st2, tr2, rec2 = eng._chunk(state, 4, it=2)
        out[route] = (_flat(clone_state(state)), [st1, st2], [tr1, tr2],
                      [rec1, rec2], eng.gen.get_state())
    (le, se, te, re_, ge), (lg, sg, tg, rg, gg) = out["eager"], out["graph"]
    assert len(le) == len(lg)
    assert all(torch.equal(a, b) for a, b in zip(le, lg))
    assert all(torch.equal(a, b) for a, b in zip(se, sg))
    for a, b in zip(te + re_, tg + rg):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(ge, gg)
    assert rg[1]["a1"].shape[0] == 4       # one record a sample


def _run_cli(ctl, route, extra, monkeypatch):
    from bpp_tpu_torch import cli
    from bpp_tpu_torch.mcmc import driver
    with monkeypatch.context() as m:
        if route == "eager":
            m.setattr(driver, "step_route",
                      lambda cfg, shard=None: ("eager", "compared"))
        assert cli.main(["--cfile", ctl, "--device", "cpu", "--quiet",
                         *extra]) == 0


@pytest.mark.parametrize("job,extra", [("out", ()), ("dip", ("--x64",)),
                                       ("c2", ())])
def test_cli_files_equal_on_both_routes(data, tmp_path, monkeypatch, job,
                                        extra):
    """Chunks that cross the finetune marks, ``check = 5`` (``out``), K2's
    plain version in float64 (``dip``) and two chains (``c2``)."""
    files = {}
    for route in ("eager", "graph"):
        d = tmp_path / route
        d.mkdir()
        cs.cut_ctl(str(data / f"{job}.ctl"), str(d / f"{job}.ctl"),
                   job=str(d / job))
        monkeypatch.chdir(d)
        _run_cli(f"{job}.ctl", route, extra, monkeypatch)
        names = [f"{job}.mcmc.txt"] + ([f"{job}.c2.mcmc.txt"]
                                       if job == "c2" else [])
        files[route] = [(d / n).read_bytes() for n in names]
    assert files["eager"] == files["graph"]
    assert all(len(f.splitlines()) == 7 for f in files["graph"])


@pytest.mark.parametrize("job", ["ck", "c2"])
def test_resume_on_graph_route_is_byte_identical(data, tmp_path, monkeypatch,
                                                 job):
    """Checkpoint at generation 3, then ``--resume``: the files equal the
    uninterrupted run's (one chain; two chains)."""
    from bpp_tpu_torch import cli
    d = tmp_path / job
    d.mkdir()
    cs.cut_ctl(str(data / f"{job}.ctl"), str(d / f"{job}.ctl"),
               job=str(d / job))
    monkeypatch.chdir(d)
    names = [f"{job}.mcmc.txt"] + ([f"{job}.c2.mcmc.txt"]
                                   if job == "c2" else [])
    assert cli.main(["--cfile", f"{job}.ctl", "--device", "cpu",
                     "--quiet"]) == 0
    whole = [(d / n).read_bytes() for n in names]
    assert cli.main(["--resume", f"{job}.chk.npz", "--device", "cpu",
                     "--quiet"]) == 0
    assert [(d / n).read_bytes() for n in names] == whole


def _cfg(text):
    from bpp_tpu_torch.io.ctl import parse_ctl_string
    return parse_ctl_string(text)


def _main_ctl(n):
    run = cs.RUN_CTL.format(nloci=10, burnin=8, nsample=4, job="x",
                            extra="{extra}")
    run2 = cs.RUN2_CTL.format(nloci=10, burnin=8, nsample=4, job="x",
                              extra="{extra}")
    from bpp_tpu_torch.testing import NET_GUIDE
    return {
        1: run.format(extra=""), 2: run2.format(extra=""),
        3: run.format(extra=cs.RELAXED), 4: run2.format(extra=cs.SIMPLE),
        9: cs.AA_CTL.format(nloci=10, burnin=8, nsample=4),
        10: run.replace("((A, B), (C, D));", NET_GUIDE + ";").format(
            extra="phiprior = 1 1\n"),
        11: cs.BDI_CTL.format(fix=".", job="x", burnin=8, nsample=4,
                              extra="thetamodel = linked-msci\n"),
        13: run.format(extra=f"chains = {cs.CHAINS}\n"),
        15: run.format(extra=cs.TRAITS15.format(check=10)),
        8: run.format(extra=cs.CUSTOM8.format(check=10, last=10)),
        17: cs.new_ctl(17, 10), 18: cs.new_ctl(18, 10),
        19: cs.new_ctl(19, 10), 20: cs.new_ctl(20, 10),
    }[n]


@pytest.mark.parametrize("main", [1, 2, 3, 4, 8, 9, 10, 11, 13, 15, 17, 18,
                                  19, 20])
def test_step_route_captures_the_main_paths(main):
    from bpp_tpu_torch.mcmc.driver import step_route
    route, why = step_route(_cfg(_main_ctl(main)))
    assert route == "graph", why


@pytest.mark.parametrize("case,lines,where", [
    ("gamma-dirichlet", "locusrate = 1 10 10 5\n", "clock_moves.py:194"),
    ("gamma-dirichlet nu_i", "clock = 2 10 100 5 gdir G\n",
     "clock_moves.py:194"),
    ("integrated thetas", "thetaprior = invgamma 3 0.03 int\n",
     "notheta.py:96"),
    ("snl", cs.A01, "stree_moves.py:498"),
    ("msc-m", None, "mig_moves.py:830"),
])
def test_step_route_sends_host_reads_eager(case, lines, where):
    """The five schedules whose step once read the device from the host
    (``where``: the host read each had) take the graph route now that the
    accept chains (K3/K4), SNL's species-level part and the
    sim-SPR walk (K5) run on the device; ``--multihost`` alone stays
    eager, its all-reduces going through the host."""
    from bpp_tpu_torch.mcmc.driver import step_route
    from bpp_tpu_torch.testing import MIG_RUN
    text = cs.RUN_CTL.format(nloci=10, burnin=8, nsample=4, job="x",
                             extra=lines if lines else MIG_RUN)
    text = text.replace("thetaprior = 3 0.03\n", "") if "int" in (
        lines or "") else text
    cfg = _cfg(text)
    route, why = step_route(cfg)
    assert route == "graph", (case, where, why)
    route, why = step_route(cfg, shard=object())
    assert route == "eager" and "--multihost" in why, (route, why)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 2e-5)])
def test_eigh_jacobi_matches_eigh(dtype, tol):
    """The device-side eigensolver GTR's eigensystem takes on the card
    (``pmatrix.eigh_jacobi``): eigenvalues of random reversible 4-state
    systems (and of repeated-eigenvalue matrices) equal to
    ``torch.linalg.eigh``'s, orthonormal eigenvectors that rebuild the
    matrix."""
    from bpp_tpu_torch.core.pmatrix import eigh_jacobi
    g = torch.Generator().manual_seed(7)
    L = 500
    f = torch.rand((L, 4), generator=g, dtype=torch.float64) + 0.01
    f = f / f.sum(1, keepdim=True)
    r = torch.rand((L, 6), generator=g, dtype=torch.float64) ** 3 * 50 + 1e-3
    iu = torch.triu_indices(4, 4, 1)
    R = torch.zeros((L, 4, 4), dtype=torch.float64)
    R[:, iu[0], iu[1]] = r
    Q = (R + R.transpose(1, 2)) * f[:, None, :]
    Q = Q - torch.diag_embed(Q.sum(-1))
    sq = f.sqrt()
    B = sq[:, :, None] * Q / sq[:, None, :]
    B = torch.cat([B, torch.eye(4, dtype=B.dtype)[None],
                   torch.diag(torch.tensor([1.0, 1.0, 2.0, 2.0],
                                           dtype=B.dtype))[None]]).to(dtype)
    w, V = eigh_jacobi(B)
    scale = B.abs().amax((-2, -1))[:, None]
    want = torch.linalg.eigvalsh(B.double())
    assert ((w.double().sort(-1).values - want).abs() / scale).max() < tol
    eye = torch.eye(4, dtype=dtype)
    assert (V.transpose(-1, -2) @ V - eye).abs().max() < tol * 10
    rebuilt = V @ torch.diag_embed(w) @ V.transpose(-1, -2)
    assert (((rebuilt - B).abs().amax((-2, -1)) / scale[:, 0]).max()
            < tol * 10)


def test_gtr_chain_through_eigh_jacobi_matches_bpp_tpu(tmp_path,
                                                      monkeypatch):
    """A GTR+G4 chain in float64 on the CPU with every eigensystem from
    ``pmatrix.eigh_jacobi`` (``Ctx.captured``, the captured step's solver
    on the card; an eager step takes ``torch.linalg.eigh``), on both
    routes (bit-equal): after 30 iterations that moved freqs and
    qrates, the cached eigensystem gives ``bpp_tpu``'s P(t) for the
    chain's own freqs and qrates, and ``bpp_tpu``'s likelihood of the
    chain's state, its eigensystem solved by ``bpp_tpu``, equals the
    chain's cached logl (rtol 1e-9)."""
    import jax.numpy as jnp
    import numpy as np
    from bpp_tpu.checkpoint import restore_state
    from bpp_tpu.core.pmatrix import gtr_eigen as gtr_eigen_j
    from bpp_tpu.loader import load_run_from_ctl as load_j
    from bpp_tpu.mcmc.driver import Engine as EngineJ
    from bpp_tpu_torch.checkpoint import _leaves
    from bpp_tpu_torch.core import pmatrix
    from bpp_tpu_torch.testing import write_simulated_run
    ctl = write_simulated_run(tmp_path, 6, n_sites=150, model="GTR",
                              sim_model="model = 3\nkappa = 2\nbasefreqs = "
                              "0.3 0.2 0.2 0.3", priors=("alphaprior = 2 4 4",))
    calls = []

    def jacobi(B):
        calls.append(B.shape)
        return orig(B)
    orig = pmatrix.eigh_jacobi
    monkeypatch.setattr(pmatrix, "eigh_jacobi", jacobi)
    states = {}
    for route in ("eager", "graph"):
        eng = _engine(ctl, route, "float64")
        eng.ctx = dataclasses.replace(eng.ctx, captured=True)
        init = eng.init_state()
        states[route], _ = eng.chunk_step(init, 30)
    assert len(calls) > 60
    for a, b in zip(_flat(states["eager"]), _flat(states["graph"])):
        assert torch.equal(a, b)
    state = states["graph"]
    sub = state.subst
    assert not torch.equal(sub.qrates, init.subst.qrates)
    assert not torch.equal(sub.freqs, init.subst.freqs)
    w, T, Ti = (np.asarray(a) for a in gtr_eigen_j(
        jnp.asarray(sub.freqs.numpy()), jnp.asarray(sub.qrates.numpy())))

    def pmat(w, T, Ti, t=0.3):
        return np.einsum("lik,lk,lkj->lij", T, np.exp(w * t), Ti)
    np.testing.assert_allclose(
        pmat(sub.eigw.numpy(), sub.eigT.numpy(), sub.eigTi.numpy()),
        pmat(w, T, Ti), rtol=1e-10, atol=1e-12)
    rj = load_j(ctl)
    rj.cfg = rj.cfg.replace(dtype="float64")
    ej = EngineJ(rj, seed=7)
    arrays = {k: v.numpy() for k, v in _leaves(state)}
    arrays.update({"state.subst.eigw": w, "state.subst.eigT": T,
                   "state.subst.eigTi": Ti})
    sj = restore_state(ej.init_state(), arrays)
    logl = ej._logl_fn(sj.gt, sj.subst, sj.sp, sj.clock)
    np.testing.assert_allclose(state.logl.numpy(), np.asarray(logl),
                               rtol=1e-9)


def test_load_refuses_another_shape(data):
    from bpp_tpu_torch.mcmc.graph import StepGraph
    eng = _engine(str(data / "out.ctl"), "graph", "float32")
    state = eng.init_state()
    graph = StepGraph(eng, [state], [eng.gen])
    bad = state._replace(logl=state.logl[:-1])
    with pytest.raises(ValueError, match="shape"):
        graph.load([bad])
    with pytest.raises(ValueError, match="structure"):
        graph.load([state._replace(coal=state.logl)])
    with pytest.raises(ValueError, match="chains"):
        graph.load([state, state])


def test_write_back_of_aliased_results_and_finetune(data):
    """A step whose new state holds another buffer (here logl and logpr
    swapped) is written back as the eager step's result, and
    ``_reset_finetune`` writes into the buffer the next replay reads."""
    from bpp_tpu_torch.mcmc.driver import clone_state
    from bpp_tpu_torch.mcmc.graph import StepGraph
    eng = _engine(str(data / "out.ctl"), "graph", "float64")
    state = eng.init_state()
    stats = torch.zeros((23, 2), dtype=torch.int64)

    def swap(self, st):
        return st._replace(logl=st.logpr, logpr=st.logl), stats
    eng._step = types.MethodType(swap, eng)
    graph = StepGraph(eng, [state], [eng.gen])
    graph.replay()
    view = graph.state()
    assert torch.equal(view.logl, state.logpr)
    assert torch.equal(view.logpr, state.logl)
    before = clone_state(view.finetune)
    st = eng._reset_finetune(view, stats.numpy() + [[100, 100]])
    assert st is view and graph.state().finetune is view.finetune
    assert not torch.equal(view.finetune, before)
    assert any(b is view.finetune for b in graph.bufs[0])
