"""The port's relaxed clocks (clock = 2 IID, 3 CORR, 4 SIMPLE) against
``bpp_tpu``, on the CPU in float64.

* ``lnprior_rates`` over clocks 2/3 x gamma/lognormal rates and clock 4,
  on random rates, variances and locus rates (rtol 1e-10).
* ``relaxed_branch_lengths`` on bpp_tpu's starting gene trees and rates
  (rtol 1e-12).
* The relaxed log-likelihood of the plain path on bpp_tpu's starting
  state against bpp_tpu's relaxed ``make_logl_fn``, haploid JC69 and
  diploid HKY+G4 (rtol 1e-10).
* ``init_state`` equal to bpp_tpu's for each clock: gene trees, locus
  rates, the rate hierarchy, lnrates, logl, logpr (rtol 1e-9).
* The cached ``logl`` and ``lnrates`` equal a fresh evaluation after each
  new move (mu_i, nu_i, nubar, the branch-rate sweeps, and tau/mixing
  under the correlated lognormal prior, whose density moves with the
  taus).
* With ``usedata = 0`` the rate moves recover their priors: nubar, nu_i
  and the IID branch rates, the mean nu_i under the Gamma-Dirichlet
  prior, and the SIMPLE clock's rates, on their first and second moments
  within 4 Monte Carlo standard errors (20 batch means).  (mubar is
  recovered under tip dating, ``test_torch_tipdate.py``; mu_i and mubar
  under the strict clock, ``test_torch_subst_moves.py``.)
* The Gamma-Dirichlet accept chain's plain version (``gammadir_accept``
  on the CPU, what kernel K4 is held against on the card) takes
  bpp_tpu's decisions on the inputs of bpp_tpu's mu_i and nu_i scans,
  read at the scan, and on those inputs with every uniform moved to
  1e-7..1e-6 from its threshold under the serial carry (bpp_tpu's scan
  rerun on them): equal but for a first disagreement at a near tie
  (< 1e-9).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpp_tpu_torch.mcmc import clock_moves, moves

torch.set_num_threads(1)     # tiny tensors; the suite runs in parallel

HKY_SIM = ("model = 3\nkappa = 2\nbasefreqs = 0.3 0.2 0.2 0.3\n"
           "locusrate = 1 5")
CLOCKS = {
    "iid-G": ("JC69", False, ("locusrate = 1 10 10 5 iid",
                              "clock = 2 10 100 5 iid G")),
    "corr-LN": ("JC69", False, ("locusrate = 1 10 10 5",
                                "clock = 3 10 100 5 gdir LN")),
    "corr-G": ("JC69", False, ("locusrate = 1 10 10 5 iid",
                               "clock = 3 10 100 5 iid G")),
    "simple-diploid": ("HKY", True, ("alphaprior = 1 1 4",
                                     "locusrate = 1 10 10 5 iid",
                                     "heredity = 1 4 4", "clock = 4 2.0")),
}


@pytest.fixture(scope="module")
def ctls(tmp_path_factory):
    from bpp_tpu_torch.testing import write_simulated_run
    out = {}
    for name, (model, diploid, priors) in CLOCKS.items():
        tmp = tmp_path_factory.mktemp(f"torchclock-{name}")
        out[name] = write_simulated_run(
            tmp, n_loci=5, n_sites=80,
            seqs=(1, 1, 2, 2) if diploid else (2, 2, 2, 2),
            diploid=(1, 1, 0, 0) if diploid else None,
            sim_model=HKY_SIM if diploid else "model = 0", model=model,
            priors=priors)
    return out


def _port_engine(ctl, seed=7, **replace):
    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.mcmc.driver import Engine
    run = load_run_from_ctl(ctl)
    run.cfg = run.cfg.replace(dtype="float64", **replace)
    return Engine(run, seed=seed, device="cpu")


def _jax_engine(ctl, seed=7):
    from bpp_tpu.loader import load_run_from_ctl
    from bpp_tpu.mcmc.driver import Engine
    run = load_run_from_ctl(ctl)
    run.cfg = run.cfg.replace(dtype="float64")
    return Engine(run, seed=seed)


def _fields(nt):
    return {k: (None if v is None else np.asarray(v))
            for k, v in nt._asdict().items()}


@pytest.fixture(scope="module")
def jax_states(ctls):
    return {name: _jax_engine(ctl).init_state() for name, ctl in ctls.items()}


PRIOR_CASES = [(2, 1), (2, 0), (3, 1), (3, 0), (4, 1)]


@pytest.mark.parametrize("clock,dist", PRIOR_CASES,
                         ids=[f"clock{c}-{'G' if d else 'LN'}"
                              for c, d in PRIOR_CASES])
def test_lnprior_rates_matches_bpp_tpu(ctls, clock, dist):
    from bpp_tpu.config import Clock as ClockEnumJ
    from bpp_tpu.mcmc.clock_moves import lnprior_rates as lj
    from bpp_tpu.mcmc.state import ClockState as ClockJ
    from bpp_tpu.trees.gtree import species_arrays as spj
    from bpp_tpu_torch.config import Clock
    from bpp_tpu_torch.mcmc.state import ClockState
    from bpp_tpu_torch.trees.gtree import species_arrays
    eng = _port_engine(ctls["iid-G"])
    eng.init_state()                       # sets the taus of the tree
    cfg = eng.cfg.replace(clock=Clock(clock), clock_rate_prior=dist,
                          clock_alpha=2.5)
    cfgj = _jax_engine(ctls["iid-G"]).cfg.replace(
        clock=ClockEnumJ(clock), clock_rate_prior=dist, clock_alpha=2.5)
    st = eng.run.stree
    rng = np.random.default_rng(clock * 10 + dist)
    L, H = 6, st.n_nodes
    mu = rng.gamma(5.0, 0.2, L)
    nu = rng.gamma(4.0, 0.05, L)
    brate = rng.gamma(3.0, 0.4, (1 if clock == 4 else L, H))
    got = clock_moves.lnprior_rates(
        cfg, species_arrays(st), torch.as_tensor(mu),
        ClockState(*(torch.as_tensor(a) for a in
                     (brate, nu, 1.0, 1.0, np.zeros(brate.shape[0])))))
    want = lj(cfgj, spj(st), jnp.asarray(mu), ClockJ(
        jnp.asarray(brate), jnp.asarray(nu), 1.0, 1.0,
        jnp.zeros(brate.shape[0])))
    assert got.shape == (brate.shape[0],)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10)


def test_relaxed_branch_lengths_match_bpp_tpu(ctls, jax_states):
    from bpp_tpu.core.felsenstein import relaxed_branch_lengths as rj
    from bpp_tpu.trees.gtree import assign_populations as apj
    from bpp_tpu_torch.convert import state_from_numpy
    from bpp_tpu_torch.core.felsenstein import relaxed_branch_lengths
    from bpp_tpu_torch.trees.gtree import assign_populations
    sj = jax_states["iid-G"]
    eng = _port_engine(ctls["iid-G"])
    ctxj = _jax_engine(ctls["iid-G"]).ctx
    st = state_from_numpy({"gt": _fields(sj.gt), "sp": _fields(sj.sp),
                           "subst": _fields(sj.subst),
                           "clock": _fields(sj.clock)})
    pops = assign_populations(st.gt, st.sp, eng.ctx.tip_pop)
    got = relaxed_branch_lengths(st.gt, st.sp, pops, st.clock.brate)
    want = rj(sj.gt, sj.sp, apj(sj.gt, sj.sp, ctxj.tip_pop), sj.clock.brate)
    assert float(got.abs().max()) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-15)


@pytest.mark.parametrize("name", ["iid-G", "simple-diploid"])
def test_relaxed_logl_matches_bpp_tpu(ctls, jax_states, name):
    """bpp_tpu's starting state through both packages' relaxed logl."""
    from bpp_tpu.mcmc.state import make_logl_fn as mj
    from bpp_tpu_torch.convert import state_from_numpy
    sj = jax_states[name]
    engj = _jax_engine(ctls[name])
    eng = _port_engine(ctls[name])
    if name == "simple-diploid":
        assert eng.ctx.res_map is not None
    st = state_from_numpy({"gt": _fields(sj.gt), "sp": _fields(sj.sp),
                           "subst": _fields(sj.subst),
                           "clock": _fields(sj.clock)})
    # rates off their starting values, so that the lengths are relaxed
    rng = np.random.default_rng(4)
    br = np.asarray(sj.clock.brate) * rng.uniform(0.5, 2.0,
                                                  sj.clock.brate.shape)
    got = eng._logl_fn(st.gt, st.subst, st.sp,
                       st.clock._replace(brate=torch.as_tensor(br)))
    want = mj(engj.ctx, engj.cfg)(sj.gt, sj.subst, sj.sp,
                                  sj.clock._replace(brate=jnp.asarray(br)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10)


@pytest.mark.parametrize("name", list(CLOCKS))
def test_init_state_matches_bpp_tpu(ctls, jax_states, name):
    sj = jax_states[name]
    sp = _port_engine(ctls[name]).init_state()

    def close(a, b, what):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-9,
                                   atol=1e-12, err_msg=what)

    close(sp.gt.age.numpy(), sj.gt.age, "gene-tree ages")
    close(sp.sp.tau.numpy(), sj.sp.tau, "tau")
    close(sp.subst.mu.numpy(), sj.subst.mu, "mu")
    for f in ("brate", "nu", "mubar", "nubar", "lnrates"):
        close(getattr(sp.clock, f).numpy(), getattr(sj.clock, f), f)
    close(sp.logl.numpy(), sj.logl, "logl")
    close(sp.logpr.numpy(), sj.logpr, "logpr")
    assert sp.mubar is None and sp.coal is None


MOVES = [
    ("iid-G", "mui", clock_moves.mui_move),
    ("iid-G", "nui", clock_moves.nui_move),
    ("iid-G", "nubar", clock_moves.nubar_move),
    ("iid-G", "brate", clock_moves.brate_move),
    ("corr-LN", "mui", clock_moves.mui_move),
    ("corr-LN", "nui", clock_moves.nui_move),
    ("corr-LN", "brate", clock_moves.brate_move),
    ("corr-LN", "tau", moves.tau_move),
    ("corr-LN", "mixing", moves.mixing_move),
    ("corr-G", "brate", clock_moves.brate_move),
    ("simple-diploid", "mui", clock_moves.mui_move),
    ("simple-diploid", "brate_simple", clock_moves.brate_simple_move),
]


@pytest.mark.parametrize("name,move,fn", MOVES,
                         ids=[f"{n}-{m}" for n, m, _ in MOVES])
def test_move_keeps_caches_exact(ctls, name, move, fn):
    eng = _port_engine(ctls[name], seed=21)
    state = eng.init_state()
    gen = torch.Generator().manual_seed(5)
    before = state
    proposed = accepted = 0
    # a global move takes one decision a call
    for _ in range(10 if move == "mixing" else 3):
        state, (p, a) = fn(eng.ctx, eng.cfg, state, gen)
        proposed += int(p)
        accepted += int(a)
        logl = eng._logl_fn(state.gt, state.subst, state.sp, state.clock)
        lnr = clock_moves.lnprior_rates(eng.cfg, state.sp, state.subst.mu,
                                        state.clock)
        np.testing.assert_allclose(state.logl.numpy(), logl.numpy(),
                                   rtol=1e-10, atol=1e-9)
        np.testing.assert_allclose(state.clock.lnrates.numpy(), lnr.numpy(),
                                   rtol=1e-10, atol=1e-9)
    assert proposed > 0 and 0 < accepted <= proposed
    if move.startswith("brate"):
        assert bool((state.clock.brate != before.clock.brate).any())
    if name.startswith("corr") and move in ("mui", "brate"):
        # the correlated clock's root rate is the locus rate
        root = state.sp.root
        assert bool((state.clock.brate[:, root] == state.subst.mu).all())


def _prior_engine(tmp_path, priors, n_loci=3, seed=3):
    from bpp_tpu_torch.testing import write_simulated_run
    ctl = write_simulated_run(tmp_path, n_loci=n_loci, n_sites=40, usedata=0,
                              priors=priors)
    eng = _port_engine(ctl, seed=seed)
    return eng, eng.init_state()


def _check_moments(x, mean, second, what, n_batches=20):
    x = np.asarray(x, np.float64)
    n = len(x) // n_batches * n_batches
    for power, want in ((1, mean), (2, second)):
        if want is None:
            continue
        y = x[:n] ** power
        b = y.reshape(n_batches, -1, *y.shape[1:]).mean(1)
        se = b.std(0, ddof=1) / np.sqrt(n_batches)
        got = y.mean(0)
        want = np.broadcast_to(np.asarray(want, np.float64), got.shape)
        assert (np.abs(got - want) < 4 * se).all(), (what, power, got, want,
                                                     se)


def _run(eng, state, fns, n, read, burn=300, seed=11):
    gen = torch.Generator().manual_seed(seed)
    out = []
    for it in range(burn + n):
        for fn in fns:
            state, _ = fn(eng.ctx, eng.cfg, state, gen)
        if it >= burn:
            out.append(read(state).numpy().copy())
    return np.stack(out)


def test_prior_recovery_iid_clock(tmp_path):
    """Hierarchical nu_i and IID gamma branch rates at fixed locus rates
    (mu_i = 1): nubar ~ G(av, bv), nu_i | nubar ~ G(avi, avi/nubar),
    r | nu ~ G(1/nu, 1/nu), so E r = 1 and E r^2 = 1 + E nu.  (Estimated
    mu_i and mubar, tied to seven rates a locus, mix too slowly for a
    short run; their moves' caches are held above.)"""
    av, bv, avi = 10.0, 50.0, 5.0
    eng, state = _prior_engine(tmp_path, (
        f"clock = 2 {av} {bv} {avi} iid G",))
    assert eng.cfg.locusrate_prior == 1 and eng.cfg.est_locusrate == 0
    x = _run(eng, state, [clock_moves.nui_move, clock_moves.nubar_move,
                          clock_moves.brate_move], 4000,
             lambda s: torch.cat([s.clock.nubar[None], s.clock.nu,
                                  s.clock.brate.reshape(-1)]))
    L = state.clock.nu.shape[0]
    v2 = av * (av + 1) / bv ** 2
    _check_moments(x[:, 0], av / bv, v2, "nubar")
    _check_moments(x[:, 1:1 + L], av / bv, v2 * (avi + 1) / avi, "nu_i")
    _check_moments(x[:, 1 + L:], 1.0, 1.0 + av / bv, "branch rates")


def test_prior_recovery_gamma_dirichlet_nu(tmp_path):
    """nu_i under the Gamma-Dirichlet prior (the serial host chain): the
    mean variance is Gamma(av, bv)."""
    av, bv, avi = 10.0, 50.0, 5.0
    eng, state = _prior_engine(tmp_path, (
        "locusrate = 1 10 10 5", f"clock = 2 {av} {bv} {avi} gdir G"))
    assert eng.cfg.locusrate_prior == 0
    nu = _run(eng, state, [clock_moves.nui_move, clock_moves.brate_move],
              4000, lambda s: s.clock.nu)
    _check_moments(nu.mean(1), av / bv, av * (av + 1) / bv ** 2, "mean nu")


def test_prior_recovery_simple_clock(tmp_path):
    a = 2.5
    eng, state = _prior_engine(tmp_path, (f"clock = 4 {a}",))
    r = _run(eng, state, [clock_moves.brate_simple_move], 4000,
             lambda s: s.clock.brate[0])
    _check_moments(r, 1.0, 1.0 + 1.0 / a, "simple rates")


@pytest.fixture(scope="module")
def gdir_chain(tmp_path_factory):
    """bpp_tpu's engine and starting state on 40 loci under the prior,
    clock = 3 with Gamma-Dirichlet mu_i and nu_i."""
    from bpp_tpu_torch.testing import write_simulated_run
    tmp = tmp_path_factory.mktemp("torchclock-gdir")
    ctl = write_simulated_run(tmp, n_loci=40, n_sites=40, usedata=0,
                              priors=("locusrate = 1 10 10 5",
                                      "clock = 3 10 100 5 gdir LN"))
    engj = _jax_engine(ctl)
    assert engj.cfg.locusrate_prior == 0
    return engj, engj.init_state()


def _bpp_tpu_scan(engj, state_j, move, key, monkeypatch):
    """``bpp_tpu``'s move on ``state_j`` with ``key``, its Gamma-Dirichlet
    ``lax.scan`` (clock_moves.py:212 / :296) read as it runs: (the move's
    locals at the scan, the scan's body, init and inputs, its decisions)."""
    import sys

    import jax
    real = jax.lax.scan
    seen = []

    def spy(body, init, xs, *a, **kw):
        carry, ys = real(body, init, xs, *a, **kw)
        seen.append((dict(sys._getframe(1).f_locals), body, init, xs, ys))
        return carry, ys

    monkeypatch.setattr(jax.lax, "scan", spy)
    try:
        move(engj.ctx, engj.cfg, state_j, jax.random.PRNGKey(key))
    finally:
        monkeypatch.undo()
    found = [s for s in seen if "terma" in s[0]]
    assert len(found) == 1, len(seen)
    return found[0]


def _edge_uniforms(mo, mn, lratio, mask, a_bar, terma, termb, rng):
    """Uniforms that put every proposing locus's decision 1e-7..1e-6 from
    its threshold under the serial carry (``_gammadir_chain``'s walk in
    its arithmetic), accepted or rejected at random."""
    u = np.ones(len(mo))
    sum_mu = float(mo[mask].sum())
    for i in np.flatnonzero(mask):
        sum_new = sum_mu + mn[i] - mo[i]
        lnacc = ((a_bar - terma) * np.log(sum_new / sum_mu)
                 - termb * (sum_new - sum_mu) + lratio[i])
        acc = rng.random() < 0.5
        gap = rng.uniform(1e-7, 1e-6)
        u[i] = np.exp(lnacc - gap if acc else lnacc + gap)
        if acc:
            sum_mu = sum_new
    return u


@pytest.mark.parametrize("move", ["mui", "nui"])
def test_gammadir_chain_matches_bpp_tpu_scans(gdir_chain, move, monkeypatch):
    import types

    import jax
    from bpp_tpu.mcmc import clock_moves as cmj
    engj, state_j = gdir_chain
    cfg = engj.cfg
    if move == "mui":
        fn, a_bar, b_bar, a_i = (cmj.mui_move, cfg.locusrate_mubar_a,
                                 cfg.locusrate_mubar_b, cfg.locusrate_alpha)
    else:
        fn, a_bar, b_bar, a_i = (cmj.nui_move, cfg.clock_vbar_a,
                                 cfg.clock_vbar_b, cfg.clock_vi_alpha)
    rng = np.random.default_rng(3)
    decided = np.zeros(2, int)
    for key in range(8):
        _, body, init, xs, want = _bpp_tpu_scan(engj, state_j, fn, key,
                                                monkeypatch)
        xs = [np.array(x) for x in xs]
        if move == "mui":
            mo, mn, dlog, dlo, dlr, u, mask = xs
            ddens, iu = dlo + dlr, 5
        else:
            mo, mn, dlog, dlr, u, mask = xs
            ddens, iu = dlr, 4
        nl = float(mask.sum())
        lratio = (a_i - 1.0) * np.log(mn / mo) + dlog + ddens
        for edge in (False, True):
            if edge:
                u = _edge_uniforms(mo, mn, lratio, mask, a_bar, a_i * nl,
                                   b_bar / nl, rng)
                xs[iu] = u
                _, want = jax.lax.scan(body, init, tuple(
                    jnp.asarray(x) for x in xs))
            want = np.asarray(want)
            ctx = types.SimpleNamespace(locus_mask=torch.as_tensor(mask),
                                        shard=None)
            margin = np.full(len(mo), np.inf)
            got = clock_moves.gammadir_accept(
                ctx, *(torch.as_tensor(x) for x in (mo, mn, dlog, ddens, u)),
                a_bar, b_bar, a_i, margin=margin).numpy()
            differ = np.flatnonzero(got != want)
            assert not len(differ) or margin[differ[0]] < 1e-9, (
                key, edge, differ, margin[differ])
            decided += [int(got[mask].sum()), int((~got[mask]).sum())]
    assert decided.min() > 0, decided
