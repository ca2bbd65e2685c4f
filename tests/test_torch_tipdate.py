"""Tip dating (``datefile`` with ``locusrate = 3 a b``) in the port, on the
CPU in float64.  The data is a simulated run plus a datefile the test
writes (dates in [0, 1] calendar units, one per individual).

* ``per_pop_stats_dated`` equals bpp_tpu's on bpp_tpu's dated starting
  trees (counts exact, waiting sums rtol 1e-12), and equals the undated
  ``per_pop_stats`` when every date is 0.
* ``init_gtrees(tip_ages=)`` and the whole dated ``init_state`` equal
  bpp_tpu's: topology exact, ages, taus, mubar, logl and logpr to rtol
  1e-9 or better.
* After each ``tipdate_mubar_move`` the tip ages are exactly
  ``date * mubar``, and logl/logpr (or, with integrated thetas, the
  coal/t2h caches) equal a fresh evaluation.
* With ``usedata = 0`` the chain recovers mubar's Gamma(a, b) prior
  (mean and second moment within 4 Monte Carlo standard errors).
"""

import numpy as np
import pytest
import torch

from bpp_tpu_torch.mcmc import clock_moves

torch.set_num_threads(1)     # tiny tensors; the suite runs in parallel

A_MU, B_MU = 10.0, 10000.0


def _dated_run(directory, n_loci, zero=False, usedata=1, nsample=10,
               thetaprior="3 0.03", extra=()):
    """A simulated run of ((A,B),(C,D)), 2 individuals a species, and its
    datefile; returns the control file."""
    from bpp_tpu_torch.testing import write_simulated_run
    rng = np.random.default_rng(8)
    dates = directory / "dates.txt"
    dates.write_text("".join(
        f"{s}{k} {0.0 if zero else round(float(rng.uniform(0, 1)), 3)}\n"
        for s in "abcd" for k in (1, 2)))
    return write_simulated_run(
        directory, n_loci=n_loci, n_sites=80, usedata=usedata,
        thetaprior=thetaprior, nsample=nsample,
        priors=(f"datefile = {dates}", f"locusrate = 3 {A_MU} {B_MU}",
                *extra))


@pytest.fixture(scope="module")
def ctl(tmp_path_factory):
    return _dated_run(tmp_path_factory.mktemp("torchdate"), 5)


def _engines(ctl, seed=7):
    from bpp_tpu.loader import load_run_from_ctl as load_jax
    from bpp_tpu.mcmc.driver import Engine as EngineJ
    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.mcmc.driver import Engine
    rj = load_jax(ctl)
    rj.cfg = rj.cfg.replace(dtype="float64")
    rp = load_run_from_ctl(ctl)
    rp.cfg = rp.cfg.replace(dtype="float64")
    return EngineJ(rj, seed=seed), Engine(rp, seed=seed, device="cpu")


def test_dated_init_state_matches_bpp_tpu(ctl):
    engj, eng = _engines(ctl)
    sj, sp = engj.init_state(), eng.init_state()
    assert eng.ctx.tip_dates is not None
    np.testing.assert_array_equal(eng.run.tip_dates, engj.run.tip_dates)
    for f in ("left", "right", "parent"):
        np.testing.assert_array_equal(getattr(sp.gt, f).numpy(),
                                      np.asarray(getattr(sj.gt, f)))
    T = sp.gt.n_tips
    ages = sp.gt.age.numpy()
    assert (ages[:, :T] > 0).any()
    np.testing.assert_allclose(ages, np.asarray(sj.gt.age), rtol=1e-12)
    np.testing.assert_allclose(ages[:, :T],
                               eng.run.tip_dates * A_MU / B_MU, rtol=1e-15)
    for got, want in ((sp.sp.tau, sj.sp.tau), (sp.mubar, sj.mubar),
                      (sp.logl, sj.logl), (sp.logpr, sj.logpr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9)


def test_per_pop_stats_dated_matches_bpp_tpu(ctl):
    from bpp_tpu.trees.coalescent import per_pop_stats_dated as dj
    from bpp_tpu.trees.gtree import assign_populations as apj
    from bpp_tpu_torch.convert import state_from_numpy
    from bpp_tpu_torch.trees.coalescent import per_pop_stats_dated
    from bpp_tpu_torch.trees.gtree import assign_populations
    engj, eng = _engines(ctl)
    sj = engj.init_state()

    def fields(nt):
        return {k: (None if v is None else np.asarray(v))
                for k, v in nt._asdict().items()}

    st = state_from_numpy({"gt": fields(sj.gt), "sp": fields(sj.sp),
                           "subst": fields(sj.subst)})
    c, t2, n_in = per_pop_stats_dated(
        st.gt, st.sp, assign_populations(st.gt, st.sp, eng.ctx.tip_pop),
        eng.ctx.n_seq)
    cj, t2j, n_inj = dj(sj.gt, sj.sp, apj(sj.gt, sj.sp, engj.ctx.tip_pop),
                        engj.ctx.n_seq)
    np.testing.assert_array_equal(c.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(n_in.numpy(), np.asarray(n_inj))
    np.testing.assert_allclose(t2.numpy(), np.asarray(t2j), rtol=1e-12,
                               atol=1e-15)


def test_dated_stats_equal_undated_when_every_date_is_0(tmp_path):
    from bpp_tpu_torch.trees.coalescent import (
        per_pop_stats, per_pop_stats_dated,
    )
    from bpp_tpu_torch.trees.gtree import assign_populations
    _, eng = _engines(_dated_run(tmp_path, 6, zero=True))
    state = eng.init_state()
    state, _ = eng.chunk_step(state, 3)
    assert bool((state.gt.age[:, :state.gt.n_tips] == 0).all())
    pops = assign_populations(state.gt, state.sp, eng.ctx.tip_pop)
    a = per_pop_stats_dated(state.gt, state.sp, pops, eng.ctx.n_seq)
    b = per_pop_stats(state.gt, state.sp, pops, eng.ctx.n_seq)
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
    np.testing.assert_array_equal(a[2].numpy(), b[2].numpy())
    np.testing.assert_allclose(a[1].numpy(), b[1].numpy(), rtol=1e-12,
                               atol=1e-15)


@pytest.mark.parametrize("integrated", [False, True],
                         ids=["theta", "theta-integrated"])
def test_tip_ages_track_mubar(tmp_path, integrated):
    c = _dated_run(tmp_path, 5, thetaprior="invgamma 3 0.03 int"
                   if integrated else "3 0.03")
    _, eng = _engines(c, seed=21)
    state = eng.init_state()
    state, _ = eng.chunk_step(state, 2)
    gen = torch.Generator().manual_seed(5)
    T = state.gt.n_tips
    live = (torch.arange(T)[None, :] < eng.ctx.n_seq[:, None])
    m0 = float(state.mubar)
    accepted = 0
    for _ in range(6):
        state, (_, a) = clock_moves.tipdate_mubar_move(eng.ctx, eng.cfg,
                                                       state, gen)
        accepted += int(a)
        want = torch.where(live, eng.ctx.tip_dates * state.mubar,
                           torch.zeros_like(eng.ctx.tip_dates))
        assert bool((state.gt.age[:, :T] == want).all())
        logl = eng._logl_fn(state.gt, state.subst, state.sp, state.clock)
        logpr, cc, t2 = eng._logpr_fn(state.gt, state.sp,
                                      state.subst.heredity)
        np.testing.assert_allclose(state.logl.numpy(), logl.numpy(),
                                   rtol=1e-10, atol=1e-9)
        np.testing.assert_allclose(state.logpr.numpy(), logpr.numpy(),
                                   rtol=1e-10, atol=1e-9)
        if integrated:
            np.testing.assert_array_equal(state.coal.numpy(), cc.numpy())
            np.testing.assert_allclose(state.t2h.numpy(), t2.numpy(),
                                       rtol=1e-12, atol=1e-15)
    assert accepted > 0 and float(state.mubar) != m0


def test_mubar_prior_recovery_usedata0(tmp_path):
    c = _dated_run(tmp_path, 2, usedata=0, nsample=2500)
    _, eng = _engines(c, seed=3)
    log = eng.run_mcmc(progress_every=0)
    x = np.asarray(log.mubar)
    assert len(x) == 2500
    n = len(x) // 20 * 20
    for power, want in ((1, A_MU / B_MU),
                        (2, A_MU * (A_MU + 1) / B_MU ** 2)):
        y = x[:n] ** power
        se = y.reshape(20, -1).mean(1).std(ddof=1) / np.sqrt(20)
        assert abs(y.mean() - want) < 4 * se, (power, y.mean(), want, se)


GUARDS = [
    ("clock = 2 10 100 5", NotImplementedError, "strict molecular clock"),
    ("locusrate = 1 10 10 5 iid", ValueError, "locusrate = 3"),
    ("thetamodel = linked-all\nthetaprior = invgamma 3 0.03 int",
     NotImplementedError, "thetamodel cannot be combined"),
]


@pytest.mark.parametrize("line,exc,match", GUARDS,
                         ids=["relaxed-clock", "locusrate-1", "linked-int"])
def test_reference_guards_raise_as_in_bpp_tpu(ctl, tmp_path, line, exc,
                                              match):
    """bpp_tpu's tip-dating and linked-theta guards, in the port."""
    from bpp_tpu.io.ctl import parse_ctl as parse_jax
    from bpp_tpu.loader import load_run as load_jax
    from bpp_tpu.mcmc.driver import Engine as EngineJ
    from bpp_tpu_torch.io.ctl import parse_ctl
    from bpp_tpu_torch.loader import load_run
    from bpp_tpu_torch.mcmc.driver import Engine
    keys = {ln.split("=")[0].strip() for ln in line.splitlines()}
    with open(ctl) as fh:
        text = "".join(ln for ln in fh
                       if ln.split("=")[0].strip() not in keys)
    other = tmp_path / "other.ctl"
    other.write_text(text + line + "\n")
    with pytest.raises(exc, match=match):
        EngineJ(load_jax(parse_jax(str(other))))
    with pytest.raises(exc, match=match):
        Engine(load_run(parse_ctl(str(other))), device="cpu")
