"""The port's substitution, locus-rate and heredity moves.

* ``init_state`` equals ``bpp_tpu``'s on the same control file and seed
  for HKY+G4, TN93 and GTR+G4 with locus rates (hierarchical, Dirichlet,
  Gamma-Dirichlet prior) and heredity scalars: freqs, qrates, kappas,
  rates, mu, heredity, the eigensystem, the rate hierarchy, logl and
  logpr, to float64 roundoff (rtol 1e-9; the eigenvectors are compared
  through the sign-free projectors T[:, k] Tinv[k, :]).
* After each new move the cached logl and logpr equal a fresh evaluation.
* With ``usedata = 0`` each move recovers its prior: first and second
  moments within 4 Monte Carlo standard errors (20 batch means) of
  - the uniform Dirichlet on freqs and Dirichlet(2,4,2,2,4,2) on qrates,
  - Gamma(a, b) on alpha,
  - the locus-rate priors 0 (Gamma-Dirichlet), 1 (hierarchical, with the
    mubar move) and 3 (Dirichlet),
  - Gamma(a, b) on the heredity scalars (inside the full step, because
    heredity enters the gene trees' MSC density).
* ``discrete_gamma_rates`` in float32 against ``bpp_tpu``'s in float64
  for alpha over 0.05-50 (rtol 2e-3, atol 1e-5 on mean-1 rates).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpp_tpu_torch.mcmc import clock_moves, subst_moves

torch.set_num_threads(1)     # tiny tensors; the suite runs in parallel

SIM_HKY = ("model = 3\nkappa = 2\nbasefreqs = 0.3 0.2 0.2 0.3\n"
           "locusrate = 1 5")
CONFIGS = {
    "HKY": ("HKY", ("alphaprior = 1 1 4", "locusrate = 1 10 10 5 iid",
                    "heredity = 1 4 4")),
    "TN93": ("TN93", ("locusrate = 1 0 0 5", "heredity = 1 4 4")),
    "GTR": ("GTR", ("alphaprior = 2 4 4", "locusrate = 1 10 10 5",
                    "heredity = 1 4 4")),
}


@pytest.fixture(scope="module")
def ctls(tmp_path_factory):
    """One diploid/haploid dataset (diploid = 1 1 0 0), one control file
    per model configuration."""
    from bpp_tpu_torch.testing import write_simulated_run
    tmp = tmp_path_factory.mktemp("torchsubst")
    return {name: write_simulated_run(
        tmp, n_loci=6, n_sites=150, seqs=(1, 1, 2, 2), diploid=(1, 1, 0, 0),
        sim_model=SIM_HKY, job=name, model=model, priors=priors)
        for name, (model, priors) in CONFIGS.items()}


def _port_engine(ctl, seed=7):
    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.mcmc.driver import Engine
    run = load_run_from_ctl(ctl)
    run.cfg = run.cfg.replace(dtype="float64")
    return Engine(run, seed=seed, device="cpu")


def _projectors(T, Ti):
    T, Ti = np.asarray(T), np.asarray(Ti)
    return np.einsum("lik,lkj->lkij", T, Ti)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_init_state_matches_bpp_tpu(ctls, name):
    from bpp_tpu.loader import load_run_from_ctl as load_jax
    from bpp_tpu.mcmc.driver import Engine as EngineJ
    rj = load_jax(ctls[name])
    rj.cfg = rj.cfg.replace(dtype="float64")
    sj = EngineJ(rj, seed=7).init_state()
    eng = _port_engine(ctls[name])
    sp = eng.init_state()
    assert eng.cfg.locusrate_prior == {"HKY": 1, "TN93": 3, "GTR": 0}[name]

    def close(a, b, what):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-9,
                                   atol=1e-12, err_msg=what)

    for f in ("freqs", "kappa1", "kappa2", "qrates", "alpha", "rates", "mu",
              "heredity", "eigw"):
        close(getattr(sp.subst, f).numpy(), getattr(sj.subst, f), f)
    close(_projectors(sp.subst.eigT.numpy(), sp.subst.eigTi.numpy()),
          _projectors(sj.subst.eigT, sj.subst.eigTi), "eigensystem")
    if name == "GTR":
        assert float(sp.subst.eigT.abs().sum()) > 0
    close(sp.gt.age.numpy(), sj.gt.age, "gene-tree ages")
    close(sp.logl.numpy(), sj.logl, "logl")
    close(sp.logpr.numpy(), sj.logpr, "logpr")
    if name == "TN93":          # Dirichlet prior: no rate hierarchy
        assert sp.clock is None and sj.clock is None
    else:
        for f in ("brate", "nu", "mubar", "nubar", "lnrates"):
            close(getattr(sp.clock, f).numpy(), getattr(sj.clock, f), f)


def test_init_state_rates_and_scalars_from_files(tmp_path):
    """``locusrate = 2 file`` / ``heredity = 2 file``: fixed per-locus
    values, the rates normalized to mean 1, as in bpp_tpu."""
    from bpp_tpu.loader import load_run_from_ctl as load_jax
    from bpp_tpu.mcmc.driver import Engine as EngineJ
    from bpp_tpu_torch.testing import write_simulated_run
    rates = tmp_path / "rates.txt"
    rates.write_text("0.5 1.5 2.0 4.0\n")
    scalars = tmp_path / "scalars.txt"
    scalars.write_text("1.0 0.25 0.75 1.0\n")
    ctl = write_simulated_run(
        tmp_path, n_loci=4, n_sites=60,
        priors=(f"locusrate = 2 {rates}", f"heredity = 2 {scalars}"))
    rj = load_jax(ctl)
    rj.cfg = rj.cfg.replace(dtype="float64")
    sj = EngineJ(rj, seed=7).init_state()
    eng = _port_engine(ctl)
    sp = eng.init_state()
    np.testing.assert_allclose(sp.subst.mu.numpy(), [0.25, 0.75, 1.0, 2.0],
                               rtol=1e-12)
    np.testing.assert_array_equal(sp.subst.heredity.numpy(),
                                  [1.0, 0.25, 0.75, 1.0])
    for got, want in ((sp.subst.mu, sj.subst.mu), (sp.logl, sj.logl),
                      (sp.logpr, sj.logpr)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9)
    assert sp.clock is None
    # fixed values: no move touches them
    state, stats = eng.chunk_step(sp, 2)
    assert bool((state.subst.mu == sp.subst.mu).all())
    assert bool((state.subst.heredity == sp.subst.heredity).all())
    rates.write_text("0.5 1.5 2.0\n")
    with pytest.raises(ValueError, match="fewer rates"):
        eng.init_state()


def test_state_from_numpy_carries_subst_and_clock(ctls):
    from bpp_tpu.loader import load_run_from_ctl as load_jax
    from bpp_tpu.mcmc.driver import Engine as EngineJ
    from bpp_tpu_torch.convert import state_from_numpy
    rj = load_jax(ctls["GTR"])
    rj.cfg = rj.cfg.replace(dtype="float64")
    sj = EngineJ(rj, seed=9).init_state()

    def fields(nt):
        return {k: (None if v is None else np.asarray(v))
                for k, v in nt._asdict().items()}

    eng = _port_engine(ctls["GTR"])
    st = state_from_numpy({"gt": fields(sj.gt), "sp": fields(sj.sp),
                           "subst": fields(sj.subst),
                           "clock": fields(sj.clock)}, cfg=eng.cfg)
    np.testing.assert_array_equal(st.subst.qrates.numpy(),
                                  np.asarray(sj.subst.qrates))
    np.testing.assert_array_equal(st.clock.nu.numpy(),
                                  np.asarray(sj.clock.nu))
    logl = eng._logl_fn(st.gt, st.subst, st.sp, st.clock)
    np.testing.assert_allclose(logl.numpy(), np.asarray(sj.logl), rtol=1e-9)


MOVES = [
    ("HKY", "freqs", subst_moves.freqs_move),
    ("HKY", "qrates", subst_moves.qrates_move),
    ("HKY", "alpha", subst_moves.alpha_move),
    ("HKY", "heredity", subst_moves.heredity_move),
    ("HKY", "mui", clock_moves.mui_move),
    ("HKY", "mubar", clock_moves.mubar_move),
    ("TN93", "freqs", subst_moves.freqs_move),
    ("TN93", "qrates", subst_moves.qrates_move),
    ("TN93", "locusrate", subst_moves.locusrate_move),
    ("GTR", "freqs", subst_moves.freqs_move),
    ("GTR", "qrates", subst_moves.qrates_move),
    ("GTR", "mui", clock_moves.mui_move),
]


@pytest.fixture(scope="module")
def warm(ctls):
    out = {}
    for name in CONFIGS:
        eng = _port_engine(ctls[name], seed=21)
        state = eng.init_state()
        state, _ = eng.chunk_step(state, 2)
        out[name] = (eng, state)
    return out


@pytest.mark.parametrize("name,move,fn", MOVES,
                         ids=[f"{n}-{m}" for n, m, _ in MOVES])
def test_move_keeps_caches_exact(warm, name, move, fn):
    eng, state = warm[name]
    gen = torch.Generator().manual_seed(5)
    before = state
    proposed = accepted = 0
    for _ in range(4):
        state, (p, a) = fn(eng.ctx, eng.cfg, state, gen)
        proposed += int(p)
        accepted += int(a)
        logl = eng._logl_fn(state.gt, state.subst, state.sp, state.clock)
        logpr, _, _ = eng._logpr_fn(state.gt, state.sp, state.subst.heredity)
        np.testing.assert_allclose(state.logl.numpy(), logl.numpy(),
                                   rtol=1e-10, atol=1e-9)
        np.testing.assert_allclose(state.logpr.numpy(), logpr.numpy(),
                                   rtol=1e-10, atol=1e-9)
    assert proposed > 0 and 0 < accepted <= proposed
    # the move changed its own parameter and left the gene trees alone
    assert bool((state.gt.age == before.gt.age).all())
    changed = {
        "freqs": lambda s: s.subst.freqs, "qrates": lambda s: s.subst.qrates,
        "alpha": lambda s: s.subst.alpha, "mui": lambda s: s.subst.mu,
        "locusrate": lambda s: s.subst.mu,
        "heredity": lambda s: s.subst.heredity,
        "mubar": lambda s: s.clock.mubar}[move]
    assert bool((changed(state) != changed(before)).any())
    if move in ("freqs", "qrates"):
        np.testing.assert_allclose(changed(state).sum(1).numpy(),
                                   changed(before).sum(1).numpy(),
                                   rtol=1e-12)
    if move == "locusrate":
        np.testing.assert_allclose(float(state.subst.mu.sum()),
                                   float(before.subst.mu.sum()), rtol=1e-12)


def _prior_engine(tmp_path, model, priors, n_loci=4, seed=3):
    from bpp_tpu_torch.testing import write_simulated_run
    ctl = write_simulated_run(tmp_path, n_loci=n_loci, n_sites=40, usedata=0,
                              model=model, priors=priors)
    eng = _port_engine(ctl, seed=seed)
    return eng, eng.init_state()


def _check_moments(x, mean, second, what, n_batches=20):
    """First and second moments of the draws ``x [n, ...]`` within 4
    batch-means standard errors of ``mean`` and ``second``."""
    x = np.asarray(x, np.float64)
    n = len(x) // n_batches * n_batches
    for power, want in ((1, mean), (2, second)):
        y = x[:n] ** power
        b = y.reshape(n_batches, -1, *y.shape[1:]).mean(1)
        se = b.std(0, ddof=1) / np.sqrt(n_batches)
        got = y.mean(0)
        want = np.broadcast_to(np.asarray(want, np.float64), got.shape)
        assert (np.abs(got - want) < 4 * se).all(), (what, power, got, want,
                                                     se)


def _run_moves(eng, state, fns, n, read, burn=300, seed=11):
    gen = torch.Generator().manual_seed(seed)
    out = []
    for it in range(burn + n):
        for fn in fns:
            state, _ = fn(eng.ctx, eng.cfg, state, gen)
        if it >= burn:
            out.append(read(state).numpy().copy())
    return np.stack(out)


def test_prior_recovery_freqs_and_qrates(tmp_path):
    from bpp_tpu_torch.mcmc.state import FT_FREQS, FT_QRATES
    eng, state = _prior_engine(tmp_path, "GTR", ())
    # steps wide enough for the pair slides to mix within the run
    ft = state.finetune.clone()
    ft[FT_FREQS], ft[FT_QRATES] = 0.5, 1.0
    state = state._replace(finetune=ft)
    draws = _run_moves(
        eng, state, [subst_moves.freqs_move, subst_moves.qrates_move], 8000,
        lambda s: torch.cat([s.subst.freqs, s.subst.qrates], dim=1))
    f, q = draws[:, :, :4], draws[:, :, 4:]
    # uniform Dirichlet(1,1,1,1)
    _check_moments(f, 0.25, 0.25 * 0.75 / 5 + 0.0625, "freqs")
    a = np.asarray(subst_moves.GTR_DIR_ALPHA)
    m = a / a.sum()
    _check_moments(q, m[None, :], (m * (1 - m) / (a.sum() + 1) + m * m)[None],
                   "qrates")


def test_prior_recovery_qrates_tn93(tmp_path):
    eng, state = _prior_engine(tmp_path, "TN93", ())
    q = _run_moves(eng, state, [subst_moves.qrates_move], 5000,
                   lambda s: s.subst.qrates[:, :3])
    a = np.array([2.0, 4.0, 2.0])
    m = a / a.sum()
    _check_moments(q, m[None, :], (m * (1 - m) / (a.sum() + 1) + m * m)[None],
                   "qrates")
    kappa = _run_moves(eng, state, [subst_moves.qrates_move], 3,
                       lambda s: torch.stack(
                           [s.subst.kappa1 * s.subst.qrates[:, 2]
                            - s.subst.qrates[:, 0],
                            s.subst.kappa2 * s.subst.qrates[:, 2]
                            - s.subst.qrates[:, 1]]), burn=0)
    np.testing.assert_allclose(kappa, 0.0, atol=1e-12)


def test_prior_recovery_alpha(tmp_path):
    a, b = 3.0, 4.0
    eng, state = _prior_engine(tmp_path, "JC69", (f"alphaprior = {a} {b} 4",))
    x = _run_moves(eng, state, [subst_moves.alpha_move], 6000,
                   lambda s: s.subst.alpha)
    _check_moments(x, a / b, a * (a + 1) / b ** 2, "alpha")


def test_prior_recovery_locusrate_hierarchical(tmp_path):
    a, b, am = 8.0, 8.0, 5.0
    eng, state = _prior_engine(tmp_path, "JC69",
                               (f"locusrate = 1 {a} {b} {am} iid",))
    assert eng.cfg.locusrate_prior == 1
    x = _run_moves(eng, state, [clock_moves.mui_move, clock_moves.mubar_move],
                   8000, lambda s: torch.cat([s.clock.mubar[None],
                                              s.subst.mu]))
    # mubar ~ Gamma(a, b); mu_i | mubar ~ Gamma(am, am / mubar)
    m2 = a * (a + 1) / b ** 2
    _check_moments(x[:, 0], a / b, m2, "mubar")
    _check_moments(x[:, 1:], a / b, m2 * (am + 1) / am, "mu_i")


def test_prior_recovery_locusrate_gamma_dirichlet(tmp_path):
    a, b, am = 8.0, 8.0, 5.0
    eng, state = _prior_engine(tmp_path, "JC69",
                               (f"locusrate = 1 {a} {b} {am}",))
    assert eng.cfg.locusrate_prior == 0
    mu = _run_moves(eng, state, [clock_moves.mui_move], 8000,
                    lambda s: s.subst.mu)
    L = mu.shape[1]
    # the mean rate is Gamma(a, b); the shares are Dirichlet(am, ..., am)
    mean_rate = mu.mean(1)
    _check_moments(mean_rate, a / b, a * (a + 1) / b ** 2, "mean rate")
    share2 = (am + 1) / (L * (L * am + 1))
    _check_moments(mu, a / b, L * L * a * (a + 1) / b ** 2 * share2, "mu_i")


def test_prior_recovery_locusrate_dirichlet(tmp_path):
    am = 5.0
    eng, state = _prior_engine(tmp_path, "JC69", (f"locusrate = 1 0 0 {am}",))
    assert eng.cfg.locusrate_prior == 3
    mu = _run_moves(eng, state, [subst_moves.locusrate_move], 6000,
                    lambda s: s.subst.mu)
    L = mu.shape[1]
    np.testing.assert_allclose(mu.sum(1), L, rtol=1e-9)
    _check_moments(mu, 1.0, L * (am + 1) / (L * am + 1), "mu_i")


def test_prior_recovery_heredity_in_the_full_step(tmp_path):
    a, b = 4.0, 4.0
    eng, state = _prior_engine(tmp_path, "JC69", (f"heredity = 1 {a} {b}",),
                               n_loci=3)
    out = []
    for it in range(200 + 3000):
        state, _ = eng._step(state)
        if it >= 200:
            out.append(state.subst.heredity.numpy().copy())
    _check_moments(np.stack(out), a / b, a * (a + 1) / b ** 2, "heredity")


def test_discrete_gamma_rates_float32_over_the_slide_range():
    from bpp_tpu.core.gammarates import discrete_gamma_rates as dj
    from bpp_tpu_torch.core.gammarates import discrete_gamma_rates as dp
    alpha = np.exp(np.linspace(np.log(0.05), np.log(50.0), 40))
    got = dp(torch.as_tensor(alpha, dtype=torch.float32), 4).numpy()
    want = np.stack([np.asarray(dj(jnp.float64(a), 4)) for a in alpha])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got.mean(1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-5)
    got64 = dp(torch.as_tensor(alpha), 4).numpy()
    np.testing.assert_allclose(got64, want, rtol=1e-9, atol=1e-14)
    # shapes whose density at the Wilson-Hilferty start underflows float32:
    # Newton's divisor is floored at the dtype's smallest normal number
    for a in (1e-3, 500.0):
        edge = dp(torch.as_tensor([a], dtype=torch.float32), 4).numpy()
        assert np.isfinite(edge).all(), (a, edge)
        assert (edge >= 0).all() and (edge[:, -1] > 0).all(), (a, edge)
        np.testing.assert_allclose(edge.mean(1), 1.0, rtol=1e-4)
        np.testing.assert_allclose(
            dp(torch.as_tensor([a], dtype=torch.float64), 4).numpy(),
            np.asarray(dj(jnp.float64(a), 4))[None], rtol=1e-9, atol=1e-14)
