"""``chains = K`` on the batched route (``Engine._step_batched``) for A10's
rj move, integrated thetas and the Gamma-Dirichlet (0) and Dirichlet (3)
locus-rate priors, with kernels K3 and K4 over a chain axis.

* (a) Five batched iterations against K one-chain ``_step`` runs from
  cloned generators: every state leaf within 1e-12, move statistics and
  trace rows equal, the generators where the one-chain steps leave
  theirs.  Cases: A10 under both rjMCMC algorithms, A10 with integrated
  thetas, integrated thetas alone (with heredity scalars), Gamma-Dirichlet
  and Dirichlet locus rates, and A10 on diploid data (K2).  The A10 data
  and tau prior make the rj move accept within the five iterations.
* (b) The plain K3 (``notheta.chain_accept``) and K4
  (``clock_moves.gammadir_chain``) over ``[K, L, ...]`` equal K one-chain
  calls exactly, and take the decisions of ``jax.vmap`` of ``bpp_tpu``'s
  ``notheta.scan_accept`` and of its mu_i ``lax.scan``
  (``bpp_tpu/mcmc/clock_moves.py:212``) on the same uniforms, random and
  with every decision 1e-7..1e-6 from its threshold.
* (c) The batched integrated density against ``jax.vmap`` of
  ``bpp_tpu``'s ``notheta.total_integrated`` on the same K states, rtol
  1e-10.
* (d) One ``chain_accept`` / ``gammadir_chain`` call a move for all K
  chains.
* (e) No op of the extended step falls back to vmap's for-loop.
* (f) A10 prior recovery (usedata = 0) on the batched route: the pooled
  chains' frequencies of the three delimitations of a 3-species guide
  tree lie within 4 Monte Carlo standard errors (between chains) of
  ``prior_a11_masses``.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpp_tpu_torch.mcmc.graph import flatten

torch.set_num_threads(1)     # tiny tensors; the suite runs in parallel

K = 3
N_LOCI = 5
ITERS = 5
INT = "invgamma 3 0.03 int"
DELIMIT0 = "speciesdelimitation = 1 0 2"
DELIMIT1 = "speciesdelimitation = 1 1 2 1"
# the sister species split 1e-5 apart and a tau prior of mean 0.001, so
# that the rj move's joins and splits are accepted within a few iterations
SHALLOW = ("((A #0.01, B #0.01) :0.00001 #0.01, (C #0.01, D #0.01) :0.00001 "
           "#0.01) :0.02 #0.01")
A10 = dict(sim_tree=SHALLOW, tauprior="3 0.002")
# engine seeds at which every A10 case accepts an rj move in the five
# iterations
SEEDS = {"a10-int": 14, "a10-diploid": 14}
CASES = {
    "a10-rj0": dict(A10, priors=(DELIMIT0,)),
    "a10-rj1": dict(A10, priors=(DELIMIT1,)),
    "a10-int": dict(A10, thetaprior=INT, priors=(DELIMIT0,)),
    "int": dict(thetaprior=INT, priors=("heredity = 1 4 4",)),
    "gammadir": dict(priors=("locusrate = 1 10 10 5",)),
    "dirichlet": dict(priors=("locusrate = 1 10 10 5 dir",)),
    "a10-diploid": dict(A10, n_sites=80, seqs=(1, 1, 2, 2),
                        diploid=(1, 1, 0, 0), model="HKY",
                        priors=(DELIMIT0,)),
}


@pytest.fixture(scope="module")
def ctls(tmp_path_factory):
    from bpp_tpu_torch.testing import write_simulated_run
    out = {}
    for name, kw in CASES.items():
        kw = dict(kw)
        kw.setdefault("n_sites", 60)
        out[name] = write_simulated_run(tmp_path_factory.mktemp(name),
                                        N_LOCI, **kw)
    return out


def _engine(ctl, seed=7):
    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.mcmc.driver import Engine
    run = load_run_from_ctl(ctl)
    run.cfg = run.cfg.replace(dtype="float64")
    return Engine(run, seed=seed, device="cpu")


def _gens(eng, k_chains=K):
    gens = [torch.Generator() for _ in range(k_chains)]
    for k, g in enumerate(gens):
        g.manual_seed(eng.chain_seed(k))
    return gens


def _clone_gens(gens):
    out = []
    for g in gens:
        c = torch.Generator()
        c.set_state(g.get_state())
        out.append(c)
    return out


def _leaves_close(a, b, what):
    _, la = flatten(a)
    _, lb = flatten(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape and x.dtype == y.dtype, what
        if x.dtype.is_floating_point:
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-12,
                                       atol=1e-12, err_msg=what)
        else:
            assert torch.equal(x, y), what


@pytest.mark.parametrize("case", list(CASES))
def test_batched_step_equals_one_chain_steps(ctls, case):
    from bpp_tpu_torch.mcmc.driver import chain_views, stack_states
    from bpp_tpu_torch.mcmc.state import MV_LRHT, MV_MUI, MV_RJ, MV_THETA
    eng = _engine(ctls[case], seed=SEEDS.get(case, 7))
    cfg = eng.cfg
    assert eng.chains_route == "batched", eng.chains_route_reason
    assert eng.ctx.route == ("K2" if case == "a10-diploid" else "K1")
    states = eng.init_states(K)
    gens = _gens(eng)
    gens1 = _clone_gens(gens)
    stacked = stack_states(states)
    batched = []
    for _ in range(ITERS):
        stacked, stats = eng._step_batched(stacked, gens)
        batched.append((stacked, stats, eng._trace_batched(stacked)))
    for k in range(K):
        st = states[k]
        eng.gen = gens1[k]
        for i in range(ITERS):
            st, stats = eng._step(st)
            bst, bstats, btrace = batched[i]
            _leaves_close(chain_views(bst, K)[k], st,
                          f"chain {k} iteration {i}")
            assert torch.equal(bstats[k], stats), (k, i)
            for key, v in eng._trace_of(st).items():
                assert torch.equal(btrace[key][k], v), (key, k, i)
        assert torch.equal(gens[k].get_state(), gens1[k].get_state())
    acc = sum(s for _, s, _ in batched)
    # each case's own move ran in every chain and was accepted in some
    if cfg.est_delimit:
        assert (acc[:, MV_RJ, 0] == ITERS).all()
        assert int(acc[:, MV_RJ, 1].sum()) > 0, "no rj move accepted"
    if cfg.est_locusrate == 1:
        mv = MV_LRHT if cfg.locusrate_prior == 3 else MV_MUI
        assert int(acc[:, mv, 1].sum()) > 0
    if cfg.theta_integrated:
        # no theta move; the chains carry their own coalescent caches
        assert int(acc[:, MV_THETA, 0].sum()) == 0
        assert stacked.coal.shape[0] == K


def _k3_inputs(rng, L, H, locus_mask):
    """One chain's integrated-theta accept-chain inputs (gene-tree-like
    proposals, as ``test_torch_notheta``'s): coal/t2/heredity old and new,
    a random dother and the proposing mask."""
    coal_o = rng.integers(0, 5, (L, H))
    t2_o = rng.gamma(2.0, 0.02, (L, H)) * (coal_o > 0)
    h_o = rng.uniform(0.5, 1.5, L)
    mask = (rng.random(L) < 0.8) & locus_mask
    coal_n = coal_o.copy()
    src = rng.integers(0, H, L)
    dst = (src + 1 + rng.integers(0, H - 1, L)) % H
    move = mask & (coal_n[np.arange(L), src] > 0)
    coal_n[np.arange(L)[move], src[move]] -= 1
    coal_n[np.arange(L)[move], dst[move]] += 1
    t2_n = np.where(mask[:, None], t2_o * rng.uniform(0.7, 1.4, (L, H)),
                    t2_o)
    dother = rng.normal(0.0, 1.0, L)
    return coal_o, t2_o, h_o, coal_n, t2_n, h_o, dother, mask


@pytest.mark.parametrize("regime", ["random", "edge"])
def test_plain_k3_over_chains_matches_bpp_tpu_vmap(ctls, regime):
    from test_torch_notheta import _edge_dother

    from bpp_tpu.mcmc.notheta import scan_accept as sj
    from bpp_tpu_torch.mcmc import notheta
    cfg = _engine(ctls["int"]).cfg
    a, b = cfg.thetaprior.alpha, cfg.thetaprior.beta
    rng = np.random.default_rng(31 if regime == "random" else 32)
    L, H = 61, 7
    locus_mask = np.ones(L, bool)
    locus_mask[-2:] = False
    keys = jax.random.split(jax.random.PRNGKey(5), K)
    chains, cols, sums = [], [], []
    for k in range(K):
        co, t2o, ho, cn, t2n, hn, dother, mask = _k3_inputs(
            rng, L, H, locus_mask)
        us = np.asarray(jax.random.uniform(keys[k], (L,)))
        K0, C0 = notheta.pop_sums(torch.as_tensor(co), torch.as_tensor(t2o),
                                  torch.as_tensor(ho),
                                  torch.as_tensor(locus_mask))
        dh = cn.sum(1) * np.log(2.0 / hn) - co.sum(1) * np.log(2.0 / ho)
        to, tn = t2o / ho[:, None], t2n / hn[:, None]
        if regime == "edge":
            dother = _edge_dother(a, b, K0.numpy(), C0.numpy(), co, cn, to,
                                  tn, dh, np.log(us), mask, rng)
        chains.append((dother, co, t2o, ho, cn, t2n, hn, mask))
        cols.append(np.concatenate([co, cn, to, tn, np.stack(
            [dother, dh, np.log(us), mask.astype(np.float64)], 1)], 1))
        sums.append(np.concatenate([K0.numpy(), C0.numpy()]))
    cols, sums = torch.as_tensor(np.stack(cols)), torch.as_tensor(
        np.stack(sums))
    got = notheta.chain_accept(a, b, cols, sums, H)
    assert got.shape == (K, L)
    for k in range(K):
        assert torch.equal(got[k], notheta.chain_accept(a, b, cols[k],
                                                        sums[k], H)), k
    stacked = [jnp.asarray(np.stack(x)) for x in zip(*chains)]
    want = np.asarray(jax.vmap(
        lambda key, dot, co, to, ho, cn, tn, hn, m: sj(
            key, cfg, dot, co, to, ho, cn, tn, hn, m,
            jnp.asarray(locus_mask)))(keys, *stacked))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < sum(int(c[-1].sum()) for c in chains)


@pytest.fixture(scope="module")
def gdir_scan(tmp_path_factory):
    """``bpp_tpu``'s mu_i move on a Gamma-Dirichlet chain of 40 loci under
    the prior, its ``lax.scan`` (clock_moves.py:212) caught as it runs:
    (the scan's body, its inputs, a_bar, a_i, b_bar)."""
    from test_torch_clock import _bpp_tpu_scan, _jax_engine

    from bpp_tpu.mcmc import clock_moves as cmj
    from bpp_tpu_torch.testing import write_simulated_run
    ctl = write_simulated_run(tmp_path_factory.mktemp("gdir40"), n_loci=40,
                              n_sites=40, usedata=0,
                              priors=("locusrate = 1 10 10 5",))
    engj = _jax_engine(ctl)
    cfg = engj.cfg
    with pytest.MonkeyPatch.context() as mp:
        _, body, _, xs, _ = _bpp_tpu_scan(engj, engj.init_state(),
                                          cmj.mui_move, 3, mp)
    return (body, [np.array(x) for x in xs], cfg.locusrate_mubar_a,
            cfg.locusrate_alpha, cfg.locusrate_mubar_b)


@pytest.mark.parametrize("regime", ["random", "edge"])
def test_plain_k4_over_chains_matches_bpp_tpu_vmap(gdir_scan, regime):
    from test_torch_clock import _edge_uniforms

    from bpp_tpu_torch.mcmc import clock_moves
    body, xs, a_bar, a_i, b_bar = gdir_scan
    mo, mn, dlog, dlo, dlr, u, mask = xs
    L = len(mo)
    rng = np.random.default_rng(41 if regime == "random" else 42)
    nl = float(mask.sum())
    chains = []
    for k in range(K):
        # chain k: its own proposals and uniforms about the same rates
        mok = mo * rng.uniform(0.8, 1.25, L)
        mnk = mok * np.exp(rng.normal(0.0, 0.3, L))
        dlk = np.log(mnk / mok)
        dlok = rng.normal(0.0, 0.5, L)
        uk = rng.random(L)
        if regime == "edge":
            lratio = (a_i - 1.0) * np.log(mnk / mok) + dlk + dlok + dlr
            uk = _edge_uniforms(mok, mnk, lratio, mask, a_bar, a_i * nl,
                                b_bar / nl, rng)
        chains.append((mok, mnk, dlk, dlok, dlr, uk, mask))
    terms = torch.as_tensor(np.stack([np.stack(
        [c[0], c[1], c[2], c[3] + c[4], c[5], c[6].astype(np.float64)], 1)
        for c in chains]))
    got = clock_moves.gammadir_chain(terms, a_bar, b_bar, a_i)
    assert got.shape == (K, L)
    for k in range(K):
        assert torch.equal(got[k], clock_moves.gammadir_chain(
            terms[k], a_bar, b_bar, a_i)), k
    sums0 = jnp.asarray([float(c[0][mask].sum()) for c in chains])
    stacked = tuple(jnp.asarray(np.stack(x)) for x in zip(*chains))
    _, want = jax.vmap(lambda s, x: jax.lax.scan(body, s, x))(sums0, stacked)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(want.sum()) < K * int(mask.sum())


def test_batched_integrated_density_matches_bpp_tpu_vmap(ctls):
    from bpp_tpu.mcmc.notheta import total_integrated as tij
    from bpp_tpu_torch.mcmc import notheta
    from bpp_tpu_torch.mcmc.driver import stack_states
    eng = _engine(ctls["int"])
    cfg, mask = eng.cfg, eng.ctx.locus_mask
    st = stack_states(eng.init_states(K))
    got = torch.func.vmap(lambda c, t, h: notheta.total_integrated(
        cfg, c, t, h, mask))(st.coal, st.t2h, st.subst.heredity)
    want = jax.vmap(lambda c, t, h: tij(cfg, c, t, h, jnp.asarray(
        mask.numpy())))(*(jnp.asarray(x.numpy()) for x in (
            st.coal, st.t2h, st.subst.heredity)))
    assert got.shape == (K,) and np.isfinite(np.asarray(want)).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10)
    assert len(set(got.tolist())) == K


# the accept-chain calls of one batched iteration: integrated thetas
# (ages 2 phases + SPR 3 + heredity 1; A10's rj move takes the integrated
# density's delta, no chain), Gamma-Dirichlet mu_i (one)
CALLS = {"int": ("K3", 6), "a10-int": ("K3", 5), "gammadir": ("K4", 1)}


@pytest.mark.parametrize("case", list(CALLS))
def test_one_accept_chain_call_a_move_for_all_chains(ctls, case,
                                                     monkeypatch):
    from bpp_tpu_torch.mcmc import clock_moves, notheta
    from bpp_tpu_torch.mcmc.driver import stack_states
    eng = _engine(ctls[case])
    kernel, n = CALLS[case]
    mod, name = ((notheta, "chain_accept") if kernel == "K3"
                 else (clock_moves, "gammadir_chain"))
    real = getattr(mod, name)
    calls = []

    def counted(*a, **kw):
        rows = kw["cols"] if kernel == "K3" else kw["terms"]
        calls.append(tuple(rows.shape))
        return real(*a, **kw)

    stacked = stack_states(eng.init_states(K))
    monkeypatch.setattr(mod, name, counted)
    eng._step_batched(stacked, _gens(eng))
    assert len(calls) == n, calls
    assert all(s[:2] == (K, N_LOCI) for s in calls), calls


@pytest.mark.parametrize("case", list(CASES))
def test_no_vmap_loop_fallback(ctls, case):
    from bpp_tpu_torch.mcmc.driver import stack_states
    eng = _engine(ctls[case])
    stacked = stack_states(eng.init_states(K))
    gens = _gens(eng)
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            # the check is live: an op with no batching rule raises
            with pytest.raises(UserWarning, match="batching rule"):
                torch.func.vmap(lambda x: torch.histc(x, 4))(
                    torch.rand(K, 6, dtype=torch.float64))
            for _ in range(2):
                stacked, _ = eng._step_batched(stacked, gens)
            eng._trace_batched(stacked)
    finally:
        # vmap's default: the fallback is silent
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)


def test_a10_prior_recovery_on_the_batched_route(tmp_path):
    """6 chains of 200 batched iterations under the prior (3 species, one
    locus), pooled after 20; standard errors between the chains."""
    from test_torch_stree import write_dummy

    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.mcmc.driver import (
        Engine, prior_a11_masses, stack_states,
    )
    from bpp_tpu_torch.mcmc.state import MV_RJ
    n_chains = 6
    run = load_run_from_ctl(write_dummy(tmp_path, "ABC", "((A,B),C)",
                                        extra=DELIMIT0))
    run.cfg = run.cfg.replace(dtype="float64")
    eng = Engine(run, seed=30, device="cpu")
    assert eng.chains_route == "batched", eng.chains_route_reason
    st = stack_states(eng.init_states(n_chains))
    gens = _gens(eng, n_chains)
    n_sp, n_acc = [], 0
    for _ in range(200):
        st, stats = eng._step_batched(st, gens)
        n_acc += int(stats[:, MV_RJ, 1].sum())
        n_sp.append(((st.sp.tau[:, 3:] > 0).sum(1) + 1).numpy())
    assert n_acc > 0
    n_sp = np.stack(n_sp[20:], 1)                     # [chains, iterations]
    freqs = np.stack([(n_sp == k).mean(1) for k in (1, 2, 3)], 1)
    se = freqs.std(0, ddof=1) / np.sqrt(n_chains)
    want = prior_a11_masses(3, 1)
    assert (np.abs(freqs.mean(0) - want) < 4 * se).all(), (freqs.mean(0),
                                                           se, want)
