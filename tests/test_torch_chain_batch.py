"""``chains = K`` as one batched step (``Engine._step_batched``), the
port's counterpart of ``bpp_tpu``'s ``_chunk_multi``.

* (a) The batched likelihood and MSC density of K stacked states (each
  pruning pass one call over the chains, ``Ctx.chains``) against
  ``jax.vmap`` of ``bpp_tpu``'s on the same K states, float64: JC69 (K1)
  and the diploid HKY+G4 chain (K2 and ``reduce_root``).  Against
  ``bpp_tpu``'s float64 XLA pass rtol 1e-10; against its kernels K1/K2 in
  Pallas interpret mode (as test_kernel_consistency runs them on the CPU;
  they compute in float32) within that suite's 0.02 lnL a locus, the
  density rtol 1e-10 either way.
* (b) Five batched iterations against K one-chain ``_step`` runs from
  cloned generators: every state leaf within 1e-12, move statistics and
  trace rows equal; ``run_mcmc_multi``'s samples on the batched route
  (its captured-step buffers, run eagerly on the CPU) equal to the
  per-chain route's.
* (c) The plain K1 and K2 over ``[K, L, ...]`` arguments equal K calls on
  one chain's arguments exactly; one wrapper call a pass for all K.
* (d) ``driver.chain_route``: batched for the A00 configurations, A10,
  integrated thetas, every locus-rate prior, MSC-M (fixed and
  variable-rate routes, geneflow, A10 x MSC-M), MSC-I networks (BDI,
  integrated thetas, diploid data) and linked thetas (all three models,
  A10 x linked); per-chain for A11, GTR, relaxed clocks, tip dating,
  traits and usedata = 2, with migration, a network or linked thetas or
  without.
* (e) No op of the batched step falls back to vmap's for-loop: the step
  runs with that warning turned into an error (and the warning is shown
  to fire on an op that has no batching rule).
* A batched draw (``rng.ChainGens``) is chain k's draw from its own
  generator.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from bpp_tpu_torch.mcmc import rng
from bpp_tpu_torch.mcmc.graph import flatten, unflatten

torch.set_num_threads(1)     # tiny tensors; the suite runs in parallel

K = 3
N_LOCI = 5
JC = dict(n_sites=60)
DIPLOID = dict(n_sites=80, seqs=(1, 1, 2, 2), diploid=(1, 1, 0, 0),
               model="HKY", priors=("alphaprior = 1 1 4",
                                    "locusrate = 1 10 10 5 iid",
                                    "heredity = 1 4 4"))
KINDS = {"jc69": JC, "diploid": DIPLOID}


@pytest.fixture(scope="module")
def ctls(tmp_path_factory):
    from bpp_tpu_torch.testing import write_simulated_run
    out = {}
    for kind, kw in KINDS.items():
        d = tmp_path_factory.mktemp(kind)
        out[kind] = write_simulated_run(d, N_LOCI, **kw)
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


def _densities(eng, stacked):
    """The batched logl [K, L] and logpr [K, L] of a stacked state."""
    from bpp_tpu_torch.mcmc.state import make_logl_fn, make_logpr_fn
    ctx = dataclasses.replace(eng.ctx, chains=K)
    logl_fn, logpr_fn = make_logl_fn(ctx, eng.cfg), make_logpr_fn(ctx)
    spec, leaves = flatten(stacked)

    def one(lv):
        st = unflatten(spec, iter(lv))
        return (logl_fn(st.gt, st.subst, st.sp, st.clock),
                logpr_fn(st.gt, st.sp, st.subst.heredity)[0])

    return torch.func.vmap(one)(leaves)


@pytest.mark.parametrize("pallas", ["0", "interpret"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_batched_densities_match_jax_vmap(ctls, kind, pallas, monkeypatch):
    import jax
    import jax.numpy as jnp

    from bpp_tpu.loader import load_run_from_ctl as load_j
    from bpp_tpu.mcmc.driver import Engine as EJ
    from bpp_tpu_torch.testing import port_state

    # "interpret": bpp_tpu's kernels in interpret mode, as
    # test_kernel_consistency runs them on the CPU (read at construction
    # and at trace time); "0": its XLA pass
    monkeypatch.setenv("BPP_TPU_PALLAS", pallas)
    rj = load_j(ctls[kind])
    rj.cfg = rj.cfg.replace(dtype="float64")
    engj = EJ(rj, seed=7)
    kernel = pallas == "interpret"
    assert (engj.ctx.pack is not None) == (kernel and kind == "jc69")
    assert (engj.ctx.tips_am is not None) == (kernel and kind != "jc69")
    # the K chains one init_state at a time, each copied at once (bpp_tpu's
    # species arrays may alias the host tree the next chain rewrites;
    # ROADMAP Queue 3)
    chains = []
    for k in range(K):
        engj.seed = 7 + 1000003 * k
        st = engj.init_state()
        chains.append(jax.tree.map(lambda x: jnp.array(np.array(x)), st))
    stacked_j = jax.tree.map(lambda *xs: jnp.stack(xs), *chains)

    def dens(st):
        return (engj._logl_fn(st.gt, st.subst, st.sp, st.clock),
                engj._logpr_fn(st.gt, st.sp, st.subst.heredity)[0])

    want_l, want_p = jax.vmap(dens)(stacked_j)
    eng = _engine(ctls[kind])
    stacked = port_state(stacked_j, eng.cfg)
    assert stacked.gt.left.shape[0] == K and stacked.logl.shape == (K, N_LOCI)
    assert stacked.finetune.shape[0] == K
    # the cached densities came across with the stacked state
    np.testing.assert_array_equal(stacked.logpr.numpy(),
                                  np.asarray(stacked_j.logpr))
    got_l, got_p = _densities(eng, stacked)
    assert got_l.shape == (K, N_LOCI)
    mask = np.asarray(rj.batch.locus_mask)
    for got, want, tol in ((got_l, want_l, dict(rtol=0, atol=0.02) if kernel
                            else dict(rtol=1e-10)),
                           (got_p, want_p, dict(rtol=1e-10))):
        want = np.asarray(want)
        assert np.isfinite(want[:, mask]).all()
        np.testing.assert_allclose(got.numpy()[:, mask], want[:, mask],
                                   **tol)
    # the chains differ, so the comparison is of K distinct states
    assert not np.allclose(np.asarray(want_l)[0], np.asarray(want_l)[1])


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


@pytest.mark.parametrize("kind", list(KINDS))
def test_batched_step_equals_one_chain_steps(ctls, kind):
    from bpp_tpu_torch.mcmc.driver import chain_views, stack_states
    eng = _engine(ctls[kind])
    assert eng.chains_route == "batched"
    # the haploid data takes K1's route, the diploid K2's
    assert eng.ctx.route == ("K1" if kind == "jc69" else "K2")
    states = eng.init_states(K)
    gens = _gens(eng)
    gens1 = _clone_gens(gens)
    stacked = stack_states(states)
    batched = []
    for _ in range(5):
        stacked, stats = eng._step_batched(stacked, gens)
        batched.append((stacked, stats, eng._trace_batched(stacked)))
    assert batched[-1][1].shape == (K, 23, 2)
    for k in range(K):
        st = states[k]
        eng.gen = gens1[k]
        for i in range(5):
            st, stats = eng._step(st)
            bst, bstats, btrace = batched[i]
            _leaves_close(chain_views(bst, K)[k], st,
                          f"chain {k} iteration {i}")
            assert torch.equal(bstats[k], stats), (k, i)
            for key, v in eng._trace_of(st).items():
                assert torch.equal(btrace[key][k], v), (key, k, i)
        # the generators end where the one-chain steps leave theirs
        assert torch.equal(gens[k].get_state(), gens1[k].get_state())
    # a chain moves: its statistics count proposals and acceptances
    assert int(batched[-1][1][:, :, 1].sum()) > 0


@pytest.mark.parametrize("kind", list(KINDS))
def test_run_mcmc_multi_batched_equals_per_chain(ctls, kind):
    logs = {}
    for route in ("batched", "per-chain"):
        eng = _engine(ctls[kind], seed=11)
        eng.chains_route = route
        eng.cfg = eng.cfg.replace(burnin=8, nsample=4, sampfreq=2)
        logs[route] = eng.run_mcmc_multi(K, progress_every=0)
    for a, b in zip(logs["batched"], logs["per-chain"]):
        assert a.gen == b.gen and len(a.gen) == 4
        np.testing.assert_array_equal(np.asarray(a.lnL), np.asarray(b.lnL))
        np.testing.assert_array_equal(np.stack(a.theta), np.stack(b.theta))
        np.testing.assert_array_equal(np.stack(a.tau), np.stack(b.tau))
    assert logs["batched"][0].lnL != logs["batched"][1].lnL


@pytest.mark.parametrize("kind", list(KINDS))
def test_plain_kernels_over_a_chain_axis(ctls, kind):
    from bpp_tpu_torch.core import fels, pack
    from bpp_tpu_torch.mcmc.driver import stack_states
    from bpp_tpu_torch.mcmc.state import TREE_ARGS
    from bpp_tpu_torch.trees.gtree import inner_order
    eng = _engine(ctls[kind])
    ctx = eng.ctx
    states = eng.init_states(K)
    st = stack_states(states)
    C = st.subst.rates.shape[-1]

    def args(s):
        rk = torch.cat([s.subst.rates, s.subst.kappa1[..., None],
                        s.subst.kappa2[..., None]], dim=-1)
        order = (torch.stack([inner_order(x.gt) for x in states])
                 if s.gt.left.dim() == 3 else inner_order(s.gt))
        return (order, s.gt.left, s.gt.right, s.gt.parent, ctx.n_seq,
                s.gt.age, s.subst.mu, rk, s.subst.freqs, s.subst.eigw,
                s.subst.eigT, s.subst.eigTi, ctx.tip_partials)

    kw = dict(model=eng.cfg.model, n_cats=C)
    if ctx.res_map is None:
        got = pack.site_logl_packed_ref(*args(st), ctx.weights, **kw)
        want = [pack.site_logl_packed_ref(*args(s), ctx.weights, **kw)
                for s in states]
        fn, extra = pack.site_logl_packed, dict(weights=ctx.weights)
    else:
        got = fels.site_logl_fels_ref(*args(st), n_pat=ctx.n_pat, **kw)
        want = [fels.site_logl_fels_ref(*args(s), n_pat=ctx.n_pat, **kw)
                for s in states]
        fn, extra = fels.site_logl_fels, dict(n_pat=ctx.n_pat)
    assert got.shape[:2] == (K, N_LOCI)
    for k in range(K):
        assert torch.equal(got[k], want[k]), k
    # inside vmap, one wrapper call for all K chains, the same values
    calls = []

    def counted(**a):
        calls.append(a["age"].shape)
        return fn(**a)

    spec, leaves = flatten(st)

    def one(lv):
        s = unflatten(spec, iter(lv))
        tree = dict(zip(TREE_ARGS, args(s)[:-1] + (ctx.tip_partials,)),
                    blen=None)
        return pack.chain_pass(counted, dict(tree, **extra), **kw)

    via = torch.func.vmap(one)(leaves)
    assert calls == [(K, N_LOCI, st.gt.left.shape[-1])]
    assert torch.equal(via, got)


def test_one_kernel_call_a_pass_for_all_chains(ctls, monkeypatch):
    from bpp_tpu_torch.mcmc import state as state_mod
    from bpp_tpu_torch.mcmc.driver import stack_states
    eng = _engine(ctls["jc69"])
    calls = []
    real = state_mod.site_logl_packed

    def counted(*a, **kw):
        calls.append(kw["age"].shape)
        return real(*a, **kw)

    stacked = stack_states(eng.init_states(K))
    monkeypatch.setattr(state_mod, "site_logl_packed", counted)
    eng._step_batched(stacked, _gens(eng))
    # age 2 + SPR 3 + tau 2 + mixing 1, each one call over the 3 chains
    assert len(calls) == 8
    assert all(s[0] == K for s in calls)


def test_chain_draws_are_each_chains_own():
    gens = [torch.Generator().manual_seed(100 + k) for k in range(K)]
    refs = _clone_gens(gens)
    alpha = torch.tensor([[0.5, 2.0], [1.0, 3.0], [4.0, 0.2]],
                         dtype=torch.float64)

    def draws(i, a):
        g = rng.ChainGens(gens, i)
        return (rng.uniform(g, (4,), torch.float64, "cpu"),
                rng.randint(g, 7, (5,), "cpu"),
                rng.exponential(g, (3,), torch.float32, "cpu"),
                rng.bactrian(g, (2,), torch.float64, "cpu"),
                rng.gamma(g, a))

    before = rng.CHAIN_DRAWS
    got = torch.func.vmap(draws)(torch.arange(K), alpha)
    assert rng.CHAIN_DRAWS - before == 6      # bactrian draws twice
    for k, g in enumerate(refs):
        want = (rng.uniform(g, (4,), torch.float64, "cpu"),
                rng.randint(g, 7, (5,), "cpu"),
                rng.exponential(g, (3,), torch.float32, "cpu"),
                rng.bactrian(g, (2,), torch.float64, "cpu"),
                rng.gamma(g, alpha[k]))
        for x, y in zip(got, want):
            assert torch.equal(x[k], y), k
    with pytest.raises(RuntimeError, match="inside the batched step"):
        rng.uniform(rng.ChainGens(gens, torch.tensor(0)), (2,),
                    torch.float64, "cpu")


def test_chain_route_by_configuration(ctls, tmp_path):
    from test_torch_bdi import CTL as BDI_CTL

    from bpp_tpu_torch.config import Clock
    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.mcmc.driver import chain_route
    from bpp_tpu_torch.testing import (
        MIG_RUN, MIG_SIM, NET_GUIDE, NET_SIM_TREE, write_simulated_run,
    )
    eng = _engine(ctls["jc69"])
    cfg, run = eng.cfg, eng.run
    assert chain_route(cfg, run)[0] == "batched"
    assert _engine(ctls["diploid"]).chains_route == "batched"
    for model in ("HKY", "TN93", "K80"):
        assert chain_route(cfg.replace(model=type(cfg.model)[model]),
                           run)[0] == "batched"
    # A10 (the rj move on the guide tree), integrated thetas (K3 over the
    # chains), the Gamma-Dirichlet (K4) and Dirichlet locus-rate priors,
    # MSC-M (K5 over the chains: fixed routes, variable-rate routes,
    # geneflow, A10 x MSC-M), linked thetas, GTR, custom and amino-acid
    # models (a per-chain eigensystem), tip dating, traits and usedata = 2
    # take the batched step too
    batched = {
        "linked thetas": cfg.replace(linked_theta=1),
        "linked-inner thetas": cfg.replace(linked_theta=2),
        "A10 x linked thetas": cfg.replace(linked_theta=2,
                                           est_delimit=True),
        "A10": cfg.replace(est_delimit=True),
        "integrated thetas": cfg.replace(theta_integrated=True),
        "Gamma-Dirichlet locus rates": cfg.replace(est_locusrate=1,
                                                   locusrate_prior=0),
        "Dirichlet locus rates": cfg.replace(est_locusrate=1,
                                             locusrate_prior=3),
        "MSC-M": cfg.replace(migration=True),
        "MSC-M geneflow": cfg.replace(migration=True, geneflow=True),
        "A10 x MSC-M": cfg.replace(migration=True, est_delimit=True),
        "diploid MSC-M": cfg.replace(migration=True,
                                     model=type(cfg.model)["HKY"]),
        "GTR": cfg.replace(model=type(cfg.model)["GTR"]),
        "custom": cfg.replace(model=type(cfg.model)["CUSTOM"]),
        "WAG": cfg.replace(model=type(cfg.model)["WAG"]),
        "tip dating": cfg.replace(datefile="dates.txt"),
        "traits": cfg.replace(traitfile="traits.txt"),
        "usedata = 2": cfg.replace(usedata_fix_gtree=True),
        "MSC-M x custom": cfg.replace(migration=True,
                                      model=type(cfg.model)["CUSTOM"]),
        "MSC-M x tip dating": cfg.replace(migration=True,
                                          datefile="dates.txt"),
        "MSC-M x traits": cfg.replace(migration=True,
                                      traitfile="traits.txt"),
        "MSC-M x usedata = 2": cfg.replace(migration=True,
                                           usedata_fix_gtree=True),
        "linked thetas x tip dating": cfg.replace(linked_theta=1,
                                                  datefile="dates.txt"),
        "linked thetas x traits": cfg.replace(linked_theta=1,
                                              traitfile="traits.txt"),
    }
    for what, c in batched.items():
        assert chain_route(c, run)[0] == "batched", what
    # what both CLIs refuse under chains > 1 steps one chain after another
    per_chain = {
        "A11": cfg.replace(est_delimit=True, est_stree=True),
        "relaxed clock": cfg.replace(clock=Clock.IID),
        "A01": cfg.replace(est_stree=True),
        "MSC-M x relaxed clock": cfg.replace(migration=True,
                                             clock=Clock.IID),
    }
    for what, c in per_chain.items():
        route, why = chain_route(c, run)
        assert route == "per-chain", what
        assert why.endswith("one chain's step after another"), what
    for name in ("net", "mig", "gf"):
        (tmp_path / name).mkdir()
    net = write_simulated_run(tmp_path / "net", 2, n_sites=30,
                              sim_tree=NET_SIM_TREE, guide=NET_GUIDE,
                              priors=("phiprior = 1 1",))
    net_eng = _engine(net)
    assert net_eng.chains_route == "batched"
    # an MSC-I network with BDI, integrated thetas or diploid data, and
    # linked-msci thetas, batched; with model = custom per-chain
    bdi = tmp_path / "bdi.ctl"
    bdi.write_text(BDI_CTL.format(job=tmp_path / "bdi", nloci=2,
                                  nsample=2,
                                  extra="thetamodel = linked-msci"))
    bdi_run = load_run_from_ctl(str(bdi))
    assert bdi_run.stree.n_hybrids > 0 and bdi_run.stree.bdi is not None
    assert chain_route(bdi_run.cfg, bdi_run)[0] == "batched"
    ncfg, nrun = net_eng.cfg, net_eng.run
    for what, c in {
            "network, integrated thetas": ncfg.replace(
                theta_integrated=True),
            "diploid network": ncfg.replace(model=type(ncfg.model)["HKY"]),
            "network, linked-msci": ncfg.replace(linked_theta=3)}.items():
        assert chain_route(c, nrun)[0] == "batched", what
    assert chain_route(ncfg.replace(model=type(ncfg.model)["CUSTOM"]),
                       nrun)[0] == "batched"
    route, why = chain_route(ncfg.replace(clock=Clock.IID), nrun)
    assert route == "per-chain" and why.startswith("a relaxed clock"), why
    mig = write_simulated_run(tmp_path / "mig", 2, n_sites=30,
                              sim_model="model = 0\n" + MIG_SIM,
                              priors=(MIG_RUN,))
    assert _engine(mig).chains_route == "batched"
    gf = write_simulated_run(tmp_path / "gf", 2, n_sites=30,
                             sim_model="model = 0\n" + MIG_SIM,
                             priors=(MIG_RUN, "geneflow = 1"))
    assert _engine(gf).chains_route == "batched"


@pytest.mark.parametrize("kind", list(KINDS))
def test_no_vmap_loop_fallback(ctls, kind):
    from bpp_tpu_torch.mcmc.driver import stack_states
    eng = _engine(ctls[kind])
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
