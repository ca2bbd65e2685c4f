"""``chains = K`` on the batched route (``Engine._step_batched``) for tip
dating, morphological traits and ``usedata = 2``, with the combinations
``bpp_tpu``'s ``_run_multichain`` takes: linked thetas x traits and
MSC-M x traits (MSC-M x tip dating both packages refuse).

* (a) Three batched iterations against K one-chain ``_step`` runs from
  cloned generators: every state leaf within 1e-12, move statistics and
  trace rows equal, the generators where the one-chain steps leave
  theirs.  Cases: tip dating with integrated thetas (K3 over the chains:
  the age move's 2 blocks and 3 SPR rounds, each one call over [K, L,
  4H + 4]; the tip-dating mu_bar move accepted), tip dating with
  estimated thetas, continuous and discrete traits (the trait-rate move
  accepted), linked-inner thetas x traits, MSC-M x traits and
  ``usedata = 2`` (gene trees and taus kept, thetas moving).
* (b) The batched densities of K stacked states against
  ``jax.jit(jax.vmap)`` of ``bpp_tpu``'s on the same states (the K
  initial states, one ``init_state`` at a time, and the K states after
  three batched iterations), rtol 1e-10: the dated MSC density with its
  coalescent counts (exact) and waiting sums, the dated likelihood
  (``bpp_tpu``'s XLA pass) and the trait log-likelihoods.
* (c) No op of these steps falls back to vmap's for-loop.
* (d) ``run_mcmc_multi`` on the batched route against the per-chain
  route (samples, mu_bar among them, equal), and the CLI's resumed
  batched dated run (with its checkpoint, as main 5's) writes its chain
  files byte for byte.
"""

import dataclasses
import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_chain_batch_msci import (
    _clone_gens, _engine, _gens, _jax_engine, _leaves_close,
)

from bpp_tpu_torch.mcmc.graph import flatten, unflatten
from bpp_tpu_torch.testing import MIG_RUN, MIG_SIM

torch.set_num_threads(1)     # tiny tensors; the suite runs in parallel

K = 3
N_LOCI = 4
ITERS = 3
A_MU, B_MU = 10.0, 10000.0
DATED = (f"locusrate = 3 {A_MU} {B_MU}",)
INT = "invgamma 3 0.03 int"
CASES = {
    "dated_int": dict(dated=True, thetaprior=INT),
    "dated": dict(dated=True),
    "traits": dict(traits=True),
    "linked_traits": dict(traits=True,
                          priors=("thetamodel = linked-inner",)),
    "mig_traits": dict(traits=True, sim_model="model = 0\n" + MIG_SIM,
                       priors=(MIG_RUN,)),
    "usedata2": dict(usedata=2),
}
# the moves each case must accept (state.MV_* names)
MOVED = {"dated_int": ("MV_MUBAR", "MV_GTAGE"),
         "dated": ("MV_MUBAR", "MV_THETA"),
         "traits": ("MV_TRAIT", "MV_THETA"),
         "linked_traits": ("MV_TRAIT", "MV_THETA"),
         "mig_traits": ("MV_TRAIT", "MV_THETA"),
         "usedata2": ("MV_THETA",)}


def _write_dates(directory):
    rng = np.random.default_rng(8)
    dates = directory / "dates.txt"
    dates.write_text("".join(
        f"{s}{k} {round(float(rng.uniform(0, 1)), 3)}\n"
        for s in "abcd" for k in (1, 2)))
    return dates


def _ctl(directory, n_loci=N_LOCI, extra=(), dated=False, traits=False,
         **kw):
    """A simulated run of ((A,B),(C,D)), 2 individuals a species (its
    datefile or traitfile written beside it); returns the control
    file."""
    from bpp_tpu_torch.testing import write_simulated_run, write_trait_file
    priors = tuple(kw.pop("priors", ())) + tuple(extra)
    if dated:
        priors += (f"datefile = {_write_dates(directory)}",) + DATED
    if traits:
        write_trait_file(directory / "traits.txt")
        priors += (f"traitfile = {directory / 'traits.txt'}",)
    kw.setdefault("n_sites", 60)
    return write_simulated_run(directory, n_loci, priors=priors, **kw)


@pytest.fixture(scope="module")
def ctls(tmp_path_factory):
    return {name: _ctl(tmp_path_factory.mktemp(name), **kw)
            for name, kw in CASES.items()}


_RUNS = {}


def _batched(ctls, case):
    """(engine, the K initial states, the generators' initial states, the
    generators after the run, the batched (state, stats, trace) after
    each of ITERS iterations, the K3 calls' cols shapes), run once a
    module."""
    from bpp_tpu_torch.mcmc import notheta
    from bpp_tpu_torch.mcmc.driver import stack_states
    if case not in _RUNS:
        eng = _engine(ctls[case])
        states = eng.init_states(K)
        gens = _gens(eng)
        gens0 = _clone_gens(gens)
        stacked = stack_states(states)
        real, k3 = notheta.chain_accept, []

        def counted(a, b, cols, sums, H, margin=None):
            k3.append(tuple(cols.shape))
            return real(a, b, cols, sums, H, margin)

        notheta.chain_accept = counted
        try:
            out = []
            for _ in range(ITERS):
                stacked, stats = eng._step_batched(stacked, gens)
                out.append((stacked, stats, eng._trace_batched(stacked)))
        finally:
            notheta.chain_accept = real
        _RUNS[case] = (eng, states, gens0, gens, out, k3)
    return _RUNS[case]


@pytest.mark.parametrize("case", list(CASES))
def test_batched_step_equals_one_chain_steps(ctls, case):
    from bpp_tpu_torch.mcmc import state as state_mod
    from bpp_tpu_torch.mcmc.driver import chain_views
    eng, states, gens0, gens, batched, k3 = _batched(ctls, case)
    cfg = eng.cfg
    assert eng.chains_route == "batched", eng.chains_route_reason
    gens1 = _clone_gens(gens0)
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
    for name in MOVED[case]:
        mv = getattr(state_mod, name)
        assert int(acc[:, mv, 0].min()) > 0, (name, acc[:, mv])
        assert int(acc[:, mv, 1].sum()) > 0, (name, "never accepted")
    last, trace = batched[-1][0], batched[-1][2]
    first = batched[0][2]
    if cfg.theta_integrated:
        # K3 over the chains: the age move's 2 blocks and 3 SPR rounds,
        # each one call over [K, L, 4H + 4]
        assert len(k3) == 5 * ITERS and all(
            s[:2] == (K, N_LOCI) for s in k3), k3
    else:
        assert not k3
    if eng.ctx.tip_dates is not None:
        # every chain's tip ages are its dates times its own mu_bar
        T = states[0].gt.n_tips
        want = eng.ctx.tip_dates[None] * last.mubar[:, None, None]
        tip = torch.arange(T)[None, :] < eng.ctx.n_seq[:, None]
        np.testing.assert_allclose(
            last.gt.age[:, :, :T].numpy(),
            torch.where(tip[None], want, torch.zeros_like(want)).numpy(),
            rtol=1e-12)
        assert not torch.equal(trace["mubar"], first["mubar"])
    if eng.ctx.has_traits:
        # the cached trait logl is a fresh evaluation's, in every chain
        from bpp_tpu_torch.mcmc.moves import _trait_eval
        for st in chain_views(last, K):
            fresh = _trait_eval(eng.ctx, st.sp, st.sp.tau, st.trait.brate)
            np.testing.assert_allclose(st.trait.logl.numpy(), fresh.numpy(),
                                       rtol=1e-12)
        assert not torch.equal(last.trait.brate[0], last.trait.brate[1])
    if cfg.linked_theta:
        link = eng.ctx.theta_link
        assert torch.equal(last.sp.theta, last.sp.theta[:, link])
    if cfg.usedata_fix_gtree:
        # the gene trees and taus stay at their start (method.c:5490)
        for k, st in enumerate(states):
            view = chain_views(last, K)[k]
            assert torch.equal(view.gt.age, st.gt.age)
            assert torch.equal(view.gt.parent, st.gt.parent)
            assert torch.equal(view.sp.tau, st.sp.tau)
        assert not torch.equal(last.sp.theta, batched[0][0].sp.theta)


def _to_jax_chains(states):
    """bpp_tpu's stacked McmcState (gt, sp, subst) of the port's per-chain
    states."""
    from test_torch_mig import _jax_state
    return jax.tree.map(lambda *xs: jnp.stack(xs),
                        *[_jax_state(s) for s in states])


@pytest.mark.parametrize("case", ["dated_int", "dated", "traits", "usedata2"])
def test_batched_densities_match_bpp_tpu_vmap(ctls, case, monkeypatch):
    from bpp_tpu_torch.mcmc.driver import chain_views
    from bpp_tpu_torch.mcmc.state import make_logl_fn, make_logpr_fn
    from bpp_tpu_torch.testing import port_state
    # bpp_tpu's XLA pass (float64), read at construction and trace time
    monkeypatch.setenv("BPP_TPU_PALLAS", "0")
    engj = _jax_engine(ctls[case])
    eng, _, _, _, batched, _ = _batched(ctls, case)
    chains = []
    for k in range(K):
        engj.seed = 7 + 1000003 * k
        st = engj.init_state()
        chains.append(jax.tree.map(lambda x: jnp.array(np.array(x)), st))
    init_j = jax.tree.map(lambda *xs: jnp.stack(xs), *chains)
    init_p = port_state(init_j, eng.cfg)
    last = batched[-1][0]
    last_j = _to_jax_chains(chain_views(last, K))
    ctx = dataclasses.replace(eng.ctx, chains=K)
    logl_p, logpr_p = make_logl_fn(ctx, eng.cfg), make_logpr_fn(ctx)

    def port(spec, lv):
        st = unflatten(spec, iter(lv))
        return (logl_p(st.gt, st.subst, st.sp, st.clock),
                *logpr_p(st.gt, st.sp, st.subst.heredity))

    def jaxs(st):
        return (engj._logl_fn(st.gt, st.subst, st.sp, st.clock),
                *engj._logpr_fn(st.gt, st.sp, st.subst.heredity))

    mask = np.asarray(eng.ctx.locus_mask)
    for when, (st_p, st_j) in (("initial", (init_p, init_j)),
                               ("after 3", (last, last_j))):
        spec, leaves = flatten(st_p)
        got = torch.func.vmap(lambda lv: port(spec, lv))(leaves)
        want = jax.jit(jax.vmap(jaxs))(st_j)
        for what, x, y in zip(("logl", "logpr", "coal", "T2h"), got, want):
            x, y = x.numpy(), np.asarray(y)
            assert x.shape[0] == K, what
            if what == "coal":
                np.testing.assert_array_equal(x, y, err_msg=(when, what))
            else:
                assert np.isfinite(y[:, mask]).all(), (when, what)
                np.testing.assert_allclose(x[:, mask], y[:, mask],
                                           rtol=1e-10, atol=1e-13,
                                           err_msg=(when, what))
        assert not np.allclose(got[3][0].numpy(), got[3][1].numpy())
        if eng.ctx.has_traits:
            # the trait log-likelihoods of the K chains' taus and rates
            tau, brate = st_p.sp.tau, st_p.trait.brate
            got_t = torch.func.vmap(eng.ctx.trait_fn)(tau, brate).numpy()
            want_t = np.asarray(jax.jit(jax.vmap(engj.ctx.trait_fn))(
                jnp.asarray(tau.numpy()), jnp.asarray(brate.numpy())))
            np.testing.assert_allclose(got_t, want_t, rtol=1e-10,
                                       err_msg=when)
            np.testing.assert_allclose(got_t, st_p.trait.logl.numpy(),
                                       rtol=1e-10, err_msg=when)


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
            stacked, _ = eng._step_batched(stacked, gens)
            eng._trace_batched(stacked)
    finally:
        # vmap's default: the fallback is silent
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)


@pytest.mark.parametrize("case", ["dated_int", "traits"])
def test_run_mcmc_multi_batched_equals_per_chain(ctls, case):
    logs = {}
    for route in ("batched", "per-chain"):
        eng = _engine(ctls[case], seed=11)
        eng.chains_route = route
        eng.cfg = eng.cfg.replace(burnin=2, nsample=2, sampfreq=2)
        logs[route] = eng.run_mcmc_multi(K, progress_every=0)
    for a, b in zip(logs["batched"], logs["per-chain"]):
        assert a.gen == b.gen and len(a.gen) == 2
        np.testing.assert_array_equal(np.asarray(a.lnL), np.asarray(b.lnL))
        np.testing.assert_array_equal(np.stack(a.theta), np.stack(b.theta))
        np.testing.assert_array_equal(np.stack(a.tau), np.stack(b.tau))
        np.testing.assert_array_equal(np.asarray(a.mubar),
                                      np.asarray(b.mubar))
        assert len(a.mubar) == (2 if case == "dated_int" else 0)
    assert logs["batched"][0].lnL != logs["batched"][1].lnL


def test_cli_batched_dated_resume_is_byte_identical(tmp_path, capsys):
    from bpp_tpu_torch import cli
    ctl = _ctl(tmp_path, n_loci=3, dated=True, thetaprior=INT, nsample=5,
               burnin=2, extra=(f"chains = {K}", "checkpoint = 4 0"))
    assert cli.main(["--cfile", ctl, "--device", "cpu"]) == 0
    assert f"chains = {K}: batched" in capsys.readouterr().err
    files = [tmp_path / "out.mcmc.txt"] + [tmp_path / f"out.c{c}.mcmc.txt"
                                           for c in range(2, K + 1)]
    whole = [f.read_bytes() for f in files]
    for f in files:
        head = f.read_text().splitlines()[0].split("\t")
        assert "mu_bar" in head and not any(h.startswith("theta")
                                            for h in head), head
        shutil.move(f, tmp_path / (f.name + ".whole"))
    assert cli.main(["--resume", str(tmp_path / "out.chk.npz"), "--device",
                     "cpu", "--quiet"]) == 0
    assert [f.read_bytes() for f in files] == whole


def test_mig_tip_dating_refused_as_bpp_tpu(tmp_path):
    """MSC-M x tip dating: both packages refuse it, with or without
    chains, so it takes no route."""
    from bpp_tpu.loader import load_run_from_ctl as load_j
    from bpp_tpu.mcmc.driver import Engine as EJ
    from bpp_tpu_torch.loader import load_run_from_ctl as load_p
    from bpp_tpu_torch.mcmc.driver import Engine as EP
    ctl = _ctl(tmp_path, n_loci=2, dated=True,
               sim_model="model = 0\n" + MIG_SIM,
               priors=(MIG_RUN, f"chains = {K}"))
    with pytest.raises(NotImplementedError) as ej:
        EJ(load_j(ctl), seed=1)
    with pytest.raises(NotImplementedError) as ep:
        EP(load_p(ctl), seed=1, device="cpu")
    assert str(ep.value) == str(ej.value)
