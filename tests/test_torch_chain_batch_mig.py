"""``chains = K`` on the batched route (``Engine._step_batched``) for MSC-M:
fixed routes of constant and of variable rate, geneflow, A10 x MSC-M and
diploid data, with kernel K5 (the sim-SPR walk) over a chain axis.

* (a) Three batched iterations against K one-chain ``_step`` runs from
  cloned generators: every state leaf within 1e-12, move statistics and
  trace rows equal, the generators where the one-chain steps leave
  theirs.  Cases: fixed routes, variable-rate routes (``am``), geneflow,
  A10 x MSC-M, diploid MSC-M (K2) and Gamma-Dirichlet locus rates (K4).
  In every case a sim-SPR move that walks new migration events is
  accepted.
* (b) The batched MSC-M density of K stacked states against ``jax.vmap``
  of ``bpp_tpu``'s ``make_logpr_fn_mig`` on the same states: the K
  initial states, taken one ``init_state`` at a time, and the K states
  after three batched iterations (with migration events), rtol 1e-10.
* (c) The plain K5 over ``[K, L, ...]`` (``simspr_walk_chains`` on CPU
  tensors) equal to K one-chain ``simspr_walk_ref`` calls exactly, and
  each chain's walk equal to ``bpp_tpu``'s ``while_loop`` on the same
  inputs and draws (populations, outcomes and events exact, times to
  1e-12).
* (d) One ``simspr_walk`` call a sim-SPR round for all K chains: three an
  iteration, each ``[K, L, ...]``.
* (e) No op of the MSC-M step falls back to vmap's for-loop.
* (f) ``run_mcmc_multi`` on the batched route against the per-chain
  route: samples, the ``migM`` rows among them, equal; and the CLI's
  resumed batched run writes its chain files byte for byte.
"""

import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpp_tpu_torch.mcmc.graph import flatten, unflatten

torch.set_num_threads(1)     # tiny tensors; the suite runs in parallel

K = 3
N_LOCI = 5
ITERS = 3
# migration at M = 20 in the simulation and a Gamma(2, 0.1) route prior
# (mean 20), so that the walks carry events (as test_torch_mig's)
SIM = "model = 0\nmigration = 2\nA B 20\nB A 20"
ROUTES = "migration = 2\nA B 2 0.1\nB A 2 0.1"
CASES = {
    "fixed": dict(priors=(ROUTES,)),
    "am": dict(priors=("migration = 2\nA B 2 0.1 3\nB A 2 0.1 3",)),
    "geneflow": dict(priors=(ROUTES, "geneflow = 1")),
    "a10": dict(priors=(ROUTES, "speciesdelimitation = 1 0 2")),
    "diploid": dict(n_sites=80, seqs=(1, 1, 2, 2), diploid=(1, 1, 0, 0),
                    model="HKY", priors=(ROUTES, "heredity = 1 4 4")),
    "gammadir": dict(priors=(ROUTES, "locusrate = 1 10 10 5")),
}


@pytest.fixture(scope="module")
def ctls(tmp_path_factory):
    from bpp_tpu_torch.testing import write_simulated_run
    out = {}
    for name, kw in CASES.items():
        kw = dict(kw)
        kw.setdefault("n_sites", 60)
        out[name] = write_simulated_run(tmp_path_factory.mktemp(name),
                                        N_LOCI, sim_model=SIM, **kw)
    return out


def _engine(ctl, seed=7):
    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.mcmc.driver import Engine
    run = load_run_from_ctl(ctl)
    run.cfg = run.cfg.replace(dtype="float64")
    return Engine(run, seed=seed, device="cpu")


def _jax_engine(ctl, seed=7):
    from bpp_tpu.loader import load_run_from_ctl
    from bpp_tpu.mcmc.driver import Engine
    run = load_run_from_ctl(ctl)
    run.cfg = run.cfg.replace(dtype="float64")
    return Engine(run, seed=seed)


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


_RUNS = {}


def _batched(ctls, case):
    """(engine, the K initial states, the generators' initial states, the
    batched (state, stats, trace) after each of ITERS iterations), run
    once a module."""
    from bpp_tpu_torch.mcmc.driver import stack_states
    if case not in _RUNS:
        eng = _engine(ctls[case])
        states = eng.init_states(K)
        gens = _gens(eng)
        gens0 = _clone_gens(gens)
        stacked = stack_states(states)
        out = []
        for _ in range(ITERS):
            stacked, stats = eng._step_batched(stacked, gens)
            out.append((stacked, stats, eng._trace_batched(stacked)))
        _RUNS[case] = (eng, states, gens0, gens, out)
    return _RUNS[case]


def _new_events(old, new):
    """[L] loci of ``new`` whose gene tree changed and that hold a live
    event at a time ``old`` does not hold: a sim-SPR move that walked
    migration events and was accepted."""
    moved = ((new.gt.parent != old.gt.parent).any(1)
             | (new.gt.age != old.gt.age).any(1))
    fresh = ((new.mig.node >= 0)
             & (new.mig.time[:, :, None] != old.mig.time[:, None, :]).all(2))
    return moved & fresh.any(1)


@pytest.mark.parametrize("case", list(CASES))
def test_batched_step_equals_one_chain_steps(ctls, case, monkeypatch):
    from bpp_tpu_torch.mcmc import mig_moves
    from bpp_tpu_torch.mcmc.driver import chain_views
    from bpp_tpu_torch.mcmc.state import MV_GFRJ, MV_GTSPR, MV_MUI, MV_RJ
    eng, states, gens0, gens, batched = _batched(ctls, case)
    cfg = eng.cfg
    assert eng.chains_route == "batched", eng.chains_route_reason
    assert eng.ctx.route == ("K2" if case == "diploid" else "K1")
    walked = []
    real = mig_moves.spr_sim_move

    def watched(ctx, cfg, routes, state, gen):
        new, pa = real(ctx, cfg, routes, state, gen)
        walked.append(int(_new_events(state, new).sum()))
        return new, pa

    monkeypatch.setattr(mig_moves, "spr_sim_move", watched)
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
    # the equal steps accepted sim-SPR proposals with new events
    assert len(walked) == 3 * ITERS * K
    assert sum(walked) > 0, "no accepted sim-SPR move walked an event"
    acc = sum(s for _, s, _ in batched)
    assert (acc[:, MV_GTSPR, 0] == 3 * ITERS * N_LOCI).all()
    assert "migM" in batched[-1][2] and batched[-1][2]["migM"].shape[0] == K
    if cfg.est_delimit:
        assert (acc[:, MV_RJ, 0] == ITERS).all()
    if cfg.geneflow:
        assert (acc[:, MV_GFRJ, 0] == 2 * ITERS).all()
    if cfg.est_locusrate == 1:
        assert int(acc[:, MV_MUI, 1].sum()) > 0


@pytest.mark.parametrize("case", ["fixed", "am", "geneflow"])
def test_batched_mig_density_matches_bpp_tpu_vmap(ctls, case):
    from test_torch_mig import _jax_state

    from bpp_tpu.mcmc.mig_moves import make_logpr_fn_mig as logpr_j
    from bpp_tpu_torch.mcmc.driver import chain_views
    from bpp_tpu_torch.testing import port_state
    engj = _jax_engine(ctls[case])
    eng, _, _, _, batched = _batched(ctls, case)
    # the K initial states, one init_state at a time, each copied at once
    chains = []
    for k in range(K):
        engj.seed = 7 + 1000003 * k
        st = engj.init_state()
        chains.append(jax.tree.map(lambda x: jnp.array(np.array(x)), st))
    init_j = jax.tree.map(lambda *xs: jnp.stack(xs), *chains)
    init_p = port_state(init_j, eng.cfg)
    # and the K chains after the batched iterations
    last = batched[-1][0]
    last_j = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        _jax_state(s) for s in chain_views(last, K)])
    assert int((last.mig.node >= 0).sum()) > 0, "no migration event"
    fj = logpr_j(engj.ctx, engj.routes)

    def one(spec, lv):
        st = unflatten(spec, iter(lv))
        return eng._logpr_mig_fn(st.gt, st.sp, st.mig, st.subst.heredity)

    for st_p, st_j in ((init_p, init_j), (last, last_j)):
        spec, leaves = flatten(st_p)
        got = torch.func.vmap(lambda lv: one(spec, lv))(leaves)
        want = jax.jit(jax.vmap(fj))(st_j.gt, st_j.sp, st_j.mig,
                                     st_j.subst.heredity)
        mask = np.asarray(eng.ctx.locus_mask)
        for what, x, y in zip(("lp", "coal", "C2", "W", "mc", "pops"), got,
                              want):
            y = np.asarray(y)
            assert x.shape[0] == K, what
            if what in ("lp", "C2", "W"):
                assert np.isfinite(y[:, mask]).all(), what
                np.testing.assert_allclose(x.numpy(), y, rtol=1e-10,
                                           atol=1e-13, err_msg=what)
            else:
                np.testing.assert_array_equal(x.numpy(), y, err_msg=what)
        # K distinct states
        lp = got[0].numpy()
        assert not np.allclose(lp[0], lp[1])


@pytest.mark.parametrize("case", ["fixed", "geneflow"])
def test_plain_k5_over_chains_matches_bpp_tpu_walks(ctls, case,
                                                    monkeypatch):
    from test_torch_mig import _bpp_tpu_walk, _jax_state, _walk_uniforms

    from bpp_tpu_torch.mcmc.driver import chain_views
    from bpp_tpu_torch.mcmc.mig_moves import (
        WALK_PER_CHAIN, simspr_walk_chains, simspr_walk_ref,
    )
    engj = _jax_engine(ctls[case], seed=5)
    _, _, _, _, batched = _batched(ctls, case)
    views = chain_views(batched[-1][0], K)

    def t(x):
        a = torch.from_numpy(np.array(x))
        return a.to(torch.int64) if a.dtype == torch.int32 else a

    seen = {"coalesced": 0, "events": 0}
    for key in range(2):
        ones, carries = [], []
        for k in range(K):
            f, carry = _bpp_tpu_walk(engj, _jax_state(views[k]), 10 * key + k,
                                     monkeypatch)
            sp = f["sp"]
            tau, partau_f, si = t(f["tau"]), t(f["partau_f"]), t(f["si"])
            ones.append(dict(
                t_lo=t(f["t_lo"]), t_hi=t(f["t_hi"]), pop_lo=t(f["pop_lo"]),
                live_e=t(f["live_e"]), pptable=t(sp.pptable), tau=tau,
                partau_f=partau_f, theta=t(sp.theta), parent=t(sp.parent),
                si=si, ti=t(f["ti"]), d_lo=tau[si], d_hi=partau_f[si],
                route_M=t(f["route_M"]), heredity=t(f["heredity"]),
                t0=t(f["t0"]), p0=t(f["start_pop"]),
                is_valid=t(f["is_valid"]),
                unif=_walk_uniforms(f["ksim"], f["max_steps"], f["L"])))
            carries.append(carry)
            ME = f["ME"]
        stacked = {n: (torch.stack([o[n] for o in ones])
                       if n in WALK_PER_CHAIN else ones[0][n])
                   for n in ones[0]}
        got = simspr_walk_chains(**stacked, ME=ME)
        assert got[0].shape == (K, N_LOCI) and got[4].shape == (K, N_LOCI,
                                                                 ME)
        for k in range(K):
            one = simspr_walk_ref(**ones[k], ME=ME)
            for x, y in zip(got, one):
                assert torch.equal(x[k], y), (key, k)
            tj, pj, _, donej, failj, ntj, nsj, ndj, nnj, _ = carries[k]
            for what, a, b in (("p", pj, one[1]), ("done", donej, one[2]),
                               ("fail", failj, one[3]), ("ns", nsj, one[5]),
                               ("nd", ndj, one[6]), ("nn", nnj, one[7])):
                np.testing.assert_array_equal(
                    b.numpy(), np.asarray(a), err_msg=f"{what}, {key} {k}")
            for what, a, b in (("t", tj, one[0]), ("nt", ntj, one[4])):
                np.testing.assert_allclose(
                    b.numpy(), np.asarray(a), rtol=1e-12,
                    err_msg=f"{what}, {key} {k}")
            valid = ones[k]["is_valid"].numpy()
            seen["coalesced"] += int((np.asarray(donej) & valid).sum())
            seen["events"] += int(np.asarray(nnj)[valid].sum())
    assert seen["coalesced"] and seen["events"], seen


def test_one_walk_call_a_round_for_all_chains(ctls, monkeypatch):
    from bpp_tpu_torch.core import chains
    from bpp_tpu_torch.mcmc import mig_moves, rng
    from bpp_tpu_torch.mcmc.driver import stack_states
    eng = _engine(ctls["fixed"])
    real = mig_moves.simspr_walk_chains
    calls = []

    def counted(**kw):
        calls.append((tuple(kw["t_lo"].shape), tuple(kw["unif"].shape),
                      tuple(kw["si"].shape)))
        return real(**kw)

    stacked = stack_states(eng.init_states(K))
    monkeypatch.setattr(mig_moves, "simspr_walk_chains", counted)
    before = chains.LAUNCHES_SIMWALK, rng.CHAIN_DRAWS
    eng._step_batched(stacked, _gens(eng))
    assert len(calls) == 3, calls
    n_routes = eng.mig_routes.si.shape[0]
    for t_lo, unif, si in calls:
        assert t_lo[:2] == (K, N_LOCI)
        assert unif[:2] == (K, 3) and unif[-1] == N_LOCI
        assert si == (n_routes,)      # the route table: one copy
    # no launch on the CPU; the walks' uniforms one draw site a round
    assert chains.LAUNCHES_SIMWALK == before[0]
    assert rng.CHAIN_DRAWS > before[1]


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


@pytest.mark.parametrize("case", ["fixed", "geneflow"])
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
        assert len(a.migM) == 2
        np.testing.assert_array_equal(np.stack(a.migM), np.stack(b.migM))
    assert logs["batched"][0].lnL != logs["batched"][1].lnL


def test_cli_batched_resume_is_byte_identical(tmp_path, capsys):
    from bpp_tpu_torch import cli
    from bpp_tpu_torch.testing import write_simulated_run
    ctl = write_simulated_run(tmp_path, 4, n_sites=60, sim_model=SIM,
                              burnin=2, nsample=5,
                              priors=(ROUTES, "geneflow = 1",
                                      f"chains = {K}", "checkpoint = 3 0"))
    argv = ["--device", "cpu", "--quiet"]
    assert cli.main(["--cfile", ctl, "--device", "cpu"]) == 0
    assert f"chains = {K}: batched" in capsys.readouterr().err
    files = [tmp_path / "out.mcmc.txt"] + [tmp_path / f"out.c{c}.mcmc.txt"
                                           for c in range(2, K + 1)]
    whole = [f.read_bytes() for f in files]
    for f in files:
        head = f.read_text().splitlines()[0].split("\t")
        # a W: column a candidate route
        assert sum(h.startswith("W:") for h in head) > 2, head
        shutil.move(f, tmp_path / (f.name + ".whole"))
    assert cli.main(["--resume", str(tmp_path / "out.chk.npz"), *argv]) == 0
    assert [f.read_bytes() for f in files] == whole


def test_synthetic_walk_chains_share_a_route_table():
    """The chain-axis walks the card's K5 test takes
    (``testing.synthetic_walk_chains``): one route table, species tables
    and loci of each chain's own; the plain walk over the chain axis
    equals each chain's one-chain walk, and every chain's valid loci end
    done or failed."""
    from bpp_tpu_torch.mcmc.mig_moves import (
        simspr_walk_chains, simspr_walk_ref,
    )
    from bpp_tpu_torch.testing import synthetic_walk_chains
    C, L, E = 3, 40, 33
    args, per, kinds = synthetic_walk_chains(C, L, E, seed=5)
    assert args[0].shape == (C, L, E) and args[9].dim() == 1
    for a in per[1:]:
        assert torch.equal(a[9], per[0][9]) and torch.equal(a[10], per[0][10])
        assert not torch.equal(a[5], per[0][5])       # the taus
        assert not torch.equal(a[0], per[0][0])       # the sub-edges
    got = simspr_walk_chains(*args)
    for k in range(C):
        one = simspr_walk_ref(*per[k])
        for x, y in zip(got, one):
            assert torch.equal(x[k], y), k
        done, fail, valid = one[2], one[3], per[k][17]
        assert bool((done | fail)[valid].all())
        assert set(kinds[k].tolist()) == {0, 1, 2, 3}


@pytest.mark.parametrize("L", [1, 2, 3, 7, 1000])
def test_locus_sum_is_the_sum_in_a_fixed_order(L):
    """``moves.locus_sum``, the sum over loci the batched step takes where
    a reduction over an [L, X] tensor would round by its shape: the sum
    (float64, 1e-12), the same under vmap as chain by chain, and a
    column of a 2-D tensor summed as that column alone."""
    from bpp_tpu_torch.mcmc.moves import locus_sum
    gen = torch.Generator().manual_seed(L)
    x = torch.rand((K, L, 5), generator=gen, dtype=torch.float64) - 0.3
    got = torch.func.vmap(locus_sum)(x)
    for k in range(K):
        assert torch.equal(got[k], locus_sum(x[k]))
        np.testing.assert_allclose(got[k].numpy(), x[k].sum(0).numpy(),
                                   rtol=1e-12, atol=1e-13)
        # a column alone sums in the same order as within the block
        assert torch.equal(locus_sum(x[k, :, 0]), got[k][0])
