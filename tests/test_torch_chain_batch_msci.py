"""``chains = K`` on the batched route (``Engine._step_batched``) for MSC-I
networks (BDI among them) and linked thetas, and the sums over loci and
over owners these steps take in a fixed order.

* (a) Three batched iterations against K one-chain ``_step`` runs from
  cloned generators: every state leaf within 1e-12, move statistics and
  trace rows (``phi`` among them) equal, the generators where the
  one-chain steps leave theirs.  Cases: a network with estimated thetas,
  a network with integrated thetas (K3 over the chains through
  ``repath_move``'s ``notheta.scan_accept``), the BDI fixture with
  ``thetamodel = linked-msci``, a diploid network (K2), linked-all and
  linked-inner thetas on a tree, and A10 x linked-inner.  Each network
  case accepts repath and network tau moves; each linked case accepts
  theta moves and keeps every member at its owner's theta.
* (b) The batched MSC-I density of K stacked states against
  ``jax.jit(jax.vmap)`` of ``bpp_tpu``'s ``make_logpr_fn`` on the same
  states: the K initial states, taken one ``init_state`` at a time, and
  the K states after three batched iterations, rtol 1e-10.
* (c) No op of these steps falls back to vmap's for-loop.
* (d) ``run_mcmc_multi`` on the batched route against the per-chain
  route (samples, the ``phi`` rows among them, equal), and the CLI's
  resumed batched BDI run writes its chain files byte for byte.
* The fixed-order sums: ``msc_logprob_integrated``, ``notheta.pop_sums``
  and ``moves._pool_linked`` against ``bpp_tpu``'s counterparts to
  float64 roundoff, and each the same under ``vmap`` as chain by chain,
  bit for bit.
"""

import os
import shutil
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpp_tpu_torch.mcmc.graph import flatten, unflatten
from bpp_tpu_torch.testing import NET_GUIDE, NET_SIM_TREE

torch.set_num_threads(1)     # tiny tensors; the suite runs in parallel

K = 3
N_LOCI = 4
ITERS = 3
NET = dict(sim_tree=NET_SIM_TREE, guide=NET_GUIDE)
PHI = "phiprior = 1 1"
CASES = {
    "net": dict(NET, priors=(PHI,)),
    "net_int": dict(NET, thetaprior="invgamma 3 0.03 int", priors=(PHI,)),
    "bdi": None,                 # tests/fixtures/bdi, linked-msci thetas
    "net_diploid": dict(NET, n_sites=80, seqs=(1, 1, 2, 2),
                        diploid=(1, 1, 0, 0), model="HKY",
                        priors=(PHI, "heredity = 1 4 4")),
    "linked_all": dict(priors=("thetamodel = linked-all",)),
    "linked_inner": dict(priors=("thetamodel = linked-inner",)),
    "a10_linked": dict(priors=("thetamodel = linked-inner",
                               "speciesdelimitation = 1 0 2")),
}
NETWORKS = ("net", "net_int", "bdi", "net_diploid")


def _bdi_ctl(directory, extra="", nloci=N_LOCI, nsample=10):
    from test_torch_bdi import CTL
    path = os.path.join(str(directory), "bdi.ctl")
    with open(path, "w") as f:
        f.write(CTL.format(job=os.path.join(str(directory), "out"),
                           nloci=nloci, nsample=nsample,
                           extra="thetamodel = linked-msci\n" + extra))
    return path


@pytest.fixture(scope="module")
def ctls(tmp_path_factory):
    from bpp_tpu_torch.testing import write_simulated_run
    out = {}
    for name, kw in CASES.items():
        d = tmp_path_factory.mktemp(name)
        if kw is None:
            out[name] = _bdi_ctl(d)
            continue
        kw = dict(kw)
        kw.setdefault("n_sites", 60)
        out[name] = write_simulated_run(d, N_LOCI, **kw)
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
    from bpp_tpu_torch.mcmc.driver import chain_views
    from bpp_tpu_torch.mcmc.state import (
        MV_GTAGE, MV_HPATH, MV_PHI, MV_RJ, MV_TAU, MV_THETA,
    )
    eng, states, gens0, gens, batched, k3 = _batched(ctls, case)
    cfg = eng.cfg
    assert eng.chains_route == "batched", eng.chains_route_reason
    assert eng.ctx.route == ("K2" if case == "net_diploid" else "K1")
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
    last, trace = batched[-1][0], batched[-1][2]
    if case in NETWORKS:
        assert last.sp.is_network and trace["phi"].shape[0] == K
        assert int(acc[:, MV_HPATH, 1].sum()) > 0, "no repath accepted"
        assert int(acc[:, MV_TAU, 1].sum()) > 0, "no network tau accepted"
        assert (acc[:, MV_PHI, 0] == ITERS * eng.run.stree.n_hybrids).all()
        # the phi draws moved every chain's phis
        assert not torch.equal(trace["phi"], batched[0][2]["phi"])
    if cfg.theta_integrated:
        # K3 over the chains: the age move's 2 blocks, 3 SPR rounds and
        # repath's 2 phases, each one call over [K, L, 4H + 4]
        assert len(k3) == 7 * ITERS and all(
            s[:2] == (K, N_LOCI) for s in k3), k3
        assert (acc[:, MV_GTAGE, 0] > 0).all()
    else:
        assert not k3
        assert int(acc[:, MV_THETA, 1].sum()) > 0
    if cfg.linked_theta:
        link = eng.ctx.theta_link
        # every member holds its owner's theta, in every chain
        assert torch.equal(last.sp.theta, last.sp.theta[:, link])
        assert (link != torch.arange(len(link))).any()
    if cfg.est_delimit:
        assert (acc[:, MV_RJ, 0] == ITERS).all()


@pytest.mark.parametrize("case", ["net", "bdi"])
def test_batched_msci_density_matches_bpp_tpu_vmap(ctls, case):
    from test_torch_mig import _jax_state

    from bpp_tpu.mcmc.state import make_logpr_fn as logpr_j
    from bpp_tpu_torch.mcmc.driver import chain_views
    from bpp_tpu_torch.testing import port_state
    engj = _jax_engine(ctls[case])
    eng, _, _, _, batched, _ = _batched(ctls, case)
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
    fj = logpr_j(engj.ctx)

    def one(spec, lv):
        st = unflatten(spec, iter(lv))
        return eng._logpr_fn(st.gt, st.sp, st.subst.heredity)

    mask = np.asarray(eng.ctx.locus_mask)
    for st_p, st_j in ((init_p, init_j), (last, last_j)):
        assert st_p.sp.hslot.shape[0] == K
        spec, leaves = flatten(st_p)
        got = torch.func.vmap(lambda lv: one(spec, lv))(leaves)
        want = jax.jit(jax.vmap(fj))(st_j.gt, st_j.sp, st_j.subst.heredity)
        for what, x, y in zip(("lp", "coal", "T2h"), got, want):
            y = np.asarray(y)
            assert x.shape[0] == K, what
            if what == "coal":
                np.testing.assert_array_equal(x.numpy(), y, err_msg=what)
            else:
                assert np.isfinite(y[:, mask]).all(), what
                np.testing.assert_allclose(x.numpy(), y, rtol=1e-10,
                                           atol=1e-13, err_msg=what)
        # K distinct states
        lp = got[0].numpy()
        assert not np.allclose(lp[0], lp[1])


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


@pytest.mark.parametrize("case", ["net", "linked_inner"])
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
        assert len(a.phi) == (2 if case == "net" else 0)
        if a.phi:
            np.testing.assert_array_equal(np.stack(a.phi), np.stack(b.phi))
    assert logs["batched"][0].lnL != logs["batched"][1].lnL


def test_cli_batched_bdi_resume_is_byte_identical(tmp_path, capsys):
    from bpp_tpu_torch import cli
    ctl = _bdi_ctl(tmp_path, f"chains = {K}\ncheckpoint = 2 0\n", nloci=3,
                   nsample=5)
    assert cli.main(["--cfile", ctl, "--device", "cpu"]) == 0
    assert f"chains = {K}: batched" in capsys.readouterr().err
    files = [tmp_path / "out.mcmc.txt"] + [tmp_path / f"out.c{c}.mcmc.txt"
                                           for c in range(2, K + 1)]
    whole = [f.read_bytes() for f in files]
    for f in files:
        head = f.read_text().splitlines()[0].split("\t")
        assert sum(h.startswith("phi") for h in head) == 2, head
        shutil.move(f, tmp_path / (f.name + ".whole"))
    assert cli.main(["--resume", str(tmp_path / "out.chk.npz"), "--device",
                     "cpu", "--quiet"]) == 0
    assert [f.read_bytes() for f in files] == whole


@pytest.mark.parametrize("L", [1, 3, 8, 37])
def test_fixed_order_sums_match_bpp_tpu(L):
    """``msc_logprob_integrated`` and ``notheta.pop_sums`` (sums over
    loci in ``locus_sum``'s order) and ``moves._pool_linked`` (members
    added in index order) against ``bpp_tpu``'s to float64 roundoff on
    random counts, waiting sums, heredity scalars and the linked-msci
    owner map of the BDI fixture; each the same under ``vmap`` over K
    chains as chain by chain, bit for bit."""
    from bpp_tpu.mcmc import notheta as ntj
    from bpp_tpu.trees.coalescent import msc_logprob_integrated as mj
    from bpp_tpu.trees.stree import SpeciesTree as SJ
    from bpp_tpu.trees.stree import theta_link_map as link_j
    from bpp_tpu_torch.mcmc import notheta
    from bpp_tpu_torch.mcmc.moves import _pool_linked
    from bpp_tpu_torch.trees.coalescent import msc_logprob_integrated
    from test_torch_bdi import NWK
    st = SJ.from_newick(NWK, list("ABC"))
    owners = np.asarray(link_j(st, 3))
    H = st.n_nodes
    rng = np.random.default_rng(L)
    coal = rng.integers(0, 4, (K, L, H))
    t2 = rng.uniform(0.0, 0.05, (K, L, H))
    hered = rng.uniform(0.5, 2.0, (K, L))
    mask = np.ones(L, bool)
    mask[-1] = L == 1
    a, b = 3.0, 0.03
    tc, tt, th = map(torch.as_tensor, (coal, t2, hered))
    tm = torch.as_tensor(mask)

    def integ(c, t, h):
        return msc_logprob_integrated(c, t, h, a, b, tm)

    def sums(c, t, h):
        return torch.stack(notheta.pop_sums(c, t, h, tm))

    got_i = torch.func.vmap(integ)(tc, tt, th)
    got_s = torch.func.vmap(sums)(tc, tt, th)
    ctx = types.SimpleNamespace(theta_link=torch.as_tensor(owners))
    ks, cs = got_s[:, 0], got_s[:, 1]
    got_p = torch.func.vmap(
        lambda k, c: torch.stack(_pool_linked(ctx, k, c)))(ks, cs)
    link = jnp.asarray(owners)
    for k in range(K):
        assert torch.equal(got_i[k], integ(tc[k], tt[k], th[k]))
        assert torch.equal(got_s[k], sums(tc[k], tt[k], th[k]))
        assert torch.equal(got_p[k], torch.stack(_pool_linked(ctx, ks[k],
                                                              cs[k])))
        want = mj(jnp.asarray(coal[k]), jnp.asarray(t2[k]),
                  jnp.asarray(hered[k]), a, b, jnp.asarray(mask))
        np.testing.assert_allclose(float(got_i[k]), float(want), rtol=1e-12)
        wk, wc = ntj.pop_sums(jnp.asarray(coal[k]), jnp.asarray(t2[k]),
                              jnp.asarray(hered[k]), jnp.asarray(mask))
        np.testing.assert_allclose(got_s[k].numpy(),
                                   np.stack([wk, wc]), rtol=1e-12,
                                   atol=1e-15)
        # bpp_tpu's theta_move pooling (bpp_tpu/mcmc/moves.py:77-80)
        kj, cj = jnp.asarray(ks[k].numpy()), jnp.asarray(cs[k].numpy())
        want_p = np.stack([jnp.zeros_like(kj).at[link].add(kj)[link],
                           jnp.zeros_like(cj).at[link].add(cj)[link]])
        np.testing.assert_allclose(got_p[k].numpy(), want_p, rtol=1e-12,
                                   atol=1e-15)
    # the pooling is a sum a group: owners with more than one member
    assert len(set(owners.tolist())) < H


@pytest.mark.parametrize("dated", [False, True])
@pytest.mark.parametrize("case", ["net", "linked_all"])
def test_event_sums_match_bpp_tpu(ctls, case, dated):
    """``per_pop_stats`` (each locus's events summed into its populations
    over the innermost axis of [L, H, E]) and ``per_pop_stats_dated``
    (the pairwise coexistence times) of K chains' gene trees, on a network and on a tree, with every tip at age
    0 or (``dated``) each tip at a random age below its parent: under
    ``vmap`` bit for bit the chain-by-chain values, and against
    ``bpp_tpu``'s on the same trees and populations to float64 roundoff
    (counts exact)."""
    from test_torch_mig import _jax_state

    from bpp_tpu.trees import coalescent as cj
    from bpp_tpu_torch.trees import coalescent as cp
    from bpp_tpu_torch.trees.gtree import assign_populations
    eng = _engine(ctls[case])
    ctx = eng.ctx
    states = eng.init_states(K)
    rng = np.random.default_rng(5)
    stats = cp.per_pop_stats_dated if dated else cp.per_pop_stats
    stats_j = cj.per_pop_stats_dated if dated else cj.per_pop_stats
    trees, pops = [], []
    for st in states:
        gt = st.gt
        if dated:
            T = gt.n_tips
            page = torch.gather(gt.age, 1, gt.parent[:, :T].clamp(min=0))
            tip = torch.as_tensor(rng.uniform(0.0, 0.9, page.shape)) * page
            gt = gt._replace(age=torch.cat([tip, gt.age[:, T:]], 1))
        trees.append(gt)
        pops.append(assign_populations(gt, st.sp, ctx.tip_pop))
    stacked = [torch.stack(x) for x in zip(*[flatten(g)[1] for g in trees])]
    spec = flatten(trees[0])[0]
    sp_spec = flatten(states[0].sp)[0]
    sps = [torch.stack(x) for x in zip(*[flatten(s.sp)[1] for s in states])]

    def one(gl, sl, p):
        return stats(unflatten(spec, iter(gl)), unflatten(sp_spec, iter(sl)),
                     p, ctx.n_seq)

    got = torch.func.vmap(one)(stacked, sps, torch.stack(pops))
    for k, st in enumerate(states):
        want = stats(trees[k], st.sp, pops[k], ctx.n_seq)
        for x, y in zip(got, want):
            assert torch.equal(x[k], y), (k, "vmap against chain by chain")
        js = _jax_state(st._replace(gt=trees[k]))
        ref = stats_j(js.gt, js.sp, jnp.asarray(pops[k].numpy()),
                      jnp.asarray(ctx.n_seq.numpy()))
        np.testing.assert_array_equal(got[0][k].numpy(), np.asarray(ref[0]))
        np.testing.assert_allclose(got[1][k].numpy(), np.asarray(ref[1]),
                                   rtol=1e-12, atol=1e-15)
        np.testing.assert_array_equal(got[2][k].numpy(), np.asarray(ref[2]))
    # K distinct chains, events in every one
    assert not torch.equal(got[1][0], got[1][1])
    assert int(got[0].sum()) > 0
