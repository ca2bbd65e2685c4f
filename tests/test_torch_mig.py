"""MSC-M migration on fixed routes in the PyTorch port against ``bpp_tpu``.

* ``build_routes`` (and the geneflow candidate table): every field equal.
* The hand oracle of ``tests/test_migration.py`` (one migration event on a
  two-species locus) through the port's functions.
* On the states of seeded float64 port chains with live migration events
  (strict clock, clock = 2, variable-rate routes, heredity, A10), handed
  to both packages: ``assign_populations_mig``, ``route_consistent_mig``
  and the integer statistics exact; ``_subedges``, ``mig_stats``,
  ``msc_logprob_mig``, ``make_logpr_fn_mig``,
  ``relaxed_branch_lengths_mig``, ``_remap_event_times``, the plain
  likelihood (strict and relaxed) and the a1b1 rows (theta and rate) at
  rtol 1e-10.
* The combination guards refuse as ``bpp_tpu``'s, with its messages
  (``thetamodel = linked-mscm`` among them: ``bpp_tpu`` does not
  implement it).
* The float32 floor of the sim-SPR coalescence rate.
* The synthetic sim-SPR walks the card's tests hold kernel K5 to
  (``testing.synthetic_walks``) are well-formed walks with the edge cases
  they claim.

The caches along 30-step port chains are ``test_torch_mig_chain.py``,
prior recovery under migration ``test_torch_mig_prior.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpp_tpu.mcmc import state as sj
from bpp_tpu.trees import gtree as gj
from bpp_tpu.trees import migration as mj
from bpp_tpu_torch.testing import WALK_SHAPES, walk_id
from bpp_tpu_torch.trees import migration as mp

torch.set_num_threads(1)     # tiny tensors; the suite runs in parallel

# the rates of the simulation are high enough that a few loci of 8
# carry events; the run's routes have a Gamma(2, 0.1) prior (mean 20)
SIM = "model = 0\nmigration = 2\nA B 20\nB A 20"
ROUTES = "migration = 2\nA B 2 0.1\nB A 2 0.1"
CONFIGS = {
    "strict": (ROUTES,),
    "clock2": (ROUTES, "clock = 2 10 100 5 iid G"),
    "am": ("migration = 2\nA B 2 0.1 3\nB A 2 0.1 3",),
    "heredity": (ROUTES, "heredity = 1 4 4"),
    "A10": (ROUTES, "speciesdelimitation = 1 0 2"),
}
STEPS = 10


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from bpp_tpu_torch.testing import write_simulated_run
    d = tmp_path_factory.mktemp("mig")
    ctls = {}
    for name, lines in CONFIGS.items():
        ctls[name] = write_simulated_run(
            d, 8, n_sites=60, job=name, sim_model=SIM, priors=lines)
    return ctls


def _engines(ctl):
    from bpp_tpu.loader import load_run_from_ctl as load_j
    from bpp_tpu.mcmc.driver import Engine as EJ
    from bpp_tpu_torch.loader import load_run_from_ctl as load_p
    from bpp_tpu_torch.mcmc.driver import Engine as EP
    rj, rp = load_j(ctl), load_p(ctl)
    rj.cfg = rj.cfg.replace(dtype="float64")
    rp.cfg = rp.cfg.replace(dtype="float64")
    return EJ(rj, seed=5), EP(rp, seed=5, device="cpu")


_CHAINS = {}


def _chain(data, name):
    """(bpp_tpu engine, port engine, the port chain's states after each
    step), run once a module."""
    if name not in _CHAINS:
        engj, eng = _engines(data[name])
        st = eng.init_state()
        states = []
        for _ in range(STEPS):
            st, _ = eng.chunk_step(st, 1)
            states.append(st)
        _CHAINS[name] = (engj, eng, states)
    return _CHAINS[name]


def _j(x):
    a = x.detach().cpu().numpy()
    return jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)


def _jax_state(st):
    """bpp_tpu's McmcState holding the port state's arrays."""
    def conv(cls, x):
        return None if x is None else cls(**{
            f: _j(getattr(x, f)) for f in cls._fields
            if getattr(x, f, None) is not None})

    return sj.McmcState(
        gt=conv(gj.GTrees, st.gt), sp=conv(gj.SpeciesArrays, st.sp),
        subst=conv(sj.SubstState, st.subst), logl=_j(st.logl),
        logpr=_j(st.logpr), finetune=_j(st.finetune),
        clock=conv(sj.ClockState, st.clock), mig=conv(mj.MigState, st.mig))


def _eq(a, b, what, rtol=None):
    a, b = np.asarray(a), b.detach().cpu().numpy()
    if rtol is None:
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        np.testing.assert_allclose(b, a, rtol=rtol, atol=1e-13, err_msg=what)


def test_build_routes_equal(data):
    from bpp_tpu.loader import load_run_from_ctl as load_j
    from bpp_tpu_torch.loader import load_run_from_ctl as load_p
    for name in ("strict", "am"):
        rj, rp = load_j(data[name]), load_p(data[name])
        for build in ("build_routes", "build_routes_geneflow"):
            a = getattr(mj, build)(rj.cfg, rj.stree)
            b = getattr(mp, build)(rp.cfg, rp.stree)
            if build == "build_routes_geneflow":
                np.testing.assert_array_equal(a[1], b[1])
                a, b = a[0], b[0]
            for f in ("si", "ti", "alpha", "beta", "am", "index"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                              err_msg=f"{build}.{f}")


def test_density_hand_oracle():
    """tests/test_migration.py's oracle: a in A, b in B, tau_R = 0.1; one
    event on a's edge at 0.04 (backward A -> B, route B -> A), the
    coalescence at 0.08 in B."""
    from bpp_tpu_torch.trees.gtree import GTrees, species_arrays
    from bpp_tpu_torch.trees.stree import SpeciesTree
    theta, t_m, t_r, M = 0.01, 0.04, 0.08, 1.7
    st = SpeciesTree.from_newick("(A, B);", tip_order=["A", "B"])
    st.tau[:] = [0.0, 0.0, 0.1]
    st.theta[:] = theta
    sp = species_arrays(st)
    gt = GTrees(torch.tensor([[-1, -1, 0]]), torch.tensor([[-1, -1, 1]]),
                torch.tensor([[2, 2, -1]]),
                torch.tensor([[0.0, 0.0, t_r]], dtype=torch.float64))
    n_seq = torch.tensor([2])
    mig = mp.empty_mig_state(1, 4, 1, [M], torch.float64)
    mig.time[0, 0], mig.node[0, 0], mig.src[0, 0], mig.dst[0, 0] = \
        t_m, 0, 0, 1
    pops = mp.assign_populations_mig(gt, sp, torch.tensor([[0, 1]]), mig,
                                     n_seq)
    assert int(pops[0, 2]) == 1
    assert bool(mp.route_consistent_mig(gt, sp, mig, pops, n_seq)[0])
    coal, C2, W, mc, _ = mp.mig_stats(gt, sp, pops, mig, [1], [0], n_seq)
    assert coal[0].tolist() == [0, 1, 0] and int(mc[0, 0]) == 1
    np.testing.assert_allclose(C2[0].numpy(), [0.0, 0.08, 0.0], atol=1e-12)
    np.testing.assert_allclose(float(W[0, 0]), 0.04, atol=1e-12)
    lp = mp.msc_logprob_mig(coal, C2, W, mc, sp.theta,
                            torch.ones(1, dtype=torch.float64), mig.M)
    want = np.log(M) - M * 0.04 + np.log(2.0 / theta) - 0.08 / theta
    np.testing.assert_allclose(float(lp[0]), want, rtol=1e-12)


@pytest.mark.parametrize("name", ["strict", "clock2", "am", "A10"])
def test_functions_match_bpp_tpu_on_chain_states(data, name):
    from bpp_tpu.mcmc.mig_moves import make_logpr_fn_mig as logpr_j
    from bpp_tpu.mcmc.rj_moves import _remap_event_times as remap_j
    from bpp_tpu_torch.mcmc.rj_moves import _remap_event_times as remap_p
    engj, eng, states = _chain(data, name)
    ctx = eng.ctx
    n_seq, tip_pop = ctx.n_seq, ctx.tip_pop
    rt = eng.mig_routes
    st = max(states, key=lambda s: int(s.mig.count().sum()))
    assert int(st.mig.count().sum()) > 0, "no migration event"
    sj_ = _jax_state(st)
    gtj, spj, migj = sj_.gt, sj_.sp, sj_.mig
    nj = _j(n_seq)

    pj = mj.assign_populations_mig(gtj, spj, _j(tip_pop), migj, nj)
    pp = mp.assign_populations_mig(st.gt, st.sp, tip_pop, st.mig, n_seq)
    _eq(pj, pp, "pops")
    _eq(mj.route_consistent_mig(gtj, spj, migj, pj, nj),
        mp.route_consistent_mig(st.gt, st.sp, st.mig, pp, n_seq), "ok")
    excl = torch.stack([torch.full_like(n_seq, 1), torch.full_like(n_seq, 9)],
                       1)
    for kw_j, kw_p in (({"include_root_edge": True},
                        {"include_root_edge": True}),
                       ({"exclude": _j(excl)}, {"exclude": excl})):
        a = mj._subedges(gtj, migj, pj, nj, **kw_j)
        b = mp._subedges(st.gt, st.mig, pp, n_seq, **kw_p)
        for x, y, what in zip(a, b, ("t_lo", "t_hi", "pop_lo", "live")):
            _eq(x, y, f"_subedges {what}", None if what in ("pop_lo", "live")
                else 1e-10)
    sa = mj.mig_stats(gtj, spj, pj, migj, engj.routes.si, engj.routes.ti, nj)
    sb = mp.mig_stats(st.gt, st.sp, pp, st.mig, rt.si, rt.ti, n_seq)
    for x, y, what in zip(sa, sb, ("coal", "C2", "W", "mc", "n_in")):
        _eq(x, y, what, 1e-10 if what in ("C2", "W") else None)
    hered = st.subst.heredity
    _eq(mj.msc_logprob_mig(*sa[:4], spj.theta, _j(hered),
                           mj.eff_rates(engj.routes, migj)),
        mp.msc_logprob_mig(*sb[:4], st.sp.theta, hered,
                           mp.eff_rates(rt, st.mig)), "msc_logprob_mig",
        1e-10)
    lj = logpr_j(engj.ctx, engj.routes)(gtj, spj, migj, _j(hered))
    lp = eng._logpr_mig_fn(st.gt, st.sp, st.mig, hered)
    for x, y, what in zip(lj, lp, ("lp", "coal", "C2", "W", "mc", "pops")):
        _eq(x, y, f"logpr_fn {what}",
            1e-10 if what in ("lp", "C2", "W") else None)
    brate = torch.as_tensor(np.random.default_rng(3).uniform(
        0.5, 2.0, (st.gt.n_loci, st.sp.n_nodes)))
    _eq(mj.relaxed_branch_lengths_mig(gtj, spj, migj, pj, nj, _j(brate)),
        mp.relaxed_branch_lengths_mig(st.gt, st.sp, st.mig, pp, n_seq,
                                      brate), "relaxed lengths", 1e-10)
    T = st.gt.n_tips
    inner = torch.arange(st.gt.n_nodes) >= T
    age_new = torch.where(inner, st.gt.age * 1.07, st.gt.age)
    mask = ctx.locus_mask
    ma, ja = remap_j(gtj, _j(age_new), migj, _j(mask))
    mb, jb = remap_p(st.gt, age_new, st.mig, mask)
    _eq(ma.time, mb.time, "remapped event times", 1e-10)
    _eq(ja, jb, "remap Jacobian", 1e-10)
    # the plain likelihood, strict or through the relaxed sub-edge lengths
    _eq(engj._logl_fn(gtj, sj_.subst, spj, sj_.clock, mig=migj),
        eng._logl_fn(st.gt, st.subst, st.sp, st.clock, mig=st.mig),
        "logl", 1e-10)
    # the a1b1 rows: theta and migration rate
    a1j, b1j, wa1j, wb1j = engj.a1b1_stats(sj_)
    a1, b1 = eng.a1b1_stats(st)
    wa1, wb1 = eng.mig_a1b1_stats(st)
    for x, y, what in ((a1j, a1, "a1"), (b1j, b1, "b1"), (wa1j, wa1, "wa1"),
                       (wb1j, wb1, "wb1")):
        _eq(x, y, what, 1e-10)


GUARDS = {
    "A01": "speciestree = 1",
    "correlated clock": "clock = 3 10 100 5 iid G",
    "integrated theta": "thetaprior = invgamma 3 0.03 int",
    "linked-mscm": "thetamodel = linked-mscm",
    "linked-all": "thetamodel = linked-all",
    "root route": "ROUTE X R",
    "ancestor route": "ROUTE A X",
    "geneflow with am": "geneflow = 1\nmigration = 1\nA B 2 0.1 3",
    "geneflow with A10": "geneflow = 1\nspeciesdelimitation = 1 0 2",
}


@pytest.mark.parametrize("case", list(GUARDS))
def test_guards_refuse_as_bpp_tpu(data, tmp_path, case):
    from bpp_tpu.loader import load_run_from_ctl as load_j
    from bpp_tpu.mcmc.driver import Engine as EJ
    from bpp_tpu_torch.loader import load_run_from_ctl as load_p
    from bpp_tpu_torch.mcmc.driver import Engine as EP
    with open(data["strict"]) as fh:
        text = fh.read()
    line = GUARDS[case]
    if line.startswith("ROUTE"):
        # labelled ancestral populations X = (A, B) and R = the root
        text = text.replace("((A, B), (C, D))", "((A, B)X, (C, D)Y)R")
        line = "migration = 1\n" + line[len("ROUTE "):]
    if "migration =" in line:
        text = text.replace(ROUTES + "\n", "")
    if line.startswith("thetaprior"):
        text = text.replace("thetaprior = 3 0.03\n", "")
    ctl = tmp_path / "g.ctl"
    ctl.write_text(text + line + "\n")
    errs = []
    for load, engine in ((load_j, EJ), (load_p, EP)):
        with pytest.raises((NotImplementedError, ValueError)) as e:
            run = load(str(ctl))
            engine(run, seed=1, **({} if engine is EJ else {"device": "cpu"}))
        errs.append((type(e.value), str(e.value)))
    assert errs[0] == errs[1], errs


def test_sim_rate_float32_floor():
    """A lineage alone in a population whose theta is 0 in float32: the
    migration rate alone, not 0 / 0."""
    from bpp_tpu_torch.mcmc.mig_moves import _sim_rate
    for dt in (torch.float32, torch.float64):
        n = torch.tensor([0, 3])
        theta = torch.tensor([0.0, 0.01], dtype=dt)
        crate, rate = _sim_rate(n, theta, torch.ones(2, dtype=dt),
                                torch.tensor([1.5, 2.0], dtype=dt))
        assert torch.isfinite(rate).all(), (dt, rate)
        assert float(rate[0]) == 1.5
        np.testing.assert_allclose(float(crate[1]), 600.0, rtol=1e-6)


class _Walked(Exception):
    """Raised by the stand-in ``while_loop`` once ``bpp_tpu``'s sim-SPR
    walk has run: the caller's locals and the loop's final carry."""

    def __init__(self, frame, carry):
        super().__init__("walked")
        self.frame, self.carry = frame, carry


def _bpp_tpu_walk(engj, state_j, key, monkeypatch):
    """``bpp_tpu``'s ``spr_sim_move`` up to the end of its walk
    (``lax.while_loop``, mig_moves.py:765), the loop run step by step:
    (the move's locals at the loop, the loop's final carry)."""
    import sys

    import jax
    from bpp_tpu.mcmc import mig_moves as mmj

    def walk(cond, body, carry):
        frame = dict(sys._getframe(1).f_locals)
        while bool(cond(carry)):
            carry = body(carry)
        raise _Walked(frame, carry)

    monkeypatch.setattr(jax.lax, "while_loop", walk)
    try:
        mmj.spr_sim_move(engj.ctx, engj.cfg, engj.routes, state_j,
                         jax.random.PRNGKey(key))
    except _Walked as w:
        return w.frame, w.carry
    finally:
        monkeypatch.undo()
    raise AssertionError("bpp_tpu's spr_sim_move ran no while_loop")


def _walk_uniforms(ksim, max_steps, L):
    """The block of uniforms [3, max_steps, L] that makes the port's walk
    take ``bpp_tpu``'s draws: step s's keys split as its ``sim_body``
    splits them, the exponential e as the uniform 1 - exp(-e) (the port
    takes -log1p(-u))."""
    import jax
    kk, rows = ksim, []
    for _ in range(max_steps):
        kk, k1, k2, k3 = jax.random.split(kk, 4)
        e = np.asarray(jax.random.exponential(k1, (L,), jnp.float64))
        rows.append([-np.expm1(-e),
                     np.asarray(jax.random.uniform(k2, (L,), jnp.float64)),
                     np.asarray(jax.random.uniform(k3, (L,), jnp.float64))])
    return torch.from_numpy(np.asarray(rows).transpose(1, 0, 2).copy())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sim_walk_matches_bpp_tpu_while_loop(data, name, monkeypatch):
    """The sim-SPR walk's plain version (``simspr_walk_ref``, what kernel
    K5 is held against on the card) against ``bpp_tpu``'s ``while_loop``
    on the same inputs and the same draws: the walk's inputs read from
    ``bpp_tpu``'s move at its loop, on the chain's first state and the
    one with most events, eight keys each.  Populations, outcomes and
    events' populations and counts exact, times at float64 round-off."""
    from bpp_tpu_torch.mcmc.mig_moves import simspr_walk_ref
    engj, eng, states = _chain(data, name)
    picks = [eng.init_state(), max(states, key=lambda s: int(
        s.mig.count().sum()))]

    def t(x, dtype=None):
        a = torch.from_numpy(np.array(x))
        if a.dtype == torch.int32:
            a = a.to(torch.int64)
        return a if dtype is None else a.to(dtype)

    seen = {"coalesced": 0, "events": 0, "failed": 0}
    for st in picks:
        state_j = _jax_state(st)
        for key in range(8):
            f, carry = _bpp_tpu_walk(engj, state_j, key, monkeypatch)
            L, sp = f["L"], f["sp"]
            unif = _walk_uniforms(f["ksim"], f["max_steps"], L)
            tau, partau_f, si = t(f["tau"]), t(f["partau_f"]), t(f["si"])
            got = simspr_walk_ref(
                t(f["t_lo"]), t(f["t_hi"]), t(f["pop_lo"]), t(f["live_e"]),
                t(sp.pptable), tau, partau_f, t(sp.theta), t(sp.parent), si,
                t(f["ti"]), tau[si], partau_f[si], t(f["route_M"]),
                t(f["heredity"]), t(f["t0"]), t(f["start_pop"]),
                t(f["is_valid"]), unif, f["ME"])
            tj, pj, _, donej, failj, ntj, nsj, ndj, nnj, _ = carry
            for what, a, b in (("p", pj, got[1]), ("done", donej, got[2]),
                               ("fail", failj, got[3]), ("ns", nsj, got[5]),
                               ("nd", ndj, got[6]), ("nn", nnj, got[7])):
                np.testing.assert_array_equal(
                    b.numpy(), np.asarray(a), err_msg=f"{what}, key {key}")
            for what, a, b in (("t", tj, got[0]), ("nt", ntj, got[4])):
                np.testing.assert_allclose(
                    b.numpy(), np.asarray(a), rtol=1e-12,
                    err_msg=f"{what}, key {key}")
            valid = np.asarray(f["is_valid"])
            seen["coalesced"] += int((np.asarray(donej) & valid).sum())
            seen["events"] += int(np.asarray(nnj)[valid].sum())
            seen["failed"] += int((np.asarray(failj) & valid).sum())
    assert seen["coalesced"] and seen["events"], seen


@pytest.mark.parametrize("shape", WALK_SHAPES,
                         ids=[walk_id(s) for s in WALK_SHAPES])
def test_synthetic_walks_are_well_formed(shape):
    """Each synthetic walk case of ``tests/test_torch_kernel_gpu.py``'s
    K5 test through ``simspr_walk_ref`` on the CPU: every valid locus done
    or failed within the S steps, never both; at most ME events, their
    times non-decreasing from the start and the walk's end at or above the
    last; invalid loci untouched.  The edge cases a case claims are there:
    where it has 33 loci or more, invalid loci, loci with no live
    sub-edge and walks that fill all ME slots, all of them failed, and
    walks that coalesce and that migrate."""
    from bpp_tpu_torch.mcmc.mig_moves import simspr_walk_ref
    from bpp_tpu_torch.testing import synthetic_walks, walk_seed
    from bpp_tpu_torch.trees.gtree import BIG_AGE
    E, L, H, every_pair = shape
    args, kinds = synthetic_walks(L, E, H, seed=walk_seed(shape),
                                  every_pair=every_pair)
    assert args[0].shape == (L, E) and args[5].shape == (H,)
    ME, S = args[19], args[18].shape[1]
    live, t0, p0, valid = args[3], args[15], args[16], args[17]
    steps = torch.zeros(L, dtype=torch.int64)
    t, p, done, fail, nt, ns, nd, nn = simspr_walk_ref(*args, steps=steps)
    assert int(steps.max()) <= S
    assert bool((done | fail)[valid].all()) and not bool((done & fail).any())
    assert bool((nn <= ME).all())
    slot = torch.arange(ME)[None, :]
    used = slot < nn[:, None]
    assert bool((nt[~used] == BIG_AGE).all())
    prev = torch.cat([t0[:, None], nt[:, :-1]], dim=1)
    assert bool((nt >= prev)[used].all())
    last = torch.where(nn > 0, nt[torch.arange(L), (nn - 1).clamp(min=0)], t0)
    assert bool((t >= last)[valid].all())
    assert torch.equal(t[~valid], t0[~valid])
    assert torch.equal(p[~valid], p0[~valid])
    assert not bool((done | fail | (nn > 0))[~valid].any())
    if every_pair:
        assert args[9].shape[0] > 32       # more routes than a warp's lanes
    kinds = torch.as_tensor(kinds)
    if L >= 33:
        assert set(kinds.tolist()) == {0, 1, 2, 3}
        assert not bool(live[kinds == 2].any())
        assert bool(live[kinds == 3].any())
        trapped = (kinds == 2) | (kinds == 3)
        assert bool((fail & (nn == ME))[trapped].all())
        walks = kinds == 0
        assert bool(done[walks].any()) and bool((nn > 0)[walks].any())
    else:
        assert not bool((kinds != 0).any())
