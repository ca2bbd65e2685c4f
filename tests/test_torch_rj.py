"""Species delimitation (A10/A11) of the PyTorch port against
``bpp_tpu``.

* ``prior_a11_masses`` (n = 2..6, priors 0-3, and the reference table of
  tests/test_a10.py) and ``_root_age_scale`` (gamma and inverse-gamma tau
  priors, without data, on haploid and on unphased diploid data) equal
  ``bpp_tpu``'s exactly.
* After every accepted rj move the gene trees are valid and every cache is
  exact, for both rjMCMC algorithms, with integrated thetas and under an
  IID relaxed clock (clock = 2).
* On a collapsed state (tau = 0 at an inner node) the MSC statistics
  equal ``bpp_tpu``'s ``per_pop_stats``, and every base move (gene-node
  ages, gene-tree SPR, thetas, taus, mixing, the relaxed clock's rates)
  keeps the caches exact.
* Prior recovery (usedata = 0, speciesmodelprior = 1): the frequencies of
  the three delimitations of a 3-species guide tree (A10) and of the 1-,
  2- and 3-species joint models (A11) lie within 4 Monte Carlo standard
  errors (between independent chains) of ``prior_a11_masses``, 1/3
  each.
* clock = 3 with species delimitation is refused, as in ``bpp_tpu``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_stree import _check_caches, _engine, write_dummy

torch.set_num_threads(1)     # tiny tensors; the suite runs in parallel

DELIMIT = "speciesdelimitation = 1 0 2"


@pytest.mark.parametrize("prior", [0, 1, 2, 3])
def test_prior_a11_masses_match_bpp_tpu(prior):
    from bpp_tpu.mcmc.driver import prior_a11_masses as masses_j
    from bpp_tpu_torch.mcmc.driver import prior_a11_masses as masses_p
    for n in range(2, 7):
        np.testing.assert_array_equal(masses_p(n, prior), masses_j(n, prior))
    # the reference table (partition_fast/print_pinfo, delimit.c:88-215)
    if prior == 2:
        np.testing.assert_allclose(masses_p(4, 2) * 66, [15, 15, 18, 18],
                                   rtol=1e-12)
    if prior == 3:
        np.testing.assert_allclose(masses_p(4, 3) * 63, [15, 15, 18, 15],
                                   rtol=1e-12)


@pytest.mark.parametrize("case", ["gamma", "invgamma", "haploid",
                                  "diploid"])
def test_root_age_scale_matches_bpp_tpu(tmp_path, case):
    from bpp_tpu.loader import load_run_from_ctl as load_j
    from bpp_tpu.mcmc.driver import _root_age_scale as scale_j
    from bpp_tpu_torch.loader import load_run_from_ctl as load_p
    from bpp_tpu_torch.mcmc.driver import _root_age_scale as scale_p
    from bpp_tpu_torch.testing import write_simulated_run
    kw = dict(n_loci=5, n_sites=80, priors=(DELIMIT,))
    if case == "gamma":
        kw.update(usedata=0, tauprior="gamma 2 100")
    elif case == "invgamma":
        kw.update(usedata=0)
    elif case == "diploid":
        kw.update(seqs=(1, 1, 2, 2), diploid=(1, 1, 0, 0))
    ctl = write_simulated_run(tmp_path, **kw)
    rp, rj = load_p(ctl), load_j(ctl)
    got, want = scale_p(rp.cfg, rp), scale_j(rj.cfg, rj)
    assert isinstance(got, float) and got > 0
    assert got == want


def _rj_states(eng, n_iter, want=4):
    """Run ``n_iter`` iterations, each followed by two extra rj moves;
    check the caches after every accepted rj move; returns the number
    accepted."""
    from bpp_tpu_torch.mcmc import rj_moves
    st = eng.init_state()
    n_acc = 0
    seen = set()
    for _ in range(n_iter):
        st, _ = eng._step(st)
        for _ in range(2):
            st, (_, acc) = rj_moves.rj_move(eng.ctx, eng.cfg, st, eng.gen,
                                            eng.root_age0)
            if int(acc):
                n_acc += 1
                _check_caches(eng, st)
                seen.add(tuple((st.sp.tau[4:] > 0).tolist()))
        if n_acc >= want and len(seen) > 1:
            break
    return n_acc, seen


@pytest.mark.parametrize("priors", [
    (DELIMIT,),
    ("speciesdelimitation = 1 1 2 1",),
    (DELIMIT, "thetaprior = invgamma 3 0.03 int"),
    (DELIMIT, "clock = 2 10 100 5 iid G", "locusrate = 1 10 10 5 iid"),
], ids=["alg0", "alg1", "integrated", "clock2"])
def test_caches_exact_after_rj_moves(tmp_path, priors):
    # weak data (one sequence a species, 4 sites): rj moves get accepted
    eng = _engine(tmp_path, priors, seqs=(1, 1, 1, 1), n_loci=3, n_sites=4)
    n_acc, seen = _rj_states(eng, 200)
    assert n_acc >= 2 and len(seen) > 1, (n_acc, seen)


def _collapsed(eng, node):
    """The initial state with tau = 0 at ``node`` and fresh caches."""
    from bpp_tpu_torch.mcmc.clock_moves import lnprior_rates
    st = eng.init_state()
    tau = st.sp.tau.clone()
    tau[node] = 0.0
    sp = st.sp._replace(tau=tau)
    lp, c, t2 = eng._logpr_fn(st.gt, sp, st.subst.heredity)
    st = st._replace(sp=sp, logpr=lp,
                     logl=eng._logl_fn(st.gt, st.subst, sp, st.clock))
    if st.coal is not None:
        st = st._replace(coal=c, t2h=t2)
    if st.clock is not None:
        st = st._replace(clock=st.clock._replace(lnrates=lnprior_rates(
            eng.cfg, sp, st.subst.mu, st.clock)))
    return st


def test_collapsed_msc_stats_match_bpp_tpu(tmp_path):
    from bpp_tpu.trees import coalescent as cj
    from bpp_tpu.trees import gtree as gj
    from bpp_tpu_torch.trees import coalescent as cp
    from bpp_tpu_torch.trees.gtree import assign_populations
    eng = _engine(tmp_path, (DELIMIT,))
    for node in (4, 5):
        st = _collapsed(eng, node)
        ctx, sp, gt = eng.ctx, st.sp, st.gt
        pops = assign_populations(gt, sp, ctx.tip_pop)
        c, t2, _ = cp.per_pop_stats(gt, sp, pops, ctx.n_seq)
        spj = gj.species_arrays(eng.run.stree, dtype=jnp.float64)._replace(
            tau=jnp.asarray(sp.tau.numpy()))
        gtj = gj.GTrees(*(jnp.asarray(x.numpy()) for x in gt[:4]))
        popsj = gj.assign_populations(gtj, spj, jnp.asarray(
            ctx.tip_pop.numpy()))
        np.testing.assert_array_equal(pops.numpy(), np.asarray(popsj))
        cj_, t2j, _ = cj.per_pop_stats(gtj, spj, popsj,
                                       jnp.asarray(ctx.n_seq.numpy()))
        np.testing.assert_array_equal(c.numpy(), np.asarray(cj_))
        np.testing.assert_allclose(t2.numpy(), np.asarray(t2j), rtol=1e-12,
                                   atol=1e-15)


@pytest.mark.parametrize("priors", [
    (DELIMIT,),
    (DELIMIT, "thetaprior = invgamma 3 0.03 int"),
    (DELIMIT, "clock = 2 10 100 5 iid G", "locusrate = 1 10 10 5 iid"),
], ids=["thetas", "integrated", "clock2"])
def test_collapsed_state_through_base_moves(tmp_path, priors):
    from bpp_tpu_torch.mcmc import clock_moves, moves
    eng = _engine(tmp_path, priors, n_sites=20)
    ctx, cfg, gen = eng.ctx, eng.cfg, eng.gen
    st = _collapsed(eng, 4)
    _check_caches(eng, st)
    base = [moves.age_block_move, moves.spr_round_move, moves.tau_move,
            moves.mixing_move]
    if not cfg.theta_integrated:
        base.append(moves.theta_move)
    if st.clock is not None:
        base += [clock_moves.mui_move, clock_moves.nui_move,
                 clock_moves.brate_move]
    accepted = {m.__name__: 0 for m in base}
    for _ in range(4):
        for move in base:
            st, (_, acc) = move(ctx, cfg, st, gen)
            accepted[move.__name__] += int(acc)
            _check_caches(eng, st)
            assert float(st.sp.tau[4]) == 0.0
    assert accepted["age_block_move"] > 0 and accepted["tau_move"] > 0, \
        accepted


@pytest.mark.parametrize("extra", [
    DELIMIT, DELIMIT + "\nspeciestree = 1"], ids=["A10", "A11"])
def test_delimitation_frequencies_match_prior(tmp_path, extra):
    """5 independent chains of 200 iterations (a delimitation's sojourns
    are long, so batch means of one short chain understate the error);
    standard errors between chains."""
    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.mcmc.driver import Engine, prior_a11_masses
    from bpp_tpu_torch.mcmc.state import MV_RJ
    ctl = write_dummy(tmp_path, "ABC", "((A,B),C)", extra=extra)
    run = load_run_from_ctl(ctl)
    run.cfg = run.cfg.replace(dtype="float64")
    freqs, n_acc = [], 0
    for seed in range(5):
        eng = Engine(run, seed=30 + seed, device="cpu")
        st = eng.init_state()
        k = []
        for _ in range(200):
            st, stats = eng._step(st)
            n_acc += int(stats[MV_RJ, 1])
            k.append(int((st.sp.tau[3:] > 0).sum()) + 1)
        k = np.asarray(k[20:])
        freqs.append([(k == n_sp).mean() for n_sp in (1, 2, 3)])
    assert n_acc > 0
    freqs = np.asarray(freqs)
    se = freqs.std(0, ddof=1) / np.sqrt(len(freqs))
    want = prior_a11_masses(3, 1)
    assert (np.abs(freqs.mean(0) - want) < 4 * se).all(), (freqs.mean(0), se)


def test_clock3_with_delimitation_refused(tmp_path):
    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.mcmc.driver import Engine
    ctl = write_dummy(tmp_path, "ABC", "((A,B),C)",
                      extra=DELIMIT + "\nclock = 3 10 100 5 gdir LN\n"
                      "locusrate = 1 10 10 5 iid")
    with pytest.raises(NotImplementedError, match="auto-correlated"):
        Engine(load_run_from_ctl(ctl), device="cpu")
