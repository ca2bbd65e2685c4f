"""Species-tree search (A01) of the PyTorch port against ``bpp_tpu``.

* ``build_constraint_ids`` and the ancestor / MRCA tables rebuilt after
  species SPR and SNL moves equal ``bpp_tpu``'s on the same inputs;
  ``log_species_model_prior`` (priors 0-3, on resolved and partly
  collapsed trees) and ``log_histories_tau`` agree to float32 round-off
  (``bpp_tpu`` takes their lgammas in float32, the port in float64).
* After every accepted species SPR and SNL of short port chains the gene
  trees are valid (children and parents agree, no child older than its
  parent), ``logpr`` is finite and every cache is exact: ``logl``,
  ``logpr``, ``coal``/``t2h`` with integrated thetas, ``lnrates`` under
  the correlated clock (clock = 3); the species tables match the topology
  and the root stays the last node.
* On those gene trees the port's plain per-locus lnL equals ``bpp_tpu``'s
  ``felsenstein.loglikelihood`` (float64, rtol 1e-10), and ``bpp_tpu``'s
  kernel K1 in Pallas interpret mode agrees with the port's float32 pass
  (rtol 2e-4 / atol 2e-3 lnL, as in test_torch_likelihood.py).
* Topology constraints: SPR under the prior keeps the constrained clade
  and visits the three trees that have it near-uniformly; SNL with a
  constraint file is refused, as in ``bpp_tpu``.

Prior recovery of the topology frequencies is in
test_torch_stree_prior.py.
"""

import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)     # tiny tensors; the suite runs in parallel

SNL_ON = "speciestree = 1 0.5 0.33 0.1 0.2"


def write_dummy(path, names, guide, seqs=1, extra="", usedata=0,
                thetaprior="3 0.02"):
    """A control file over a constant alignment (one locus) for prior
    runs; returns its path."""
    n = len(names)
    (path / "d.txt").write_text("\n".join(
        [f"{n * seqs} 20"] + [f"{s}^{s.lower()}{i} " + "A" * 20
                              for s in names for i in range(seqs)]) + "\n\n")
    (path / "d.imap").write_text("".join(
        f"{s.lower()}{i}\t{s}\n" for s in names for i in range(seqs)))
    ctl = path / "a.ctl"
    ctl.write_text(textwrap.dedent(f"""\
        seed = 1
        seqfile = {path / 'd.txt'}
        Imapfile = {path / 'd.imap'}
        jobname = {path / 'out'}
        species&tree = {n} {' '.join(names)}
                       {' '.join([str(seqs)] * n)}
                       {guide};
        usedata = {usedata}
        nloci = 1
        thetaprior = {thetaprior}
        tauprior = gamma 2 100
        finetune = 1
        burnin = 0
        sampfreq = 1
        nsample = 1
    """) + extra + "\n")
    return str(ctl)


def canon(left, right, parent, names):
    """Canonical newick (sorted, no lengths) of species arrays."""
    ns = len(names)
    root = int(np.nonzero(np.asarray(parent) < 0)[0][0])

    def rec(i):
        if i < ns:
            return names[i]
        a, b = rec(int(left[i])), rec(int(right[i]))
        return "(" + ",".join(sorted([a, b])) + ")"

    return rec(root)


@pytest.mark.parametrize("lines", [
    "constraint = (A, B);",
    "define ab as (A, B);\nconstraint = (ab, C);",
    "outgroup = D, E;",
    "constraint = (D, E);\nconstraint = ((A, B), C);",
])
def test_build_constraint_ids_matches_bpp_tpu(tmp_path, lines):
    from bpp_tpu.io.constraints import build_constraint_ids as ids_j
    from bpp_tpu.loader import load_run_from_ctl as load_j
    from bpp_tpu_torch.io.constraints import build_constraint_ids as ids_p
    from bpp_tpu_torch.loader import load_run_from_ctl as load_p
    ctl = write_dummy(tmp_path, "ABCDE", "(((A,B),C),(D,E))",
                      extra="speciestree = 1 0")
    cf = tmp_path / "cons.txt"
    cf.write_text(lines + "\n")
    got = ids_p(load_p(ctl).stree, str(cf))
    want = ids_j(load_j(ctl).stree, str(cf))
    np.testing.assert_array_equal(got, want)
    assert len(set(got.tolist())) > 1


def _species_pair(tau, stp, stj):
    """(port SpeciesArrays, bpp_tpu SpeciesArrays) with taus ``tau``."""
    from bpp_tpu.trees.gtree import species_arrays as arr_j
    from bpp_tpu_torch.trees.gtree import species_arrays as arr_p
    sp = arr_p(stp, dtype=torch.float64)
    sj = arr_j(stj, dtype=jnp.float64)
    return (sp._replace(tau=torch.as_tensor(tau)),
            sj._replace(tau=jnp.asarray(tau)))


@pytest.mark.parametrize("prior", [0, 1, 2, 3])
def test_species_model_prior_matches_bpp_tpu(tmp_path, prior):
    from bpp_tpu.loader import load_run_from_ctl as load_j
    from bpp_tpu.mcmc import stree_moves as smj
    from bpp_tpu.mcmc.driver import prior_a11_masses as masses_j
    from bpp_tpu_torch.loader import load_run_from_ctl as load_p
    from bpp_tpu_torch.mcmc import stree_moves as smp
    from bpp_tpu_torch.mcmc.driver import prior_a11_masses as masses_p
    ctl = write_dummy(tmp_path, "ABCDE", "(((A,B),C),(D,E))",
                      extra=f"speciestree = 1\nspeciesdelimitation = 1 0 2\n"
                      f"speciesmodelprior = {prior}")
    rp, rj = load_p(ctl), load_j(ctl)
    cfg = rp.cfg
    H = rp.stree.n_nodes
    la_p = torch.as_tensor(np.log(masses_p(5, prior))) if prior >= 2 \
        else None
    la_j = jnp.asarray(np.log(masses_j(5, prior))) if prior >= 2 else None
    rng = np.random.default_rng(prior)
    for collapsed in ([], [5], [6, 7], [5, 6, 7, 8]):
        tau = np.zeros(H)
        tau[5:] = np.sort(rng.uniform(0.01, 0.05, H - 5))
        tau[collapsed] = 0.0
        sp, sj = _species_pair(tau, rp.stree, rj.stree)
        got = float(smp.log_species_model_prior(cfg, sp, la_p))
        want = float(smj.log_species_model_prior(rj.cfg, sj, la_j))
        # bpp_tpu takes these lgammas of int32 counts in float32; the
        # port in float64 (exact at these counts)
        np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-7)
        hist = float(smp.log_histories_tau(sp))
        np.testing.assert_allclose(hist, float(smj.log_histories_tau(sj)),
                                   rtol=1e-7, atol=1e-7)
    tips = torch.arange(H) < 5
    np.testing.assert_allclose(
        float(smp._log_histories(sp.pptable, tips)),
        float(smj._log_histories(sj.pptable, jnp.asarray(tips.numpy()))),
        rtol=1e-7)


def _engine(tmp_path, priors, seqs=(2, 2, 2, 2), n_loci=6, n_sites=40,
            seed=3, **kw):
    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.mcmc.driver import Engine
    from bpp_tpu_torch.testing import write_simulated_run
    run = load_run_from_ctl(write_simulated_run(
        tmp_path, n_loci=n_loci, seqs=seqs, n_sites=n_sites,
        priors=priors, **kw))
    run.cfg = run.cfg.replace(dtype="float64")
    return Engine(run, seed=seed, device="cpu")


def _check_caches(eng, st):
    """Every cache of ``st`` equals a fresh computation, the gene trees
    are valid and the species tables match the topology."""
    from bpp_tpu_torch.mcmc import stree_moves as smp
    from bpp_tpu_torch.mcmc.clock_moves import lnprior_rates
    from bpp_tpu_torch.testing import gene_tree_faults
    assert gene_tree_faults(st.gt, eng.ctx.n_seq) == []
    assert bool(torch.isfinite(st.logpr).all())
    ll = eng._logl_fn(st.gt, st.subst, st.sp, st.clock)
    lp, c, t2 = eng._logpr_fn(st.gt, st.sp, st.subst.heredity)
    np.testing.assert_allclose(st.logl.numpy(), ll.numpy(), rtol=1e-12,
                               atol=1e-9)
    np.testing.assert_allclose(st.logpr.numpy(), lp.numpy(), rtol=1e-12,
                               atol=1e-9)
    if st.coal is not None:
        assert torch.equal(st.coal, c)
        np.testing.assert_allclose(st.t2h.numpy(), t2.numpy(), rtol=1e-12,
                                   atol=1e-15)
    if st.clock is not None and eng.cfg.clock.value == 3:
        np.testing.assert_allclose(
            st.clock.lnrates.numpy(),
            lnprior_rates(eng.cfg, st.sp, st.subst.mu, st.clock).numpy(),
            rtol=1e-12, atol=1e-9)
    sp = st.sp
    pp = smp._recompute_pptable(sp.parent, sp.n_nodes)
    assert torch.equal(pp, sp.pptable)
    assert torch.equal(smp._recompute_mrca(pp), sp.mrca)
    assert int(sp.parent[-1]) == -1


def _accepted_moves(eng, n_iter, want=6):
    """Run ``n_iter`` iterations, each followed by one extra species SPR
    and one SNL; check the caches after every accepted species move and
    return the states after accepted moves as {"spr": [...], "snl":
    [...]} (at most ``want`` each)."""
    from bpp_tpu_torch.mcmc import stree_moves as smp
    st = eng.init_state()
    _check_caches(eng, st)
    out = {"spr": [], "snl": []}
    for _ in range(n_iter):
        st, _ = eng._step(st)
        for kind, move in (("spr", smp.species_spr_move),
                           ("snl", smp.snl_move)):
            st, (_, acc) = move(eng.ctx, eng.cfg, st, eng.gen)
            if int(acc):
                _check_caches(eng, st)
                if len(out[kind]) < want:
                    out[kind].append(st)
        if all(len(v) >= want for v in out.values()):
            break
    return out


@pytest.fixture(scope="module")
def a01_states(tmp_path_factory):
    """States after accepted SPR and SNL moves of a float64 A01 chain
    under the prior (SNL is rarely accepted on data) on 3 simulated loci
    of 100 sites, one sequence a species."""
    eng = _engine(tmp_path_factory.mktemp("a01"), (SNL_ON,),
                  seqs=(1, 1, 1, 1), n_loci=3, n_sites=100, usedata=0,
                  thetaprior="gamma 2 200", tauprior="gamma 2 100")
    out = _accepted_moves(eng, 400, want=4)
    assert len(out["spr"]) >= 3 and len(out["snl"]) >= 2, \
        {k: len(v) for k, v in out.items()}
    return eng, out


@pytest.mark.parametrize("priors", [
    ("thetaprior = invgamma 3 0.03 int",),
    ("clock = 3 10 100 5 gdir LN", "locusrate = 1 10 10 5 iid"),
    ("clock = 2 10 100 5 iid G", "locusrate = 1 10 10 5 iid"),
], ids=["integrated", "clock3", "clock2"])
def test_caches_exact_after_species_moves(tmp_path, priors):
    eng = _engine(tmp_path, (SNL_ON,) + priors, n_sites=4)
    out = _accepted_moves(eng, 60, want=3)
    assert out["spr"], "no species SPR accepted"


def test_species_tables_match_bpp_tpu_after_spr(a01_states):
    from bpp_tpu.mcmc import stree_moves as smj
    eng, out = a01_states
    for st in out["spr"] + out["snl"]:
        H = st.sp.n_nodes
        pp = smj._recompute_pptable(jnp.asarray(st.sp.parent.numpy()), H)
        np.testing.assert_array_equal(st.sp.pptable.numpy(), np.asarray(pp))
        np.testing.assert_array_equal(st.sp.mrca.numpy(),
                                      np.asarray(smj._recompute_mrca(pp)))


def _rk(subst):
    return torch.cat([subst.rates, subst.kappa1[:, None],
                      subst.kappa2[:, None]], dim=1)


@pytest.mark.parametrize("model_name,n_cats", [("JC69", 1), ("HKY", 4)])
def test_plain_lnl_on_moved_trees_matches_bpp_tpu(a01_states, model_name,
                                                  n_cats):
    from bpp_tpu.config import SubstModel as SMJ
    from bpp_tpu.core import felsenstein as fej
    from bpp_tpu.mcmc import state as stj
    from bpp_tpu.trees import gtree as gj
    from bpp_tpu_torch.core import pack
    from bpp_tpu_torch.testing import fixed_subst
    from bpp_tpu_torch.trees.gtree import inner_order
    eng, out = a01_states
    ctx = eng.ctx
    for st in out["spr"] + out["snl"]:
        gt = st.gt
        L = gt.n_loci
        model, subst = fixed_subst(model_name, n_cats, L, torch.float64)
        got = pack.site_logl_packed_ref(
            inner_order(gt), gt.left, gt.right, gt.parent, ctx.n_seq,
            gt.age, subst.mu, _rk(subst), subst.freqs, subst.eigw,
            subst.eigT, subst.eigTi, ctx.tip_partials, ctx.weights,
            model=model, n_cats=n_cats).numpy()
        gtj = gj.GTrees(*(jnp.asarray(x.numpy()) for x in gt[:4]))
        sj = stj.SubstState(*(jnp.asarray(x.numpy()) for x in subst))
        pm = stj.compute_pmats(gtj, sj, SMJ[model_name])
        want = np.asarray(fej.loglikelihood(
            gtj, jnp.asarray(ctx.tip_partials.numpy()),
            jnp.asarray(ctx.weights.numpy()), jnp.asarray(ctx.n_seq.numpy()),
            pm, sj.freqs, jnp.full((n_cats,), 1.0 / n_cats, jnp.float64)))
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-10)


def test_bpp_tpu_kernel_on_moved_trees(a01_states, monkeypatch):
    """bpp_tpu's K1 (Pallas, interpret mode) against the port's float32
    pass on the gene trees after accepted SPR and SNL moves."""
    from bpp_tpu.config import SubstModel as SMJ
    from bpp_tpu.core.pallas_pack import build_pack_layout
    from bpp_tpu.core.pallas_pack import site_logl_packed as k1
    from bpp_tpu_torch.core import pack
    from bpp_tpu_torch.testing import fixed_subst
    from bpp_tpu_torch.trees.gtree import inner_order
    monkeypatch.setenv("BPP_TPU_PALLAS", "interpret")
    eng, out = a01_states
    ctx = eng.ctx
    layout = build_pack_layout(
        ctx.tip_partials.numpy().astype(np.float32),
        ctx.weights.numpy().astype(np.float32),
        np.asarray(eng.run.batch.n_pat), ctx.n_seq.numpy(),
        ctx.locus_mask.numpy())

    def j32(x):
        return jnp.asarray(x.numpy().astype(np.float32))

    def i32(x):
        return jnp.asarray(x.numpy().astype(np.int32))

    for st in out["spr"][:2] + out["snl"][:2]:
        gt = st.gt
        model, subst = fixed_subst("HKY", 4, gt.n_loci, torch.float32)
        order = inner_order(gt)
        got = pack.site_logl_packed(
            order, gt.left, gt.right, gt.parent, ctx.n_seq,
            gt.age.float(), subst.mu, _rk(subst), subst.freqs, subst.eigw,
            subst.eigT, subst.eigTi, ctx.tip_partials.float(),
            ctx.weights.float(), model=model, n_cats=4).numpy()
        want = np.asarray(k1(
            layout, i32(order), i32(gt.left), i32(gt.right), i32(gt.parent),
            i32(ctx.n_seq), j32(gt.age), j32(subst.mu), j32(_rk(subst)),
            j32(subst.freqs), j32(subst.eigw), j32(subst.eigT),
            j32(subst.eigTi), model=SMJ.HKY, n_cats=4))
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-3)


def test_constraint_respected_under_prior(tmp_path):
    from collections import Counter

    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.mcmc.driver import Engine
    from bpp_tpu_torch.mcmc.state import MV_SSPR
    cf = tmp_path / "cons.txt"
    cf.write_text("constraint = (A, B);\n")
    ctl = write_dummy(tmp_path, "ABCD", "(((A,B),C),D)",
                      extra=f"speciestree = 1 0\nconstraintfile = {cf}")
    run = load_run_from_ctl(ctl)
    run.cfg = run.cfg.replace(dtype="float64")
    eng = Engine(run, seed=7, device="cpu")
    st = eng.init_state()
    seen = []
    acc = torch.zeros((23, 2), dtype=torch.int64)
    for _ in range(600):
        st, stats = eng._step(st)
        acc += stats
        seen.append(canon(st.sp.left, st.sp.right, st.sp.parent,
                          run.stree.names))
    assert int(acc[MV_SSPR, 1]) > 0
    want = {"(((A,B),C),D)", "(((A,B),D),C)", "((A,B),(C,D))"}
    assert set(seen) == want, Counter(seen)
    seen = np.asarray(seen[60:])
    for topo in want:
        x = (seen == topo).astype(float)[:520].reshape(20, -1).mean(1)
        se = x.std(ddof=1) / np.sqrt(20)
        assert abs(x.mean() - 1 / 3) < 4 * se + 1e-9, (topo, x.mean(), se)


def test_snl_with_constraints_refused(tmp_path):
    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.mcmc.driver import Engine
    cf = tmp_path / "cons.txt"
    cf.write_text("constraint = (A, B);\n")
    ctl = write_dummy(tmp_path, "ABCD", "(((A,B),C),D)",
                      extra=f"speciestree = 1\nconstraintfile = {cf}")
    with pytest.raises(NotImplementedError, match="SNL"):
        Engine(load_run_from_ctl(ctl), device="cpu")


@pytest.fixture(scope="module")
def bpp_tpu_a01(tmp_path_factory):
    """``bpp_tpu``'s engine, state and configuration on ``a01_states``'
    configuration (the same four species, one sequence each), float64."""
    from bpp_tpu.loader import load_run_from_ctl as load_j
    from bpp_tpu.mcmc.driver import Engine as EJ
    from bpp_tpu_torch.testing import write_simulated_run
    ctl = write_simulated_run(
        tmp_path_factory.mktemp("a01j"), n_loci=3, seqs=(1, 1, 1, 1),
        n_sites=100, priors=(SNL_ON,), usedata=0, thetaprior="gamma 2 200",
        tauprior="gamma 2 100")
    run = load_j(ctl)
    run.cfg = run.cfg.replace(dtype="float64")
    eng = EJ(run, seed=3)
    return eng, eng.init_state()


# the local variables of bpp_tpu's snl_move the comparison reads
SNL_LOCALS = ("sel", "shrink", "y", "x", "a", "b_node", "c", "lca",
              "went_down", "wdone", "wbad", "bad", "logp_sel", "term_pe",
              "term_sh", "term_ed", "w2", "rev_node", "sp_scaled",
              "taufactor", "tau_new", "tau0", "tau0n", "rt", "nleft",
              "nright", "nparent", "ntau", "root_new", "k_mt", "swap", "u_d",
              "k_walk")


def _bpp_tpu_snl_locals(eng_j, state_j, monkeypatch):
    """A jitted function of (species arrays, key) that returns the local
    variables ``SNL_LOCALS`` of ``bpp_tpu``'s ``snl_move`` at its accept
    draw (rejected there), read while it is traced."""
    import sys

    import jax
    from bpp_tpu.mcmc import stree_moves as smj

    def capture(k, lnacc, *args, **kw):
        frame = sys._getframe(1).f_locals
        capture.out = {name: frame[name] for name in SNL_LOCALS}
        return jnp.asarray(False)

    monkeypatch.setattr(smj.rng, "mh_accept", capture)

    def run(left, right, parent, tau, pptable, mrca, key):
        spj = state_j.sp._replace(left=left, right=right, parent=parent,
                                  tau=tau, pptable=pptable, mrca=mrca)
        smj.snl_move(eng_j.ctx, eng_j.cfg, state_j._replace(sp=spj), key)
        return capture.out

    jitted = jax.jit(run)

    def call(sp, key):
        return jitted(jnp.asarray(sp.left.numpy(), jnp.int32),
                      jnp.asarray(sp.right.numpy(), jnp.int32),
                      jnp.asarray(sp.parent.numpy(), jnp.int32),
                      jnp.asarray(sp.tau.numpy()),
                      jnp.asarray(sp.pptable.numpy()),
                      jnp.asarray(sp.mrca.numpy(), jnp.int32),
                      jax.random.PRNGKey(key))
    return call


def _port_uniforms(cap, sp, H):
    """The uniforms that make the port's species-level part take
    ``bpp_tpu``'s draws: its move type and delta uniforms, its walk's,
    its child split, and a uniform inside the port's inverse-CDF interval
    of the focal node ``bpp_tpu`` drew (Gumbel-max there)."""
    import jax
    tau = sp.tau.numpy()
    parent = sp.parent.numpy()
    NS = (H + 1) // 2
    partau = np.where(parent >= 0, tau[np.maximum(parent, 0)], np.inf)
    feas = (np.arange(H) >= NS) & (parent >= 0) & (tau > 0)
    w = np.where(feas, 1.0 / np.sqrt(np.maximum(partau - tau, 1e-30)), 0.0)
    wn = w / max(w.sum(), 1e-300)
    logits = np.where(feas, np.log(np.maximum(wn, 1e-300)), -1e30)
    cdf = np.cumsum(np.exp(logits - logits.max()))
    sel = int(cap["sel"])
    lo = cdf[sel - 1] if sel else 0.0
    u = [float(jax.random.uniform(cap["k_mt"])),
         0.5 * (lo + cdf[sel]) / cdf[-1],
         0.25 if bool(cap["swap"]) else 0.75, float(cap["u_d"])]
    kk = cap["k_walk"]
    for _ in range(4 * H + 16):
        kk, k1, k2 = jax.random.split(kk, 3)
        u += [float(jax.random.uniform(k1)), float(jax.random.uniform(k2))]
    return torch.tensor(u, dtype=torch.float64)


def test_snl_species_part_matches_bpp_tpu(a01_states, bpp_tpu_a01,
                                          monkeypatch):
    """SNL's species-level part on the device (``snl_species``: the focal
    choice, the delta walk, the proposal densities, the new species
    arrays, the reverse terms) against ``bpp_tpu``'s ``snl_move`` on the
    same trees with the same draws: integers exact, floats at float64
    round-off, over the first tree and those after accepted species moves,
    eight keys each.  ``bpp_tpu`` flags every landing on a tip branch as
    invalid (its walk goes on checking after it stopped; ROADMAP Queue 3):
    the port's flag differs only there, and the rest of such a proposal
    is compared too."""
    from bpp_tpu_torch.mcmc import stree_moves as smp
    eng, out = a01_states
    eng_j, state_j = bpp_tpu_a01
    cfg = eng.cfg
    kinds = {"shrink": 0, "expand": 0, "expand-down": 0}
    snl_j = _bpp_tpu_snl_locals(eng_j, state_j, monkeypatch)
    trees = [eng.init_state().sp] + [st.sp for st in out["spr"]
                                     + out["snl"]]
    for sp in trees:
        H = sp.n_nodes
        NS = (H + 1) // 2
        for key in range(8):
            cap = snl_j(sp, key)
            got = smp.snl_species(cfg, sp, _port_uniforms(cap, sp, H))

            def j(name):
                return np.asarray(cap[name])

            for name, want in (("sel", "sel"), ("shrink", "shrink"),
                               ("y", "y"), ("a", "a"), ("c", "c"),
                               ("went_down", "went_down"),
                               ("done", "wdone")):
                assert int(getattr(got, name)) == int(j(want)), (key, name)
            pure = ~j("shrink") & ~j("went_down")
            term = np.where(pure, j("term_pe"),
                            np.where(j("shrink"), j("term_sh"),
                                     j("term_ed")))
            lnacc_j = (-j("logp_sel") + term
                       + np.log(max(j("w2")[int(j("rev_node"))], 1e-300))
                       + j("sp_scaled") * np.log(j("taufactor"))
                       + np.where(abs(j("tau0n") - j("tau0")) > 1e-20,
                                  j("rt"), 0.0))
            bad_j = bool(j("bad")) or not np.isfinite(lnacc_j)
            if bool(got.bad) != bad_j:
                # bpp_tpu's check after the walk stopped, on a tip branch
                assert bad_j and bool(j("wbad")) and not bool(got.wbad) \
                    and int(got.c) < NS, (key, int(got.c))
            if bool(got.bad):
                continue
            kinds["shrink" if bool(got.shrink) else
                  "expand-down" if bool(got.went_down) else "expand"] += 1
            for name in ("x", "b_node", "lca", "sp_scaled", "root_new"):
                want = {"sp_scaled": "sp_scaled", "root_new": "root_new"}
                assert int(getattr(got, name)) == int(j(want.get(name, name))), \
                    (key, name)
            for name, want in (("left", "nleft"), ("right", "nright"),
                               ("parent", "nparent")):
                np.testing.assert_array_equal(getattr(got, name).numpy(),
                                              j(want))
            np.testing.assert_allclose(got.tau.numpy(), j("ntau"),
                                       rtol=1e-13)
            for name in ("tau_new", "taufactor"):
                np.testing.assert_allclose(float(getattr(got, name)),
                                           float(j(name)), rtol=1e-13)
            np.testing.assert_allclose(float(got.lnacc), float(lnacc_j),
                                       rtol=1e-10, atol=1e-10)
    assert all(kinds.values()), kinds
