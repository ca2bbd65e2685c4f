"""MSC-I networks in the PyTorch port against ``bpp_tpu``.

* ``species_arrays`` on the networks of ``tests/fixtures/msci``,
  ``test_clock.py`` (htau = 1 and htau = 0), the four-species network of
  ``testing.NET_GUIDE`` and the BDI network: every field equal.
* ``init_gtrees``: the same gene trees and hybridization flags.
* On states of a short float64 ``bpp_tpu`` chain on ``m.ctl`` with data
  (and the same trees with random flags, where routes disagree), handed
  over by ``convert.state_from_numpy``: ``route_step``,
  ``assign_populations_net``, ``route_consistent`` and ``edge_passes``
  exact; ``per_pop_stats``, ``phi_entry_counts`` and ``logpr_fn`` (phi
  terms, validity) at 1e-10; the plain likelihood on those trees, strict
  and with relaxed (clock = 2) lengths; ``phi_gibbs_move``'s Beta
  parameters.  The BDI fixture's starting trees check the BDI branches.
* The float32 phi floor: a phi of 0 gives a finite density where no
  lineage enters, not NaN.
* A seeded port chain of 30 steps: caches exact and routes consistent
  after every step.

Prior recovery on the network is ``test_torch_msci_prior.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpp_tpu.trees import coalescent as cj
from bpp_tpu.trees import gtree as gj
from bpp_tpu_torch.testing import NET_GUIDE, port_state
from bpp_tpu_torch.trees import coalescent as cp
from bpp_tpu_torch.trees import gtree as gp

torch.set_num_threads(1)     # tiny tensors; the suite runs in parallel

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
M_NWK = "((A,(B)H[&phi=0.4,&tau-parent=yes]),(H[&tau-parent=yes],C))R;"
NETWORKS = {
    "m": (M_NWK, "ABC"),
    "htau0": (M_NWK.replace("phi=0.4,&tau-parent=yes",
                            "phi=0.4,&tau-parent=no"), "ABC"),
    "four": (NET_GUIDE + ";", "ABCD"),
    "bdi": ("(((A,Y[&phi=0.300000])X,(B,X[&phi=0.200000])Y)S, C)R;", "ABC"),
}


def _trees(name):
    from bpp_tpu.trees.stree import SpeciesTree as SJ
    from bpp_tpu_torch.trees.stree import SpeciesTree as SP
    nwk, tips = NETWORKS[name]
    rng = np.random.default_rng(1)
    stj, stp = SJ.from_newick(nwk, list(tips)), SP.from_newick(nwk,
                                                               list(tips))
    theta = rng.uniform(0.002, 0.01, stj.n_nodes)
    for st in (stj, stp):
        st.tau[:] = np.where(np.arange(st.n_nodes) >= st.n_tips, 0.01, 0.0)
        st.theta[:] = theta
    return stj, stp


def _eq(port, jax_arr, what=""):
    if jax_arr is None:
        assert port is None, what
        return
    a, b = port.detach().cpu().numpy(), np.asarray(jax_arr)
    assert a.shape == b.shape, what
    if b.dtype.kind == "f":
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10, err_msg=what)
    else:
        np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("name", list(NETWORKS))
def test_species_arrays_equal(name):
    stj, stp = _trees(name)
    spj = gj.species_arrays(stj, dtype=jnp.float64)
    spp = gp.species_arrays(stp)
    for f in spj._fields:
        _eq(getattr(spp, f), getattr(spj, f), f)
    for prop in ("n_nodes", "n_hybrids", "n_bdi_slots", "n_tips", "root",
                 "is_network"):
        assert getattr(spp, prop) == getattr(spj, prop), prop


# --- states -------------------------------------------------------------------

M_CTL = open(os.path.join(FIX, "msci", "m.ctl")).read().replace(
    "usedata = 0", "usedata = 1").replace("seqfile = d.txt",
                                          "seqfile = d.txt\nmodel = 0")


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """(bpp_tpu engine, port engine, [bpp_tpu states]): the initial state
    and two later states of a float64 chain on m.ctl with data."""
    from bpp_tpu.io.ctl import parse_ctl_lines
    from bpp_tpu.loader import load_run
    from bpp_tpu.mcmc.driver import Engine
    from bpp_tpu_torch.io.ctl import parse_ctl_lines as parse_p
    from bpp_tpu_torch.loader import load_run as load_p
    from bpp_tpu_torch.mcmc.driver import Engine as EngineP
    d = tmp_path_factory.mktemp("msci")
    for f in ("d.txt", "d.imap"):
        (d / f).write_text(open(os.path.join(FIX, "msci", f)).read())
    # data with variation: every sequence is the same A's in the fixture
    rng = np.random.default_rng(0)
    lines = (d / "d.txt").read_text().splitlines()
    lines[1:7] = [ln.split()[0] + " " + "".join(rng.choice(list("ACGT"), 20))
                  for ln in lines[1:7]]
    (d / "d.txt").write_text("\n".join(lines) + "\n")
    (d / "m.ctl").write_text(M_CTL)
    cwd = os.getcwd()
    os.chdir(d)
    try:
        cfgj = parse_ctl_lines(M_CTL.splitlines()).replace(dtype="float64")
        engj = Engine(load_run(cfgj), seed=3)
        cfgp = parse_p(M_CTL.splitlines()).replace(dtype="float64")
        engp = EngineP(load_p(cfgp), seed=3, device="cpu")
    finally:
        os.chdir(cwd)
    s0 = engj.init_state()
    s1, _ = engj.chunk_step(s0, jax.random.PRNGKey(1), 6)
    return engj, engp, [s0, s1]


# bpp_tpu's functions, compiled once for every state of the tests
J = {name: jax.jit(fn) for name, fn in (
    ("route_step", gj.route_step),
    ("pops", gj.assign_populations_net),
    ("consistent", gj.route_consistent),
    ("passes", gj.edge_passes),
    ("lift", gj.lift_population_net),
    ("stats", cj.per_pop_stats),
    ("entry", cj.phi_entry_counts))}


def _random_flags(sj, seed):
    """``sj`` with random hybridization flags: routes that disagree."""
    rng = np.random.default_rng(seed)
    hp = rng.integers(0, 2, np.shape(sj.gt.hpath)).astype(np.int8)
    return sj._replace(gt=sj.gt._replace(hpath=jnp.asarray(hp)))


def _states(chain):
    """The chain's states, and its last state's trees with random flags."""
    engj, engp, states = chain
    return states + [_random_flags(states[-1], k) for k in range(3)]


def test_route_walks_exact(chain):
    engj, engp, _ = chain
    seen_bad = False
    for sj in _states(chain):
        st = port_state(sj, engp.cfg)
        tp = engp.ctx.tip_pop
        tj = engj.ctx.tip_pop
        H, HY = st.sp.n_nodes, st.sp.n_hybrids
        # route_step from every population under every flag combination
        p = torch.arange(H).repeat(1 << HY)
        fl = ((torch.arange(1 << HY)[:, None] >> torch.arange(HY)) & 1) \
            .repeat_interleave(H, 0).to(torch.int8)
        _eq(gp.route_step(st.sp, p, fl),
            J["route_step"](sj.sp, jnp.asarray(p.numpy()),
                          jnp.asarray(fl.numpy())), "route_step")
        pops = gp.assign_populations_net(st.gt, st.sp, tp)
        pj = J["pops"](sj.gt, sj.sp, tj)
        _eq(pops, pj, "pops")
        ok = gp.route_consistent(st.gt, st.sp, pops, engp.ctx.n_seq)
        _eq(ok, J["consistent"](sj.gt, sj.sp, pj, engj.ctx.n_seq),
            "route_consistent")
        seen_bad |= not bool(ok.all())
        _eq(gp.edge_passes(st.gt, st.sp, pops),
            J["passes"](sj.gt, sj.sp, pj), "edge_passes")
        # lift from every population at every gene-node age
        age = st.gt.age[0].clamp(max=1.0)
        base = torch.arange(H)[:, None].expand(H, age.shape[0])
        flags = st.gt.hpath[0][None].expand(H, -1, -1)
        lifted = gp.lift_population_net(st.sp, base, age[None].expand(H, -1),
                                        flags)
        _eq(lifted,
            J["lift"](
                sj.sp, jnp.asarray(base.numpy()),
                jnp.asarray(age[None].expand(H, -1).numpy()),
                jnp.asarray(flags.numpy())), "lift")
    assert seen_bad, "no state with disagreeing routes"


def test_densities_and_phi_terms(chain):
    from bpp_tpu.mcmc.state import make_logpr_fn as lpj
    from bpp_tpu_torch.mcmc.msci_moves import phi_beta_params
    from bpp_tpu_torch.mcmc.state import make_logpr_fn
    engj, engp, _ = chain
    logpr_j = jax.jit(lpj(engj.ctx))
    for sj in _states(chain):
        st = port_state(sj, engp.cfg)
        pops = gp.assign_populations(st.gt, st.sp, engp.ctx.tip_pop)
        pj = J["pops"](sj.gt, sj.sp, engj.ctx.tip_pop)
        c, t2, n_in = cp.per_pop_stats(st.gt, st.sp, pops, engp.ctx.n_seq)
        cj_, t2j, nj = J["stats"](sj.gt, sj.sp, pj, engj.ctx.n_seq)
        _eq(c, cj_, "coal")
        _eq(t2, t2j, "T2h")
        _eq(n_in, nj, "n_in")
        _eq(cp.phi_entry_counts(st.sp, n_in),
            J["entry"](sj.sp, nj), "phi_entry_counts")
        lp, _, _ = make_logpr_fn(engp.ctx)(st.gt, st.sp, st.subst.heredity)
        lpj_, _, _ = logpr_j(sj.gt, sj.sp, sj.subst.heredity)
        _eq(lp, lpj_, "logpr")
        # phi_gibbs_move's Beta(a, b), from bpp_tpu's route counts
        a, b = phi_beta_params(engp.ctx, engp.cfg, st)
        tot = np.asarray(J["entry"](sj.sp, nj)).sum(0)
        hin = np.asarray(sj.sp.hslot)
        mir = np.asarray(sj.sp.hybrid)[hin]
        _eq(a, 1.0 + tot[hin], "phi a")
        _eq(b, 1.0 + tot[mir], "phi b")


def test_plain_likelihood_strict_and_relaxed(chain):
    from bpp_tpu.core import felsenstein as fj
    from bpp_tpu.mcmc.state import compute_pmats as cpj
    from bpp_tpu_torch.core import felsenstein as fp
    from bpp_tpu_torch.mcmc.state import compute_pmats
    engj, engp, _ = chain
    ctxj, model = engj.ctx, engj.cfg.model

    @jax.jit
    def relaxed_j(gt, subst, sp, br):
        blen = fj.relaxed_branch_lengths(
            gt, sp, gj.assign_populations(gt, sp, ctxj.tip_pop), br)
        ll = fj.loglikelihood(gt, ctxj.tip_partials, ctxj.weights,
                              ctxj.n_seq, cpj(gt, subst, model, blen=blen),
                              subst.freqs, jnp.ones(1, jnp.float64),
                              res_map=ctxj.res_map, res_count=ctxj.res_count)
        return blen, ll

    strict_j = jax.jit(engj._logl_fn)
    rng = np.random.default_rng(5)
    for sj in _states(chain)[:2]:
        st = port_state(sj, engp.cfg)
        _eq(engp._logl_fn(st.gt, st.subst), strict_j(sj.gt, sj.subst),
            "strict logl")
        br = rng.uniform(0.5, 2.0, (st.gt.n_loci, st.sp.n_nodes))
        pops = gp.assign_populations(st.gt, st.sp, engp.ctx.tip_pop)
        blen = fp.relaxed_branch_lengths(st.gt, st.sp, pops,
                                         torch.as_tensor(br))
        ll = fp.loglikelihood(st.gt, engp.ctx.tip_partials,
                              engp.ctx.weights, engp.ctx.n_seq,
                              compute_pmats(st.gt, st.subst, engp.cfg.model,
                                            blen=blen), st.subst.freqs,
                              torch.ones(1, dtype=torch.float64))
        bj, lj = relaxed_j(sj.gt, sj.subst, sj.sp, jnp.asarray(br))
        _eq(blen, bj, "relaxed lengths")
        _eq(ll, lj, "relaxed logl")


@pytest.fixture(scope="module")
def bdi_start():
    """bpp_tpu's and the port's starting trees on the BDI fixture."""
    from bpp_tpu.io.ctl import parse_ctl_lines
    from bpp_tpu.loader import init_tau_theta, load_run
    from bpp_tpu_torch.io.ctl import parse_ctl_lines as parse_p
    from bpp_tpu_torch.loader import init_tau_theta as init_p
    from bpp_tpu_torch.loader import load_run as load_p
    text = f"""seed = 7
seqfile = {FIX}/bdi/bdi_seqs.txt
Imapfile = {FIX}/bdi/bdi_imap.txt
jobname = out
species&tree = 3 A B C
               4 4 2
               {NETWORKS["bdi"][0]}
nloci = 30
cleandata = 0
model = JC69
thetaprior = gamma 2 1000
tauprior = gamma 4 100
phiprior = 1 1
burnin = 2
sampfreq = 1
nsample = 2
""".splitlines()
    runj = load_run(parse_ctl_lines(text))
    runp = load_p(parse_p(text))
    init_tau_theta(runj.cfg, runj.stree, np.random.default_rng(4))
    init_p(runp.cfg, runp.stree, np.random.default_rng(4))
    gtj = gj.init_gtrees(9, runj.batch, runj.stree, dtype=jnp.float64)
    gtp = gp.init_gtrees(9, runp.batch, runp.stree)
    return runj, runp, gtj, gtp


@pytest.mark.parametrize("which", ["m", "bdi"])
def test_init_gtrees_equal(chain, bdi_start, which):
    if which == "bdi":
        runj, runp, gtj, gtp = bdi_start
    else:
        engj, engp, _ = chain
        runj, runp = engj.run, engp.run
        # the taus and thetas bpp_tpu's init_state drew
        runp.stree.tau[:] = runj.stree.tau
        runp.stree.theta[:] = runj.stree.theta
        gtj = gj.init_gtrees(9, runj.batch, runj.stree, dtype=jnp.float64)
        gtp = gp.init_gtrees(9, runp.batch, runp.stree)
    assert gtp.hpath.dtype == torch.int8
    for f in gtj._fields:
        _eq(getattr(gtp, f), getattr(gtj, f), f)


def test_bdi_routes_and_entry_counts(bdi_start):
    runj, runp, gtj, gtp = bdi_start
    spj = gj.species_arrays(runj.stree, dtype=jnp.float64)
    spp = gp.species_arrays(runp.stree)
    tj = jnp.asarray(runj.batch.tip_pop)
    tp = torch.as_tensor(runp.batch.tip_pop, dtype=torch.int64)
    nsj = jnp.asarray(runj.batch.n_seq)
    nsp = torch.as_tensor(runp.batch.n_seq, dtype=torch.int64)
    pj = J["pops"](gtj, spj, tj)
    pops = gp.assign_populations(gtp, spp, tp)
    _eq(pops, pj, "pops")
    _eq(gp.route_consistent(gtp, spp, pops, nsp),
        J["consistent"](gtj, spj, pj, nsj), "route_consistent")
    _eq(gp.edge_passes(gtp, spp, pops), J["passes"](gtj, spj, pj),
        "edge_passes")
    _, _, n_in = cp.per_pop_stats(gtp, spp, pops, nsp)
    _, _, nj = J["stats"](gtj, spj, pj, nsj)
    eff = cp.phi_entry_counts(spp, n_in)
    _eq(eff, J["entry"](spj, nj), "BDI entry counts")
    assert bool((eff != n_in).any()), "no partner-side switcher"


def test_phi_floor_in_float32():
    """A float32 phi of exactly 0 on a side no lineage enters gives a
    finite density (the floor is finfo.tiny, not 1e-300, which float32
    holds as 0: 0 * log(0) would be NaN)."""
    from bpp_tpu_torch.mcmc.state import make_logpr_fn
    _, stp = _trees("m")
    sp = gp.species_arrays(stp, dtype=torch.float32)
    hin = int(sp.hslot[0])
    mir = int(sp.hybrid[hin])
    phi = sp.phi.clone()
    phi[hin], phi[mir] = 1.0, 0.0
    sp = sp._replace(phi=phi)
    # one locus, two sequences of A: no lineage reaches a hybridization
    gt = gp.GTrees(left=torch.tensor([[0, 0, 0]]),
                   right=torch.tensor([[0, 0, 1]]),
                   parent=torch.tensor([[2, 2, -1]]),
                   age=torch.tensor([[0.0, 0.0, 0.02]]),
                   hpath=torch.zeros((1, 3, 1), dtype=torch.int8))
    from bpp_tpu_torch.mcmc.state import Ctx
    ctx = Ctx(tip_partials=torch.zeros((1, 2, 1, 4)),
              weights=torch.ones((1, 1)), n_seq=torch.tensor([2]),
              tip_pop=torch.tensor([[0, 0]]),
              locus_mask=torch.tensor([True]))
    lp, _, _ = make_logpr_fn(ctx)(gt, sp, torch.ones(1))
    assert torch.isfinite(lp).all(), lp
    # and the float64 value is bpp_tpu's (floor 1e-300)
    sp64 = sp._replace(phi=phi.double(), tau=sp.tau.double(),
                       theta=sp.theta.double())
    lp64, _, _ = make_logpr_fn(ctx)(gt._replace(age=gt.age.double()), sp64,
                                    torch.ones(1, dtype=torch.float64))
    assert abs(float(lp64[0]) - float(lp[0])) < 1e-3 * abs(float(lp64[0]))


def test_port_chain_caches_exact_and_routes_consistent(chain):
    from bpp_tpu_torch.trees.gtree import route_consistent
    _, engp, _ = chain
    state = engp.init_state()
    for _ in range(30):
        state, _ = engp.chunk_step(state, 1)
        pops = gp.assign_populations(state.gt, state.sp, engp.ctx.tip_pop)
        assert bool(route_consistent(state.gt, state.sp, pops,
                                     engp.ctx.n_seq).all())
        assert engp.validate_state(state)
    assert float(state.sp.phi[state.sp.hslot[0]]) != 0.4
