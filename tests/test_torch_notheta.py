"""Integrated-out thetas (``thetaprior = invgamma a b int``) in the port,
on the CPU in float64.

* ``msc_logprob_integrated`` equals bpp_tpu's on random counts and
  waiting sums with a padded locus (rtol 1e-10).
* The host accept chain (``notheta.accept_chain``, what kernel K3 is
  held against on the card) takes the same decisions as bpp_tpu's
  ``scan_accept`` on the same uniforms (exact booleans), for
  gene-tree-like proposals and for heredity proposals, and in the
  regimes K3's lookahead stresses: every proposing locus accepted, none,
  alternating runs, 1 and 40 populations, 61 loci, proposing loci that
  change no population, and every decision within 1e-7..1e-6 of its
  threshold under the serial carry (a decision taken under another
  carry would differ).
* After each move of the chain (ages, SPR, tau, mixing, heredity) the
  ``coal``/``t2h`` caches equal a fresh evaluation exactly and ``logl``
  to float64 roundoff; logpr stays 0.
* With ``usedata = 0`` the chain recovers the tau prior (root tau and
  the mean of the inner taus within 4 Monte Carlo standard errors).
* mcmc.txt has bpp_tpu's header: no theta columns.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpp_tpu_torch.mcmc import moves, notheta, subst_moves

torch.set_num_threads(1)     # tiny tensors; the suite runs in parallel

PRIORS = ("heredity = 1 4 4",)
THETA = "invgamma 3 0.03 int"


@pytest.fixture(scope="module")
def ctl(tmp_path_factory):
    from bpp_tpu_torch.testing import write_simulated_run
    tmp = tmp_path_factory.mktemp("torchnotheta")
    return write_simulated_run(tmp, n_loci=6, n_sites=80, thetaprior=THETA,
                               priors=PRIORS, burnin=5, nsample=10)


def _port_engine(ctl, seed=7):
    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.mcmc.driver import Engine
    run = load_run_from_ctl(ctl)
    run.cfg = run.cfg.replace(dtype="float64")
    return Engine(run, seed=seed, device="cpu")


def test_msc_logprob_integrated_matches_bpp_tpu():
    from bpp_tpu.trees.coalescent import msc_logprob_integrated as mj
    from bpp_tpu_torch.trees.coalescent import msc_logprob_integrated
    rng = np.random.default_rng(2)
    L, H = 9, 7
    coal = rng.integers(0, 6, (L, H))
    t2 = rng.gamma(2.0, 0.01, (L, H)) * (coal > 0)
    h = rng.uniform(0.3, 2.0, L)
    mask = np.ones(L, bool)
    mask[-1] = False
    got = msc_logprob_integrated(torch.as_tensor(coal), torch.as_tensor(t2),
                                 torch.as_tensor(h), 3.0, 0.03,
                                 torch.as_tensor(mask))
    want = mj(jnp.asarray(coal), jnp.asarray(t2), jnp.asarray(h), 3.0, 0.03,
              jnp.asarray(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-10)


# (kind, seed, regime, H, L): the first six as before; then the regimes
# K3's lookahead stresses
CHAIN_CASES = [pytest.param(kind, seed, "random", 7, 60, id=f"{kind}-{seed}")
               for kind in ("gene-trees", "heredity") for seed in (0, 1, 2)]
CHAIN_CASES += [
    pytest.param("gene-trees", 3, "all", 7, 60, id="all-accepted"),
    pytest.param("gene-trees", 4, "none", 7, 60, id="none-accepted"),
    pytest.param("gene-trees", 5, "alternating", 7, 60, id="alternating"),
    pytest.param("gene-trees", 6, "random", 1, 60, id="H1"),
    pytest.param("gene-trees", 7, "random", 40, 60, id="H40"),
    pytest.param("gene-trees", 8, "random", 7, 61, id="L61"),
    pytest.param("gene-trees", 9, "unchanged", 7, 60, id="no-change"),
    pytest.param("gene-trees", 10, "edge", 7, 61, id="edge"),
    pytest.param("heredity", 11, "edge", 40, 61, id="heredity-edge"),
]


def _edge_dother(a, b, K0, C0, co, cn, to, tn, dh, logu, mask, rng):
    """dother that puts every proposing locus's decision 1e-7..1e-6 from
    its threshold under the serial walk's carry, accepted or rejected at
    random (the walk of ``notheta.accept_chain``, in the same
    arithmetic)."""
    import math

    def term(k, c):
        return math.lgamma(a + k) - (a + k) * math.log(b + c)
    K, C = [float(k) for k in K0], [float(c) for c in C0]
    g = [term(k, c) for k, c in zip(K, C)]
    dK, dC = (cn - co).tolist(), (tn - to).tolist()
    dother = np.zeros(len(logu))
    for i in np.flatnonzero(mask).tolist():
        dlg, upd = 0.0, []
        for h in range(len(K)):
            if dK[i][h] != 0.0 or dC[i][h] != 0.0:
                k, c = K[h] + dK[i][h], C[h] + dC[i][h]
                x = term(k, c)
                dlg += x - g[h]
                upd.append((h, k, c, x))
        acc = rng.random() < 0.5
        gap = rng.uniform(1e-7, 1e-6)
        dother[i] = logu[i] - dh[i] - dlg + (gap if acc else -gap)
        if acc:
            for h, k, c, x in upd:
                K[h], C[h], g[h] = k, c, x
    return dother


@pytest.mark.parametrize("kind,seed,regime,H,L", CHAIN_CASES)
def test_accept_chain_matches_bpp_tpu_scan_accept(ctl, kind, seed, regime,
                                                  H, L):
    from bpp_tpu.mcmc.notheta import scan_accept as sj
    eng = _port_engine(ctl)
    cfg = eng.cfg
    a, b = cfg.thetaprior.alpha, cfg.thetaprior.beta
    rng = np.random.default_rng(seed)
    coal_o = rng.integers(0, 5, (L, H))
    t2_o = rng.gamma(2.0, 0.02, (L, H)) * (coal_o > 0)
    h_o = rng.uniform(0.5, 1.5, L)
    mask = rng.random(L) < 0.8
    locus_mask = np.ones(L, bool)
    locus_mask[-2:] = False
    mask &= locus_mask
    if kind == "gene-trees":
        # a coalescence moves between two populations, waiting times change
        coal_n = coal_o.copy()
        if H > 1:
            src = rng.integers(0, H, L)
            dst = (src + 1 + rng.integers(0, H - 1, L)) % H
            move = mask & (coal_n[np.arange(L), src] > 0)
            coal_n[np.arange(L)[move], src[move]] -= 1
            coal_n[np.arange(L)[move], dst[move]] += 1
        t2_n = np.where(mask[:, None],
                        t2_o * rng.uniform(0.7, 1.4, (L, H)), t2_o)
        h_n = h_o
    else:
        coal_n, t2_n = coal_o, t2_o
        h_n = np.where(mask, h_o * rng.uniform(0.8, 1.25, L), h_o)
    if regime == "unchanged":
        # a third of the proposing loci propose their current rows
        same = mask & (rng.random(L) < 0.33)
        coal_n = np.where(same[:, None], coal_o, coal_n)
        t2_n = np.where(same[:, None], t2_o, t2_n)
    key = jax.random.PRNGKey(seed)
    us = np.asarray(jax.random.uniform(key, (L,)))
    K0, C0 = notheta.pop_sums(torch.as_tensor(coal_o), torch.as_tensor(t2_o),
                              torch.as_tensor(h_o),
                              torch.as_tensor(locus_mask))
    dh = (coal_n.sum(1) * np.log(2.0 / h_n)
          - coal_o.sum(1) * np.log(2.0 / h_o))
    to, tn = t2_o / h_o[:, None], t2_n / h_n[:, None]
    dother = {"all": np.full(L, 50.0), "none": np.full(L, -50.0),
              "alternating": np.where((np.arange(L) // 3) % 2 == 0, 50.0,
                                      -50.0)}.get(regime)
    if regime == "edge":
        dother = _edge_dother(a, b, K0.numpy(), C0.numpy(), coal_o, coal_n,
                              to, tn, dh, np.log(us), mask, rng)
    elif dother is None:
        dother = rng.normal(0.0, 1.0, L)
    want = np.asarray(sj(key, cfg, jnp.asarray(dother), jnp.asarray(coal_o),
                         jnp.asarray(t2_o), jnp.asarray(h_o),
                         jnp.asarray(coal_n), jnp.asarray(t2_n),
                         jnp.asarray(h_n), jnp.asarray(mask),
                         jnp.asarray(locus_mask)))
    got = notheta.accept_chain(a, b, K0.numpy(), C0.numpy(), coal_o, coal_n,
                               to, tn, dother, dh, np.log(us), mask)
    if regime == "all":
        assert got.sum() == mask.sum()
    elif regime == "none":
        assert got.sum() == 0
    else:
        assert 0 < got.sum() < mask.sum()
    np.testing.assert_array_equal(got, want)


def test_chain_launchers_take_only_cuda_tensors():
    """K3/K4's launchers refuse host tensors before they build or launch
    anything, and count no launch (the wrappers send host tensors to the
    plain versions)."""
    from bpp_tpu_torch.core import chains
    cols = torch.zeros((3, 8), dtype=torch.float64)
    sums = torch.zeros(2, dtype=torch.float64)
    terms = torch.zeros((3, 6), dtype=torch.float64)
    before = chains.launch_counts()
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        chains.launch_notheta(cols, sums, 1, 3.0, 0.03)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        chains.launch_gammadir(terms, 10.0, 10.0, 5.0)
    assert chains.launch_counts() == before


MOVES = [("age", moves.age_block_move), ("spr", moves.spr_round_move),
         ("tau", moves.tau_move), ("mixing", moves.mixing_move),
         ("heredity", subst_moves.heredity_move)]


@pytest.mark.parametrize("name,fn", MOVES, ids=[m for m, _ in MOVES])
def test_move_keeps_caches_exact(ctl, name, fn):
    eng = _port_engine(ctl, seed=21)
    state = eng.init_state()
    assert state.coal is not None and bool((state.logpr == 0).all())
    gen = torch.Generator().manual_seed(5)
    before = state
    proposed = accepted = 0
    for _ in range(10 if name == "mixing" else 3):
        state, (p, a) = fn(eng.ctx, eng.cfg, state, gen)
        proposed += int(p)
        accepted += int(a)
        logl = eng._logl_fn(state.gt, state.subst, state.sp, state.clock)
        logpr, c, t2 = eng._logpr_fn(state.gt, state.sp,
                                     state.subst.heredity)
        np.testing.assert_allclose(state.logl.numpy(), logl.numpy(),
                                   rtol=1e-10, atol=1e-9)
        np.testing.assert_array_equal(state.coal.numpy(), c.numpy())
        np.testing.assert_allclose(state.t2h.numpy(), t2.numpy(),
                                   rtol=1e-12, atol=1e-15)
        assert bool((state.logpr == 0).all()) and bool((logpr == 0).all())
    assert proposed > 0 and 0 < accepted <= proposed
    if name == "heredity":
        assert bool((state.subst.heredity != before.subst.heredity).any())
    else:
        assert bool((state.gt.age != before.gt.age).any())
    # the thetas are never touched
    assert bool((state.sp.theta == before.sp.theta).all())


def test_tau_prior_recovery_usedata0(tmp_path):
    from bpp_tpu_torch.testing import write_simulated_run
    a_tau, b_tau = 5.0, 0.08
    c = write_simulated_run(tmp_path, n_loci=2, usedata=0, thetaprior=THETA,
                            tauprior=f"{a_tau} {b_tau}", burnin=100,
                            nsample=2000)
    eng = _port_engine(c, seed=3)
    assert eng.ctx.integrated
    _, _, tau, lnl, _ = eng.run_mcmc(progress_every=0).arrays()
    assert (lnl == 0).all()
    st = eng.run.stree
    root = st.root
    inner = [i for i in range(st.n_tips, st.n_nodes) if i != root]
    m = b_tau / (a_tau - 1)
    # the root tau is InvGamma(a, b); each inner tau is uniform below it
    for what, x, want in (("tau_root", tau[:, root], m),
                          ("inner taus", tau[:, inner].mean(1), m / 2)):
        n = len(x) // 20 * 20
        se = x[:n].reshape(20, -1).mean(1).std(ddof=1) / np.sqrt(20)
        assert abs(x.mean() - want) < 4 * se, (what, x.mean(), want, se)


def test_mcmc_txt_has_no_theta_columns(ctl):
    from bpp_tpu.loader import load_run_from_ctl as load_jax
    from bpp_tpu.output import McmcWriter
    from pathlib import Path

    from bpp_tpu_torch import cli
    rc = cli.main(["--cfile", ctl, "--device", "cpu", "--x64", "--quiet"])
    assert rc == 0
    lines = Path(ctl).with_name("out.mcmc.txt").read_text().splitlines()
    run = load_jax(ctl)
    assert run.cfg.theta_integrated
    ref = Path(ctl).with_name("ref_header.txt")
    McmcWriter(str(ref), run.cfg, run.stree).close()
    assert lines[0] == ref.read_text().rstrip("\n")
    assert not any(c.startswith("theta") for c in lines[0].split("\t"))
    data = np.array([[float(x) for x in ln.split("\t")] for ln in lines[1:]])
    assert data.shape == (10, len(lines[0].split("\t")))
    assert np.isfinite(data).all()
    summary = Path(ctl).with_name("out.txt").read_text()
    assert "theta" not in summary and "(10 samples" in summary


def test_integration_needs_an_inverse_gamma_prior(ctl):
    from bpp_tpu_torch.config import PriorDist
    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.mcmc.driver import Engine
    run = load_run_from_ctl(ctl)
    run.cfg = run.cfg.replace(thetaprior=dataclasses.replace(
        run.cfg.thetaprior, dist=PriorDist.GAMMA))
    with pytest.raises(ValueError, match="inverse-gamma"):
        Engine(run, device="cpu")
