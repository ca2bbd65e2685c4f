"""``chains = K`` on the batched route (``Engine._step_batched``) for the
substitution models with an eigensystem of their own a chain: GTR+G4,
``model = custom`` (a DNA partition; a mixed DNA/amino-acid one through
the 20-state plain pass), the amino-acid model WAG and diploid GTR (K2).

* (a) Three batched iterations against K one-chain ``_step`` runs from
  cloned generators: every state leaf within 1e-12 (the eigensystems
  among them), move statistics and trace rows equal, the generators
  where the one-chain steps leave theirs; each case accepts its own
  substitution moves (frequencies, exchangeabilities, alpha).
* (b) The batched log-likelihood of K stacked states against
  ``jax.jit(jax.vmap)`` of ``bpp_tpu``'s ``make_logl_fn`` (its XLA pass,
  ``BPP_TPU_PALLAS=0``) on the same states: the K initial states, taken
  one ``init_state`` at a time, and the K states after three batched
  iterations, rtol 1e-10.
* (c) No op of these steps falls back to vmap's for-loop.
* (d) ``run_mcmc_multi`` on the batched route against the per-chain
  route (samples equal), and the CLI's resumed batched GTR run writes its
  chain files byte for byte.
* The pieces these steps newly run over a chain axis: the plain 20-state
  pass once over K chains' loci equals one call a chain, and
  ``eigh_jacobi`` under ``vmap`` equals it chain by chain and finds
  ``torch.linalg.eigh``'s system.
"""

import dataclasses
import os
import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_chain_batch_msci import _clone_gens, _gens, _leaves_close

from bpp_tpu_torch.mcmc.graph import flatten, unflatten

torch.set_num_threads(1)     # tiny tensors; the suite runs in parallel

K = 3
N_LOCI = 4
ITERS = 3
GAMMA4 = "alphaprior = 1 1 4"
PARTITION = ("JC69", "K80", "HKY", "TN93", "GTR")
CASES = {
    "gtr": dict(model="GTR", priors=(GAMMA4,)),
    "custom": "partition",       # the five DNA models, one a locus
    "mixed": "synthetic",        # test_torch_custom's mixed DNA/AA batch
    "wag": "aa",                 # generate_aa_benchmark's WAG data
    "diploid_gtr": dict(model="GTR", n_sites=60, seqs=(1, 1, 2, 2),
                        diploid=(1, 1, 0, 0), priors=(GAMMA4,)),
}
# the moves each case must accept (state.MV_* names)
MOVED = {"gtr": ("MV_FREQS", "MV_QRATES", "MV_ALPHA"),
         "custom": ("MV_FREQS", "MV_QRATES", "MV_ALPHA"),
         "mixed": ("MV_FREQS", "MV_QRATES"),
         "wag": ("MV_ALPHA",),
         "diploid_gtr": ("MV_FREQS", "MV_QRATES", "MV_ALPHA")}
ROUTES = {"gtr": "K1", "custom": "K1", "mixed": "plain", "wag": "plain",
          "diploid_gtr": "K2"}

AA_CTL = """seed = 11
seqfile = {d}/aa.phy
Imapfile = {d}/Imap.txt
jobname = {d}/out
species&tree = 4 A B C D
                 4 4 4 4
                ((A, B), (C, D));
usedata = 1
nloci = {n}
cleandata = 0
model = WAG
alphaprior = 1 1 4
thetaprior = 3 0.03
tauprior = 3 0.06
finetune = 1
burnin = 2
sampfreq = 1
nsample = 4
"""


@pytest.fixture(scope="module")
def ctls(tmp_path_factory):
    from bpp_tpu_torch.testing import (
        generate_aa_benchmark, write_partition_file, write_simulated_run,
    )
    out = {}
    for name, kw in CASES.items():
        d = tmp_path_factory.mktemp(name)
        if kw == "synthetic":
            out[name] = None
        elif kw == "aa":
            generate_aa_benchmark(N_LOCI, 40, str(d))
            path = d / "aa.ctl"
            path.write_text(AA_CTL.format(d=d, n=N_LOCI))
            out[name] = str(path)
        elif kw == "partition":
            parts = write_partition_file(d / "parts.txt", PARTITION, 5)
            out[name] = write_simulated_run(
                d, 5, n_sites=60, model=f"custom {parts}", priors=(GAMMA4,))
        else:
            kw = dict(kw)
            kw.setdefault("n_sites", 60)
            out[name] = write_simulated_run(d, N_LOCI, **kw)
    return out


def _engine(ctls, case, seed=7):
    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.mcmc.driver import Engine
    if case == "mixed":
        from test_torch_custom import _mixed_runs
        return Engine(_mixed_runs()[0], seed=seed, device="cpu")
    run = load_run_from_ctl(ctls[case])
    run.cfg = run.cfg.replace(dtype="float64")
    return Engine(run, seed=seed, device="cpu")


def _jax_engine(ctls, case, seed=7):
    from bpp_tpu.loader import load_run_from_ctl
    from bpp_tpu.mcmc.driver import Engine
    if case == "mixed":
        from test_torch_custom import _mixed_runs
        return Engine(_mixed_runs()[1], seed=seed)
    run = load_run_from_ctl(ctls[case])
    run.cfg = run.cfg.replace(dtype="float64")
    return Engine(run, seed=seed)


_RUNS = {}


def _batched(ctls, case):
    """(engine, the K initial states, the generators' initial states, the
    generators after the run, the batched (state, stats, trace) after
    each of ITERS iterations), run once a module."""
    from bpp_tpu_torch.mcmc.driver import stack_states
    if case not in _RUNS:
        eng = _engine(ctls, case)
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


@pytest.mark.parametrize("case", list(CASES))
def test_batched_step_equals_one_chain_steps(ctls, case):
    from bpp_tpu_torch.mcmc import state as state_mod
    from bpp_tpu_torch.mcmc.driver import chain_views
    eng, states, gens0, gens, batched = _batched(ctls, case)
    assert eng.chains_route == "batched", eng.chains_route_reason
    assert eng.ctx.route == ROUTES[case]
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
    last = batched[-1][0]
    # each chain carries its own eigensystem, and they differ
    if case != "wag":
        w = last.subst.eigw
        assert w.shape[0] == K and not torch.equal(w[0], w[1])


@pytest.mark.parametrize("case", list(CASES))
def test_batched_likelihood_matches_bpp_tpu_vmap(ctls, case, monkeypatch):
    from test_torch_mig import _jax_state

    from bpp_tpu_torch.mcmc.driver import chain_views
    from bpp_tpu_torch.testing import port_state
    # bpp_tpu's XLA pass (float64), read at construction and trace time
    monkeypatch.setenv("BPP_TPU_PALLAS", "0")
    engj = _jax_engine(ctls, case)
    eng, _, _, _, batched = _batched(ctls, case)
    # the K initial states, one init_state at a time, each copied at once
    chains = []
    for k in range(K):
        engj.seed = 7 + 1000003 * k
        st = engj.init_state()
        chains.append(jax.tree.map(lambda x: jnp.array(np.array(x)), st))
    init_j = jax.tree.map(lambda *xs: jnp.stack(xs), *chains)
    init_p = port_state(init_j, eng.cfg)
    last = batched[-1][0]
    last_j = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        _jax_state(s) for s in chain_views(last, K)])
    ctx = dataclasses.replace(eng.ctx, chains=K)

    def one(spec, lv):
        from bpp_tpu_torch.mcmc.state import make_logl_fn
        st = unflatten(spec, iter(lv))
        return make_logl_fn(ctx, eng.cfg)(st.gt, st.subst, st.sp, st.clock)

    def dens(st):
        return engj._logl_fn(st.gt, st.subst, st.sp, st.clock)

    mask = np.asarray(eng.ctx.locus_mask)
    for st_p, st_j in ((init_p, init_j), (last, last_j)):
        assert st_p.subst.eigw.shape[0] == K
        spec, leaves = flatten(st_p)
        got = torch.func.vmap(lambda lv: one(spec, lv))(leaves).numpy()
        want = np.asarray(jax.jit(jax.vmap(dens))(st_j))
        assert got.shape == want.shape == (K, len(mask))
        assert np.isfinite(want[:, mask]).all()
        np.testing.assert_allclose(got[:, mask], want[:, mask], rtol=1e-10)
        assert not np.allclose(got[0], got[1])


@pytest.mark.parametrize("case", list(CASES))
def test_no_vmap_loop_fallback(ctls, case):
    from bpp_tpu_torch.mcmc.driver import stack_states
    eng = _engine(ctls, case)
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


@pytest.mark.parametrize("case", ["gtr", "wag"])
def test_run_mcmc_multi_batched_equals_per_chain(ctls, case):
    logs = {}
    for route in ("batched", "per-chain"):
        eng = _engine(ctls, case, seed=11)
        eng.chains_route = route
        eng.cfg = eng.cfg.replace(burnin=2, nsample=2, sampfreq=2)
        logs[route] = eng.run_mcmc_multi(K, progress_every=0)
    for a, b in zip(logs["batched"], logs["per-chain"]):
        assert a.gen == b.gen and len(a.gen) == 2
        np.testing.assert_array_equal(np.asarray(a.lnL), np.asarray(b.lnL))
        np.testing.assert_array_equal(np.stack(a.theta), np.stack(b.theta))
        np.testing.assert_array_equal(np.stack(a.tau), np.stack(b.tau))
    assert logs["batched"][0].lnL != logs["batched"][1].lnL


def test_cli_batched_gtr_resume_is_byte_identical(tmp_path, capsys):
    from bpp_tpu_torch import cli
    from bpp_tpu_torch.testing import write_simulated_run
    ctl = write_simulated_run(tmp_path, 3, n_sites=40, model="GTR",
                              nsample=5, burnin=2,
                              priors=(GAMMA4, f"chains = {K}",
                                      "checkpoint = 4 0"))
    assert cli.main(["--cfile", ctl, "--device", "cpu"]) == 0
    assert f"chains = {K}: batched" in capsys.readouterr().err
    files = [tmp_path / "out.mcmc.txt"] + [tmp_path / f"out.c{c}.mcmc.txt"
                                           for c in range(2, K + 1)]
    whole = [f.read_bytes() for f in files]
    for f in files:
        shutil.move(f, tmp_path / (f.name + ".whole"))
    assert os.path.exists(tmp_path / "out.chk.npz")
    assert cli.main(["--resume", str(tmp_path / "out.chk.npz"), "--device",
                     "cpu", "--quiet"]) == 0
    assert [f.read_bytes() for f in files] == whole


@pytest.mark.parametrize("L", [1, 3, 8])
def test_eigh_jacobi_over_a_chain_axis(L):
    """``eigh_jacobi`` under ``vmap`` over K chains' systems of L loci
    equals it chain by chain bit for bit, and is the eigensystem
    ``torch.linalg.eigh`` finds: the same eigenvalues to 1e-12, ``V
    diag(w) V^T = B``."""
    from bpp_tpu_torch.core import pmatrix
    rng = np.random.default_rng(L)
    x = torch.as_tensor(rng.uniform(-1, 1, (K, L, 4, 4)))
    B = x + x.transpose(-1, -2) + 4.0 * torch.eye(4, dtype=x.dtype)
    got_w, got_v = torch.func.vmap(pmatrix.eigh_jacobi)(B)
    for k in range(K):
        w, v = pmatrix.eigh_jacobi(B[k])
        assert torch.equal(got_w[k], w) and torch.equal(got_v[k], v)
        recon = (v * w[..., None, :]) @ v.transpose(-1, -2)
        np.testing.assert_allclose(recon.numpy(), B[k].numpy(), atol=1e-12)
        np.testing.assert_allclose(
            np.sort(w.numpy(), -1), torch.linalg.eigh(B[k])[0].numpy(),
            rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", ["wag", "mixed"])
def test_plain_pass_over_a_chain_axis(ctls, case):
    """The 20-state plain pass ``fels.site_logl_fels_ref`` once over K
    chains' ``[K, L, ...]`` arguments (as ``pack.chain_pass`` hands it
    them inside the batched step) equals one call a chain exactly."""
    from bpp_tpu_torch.core import fels
    from bpp_tpu_torch.trees.gtree import inner_order
    eng, _, _, _, batched = _batched(ctls, case)
    ctx = eng.ctx
    from bpp_tpu_torch.mcmc.driver import chain_views
    states = chain_views(batched[-1][0], K)

    def args(st):
        s = st.subst
        rk = torch.cat([s.rates, s.kappa1[:, None], s.kappa2[:, None]], 1)
        return (inner_order(st.gt), st.gt.left, st.gt.right, st.gt.parent,
                ctx.n_seq, st.gt.age, s.mu, rk, s.freqs, s.eigw, s.eigT,
                s.eigTi, ctx.tip_partials)

    chains = [args(st) for st in states]
    stacked = tuple(a if i in (4, 12) else torch.stack([c[i] for c in chains])
                    for i, a in enumerate(chains[0]))
    kw = dict(model=eng.cfg.model, n_cats=states[0].subst.rates.shape[1],
              n_pat=ctx.n_pat)
    got = fels.site_logl_fels_ref(*stacked, **kw)
    assert got.shape[:2] == (K, ctx.n_seq.shape[0])
    assert ctx.tip_partials.shape[-1] == 20
    for k in range(K):
        assert torch.equal(got[k], fels.site_logl_fels_ref(*chains[k], **kw))
