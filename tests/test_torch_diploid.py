"""Unphased diploid data in the PyTorch port against ``bpp_tpu``.

* ``felsenstein.reduce_root`` with a resolution map (R = 1 and R = 4)
  against ``bpp_tpu``'s on random inputs, float64, rtol 1e-12.
* Per-pattern and per-locus log-likelihoods of a simulated dataset with
  ``diploid = 1 1 0 0`` (two diploid and two haploid species), over JC69,
  HKY+G4, TN93 and GTR+G4:
  - ``fels.site_logl_fels_ref`` and ``loglikelihood(res_map=...)`` against
    ``bpp_tpu``'s XLA ``felsenstein.loglikelihood`` in float64, rtol 1e-10;
  - the port on the CPU against ``bpp_tpu``'s per-locus Pallas kernel K2
    itself (``site_logl_pallas`` in interpret mode, as
    test_pallas_kernel.py runs it) in float32, rtol 2e-4 / atol 2e-3, the
    bound of that suite.
* Columns past a locus's real pattern count are exactly 0.
* The engine's route: an identity map takes K1's wrapper, a diploid map
  K2's (calls counted on the CPU path).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpp_tpu.config import SubstModel as SMJ
from bpp_tpu.core import felsenstein as fej
from bpp_tpu.core.pallas_fels import site_logl_pallas
from bpp_tpu.mcmc import state as stj
from bpp_tpu.trees import gtree as gj
from bpp_tpu_torch.core import fels
from bpp_tpu_torch.core import felsenstein as fep
from bpp_tpu_torch.testing import fixed_subst

torch.set_num_threads(1)     # tiny tensors; the suite runs in parallel

MODELS = [("JC69", 1), ("HKY", 4), ("TN93", 1), ("GTR", 4)]


@pytest.mark.parametrize("R", [1, 4])
def test_reduce_root_matches_bpp_tpu(R):
    rng = np.random.default_rng(17 + R)
    L, S, W = 5, 40, 24
    site = rng.uniform(-30.0, -1.0, (L, S))
    weights = rng.integers(0, 9, (L, W)).astype(np.float64)
    res_map = rng.integers(0, S, (L, W, R))
    res_count = rng.integers(1, R + 1, (L, W))
    # padding entries as pack_loci leaves them: column 0, one resolution,
    # weight 0
    res_map[:, -3:] = 0
    res_count[:, -3:] = 1
    weights[:, -3:] = 0.0
    got = fep.reduce_root(torch.as_tensor(site), torch.as_tensor(weights),
                          torch.as_tensor(res_map),
                          torch.as_tensor(res_count))
    want = fej.reduce_root(jnp.asarray(site), jnp.asarray(weights),
                           jnp.asarray(res_map), jnp.asarray(res_count))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


def test_reduce_root_without_map_takes_the_weights_dot():
    rng = np.random.default_rng(3)
    site = torch.as_tensor(rng.uniform(-9.0, -1.0, (4, 16)))
    weights = torch.as_tensor(rng.integers(0, 5, (4, 12)).astype(float))
    np.testing.assert_allclose(
        fep.reduce_root(site, weights).numpy(),
        (weights * site[:, :12]).sum(1).numpy(), rtol=1e-14)


@pytest.fixture(scope="module")
def diploid(tmp_path_factory):
    """Gene trees from a few float64 port iterations on 8 simulated loci
    of 150 sites: species A, B with one unphased diploid individual each,
    C, D with two haploid sequences each."""
    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.mcmc.driver import Engine
    from bpp_tpu_torch.testing import write_simulated_run
    tmp = tmp_path_factory.mktemp("torchdip")
    run = load_run_from_ctl(write_simulated_run(
        tmp, n_loci=8, n_sites=150, seqs=(1, 1, 2, 2), diploid=(1, 1, 0, 0)))
    run.cfg = run.cfg.replace(dtype="float64")
    eng = Engine(run, seed=2, device="cpu")
    state = eng.init_state()
    state, _ = eng.chunk_step(state, 6)
    return eng, state


def _tree_args(state, ctx, subst, dtype):
    from bpp_tpu_torch.trees.gtree import inner_order
    gt = state.gt
    rk = torch.cat([subst.rates, subst.kappa1[:, None],
                    subst.kappa2[:, None]], dim=1)
    return (inner_order(gt), gt.left, gt.right, gt.parent, ctx.n_seq,
            gt.age.to(dtype), subst.mu, rk, subst.freqs, subst.eigw,
            subst.eigT, subst.eigTi, ctx.tip_partials.to(dtype))


def test_batch_carries_a_resolution_map(diploid):
    eng, _ = diploid
    b = eng.run.batch
    assert eng.ctx.res_map is not None
    assert b.res_map.shape[2] >= 2, "no heterozygous site was simulated"
    assert (b.n_pat > (b.weights > 0).sum(1)).any()
    assert b.max_tips == 8


@pytest.mark.parametrize("model_name,n_cats", MODELS)
def test_plain_diploid_loglikelihood_matches_bpp_tpu(diploid, model_name,
                                                     n_cats):
    eng, state = diploid
    ctx = eng.ctx
    L = state.gt.n_loci
    model, subst = fixed_subst(model_name, n_cats, L, torch.float64)
    args = _tree_args(state, ctx, subst, torch.float64)
    site = fels.site_logl_fels_ref(*args, model=model, n_cats=n_cats)
    logl = fep.reduce_root(site, ctx.weights, ctx.res_map, ctx.res_count)

    gtj = gj.GTrees(*(jnp.asarray(x.numpy()) for x in state.gt[:4]))
    sj = stj.SubstState(*(jnp.asarray(x.numpy()) for x in subst))
    pm = stj.compute_pmats(gtj, sj, SMJ[model_name])
    cw = jnp.full((n_cats,), 1.0 / n_cats, jnp.float64)
    b = eng.run.batch
    want, want_site = fej.loglikelihood(
        gtj, jnp.asarray(ctx.tip_partials.numpy()),
        jnp.asarray(ctx.weights.numpy()), jnp.asarray(ctx.n_seq.numpy()),
        pm, sj.freqs, cw, return_site=True, res_map=jnp.asarray(b.res_map),
        res_count=jnp.asarray(b.res_count))
    assert np.isfinite(logl.numpy()).all()
    # padding columns are all-ambiguous: lnL = 0 up to roundoff
    np.testing.assert_allclose(site.numpy(), np.asarray(want_site),
                               rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(logl.numpy(), np.asarray(want), rtol=1e-10)

    # the port's loglikelihood with the map is the same reduction
    from bpp_tpu_torch.mcmc.state import compute_pmats
    logl2 = fep.loglikelihood(
        state.gt, ctx.tip_partials, ctx.weights, ctx.n_seq,
        compute_pmats(state.gt, subst, model), subst.freqs,
        torch.full((n_cats,), 1.0 / n_cats, dtype=torch.float64),
        res_map=ctx.res_map, res_count=ctx.res_count)
    np.testing.assert_allclose(logl2.numpy(), np.asarray(want), rtol=1e-10)


@pytest.mark.parametrize("model_name,n_cats", MODELS)
def test_port_matches_bpp_tpu_fels_kernel(diploid, model_name, n_cats,
                                          monkeypatch):
    monkeypatch.setenv("BPP_TPU_PALLAS", "interpret")
    monkeypatch.setenv("BPP_TPU_PACK", "0")
    eng, state = diploid
    ctx = eng.ctx
    L = state.gt.n_loci
    S = ctx.tip_partials.shape[2]
    model, subst = fixed_subst(model_name, n_cats, L, torch.float32)
    # on CPU tensors the wrapper computes the plain version
    got = fels.site_logl_fels(*_tree_args(state, ctx, subst, torch.float32),
                              model=model, n_cats=n_cats)
    got_l = fep.reduce_root(got, ctx.weights.float(), ctx.res_map,
                            ctx.res_count)

    # bpp_tpu's layout: A-major tips, pattern axis padded to 128 lanes
    # with all-ones partials (driver._build_tips_am)
    S128 = -(-S // 128) * 128
    am = np.transpose(ctx.tip_partials.numpy().astype(np.float32),
                      (0, 1, 3, 2))
    am = np.pad(am, ((0, 0), (0, 0), (0, 0), (0, S128 - S)),
                constant_values=1.0)
    args = _tree_args(state, ctx, subst, torch.float32)[:-1]
    jargs = [jnp.asarray(x.numpy().astype(
        np.int32 if x.dtype == torch.int64 else np.float32)) for x in args]
    want = site_logl_pallas(*jargs, jnp.asarray(am), model=SMJ[model_name],
                            n_cats=n_cats)
    b = eng.run.batch
    want_l = fej.reduce_root(want, jnp.asarray(b.weights, jnp.float32),
                             jnp.asarray(b.res_map),
                             jnp.asarray(b.res_count))
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :S],
                               rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l),
                               rtol=2e-4, atol=2e-3)


def test_columns_past_n_pat_are_exactly_zero(diploid):
    eng, state = diploid
    ctx = eng.ctx
    L = state.gt.n_loci
    model, subst = fixed_subst("HKY", 4, L, torch.float64)
    args = _tree_args(state, ctx, subst, torch.float64)
    site = fels.site_logl_fels(*args, model=model, n_cats=4, n_pat=ctx.n_pat)
    full = fels.site_logl_fels(*args, model=model, n_cats=4)
    S = site.shape[1]
    live = torch.arange(S) < ctx.n_pat[:, None]
    assert bool((~live).any()), "no padding column in the batch"
    assert bool((site[~live] == 0).all())
    assert bool((site[live] == full[live]).all())
    # the map only reaches live columns, so the reduction is the same
    np.testing.assert_array_equal(
        fep.reduce_root(site, ctx.weights, ctx.res_map, ctx.res_count),
        fep.reduce_root(full, ctx.weights, ctx.res_map, ctx.res_count))


@pytest.mark.parametrize("kind", ["haploid", "diploid"])
def test_engine_routes_by_resolution_map(tmp_path, monkeypatch, kind):
    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.mcmc import state as stp
    from bpp_tpu_torch.mcmc.driver import Engine
    from bpp_tpu_torch.testing import write_simulated_run
    calls = {"K1": 0, "K2": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(stp, "site_logl_packed",
                        counting("K1", stp.site_logl_packed))
    monkeypatch.setattr(stp, "site_logl_fels",
                        counting("K2", stp.site_logl_fels))
    # one heterozygous site sends the whole batch through K2
    dip = (1, 1, 0, 0) if kind == "diploid" else None
    run = load_run_from_ctl(write_simulated_run(
        tmp_path, n_loci=4, n_sites=200, seqs=(1, 1, 2, 2), diploid=dip))
    eng = Engine(run, seed=4, device="cpu")
    assert (eng.ctx.res_map is None) == (kind == "haploid")
    state = eng.init_state()
    eng.chunk_step(state, 2)
    passes = 1 + 2 * 8          # the initial state + 8 per iteration
    assert calls == ({"K1": passes, "K2": 0} if kind == "haploid"
                     else {"K1": 0, "K2": passes})
