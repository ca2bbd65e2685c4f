"""Likelihood math of the PyTorch port against ``bpp_tpu``.

* P(t) for every DNA model family, float64 (rtol 1e-12), and the closed
  forms against the matrix exponential down to t = 1e-38 (they keep the
  short branches' off-diagonal entries, as the kernels' expm1 factors
  do);
* per-locus log-likelihoods of ``pack.site_logl_packed_ref`` against
  ``bpp_tpu``'s ``felsenstein.loglikelihood`` in float64 (rtol 1e-10)
  on simulated data over the model grid of test_kernel_consistency.py,
  and on heterogeneous batches (fewer sequences than the tip capacity,
  a locus of 150 patterns, a single-sequence locus);
* the port on the CPU against ``bpp_tpu``'s lane-packed Pallas kernel
  K1 itself, run in interpret mode as its own tests run it, in float32
  (rtol 2e-4 / atol 2e-3 lnL, the bound of test_pallas_pack.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpp_tpu.config import SubstModel as SMJ
from bpp_tpu.core import felsenstein as fej
from bpp_tpu.core import pmatrix as pmj
from bpp_tpu.mcmc import state as stj
from bpp_tpu.trees import gtree as gj
from bpp_tpu_torch.core import pack
from bpp_tpu_torch.core import pmatrix as pmp
from bpp_tpu_torch.testing import fixed_subst

torch.set_num_threads(1)     # tiny tensors; the suite runs in parallel

MODELS = [("JC69", 1), ("HKY", 4), ("TN93", 1), ("GTR", 4)]


def _rand(shape, lo, hi, seed):
    return np.random.default_rng(seed).uniform(lo, hi, shape)


@pytest.mark.parametrize("name", ["JC69", "K80", "F81", "HKY", "TN93",
                                  "GTR"])
def test_pmatrix_matches(name):
    t = _rand((3, 5), 1e-5, 0.5, 1)
    f = _rand((3, 5, 4), 0.1, 1.0, 2)
    f /= f.sum(-1, keepdims=True)
    k1 = _rand((3, 5), 0.5, 8.0, 3)
    k2 = _rand((3, 5), 0.5, 8.0, 4)
    T = torch.as_tensor
    if name == "JC69":
        a, b = pmp.pmatrix_jc69(T(t)), pmj.pmatrix_jc69(jnp.asarray(t))
    elif name == "K80":
        a = pmp.pmatrix_k80(T(t), T(k1))
        b = pmj.pmatrix_k80(jnp.asarray(t), jnp.asarray(k1))
    elif name == "F81":
        a, b = pmp.pmatrix_f81(T(t), T(f)), pmj.pmatrix_f81(jnp.asarray(t),
                                                            jnp.asarray(f))
    elif name == "HKY":
        a = pmp.pmatrix_hky(T(t), T(f), T(k1))
        b = pmj.pmatrix_hky(jnp.asarray(t), jnp.asarray(f), jnp.asarray(k1))
    elif name == "TN93":
        a = pmp.pmatrix_tn93(T(t), T(f), T(k1), T(k2))
        b = pmj.pmatrix_tn93(*(jnp.asarray(x) for x in (t, f, k1, k2)))
    else:
        q = _rand((3, 5, 6), 0.2, 5.0, 5)
        a = pmp.pmatrix_eigen(T(t), *pmp.gtr_eigen(T(f), T(q)))
        b = pmj.pmatrix_eigen(jnp.asarray(t),
                              *pmj.gtr_eigen(jnp.asarray(f), jnp.asarray(q)))
    # atol: eigen-solver roundoff on the smallest entries of GTR P(t)
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                               atol=1e-15)


@pytest.mark.parametrize("name", ["JC69", "HKY", "TN93"])
def test_pmatrix_closed_forms_keep_short_branches(name):
    """The closed forms against the matrix exponential of their rate
    matrix from t = 1e-38 (a node at float32's smallest normal age above
    its tips, where an age move's reflection can leave it) to t = 3, every
    entry to 1e-13 relative.  ``bpp_tpu``'s 1 - exp(-t) forms lose the
    off-diagonal entries of short branches (0 below t ~ 1e-16), which the
    kernels' expm1 factors keep."""
    from scipy.linalg import expm
    t = np.array([1e-38, 1e-30, 1e-20, 1e-12, 1e-8, 1e-4, 0.01, 0.5, 3.0])
    f = np.array([0.3, 0.2, 0.15, 0.35])
    k1, k2 = {"JC69": (1.0, 1.0), "HKY": (2.5, 2.5),
              "TN93": (2.5, 4.0)}[name]
    if name == "JC69":
        f = np.full(4, 0.25)
        got = pmp.pmatrix_jc69(torch.as_tensor(t)).numpy()
    else:
        n = len(t)
        got = pmp.pmatrix_tn93(torch.as_tensor(t),
                               torch.as_tensor(np.tile(f, (n, 1))),
                               torch.full((n,), k1, dtype=torch.float64),
                               torch.full((n,), k2, dtype=torch.float64)
                               ).numpy()
    pa, pc, pg, pt = f
    Q = np.array([[0, pc, k1 * pg, pt], [pa, 0, pg, k2 * pt],
                  [k1 * pa, pc, 0, pt], [pa, k2 * pc, pg, 0]])
    np.fill_diagonal(Q, -Q.sum(1))
    Q /= -(f * np.diag(Q)).sum()
    for i, ti in enumerate(t):
        want = expm(Q * ti)
        np.testing.assert_allclose(got[i], want, rtol=1e-13, atol=0,
                                   err_msg=f"t = {ti}")


@pytest.fixture(scope="module")
def simulated(tmp_path_factory):
    """Gene trees from a few float64 port iterations on 12 simulated
    4-species x 2-sequence loci of 200 sites."""
    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.mcmc.driver import Engine
    from bpp_tpu_torch.testing import write_simulated_run
    tmp = tmp_path_factory.mktemp("torchlik")
    run = load_run_from_ctl(write_simulated_run(tmp, n_loci=12))
    run.cfg = run.cfg.replace(dtype="float64")
    eng = Engine(run, seed=2, device="cpu")
    state = eng.init_state()
    state, _ = eng.chunk_step(state, 8)
    return eng, state


@pytest.fixture(scope="module")
def heterogeneous():
    """Synthetic batch: 1..7 sequences per locus, up to 150 patterns."""
    from bpp_tpu_torch.mcmc.driver import Engine
    from bpp_tpu_torch.testing import synthetic_run
    run = synthetic_run(n_loci=7, n_seq=[6, 3, 7, 5, 2, 4, 1],
                        n_patterns=[12, 40, 7, 150, 16, 9, 5], seed=4,
                        dtype="float64")
    eng = Engine(run, seed=3, device="cpu")
    return eng, eng.init_state()


def _jax_logl(state, ctx, model_name, subst):
    """bpp_tpu's felsenstein.loglikelihood over its compute_pmats."""
    gt = state.gt
    gtj = gj.GTrees(*(jnp.asarray(x.numpy()) for x in gt[:4]))
    sj = stj.SubstState(*(jnp.asarray(x.numpy()) for x in subst))
    pm = stj.compute_pmats(gtj, sj, SMJ[model_name])
    C = subst.rates.shape[1]
    cw = jnp.full((C,), 1.0 / C, jnp.float64)
    return np.asarray(fej.loglikelihood(
        gtj, jnp.asarray(ctx.tip_partials.numpy()),
        jnp.asarray(ctx.weights.numpy()), jnp.asarray(ctx.n_seq.numpy()),
        pm, sj.freqs, cw))


def _port_logl(state, ctx, model, subst, dtype, fn):
    from bpp_tpu_torch.trees.gtree import inner_order
    gt = state.gt
    rk = torch.cat([subst.rates, subst.kappa1[:, None],
                    subst.kappa2[:, None]], dim=1)
    return fn(inner_order(gt), gt.left, gt.right, gt.parent, ctx.n_seq,
              gt.age.to(dtype), subst.mu, rk, subst.freqs, subst.eigw,
              subst.eigT, subst.eigTi, ctx.tip_partials.to(dtype),
              ctx.weights.to(dtype), model=model,
              n_cats=subst.rates.shape[1]).numpy()


@pytest.mark.parametrize("data", ["simulated", "heterogeneous"])
@pytest.mark.parametrize("model_name,n_cats", MODELS)
def test_plain_loglikelihood_matches_bpp_tpu(request, data, model_name,
                                             n_cats):
    eng, state = request.getfixturevalue(data)
    L = state.gt.n_loci
    model, subst = fixed_subst(model_name, n_cats, L, torch.float64)
    got = _port_logl(state, eng.ctx, model, subst, torch.float64,
                     pack.site_logl_packed_ref)
    want = _jax_logl(state, eng.ctx, model_name, subst)
    mask = eng.ctx.locus_mask.numpy()
    assert np.isfinite(got[mask]).all()
    np.testing.assert_allclose(got, want, rtol=1e-10)


@pytest.mark.parametrize("model_name,n_cats", MODELS)
def test_port_matches_bpp_tpu_packed_kernel(heterogeneous, model_name,
                                            n_cats, monkeypatch):
    from bpp_tpu.core.pallas_pack import build_pack_layout
    from bpp_tpu.core.pallas_pack import site_logl_packed as k1
    monkeypatch.setenv("BPP_TPU_PALLAS", "interpret")
    eng, state = heterogeneous
    ctx = eng.ctx
    L = state.gt.n_loci
    model, subst = fixed_subst(model_name, n_cats, L, torch.float32)
    # on CPU tensors the wrapper computes the plain version
    got = _port_logl(state, ctx, model, subst, torch.float32,
                     pack.site_logl_packed)
    n_seq = ctx.n_seq.numpy()
    layout = build_pack_layout(
        ctx.tip_partials.numpy().astype(np.float32),
        ctx.weights.numpy().astype(np.float32),
        np.asarray(eng.run.batch.n_pat), n_seq,
        ctx.locus_mask.numpy())
    from bpp_tpu_torch.trees.gtree import inner_order
    gt = state.gt
    rk = torch.cat([subst.rates, subst.kappa1[:, None],
                    subst.kappa2[:, None]], dim=1)
    j32 = lambda x: jnp.asarray(x.numpy().astype(np.float32))  # noqa: E731
    i32 = lambda x: jnp.asarray(x.numpy().astype(np.int32))    # noqa: E731
    want = np.asarray(k1(
        layout, i32(inner_order(gt)), i32(gt.left), i32(gt.right),
        i32(gt.parent), i32(ctx.n_seq), j32(gt.age), j32(subst.mu), j32(rk),
        j32(subst.freqs), j32(subst.eigw), j32(subst.eigT), j32(subst.eigTi),
        model=SMJ[model_name], n_cats=n_cats))
    # K1 roots a single-sequence locus at its tip; bpp_tpu's XLA path
    # (and so the plain version) at an unused slot: compare n_seq >= 2
    keep = ctx.locus_mask.numpy() & (n_seq >= 2)
    np.testing.assert_allclose(got[keep], want[keep], rtol=2e-4, atol=2e-3)
