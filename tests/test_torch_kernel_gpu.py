"""Kernels K1 (``bpp_tpu_torch/csrc/pack_kernel.cu``) and K2
(``csrc/fels_kernel.cu``) on the card against their plain PyTorch
versions, over the model grid of test_kernel_consistency.py and both CLV
stores (shared memory, device scratch): max per-locus |dlnL| < 0.02, the
float32 bound used there; K2 on haploid and on unphased diploid tips, per
pattern (max |dlnL| < 2e-3) and per locus after ``reduce_root``.  Also:
trees of 64 and 128 tips (the wrapper picks the store), 8 rate categories,
``blen=`` against the strict clock, bit-equal repeat launches and block
sizes, junk in the schedule's padding levels, refused shapes; the
relaxed-clock branch lengths of clock = 2 and clock = 4 chains and the
dated tips of a tip-dating chain, and the caches of those chains on the
card; the gene trees a species SPR, an SNL and an rj move propose (K1 on
haploid A01 data, K2 on diploid A11 data), and the caches of those chains
on the card; both kernels on the per-locus eigensystems of a DNA
partition (``model = custom``), and the 20-state plain pass of an
amino-acid batch (WAG) in float32 on the card against float64 on the CPU;
under MSC-M migration, K1 on the gene trees the sim-SPR move proposes and
on a clock = 2 chain's sub-edge branch lengths, K2 on a diploid batch
simulated under migration, and the caches of those chains on the card.
The float64 builds (``--x64``): K1 within 1e-6 lnL a locus and K2 within
1e-8 a pattern and 1e-6 a locus of their float64 plain versions, on both
stores and the model grid; both within 1e-10 on the four families x C in
1, 2, 4, 8 x both stores, with repeat launches and block sizes
bit-equal; and an x64 engine's step launching only the float64 build.
Both kernels per locus (K1) and per pattern (K2) on cherries at float32's
smallest normal age above their tips.  The captured step
(``mcmc.graph.StepGraph``): 20 replays bit-equal to 20
eager steps on a JC69, a diploid, an integrated-theta, an A01 (SNL), an
MSC-M and a clock = 3 Gamma-Dirichlet chain, and the launch counters
adding up under replay.  K3 (``csrc/chain_kernel.cu`` notheta_chain) and
K4 (gammadir_chain) against their host plain versions on random chains,
K5 (``csrc/simwalk_kernel.cu``) against its torch plain version on the
MSC-M chain's sim-SPR walks and on synthetic walks of 1 to 97 sub-edges, 1
to 1000 loci, up to 207 populations and up to 62 routes, in float32 and
float64: decisions
equal but at near ties, which are counted and gated.  ``chains = K``:
one launch of K1 / K2 over K chains (K in 1, 3, 8; float32 and float64;
both stores) bit-equal per (chain, locus) to K one-chain launches and
within the plain versions' gates; one launch of K3 and one of K4 over K
chains (K in 2, 4, 8; every regime) bit-equal per (chain, locus) to
one-chain launches and equal to the plain versions but at near ties; one
launch of K5 over C chains (C in 2, 4, 8; float32 and float64; every
synthetic walk shape) bit-equal per (chain, locus) to one-chain launches;
the batched step's graph (one replay for every chain; JC69, diploid,
MSC-M and MSC-I) bit-equal to the eager batched step, and one batched
iteration against the one-chain steps.  Needs a CUDA device and nvcc;
skips without them.

    python -m pytest tests/test_torch_kernel_gpu.py -q
"""

import numpy as np
import pytest
import torch

from bpp_tpu_torch.testing import (WALK_SHAPES, fixed_subst,
                                   synthetic_walk_chains, synthetic_walks,
                                   walk_id, walk_seed)

MODELS = [("JC69", 1), ("HKY", 4), ("TN93", 1), ("GTR", 4)]

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda_state(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.mcmc.driver import Engine
    from bpp_tpu_torch.testing import write_simulated_run
    tmp = tmp_path_factory.mktemp("torchgpu")
    run = load_run_from_ctl(write_simulated_run(tmp, n_loci=12))
    eng = Engine(run, seed=1, device="cuda")
    state = eng.init_state()
    state, _ = eng.chunk_step(state, 10)
    return eng, state


@pytest.fixture(scope="module")
def cuda_diploid(tmp_path_factory):
    """Species A, B with two unphased diploid individuals each, C, D with
    two haploid sequences each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.mcmc.driver import Engine
    from bpp_tpu_torch.testing import write_simulated_run
    tmp = tmp_path_factory.mktemp("torchgpudip")
    run = load_run_from_ctl(write_simulated_run(
        tmp, n_loci=12, seqs=(2, 2, 2, 2), diploid=(1, 1, 0, 0)))
    eng = Engine(run, seed=1, device="cuda")
    assert eng.ctx.res_map is not None
    state = eng.init_state()
    state, _ = eng.chunk_step(state, 10)
    return eng, state


def _args(state, ctx, subst, dtype):
    from bpp_tpu_torch.trees.gtree import inner_order
    gt = state.gt
    rk = torch.cat([subst.rates, subst.kappa1[:, None],
                    subst.kappa2[:, None]], dim=1)
    return (inner_order(gt), gt.left, gt.right, gt.parent, ctx.n_seq,
            gt.age.to(dtype), subst.mu, rk, subst.freqs, subst.eigw,
            subst.eigT, subst.eigTi, ctx.tip_partials.to(dtype),
            ctx.weights.to(dtype))


STORES = ["shared", "global"]


@pytest.mark.parametrize("store", STORES)
@pytest.mark.parametrize("model_name,n_cats", MODELS + [("HKY", 8)])
def test_kernel_matches_plain_version(cuda_state, model_name, n_cats, store):
    from bpp_tpu_torch.core import pack
    eng, state = cuda_state
    L = state.gt.n_loci
    model, s32 = fixed_subst(model_name, n_cats, L, torch.float32, "cuda")
    _, s64 = fixed_subst(model_name, n_cats, L, torch.float64, "cuda")
    before = pack.LAUNCHES
    got = pack.site_logl_packed(*_args(state, eng.ctx, s32, torch.float32),
                                model=model, n_cats=n_cats,
                                units=eng.ctx.units, clv_store=store)
    torch.cuda.synchronize()
    assert pack.LAUNCHES == before + 1
    assert pack.CLV_STORE == store
    want = pack.site_logl_packed_ref(
        *_args(state, eng.ctx, s64, torch.float64), model=model,
        n_cats=n_cats)
    mask = eng.ctx.locus_mask
    got = got.double()
    assert bool(torch.isfinite(got[mask]).all())
    err = float((got - want)[mask].abs().max())
    assert err < 0.02, err


@pytest.mark.parametrize("store", STORES)
@pytest.mark.parametrize("data", ["cuda_state", "cuda_diploid"])
@pytest.mark.parametrize("model_name,n_cats", MODELS + [("HKY", 8)])
def test_fels_kernel_matches_plain_version(request, data, model_name,
                                           n_cats, store):
    from bpp_tpu_torch.core import fels
    from bpp_tpu_torch.core import felsenstein as fe
    eng, state = request.getfixturevalue(data)
    ctx = eng.ctx
    L = state.gt.n_loci
    model, s32 = fixed_subst(model_name, n_cats, L, torch.float32, "cuda")
    _, s64 = fixed_subst(model_name, n_cats, L, torch.float64, "cuda")
    kw = dict(model=model, n_cats=n_cats, n_pat=ctx.n_pat)
    before = fels.LAUNCHES
    # without `units` the wrapper builds the table from n_pat itself
    got = fels.site_logl_fels(*_args(state, ctx, s32, torch.float32)[:-1],
                              clv_store=store, **kw)
    torch.cuda.synchronize()
    assert fels.LAUNCHES == before + 1
    assert fels.CLV_STORE == store
    with_units = fels.site_logl_fels(
        *_args(state, ctx, s32, torch.float32)[:-1], clv_store=store,
        units=ctx.units, **kw)
    assert torch.equal(got, with_units)
    want = fels.site_logl_fels_ref(
        *_args(state, ctx, s64, torch.float64)[:-1], **kw)
    assert got.shape == want.shape == ctx.tip_partials.shape[:1] \
        + ctx.tip_partials.shape[2:3]
    live = torch.arange(got.shape[1], device="cuda") < ctx.n_pat[:, None]
    assert bool((got[~live] == 0).all())
    assert bool(torch.isfinite(got).all())
    site_err = float((got.double() - want).abs().max())
    assert site_err < 2e-3, site_err
    w64 = ctx.weights.double()
    err = float((fe.reduce_root(got.double(), w64, ctx.res_map,
                                ctx.res_count)
                 - fe.reduce_root(want, w64, ctx.res_map, ctx.res_count)
                 )[ctx.locus_mask].abs().max())
    assert err < 0.02, err


def test_diploid_engine_launches_only_k2(cuda_diploid):
    from bpp_tpu_torch.core import fels, pack
    eng, state = cuda_diploid
    k1, k2 = pack.LAUNCHES, fels.LAUNCHES
    eng.chunk_step(state, 2)
    torch.cuda.synchronize()
    assert pack.LAUNCHES == k1
    assert fels.LAUNCHES == k2 + 16


def test_kernel_refuses_float64(cuda_state):
    """float64 tips with float32 parameters (or float16 tips) are refused:
    a launch takes one build's type throughout."""
    from bpp_tpu_torch.core import pack
    eng, state = cuda_state
    L = state.gt.n_loci
    model, s32 = fixed_subst("JC69", 1, L, torch.float32, "cuda")
    mixed = list(_args(state, eng.ctx, s32, torch.float32))
    mixed[12] = mixed[12].double()                  # the tips
    with pytest.raises(TypeError):
        pack.site_logl_packed(*mixed, model=model, n_cats=1)
    from bpp_tpu_torch.core import fels
    with pytest.raises(TypeError):
        fels.site_logl_fels(*mixed[:-1], model=model, n_cats=1)
    half = list(_args(state, eng.ctx, s32, torch.float32))
    half[12] = half[12].half()
    with pytest.raises(TypeError):
        pack.site_logl_packed(*half, model=model, n_cats=1)


@pytest.mark.parametrize("store", STORES)
@pytest.mark.parametrize("model_name,n_cats", MODELS + [("HKY", 8)])
def test_float64_kernel_matches_plain_version(cuda_state, model_name,
                                              n_cats, store):
    from bpp_tpu_torch.core import pack
    eng, state = cuda_state
    L = state.gt.n_loci
    model, s64 = fixed_subst(model_name, n_cats, L, torch.float64, "cuda")
    a64 = _args(state, eng.ctx, s64, torch.float64)
    before = pack.LAUNCHES, pack.LAUNCHES_F64
    got = pack.site_logl_packed(*a64, model=model, n_cats=n_cats,
                                units=eng.ctx.units, clv_store=store)
    torch.cuda.synchronize()
    assert (pack.LAUNCHES, pack.LAUNCHES_F64) == (before[0] + 1,
                                                  before[1] + 1)
    assert got.dtype == torch.float64 and pack.CLV_STORE == store
    want = pack.site_logl_packed_ref(*a64, model=model, n_cats=n_cats)
    mask = eng.ctx.locus_mask
    assert bool(torch.isfinite(got[mask]).all())
    err = float((got - want)[mask].abs().max())
    assert err < 1e-6, err


@pytest.mark.parametrize("store", STORES)
@pytest.mark.parametrize("data", ["cuda_state", "cuda_diploid"])
@pytest.mark.parametrize("model_name,n_cats", MODELS)
def test_float64_fels_kernel_matches_plain_version(request, data,
                                                   model_name, n_cats,
                                                   store):
    from bpp_tpu_torch.core import fels
    from bpp_tpu_torch.core import felsenstein as fe
    eng, state = request.getfixturevalue(data)
    ctx = eng.ctx
    L = state.gt.n_loci
    model, s64 = fixed_subst(model_name, n_cats, L, torch.float64, "cuda")
    a64 = _args(state, ctx, s64, torch.float64)[:-1]
    kw = dict(model=model, n_cats=n_cats, n_pat=ctx.n_pat)
    before = fels.LAUNCHES_F64
    got = fels.site_logl_fels(*a64, clv_store=store, units=ctx.units, **kw)
    torch.cuda.synchronize()
    assert fels.LAUNCHES_F64 == before + 1 and got.dtype == torch.float64
    want = fels.site_logl_fels_ref(*a64, **kw)
    live = torch.arange(got.shape[1], device="cuda") < ctx.n_pat[:, None]
    assert bool((got[~live] == 0).all())
    site_err = float((got - want).abs().max())
    assert site_err < 1e-8, site_err
    w64 = ctx.weights.double()
    err = float((fe.reduce_root(got, w64, ctx.res_map, ctx.res_count)
                 - fe.reduce_root(want, w64, ctx.res_map, ctx.res_count)
                 )[ctx.locus_mask].abs().max())
    assert err < 1e-6, err


@pytest.mark.parametrize("store", STORES)
@pytest.mark.parametrize("n_cats", [1, 2, 4, 8])
@pytest.mark.parametrize("model_name", ["JC69", "HKY", "TN93", "GTR"])
def test_float64_builds_on_the_grid(cuda_state, cuda_diploid, model_name,
                                    n_cats, store):
    """The float64 builds' design (``DoubleWalk``) on both stores: K1 on
    haploid loci and K2 on diploid ones within 1e-10 of their float64
    plain versions (a locus, a pattern), repeat launches and block sizes
    bit-equal."""
    from bpp_tpu_torch.core import fels, pack
    for data in (cuda_state, cuda_diploid):
        eng, state = data
        ctx = eng.ctx
        L = state.gt.n_loci
        model, s64 = fixed_subst(model_name, n_cats, L, torch.float64,
                                 "cuda")
        a64 = _args(state, ctx, s64, torch.float64)
        kw = dict(model=model, n_cats=n_cats, units=ctx.units)
        k1 = pack.launch(pack.kernel_args(*a64, clv_store=store, **kw))
        k2 = fels.launch(fels.kernel_args(*a64[:-1], n_pat=ctx.n_pat,
                                          clv_store=store, **kw))
        torch.cuda.synchronize()
        want1 = pack.site_logl_packed_ref(*a64, model=model, n_cats=n_cats)
        want2 = fels.site_logl_fels_ref(*a64[:-1], model=model,
                                        n_cats=n_cats, n_pat=ctx.n_pat)
        mask = ctx.locus_mask
        assert float((k1 - want1)[mask].abs().max()) < 1e-10
        assert float((k2 - want2).abs().max()) < 1e-10
        k1, k2 = k1.clone(), k2.clone()
        for threads in (None, 64, 128, 256):
            assert torch.equal(k1, pack.launch(pack.kernel_args(
                *a64, clv_store=store, threads=threads, **kw)))
            assert torch.equal(k2, fels.launch(fels.kernel_args(
                *a64[:-1], n_pat=ctx.n_pat, clv_store=store,
                threads=threads, **kw)))


def test_x64_engine_launches_the_float64_build(tmp_path):
    """An engine in float64 on the card: 8 K1 launches an iteration, all of
    the float64 build, and its caches exact to float64 roundoff."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bpp_tpu_torch.core import pack
    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.mcmc.driver import Engine
    from bpp_tpu_torch.testing import write_simulated_run
    run = load_run_from_ctl(write_simulated_run(tmp_path, n_loci=12))
    run.cfg = run.cfg.replace(dtype="float64")
    eng = Engine(run, seed=1, device="cuda")
    state = eng.init_state()
    before = pack.LAUNCHES, pack.LAUNCHES_F64
    state, _ = eng.chunk_step(state, 3)
    torch.cuda.synchronize()
    assert pack.LAUNCHES - before[0] == 24
    assert pack.LAUNCHES_F64 - before[1] == 24
    assert state.logl.dtype == torch.float64
    assert eng.validate_state(state)


def test_single_sequence_and_padded_loci_finite():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bpp_tpu_torch.core import pack
    from bpp_tpu_torch.mcmc.driver import Engine
    from bpp_tpu_torch.testing import synthetic_run
    from bpp_tpu_torch.trees.gtree import inner_order
    run = synthetic_run(n_loci=5, n_seq=[6, 1, 3, 2, 5],
                        n_patterns=[12, 5, 150, 9, 7], seed=2,
                        pad_loci_to=8)
    eng = Engine(run, seed=3, device="cuda")
    state = eng.init_state()
    gt, s = state.gt, state.subst
    rk = torch.cat([s.rates, s.kappa1[:, None], s.kappa2[:, None]], dim=1)
    out = pack.site_logl_packed(
        inner_order(gt), gt.left, gt.right, gt.parent, eng.ctx.n_seq,
        gt.age, s.mu, rk, s.freqs, s.eigw, s.eigT, s.eigTi,
        eng.ctx.tip_partials, eng.ctx.weights, model=eng.cfg.model,
        n_cats=1)
    assert np.isfinite(out.cpu().numpy()).all()
    from bpp_tpu_torch.core import fels
    site = fels.site_logl_fels(
        inner_order(gt), gt.left, gt.right, gt.parent, eng.ctx.n_seq,
        gt.age, s.mu, rk, s.freqs, s.eigw, s.eigT, s.eigTi,
        eng.ctx.tip_partials, model=eng.cfg.model, n_cats=1,
        n_pat=eng.ctx.n_pat)
    assert np.isfinite(site.cpu().numpy()).all()
    live = torch.arange(site.shape[1], device="cuda") < eng.ctx.n_pat[:, None]
    assert bool((site[~live] == 0).all())
    # the per-locus kernel is the weighted sum of the per-pattern one
    W = eng.ctx.weights.shape[1]
    np.testing.assert_allclose(
        (eng.ctx.weights * site[:, :W]).sum(1).cpu().numpy(),
        out.cpu().numpy(), rtol=1e-4, atol=1e-3)


def _big_trees(n_tips):
    """The 12 loci of most sequences of ``shaped_batch``: fixed caterpillar
    and balanced trees of up to ``n_tips`` tips, 0..72 patterns."""
    from bpp_tpu_torch.core.units import Units
    from bpp_tpu_torch.testing import shaped_batch
    gt, n_seq, n_pat, tips, weights = (
        type(x)(*(None if y is None else y[-12:].contiguous() for y in x))
        if isinstance(x, tuple)
        else x[-12:].contiguous()
        for x in shaped_batch(n_tips, 72, seed=n_tips, device="cuda"))
    return gt, n_seq, n_pat, tips, weights, Units(n_pat.cpu().numpy(), 72,
                                                  "cuda")


def _tree_args(gt, n_seq, subst, tips, dtype):
    from bpp_tpu_torch.trees.gtree import inner_order
    rk = torch.cat([subst.rates, subst.kappa1[:, None],
                    subst.kappa2[:, None]], dim=1)
    return (inner_order(gt), gt.left, gt.right, gt.parent, n_seq,
            gt.age.to(dtype), subst.mu, rk, subst.freqs, subst.eigw,
            subst.eigT, subst.eigTi, tips.to(dtype))


@pytest.mark.parametrize("n_tips,model_name,n_cats,picked", [
    (64, "HKY", 4, "shared"),      # 3 warps of 71 KB a block
    (128, "GTR", 8, "global"),     # 256 KB of CLVs a warp: over a block's
                                   # 227 KB
])
def test_large_trees_pick_their_store(n_tips, model_name, n_cats, picked):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bpp_tpu_torch.core import fels, pack
    gt, n_seq, n_pat, tips, weights, units = _big_trees(n_tips)
    L = gt.n_loci
    model, s32 = fixed_subst(model_name, n_cats, L, torch.float32, "cuda")
    _, s64 = fixed_subst(model_name, n_cats, L, torch.float64, "cuda")
    a32 = _tree_args(gt, n_seq, s32, tips, torch.float32) + (weights,)
    a64 = _tree_args(gt, n_seq, s64, tips, torch.float64) \
        + (weights.double(),)
    kw = dict(model=model, n_cats=n_cats)
    # float32 roundoff grows with the T - 1 levels: the 16-tip bounds,
    # scaled by T / 16
    scale = n_tips / 16
    site = fels.site_logl_fels(*a32[:-1], n_pat=n_pat, units=units, **kw)
    assert fels.CLV_STORE == picked
    want = fels.site_logl_fels_ref(*a64[:-1], n_pat=n_pat, **kw)
    assert float((site.double() - want).abs().max()) < 2e-3 * scale
    logl = pack.site_logl_packed(*a32, units=units, **kw)
    assert pack.CLV_STORE == picked
    want_l = pack.site_logl_packed_ref(*a64, **kw)
    assert float((logl.double() - want_l).abs().max()) < 0.02 * scale
    if picked == "shared":
        # the global store computes the same arithmetic in the same order
        assert torch.equal(site, fels.site_logl_fels(
            *a32[:-1], n_pat=n_pat, units=units, clv_store="global", **kw))
        assert torch.equal(logl, pack.site_logl_packed(
            *a32, units=units, clv_store="global", **kw))


def test_blen_given_equals_the_strict_clock(cuda_diploid):
    from bpp_tpu_torch.core import fels, pack
    from bpp_tpu_torch.core import felsenstein as fe
    eng, state = cuda_diploid
    ctx = eng.ctx
    L = state.gt.n_loci
    model, s32 = fixed_subst("HKY", 4, L, torch.float32, "cuda")
    s32 = s32._replace(mu=torch.linspace(0.5, 2.0, L, device="cuda"))
    a32 = _args(state, ctx, s32, torch.float32)
    blen = fe.branch_lengths(state.gt, s32.mu)
    kw = dict(model=model, n_cats=4, units=ctx.units)
    assert torch.equal(
        fels.site_logl_fels(*a32[:-1], n_pat=ctx.n_pat, **kw),
        fels.site_logl_fels(*a32[:-1], n_pat=ctx.n_pat, blen=blen, **kw))
    assert torch.equal(pack.site_logl_packed(*a32, **kw),
                       pack.site_logl_packed(*a32, blen=blen, **kw))
    # and it is read: other lengths give another answer
    assert not torch.equal(
        pack.site_logl_packed(*a32, **kw),
        pack.site_logl_packed(*a32, blen=2.0 * blen, **kw))


def test_repeat_launches_and_block_sizes_are_bit_equal():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bpp_tpu_torch.core import fels, pack
    from bpp_tpu_torch.mcmc.driver import Engine
    from bpp_tpu_torch.testing import synthetic_run
    run = synthetic_run(n_loci=9, n_seq=[6, 1, 3, 2, 5, 6, 6, 4, 2],
                        n_patterns=[12, 5, 300, 9, 7, 33, 64, 1, 2], seed=2,
                        pad_loci_to=12)
    eng = Engine(run, seed=3, device="cuda")
    state = eng.init_state()
    ctx = eng.ctx
    L = state.gt.n_loci
    model, s32 = fixed_subst("TN93", 3, L, torch.float32, "cuda")
    a32 = _args(state, ctx, s32, torch.float32)
    kw = dict(model=model, n_cats=3, units=ctx.units)
    first = pack.launch(pack.kernel_args(*a32, **kw))
    site = fels.launch(fels.kernel_args(*a32[:-1], n_pat=ctx.n_pat, **kw))
    for threads in (None, 64, 128, 256):
        for store in STORES:
            k1 = pack.kernel_args(*a32, threads=threads, clv_store=store,
                                  **kw)
            assert k1.plan.clv_store == store
            assert torch.equal(first, pack.launch(k1)), (threads, store)
            k2 = fels.kernel_args(*a32[:-1], n_pat=ctx.n_pat,
                                  threads=threads, clv_store=store, **kw)
            assert torch.equal(site, fels.launch(k2)), (threads, store)
            assert fels.CLV_STORE == store
    # one sum in double per locus, in pattern order
    W = ctx.weights.shape[1]
    np.testing.assert_allclose(
        first.cpu().numpy(),
        (ctx.weights.double() * site[:, :W].double()).sum(1).cpu().numpy(),
        rtol=1e-6, atol=1e-6)


def test_padding_levels_of_the_schedule_may_hold_anything():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bpp_tpu_torch.core import fels, pack
    from bpp_tpu_torch.mcmc.driver import Engine
    from bpp_tpu_torch.testing import synthetic_run
    run = synthetic_run(n_loci=6, n_seq=[6, 1, 3, 2, 5, 4],
                        n_patterns=[12, 5, 70, 9, 7, 33], seed=5,
                        pad_loci_to=8)
    eng = Engine(run, seed=3, device="cuda")
    state = eng.init_state()
    ctx = eng.ctx
    L, T = ctx.tip_partials.shape[:2]
    model, s32 = fixed_subst("HKY", 4, L, torch.float32, "cuda")
    a32 = _args(state, ctx, s32, torch.float32)
    kw = dict(model=model, n_cats=4, units=ctx.units)
    # levels k >= n_seq - 1 are never entered: any node id may stand there
    junk = torch.randint(0, 2 * T - 1, a32[0].shape, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(1))
    padding = torch.arange(T - 1, device="cuda") >= ctx.n_seq[:, None] - 1
    b32 = (torch.where(padding, junk, a32[0]),) + a32[1:]
    assert not torch.equal(a32[0], b32[0])
    for store in STORES:
        assert torch.equal(pack.site_logl_packed(*a32, clv_store=store, **kw),
                           pack.site_logl_packed(*b32, clv_store=store, **kw))
        assert torch.equal(
            fels.site_logl_fels(*a32[:-1], n_pat=ctx.n_pat, clv_store=store,
                                **kw),
            fels.site_logl_fels(*b32[:-1], n_pat=ctx.n_pat, clv_store=store,
                                **kw))


def test_refused_shapes_raise(cuda_state):
    from bpp_tpu_torch.core import fels, pack
    from bpp_tpu_torch.core.units import Units
    eng, state = cuda_state
    ctx = eng.ctx
    L = state.gt.n_loci
    before = pack.LAUNCHES, fels.LAUNCHES
    model, s9 = fixed_subst("HKY", 9, L, torch.float32, "cuda")
    with pytest.raises(ValueError, match="rate categories"):
        pack.site_logl_packed(*_args(state, ctx, s9, torch.float32),
                              model=model, n_cats=9)
    model, s4 = fixed_subst("HKY", 4, L, torch.float32, "cuda")
    a32 = _args(state, ctx, s4, torch.float32)
    kw = dict(model=model, n_cats=4)
    with pytest.raises(ValueError, match="clv_store"):
        fels.site_logl_fels(*a32[:-1], clv_store="registers", **kw)
    with pytest.raises(ValueError, match="unit table"):
        fels.site_logl_fels(*a32[:-1], units=Units([3] * (L + 1), 8, "cuda"),
                            **kw)
    with pytest.raises(ValueError, match="not contiguous"):
        pack.site_logl_packed(a32[0], a32[1].t().contiguous().t(), *a32[2:],
                              **kw)
    with pytest.raises(ValueError, match="threads"):
        pack.kernel_args(*a32, threads=48, **kw)
    assert (pack.LAUNCHES, fels.LAUNCHES) == before


def _chain_engine(tmp, priors, diploid=False, dates=False):
    """A CUDA engine after a short chain of a relaxed-clock or tip-dating
    run: (engine, state)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.mcmc.driver import Engine
    from bpp_tpu_torch.testing import write_simulated_run
    if dates:
        rng = np.random.default_rng(8)
        (tmp / "dates.txt").write_text("".join(
            f"{s}{k} {rng.uniform(0, 1):.3f}\n" for s in "abcd"
            for k in (1, 2)))
        priors = priors + (f"datefile = {tmp / 'dates.txt'}",)
    run = load_run_from_ctl(write_simulated_run(
        tmp, n_loci=12, seqs=(2, 2, 2, 2),
        diploid=(1, 1, 0, 0) if diploid else None,
        model="HKY" if diploid else "JC69", priors=priors,
        thetaprior="invgamma 3 0.03 int" if dates else "3 0.03"))
    eng = Engine(run, seed=1, device="cuda")
    state = eng.init_state()
    state, _ = eng.chunk_step(state, 5)
    return eng, state


@pytest.fixture(scope="module")
def cuda_relaxed(tmp_path_factory):
    return _chain_engine(tmp_path_factory.mktemp("gpurelaxed"), (
        "locusrate = 1 10 10 5 iid", "clock = 2 10 100 5 iid G"))


@pytest.fixture(scope="module")
def cuda_simple_diploid(tmp_path_factory):
    return _chain_engine(tmp_path_factory.mktemp("gpusimple"), (
        "locusrate = 1 10 10 5 iid", "clock = 4 2.0"), diploid=True)


@pytest.fixture(scope="module")
def cuda_dated(tmp_path_factory):
    return _chain_engine(tmp_path_factory.mktemp("gpudated"), (
        "locusrate = 3 10 10000",), dates=True)


def _relaxed_blen(eng, state, dtype):
    from bpp_tpu_torch.config import Clock
    from bpp_tpu_torch.core import felsenstein as fe
    from bpp_tpu_torch.trees.gtree import assign_populations
    gt = state.gt._replace(age=state.gt.age.to(dtype))
    sp = state.sp._replace(tau=state.sp.tau.to(dtype))
    brate = state.clock.brate.to(dtype)
    if eng.cfg.clock == Clock.SIMPLE:
        brate = brate * state.subst.mu.to(dtype)[:, None]
    return fe.relaxed_branch_lengths(
        gt, sp, assign_populations(gt, sp, eng.ctx.tip_pop), brate)


@pytest.mark.parametrize("store", STORES)
@pytest.mark.parametrize("data", ["cuda_relaxed", "cuda_simple_diploid",
                                  "cuda_dated"])
@pytest.mark.parametrize("model_name,n_cats", MODELS)
def test_kernels_on_relaxed_lengths_and_dated_tips(request, data,
                                                  model_name, n_cats, store):
    """K1 on a clock = 2 chain's branch lengths and on a tip-dating
    chain's gene trees (nonzero tip ages), K2 on a clock = 4 diploid
    chain's branch lengths, each against its float64 plain version."""
    from bpp_tpu_torch.core import fels, pack
    from bpp_tpu_torch.core import felsenstein as fe
    eng, state = request.getfixturevalue(data)
    ctx = eng.ctx
    L = state.gt.n_loci
    model, s32 = fixed_subst(model_name, n_cats, L, torch.float32, "cuda")
    _, s64 = fixed_subst(model_name, n_cats, L, torch.float64, "cuda")
    a32 = _args(state, ctx, s32, torch.float32)
    a64 = _args(state, ctx, s64, torch.float64)
    b32 = b64 = None
    if data == "cuda_dated":
        assert bool((state.gt.age[:, :state.gt.n_tips] > 0).any())
    else:
        b32 = _relaxed_blen(eng, state, torch.float32).contiguous()
        b64 = _relaxed_blen(eng, state, torch.float64)
        strict = fe.branch_lengths(state.gt, state.subst.mu)
        assert not bool(torch.isclose(b32, strict).all())
    kw = dict(model=model, n_cats=n_cats)
    mask = ctx.locus_mask
    if ctx.res_map is None:
        got = pack.site_logl_packed(*a32, blen=b32, units=ctx.units,
                                    clv_store=store, **kw).double()
        want = pack.site_logl_packed_ref(*a64, blen=b64, **kw)
        assert pack.CLV_STORE == store
    else:
        site = fels.site_logl_fels(*a32[:-1], blen=b32, n_pat=ctx.n_pat,
                                   units=ctx.units, clv_store=store,
                                   **kw).double()
        want_s = fels.site_logl_fels_ref(*a64[:-1], blen=b64,
                                         n_pat=ctx.n_pat, **kw)
        assert fels.CLV_STORE == store
        assert float((site - want_s).abs().max()) < 2e-3
        w = ctx.weights.double()
        got = fe.reduce_root(site, w, ctx.res_map, ctx.res_count)
        want = fe.reduce_root(want_s, w, ctx.res_map, ctx.res_count)
    assert bool(torch.isfinite(got[mask]).all())
    err = float((got - want)[mask].abs().max())
    assert err < 0.02, err


@pytest.mark.parametrize("data", ["cuda_relaxed", "cuda_simple_diploid",
                                  "cuda_dated"])
def test_new_chains_keep_their_caches_on_the_card(request, data):
    """A few more iterations of each chain on the card: the cached logl
    stays within float32 roundoff of a fresh pass, lnrates of a fresh
    rate prior, and the integrated-theta caches equal fresh ones."""
    from bpp_tpu_torch.mcmc import clock_moves
    eng, state = request.getfixturevalue(data)
    state, _ = eng.chunk_step(state, 3)
    logl = eng._logl_fn(state.gt, state.subst, state.sp, state.clock)
    assert float((state.logl - logl).abs().max()) < 0.02
    if state.clock is not None:
        lnr = clock_moves.lnprior_rates(eng.cfg, state.sp, state.subst.mu,
                                        state.clock)
        assert torch.allclose(state.clock.lnrates, lnr, rtol=1e-5, atol=1e-3)
    if state.coal is not None:
        _, c, t2 = eng._logpr_fn(state.gt, state.sp, state.subst.heredity)
        assert torch.equal(state.coal, c)
        assert torch.allclose(state.t2h, t2, rtol=1e-5, atol=1e-7)


def _species_engine(tmp, priors, diploid=False):
    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.mcmc.driver import Engine
    from bpp_tpu_torch.testing import write_simulated_run
    kw = dict(seqs=(2, 2, 2, 2), diploid=(1, 1, 0, 0)) if diploid else {}
    run = load_run_from_ctl(write_simulated_run(
        tmp, n_loci=12, n_sites=60, priors=priors, **kw))
    eng = Engine(run, seed=2, device="cuda")
    state = eng.init_state()
    state, _ = eng.chunk_step(state, 5)
    return eng, state


@pytest.fixture(scope="module")
def cuda_a01(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return _species_engine(tmp_path_factory.mktemp("gpua01"),
                           ("speciestree = 1 0.5 0.33 0.1 0.2",))


@pytest.fixture(scope="module")
def cuda_a11(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return _species_engine(tmp_path_factory.mktemp("gpua11"), (
        "speciesdelimitation = 1 0 2", "speciestree = 1"), diploid=True)


def _proposed_trees(eng, state, move_name):
    """The gene trees the pruning kernel was launched on inside one call of
    the move, and the loci whose trees are valid (a proposal the move
    rejects by its own checks may hold loci that are not trees)."""
    from bpp_tpu_torch.mcmc import mig_moves, rj_moves, stree_moves
    from bpp_tpu_torch.mcmc import state as state_mod
    from bpp_tpu_torch.testing import gene_tree_faults
    from bpp_tpu_torch.trees.gtree import GTrees
    seen = []
    name = ("site_logl_fels" if eng.ctx.res_map is not None
            else "site_logl_packed")
    orig = getattr(state_mod, name)

    def spy(*args, **kw):
        seen.append(GTrees(*(x.clone() for x in (args[1], args[2], args[3],
                                                  args[5]))))
        return orig(*args, **kw)

    setattr(state_mod, name, spy)
    try:
        if move_name == "rj":
            rj_moves.rj_move(eng.ctx, eng.cfg, state, eng.gen, eng.root_age0)
        elif move_name == "spr_sim":
            mig_moves.spr_sim_move(eng.ctx, eng.cfg, eng.mig_routes, state,
                                   eng.gen)
        else:
            getattr(stree_moves, move_name)(eng.ctx, eng.cfg, state, eng.gen)
    finally:
        setattr(state_mod, name, orig)
    assert len(seen) == 1
    gt = seen[0]
    bad = {f[0] for f in gene_tree_faults(gt, eng.ctx.n_seq)}
    ok = torch.tensor([i not in bad for i in range(gt.n_loci)],
                      device="cuda") & eng.ctx.locus_mask
    return state._replace(gt=gt), ok


@pytest.mark.parametrize("store", STORES)
@pytest.mark.parametrize("data,move", [
    ("cuda_a01", "species_spr_move"), ("cuda_a01", "snl_move"),
    ("cuda_a11", "species_spr_move"), ("cuda_a11", "snl_move"),
    ("cuda_a11", "rj")])
@pytest.mark.parametrize("model_name,n_cats", MODELS)
def test_kernels_on_species_move_trees(request, data, move, model_name,
                                       n_cats, store):
    from bpp_tpu_torch.core import fels, pack
    from bpp_tpu_torch.core import felsenstein as fe
    eng, state = request.getfixturevalue(data)
    ctx = eng.ctx
    for _ in range(3):
        st, ok = _proposed_trees(eng, state, move)
        L = st.gt.n_loci
        model, s32 = fixed_subst(model_name, n_cats, L, torch.float32,
                                 "cuda")
        _, s64 = fixed_subst(model_name, n_cats, L, torch.float64, "cuda")
        kw = dict(model=model, n_cats=n_cats)
        a32 = _args(st, ctx, s32, torch.float32)
        a64 = _args(st, ctx, s64, torch.float64)
        if ctx.res_map is None:
            got = pack.site_logl_packed(*a32, units=ctx.units,
                                        clv_store=store, **kw).double()
            want = pack.site_logl_packed_ref(*a64, **kw)
        else:
            w64 = ctx.weights.double()
            gs = fels.site_logl_fels(*a32[:-1], n_pat=ctx.n_pat,
                                     units=ctx.units, clv_store=store,
                                     **kw).double()
            ws = fels.site_logl_fels_ref(*a64[:-1], n_pat=ctx.n_pat, **kw)
            assert float((gs - ws)[ok].abs().max()) < 2e-3
            got = fe.reduce_root(gs, w64, ctx.res_map, ctx.res_count)
            want = fe.reduce_root(ws, w64, ctx.res_map, ctx.res_count)
        torch.cuda.synchronize()
        assert (pack if ctx.res_map is None else fels).CLV_STORE == store
        assert bool(ok.any())
        assert bool(torch.isfinite(got[ok]).all())
        assert float((got - want)[ok].abs().max()) < 0.02


@pytest.mark.parametrize("data", ["cuda_a01", "cuda_a11"])
def test_species_chains_keep_their_caches_on_the_card(request, data):
    from bpp_tpu_torch.mcmc.stree_moves import (
        _recompute_mrca, _recompute_pptable,
    )
    from bpp_tpu_torch.testing import gene_tree_faults
    eng, state = request.getfixturevalue(data)
    state, stats = eng.chunk_step(state, 10)
    assert gene_tree_faults(state.gt, eng.ctx.n_seq) == []
    logl = eng._logl_fn(state.gt, state.subst, state.sp, state.clock)
    logpr, _, _ = eng._logpr_fn(state.gt, state.sp, state.subst.heredity)
    m = eng.ctx.locus_mask
    assert float((logl - state.logl)[m].abs().max()) < 1e-3
    assert float((logpr - state.logpr)[m].abs().max()) < 1e-3
    pp = _recompute_pptable(state.sp.parent, state.sp.n_nodes)
    assert torch.equal(pp, state.sp.pptable)
    assert torch.equal(_recompute_mrca(pp), state.sp.mrca)


@pytest.fixture(scope="module")
def cuda_partition(tmp_path_factory):
    """A five-model DNA partition (``model = custom``) on haploid data and
    on data with unphased diploid species, each engine after 10
    iterations on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.mcmc.driver import Engine
    from bpp_tpu_torch.testing import write_partition_file, write_simulated_run
    out = {}
    for name, kw in (("haploid", {}), ("diploid", dict(
            seqs=(2, 2, 2, 2), diploid=(1, 1, 0, 0),
            priors=("alphaprior = 1 1 4",)))):
        tmp = tmp_path_factory.mktemp(f"torchgpucustom{name}")
        parts = write_partition_file(
            tmp / "parts.txt", ["JC69", "K80", "HKY", "TN93", "GTR"], 10)
        run = load_run_from_ctl(write_simulated_run(
            tmp, n_loci=10, model=f"custom {parts}", **kw))
        eng = Engine(run, seed=1, device="cuda")
        state, _ = eng.chunk_step(eng.init_state(), 10)
        out[name] = (eng, state)
    return out


@pytest.mark.parametrize("store", STORES)
@pytest.mark.parametrize("data", ["haploid", "diploid"])
def test_kernels_on_a_partition(cuda_partition, data, store):
    """K1 (haploid) and K2 (diploid) through the GTR family on per-locus
    eigensystems against the float64 plain version; the chain's cached
    lnL equals a fresh pass."""
    from bpp_tpu_torch.config import SubstModel
    from bpp_tpu_torch.core import fels, pack
    from bpp_tpu_torch.core import felsenstein as fe
    from bpp_tpu_torch.mcmc import subst_moves
    from bpp_tpu_torch.mcmc.state import refresh_eigen
    eng, st = cuda_partition[data]
    ctx = eng.ctx
    assert ctx.route == ("K1" if data == "haploid" else "K2")
    cm, C = ctx.custom, st.subst.rates.shape[1]

    def subst(dtype):
        s = type(st.subst)(*(x.to(dtype) for x in st.subst))
        s = subst_moves._derive_kappas(s, SubstModel.CUSTOM, cm)
        s = refresh_eigen(s, SubstModel.CUSTOM, cm)
        return type(s)(*(x.contiguous() for x in s))

    kw = dict(model=SubstModel.CUSTOM, n_cats=C)
    a32 = _args(st, ctx, subst(torch.float32), torch.float32)
    a64 = _args(st, ctx, subst(torch.float64), torch.float64)
    if data == "haploid":
        got = pack.site_logl_packed(*a32, units=ctx.units, clv_store=store,
                                    **kw).double()
        want = pack.site_logl_packed_ref(*a64, **kw)
    else:
        w64 = ctx.weights.double()
        gs = fels.site_logl_fels(*a32[:-1], n_pat=ctx.n_pat, units=ctx.units,
                                 clv_store=store, **kw).double()
        ws = fels.site_logl_fels_ref(*a64[:-1], n_pat=ctx.n_pat, **kw)
        assert float((gs - ws).abs().max()) < 2e-3
        got = fe.reduce_root(gs, w64, ctx.res_map, ctx.res_count)
        want = fe.reduce_root(ws, w64, ctx.res_map, ctx.res_count)
    torch.cuda.synchronize()
    m = ctx.locus_mask
    assert float((got - want)[m].abs().max()) < 0.02
    fresh = eng._logl_fn(st.gt, st.subst, st.sp, st.clock)
    assert float((fresh - st.logl)[m].abs().max()) < 1e-3
    assert eng.validate_state(st)


def test_amino_acid_pass_on_the_card(tmp_path):
    """WAG: the 20-state plain pass on the card in float32 against the
    same pass in float64 on the CPU; no pruning kernel is launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from bpp_tpu_torch.core import fels, pack
    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.mcmc.driver import Engine
    from bpp_tpu_torch.mcmc.state import make_logl_fn
    from bpp_tpu_torch.testing import generate_aa_benchmark
    generate_aa_benchmark(6, 120, str(tmp_path))
    ctl = tmp_path / "aa.ctl"
    ctl.write_text(f"""seed = 11
seqfile = {tmp_path}/aa.phy
Imapfile = {tmp_path}/Imap.txt
jobname = {tmp_path}/aaout
species&tree = 4 A B C D
                 4 4 4 4
                ((A, B), (C, D));
usedata = 1
nloci = 6
cleandata = 0
model = WAG
thetaprior = 3 0.03
tauprior = 3 0.06
burnin = 2
sampfreq = 1
nsample = 2
""")
    eng = Engine(load_run_from_ctl(str(ctl)), seed=1, device="cuda")
    assert eng.ctx.route == "plain"
    before = (pack.LAUNCHES, fels.LAUNCHES)
    st, _ = eng.chunk_step(eng.init_state(), 5)
    assert (pack.LAUNCHES, fels.LAUNCHES) == before
    got = eng._logl_fn(st.gt, st.subst, st.sp, st.clock).double().cpu()
    cpu = torch.device("cpu")
    ctx64 = dataclasses.replace(
        eng.ctx, tip_partials=eng.ctx.tip_partials.double().to(cpu),
        weights=eng.ctx.weights.double().to(cpu),
        n_seq=eng.ctx.n_seq.to(cpu), n_pat=eng.ctx.n_pat.to(cpu),
        locus_mask=eng.ctx.locus_mask.to(cpu))

    def host(t):
        return type(t)(*(None if x is None else x.to(cpu, torch.float64)
                         if x.is_floating_point() else x.to(cpu) for x in t))

    want = make_logl_fn(ctx64, eng.cfg)(host(st.gt), host(st.subst))
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) < 0.02


# --- MSC-M migration ---------------------------------------------------------

MIG_SIM = "model = 0\nmigration = 2\nA B 20\nB A 20"
MIG_SIM_DIPLOID = ("model = 3\nkappa = 2\nbasefreqs = 0.3 0.2 0.2 0.3\n"
                   "migration = 2\nA B 20\nB A 20")
MIG_RUN = "migration = 2\nA B 2 0.1\nB A 2 0.1"


def _mig_engine(tmp, priors=(), diploid=False):
    """A CUDA engine after 10 iterations of an MSC-M chain on 12 loci
    simulated with migration between A and B: (engine, state)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.mcmc.driver import Engine
    from bpp_tpu_torch.testing import write_simulated_run
    run = load_run_from_ctl(write_simulated_run(
        tmp, n_loci=12, n_sites=60, seqs=(2, 2, 2, 2),
        diploid=(1, 1, 0, 0) if diploid else None,
        sim_model=MIG_SIM_DIPLOID if diploid else MIG_SIM,
        model="HKY" if diploid else "JC69", priors=(MIG_RUN, *priors)))
    eng = Engine(run, seed=3, device="cuda")
    state = eng.init_state()
    state, _ = eng.chunk_step(state, 10)
    return eng, state


@pytest.fixture(scope="module")
def cuda_mig(tmp_path_factory):
    return _mig_engine(tmp_path_factory.mktemp("gpumig"))


@pytest.fixture(scope="module")
def cuda_mig_relaxed(tmp_path_factory):
    return _mig_engine(tmp_path_factory.mktemp("gpumigc"), (
        "locusrate = 1 10 10 5 iid", "clock = 2 10 100 5 iid G"))


@pytest.fixture(scope="module")
def cuda_mig_diploid(tmp_path_factory):
    return _mig_engine(tmp_path_factory.mktemp("gpumigd"), diploid=True)


def _mig_blen(eng, state, dtype):
    from bpp_tpu_torch.trees import migration as mg
    gt = state.gt._replace(age=state.gt.age.to(dtype))
    sp = state.sp._replace(tau=state.sp.tau.to(dtype))
    mig = state.mig._replace(time=state.mig.time.to(dtype))
    pops = mg.assign_populations_mig(gt, sp, eng.ctx.tip_pop, mig,
                                     eng.ctx.n_seq)
    return mg.relaxed_branch_lengths_mig(gt, sp, mig, pops, eng.ctx.n_seq,
                                         state.clock.brate.to(dtype))


@pytest.mark.parametrize("store", STORES)
@pytest.mark.parametrize("data", ["cuda_mig", "cuda_mig_relaxed",
                                  "cuda_mig_diploid"])
@pytest.mark.parametrize("model_name,n_cats", MODELS)
def test_kernels_on_migration_trees(request, data, model_name, n_cats,
                                    store):
    """K1 on the gene trees spr_sim_move proposes and on the sub-edge
    branch lengths of a clock = 2 MSC-M chain, K2 on a diploid batch
    simulated under migration, each against its float64 plain version."""
    from bpp_tpu_torch.core import fels, pack
    from bpp_tpu_torch.core import felsenstein as fe
    eng, state = request.getfixturevalue(data)
    ctx = eng.ctx
    ok = ctx.locus_mask
    b32 = b64 = None
    if data == "cuda_mig":
        state, ok = _proposed_trees(eng, state, "spr_sim")
    elif data == "cuda_mig_relaxed":
        b32 = _mig_blen(eng, state, torch.float32).contiguous()
        b64 = _mig_blen(eng, state, torch.float64)
    L = state.gt.n_loci
    model, s32 = fixed_subst(model_name, n_cats, L, torch.float32, "cuda")
    _, s64 = fixed_subst(model_name, n_cats, L, torch.float64, "cuda")
    kw = dict(model=model, n_cats=n_cats)
    a32 = _args(state, ctx, s32, torch.float32)
    a64 = _args(state, ctx, s64, torch.float64)
    if ctx.res_map is None:
        got = pack.site_logl_packed(*a32, blen=b32, units=ctx.units,
                                    clv_store=store, **kw).double()
        want = pack.site_logl_packed_ref(*a64, blen=b64, **kw)
    else:
        w64 = ctx.weights.double()
        gs = fels.site_logl_fels(*a32[:-1], n_pat=ctx.n_pat, units=ctx.units,
                                 clv_store=store, **kw).double()
        ws = fels.site_logl_fels_ref(*a64[:-1], n_pat=ctx.n_pat, **kw)
        assert float((gs - ws)[ok].abs().max()) < 2e-3
        got = fe.reduce_root(gs, w64, ctx.res_map, ctx.res_count)
        want = fe.reduce_root(ws, w64, ctx.res_map, ctx.res_count)
    torch.cuda.synchronize()
    assert (pack if ctx.res_map is None else fels).CLV_STORE == store
    assert bool(ok.any())
    assert bool(torch.isfinite(got[ok]).all())
    assert float((got - want)[ok].abs().max()) < 0.02


@pytest.mark.parametrize("data", ["cuda_mig", "cuda_mig_relaxed",
                                  "cuda_mig_diploid"])
def test_mig_chains_keep_their_caches_on_the_card(request, data):
    """A few more iterations of each MSC-M chain on the card: the cached
    logl and logpr stay within float32 roundoff of fresh ones, and every
    real locus's routes and events are consistent."""
    from bpp_tpu_torch.trees import migration as mg
    eng, state = request.getfixturevalue(data)
    state, _ = eng.chunk_step(state, 3)
    ctx = eng.ctx
    logl = eng._logl_fn(state.gt, state.subst, state.sp, state.clock,
                        mig=state.mig)
    logpr, *_, pops = eng._logpr_mig_fn(state.gt, state.sp, state.mig,
                                        state.subst.heredity)
    m = ctx.locus_mask
    assert float((logl - state.logl)[m].abs().max()) < 1e-3
    assert float((logpr - state.logpr)[m].abs().max()) < 1e-3
    ok = mg.route_consistent_mig(state.gt, state.sp, state.mig, pops,
                                 ctx.n_seq)
    assert bool((ok | ~m).all())


@pytest.mark.parametrize("model_name,n_cats", MODELS)
@pytest.mark.parametrize("data", ["cuda_state", "cuda_diploid"])
def test_kernels_on_a_branch_of_the_smallest_normal_length(request, data,
                                                          model_name,
                                                          n_cats):
    """A cherry raised to float32's smallest normal age above its tips (an
    age move's reflection off the tips' age 0 can leave a node there) on
    every locus: K1 per locus and K2 per pattern against their float64
    plain versions, whose closed-form P(t) keeps the cherry's off-diagonal
    entries (t / 3 and the like) as the kernels' expm1 factors do."""
    from bpp_tpu_torch.core import fels, pack
    eng, state = request.getfixturevalue(data)
    ctx = eng.ctx
    gt = state.gt
    T = gt.n_tips
    age = gt.age.clone()
    for l in range(gt.n_loci):
        for node in range(T, T + int(ctx.n_seq[l]) - 1):
            if int(gt.left[l, node]) < T and int(gt.right[l, node]) < T:
                age[l, node] = torch.finfo(torch.float32).tiny
                break
    state = state._replace(gt=gt._replace(age=age))
    L = gt.n_loci
    model, s32 = fixed_subst(model_name, n_cats, L, torch.float32, "cuda")
    _, s64 = fixed_subst(model_name, n_cats, L, torch.float64, "cuda")
    kw = dict(model=model, n_cats=n_cats)
    a32 = _args(state, ctx, s32, torch.float32)
    a64 = _args(state, ctx, s64, torch.float64)
    ok = ctx.locus_mask
    if ctx.res_map is None:
        got = pack.site_logl_packed(*a32, units=ctx.units, **kw).double()
        want = pack.site_logl_packed_ref(*a64, **kw)
        assert float((got - want)[ok].abs().max()) < 0.02
    else:
        gs = fels.site_logl_fels(*a32[:-1], n_pat=ctx.n_pat, units=ctx.units,
                                 **kw).double()
        ws = fels.site_logl_fels_ref(*a64[:-1], n_pat=ctx.n_pat, **kw)
        assert float((gs - ws)[ok].abs().max()) < 2e-3


def _card_engine(tmp, **kw):
    """A CUDA engine after 10 iterations of a chain on 12 simulated loci
    (``write_simulated_run``'s keywords): (engine, state)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.mcmc.driver import Engine
    from bpp_tpu_torch.testing import write_simulated_run
    run = load_run_from_ctl(write_simulated_run(tmp, n_loci=12, n_sites=60,
                                                **kw))
    eng = Engine(run, seed=3, device="cuda")
    state = eng.init_state()
    state, _ = eng.chunk_step(state, 10)
    return eng, state


@pytest.fixture(scope="module")
def cuda_msci(tmp_path_factory):
    from bpp_tpu_torch.testing import NET_GUIDE, NET_SIM_TREE
    return _card_engine(tmp_path_factory.mktemp("gpumsci"),
                        sim_tree=NET_SIM_TREE, guide=NET_GUIDE,
                        priors=("phiprior = 1 1",))


@pytest.fixture(scope="module")
def cuda_gtr(tmp_path_factory):
    """GTR+G4 (a per-chain eigensystem under chains = K) on haploid data
    (K1)."""
    return _card_engine(tmp_path_factory.mktemp("gpugtr"), model="GTR",
                        priors=("alphaprior = 1 1 4",))


@pytest.fixture(scope="module")
def cuda_gtr_diploid(tmp_path_factory):
    """GTR+G4 with unphased diploids in species A and B (K2)."""
    eng, state = _card_engine(tmp_path_factory.mktemp("gpugtrd"),
                              model="GTR", seqs=(1, 1, 2, 2),
                              diploid=(1, 1, 0, 0),
                              priors=("alphaprior = 1 1 4",))
    assert eng.ctx.res_map is not None
    return eng, state


@pytest.fixture(scope="module")
def cuda_int(tmp_path_factory):
    return _card_engine(tmp_path_factory.mktemp("gpuint"),
                        thetaprior="invgamma 3 0.03 int")


@pytest.fixture(scope="module")
def cuda_snl(tmp_path_factory):
    return _card_engine(tmp_path_factory.mktemp("gpusnl"),
                        priors=("speciestree = 1 0.5 0.33 0.1 0.2",))


@pytest.fixture(scope="module")
def cuda_gdir(tmp_path_factory):
    return _card_engine(tmp_path_factory.mktemp("gpugdir"), priors=(
        "clock = 3 10 100 5 gdir LN", "locusrate = 1 10 10 5"))


# a decision whose margin is under these may go either way between the card
# and the host (lgamma/log differ by ulps; a float32 sum of another order)
CHAIN_TIE = 1e-9
WALK_TIE = 1e-6


def _masks_agree(got, want, margin):
    """Accept masks equal up to a first disagreement at a near tie (the
    chains part there), with at most one near tie."""
    got, want = got.cpu().numpy(), want.numpy()
    near = margin < CHAIN_TIE
    differ = np.flatnonzero(got != want)
    assert not len(differ) or near[differ[0]], (differ[:5], margin[differ])
    assert near.sum() <= 1


CHAIN_REGIMES = ["random", "all", "none", "alternating", "edge"]
CHAIN_LOCI = [1, 5, 31, 33, 1000, 10000]


def _regime_dother(rng, L, regime):
    """The locus-factorizing part of ln acceptance: every proposing locus
    accepted ("all"), none ("none"), runs of three of each
    ("alternating"), else random."""
    if regime == "all":
        return np.full(L, 50.0)
    if regime == "none":
        return np.full(L, -50.0)
    if regime == "alternating":
        return np.where((np.arange(L) // 3) % 2 == 0, 50.0, -50.0)
    return rng.normal(0.0, 1.0, L)


def _k3_case(rng, L, H, regime, a=3.0, b=0.03):
    """(cols, sums) of a random integrated-theta chain: gene-tree-like
    proposals on 80% of the loci, a tenth of them proposing their current
    rows (no population changes), the last three loci padded (no
    proposal) where L > 5.  "edge": log u puts every proposing locus's
    decision 1e-7..1e-6 from its threshold under the serial walk's carry,
    accepted or rejected at random (a decision taken under another carry
    would differ)."""
    import math
    co = rng.integers(0, 5, (L, H)).astype(np.float64)
    to = rng.gamma(2.0, 0.02, (L, H)) * (co > 0)
    mask = rng.random(L) < 0.8
    if L > 5:
        mask[-3:] = False
    cn = co.copy()
    if H > 1:
        src = rng.integers(0, H, L)
        dst = (src + 1 + rng.integers(0, H - 1, L)) % H
        move = mask & (cn[np.arange(L), src] > 0)
        cn[np.arange(L)[move], src[move]] -= 1
        cn[np.arange(L)[move], dst[move]] += 1
    tn = np.where(mask[:, None], to * rng.uniform(0.7, 1.4, (L, H)), to)
    same = rng.random(L) < 0.1
    cn[same], tn[same] = co[same], to[same]
    dh = rng.normal(0.0, 0.1, L)
    dother = _regime_dother(rng, L, regime)
    logu = np.log(rng.random(L))
    sums = np.concatenate([co.sum(0), to.sum(0)])
    if regime == "edge":
        def term(k, c):
            return math.lgamma(a + k) - (a + k) * math.log(b + c)
        K, C = sums[:H].tolist(), sums[H:].tolist()
        g = [term(k, c) for k, c in zip(K, C)]
        dK, dC = (cn - co).tolist(), (tn - to).tolist()
        rhs = (dother + dh).tolist()
        for i in np.flatnonzero(mask).tolist():
            dlg, upd = 0.0, []
            for h in range(H):
                if dK[i][h] != 0.0 or dC[i][h] != 0.0:
                    k, c = K[h] + dK[i][h], C[h] + dC[i][h]
                    x = term(k, c)
                    dlg += x - g[h]
                    upd.append((h, k, c, x))
            acc = rng.random() < 0.5
            gap = rng.uniform(1e-7, 1e-6)
            logu[i] = rhs[i] + dlg + (-gap if acc else gap)
            if acc:
                for h, k, c, x in upd:
                    K[h], C[h], g[h] = k, c, x
    cols = np.concatenate([co, cn, to, tn, np.stack([
        dother, dh, logu, mask.astype(np.float64)], 1)], 1)
    return torch.as_tensor(cols), torch.as_tensor(sums), mask


def _k4_case(rng, L, regime, a_bar=10.0, b_bar=10.0, a_i=5.0):
    """(terms [L, 6], proposing mask) of a random Gamma-Dirichlet mu_i
    chain: a tenth of the loci propose their current value, the last three
    are padded where L > 5; "edge" as in :func:`_k3_case`."""
    old = rng.gamma(10.0, 0.1, L)
    new = old * np.exp(rng.normal(0.0, 0.3, L))
    same = rng.random(L) < 0.1
    new[same] = old[same]
    dlog = np.log(new / old)
    ddens = _regime_dother(rng, L, regime)
    us = rng.random(L)
    mask = np.ones(L, bool)
    if L > 5:
        mask[-3:] = False
    if regime == "edge":
        nl = float(mask.sum())
        terma, termb = a_i * nl, b_bar / nl
        lratio = (a_i - 1.0) * np.log(new / old) + dlog + ddens
        sum_mu = float(old[mask].sum())
        for i in np.flatnonzero(mask):
            sum_new = sum_mu + new[i] - old[i]
            lnacc = ((a_bar - terma) * np.log(sum_new / sum_mu)
                     - termb * (sum_new - sum_mu) + lratio[i])
            acc = rng.random() < 0.5
            gap = rng.uniform(1e-7, 1e-6)
            us[i] = np.exp(lnacc - gap if acc else lnacc + gap)
            if acc:
                sum_mu = sum_new
    terms = np.stack([old, new, dlog, ddens, us, mask.astype(np.float64)], 1)
    return torch.as_tensor(terms), mask


def _k4_plain(terms, a_bar=10.0, b_bar=10.0, a_i=5.0):
    from bpp_tpu_torch.mcmc import clock_moves
    host = terms.T.numpy()
    mask = host[5] > 0.5
    nl = float(mask.sum())
    margin = np.full(terms.shape[0], np.inf)
    want = clock_moves._gammadir_chain(host[:5], mask, a_bar, a_i * nl,
                                       b_bar / nl, a_i, margin)
    return torch.as_tensor(want), margin


def _held_regime(want, mask, regime):
    """The plain version's decisions are what the regime asks for."""
    want = want.numpy()
    if regime == "all":
        assert want[mask].all() and not want[~mask].any()
    elif regime == "none":
        assert not want.any()
    elif mask.sum() > 100:
        assert 0 < want.sum() < mask.sum()


@pytest.mark.parametrize("regime", CHAIN_REGIMES)
@pytest.mark.parametrize("H", [1, 7, 40, 200])
def test_notheta_chain_kernel_matches_plain(H, regime):
    """K3 on random integrated-theta chains of 1 .. 10,000 loci (1, 7, 40
    and 200 populations; padded loci and proposing loci that change no
    population) against ``notheta.accept_chain``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bpp_tpu_torch.mcmc import notheta
    rng = np.random.default_rng(H)
    for L in CHAIN_LOCI:
        cols, sums, mask = _k3_case(rng, L, H, regime)
        got = notheta.chain_accept(3.0, 0.03, cols.cuda(), sums.cuda(), H)
        torch.cuda.synchronize()
        margin = np.full(L, np.inf)
        want = notheta.chain_accept(3.0, 0.03, cols, sums, H, margin)
        _held_regime(want, mask, regime)
        _masks_agree(got, want, margin)


@pytest.mark.parametrize("regime", CHAIN_REGIMES)
def test_gammadir_chain_kernel_matches_plain(regime):
    """K4 on random Gamma-Dirichlet mu_i chains of 1 .. 10,000 loci (padded
    loci, loci proposing their current value) against
    ``clock_moves._gammadir_chain`` through ``gammadir_accept``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import types

    from bpp_tpu_torch.mcmc import clock_moves
    rng = np.random.default_rng(7)
    for L in CHAIN_LOCI:
        terms, mask = _k4_case(rng, L, regime)
        args = [terms[:, k].contiguous() for k in range(5)]
        cctx = types.SimpleNamespace(locus_mask=torch.as_tensor(mask).cuda(),
                                     shard=None)
        got = clock_moves.gammadir_accept(cctx, *(x.cuda() for x in args),
                                          10.0, 10.0, 5.0)
        torch.cuda.synchronize()
        want, margin = _k4_plain(terms)
        _held_regime(want, mask, regime)
        _masks_agree(got, want, margin)


def _first_h_at(depth):
    """The fewest populations at which K3 resolves ``depth`` loci a round
    (its depth falls as H grows)."""
    from bpp_tpu_torch.core import chains
    lo, hi = 1, 5000
    while lo < hi:
        mid = (lo + hi) // 2
        if chains.chain_depth(mid) <= depth:
            hi = mid
        else:
            lo = mid + 1
    return lo


@pytest.mark.parametrize("depth", [1, 2, 3, 4, 5])
def test_notheta_chain_kernel_at_every_depth(depth):
    """K3 at each depth the population count leaves it (5 loci a round
    down to 1, at the fewest populations that lower it there: tiles of a
    few loci) against ``notheta.accept_chain``, on chains whose decisions
    sit at the edge of their thresholds and on random ones."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bpp_tpu_torch.core import chains
    from bpp_tpu_torch.mcmc import notheta
    H = _first_h_at(depth)
    assert chains.chain_depth(H) == depth
    assert depth == 5 or chains.chain_depth(H - 1) > depth
    rng = np.random.default_rng(depth)
    for regime in ("edge", "random"):
        cols, sums, _ = _k3_case(rng, 40, H, regime)
        got = chains.launch_notheta(cols.cuda(), sums.cuda(), H, 3.0, 0.03)
        torch.cuda.synchronize()
        margin = np.full(40, np.inf)
        want = notheta.chain_accept(3.0, 0.03, cols, sums, H, margin)
        _masks_agree(got, want, margin)


def test_notheta_chain_kernel_off_its_table():
    """K3 where the carry's counts leave the kernel's lgamma table (K0 +-
    128 counts): every proposing locus moves a coalescence from population
    0 to 1, so K_1 drifts by one a locus accepted; decisions at the edge
    of their thresholds (half accepted) and all accepted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import math

    from bpp_tpu_torch.mcmc import notheta
    rng = np.random.default_rng(64)
    H, L = 7, 1000
    for edge in (True, False):
        co = np.full((L, H), 2.0)
        cn = co.copy()
        cn[:, 0] -= 1
        cn[:, 1] += 1
        to = rng.gamma(2.0, 0.02, (L, H))
        tn = to * rng.uniform(0.7, 1.4, (L, H))
        logu = np.log(rng.random(L))
        sums = np.concatenate([co.sum(0), to.sum(0)])
        if edge:
            def term(k, c):
                return math.lgamma(3.0 + k) - (3.0 + k) * math.log(0.03 + c)
            K, C = sums[:H].tolist(), sums[H:].tolist()
            for i in range(L):
                new = [(k + d, c + e) for k, c, d, e in zip(
                    K, C, (cn[i] - co[i]).tolist(), (tn[i] - to[i]).tolist())]
                dlg = 0.0
                for h in range(H):
                    dlg += term(*new[h]) - term(K[h], C[h])
                acc = rng.random() < 0.5
                logu[i] = dlg + (-1.0 if acc else 1.0) * rng.uniform(1e-7, 1e-6)
                if acc:
                    K, C = [k for k, _ in new], [c for _, c in new]
        dother = np.zeros(L) if edge else np.full(L, 50.0)
        cols = torch.as_tensor(np.concatenate([co, cn, to, tn, np.stack([
            dother, np.zeros(L), logu, np.ones(L)], 1)], 1))
        sums = torch.as_tensor(sums)
        got = notheta.chain_accept(3.0, 0.03, cols.cuda(), sums.cuda(), H)
        torch.cuda.synchronize()
        margin = np.full(L, np.inf)
        want = notheta.chain_accept(3.0, 0.03, cols, sums, H, margin)
        assert int(want.sum()) > 200
        _masks_agree(got, want, margin)


def test_notheta_chain_kernel_refuses_past_the_shared_budget():
    """K3 takes every population count up to 465 (what a one-warp walk
    over 40 KB tiles took) and refuses one whose tile of loci does not fit
    the block's shared memory, launching nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bpp_tpu_torch.core import chains
    from bpp_tpu_torch.mcmc import notheta
    rng = np.random.default_rng(465)
    cols, sums, _ = _k3_case(rng, 33, 465, "random")
    assert chains.chain_depth(465) > 0
    got = notheta.chain_accept(3.0, 0.03, cols.cuda(), sums.cuda(), 465)
    torch.cuda.synchronize()
    margin = np.full(33, np.inf)
    want = notheta.chain_accept(3.0, 0.03, cols, sums, 465, margin)
    _masks_agree(got, want, margin)
    H = 5000
    assert chains.chain_depth(H) == 0
    before = chains.LAUNCHES_NOTHETA
    with pytest.raises(ValueError, match="shared memory"):
        notheta.chain_accept(3.0, 0.03, torch.zeros(
            (2, 4 * H + 4), dtype=torch.float64, device="cuda"), torch.zeros(
            2 * H, dtype=torch.float64, device="cuda"), H)
    assert chains.LAUNCHES_NOTHETA == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_simwalk_kernel_matches_plain(cuda_mig, dtype, monkeypatch):
    """K5 on the walks of sim-SPR moves of the MSC-M chain on the card
    against ``mig_moves.simspr_walk_ref`` on the same inputs and draws:
    ends, populations, event counts, sources and destinations equal and
    times within 1e-5 (float32) / 1e-12 (float64) relative on every locus
    whose decisions clear a relative margin of 1e-6."""
    from bpp_tpu_torch.core import chains
    from bpp_tpu_torch.mcmc import mig_moves
    eng, state = cuda_mig
    calls = []
    orig = mig_moves.simspr_walk

    def record(*args):
        calls.append(args)
        return orig(*args)

    monkeypatch.setattr(mig_moves, "simspr_walk", record)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    for _ in range(3):
        state, _ = mig_moves.spr_sim_move(eng.ctx, eng.cfg, eng.mig_routes,
                                          state, gen)
    monkeypatch.setattr(mig_moves, "simspr_walk", orig)
    assert len(calls) == 3
    before = chains.LAUNCHES_SIMWALK
    for args in calls:
        args = tuple(x.to(dtype) if torch.is_tensor(x)
                     and x.is_floating_point() else x for x in args)
        _walks_agree(args)
    assert chains.LAUNCHES_SIMWALK == before + len(calls)


def _walks_agree(args):
    """K5 (through ``mig_moves.simspr_walk``) and ``simspr_walk_ref`` on
    the card on the walk's ``args``: ends, populations, event counts,
    sources and destinations equal and times within 1e-5 (float32) /
    1e-12 (float64) relative on every locus whose decisions clear a
    relative margin of 1e-6, and at most one locus in 1000 (at least 1)
    under it."""
    from bpp_tpu_torch.mcmc import mig_moves
    dtype = args[0].dtype
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    got = mig_moves.simspr_walk(*args)
    L = args[0].shape[0]
    margin = torch.empty(L, dtype=dtype, device="cuda")
    want = mig_moves.simspr_walk_ref(*args, margin=margin)
    torch.cuda.synchronize()
    clear = (margin >= WALK_TIE) & args[17]
    t, p, done, fail, nt, ns, nd, nn = got
    tw, pw, dw, fw, ntw, nsw, ndw, nnw = want
    c = clear
    assert bool(c.any())
    for a, b in ((done, dw), (fail, fw), (p, pw), (nn, nnw), (ns, nsw),
                 (nd, ndw)):
        assert torch.equal(a[c], b[c])
    assert bool(((t - tw).abs() <= tol * tw.abs())[c].all())
    assert bool(((nt - ntw).abs() <= tol * ntw.abs())[c].all())
    assert int((~clear & args[17]).sum()) <= max(1, L // 1000)
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", WALK_SHAPES,
                         ids=[walk_id(s) for s in WALK_SHAPES])
def test_simwalk_kernel_on_synthetic_walks(shape, dtype):
    """K5 on synthetic walks (``testing.synthetic_walks``) where a warp's
    lanes split a locus's sub-edges differently: 1, 31, 32, 33, 63 and 97
    sub-edges (past the 64 a locus the kernel keeps in registers), 1, 33
    and 1000 loci, the most populations whose float64 tables fit the
    kernel's 48 KB of shared memory, and more routes (62) than a warp's
    lanes; each case of 33 loci or more holds
    invalid loci, loci with no live sub-edge and walks that fill every
    event slot and fail.  Held against ``simspr_walk_ref`` as the main
    paths' walks are (:func:`_walks_agree`), one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bpp_tpu_torch.core import chains
    E, L, H, every_pair = shape
    args, kinds = synthetic_walks(L, E, H, seed=walk_seed(shape),
                                  dtype=dtype, device="cuda",
                                  every_pair=every_pair)
    before = chains.LAUNCHES_SIMWALK
    t, p, done, fail, nt, ns, nd, nn = _walks_agree(args)
    assert chains.LAUNCHES_SIMWALK == before + 1
    trapped = torch.as_tensor(np.isin(kinds, (2, 3)), device="cuda")
    assert bool((fail & (nn == args[19]))[trapped].all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("C", [2, 4, 8])
@pytest.mark.parametrize("shape", WALK_SHAPES,
                         ids=[walk_id(s) for s in WALK_SHAPES])
def test_simwalk_kernel_over_a_chain_axis(shape, C, dtype):
    """One K5 launch over C chains (a grid row a chain) of the synthetic
    walks (``testing.synthetic_walk_chains``: one route table, each
    chain's species tables and loci its own) against C one-chain
    launches: all eight outputs bit-equal per (chain, locus); and each
    chain's walks held against ``simspr_walk_ref`` as the one-chain
    launches are (:func:`_walks_agree`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bpp_tpu_torch.core import chains
    from bpp_tpu_torch.mcmc import mig_moves
    E, L, H, every_pair = shape
    args, per, _ = synthetic_walk_chains(C, L, E, H, seed=walk_seed(shape),
                                         dtype=dtype, device="cuda",
                                         every_pair=every_pair)
    before = chains.LAUNCHES_SIMWALK
    got = mig_moves.simspr_walk_chains(*args)
    torch.cuda.synchronize()
    assert chains.LAUNCHES_SIMWALK == before + 1
    assert got[0].shape == (C, L) and got[4].shape == (C, L, args[19])
    for k in range(C):
        one = _walks_agree(per[k])
        for x, y in zip(got, one):
            assert torch.equal(x[k], y), k


@pytest.mark.parametrize("data", ["cuda_state", "cuda_diploid", "cuda_int",
                                  "cuda_snl", "cuda_mig", "cuda_gdir"])
def test_replayed_graph_equals_the_eager_chain(request, data):
    """20 iterations as replays of the captured step (``StepGraph``)
    against 20 eager steps from the same state and generator state: the
    states, move statistics, trace rows and generator states bit-equal
    (JC69 through K1, diploid HKY through K2; integrated thetas through
    K3, A01 with SNL, MSC-M through K5, clock = 3 with Gamma-Dirichlet
    rates through K4)."""
    from bpp_tpu_torch.mcmc.driver import clone_state
    from bpp_tpu_torch.mcmc.graph import flatten
    eng, state = request.getfixturevalue(data)
    assert eng.route == "graph", eng.route_reason
    start = clone_state(state)
    seed = eng.gen.get_state()
    out = {}
    try:
        for route in ("eager", "graph"):
            eng.route = route
            eng.gen.set_state(seed)
            st, acc, trace, _ = eng._chunk(clone_state(start), 20)
            torch.cuda.synchronize()
            out[route] = (flatten(clone_state(st))[1], acc.clone(),
                          {k: v.clone() for k, v in trace.items()},
                          eng.gen.get_state())
    finally:
        eng.route = "graph"
    (le, ae, te, ge), (lg, ag, tg, gg) = out["eager"], out["graph"]
    assert all(torch.equal(a, b) for a, b in zip(le, lg))
    assert torch.equal(ae, ag) and torch.equal(ge, gg)
    assert te.keys() == tg.keys()
    assert all(torch.equal(te[k], tg[k]) for k in te)


@pytest.mark.parametrize("data", ["cuda_state", "cuda_diploid", "cuda_int",
                                  "cuda_mig", "cuda_gdir"])
def test_launch_counters_add_up_under_replay(request, data):
    """A replay makes no Python call into the wrappers: the graph counts
    its captured launches once (neither the warm-up nor the capture is
    counted) and each replay adds them, 8 K1 passes an iteration on the
    haploid chain, 8 + freqs-free HKY's ... K2 passes on the diploid one,
    as many as the eager step launches."""
    from bpp_tpu_torch.core import chains, fels, pack
    from bpp_tpu_torch.mcmc.driver import clone_state
    from bpp_tpu_torch.mcmc.graph import StepGraph
    eng, state = request.getfixturevalue(data)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    counts = {}
    for route in ("eager", "graph"):
        pack.LAUNCHES = fels.LAUNCHES = 0
        chains.set_launch_counts((0, 0, 0))
        if route == "eager":
            own = eng.gen
            eng.gen, eng.route = gen, "eager"
            try:
                eng._chunk(clone_state(state), 5)
            finally:
                eng.gen, eng.route = own, "graph"
        else:
            graph = StepGraph(eng, [clone_state(state)], [gen])
            graph.capture()
            assert (pack.LAUNCHES, fels.LAUNCHES) == (0, 0)
            assert chains.launch_counts() == (0, 0, 0)
            graph.run(5)
            assert sum(graph.per_replay) > 0
        counts[route] = (pack.LAUNCHES, fels.LAUNCHES) + \
            chains.launch_counts()
    assert counts["graph"] == counts["eager"]
    assert sum(counts["graph"][:2]) % 5 == 0
    assert sum(counts["graph"][:2]) >= 40
    # K3 (integrated thetas), K5 (MSC-M), K4 (Gamma-Dirichlet) an iteration
    want = {"cuda_int": (25, 0, 0), "cuda_mig": (0, 0, 15),
            "cuda_gdir": (0, 10, 0)}.get(data, (0, 0, 0))
    assert counts["graph"][2:] == want


# --- chains = K: K1/K2 over a chain axis, the batched step ---------------


def _chain_inputs(eng, state, K, dtype, model_name="HKY"):
    """K distinct chains' kernel arguments: the fixture state stepped 2
    iterations a chain further, each chain's locus rates scaled and its
    frequencies rotated (so that a wrong chain stride shows; under GTR
    its exchangeabilities rotated too, and its own eigensystem computed
    from them); returns (per-chain argument tuples, the stacked tuple,
    model, n_cats)."""
    from bpp_tpu_torch.mcmc.driver import clone_state
    from bpp_tpu_torch.mcmc.state import refresh_eigen
    L = state.gt.n_loci
    model, subst = fixed_subst(model_name, 4, L, torch.float64, "cuda")
    chains, st = [], clone_state(state)
    for k in range(K):
        st, _ = eng.chunk_step(st, 2)
        sk = refresh_eigen(subst._replace(
            mu=subst.mu * (1.0 + 0.05 * k),
            freqs=torch.roll(subst.freqs, k, dims=1),
            qrates=torch.roll(subst.qrates, k, dims=1)), model)
        sk = type(sk)(*(x.to(dtype).contiguous() for x in sk))
        chains.append(_args(st, eng.ctx, sk, dtype))
    # the batch's tensors (n_seq, tips, weights) stay one copy
    shared = {4, 12, 13}
    stacked = tuple(a if i in shared else torch.stack([c[i] for c in chains])
                    for i, a in enumerate(chains[0]))
    return chains, stacked, model, 4


@pytest.mark.parametrize("model_name", ["HKY", "GTR"])
@pytest.mark.parametrize("store", STORES)
@pytest.mark.parametrize("K", [1, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("data", ["cuda_state", "cuda_diploid"])
def test_chain_axis_launch_equals_one_chain_launches(request, data, dtype, K,
                                                     store, model_name):
    """One launch over K chains (a grid row a chain) against K one-chain
    launches: bit-equal per (chain, locus) for K1 (haploid data) and per
    (chain, locus, pattern) for K2 (diploid data), float32 and float64,
    both CLV stores, under HKY and under GTR with each chain's own
    eigensystem; and within the plain versions' gates (K1 0.02 lnL a
    locus in float32, 1e-6 in float64; K2 2e-3 / 1e-8 a pattern)."""
    from bpp_tpu_torch.core import fels, pack
    eng, state = request.getfixturevalue(data)
    chains, stacked, model, C = _chain_inputs(eng, state, K, dtype,
                                              model_name)
    ctx = eng.ctx
    k2 = ctx.res_map is not None
    kw = dict(model=model, n_cats=C, units=ctx.units, clv_store=store)
    if k2:
        def call(a):
            return fels.site_logl_fels(*a[:-1], n_pat=ctx.n_pat, **kw)
        counter = "fels"
    else:
        def call(a):
            return pack.site_logl_packed(*a, **kw)
        counter = "pack"
    mod = fels if k2 else pack
    before = mod.LAUNCHES
    got = call(stacked)
    torch.cuda.synchronize()
    assert mod.LAUNCHES == before + 1, counter
    assert got.shape[:2] == (K, state.gt.n_loci)
    mask = ctx.locus_mask
    for k, a in enumerate(chains):
        one = call(a)
        assert torch.equal(got[k], one), (k, store)
        a64 = tuple(t.double() if t.is_floating_point() else t for t in a)
        if k2:
            want = fels.site_logl_fels_ref(*a64[:-1], model=model, n_cats=C,
                                           n_pat=ctx.n_pat)
            tol = 2e-3 if dtype == torch.float32 else 1e-8
        else:
            want = pack.site_logl_packed_ref(*a64, model=model, n_cats=C)
            tol = 0.02 if dtype == torch.float32 else 1e-6
        err = float((got[k].double() - want)[mask].abs().max())
        assert err < tol, (k, err)


@pytest.mark.parametrize("regime", CHAIN_REGIMES)
@pytest.mark.parametrize("K", [2, 4, 8])
def test_accept_chains_over_a_chain_axis(K, regime):
    """One launch of K3 (7 populations) and one of K4 over K chains of
    1000 loci (a block a chain; each chain its own random case of the
    regime) against K one-chain launches: bit-equal per (chain, locus);
    and each chain's decisions against the plain versions, equal but at
    near ties (the regimes and gates of the one-chain tests above)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bpp_tpu_torch.core import chains
    from bpp_tpu_torch.mcmc import notheta
    rng = np.random.default_rng(100 * K + CHAIN_REGIMES.index(regime))
    L, H = 1000, 7
    k3 = [_k3_case(rng, L, H, regime) for _ in range(K)]
    k4 = [_k4_case(rng, L, regime) for _ in range(K)]
    cols = torch.stack([c for c, _, _ in k3]).cuda()
    sums = torch.stack([s for _, s, _ in k3]).cuda()
    terms = torch.stack([t for t, _ in k4]).cuda()
    before = chains.launch_counts()
    got3 = chains.launch_notheta(cols, sums, H, 3.0, 0.03)
    got4 = chains.launch_gammadir(terms, 10.0, 10.0, 5.0)
    torch.cuda.synchronize()
    after = chains.launch_counts()
    assert (after[0] - before[0], after[1] - before[1]) == (1, 1)
    assert got3.shape == got4.shape == (K, L)
    for k in range(K):
        one3 = chains.launch_notheta(cols[k], sums[k], H, 3.0, 0.03)
        one4 = chains.launch_gammadir(terms[k], 10.0, 10.0, 5.0)
        torch.cuda.synchronize()
        assert torch.equal(got3[k], one3), k
        assert torch.equal(got4[k], one4), k
        c, s, mask = k3[k]
        margin = np.full(L, np.inf)
        want = notheta.chain_accept(3.0, 0.03, c, s, H, margin)
        _held_regime(want, mask, regime)
        _masks_agree(got3[k], want, margin)
        want, margin = _k4_plain(k4[k][0])
        _held_regime(want, k4[k][1], regime)
        _masks_agree(got4[k], want, margin)


@pytest.mark.parametrize("data", ["cuda_state", "cuda_diploid", "cuda_mig",
                                  "cuda_msci", "cuda_gtr",
                                  "cuda_gtr_diploid"])
def test_batched_graph_equals_the_eager_batched_step(request, data):
    """chains = 3 on the batched route: 10 replays of the captured batched
    step (one graph, the 3 generators registered) against 10 eager
    batched steps (``Engine._chunk_multi``) from the same states and
    generator states: states, statistics, trace rows and generators
    bit-equal; the replay adds one K1/K2 launch a pass for all 3 chains
    (under MSC-M one K5 launch a sim-SPR round; on an MSC-I network one
    tau pass an inner node; under GTR+G4 freqs 1, qrates 5 and alpha 1
    more)."""
    from bpp_tpu_torch.core import fels, pack
    from bpp_tpu_torch.mcmc.driver import clone_state, stack_states
    from bpp_tpu_torch.mcmc.graph import StepGraph, flatten
    eng, state = request.getfixturevalue(data)
    assert eng.chains_route == "batched", eng.chains_route_reason
    K = 3
    states = []
    st = clone_state(state)
    for _ in range(K):
        st, _ = eng.chunk_step(st, 1)
        states.append(clone_state(st))
    start = stack_states(states)
    seeds = []
    for k in range(K):
        g = torch.Generator(device="cuda")
        g.manual_seed(40 + k)
        seeds.append(g.get_state())

    def gens():
        out = []
        for s in seeds:
            g = torch.Generator(device="cuda")
            g.set_state(s)
            out.append(g)
        return out

    g_eager, g_graph = gens(), gens()
    st_e, acc_e, tr_e = eng._chunk_multi(clone_state(start), g_eager, 10)
    graph = StepGraph(eng, [clone_state(start)], g_graph, batched=True)
    graph.capture()
    passes = graph.per_replay[0] + graph.per_replay[2]
    acc_g, tr_g = graph.run(10)
    torch.cuda.synchronize()
    # age 2 + SPR 3 + tau 2 + mixing 1 passes (JC69; MSC-M's sim-SPR
    # rounds for SPR's; a network's tau move a pass an inner node), one
    # launch each for all 3 chains
    sp = eng.run.stree
    gtr = eng.cfg.model.name == "GTR"
    assert passes == 8 + (sp.n_nodes - sp.n_tips - sp.n_hybrids - 2
                          if sp.n_hybrids else 0) + (1 + 5 + 1 if gtr else 0)
    assert graph.per_replay[6] == (3 if eng.cfg.migration else 0)
    assert all(torch.equal(a, b) for a, b in
               zip(flatten(st_e)[1], flatten(graph.state())[1]))
    assert torch.equal(acc_e, acc_g)
    for te, tg in zip(tr_e, tr_g):
        assert te.keys() == tg.keys()
        assert all(torch.equal(te[k], tg[k]) for k in te)
    for a, b in zip(g_eager, g_graph):
        assert torch.equal(a.get_state(), b.get_state())


@pytest.mark.parametrize("data", ["cuda_state", "cuda_diploid", "cuda_mig",
                                  "cuda_msci", "cuda_gtr",
                                  "cuda_gtr_diploid"])
def test_batched_step_against_one_chain_steps_on_the_card(request, data):
    """One batched iteration of 3 chains against each chain's one-chain
    eager step from the same generator state: equal move statistics and
    every state leaf within 1e-5 relative (float32; the vmapped glue may
    round differently from the one-chain ops)."""
    from bpp_tpu_torch.mcmc.driver import (
        chain_views, clone_state, stack_states,
    )
    from bpp_tpu_torch.mcmc.graph import flatten
    eng, state = request.getfixturevalue(data)
    K = 3
    states, st = [], clone_state(state)
    for _ in range(K):
        st, _ = eng.chunk_step(st, 1)
        states.append(clone_state(st))
    gens, ones = [], []
    for k in range(K):
        for lst in (gens, ones):
            g = torch.Generator(device="cuda")
            g.manual_seed(70 + k)
            lst.append(g)
    stacked, stats = eng._step_batched(stack_states(states), gens)
    own = eng.gen
    try:
        for k in range(K):
            eng.gen = ones[k]
            one, s1 = eng._step(states[k])
            assert torch.equal(stats[k], s1), k
            for a, b in zip(flatten(chain_views(stacked, K)[k])[1],
                            flatten(one)[1]):
                if a.is_floating_point():
                    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
                else:
                    assert torch.equal(a, b), k
    finally:
        eng.gen = own
