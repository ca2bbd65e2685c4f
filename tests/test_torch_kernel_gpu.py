"""Kernels K1 (``bpp_tpu_torch/csrc/pack_kernel.cu``) and K2
(``csrc/fels_kernel.cu``) on the card against their plain PyTorch
versions, over the model grid of test_kernel_consistency.py: max
per-locus |dlnL| < 0.02, the float32 bound used there; K2 on haploid and
on unphased diploid tips, per pattern (max |dlnL| < 2e-3) and per locus
after ``reduce_root``.  Needs a CUDA device and nvcc; skips without them.

    python -m pytest tests/test_torch_kernel_gpu.py -q
"""

import numpy as np
import pytest
import torch

from bpp_tpu_torch.testing import fixed_subst

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


@pytest.mark.parametrize("model_name,n_cats", MODELS)
def test_kernel_matches_plain_version(cuda_state, model_name, n_cats):
    from bpp_tpu_torch.core import pack
    eng, state = cuda_state
    L = state.gt.n_loci
    model, s32 = fixed_subst(model_name, n_cats, L, torch.float32, "cuda")
    _, s64 = fixed_subst(model_name, n_cats, L, torch.float64, "cuda")
    before = pack.LAUNCHES
    got = pack.site_logl_packed(*_args(state, eng.ctx, s32, torch.float32),
                                model=model, n_cats=n_cats)
    torch.cuda.synchronize()
    assert pack.LAUNCHES == before + 1
    want = pack.site_logl_packed_ref(
        *_args(state, eng.ctx, s64, torch.float64), model=model,
        n_cats=n_cats)
    mask = eng.ctx.locus_mask
    got = got.double()
    assert bool(torch.isfinite(got[mask]).all())
    err = float((got - want)[mask].abs().max())
    assert err < 0.02, err


@pytest.mark.parametrize("data", ["cuda_state", "cuda_diploid"])
@pytest.mark.parametrize("model_name,n_cats", MODELS)
def test_fels_kernel_matches_plain_version(request, data, model_name,
                                           n_cats):
    from bpp_tpu_torch.core import fels
    from bpp_tpu_torch.core import felsenstein as fe
    eng, state = request.getfixturevalue(data)
    ctx = eng.ctx
    L = state.gt.n_loci
    model, s32 = fixed_subst(model_name, n_cats, L, torch.float32, "cuda")
    _, s64 = fixed_subst(model_name, n_cats, L, torch.float64, "cuda")
    kw = dict(model=model, n_cats=n_cats, n_pat=ctx.n_pat)
    before = fels.LAUNCHES
    got = fels.site_logl_fels(*_args(state, ctx, s32, torch.float32)[:-1],
                              **kw)
    torch.cuda.synchronize()
    assert fels.LAUNCHES == before + 1
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
    from bpp_tpu_torch.core import pack
    eng, state = cuda_state
    L = state.gt.n_loci
    model, s64 = fixed_subst("JC69", 1, L, torch.float64, "cuda")
    with pytest.raises(TypeError):
        pack.site_logl_packed(*_args(state, eng.ctx, s64, torch.float64),
                              model=model, n_cats=1)
    from bpp_tpu_torch.core import fels
    with pytest.raises(TypeError):
        fels.site_logl_fels(*_args(state, eng.ctx, s64, torch.float64)[:-1],
                            model=model, n_cats=1)


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
    # the per-locus kernel is the weighted sum of the per-pattern one
    W = eng.ctx.weights.shape[1]
    np.testing.assert_allclose(
        (eng.ctx.weights * site[:, :W]).sum(1).cpu().numpy(),
        out.cpu().numpy(), rtol=1e-4, atol=1e-3)
