"""What the redesigned pruning kernels do around their arithmetic, stated
in numpy/PyTorch and tested on the CPU.

* ``core.units.slot_plan`` (the CLV slot plan of ``csrc/contract.cuh``):
  a property test over random, caterpillar and balanced trees with 1..T
  sequences in a capacity of T tips: never more than floor(T/2) slots, no
  slot read after it is freed, none written while alive (but over the
  child it was just read from), only the root left alive; the plan as the
  kernel finds it, by pointer jumping, gives the same slots, whatever the
  schedule's padding levels hold.
* A numpy walk of the kernel's whole algorithm (branch lengths from the
  level's node and its children, ``expm1`` factors by level and child,
  P(t)·x as x + terms in the factors, CLVs through the slot plan, rescale
  at every level) against ``fels.site_logl_fels_ref`` in float64, rtol
  1e-10, on 12 loci with 1..7 sequences, over JC69, HKY+G4, TN93, GTR+G4,
  with and without ``blen``.
* The schedule's children have the level's node as their parent on engine
  states after moves (the kernels take the branch above a child from the
  level's node).
* ``core.units.unit_table`` / ``block_table``: every real (locus, pattern)
  exactly once, nothing past ``n_pat``, a locus's units contiguous, one
  zero-filling unit for empty and masked loci, blocks of whole loci.
* ``core.efactors.efactors`` against ``bpp_tpu.core.pallas_fels.efactors``
  in float64 on the model grid: GTR equal to an ulp, JC69 / TN93 family
  ``port + 1 == bpp_tpu`` to rtol 1e-12, ``coefs`` equal.
* The launch plan: the shared CLV store where a warp's slots fit a
  block's shared memory, the global one above it, a refusal beyond.
* The float64 build's store plan (:func:`warp_layout`, the layout of
  ``csrc/contract.cuh``) as hypothesis properties: float32's layout
  unchanged, float64's regions in order, disjoint and aligned to their
  element, its CLV slots twice float32's, and the launch plan choosing
  the shared store exactly where a float64 warp fits and C is at most
  ``pack.F64_SHARED_MAX_CATS``.
* A numpy walk of the float64 build's ``DoubleWalk`` (a rescale by a
  power of two only below 2^-512, an integer exponent, the next level's
  child kept in registers) against ``fels.site_logl_fels_ref`` in
  float64, rtol 1e-12, on the 12 loci x 4 families with and without
  ``blen``, and on 128-tip trees with branches of 2e-8 that force the
  rescale (against the plain pruning on the kernels' expm1 P(t)).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from bpp_tpu.config import SubstModel as SMJ
from bpp_tpu.core import pallas_fels as pfj
from bpp_tpu_torch.core import fels, pack
from bpp_tpu_torch.core.efactors import _KFAC, efactors, model_family
from bpp_tpu_torch.core.units import (
    WARP, Units, block_table, slot_plan, unit_table,
)
from bpp_tpu_torch.testing import fixed_subst

torch.set_num_threads(1)     # tiny tensors; the suite runs in parallel

MODELS = [("JC69", 1), ("HKY", 4), ("TN93", 1), ("GTR", 4)]


def make_tree(kind: str, n_seq: int, n_tips: int, rng):
    """(order [T-1], left [N], right [N]) of one locus: ``n_seq`` real tips
    in a capacity of ``n_tips``; inner node ids are shuffled, so that the
    schedule, not the ids, carries the order."""
    T, N = n_tips, 2 * n_tips - 1
    ids = T + rng.permutation(T - 1)
    left = np.zeros(N, np.int64)
    right = np.zeros(N, np.int64)
    roots = list(range(n_seq))
    order = []
    for k in range(n_seq - 1):
        if kind == "caterpillar":
            i, j = (0, 1) if k == 0 else (len(roots) - 1, 0)
        elif kind == "balanced":
            i, j = 0, 1
        else:
            i, j = rng.choice(len(roots), 2, replace=False)
        a, b = roots[i], roots[j]
        node = int(ids[k])
        left[node], right[node] = (a, b) if rng.random() < 0.5 else (b, a)
        roots = [r for r in roots if r not in (a, b)] + [node]
        order.append(node)
    order += [int(x) for x in ids[n_seq - 1:]]      # unused levels
    return np.asarray(order, np.int64), left, right


def jumping_plan(order, left, right, n_seq, n_tips):
    """``slot_plan`` as csrc/contract.cuh finds it, all levels at once:
    every inner node of a real level points down its chain, the chains'
    bottoms are numbered in schedule order, and ceil(log2(levels)) rounds
    of pointer jumping take every node to its bottom.  Levels past
    ``n_seq - 1`` are padding: read and clamped; where one names a real
    node it points that node down its chain as the node's own level does,
    and it is never a bottom."""
    T, N = n_tips, 2 * n_tips - 1
    nlev = max(int(n_seq) - 1, 0)
    node = np.clip(order, T, N - 1)
    lc = np.clip(left[node], 0, N - 1)
    rc = np.clip(right[node], 0, N - 1)
    down = np.zeros(T - 1, np.int64)
    down[node - T] = np.where(lc >= T, lc, np.where(rc >= T, rc, node)) - T
    bottom = (np.arange(T - 1) < nlev) & (lc < T) & (rc < T)
    chain = np.zeros(T - 1, np.int64)
    chain[node[bottom] - T] = np.arange(bottom.sum())
    span = 1
    while span < nlev:
        down = down[down]
        span *= 2
    slot = chain[down]                          # by inner node
    lc, rc, node = lc[:nlev], rc[:nlev], node[:nlev]
    return (np.where(lc >= T, -1 - slot[np.maximum(lc - T, 0)], lc),
            np.where(rc >= T, -1 - slot[np.maximum(rc - T, 0)], rc),
            slot[node - T], int(bottom.sum()))


@settings(deadline=None, max_examples=150)
@given(kind=st.sampled_from(["random", "caterpillar", "balanced"]),
       n_tips=st.integers(2, 24), frac=st.floats(0.0, 1.0),
       seed=st.integers(0, 2**31 - 1), junk=st.booleans())
def test_slot_plan_invariants(kind, n_tips, frac, seed, junk):
    rng = np.random.default_rng(seed)
    n_seq = 1 + int(round(frac * (n_tips - 1)))
    order, left, right = make_tree(kind, n_seq, n_tips, rng)
    if junk:
        # padding levels may name any node, a real one too
        order[n_seq - 1:] = rng.integers(0, 2 * n_tips - 1,
                                         n_tips - n_seq)
    src_l, src_r, dst, n_slots = slot_plan(order, left, right, n_seq, n_tips)
    # the kernel's pointer jumping finds the same slots
    for mine, kernels in zip((src_l, src_r, dst, n_slots),
                             jumping_plan(order, left, right, n_seq, n_tips)):
        np.testing.assert_array_equal(mine, kernels)
    assert len(dst) == max(n_seq - 1, 0)
    assert n_slots <= n_tips // 2
    alive = {}                                  # slot -> node it holds
    for k in range(len(dst)):
        node = order[k]
        for src, child in ((src_l[k], left[node]), (src_r[k], right[node])):
            if src >= 0:
                assert src == child < n_seq     # a real tip
            else:
                # read before it is freed, and it holds this child
                assert alive.pop(-1 - src) == child
        assert 0 <= dst[k] < max(n_slots, 1)
        assert dst[k] not in alive              # not written while alive
        alive[dst[k]] = node
    if n_seq >= 2:
        assert list(alive.values()) == [order[n_seq - 2]]


def _apply(fam, x, e, freqs, T_, Ti):
    """P(t)·x of csrc/contract.cuh from factors e = expm1(.): x [S, 4]."""
    if fam == "jc69":
        return x + e[0] * (x - x.mean(-1, keepdims=True))
    if fam == "gtr":
        return x + (e * (x @ Ti.T)) @ T_.T
    pa, pc, pg, pt = freqs
    R, Y = pa + pg, pc + pt
    WR = pa * x[:, 0] + pg * x[:, 2]
    WY = pc * x[:, 1] + pt * x[:, 3]
    uR = e[0] * ((1 - R) / R * WR - WY)
    uY = e[0] * ((1 - Y) / Y * WY - WR)
    dRG = e[1] * (x[:, 0] - x[:, 2])
    dCT = e[2] * (x[:, 1] - x[:, 3])
    return x + np.stack([uR + pg / R * dRG, uY + pt / Y * dCT,
                         uR - pa / R * dRG, uY - pc / Y * dCT], axis=-1)


def kernel_walk(order, left, right, n_seq, age, mu, rates_kappa, freqs,
                eigw, eigT, eigTi, tips, *, model, n_cats, blen=None):
    """The kernels' algorithm, locus by locus in numpy: ``[L, S]``."""
    fam = model_family(model)
    K, C = _KFAC[fam], n_cats
    L, T, S, _ = tips.shape
    out = np.zeros((L, S))
    for l in range(L):
        ns = int(n_seq[l])
        nlev = max(ns - 1, 0)
        src_l, src_r, dst, _ = slot_plan(order[l], left[l], right[l], ns, T)
        # prologue: both children's branches of every level, then factors
        bl = np.zeros((nlev, 2))
        for k in range(nlev):
            node = order[l, k]
            for j, child in enumerate((left[l, node], right[l, node])):
                bl[k, j] = blen[l, child] if blen is not None else \
                    max(age[l, node] - age[l, child], 0.0) * mu[l]
        t_eff = torch.as_tensor(
            bl.reshape(1, 2 * nlev, 1) * rates_kappa[l, None, None, :C])
        fac, _ = efactors(model, t_eff, torch.as_tensor(freqs[l:l + 1]),
                          torch.as_tensor(rates_kappa[l:l + 1, C]),
                          torch.as_tensor(rates_kappa[l:l + 1, C + 1]),
                          torch.as_tensor(eigw[l:l + 1]))
        fac = fac.numpy().reshape(nlev, 2, C, K)
        slots = {}
        y = np.repeat(tips[l, 0][None], C, axis=0)         # [C, S, 4]
        logscale = np.zeros(S)
        for k in range(nlev):
            xs = []
            for src in (src_l[k], src_r[k]):
                xs.append(np.repeat(tips[l, src][None], C, axis=0)
                          if src >= 0 else slots[-1 - src])
            y = np.stack([
                _apply(fam, xs[0][c], fac[k, 0, c], freqs[l], eigT[l],
                       eigTi[l])
                * _apply(fam, xs[1][c], fac[k, 1, c], freqs[l], eigT[l],
                         eigTi[l]) for c in range(C)])
            m = np.maximum(y.max(axis=(0, 2)), 1e-30)
            y = y / m[None, :, None]
            slots[dst[k]] = y
            logscale += np.log(m)
        lik = (y * freqs[l]).sum(-1).mean(0)
        out[l] = np.log(np.maximum(lik, 1e-30)) + logscale
    return out


@pytest.fixture(scope="module")
def mixed():
    """12 synthetic loci with 1..7 sequences in a capacity of 7 tips, after
    a few float64 iterations of the engine."""
    from bpp_tpu_torch.mcmc.driver import Engine
    from bpp_tpu_torch.testing import synthetic_run
    run = synthetic_run(n_loci=12, n_seq=[6, 3, 7, 5, 2, 4, 1, 7, 7, 2, 6, 3],
                        n_patterns=[12, 40, 7, 50, 16, 9, 5, 33, 8, 1, 20, 11],
                        seed=4, dtype="float64")
    eng = Engine(run, seed=3, device="cpu")
    state = eng.init_state()
    state, _ = eng.chunk_step(state, 4)
    return eng, state


def _tree_args(state, ctx, subst):
    from bpp_tpu_torch.trees.gtree import inner_order
    gt = state.gt
    rk = torch.cat([subst.rates, subst.kappa1[:, None],
                    subst.kappa2[:, None]], dim=1)
    return (inner_order(gt), gt.left, gt.right, gt.parent, ctx.n_seq,
            gt.age, subst.mu, rk, subst.freqs, subst.eigw, subst.eigT,
            subst.eigTi, ctx.tip_partials)


@pytest.mark.parametrize("with_blen", [False, True])
@pytest.mark.parametrize("model_name,n_cats", MODELS)
def test_walk_through_the_slots_matches_plain_version(mixed, model_name,
                                                      n_cats, with_blen):
    from bpp_tpu_torch.core import felsenstein as fe
    from bpp_tpu_torch.trees.gtree import GTrees
    eng, state = mixed
    L = state.gt.n_loci
    model, subst = fixed_subst(model_name, n_cats, L, torch.float64)
    subst = subst._replace(mu=torch.as_tensor(
        np.random.default_rng(5).uniform(0.5, 2.0, L)))
    args = _tree_args(state, eng.ctx, subst)
    blen = None
    if with_blen:
        # a relaxed clock's lengths: the strict ones, rescaled per branch
        gt = state.gt
        blen = fe.branch_lengths(GTrees(*gt[:4]), subst.mu) * torch.as_tensor(
            np.random.default_rng(6).uniform(0.5, 2.0, gt.age.shape))
    want = fels.site_logl_fels_ref(*args, model=model, n_cats=n_cats,
                                   blen=blen).numpy()
    a = [x.numpy() for x in args]
    got = kernel_walk(a[0], a[1], a[2], *a[4:], model=model, n_cats=n_cats,
                      blen=None if blen is None else blen.numpy())
    # the plain version roots a one-sequence locus at an unused slot, the
    # kernels at tip 0
    many = a[4] >= 2
    assert many.sum() == 11
    # atol: padding columns are all-ambiguous, lnL = 0 up to roundoff
    np.testing.assert_allclose(got[many], want[many], rtol=1e-10, atol=1e-13)
    tip0 = a[12][~many][:, 0]                              # [1, S, 4]
    np.testing.assert_allclose(
        got[~many], np.log((tip0 * a[8][~many][:, None]).sum(-1)),
        rtol=1e-12, atol=1e-13)


# csrc/contract.cuh DoubleWalk: a level is rescaled, by 2^-e, only when
# the high word of its largest value is below 2^-512's
LOW_HI = (1023 - 512) << 20
DBL_MIN = np.finfo(np.float64).tiny


def double_walk(order, left, right, n_seq, age, mu, rates_kappa, freqs,
                eigw, eigT, eigTi, tips, *, model, n_cats, blen=None):
    """The float64 build's algorithm up to 3 categories (``DoubleWalk``;
    above, the float64 build walks as :func:`kernel_walk` states), locus
    by locus in numpy: ``([L, S] values, rescales)``.

    UnitWalk's prologue (branch lengths, factors, slot plan); a pattern is
    rescaled by 2^-e only when the largest high word of its level's values
    over all categories and states is below 2^-512's (e the largest
    value's binary exponent), the integer sum of the e is kept, and e *
    log(2) is added at the root; a level whose output the next level reads
    keeps it in registers unstored, and no other read ever needs it."""
    fam = model_family(model)
    K, C = _KFAC[fam], n_cats
    L, T, S, _ = tips.shape
    N = 2 * T - 1
    out = np.zeros((L, S))
    rescales = 0
    for l in range(L):
        ns = int(n_seq[l])
        nlev = max(ns - 1, 0)
        # the prologue: both children's branches of every level, each
        # index clamped as the kernels clamp it
        length = blen[l] if blen is not None else age[l]
        node = np.clip(order[l], T, N - 1)[:nlev]
        lc = np.clip(left[l, node], 0, N - 1)
        rc = np.clip(right[l, node], 0, N - 1)
        if blen is not None:
            bl = np.stack([length[lc], length[rc]], axis=1)
        else:
            bl = np.stack([np.maximum(length[node] - length[lc], 0.0),
                           np.maximum(length[node] - length[rc], 0.0)],
                          axis=1) * mu[l]
        src_l, src_r, dst, _ = slot_plan(order[l], left[l], right[l], ns, T)
        t_eff = torch.as_tensor(
            bl.reshape(1, 2 * nlev, 1) * rates_kappa[l, None, None, :C])
        fac, _ = efactors(model, t_eff, torch.as_tensor(freqs[l:l + 1]),
                          torch.as_tensor(rates_kappa[l:l + 1, C]),
                          torch.as_tensor(rates_kappa[l:l + 1, C + 1]),
                          torch.as_tensor(eigw[l:l + 1]))
        fac = fac.numpy().reshape(nlev, 2, C, K)
        stored = {}                                     # slot -> CLVs
        y = np.repeat(tips[l, 0][None], C, axis=0)      # [C, S, 4]
        expo = np.zeros(S, np.int64)
        held = None
        for k in range(nlev):
            xs = []
            for src in (src_l[k], src_r[k]):
                if src >= 0:
                    xs.append(np.repeat(tips[l, src][None], C, axis=0))
                elif -1 - src == held:
                    xs.append(y)                        # from registers
                else:
                    xs.append(stored.pop(-1 - src))     # read once
            y = np.stack([
                _apply(fam, xs[0][c], fac[k, 0, c], freqs[l], eigT[l],
                       eigTi[l])
                * _apply(fam, xs[1][c], fac[k, 1, c], freqs[l], eigT[l],
                         eigTi[l]) for c in range(C)])
            last = k + 1 == nlev
            hold = not last and dst[k] in (-1 - src_l[k + 1],
                                           -1 - src_r[k + 1])
            if not last:
                hi = (y.view(np.int64) >> 32).max(axis=(0, 2))
                low = (hi < LOW_HI) & (hi > 0)
                e = np.where(low, (hi >> 20) - 1023, 0)
                rescales += int(low.sum())
                y = np.ldexp(y, -e[None, :, None])
                expo += e
                if not hold:
                    stored[dst[k]] = y
            held = dst[k] if hold else None
        lik = sum((1.0 / C) * (y[c] * freqs[l]).sum(-1) for c in range(C))
        out[l] = np.log(np.maximum(lik, DBL_MIN)) + expo * np.log(2.0)
        assert not stored            # every CLV but the root's was read
    return out, rescales


@pytest.mark.parametrize("with_blen", [False, True])
@pytest.mark.parametrize("model_name,n_cats", MODELS)
def test_double_walk_matches_plain_version(mixed, model_name, n_cats,
                                           with_blen):
    from bpp_tpu_torch.core import felsenstein as fe
    from bpp_tpu_torch.trees.gtree import GTrees
    eng, state = mixed
    L = state.gt.n_loci
    model, subst = fixed_subst(model_name, n_cats, L, torch.float64)
    subst = subst._replace(mu=torch.as_tensor(
        np.random.default_rng(5).uniform(0.5, 2.0, L)))
    args = _tree_args(state, eng.ctx, subst)
    blen = None
    if with_blen:
        gt = state.gt
        blen = fe.branch_lengths(GTrees(*gt[:4]), subst.mu) * torch.as_tensor(
            np.random.default_rng(6).uniform(0.5, 2.0, gt.age.shape))
    want = fels.site_logl_fels_ref(*args, model=model, n_cats=n_cats,
                                   blen=blen).numpy()
    a = [x.numpy() for x in args]
    got, _ = double_walk(a[0], a[1], a[2], *a[4:], model=model,
                         n_cats=n_cats,
                         blen=None if blen is None else blen.numpy())
    many = a[4] >= 2
    assert many.sum() == 11
    np.testing.assert_allclose(got[many], want[many], rtol=1e-12, atol=1e-13)
    tip0 = a[12][~many][:, 0]
    np.testing.assert_allclose(
        got[~many], np.log((tip0 * a[8][~many][:, None]).sum(-1)),
        rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("model_name,n_cats", [("JC69", 1), ("HKY", 4)])
def test_double_walk_rescales_deep_caterpillars(model_name, n_cats):
    """Caterpillars and balanced trees of up to 128 tips with branches of
    about 2e-8: many patterns' likelihoods lie below double's range, so
    the walk must rescale, and it still agrees with the plain pruning.

    ``site_logl_fels_ref`` forms P(t) with 1 - exp(-t), which keeps about
    eps / t of an off-diagonal entry on such a branch (1e-8 lnL a pattern
    here); so the reference is the plain pruning
    (``felsenstein.site_loglikelihood``, a rescale at every level) on the
    P(t) the kernels apply, from the same expm1 factors."""
    from bpp_tpu_torch.core import felsenstein as fe
    from bpp_tpu_torch.testing import shaped_batch
    from bpp_tpu_torch.trees.gtree import inner_order
    gt, n_seq, n_pat, tips, _ = shaped_batch(128, 12, seed=7,
                                             dtype=torch.float64)
    keep = slice(2 * 128 - 6, 2 * 128)       # the 6 loci of most tips
    gt = type(gt)(*(x[keep].contiguous() for x in gt[:4]))
    gt = gt._replace(age=gt.age * 1e-5)
    n_seq, n_pat, tips = n_seq[keep], n_pat[keep], tips[keep].contiguous()
    L, T = gt.n_loci, tips.shape[1]
    model, s = fixed_subst(model_name, n_cats, L, torch.float64)
    rk = torch.cat([s.rates, s.kappa1[:, None], s.kappa2[:, None]], dim=1)
    args = (inner_order(gt), gt.left, gt.right, gt.parent, n_seq, gt.age,
            s.mu, rk, s.freqs, s.eigw, s.eigT, s.eigTi, tips)
    a = [x.numpy() for x in args]
    got, rescales = double_walk(a[0], a[1], a[2], *a[4:], model=model,
                                n_cats=n_cats)
    t_eff = pack.scaled_lengths(*args[:4], gt.age, s.mu, rk, n_cats, None)
    fac, _ = efactors(model, t_eff, s.freqs, rk[:, n_cats],
                      rk[:, n_cats + 1], s.eigw)
    fam = model_family(model)
    eye = np.eye(4)
    pmats = np.zeros(fac.shape[:3] + (4, 4))
    for l in range(L):
        for i in range(2 * T - 1):
            for c in range(n_cats):
                pmats[l, i, c] = _apply(fam, eye, fac[l, i, c].numpy(),
                                        a[8][l], a[10][l], a[11][l]).T
    cw = torch.full((n_cats,), 1.0 / n_cats, dtype=torch.float64)
    want = fe.site_loglikelihood(gt, tips, n_seq, torch.as_tensor(pmats),
                                 s.freqs, cw, order=args[0]).numpy()
    live = np.arange(tips.shape[2]) < n_pat.numpy()[:, None]
    assert live.sum() > 30 and rescales > 0
    assert want[live].min() < np.log(DBL_MIN)      # below double's range
    np.testing.assert_allclose(got[live], want[live], rtol=1e-12)


def test_scheduled_children_have_the_levels_node_as_parent(mixed):
    from bpp_tpu_torch.trees.gtree import inner_order
    eng, state = mixed
    for _ in range(3):
        state, _ = eng.chunk_step(state, 2)
        gt = state.gt
        order = inner_order(gt).numpy()
        left, right, parent = (x.numpy() for x in gt[:3])
        for l, ns in enumerate(eng.ctx.n_seq.numpy()):
            for k in range(max(ns - 1, 0)):
                node = order[l, k]
                assert parent[l, left[l, node]] == node
                assert parent[l, right[l, node]] == node


@settings(deadline=None, max_examples=60)
@given(n_pat=st.lists(st.integers(0, 200), min_size=1, max_size=20),
       n_cols=st.integers(1, 160), warps=st.sampled_from([1, 2, 4, 8]))
def test_unit_and_block_tables_cover_real_patterns_once(n_pat, n_cols,
                                                        warps):
    units, lu = unit_table(n_pat, n_cols)
    L = len(n_pat)
    real = np.minimum(n_pat, n_cols)
    seen = np.zeros((L, n_cols), np.int64)
    for locus, first, n, _ in units:
        assert 0 <= n <= WARP and first % WARP == 0
        seen[locus, first:first + n] += 1
    live = np.arange(n_cols) < real[:, None]
    assert (seen[live] == 1).all()          # every real pattern once
    assert (seen[~live] == 0).all()         # nothing past n_pat
    assert lu[0] == 0 and lu[-1] == len(units)
    for l in range(L):
        mine = units[lu[l]:lu[l + 1]]
        assert len(mine) == max(-(-real[l] // WARP), 1)    # contiguous
        assert (mine[:, 0] == l).all()
        assert (np.diff(mine[:, 1]) == WARP).all()
        assert mine[:, 3].tolist() == [0] * (len(mine) - 1) + [1]
        # the last unit's zero fill starts at the first column past n_pat
        assert mine[-1, 1] + mine[-1, 2] == real[l]
    blocks = block_table(lu, warps)
    assert blocks[0, 0] == 0 and blocks[0, 2] == 0
    assert blocks[-1, 1] == len(units) and blocks[-1, 3] == L
    assert (blocks[1:, 0] == blocks[:-1, 1]).all()
    assert (blocks[1:, 2] == blocks[:-1, 3]).all()
    for u0, u1, l0, l1 in blocks:
        assert (u0, u1) == (lu[l0], lu[l1])          # whole loci
        assert 1 <= l1 - l0 <= warps
        assert u1 - u0 <= warps or l1 - l0 == 1      # or one long locus


def test_units_of_a_masked_and_padded_batch():
    from bpp_tpu_torch.testing import synthetic_run
    run = synthetic_run(n_loci=3, n_seq=[4, 1, 3], n_patterns=[70, 5, 9],
                        seed=1, pad_loci_to=5)
    b = run.batch
    assert b.n_pat.tolist() == [70, 5, 9, 0, 0]
    u = Units(b.n_pat, b.max_patterns, "cpu")
    assert (u.n_loci, u.n_cols, u.n_units) == (5, b.max_patterns, 7)
    assert u.units.dtype == torch.int32 and u.locus_unit0.dtype == torch.int32
    assert u.units[-2:].tolist() == [[3, 0, 0, 1], [4, 0, 0, 1]]
    assert u.blocks(4) is u.blocks(4)
    assert u.blocks(4).tolist() == [[0, 4, 0, 2], [4, 7, 2, 5]]


@pytest.mark.parametrize("model_name,n_cats", MODELS + [("K80", 2),
                                                        ("F81", 3)])
def test_efactors_match_bpp_tpu(model_name, n_cats):
    rng = np.random.default_rng(11)
    L, N = 6, 9
    model, subst = fixed_subst(model_name, n_cats, L, torch.float64)
    freqs = rng.dirichlet(np.full(4, 5.0), L)
    k1, k2 = rng.uniform(0.5, 8.0, (2, L))
    t_eff = rng.uniform(0.0, 0.4, (L, N, n_cats))
    t_eff[:, 0] = 0.0
    t_eff[:, 1] = 1e-7
    eigw = subst.eigw.numpy()
    got, got_c = efactors(model, *(torch.as_tensor(x) for x in (
        t_eff, freqs, k1, k2, eigw)))
    want, want_c = pfj.efactors(SMJ[model_name], *(jnp.asarray(x) for x in (
        t_eff, freqs, k1, k2, eigw)))
    fam = model_family(model)
    assert got.shape == (L, N, n_cats, _KFAC[fam])
    if fam == "gtr":
        # the same formula; the two libraries' expm1 differ by an ulp
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-14, atol=0)
    else:
        np.testing.assert_allclose(got.numpy() + 1.0, np.asarray(want),
                                   rtol=1e-12)
    if fam == "tn93":
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    else:
        assert got_c is None and want_c is None


def _warp_bytes(T, C, fam, shared):
    """csrc/contract.cuh `warp_layout(...).bytes`."""
    K = (1, 3, 4)[fam]
    n = 8 * (T - 1) * C * K + 8 * (T - 1) + 4 * C + 10 * (T - 1)
    if shared:
        n += 512 * C * (T // 2)
    return -(-n // 16) * 16


@pytest.mark.parametrize("T,C,fam,threads,want", [
    (16, 1, 0, 128, ("shared", 128, 17984)),
    (16, 4, 1, 128, ("shared", 128, 72448)),
    (16, 4, 1, 256, ("shared", 256, 144896)),
    (16, 8, 2, 256, ("shared", 192, 221472)),    # 6 warps of 36 KB fit
    (64, 4, 1, 128, ("shared", 96, 218208)),
    (96, 8, 2, 128, ("shared", 32, 222672)),     # one warp a block
    (128, 8, 2, 128, ("global", 128, 139328)),   # 256 KB of CLVs a warp
    (512, 8, 2, 128, ("global", 32, 140048)),    # factors + plan only
])
def test_launch_plan_picks_the_store_that_fits(T, C, fam, threads, want):
    plan = pack.plan_launch("test", _warp_bytes, T, C, fam, None, threads)
    assert tuple(plan) == want
    assert plan.shared_bytes == plan.threads // 32 * _warp_bytes(
        T, C, fam, plan.clv_store == "shared")
    assert plan.shared_bytes <= pack.BLOCK_SHARED
    forced = pack.plan_launch("test", _warp_bytes, T, C, fam, "global",
                              threads)
    assert forced.clv_store == "global"
    assert forced.shared_bytes <= plan.shared_bytes


def test_launch_plan_refuses_what_cannot_fit():
    def plan(T, C, fam, store=None, threads=128):
        return pack.plan_launch("test", _warp_bytes, T, C, fam, store,
                                threads)
    with pytest.raises(ValueError, match="shared memory per warp"):
        plan(2048, 8, 2)
    with pytest.raises(ValueError, match="shared memory per warp"):
        plan(128, 8, 2, store="shared")
    with pytest.raises(ValueError, match="clv_store"):
        plan(16, 4, 1, store="registers")
    with pytest.raises(ValueError, match="threads"):
        plan(16, 4, 1, threads=100)


def warp_layout(T: int, C: int, K: int, shared: bool, real_bytes: int):
    """``csrc/contract.cuh`` ``warp_layout``: the byte offsets of one warp's
    CLV slots (``clv``, the shared store only), expm1 factors (``fac``),
    branch lengths (``blen``), category rates (``rate``) and slot plan
    (``plan``), its ``slots`` and its ``bytes`` rounded up to 16, for
    values of ``real_bytes`` bytes (4: float32, 8: float64)."""
    nlev = T - 1
    slots = T // 2
    off = {"clv": 0}
    n = 4 * real_bytes * WARP * C * slots if shared else 0
    off["fac"] = n
    n += real_bytes * 2 * nlev * C * K
    off["blen"] = n
    n += real_bytes * 2 * nlev
    off["rate"] = n
    n += real_bytes * C
    off["plan"] = n
    n += 2 * 5 * nlev
    return dict(off, slots=slots, bytes=-(-n // 16) * 16)


@settings(max_examples=300, deadline=None)
@given(T=st.integers(2, 600), C=st.integers(1, 8), fam=st.integers(0, 2),
       shared=st.booleans(), threads=st.sampled_from([32, 64, 128, 256]))
def test_float64_store_plan(T, C, fam, shared, threads):
    K = (1, 3, 4)[fam]
    f32 = warp_layout(T, C, K, shared, 4)
    f64 = warp_layout(T, C, K, shared, 8)
    # float32's layout is the one the kernels had before the float64 build
    assert f32["bytes"] == _warp_bytes(T, C, fam, shared)
    nlev = T - 1
    order = ["clv", "fac", "blen", "rate", "plan"]
    sizes = {"clv": 32 * 32 * C * f64["slots"] if shared else 0,
             "fac": 8 * 2 * nlev * C * K, "blen": 8 * 2 * nlev,
             "rate": 8 * C, "plan": 10 * nlev}
    for a, b in zip(order, order[1:]):
        assert f64[a] + sizes[a] == f64[b]      # in order, disjoint
    assert f64["plan"] + sizes["plan"] <= f64["bytes"] < \
        f64["plan"] + sizes["plan"] + 16
    assert f64["bytes"] % 16 == 0
    for r in ("fac", "blen", "rate"):
        assert f64[r] % 8 == 0                  # each double aligned
    assert f64["plan"] % 2 == 0
    assert f64["slots"] == f32["slots"] == T // 2
    assert f64["fac"] - f64["clv"] == 2 * (f32["fac"] - f32["clv"])
    assert f32["bytes"] <= f64["bytes"] <= 2 * f32["bytes"]

    def wb(dbl):
        return lambda T_, C_, fam_, sh: warp_layout(
            T_, C_, (1, 3, 4)[fam_], bool(sh), 8 if dbl else 4)["bytes"]

    fits64 = wb(True)(T, C, fam, 1) <= pack.BLOCK_SHARED
    try:
        p64 = pack.plan_launch("t", wb(True), T, C, fam, None, threads,
                               dbl=True)
    except ValueError:
        assert wb(True)(T, C, fam, 0) > pack.BLOCK_SHARED
        return
    # the float64 build's store: shared where a warp fits and C is at most
    # F64_SHARED_MAX_CATS, which measured faster there; else the scratch
    assert p64.clv_store == ("shared" if fits64 and
                             C <= pack.F64_SHARED_MAX_CATS else "global")
    assert p64.shared_bytes == p64.threads // 32 * wb(True)(
        T, C, fam, p64.clv_store == "shared")
    assert p64.shared_bytes <= pack.BLOCK_SHARED
    p32 = pack.plan_launch("t", wb(False), T, C, fam, None, threads)
    # what float32 keeps in the device scratch, float64 does too
    if p32.clv_store == "global":
        assert p64.clv_store == "global"
    if p32.clv_store == p64.clv_store:
        # the same store in doubles: as many warps a block at most
        assert p64.threads <= p32.threads
    # a forced store is taken as it is
    for store in ("shared", "global"):
        try:
            forced = pack.plan_launch("t", wb(True), T, C, fam, store,
                                      threads, dbl=True)
        except ValueError:
            assert store == "shared" and not fits64
            continue
        assert forced.clv_store == store
