"""Linked thetas (``thetamodel``) in the PyTorch port against ``bpp_tpu``.

* ``theta_move``'s pooled statistics (``moves._pool_linked`` of the
  per-population sums) and ``Engine.a1b1_stats`` equal ``bpp_tpu``'s
  ``a1b1_stats`` (under an inverse-gamma prior a1 - a and b1 - b are
  exactly the pooled K and C) on the same state, for linked-all and
  linked-inner on a species tree and linked-msci on an MSC-I network.
* ``theta_move`` gives every member its owner's theta.
* Short linked A01 and A10 chains keep every theta equal to its owner's.
* The mcmc.txt header (the owners' theta columns only) equals
  ``bpp_tpu``'s for the three models.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)     # tiny tensors; the suite runs in parallel

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
MODES = {"linked-all": 1, "linked-inner": 2, "linked-msci": 3}


def _runs(mode, tmp_path):
    """(bpp_tpu run, port run) on the same data: a synthetic 4-species
    tree, or for linked-msci the fixture's network with data and
    ``tau-parent = no`` on its hinner."""
    from bpp_tpu.loader import load_run as load_j
    from bpp_tpu_torch.loader import load_run as load_p
    if mode != "linked-msci":
        from bpp_tpu.testing import synthetic_run as syn_j
        from bpp_tpu_torch.testing import synthetic_run as syn_p
        kw = dict(n_loci=4, n_seq=5, n_species=4, seed=2,
                  linked_theta=MODES[mode])
        rj, rp = syn_j(**kw), syn_p(**kw)
        from bpp_tpu.config import Prior as PJ, PriorDist as DJ
        from bpp_tpu_torch.config import Prior, PriorDist
        rj.cfg = rj.cfg.replace(dtype="float64",
                                thetaprior=PJ(DJ.INVGAMMA, 3.0, 0.01))
        rp.cfg = rp.cfg.replace(dtype="float64",
                                thetaprior=Prior(PriorDist.INVGAMMA, 3.0,
                                                 0.01))
        return rj, rp
    from bpp_tpu.io.ctl import parse_ctl_lines as pj
    from bpp_tpu_torch.io.ctl import parse_ctl_lines as pp
    rng = np.random.default_rng(0)
    lines = open(os.path.join(FIX, "msci", "d.txt")).read().splitlines()
    lines[1:7] = [ln.split()[0] + " " + "".join(rng.choice(list("ACGT"), 20))
                  for ln in lines[1:7]]
    (tmp_path / "d.txt").write_text("\n".join(lines) + "\n")
    text = open(os.path.join(FIX, "msci", "m.ctl")).read()
    for a, b in (("usedata = 0", "usedata = 1\nthetamodel = linked-msci"),
                 ("thetaprior = gamma 2 200", "thetaprior = invgamma 3 0.01"),
                 ("seqfile = d.txt", f"seqfile = {tmp_path}/d.txt"),
                 ("Imapfile = d.imap", f"Imapfile = {FIX}/msci/d.imap"),
                 # tau-parent = no: the hinner's parent is linked (model B)
                 ("phi=0.4,&tau-parent=yes", "phi=0.4,&tau-parent=no")):
        text = text.replace(a, b)
    rj = load_j(pj(text.splitlines()).replace(dtype="float64"))
    rp = load_p(pp(text.splitlines()).replace(dtype="float64"))
    return rj, rp


def _to_jax(st):
    """bpp_tpu's McmcState with the port state's arrays."""
    from bpp_tpu.mcmc import state as sj
    from bpp_tpu.trees import gtree as gj

    def conv(cls, x):
        kw = {}
        for f in cls._fields:
            v = getattr(x, f, None)
            if v is None:
                continue
            a = v.detach().cpu().numpy()
            if a.dtype == np.int64:
                a = a.astype(np.int32)
            kw[f] = jnp.asarray(a)
        return cls(**kw)

    return sj.McmcState(
        gt=conv(gj.GTrees, st.gt),
        sp=conv(gj.SpeciesArrays, st.sp),
        subst=conv(sj.SubstState, st.subst),
        logl=jnp.asarray(st.logl.numpy()), logpr=jnp.asarray(st.logpr.numpy()),
        finetune=jnp.asarray(st.finetune.numpy()))


@pytest.mark.parametrize("mode", list(MODES))
def test_pooled_stats_and_a1b1_equal(mode, tmp_path):
    from bpp_tpu.mcmc.driver import Engine as EJ
    from bpp_tpu_torch.mcmc import moves
    from bpp_tpu_torch.mcmc.driver import Engine
    rj, rp = _runs(mode, tmp_path)
    eng = Engine(rp, seed=4, device="cpu")
    st = eng.init_state()
    link = eng.ctx.theta_link
    assert link is not None and bool((link != torch.arange(len(link))).any())
    engj = EJ(rj, seed=4)
    a1j, b1j, _, _ = engj.a1b1_stats(_to_jax(st))
    a1, b1 = eng.a1b1_stats(st)
    np.testing.assert_allclose(a1.numpy(), np.asarray(a1j), rtol=1e-12)
    np.testing.assert_allclose(b1.numpy(), np.asarray(b1j), rtol=1e-12)
    # theta_move's statistics: the same pooled K and C
    _, c, t2 = eng._logpr_fn(st.gt, st.sp, st.subst.heredity)
    k, cs = moves._pool_linked(eng.ctx, *moves._suff_stats(
        eng.ctx, c, t2, st.subst.heredity))
    a, b = rp.cfg.thetaprior.alpha, rp.cfg.thetaprior.beta
    np.testing.assert_allclose(k.numpy(), np.asarray(a1j) - a, atol=1e-9)
    np.testing.assert_allclose(cs.numpy(), np.asarray(b1j) - b, rtol=1e-10,
                               atol=1e-15)
    # every member takes its owner's theta
    for _ in range(3):
        st, _ = moves.theta_move(eng.ctx, rp.cfg, st, eng.gen)
        np.testing.assert_array_equal(st.sp.theta.numpy(),
                                      st.sp.theta[link].numpy())


@pytest.mark.parametrize("kind", ["A01", "A10"])
def test_linked_chains_keep_groups(kind):
    from bpp_tpu_torch.mcmc.driver import Engine
    from bpp_tpu_torch.mcmc.state import MV_RJ, MV_SSPR, MV_THETA
    from bpp_tpu_torch.testing import synthetic_run
    kw = ({"est_stree": True} if kind == "A01"
          else {"est_delimit": True})
    run = synthetic_run(n_loci=4, n_seq=5, n_species=4, seed=2,
                        linked_theta=1 if kind == "A01" else 2, **kw)
    run.cfg = run.cfg.replace(dtype="float64")
    eng = Engine(run, seed=5, device="cpu")
    state = eng.init_state()
    link = eng.ctx.theta_link
    acc = torch.zeros((23, 2), dtype=torch.int64)
    for _ in range(15):
        state, stats = eng.chunk_step(state, 2)
        acc += stats
        th = state.sp.theta
        np.testing.assert_array_equal(th.numpy(), th[link].numpy())
    assert int(acc[MV_THETA, 1]) > 0
    assert int(acc[MV_SSPR if kind == "A01" else MV_RJ, 0]) > 0
    assert eng.validate_state(state)


@pytest.mark.parametrize("mode", list(MODES))
def test_mcmc_header_equal(mode, tmp_path):
    from bpp_tpu.output import McmcWriter as WJ
    from bpp_tpu_torch.output import McmcWriter
    rj, rp = _runs(mode, tmp_path)
    wj = WJ(str(tmp_path / "j.txt"), rj.cfg, rj.stree)
    wp = McmcWriter(str(tmp_path / "p.txt"), rp.cfg, rp.stree)
    wj.close()
    wp.close()
    assert wp.columns == wj.columns
    n_theta = sum(c.startswith("theta") for c in wp.columns)
    assert n_theta < rp.stree.n_nodes
    if mode == "linked-msci":
        assert any(c.startswith("phi") for c in wp.columns)
