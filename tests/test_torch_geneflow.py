"""MSC-M geneflow rjMCMC (route add/remove and flip) in the PyTorch port
against ``bpp_tpu``.

* ``init_state``'s route mask ``on`` (the configured routes active among
  the saturated candidates) and migration state equal to ``bpp_tpu``'s.
* ``_route_overlap`` on random taus, and the MSC-M density under random
  ``on`` masks on port chain states with live events, equal to
  ``bpp_tpu``'s (rtol 1e-10, integers exact).
* The caches exact after each of 30 steps of a seeded float64 port chain,
  every state's routes and events consistent, no event on an inactive
  route, and route toggles proposed and accepted.
* mcmc.txt's ``W:`` columns: one a candidate route, with ``bpp_tpu``'s
  header, 0 exactly where the route is off.
* The three refusals (usedata = 2, delimitation, variable-rate routes),
  with ``bpp_tpu``'s messages.
* A resumed run (the checkpoint carries the route mask) writes mcmc.txt
  byte for byte as the whole run.

Prior recovery over the route sets is ``test_torch_geneflow_prior.py``.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpp_tpu_torch.mcmc.state import MV_GFRJ

torch.set_num_threads(1)     # tiny tensors; the suite runs in parallel

SIM = "model = 0\nmigration = 2\nA B 20\nB A 20"
RUN = ("migration = 2\nA B 2 0.1\nB A 2 0.1", "geneflow = 1")
STEPS = 30


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from bpp_tpu_torch.testing import write_simulated_run
    d = tmp_path_factory.mktemp("geneflow")
    return d, write_simulated_run(d, 6, n_sites=60, job="gf", sim_model=SIM,
                                  burnin=4, nsample=12, priors=RUN)


def _engines(ctl):
    from bpp_tpu.loader import load_run_from_ctl as load_j
    from bpp_tpu.mcmc.driver import Engine as EJ
    from bpp_tpu_torch.loader import load_run_from_ctl as load_p
    from bpp_tpu_torch.mcmc.driver import Engine as EP
    rj, rp = load_j(ctl), load_p(ctl)
    rj.cfg = rj.cfg.replace(dtype="float64")
    rp.cfg = rp.cfg.replace(dtype="float64")
    return EJ(rj, seed=5), EP(rp, seed=5, device="cpu")


_CHAIN = {}


def _chain(ctl):
    """(bpp_tpu engine, port engine, the port chain's states and move
    statistics after each step), run once a module."""
    if not _CHAIN:
        engj, eng = _engines(ctl)
        st = eng.init_state()
        states = []
        for _ in range(STEPS):
            st, stats = eng.chunk_step(st, 1)
            states.append((st, stats))
        _CHAIN["x"] = (engj, eng, states)
    return _CHAIN["x"]


def _j(x):
    a = x.detach().cpu().numpy()
    return jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)


def test_init_state_on_mask_equal(data):
    engj, eng = _engines(data[1])
    sj, sp = engj.init_state(), eng.init_state()
    on = sp.mig.on.numpy()
    np.testing.assert_array_equal(on, np.asarray(sj.mig.on))
    np.testing.assert_array_equal(on, eng.route_on0)
    # the configured routes A -> B and B -> A are the active ones
    assert on.sum() == 2 and len(on) == eng.routes.n_routes > 2
    for f in ("time", "node", "src", "dst", "M", "Mi"):
        np.testing.assert_array_equal(getattr(sp.mig, f).numpy(),
                                      np.asarray(getattr(sj.mig, f)), f)
    np.testing.assert_allclose(sp.logpr.numpy(), np.asarray(sj.logpr),
                               rtol=1e-10)


def test_route_overlap_and_density_under_random_masks(data):
    from bpp_tpu.mcmc import mig_moves as mmj
    from bpp_tpu.trees import gtree as gj
    from bpp_tpu.trees import migration as mj
    from bpp_tpu_torch.mcmc import mig_moves as mmp
    engj, eng, states = _chain(data[1])
    st = max((s for s, _ in states), key=lambda s: int(s.mig.count().sum()))
    assert int(st.mig.count().sum()) > 0, "no migration event"
    rng = np.random.default_rng(11)
    rt, rtj = eng.mig_routes, engj.routes
    sp = st.sp
    for _ in range(5):
        tau = sp.tau * torch.as_tensor(rng.uniform(0.5, 1.5, sp.n_nodes))
        spt = sp._replace(tau=tau)
        spj = gj.SpeciesArrays(**{f: _j(getattr(spt, f)) for f in
                                  gj.SpeciesArrays._fields
                                  if getattr(spt, f, None) is not None})
        np.testing.assert_array_equal(
            mmp._route_overlap(rt, spt).numpy(),
            np.asarray(mmj._route_overlap(rtj, spj)))
    fn_p = eng._logpr_mig_fn
    fn_j = mmj.make_logpr_fn_mig(engj.ctx, rtj)
    spj = gj.SpeciesArrays(**{f: _j(getattr(sp, f)) for f in
                              gj.SpeciesArrays._fields
                              if getattr(sp, f, None) is not None})
    gtj = gj.GTrees(**{f: _j(getattr(st.gt, f)) for f in gj.GTrees._fields
                       if getattr(st.gt, f, None) is not None})
    hered = st.subst.heredity
    n_inf = 0
    for _ in range(8):
        on = torch.as_tensor(rng.random(rt.si.shape[0]) < 0.5)
        mig = st.mig._replace(on=on)
        migj = mj.MigState(**{f: _j(getattr(mig, f))
                              for f in mj.MigState._fields})
        lp = fn_p(st.gt, sp, mig, hered)
        lj = fn_j(gtj, spj, migj, _j(hered))
        for x, y, what in zip(lj, lp, ("lp", "coal", "C2", "W", "mc",
                                       "pops")):
            a, b = np.asarray(x), y.numpy()
            if what in ("lp", "C2", "W"):
                np.testing.assert_allclose(b, a, rtol=1e-10, atol=1e-13,
                                           err_msg=what)
            else:
                np.testing.assert_array_equal(a, b, what)
        n_inf += int(np.isinf(lp[0].numpy()).sum())
        # the density of the masked rates equals the rates zeroed
        np.testing.assert_allclose(
            mmp.mg.eff_rates(rt, mig).numpy(),
            np.asarray(mj.eff_rates(rtj, migj)), rtol=1e-12)
    # some masks switch off a route that carries events
    assert n_inf > 0


def test_caches_exact_and_routes_toggle(data):
    from bpp_tpu_torch.trees import migration as mp
    _, eng, states = _chain(data[1])
    ctx = eng.ctx
    acc = torch.zeros(2, dtype=torch.int64)
    ons = set()
    for k, (st, stats) in enumerate(states):
        acc += stats[MV_GFRJ]
        ll = eng._logl_fn(st.gt, st.subst, st.sp, st.clock, mig=st.mig)
        lp, _, _, _, mc, pops = eng._logpr_mig_fn(st.gt, st.sp, st.mig,
                                                  st.subst.heredity)
        np.testing.assert_allclose(st.logl.numpy(), ll.numpy(), rtol=1e-10,
                                   err_msg=f"logl, step {k}")
        np.testing.assert_allclose(st.logpr.numpy(), lp.numpy(), rtol=1e-10,
                                   err_msg=f"logpr, step {k}")
        assert np.isfinite(lp.numpy()).all()
        ok = mp.route_consistent_mig(st.gt, st.sp, st.mig, pops, ctx.n_seq)
        assert bool((ok | ~ctx.locus_mask).all()), k
        # no event on an inactive route
        assert not bool(((mc > 0) & ~st.mig.on[None, :]).any()), k
        # the trace logs 0 exactly where a route is off
        M = eng._trace_of(st)["migM"]
        np.testing.assert_array_equal(
            M.numpy(), torch.where(st.mig.on, st.mig.M,
                                   torch.zeros_like(st.mig.M)).numpy())
        ons.add(tuple(st.mig.on.tolist()))
    assert eng.validate_state(states[-1][0])
    # two moves an iteration (flip, add/remove); the route set changes
    assert int(acc[0]) == 2 * STEPS and int(acc[1]) > 0, acc
    assert len(ons) > 1


def test_mcmc_txt_zeros_for_inactive_routes(data):
    from bpp_tpu.loader import load_run_from_ctl as load_j
    from bpp_tpu.output import McmcWriter as WJ
    from bpp_tpu_torch import cli
    d, ctl = data
    assert cli.main(["--cfile", ctl, "--device", "cpu", "--quiet"]) == 0
    run = load_j(ctl)
    WJ(str(d / "h.txt"), run.cfg, run.stree).close()
    text = (d / "gf.mcmc.txt").read_text()
    assert text.startswith((d / "h.txt").read_text())
    head = text.splitlines()[0].split("\t")
    rows = np.asarray([[float(x) for x in ln.split("\t")]
                       for ln in text.splitlines()[1:]])
    w = np.asarray([c.startswith("W:") for c in head])
    assert w.sum() == 22 and rows.shape[0] == 12
    W = rows[:, w]
    assert np.isfinite(W).all() and (W >= 0).all()
    # inactive routes log exactly 0, active ones a positive rate; the
    # number of active routes moves along the chain
    assert (W == 0).any() and (W > 0).any()
    assert len({int((r > 0).sum()) for r in W}) > 1


REFUSALS = {
    "usedata = 2": ("usedata = 1", "usedata = 2"),
    "delimitation": None,
    "variable rates": ("A B 2 0.1\nB A 2 0.1", "A B 2 0.1 3\nB A 2 0.1"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_as_bpp_tpu(data, tmp_path, case):
    from bpp_tpu.loader import load_run_from_ctl as load_j
    from bpp_tpu.mcmc.driver import Engine as EJ
    from bpp_tpu_torch.loader import load_run_from_ctl as load_p
    from bpp_tpu_torch.mcmc.driver import Engine as EP
    with open(data[1]) as fh:
        text = fh.read()
    sub = REFUSALS[case]
    if sub is None:
        text += "speciesdelimitation = 1 0 2\n"
    else:
        assert sub[0] in text
        text = text.replace(*sub)
    ctl = tmp_path / "g.ctl"
    ctl.write_text(text)
    errs = []
    for load, engine, kw in ((load_j, EJ, {}), (load_p, EP,
                                                {"device": "cpu"})):
        with pytest.raises(NotImplementedError) as e:
            engine(load(str(ctl)), seed=1, **kw)
        errs.append(str(e.value))
    assert errs[0] == errs[1], errs
    assert "geneflow" in errs[0]


def test_resume_is_byte_identical(data, tmp_path):
    from bpp_tpu_torch import cli
    d, ctl = data
    text = open(ctl).read().replace("jobname = " + str(d / "gf"),
                                    "jobname = " + str(tmp_path / "res"))
    res = tmp_path / "res.ctl"
    res.write_text(text + "checkpoint = 5 0\n")
    argv = ["--device", "cpu", "--quiet"]
    assert cli.main(["--cfile", str(res), *argv]) == 0
    whole = (tmp_path / "res.mcmc.txt").read_bytes()
    shutil.copy(tmp_path / "res.mcmc.txt", tmp_path / "whole.txt")
    from bpp_tpu_torch import checkpoint as ckpt
    _, _, arrays = ckpt.load_checkpoint(str(tmp_path / "res.chk.npz"))
    assert arrays["state.mig.on"].dtype == bool
    assert cli.main(["--resume", str(tmp_path / "res.chk.npz"), *argv]) == 0
    assert (tmp_path / "res.mcmc.txt").read_bytes() == whole
