"""Morphological traits in the PyTorch port against ``bpp_tpu``.

* ``parse_traitfile`` and ``build_trait_data``: every field equal.
* ``make_trait_logl`` (the fixed topology) and ``make_trait_logl_topo``
  (topologies with the root at any index) against ``bpp_tpu``'s on random
  taus and branch rates, float64, rtol 1e-10.
* ``Engine.init_state``'s trait state equal to ``bpp_tpu``'s, and carried
  across by ``convert.state_from_numpy``.
* The cached trait logl exact (rtol 1e-10) after every step of seeded
  float64 port chains under A00 (strict and clock = 2), A01 (strict and
  clock = 2), A10, A11 and MSC-M, with ``validate_state`` passing and the
  trait move accepted.
* The MSC-I refusal, with ``bpp_tpu``'s message.
* A resumed run's mcmc.txt byte-identical to the whole run's.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpp_tpu_torch.mcmc.state import MV_TRAIT

torch.set_num_threads(1)     # tiny tensors; the suite runs in parallel

STEPS = 12
CONFIGS = {
    "A00": (),
    "clock2": ("clock = 2 10 100 5 iid G",),
    "A01": ("speciestree = 1 0.5 0.33 0.1 0.2",),
    "A01clock2": ("speciestree = 1 0.5 0.33 0.1 0.2",
                  "clock = 2 10 100 5 iid G"),
    "A10": ("speciesdelimitation = 1 0 2",),
    "A11": ("speciestree = 1 0.5 0.33 0.1 0.2",
            "speciesdelimitation = 1 0 2"),
    "mig": ("migration = 2\nA B 2 0.1\nB A 2 0.1",),
}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from bpp_tpu_torch.testing import write_simulated_run, write_trait_file
    d = tmp_path_factory.mktemp("traits")
    write_trait_file(d / "traits.txt")
    ctls = {}
    for name, lines in CONFIGS.items():
        sim = ("model = 0\nmigration = 2\nA B 20\nB A 20" if name == "mig"
               else "model = 0")
        ctls[name] = write_simulated_run(
            d, 4, n_sites=60, job=name, sim_model=sim,
            priors=(f"traitfile = {d / 'traits.txt'}",) + lines)
    ctls["resume"] = write_simulated_run(
        d, 3, n_sites=60, job="res", burnin=4, nsample=10,
        priors=(f"traitfile = {d / 'traits.txt'}", "checkpoint = 5 0"))
    return d, ctls


def _runs(ctl):
    from bpp_tpu.loader import load_run_from_ctl as load_j
    from bpp_tpu_torch.loader import load_run_from_ctl as load_p
    rj, rp = load_j(ctl), load_p(ctl)
    rj.cfg = rj.cfg.replace(dtype="float64")
    rp.cfg = rp.cfg.replace(dtype="float64")
    return rj, rp


def test_parse_and_build_equal(data):
    from bpp_tpu.trees import traits as tj
    from bpp_tpu_torch.trees import traits as tp
    d, ctls = data
    pj = tj.parse_traitfile(str(d / "traits.txt"))
    pp = tp.parse_traitfile(str(d / "traits.txt"))
    assert [p.dtype for p in pp] == ["cont", "disc"]
    assert (pp[1].values == tp.MISSING).any()
    for a, b in zip(pj, pp):
        assert (a.dtype, a.labels, a.v_pop, a.ldetRs) == \
            (b.dtype, b.labels, b.v_pop, b.ldetRs)
        np.testing.assert_array_equal(a.values, b.values)
    rj, rp = _runs(ctls["A00"])
    dj = tj.build_trait_data(pj, rj.stree, jnp.float64)
    dp = tp.build_trait_data(pp, rp.stree, torch.float64)
    for a, b in zip(dj, dp):
        assert (a.dtype, a.v_pop, a.ldetRs, a.kmax) == \
            (b.dtype, b.v_pop, b.ldetRs, b.kmax)
        for f in ("m_tip", "tipprob", "nstate"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                np.testing.assert_array_equal(np.asarray(x), y.numpy(), f)
    assert 2 <= int(dp[1].nstate.min()) and int(dp[1].nstate.max()) <= 4


# species topologies of 4 tips as (left, right) of inner nodes 4..6; the
# root sits at 6, 6 and 4
TOPOLOGIES = [
    {6: (4, 5), 4: (0, 1), 5: (2, 3)},
    {6: (0, 5), 5: (1, 4), 4: (2, 3)},
    {4: (5, 6), 5: (0, 2), 6: (1, 3)},
]


def _arrays(topo, rng):
    H = 7
    left = np.full(H, -1)
    right = np.full(H, -1)
    parent = np.full(H, -1)
    for p, (a, b) in topo.items():
        left[p], right[p] = a, b
        parent[a] = parent[b] = p
    root = int(np.flatnonzero(parent < 0)[0])
    tau = np.zeros(H)
    tau[root] = rng.uniform(0.02, 0.1)
    stack = [root]
    while stack:
        p = stack.pop()
        for c in (left[p], right[p]):
            if c >= 4:
                tau[c] = tau[p] * rng.uniform(0.1, 0.9)
                stack.append(c)
    return left, right, parent, tau


def test_trait_logl_functions_equal(data):
    from bpp_tpu.trees import traits as tj
    from bpp_tpu_torch.trees import traits as tp
    d, ctls = data
    rj, rp = _runs(ctls["A00"])
    dj = tj.build_trait_data(tj.parse_traitfile(str(d / "traits.txt")),
                             rj.stree, jnp.float64)
    dp = tp.build_trait_data(tp.parse_traitfile(str(d / "traits.txt")),
                             rp.stree, torch.float64)
    st = rp.stree
    fixed_j, fixed_p = tj.make_trait_logl(rj.stree, dj), \
        tp.make_trait_logl(st, dp)
    topo_j = tj.make_trait_logl_topo(st.n_tips, st.n_nodes, dj)
    topo_p = tp.make_trait_logl_topo(st.n_tips, st.n_nodes, dp)
    own = {p: (int(st.left[p]), int(st.right[p]))
           for p in range(st.n_tips, st.n_nodes)}
    rng = np.random.default_rng(3)
    for k in range(6):
        brate = rng.uniform(0.3, 3.0, (2, st.n_nodes))
        tau = _arrays(own, rng)[3]
        want = np.asarray(fixed_j(jnp.asarray(tau), jnp.asarray(brate)))
        got = fixed_p(torch.as_tensor(tau), torch.as_tensor(brate)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-10, err_msg=f"fixed {k}")
        for topo in TOPOLOGIES:
            left, right, parent, tau = _arrays(topo, rng)
            want = np.asarray(topo_j(*(jnp.asarray(a) for a in (
                left, right, parent, tau, brate))))
            got = topo_p(*(torch.as_tensor(a) for a in (
                left, right, parent)), torch.as_tensor(tau),
                torch.as_tensor(brate)).numpy()
            assert np.isfinite(got).all()
            np.testing.assert_allclose(got, want, rtol=1e-10,
                                       err_msg=f"topology {topo}")


@pytest.mark.parametrize("name", ["A00", "A01"])
def test_init_state_equal(data, name):
    from bpp_tpu.mcmc.driver import Engine as EJ
    from bpp_tpu_torch.mcmc.driver import Engine as EP
    rj, rp = _runs(data[1][name])
    sj = EJ(rj, seed=9).init_state()
    sp = EP(rp, seed=9, device="cpu").init_state()
    np.testing.assert_array_equal(sp.trait.brate.numpy(),
                                  np.asarray(sj.trait.brate))
    np.testing.assert_allclose(sp.trait.logl.numpy(),
                               np.asarray(sj.trait.logl), rtol=1e-10)
    np.testing.assert_allclose(sp.logl.numpy(), np.asarray(sj.logl),
                               rtol=1e-10)
    # convert.py carries bpp_tpu's trait state across
    from bpp_tpu_torch.testing import port_state
    got = port_state(sj, rp.cfg).trait
    np.testing.assert_array_equal(got.brate.numpy(),
                                  np.asarray(sj.trait.brate))
    np.testing.assert_array_equal(got.logl.numpy(), np.asarray(sj.trait.logl))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_caches_exact_along_port_chain(data, name):
    """After every step the cached trait logl equals a fresh evaluation
    (and validate_state passes); the trait move is proposed and
    accepted, and the taus move."""
    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.mcmc import moves
    from bpp_tpu_torch.mcmc.driver import Engine
    run = load_run_from_ctl(data[1][name])
    run.cfg = run.cfg.replace(dtype="float64")
    eng = Engine(run, seed=5, device="cpu")
    st = eng.init_state()
    tau0 = st.sp.tau.clone()
    acc = torch.zeros(2, dtype=torch.int64)
    topologies = {tuple(st.sp.parent.tolist())}
    for k in range(STEPS):
        st, stats = eng.chunk_step(st, 1)
        acc += stats[MV_TRAIT]
        topologies.add(tuple(st.sp.parent.tolist()))
        fresh = moves._trait_eval(eng.ctx, st.sp, st.sp.tau, st.trait.brate)
        np.testing.assert_allclose(st.trait.logl.numpy(), fresh.numpy(),
                                   rtol=1e-10, err_msg=f"step {k}")
        assert np.isfinite(fresh.numpy()).all()
    assert eng.validate_state(st)
    assert int(acc[0]) > 0 and int(acc[1]) > 0, acc
    assert not torch.equal(st.sp.tau, tau0)
    if name in ("clock2", "A01clock2"):
        # one rate a branch: the branches differ
        assert st.trait.brate[0].unique().numel() > 2
    if name == "A01clock2":
        # the caches held across accepted species moves
        assert len(topologies) > 1


def test_msci_refused_as_bpp_tpu(tmp_path):
    from bpp_tpu.loader import load_run_from_ctl as load_j
    from bpp_tpu.mcmc.driver import Engine as EJ
    from bpp_tpu_torch import testing
    from bpp_tpu_torch.loader import load_run_from_ctl as load_p
    from bpp_tpu_torch.mcmc.driver import Engine as EP
    testing.write_trait_file(tmp_path / "traits.txt")
    ctl = testing.write_simulated_run(
        tmp_path, 2, n_sites=40, sim_tree=testing.NET_SIM_TREE,
        guide=testing.NET_GUIDE,
        priors=("phiprior = 1 1", f"traitfile = {tmp_path / 'traits.txt'}"))
    with pytest.raises(NotImplementedError) as ej:
        EJ(load_j(ctl), seed=1)
    with pytest.raises(NotImplementedError) as ep:
        EP(load_p(ctl), seed=1, device="cpu")
    assert str(ep.value) == str(ej.value) == \
        "traits with MSC-I networks are not supported"


def test_resume_is_byte_identical(data, tmp_path):
    from bpp_tpu_torch import cli
    d, ctls = data
    argv = ["--device", "cpu", "--quiet"]
    assert cli.main(["--cfile", ctls["resume"], *argv]) == 0
    whole = (d / "res.mcmc.txt").read_bytes()
    shutil.move(d / "res.mcmc.txt", tmp_path / "whole.txt")
    shutil.copy(tmp_path / "whole.txt", d / "res.mcmc.txt")
    assert cli.main(["--resume", str(d / "res.chk.npz"), *argv]) == 0
    assert (d / "res.mcmc.txt").read_bytes() == whole
