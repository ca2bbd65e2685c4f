"""MSC-M migration on fixed routes: the port's caches along its chains.

After each of 30 steps of seeded float64 port chains with live migration
events (strict clock, clock = 2, variable-rate routes, heredity, A10),
the cached logl and logpr equal a fresh evaluation at rtol 1e-10, every
real locus's routes and events are consistent, and the moves of each
configuration have moved what they own.  The functions themselves are
held against ``bpp_tpu`` in ``test_torch_mig.py``.
"""

import numpy as np
import pytest
import torch

from bpp_tpu_torch.trees import migration as mp

torch.set_num_threads(1)     # tiny tensors; the suite runs in parallel

SIM = "model = 0\nmigration = 2\nA B 20\nB A 20"
ROUTES = "migration = 2\nA B 2 0.1\nB A 2 0.1"
CONFIGS = {
    "strict": (ROUTES,),
    "clock2": (ROUTES, "clock = 2 10 100 5 iid G"),
    "am": ("migration = 2\nA B 2 0.1 3\nB A 2 0.1 3",),
    "heredity": (ROUTES, "heredity = 1 4 4"),
    "A10": (ROUTES, "speciesdelimitation = 1 0 2"),
}
STEPS = 30


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from bpp_tpu_torch.testing import write_simulated_run
    d = tmp_path_factory.mktemp("migchain")
    return {name: write_simulated_run(d, 8, n_sites=60, job=name,
                                      sim_model=SIM, priors=lines)
            for name, lines in CONFIGS.items()}


def _chain(data, name):
    """The port engine and its chain's states after each step."""
    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.mcmc.driver import Engine
    run = load_run_from_ctl(data[name])
    run.cfg = run.cfg.replace(dtype="float64")
    # at this seed every configuration's chain ends holding migration
    # events, which the last checks need (about one chain in five of
    # these ends with none)
    eng = Engine(run, seed=8, device="cpu")
    st = eng.init_state()
    states = []
    for _ in range(STEPS):
        st, _ = eng.chunk_step(st, 1)
        states.append(st)
    return eng, states


@pytest.mark.parametrize("name", list(CONFIGS))
def test_caches_exact_along_port_chain(data, name):
    """After every step: logl and logpr equal a fresh evaluation, and the
    routes and events of every real locus are consistent."""
    eng, states = _chain(data, name)
    ctx = eng.ctx
    for k, st in enumerate(states):
        ll = eng._logl_fn(st.gt, st.subst, st.sp, st.clock, mig=st.mig)
        lp, *_, pops = eng._logpr_mig_fn(st.gt, st.sp, st.mig,
                                         st.subst.heredity)
        np.testing.assert_allclose(st.logl.numpy(), ll.numpy(), rtol=1e-10,
                                   err_msg=f"logl, step {k}")
        np.testing.assert_allclose(st.logpr.numpy(), lp.numpy(), rtol=1e-10,
                                   err_msg=f"logpr, step {k}")
        ok = mp.route_consistent_mig(st.gt, st.sp, st.mig, pops, ctx.n_seq)
        assert bool((ok | ~ctx.locus_mask).all()), (k, ok)
        assert np.isfinite(st.logpr.numpy()).all()
    last = states[-1]
    assert int(last.mig.count().sum()) > 0, "no migration event"
    if name == "am":
        assert not torch.allclose(last.mig.Mi, last.mig.M[None, :])
    if name == "heredity":
        assert (last.subst.heredity != 1.0).any()
    if name == "A10":
        taus = torch.stack([s.sp.tau for s in states])
        assert (taus == 0).any() or bool((eng.init_state().sp.tau == 0).any())
