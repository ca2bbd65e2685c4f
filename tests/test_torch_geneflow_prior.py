"""Prior recovery of the geneflow rjMCMC in the PyTorch port.

With ``usedata = 0`` on two species, the candidate routes are A -> B and
B -> A, and the four route sets (none, either, both) have equal prior
mass: the chain must occupy each a quarter of the time, within four
standard errors from the effective sample size of its indicator.
"""

import numpy as np
import torch

from bpp_tpu_torch.mcmc.state import MV_GFRJ

torch.set_num_threads(1)     # tiny tensors; the suite runs in parallel

ITERS = 500


def test_route_sets_equally_likely_under_the_prior(tmp_path):
    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.mcmc.driver import Engine
    from bpp_tpu_torch.testing import ess, write_simulated_run
    ctl = write_simulated_run(
        tmp_path, 1, seqs=(2, 2), n_sites=20, names="AB",
        sim_tree="(A #0.01, B #0.01) :0.03 #0.01", guide="(A, B)",
        usedata=0, priors=("migration = 2\nA B\nB A", "geneflow = 1",
                           "wprior = 2 4"))
    run = load_run_from_ctl(ctl)
    run.cfg = run.cfg.replace(dtype="float64")
    eng = Engine(run, seed=7, device="cpu")
    assert eng.routes.n_routes == 2
    st = eng.init_state()
    sets = np.empty(ITERS, np.int64)
    acc = torch.zeros(2, dtype=torch.int64)
    for i in range(ITERS):
        st, stats = eng.chunk_step(st, 1)
        acc += stats[MV_GFRJ]
        on = st.mig.on.tolist()
        sets[i] = on[0] + 2 * on[1]
    assert int(acc[1]) > ITERS // 4, acc
    for s in range(4):
        x = (sets == s).astype(float)
        se = np.sqrt(0.25 * 0.75 / ess(x))
        assert abs(x.mean() - 0.25) < 4 * se, (s, x.mean(), se, ess(x))
