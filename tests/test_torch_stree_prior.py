"""Prior recovery of the port's species-tree moves (usedata = 0, the
default uniform prior over rooted trees, speciesmodelprior = 1): the
frequency of every rooted topology lies within 4 Monte Carlo standard
errors of its prior probability, and every topology is visited.  Three
species under SPR alone and under SPR + SNL (pSNL 0.5), four species (15
topologies) with SNL dominant (pSNL 0.9); the pattern of
tests/test_a01.py.
"""

import numpy as np
import pytest
import torch

from test_torch_stree import canon, write_dummy

torch.set_num_threads(1)     # tiny tensors; the suite runs in parallel


def _chain(tmp_path, names, guide, speciestree, n_iter, seed):
    """Topologies visited by one prior chain, and its move statistics."""
    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.mcmc.driver import Engine
    ctl = write_dummy(tmp_path, names, guide,
                      extra=f"speciestree = {speciestree}")
    run = load_run_from_ctl(ctl)
    run.cfg = run.cfg.replace(dtype="float64")
    eng = Engine(run, seed=seed, device="cpu")
    st = eng.init_state()
    seen = []
    acc = torch.zeros((23, 2), dtype=torch.int64)
    for _ in range(n_iter):
        st, stats = eng._step(st)
        acc += stats
        seen.append(canon(st.sp.left, st.sp.right, st.sp.parent,
                          run.stree.names))
    return np.asarray(seen), acc


@pytest.mark.parametrize("speciestree,n_iter", [
    ("1 0", 500), ("1 0.5 0.33 0.1 0.2", 700)], ids=["spr", "spr-snl"])
def test_three_species_topologies_match_prior(tmp_path, speciestree,
                                              n_iter):
    """One chain; standard errors from 20 batch means."""
    from bpp_tpu_torch.mcmc.state import MV_SNL, MV_SSPR
    seen, acc = _chain(tmp_path, "ABC", "((A,B),C)", speciestree, n_iter, 5)
    assert int(acc[MV_SSPR, 1]) > 0
    if speciestree != "1 0":
        assert int(acc[MV_SNL, 1]) > 0
    assert len(set(seen)) == 3
    seen = seen[n_iter // 10:]
    m = len(seen) // 20
    for topo in sorted(set(seen)):
        x = (seen[:20 * m] == topo).astype(float).reshape(20, m).mean(1)
        se = x.std(ddof=1) / np.sqrt(20)
        assert abs(x.mean() - 1 / 3) < 4 * se, (topo, x.mean(), se)


def test_four_species_topologies_match_prior_with_snl(tmp_path):
    """SNL-dominant kernel (pSNL 0.9) on 4 species: 6 independent chains
    (a topology's sojourns are long, so batch means of one short chain
    understate the error); standard errors between chains."""
    from bpp_tpu_torch.mcmc.state import MV_SNL
    freqs, pooled, snl_acc = [], set(), 0
    for seed in range(6):
        seen, acc = _chain(tmp_path, "ABCD", "((A,B),(C,D))",
                           "1 0.9 0.33 0.1 0.2", 260, 40 + seed)
        snl_acc += int(acc[MV_SNL, 1])
        seen = seen[30:]
        pooled |= set(seen)
        freqs.append({t: float((seen == t).mean()) for t in set(seen)})
    assert snl_acc > 0
    assert len(pooled) == 15
    for topo in sorted(pooled):
        x = np.asarray([f.get(topo, 0.0) for f in freqs])
        se = x.std(ddof=1) / np.sqrt(len(x))
        assert abs(x.mean() - 1 / 15) < 4 * se, (topo, x.mean(), se)
