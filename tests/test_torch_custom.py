"""Per-locus models (``model = custom``) and the amino-acid models in the
port, held against ``bpp_tpu`` on the same inputs in float64.

* ``pmatrix_aa`` against ``bpp_tpu``'s for WAG, LG, DAYHOFF and MTMAM
  (rtol 1e-12).
* ``build_custom_models`` and ``refresh_eigen`` in its 4-state (DNA loci)
  and 20-state (DNA loci embedded beside amino-acid loci) forms (rtol
  1e-10; the eigensystems through the rate matrices they rebuild, which
  repeated eigenvalues leave unique).
* ``init_state`` draws equal (freqs, qrates, kappas, eigensystems) and
  the lnL of custom DNA, mixed DNA/AA and WAG batches equal ``bpp_tpu``'s
  ``make_logl_fn`` on ``bpp_tpu``'s initial state (rtol 1e-10), on the
  partitions of ``tests/test_partition.py`` and on amino-acid data from
  ``generate_aa_benchmark``.
* After the freqs and qrates moves the cached lnL equals a fresh pass,
  and loci whose model fixes a parameter never move it.
* The route each batch takes: K1 / K2 through the GTR family for a DNA
  partition, the plain pass at 20 states.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpp_tpu_torch.config import SubstModel as M

torch.set_num_threads(1)     # tiny tensors; the suite runs in parallel

DNA_MODELS = [M.JC69, M.HKY, M.GTR, M.K80, M.TN93, M.F81]
MIXED_MODELS = [M.HKY, M.WAG, M.JC69, M.LG]


def _qmat(w, T, Ti):
    """The rate matrix T diag(w) T^-1 of each locus: unique even where
    eigenvalues repeat (JC69), unlike the eigenvectors."""
    w, T, Ti = np.asarray(w), np.asarray(T), np.asarray(Ti)
    return np.einsum("lik,lk,lkj->lij", T, w, Ti)


def close(a, b, what, rtol=1e-10):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=1e-13, err_msg=what)


@pytest.mark.parametrize("name", ["WAG", "LG", "DAYHOFF", "MTMAM"])
def test_pmatrix_aa_matches_bpp_tpu(name):
    from bpp_tpu.core.pmatrix import pmatrix_aa as pj
    from bpp_tpu_torch.core.pmatrix import pmatrix_aa
    t = np.random.default_rng(3).gamma(0.7, 0.3, size=(5, 7, 2))
    got = pmatrix_aa(torch.as_tensor(t), name).numpy()
    want = np.asarray(pj(jnp.asarray(t), name))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-12)


def _mixed_runs():
    """The same mixed DNA/AA batch for both packages (``test_partition``'s
    construction): loci 1 and 3 carry amino-acid codes."""
    from bpp_tpu.data.msa import ProcessedLocus as PJ
    from bpp_tpu.data.packing import pack_loci as packj
    from bpp_tpu.testing import synthetic_run as synj
    from bpp_tpu_torch.data.msa import ProcessedLocus
    from bpp_tpu_torch.data.packing import pack_loci
    from bpp_tpu_torch.testing import synthetic_run
    import bpp_tpu.config as cj
    runs = []
    for syn, pl, pack, models in (
            (synthetic_run, ProcessedLocus, pack_loci, MIXED_MODELS),
            (synj, PJ, packj, [cj.SubstModel[m.name] for m in MIXED_MODELS])):
        run = syn(n_loci=4, n_seq=5, n_patterns=12, seed=3,
                  model=type(models[0]).CUSTOM, locus_models=models,
                  dtype="float64")
        rng = np.random.default_rng(11)
        loci = list(run.loci)
        for li in (1, 3):
            p = loci[li]
            codes = (1 << rng.integers(0, 20, size=p.codes.shape)).astype(
                np.uint32)
            loci[li] = pl(index=p.index, labels=p.labels, codes=codes,
                          weights=p.weights, tip_species=p.tip_species,
                          n_sites=p.n_sites)
        run.loci = loci
        run.batch = pack(loci, site_block=8)
        runs.append(run)
    return runs


def _dna_runs():
    import bpp_tpu.config as cj
    from bpp_tpu.testing import synthetic_run as synj
    from bpp_tpu_torch.testing import synthetic_run
    return [synthetic_run(n_loci=6, n_seq=5, n_patterns=12, seed=3,
                          model=M.CUSTOM, locus_models=DNA_MODELS,
                          dtype="float64"),
            synj(n_loci=6, n_seq=5, n_patterns=12, seed=3,
                 model=cj.SubstModel.CUSTOM,
                 locus_models=[cj.SubstModel[m.name] for m in DNA_MODELS],
                 dtype="float64")]


@pytest.fixture(scope="module")
def aa_dir(tmp_path_factory):
    """Three loci of ``generate_aa_benchmark`` (16 sequences, 40 sites)
    with a WAG control file."""
    from bpp_tpu_torch.testing import generate_aa_benchmark
    d = tmp_path_factory.mktemp("aa")
    generate_aa_benchmark(3, 40, str(d))
    ctl = d / "aa.ctl"
    ctl.write_text(f"""seed = 11
seqfile = {d}/aa.phy
Imapfile = {d}/Imap.txt
jobname = {d}/aaout
species&tree = 4 A B C D
                 4 4 4 4
                ((A, B), (C, D));
usedata = 1
nloci = 3
cleandata = 0
model = WAG
thetaprior = 3 0.03
tauprior = 3 0.06
finetune = 1
burnin = 2
sampfreq = 1
nsample = 2
""")
    return str(ctl)


def _aa_runs(ctl):
    from bpp_tpu.loader import load_run_from_ctl as loadj
    from bpp_tpu_torch.loader import load_run_from_ctl
    runs = [load_run_from_ctl(ctl), loadj(ctl)]
    for r in runs:
        r.cfg = r.cfg.replace(dtype="float64")
    return runs


def _state_to_port(sj, cfg):
    from bpp_tpu_torch.convert import state_from_numpy
    arrays = {k: {f: (None if v is None else np.asarray(v))
                  for f, v in getattr(sj, k)._asdict().items()}
              for k in ("gt", "sp", "subst")}
    return state_from_numpy(arrays, cfg=cfg)


@pytest.mark.parametrize("which", ["dna", "mixed", "wag"])
def test_init_and_lnl_match_bpp_tpu(which, aa_dir):
    """Initial draws, eigensystems and lnL: the port's Engine against
    ``bpp_tpu``'s on the same batch and seed; the port's likelihood pass
    on ``bpp_tpu``'s initial state against ``bpp_tpu``'s."""
    from bpp_tpu.mcmc.driver import Engine as EngineJ
    from bpp_tpu.mcmc.state import make_logl_fn as logl_j
    from bpp_tpu_torch.mcmc.driver import Engine
    from bpp_tpu_torch.mcmc.state import make_logl_fn
    rp, rj = {"dna": _dna_runs, "mixed": _mixed_runs,
              "wag": lambda: _aa_runs(aa_dir)}[which]()
    ej = EngineJ(rj, seed=7)
    sj = ej.init_state()
    eng = Engine(rp, seed=7, device="cpu")
    sp = eng.init_state()
    assert eng.n_states == ej.n_states == (4 if which == "dna" else 20)
    for f in ("freqs", "qrates", "kappa1", "kappa2", "eigw"):
        close(getattr(sp.subst, f).numpy(), getattr(sj.subst, f), f)
    close(_qmat(sp.subst.eigw, sp.subst.eigT, sp.subst.eigTi),
          _qmat(sj.subst.eigw, sj.subst.eigT, sj.subst.eigTi), "eigensystem")
    close(sp.gt.age.numpy(), sj.gt.age, "gene-tree ages")
    close(sp.logl.numpy(), sj.logl, "logl")
    # the port's pass on bpp_tpu's state
    st = _state_to_port(sj, rp.cfg)
    got = make_logl_fn(eng.ctx, rp.cfg)(st.gt, st.subst, st.sp, None)
    want = logl_j(ej.ctx, rj.cfg)(sj.gt, sj.subst, sj.sp, None)
    close(got.numpy(), want, "lnL on bpp_tpu's state")
    assert np.isfinite(got.numpy()).all()


@pytest.mark.parametrize("which", ["dna", "mixed"])
def test_build_custom_models_and_refresh_eigen(which):
    """The partition's constants and both forms of refresh_eigen on
    random frequencies and exchangeabilities."""
    from bpp_tpu.mcmc.state import build_custom_models as bj
    from bpp_tpu.mcmc.state import refresh_eigen as rj
    from bpp_tpu_torch.mcmc.state import build_custom_models, refresh_eigen
    from bpp_tpu_torch.testing import fixed_subst
    rp, rjun = {"dna": _dna_runs, "mixed": _mixed_runs}[which]()
    L = rp.batch.n_loci
    cp = build_custom_models(rp.locus_models, L, torch.float64)
    cj = bj(rjun.locus_models, L, jnp.float64)
    for f in ("kind", "freqs_free", "q_free", "q_ref", "is_dna"):
        np.testing.assert_array_equal(getattr(cp, f).numpy(),
                                      np.asarray(getattr(cj, f)), f)
    assert (cp.n_states, cp.any_freqs, cp.q_slots) == (
        cj.n_states, cj.any_freqs, cj.q_slots)
    S = cp.n_states
    rng = np.random.default_rng(5)
    f = rng.dirichlet(np.ones(4), size=L)
    freqs = np.zeros((L, S))
    freqs[:, :4] = f
    q = rng.uniform(0.2, 2.0, size=(L, 6))
    _, s = fixed_subst("JC69", 1, L, torch.float64)
    s = s._replace(freqs=torch.as_tensor(freqs), qrates=torch.as_tensor(q),
                   eigw=torch.zeros(L, S), eigT=torch.zeros(L, S, S),
                   eigTi=torch.zeros(L, S, S))
    got = refresh_eigen(s, M.CUSTOM, cp)
    from bpp_tpu.config import SubstModel as MJ
    from bpp_tpu.mcmc.state import SubstState as SJ
    want = rj(SJ(*(jnp.asarray(x.numpy()) for x in s)), MJ.CUSTOM, cj)
    close(got.eigw.numpy(), want.eigw, "eigw")
    close(_qmat(got.eigw, got.eigT, got.eigTi),
          _qmat(want.eigw, want.eigT, want.eigTi), "eigensystem")


def _custom_engine(which="dna", seed=7):
    from bpp_tpu_torch.mcmc.driver import Engine
    run = {"dna": _dna_runs, "mixed": _mixed_runs}[which]()[0]
    return Engine(run, seed=seed, device="cpu")


@pytest.mark.parametrize("which", ["dna", "mixed"])
def test_caches_exact_after_freqs_and_qrates(which):
    from bpp_tpu_torch.mcmc import subst_moves
    eng = _custom_engine(which)
    st = eng.init_state()
    ctx, cfg, gen = eng.ctx, eng.cfg, eng.gen
    fresh = eng._logl_fn
    moved = 0
    for _ in range(3):
        for move in (subst_moves.freqs_move, subst_moves.qrates_move):
            st, (prop, acc) = move(ctx, cfg, st, gen)
            moved += int(acc)
            close(st.logl.numpy(), fresh(st.gt, st.subst, st.sp,
                                         st.clock).numpy(), move.__name__)
    assert moved > 0
    # eigensystem cache equals a refresh from the state's parameters
    from bpp_tpu_torch.mcmc.state import refresh_eigen
    again = refresh_eigen(st.subst, M.CUSTOM, ctx.custom)
    close(_qmat(st.subst.eigw, st.subst.eigT, st.subst.eigTi),
          _qmat(again.eigw, again.eigT, again.eigTi), "eigen cache")


def test_fixed_parameter_loci_never_move():
    """``tests/test_partition.py``'s chain: JC69 loci keep their
    frequencies and exchangeabilities, K80 its frequencies; the free ones
    move."""
    from bpp_tpu_torch.mcmc.driver import Engine
    from bpp_tpu_torch.testing import synthetic_run
    run = synthetic_run(n_loci=4, n_seq=5, n_patterns=12, seed=3,
                        model=M.CUSTOM,
                        locus_models=[M.JC69, M.HKY, M.GTR, M.K80],
                        dtype="float64")
    eng = Engine(run, seed=7, device="cpu")
    st = eng.init_state()
    f0, q0 = st.subst.freqs.clone(), st.subst.qrates.clone()
    st, _ = eng.chunk_step(st, 40)
    f1, q1 = st.subst.freqs, st.subst.qrates
    assert torch.equal(f1[0], f0[0]) and torch.equal(f1[3], f0[3])
    assert torch.equal(q1[0], q0[0])
    assert (f1[1] - f0[1]).abs().max() > 0 and (f1[2] - f0[2]).abs().max() > 0
    for i in (1, 2, 3):
        assert (q1[i] - q0[i]).abs().max() > 0, i
    assert torch.isfinite(st.logl).all()
    assert eng.validate_state(st)


def test_routes(tmp_path, aa_dir):
    """A DNA partition takes K1 (haploid) or K2 (diploid resolution map)
    through the GTR family; amino acids and a partition with an
    amino-acid locus take the plain pass."""
    from bpp_tpu_torch.core.efactors import model_family
    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.mcmc.driver import Engine
    from bpp_tpu_torch.testing import write_partition_file, write_simulated_run
    assert model_family(M.CUSTOM) == "gtr"
    with pytest.raises(ValueError, match="20 states"):
        model_family(M.WAG)
    parts = write_partition_file(tmp_path / "parts.txt",
                                 ["JC69", "HKY", "GTR"], 3)
    ctl = write_simulated_run(tmp_path, n_loci=3, n_sites=150,
                              seqs=(1, 1, 2, 2), diploid=(1, 1, 0, 0),
                              sim_model="model = 3\nkappa = 2",
                              model=f"custom {parts}")
    routes = {"dna": _custom_engine("dna").ctx.route,
              "mixed": _custom_engine("mixed").ctx.route,
              "diploid": Engine(load_run_from_ctl(ctl), device="cpu").ctx.route,
              "wag": Engine(load_run_from_ctl(aa_dir), device="cpu").ctx.route}
    assert routes == {"dna": "K1", "diploid": "K2", "mixed": "plain",
                      "wag": "plain"}


@pytest.mark.parametrize("line", ["model = custom parts.txt", "model = LG",
                                  "check = 10"])
def test_custom_aa_and_check_are_accepted(tmp_path, line):
    """The combinations an earlier slice refused now build an Engine."""
    from bpp_tpu_torch.io.ctl import parse_ctl
    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.mcmc.driver import Engine
    from bpp_tpu_torch.testing import write_simulated_run
    ctl = write_simulated_run(tmp_path, n_loci=2, n_sites=40)
    run = load_run_from_ctl(ctl)
    with open(ctl) as fh:
        text = "".join(ln for ln in fh if not ln.startswith("model"))
    (tmp_path / "parts.txt").write_text("1, DNA, HKY\n2, DNA, JC69\n")
    other = tmp_path / "other.ctl"
    other.write_text(text + line.replace("parts.txt",
                                         str(tmp_path / "parts.txt")) + "\n")
    run.cfg = parse_ctl(str(other))
    if "custom" in line:
        run.locus_models = [M.HKY, M.JC69]
    eng = Engine(run, device="cpu")
    assert eng.n_states == (20 if "LG" in line else 4)


def test_eigen_of_a_proposal_outside_the_space_is_nan():
    """A float32 proposal that reaches a rate or frequency bound (a
    reference rate of 0, so an infinite kappa) gets a NaN eigensystem, as
    in ``bpp_tpu``, and a NaN lnL that the move rejects; the other loci's
    eigensystems are those of a batch without it."""
    from bpp_tpu_torch.core.pmatrix import gtr_eigen
    rng = np.random.default_rng(2)
    f = torch.as_tensor(rng.dirichlet(np.ones(4), size=4))
    q = torch.as_tensor(rng.uniform(0.2, 2.0, size=(4, 6)))
    q_bad = q.clone()
    q_bad[1, 1] = float("inf")
    f_bad = f.clone()
    f_bad[2] = torch.tensor([0.5, 0.0, 0.25, 0.25], dtype=f.dtype)
    w, T, Ti = gtr_eigen(f_bad, q_bad)
    good = [0, 3]
    assert torch.isnan(w[[1, 2]]).all() and torch.isnan(T[[1, 2]]).all()
    w0, T0, Ti0 = gtr_eigen(f[good], q[good])
    close(_qmat(w[good], T[good], Ti[good]), _qmat(w0, T0, Ti0), "others")
