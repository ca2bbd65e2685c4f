"""Locus sharding of the port (``bpp_tpu_torch.parallel``): the sharded
chain is the unsharded chain.

* ``MultihostSpec.parse``, the contiguous block split and
  ``pad_loci_for_mesh`` against ``bpp_tpu``'s on the same inputs.
* ``shard_by_locus`` keeps the rows of the named per-locus fields only:
  the SIMPLE clock's shared rates stay whole, and so does an ``[H]`` table
  when H == L; a split that leaves a rank without a locus is refused.
* Two gloo ranks on the CPU (one pair of processes for every case) run
  20-25 ``chunk_step``s in float64 from the global initial state, and
  their gathered state equals the one-process chain's: gene-tree
  topologies and move counts exactly, ages, taus, thetas, rates and lnL
  to rtol 1e-9.  Cases: A00 (synthetic, 16 loci), unphased diploid data
  (the K2 route) with Gamma rates, the Dirichlet locus rates and
  heredity, the host loops (integrated thetas with Gamma-Dirichlet locus
  rates and heredity), a relaxed clock with Gamma-Dirichlet nu_i, dated
  tips, A01 (SPR and SNL), A10, an MSC-I network and MSC-M migration
  (the sim-SPR walk's loop test every step).
* An uneven split, 10 loci over 3 ranks (4, 4, 2).
* The CLI: two ``python -m bpp_tpu_torch --multihost 127.0.0.1:P,2,r``
  processes write one mcmc.txt, equal to the one-process run's, and one
  summary.
"""

import datetime
import os
import socket
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from bpp_tpu_torch import testing
from bpp_tpu_torch.parallel import mesh
from bpp_tpu_torch.parallel.multihost import MultihostSpec

ROOT = Path(__file__).resolve().parent.parent

torch.set_num_threads(1)     # tiny tensors; the suite runs in parallel

SEED = 11
RTOL = 1e-9
MIG_FAST = "migration = 2\nA B 20\nB A 20\n"


# --- the split and the field lists -------------------------------------------


@pytest.mark.parametrize("arg", [
    "127.0.0.1:1234,2,0", " host:99 , 4 ,3", "auto", " AUTO ",
    "h:1,2", "h:1,2,3,4", "h:1,x,0", "", "h:1,2,"])
def test_multihost_spec_parses_as_bpp_tpu(arg):
    from bpp_tpu.parallel.multihost import MultihostSpec as Ref

    def outcome(cls):
        try:
            spec = cls.parse(arg)
        except ValueError as exc:
            return ("error", str(exc))
        return (spec.coordinator, spec.num_processes, spec.process_id)

    assert outcome(MultihostSpec) == outcome(Ref)


@pytest.mark.parametrize("n_loci,size", [(16, 2), (10, 3), (1000, 2),
                                         (7, 4), (9, 8), (3, 1)])
def test_block_split_and_padding_match_bpp_tpu(n_loci, size, monkeypatch):
    from bpp_tpu.parallel import multihost as ref
    x = np.arange(n_loci)
    blocks = []
    for rank in range(size):
        monkeypatch.setattr(ref.jax, "process_count", lambda: size)
        monkeypatch.setattr(ref.jax, "process_index", lambda r=rank: r)
        want = ref._local_rows(x, None)
        lo, hi = mesh.block(n_loci, size, rank)
        np.testing.assert_array_equal(x[lo:hi], want)
        blocks.append((lo, hi))
    assert blocks[0][0] == 0 and blocks[-1][1] == n_loci
    assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
    fake = types.SimpleNamespace(devices=np.empty(size))
    assert mesh.pad_loci_for_mesh(n_loci, size) == \
        ref.pad_loci_for_mesh(n_loci, fake)


def test_a_rank_without_loci_is_refused():
    with pytest.raises(ValueError, match="rank 2 without a locus"):
        mesh.Shard(rank=2, size=3, n_loci=2)
    with pytest.raises(ValueError, match="at most 3 processes"):
        mesh.Shard(rank=3, size=4, n_loci=5)
    assert mesh.Shard(rank=1, size=3, n_loci=10).n_local == 4
    assert mesh.Shard(rank=2, size=3, n_loci=10).n_local == 2


def _engine(run, shard=None):
    from bpp_tpu_torch.mcmc.driver import Engine
    return Engine(run, seed=SEED, device="cpu", shard=shard)


def test_simple_clock_rates_stay_whole_at_two_loci():
    from bpp_tpu_torch.config import Clock
    run = testing.synthetic_run(n_loci=2, n_seq=4, n_patterns=6,
                                dtype="float64", clock=Clock.SIMPLE,
                                clock_alpha=2.0)
    st = _engine(run).init_state()
    assert st.clock.brate.shape[0] == 1
    for rank in (0, 1):
        sh = mesh.Shard(rank=rank, size=2, n_loci=2)
        got = mesh.shard_by_locus(st, sh, shared_clock=True)
        torch.testing.assert_close(got.clock.brate, st.clock.brate,
                                   rtol=0, atol=0)
        torch.testing.assert_close(got.clock.lnrates, st.clock.lnrates,
                                   rtol=0, atol=0)
        # nu_i is per locus under every clock
        torch.testing.assert_close(got.clock.nu, st.clock.nu[rank:rank + 1],
                                   rtol=0, atol=0)
        assert got.logl.shape == (1,) and got.gt.age.shape[0] == 1
        assert got.sp.tau.shape == st.sp.tau.shape


def test_species_tables_stay_whole_when_h_equals_l():
    run = testing.synthetic_run(n_loci=7, n_seq=4, n_patterns=6,
                                dtype="float64")
    eng = _engine(run)
    H = run.stree.n_nodes
    assert H == 7 == run.batch.n_loci
    st = eng.init_state()
    sh = mesh.Shard(rank=1, size=2, n_loci=7)
    ctx = mesh.shard_by_locus(
        eng.ctx.__class__(**{**eng.ctx.__dict__, "date_lmax": st.sp.tau}),
        sh)
    assert ctx.date_lmax.shape == (H,) and ctx.shard is sh
    assert ctx.tip_partials.shape[0] == 3 and ctx.locus_mask.shape == (3,)
    got = mesh.shard_by_locus(st, sh)
    for name in ("tau", "theta", "pptable", "parent"):
        assert getattr(got.sp, name).shape == getattr(st.sp, name).shape
    assert got.finetune.shape == st.finetune.shape
    torch.testing.assert_close(got.logl, st.logl[4:], rtol=0, atol=0)


# --- sharded chains against the unsharded chain ------------------------------


def _cases(tmp: Path):
    """name -> (control file, or the locus count of a synthetic batch,
    steps)."""
    def sim(name, n_loci, **kw):
        d = tmp / name
        d.mkdir()
        return str(testing.write_simulated_run(d, n_loci=n_loci, **kw))

    def dated(name, n_loci):
        """Dated tips (``datefile``, ``locusrate = 3``): one date in
        [0, 1] an individual."""
        d = tmp / name
        d.mkdir()
        rng = np.random.default_rng(8)
        (d / "dates.txt").write_text("".join(
            f"{s}{k} {round(float(rng.uniform(0, 1)), 3)}\n"
            for s in "abcd" for k in (1, 2)))
        return str(testing.write_simulated_run(
            d, n_loci=n_loci, n_sites=80,
            priors=(f"datefile = {d}/dates.txt", "locusrate = 3 10 10000")))

    return {
        "a00_synthetic": (16, 25),
        "a00_diploid_k2": (sim(
            "dip", 6, diploid=(1, 1, 0, 0), model="HKY", n_sites=120,
            priors=("alphaprior = 1 1 4", "locusrate = 1 5",
                    "heredity = 1 4 4")), 20),
        "a00_host_loops": (sim(
            "host", 8, thetaprior="3 0.03 int",
            priors=("locusrate = 1 10 10 5", "heredity = 1 4 4")), 20),
        "a00_relaxed_clock": (sim(
            "clock", 6, n_sites=120,
            priors=("locusrate = 1 10 10 5",
                    "clock = 2 10 100 5 gdir G")), 20),
        "a00_dated": (dated("dated", 6), 20),
        "a01": (sim("a01", 6, seqs=(4, 4, 4), names="ABC",
                    sim_tree="((A #0.01, B #0.01) :0.01 #0.01, C #0.01) "
                    ":0.02 #0.01", guide="((A, B), C)",
                    priors=("speciestree = 1 0.5 0.33 0.1 0.2",)), 20),
        "a10": (sim("a10", 6, priors=("speciesdelimitation = 1 0 2",)), 20),
        "msci": (sim("msci", 4, sim_tree=testing.NET_SIM_TREE,
                     guide=testing.NET_GUIDE,
                     priors=("phiprior = 1 1",)), 20),
        # migration A <-> B simulated at M = 20.  (The chain of 8 such
        # loci is chaotic: on one process a 1e-15 relative change of one
        # theta grows to 1e-5 in lnL within 15 iterations; that of 16 loci
        # keeps it below 1e-12 over 20.)
        "mscm": (sim("mscm", 16, sim_model="model = 0\n" + MIG_FAST,
                     priors=(testing.MIG_RUN, "wprior = 2 0.1")), 20),
    }


def _run_of(spec):
    if isinstance(spec, int):
        return testing.synthetic_run(n_loci=spec, n_seq=6, n_patterns=24,
                                     n_species=4, dtype="float64")
    from bpp_tpu_torch.io.ctl import parse_ctl
    from bpp_tpu_torch.loader import load_run
    return load_run(parse_ctl(spec).replace(dtype="float64"))


PER_LOCUS = {"gt": ("left", "right", "parent", "age", "hpath"),
             "subst": ("mu", "heredity", "alpha", "freqs", "qrates"),
             "clock": ("nu", "brate"), "mig": ("time", "node", "Mi")}
SHARED = {"sp": ("tau", "theta", "phi", "left", "right", "parent"),
          "mig": ("M",), "clock": ("mubar", "nubar")}


def _arrays(state, stats, shard=None, shared_clock=False):
    """The compared fields of a state, per-locus ones gathered."""
    out = {"stats": stats.numpy()}
    if state.mubar is not None:
        out["mubar"] = state.mubar.numpy()
    for k in ("logl", "logpr", "coal", "t2h"):
        v = getattr(state, k)
        if v is not None:
            out[k] = mesh.gather_loci(shard, v).numpy()
    for part, names in PER_LOCUS.items():
        obj = getattr(state, part)
        for n in names:
            v = None if obj is None else getattr(obj, n)
            if v is None or (shared_clock and n == "brate"):
                continue
            out[f"{part}.{n}"] = mesh.gather_loci(shard, v).numpy()
    for part, names in SHARED.items():
        obj = getattr(state, part)
        for n in names:
            v = None if obj is None else getattr(obj, n)
            if v is not None:
                out[f"{part}.{n}"] = v.numpy()
    return out


def _chain(run, steps, shard=None):
    from bpp_tpu_torch.config import Clock
    eng = _engine(run, shard)
    st = eng.init_state()
    eng.gen.manual_seed(SEED)
    st, stats = eng.chunk_step(st, steps)
    return _arrays(st, stats, shard, run.cfg.clock == Clock.SIMPLE)


def _worker(rank, world, init_file, out_dir, cases):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        for name, (ctl, steps) in cases.items():
            run = _run_of(ctl)
            shard = mesh.make_shard(run.batch.n_loci)
            got = _chain(run, steps, shard)
            got["n_local"] = np.asarray([shard.n_local])
            if rank == 0:
                ref = _chain(run, steps)
                np.savez(os.path.join(out_dir, f"{name}.npz"),
                         **{f"ref/{k}": v for k, v in ref.items()},
                         **{f"got/{k}": v for k, v in got.items()})
            dist.barrier()
    finally:
        dist.destroy_process_group()


def _spawn(world, out_dir, cases, timeout=300):
    """Run ``_worker`` on ``world`` gloo ranks; kill them all on a
    failure or when ``timeout`` passes (a desync hangs a collective)."""
    import torch.multiprocessing as tmp
    init = os.path.join(out_dir, "rendezvous")
    ctx = tmp.spawn(_worker, args=(world, init, out_dir, cases),
                    nprocs=world, join=False)
    deadline = time.time() + timeout
    try:
        while not ctx.join(timeout=5):
            if time.time() > deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


@pytest.fixture(scope="module")
def pair_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shard")
    cases = _cases(tmp)
    _spawn(2, str(tmp), cases)
    return {name: dict(np.load(tmp / f"{name}.npz")) for name in cases}


def _assert_same_chain(res, name):
    ref = {k[4:]: v for k, v in res.items() if k.startswith("ref/")}
    got = {k[4:]: v for k, v in res.items() if k.startswith("got/")}
    assert set(ref) == set(got) - {"n_local"}, name
    for k, v in ref.items():
        g = got[k]
        assert g.shape == v.shape, (name, k)
        if v.dtype.kind in "biu":
            np.testing.assert_array_equal(g, v, err_msg=f"{name} {k}")
        else:
            np.testing.assert_allclose(g, v, rtol=RTOL, atol=1e-12,
                                       err_msg=f"{name} {k}")


CASE_NAMES = ("a00_synthetic", "a00_diploid_k2", "a00_host_loops",
              "a00_relaxed_clock", "a00_dated", "a01", "a10", "msci",
              "mscm")


@pytest.mark.parametrize("name", CASE_NAMES)
def test_two_rank_chain_equals_one_process_chain(pair_results, name):
    res = pair_results[name]
    _assert_same_chain(res, name)
    stats = res["ref/stats"]
    assert stats[:, 0].sum() > 0 and stats[:, 1].sum() > 0
    assert res["got/n_local"][0] >= 2


def test_uneven_split_over_three_ranks(tmp_path):
    _spawn(3, str(tmp_path), {"a00_ten": (10, 12)})
    res = dict(np.load(tmp_path / "a00_ten.npz"))
    _assert_same_chain(res, "a00_ten")
    assert res["got/n_local"][0] == 4


# --- the CLI -----------------------------------------------------------------


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _table(path):
    lines = Path(path).read_text().splitlines()
    return lines[0].split("\t"), np.array(
        [[float(x) for x in ln.split("\t")] for ln in lines[1:]])


def test_cli_pair_writes_the_one_process_run(tmp_path):
    ctl = Path(testing.write_simulated_run(tmp_path, n_loci=6, n_sites=120,
                                           burnin=8, nsample=12))
    mh = tmp_path / "mh.ctl"
    mh.write_text(ctl.read_text().replace(f"{tmp_path}/out",
                                          f"{tmp_path}/mh"))
    cmd = [sys.executable, "-m", "bpp_tpu_torch", "--device", "cpu",
           "--x64"]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}    # tiny tensors
    one = subprocess.run(cmd + ["--cfile", str(ctl), "--quiet"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert one.returncode == 0, one.stderr
    port = _free_port()
    procs = [subprocess.Popen(
        cmd + ["--cfile", str(mh), "--multihost",
               f"127.0.0.1:{port},2,{rank}"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    assert "2 processes, backend gloo" in outs[0][1]
    # rank 1 prints nothing of its own (torch's c10d may warn)
    assert outs[1][0] == "" and "bpp_tpu_torch" not in outs[1][1]
    head1, one_tab = _table(tmp_path / "out.mcmc.txt")
    head2, mh_tab = _table(tmp_path / "mh.mcmc.txt")
    assert head1 == head2 and one_tab.shape == mh_tab.shape == (
        12, len(head1))
    j = head1.index("lnL")
    np.testing.assert_allclose(mh_tab[:, j], one_tab[:, j], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(np.delete(mh_tab, j, 1),
                               np.delete(one_tab, j, 1), rtol=RTOL)
    # one summary (rank 0's); no a1b1 log under a mesh
    mh_files = sorted(p.name for p in tmp_path.glob("mh.*")
                      if p.name != "mh.ctl")
    assert mh_files == ["mh.FigTree.tre", "mh.mcmc.txt", "mh.pdf",
                        "mh.txt"], mh_files
    assert "lnL" in (tmp_path / "mh.txt").read_text()
