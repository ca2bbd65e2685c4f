#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``bpp_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--parent DIR]

``--parent DIR``, a checkout of the parent commit (``git archive``), adds
the parent's float64 builds timed on ``[x64]``'s inputs and the parent's
K3/K4/K5 timed on ``[chains]``' inputs, each in a process of its own.
Phases, numbered as they were added (``main`` runs 13, 19 and 20-22 right
after the build, while the simulations of data 1 and data 2 run beside
them, then the others in order); any failure exits non-zero:

1. device   — torch version, the card's name and power limit;
2. build    — nvcc builds kernels K1 (``bpp_tpu_torch/csrc/pack_kernel.cu``),
              K2 (``csrc/fels_kernel.cu``), K3/K4 (``csrc/chain_kernel.cu``)
              and K5 (``csrc/simwalk_kernel.cu``), one process each,
              started together; the float64 instantiations' registers and spills
              from the ``-Xptxas -v`` report (none of C <= 4 may spill);
3. data 1   — the port's simulator writes the haploid bench dataset (4
              species x 4 sequences, 500 sites, JC69, seed 137) at
              10,000 loci, ``bench.py``'s scale target; every 1000-locus
              path reads its first 1000 loci (a control file's ``nloci``
              reads the first alignments, and the simulator is prefix-
              stable).  The simulation, and that of data 2, run in
              processes of their own from the start of the script, beside
              the build, ``[shapes]``, main 9 and the MSC-I phases, which
              need neither;
4. kernel 1 — on gene trees from the JC69 engine, K1 (float32) is held
              against its plain PyTorch version (float64, on the card)
              for JC69, HKY+G4, TN93 and GTR+G4 (max per-locus |dlnL| <
              0.02), under both CLV stores (shared memory, which the
              wrapper picks at these shapes, and the device scratch,
              forced); K1's device time comes from torch.profiler
              traces (the median over 3 traces of each trace's median
              over 20-30 launches, at the wrappers' 64 threads a block,
              and under the global store), and one
              launch, the whole wrapper (checks + launch) and the plain
              version (float32) from CUDA events (median of 30 / 30 / 20
              after warm-up); two launches on the same inputs must be
              bit-equal; an empty kernel is timed beside it (the launch
              floor); a profiler trace of 3 engine iterations gives the
              device kernels, busy time and idle share per iteration;
5. main 1   — ``bpp_tpu_torch.cli.main(["--cfile", "run.ctl"])`` runs the
              1000-locus A00 JC69 chain (burnin 10, nsample 40); the launch
              count of K1 must grow by 8 per iteration (age 2 + SPR 3 +
              tau 2 + mixing 1) plus 1 for the initial state, K2's must
              stay 0, and mcmc.txt must hold 40 finite samples with
              moving theta/tau; the conditional a1b1 log must hold 40 rows
              of an a1 and a b1 for each theta column, the summary its
              Rao-Blackwellized section, and ``out.pdf`` a PDF; a
              ``[profile]`` line of the step with the a1b1 record taken
              every iteration (sampfreq = 1) stands beside the plain one;
6. data 2   — the simulator writes the diploid dataset (4 species x 2
              unphased diploid individuals = 16 haplotype tips, 500 sites,
              HKY, 1000 loci with Gamma(5, 5) locus rates, seed 137);
7. kernel 2 — on gene trees from a short run of the diploid engine, K2
              (float32) against its plain version (float64, on the card)
              for the same four models, per pattern and per locus after
              ``reduce_root`` (max per-locus |dlnL| < 0.02); timed as K1
              is; the ``[profile]`` line of the diploid HKY+G4 step; and
              ``[moves]``: the wall time of each substitution and rate
              move, of the Gamma-Dirichlet mu_i move with its chain (K4),
              and of GTR's eigendecomposition and the discrete-gamma
              quantiles on the card;
8. main 2   — ``cli.main(["--cfile", "run2.ctl"])`` runs the 1000-locus
              diploid chain (phase = 1 1 1 1, HKY, alphaprior with 4
              categories, hierarchical locus rates, heredity; burnin 10,
              nsample 40); K2 must be launched 12 times per iteration (the
              8 passes of the base moves + freqs 1 + qrates 1 + alpha 1 +
              mu_i 1; heredity and mubar touch no likelihood) plus 1 for
              the initial state, K1 never, and mcmc.txt must hold 40
              finite samples with moving theta/tau/mu_bar.
9. given    — the kernels on inputs only a relaxed clock or tip dating
              gives them, each against its float64 plain version on the
              four model families under both CLV stores: K1 with the
              branch lengths (``blen``) of a relaxed-clock chain's state
              (the haploid data, clock = 2) and on the dated gene trees
              of a tip-dating chain (nonzero tip ages, no ``blen``); K2
              with the ``blen`` of a SIMPLE-clock chain on the diploid
              data (per pattern and per locus); and ``[profile]`` lines of
              those three steps;
10. main 3  — ``cli.main`` runs the haploid JC69 data with hierarchical
              locus rates and an IID relaxed clock (``clock = 2 10 100 5
              iid G``): K1 launched 8 + H = 15 times per iteration (the
              branch-rate sweep adds one pass per species branch; mu_i, nu_i
              and nubar touch no likelihood under clock 2) plus 1, K2
              never; mcmc.txt moving theta/tau/mu_bar/nu_bar;
11. main 4  — the diploid chain of main 2 with ``clock = 4 2.0``: K2
              launched 12 + H = 19 times per iteration plus 1, K1 never;
              moving theta/tau/mu_bar and the r: rate columns;
12. main 5  — the haploid data with integrated-out thetas (``thetaprior =
              invgamma 3 0.06 int``), dates in [0, 1] from a datefile the
              script writes, ``locusrate = 3 10 10000`` and ``checkpoint =
              25 0``: run whole, then ``--resume`` from its checkpoint; the
              resumed mcmc.txt must equal the whole run's byte for byte,
              with no theta column and a moving mu_bar, and the summary
              must count every sample; K1 launched 8 times per iteration
              (the tip-dating mubar move replaces mixing) plus 1 at init,
              in each run, K3 5 times per iteration (the age move's 2
              blocks, 3 SPR rounds).

13. shapes  — both kernels against their plain versions (float64) on what
              the bench data lacks: 1..16 sequences per locus in one batch,
              caterpillar and balanced trees, 0 to 200 patterns a locus
              (K1 sums loci of more than 128 patterns in rounds), HKY+G4;
              and on 12 loci of 64 and of 128 tips, where the wrappers pick
              the CLV store themselves (shared at 64 tips with 4
              categories, the device scratch at 128 tips with 8).
14. main 6  — A01 on the haploid data (``speciestree = 1 0.5 0.33 0.1
              0.2``: SPR and SNL, pSNL 0.5): K1 launched 8 + 2 = 10 times per
              iteration (both species moves are computed, one kept, a pass
              each) plus 1, K2 never; mcmc.txt holds 40 newick samples,
              the A01 report's topology probabilities sum to 1, and the
              move statistics show both SPR and SNL kept;
15. main 7  — A11 on the diploid data of main 2 (``speciesdelimitation = 1
              0 2``, ``speciestree = 1`` (pSNL 0.2), ``speciesmodelprior =
              1``): K2 launched 12 + 3 = 15 times per iteration (rj 1 +
              species SPR 1 + SNL 1) plus 1, K1 never; 40 newick samples, a
              well formed A11 report whose probabilities sum to 1;
16. topo    — 5 iterations each of main 6's and main 7's engines: K1 and K2
              held against their float64 plain versions on the four model
              families under both CLV stores on every gene-tree batch a
              species SPR, SNL or rj move proposed (the trees the kernel
              was launched on inside the move) and on the state after each
              accepted one (these iterations run eagerly: the trees are
              taken from the moves' Python calls); ``[profile]`` of both
              steps and ``[moves]`` wall ms of species_spr_move, snl_move
              and rj_move.

17. custom  — the haploid data under a partition of five DNA models in
              blocks of 200 loci (JC69, K80, HKY, TN93, GTR): K1 through its
              GTR family on the per-locus eigensystems of a warmed chain's
              state, against its float64 plain version under both CLV
              stores, and the ``[profile]`` of that step; later, K2 likewise
              on the diploid data under the same partition (with G4);
18. main 8  — ``cli.main`` runs that partition on the haploid data with
              ``check = 10`` and ``print = 1 0 0 1 0``, ``printlocus = 2 1
              1000``: K1 launched 8 + freqs 1 + qrates 6 (one pass for each
              slot some locus's model frees) = 15 times per iteration, plus
              1 at init and 1 for each of the 5 checks (which all pass in
              float32), K2 never; ``out8.gtree.L1`` and ``.L1000`` hold 40
              gene trees each;
19. main 9  — ``bench.py``'s amino-acid workload (``_bench_aa``: 500 loci x
              16 sequences x 500 sites, WAG, ``generate_aa_benchmark`` seed
              137, the same priors), burnin 10, nsample 40, through the
              20-state plain pass on the card: one pass in float32 within
              0.02 lnL a locus of float64 on the card, the pass timed, the
              ``[profile]`` of the step, no K1 or K2 launch, and the peak
              device memory of the run.

20. main 10 — A00 on an MSC-I network at the bench shape: 1000 loci x 4
              species x 4 sequences x 500 sites simulated on
              ``testing.NET_SIM_TREE`` (B into T through H, phi 0.3; seed
              137, JC69, theta 0.01), through ``cli.main`` with ``phiprior =
              1 1``, burnin 5, nsample 20: K1 launched 2 + 3 + 5 (one tau
              pass for each inner node) + 1 = 11 times per iteration plus
              1, K2 never; theta,
              tau and phi columns move; every state's routes are
              consistent and ``validate_state`` passes on the last; no
              FigTree.tre; the ``[profile]`` of its step;
21. net     — K1 and K2 against their float64 plain versions on network
              gene trees under both CLV stores: (a) main 10's last state,
              (b) a clock = 2 chain on the network (``blen`` through
              ``edge_passes``), (c) the BDI fixture under clock = 2
              (mirrors at their partners' rates, ``rate_owner``), (d) K2
              with ``reduce_root`` on 200 diploid HKY+G4 loci simulated on
              the network;
22. main 11 — the BDI fixture (``tests/fixtures/bdi``) with ``thetamodel =
              linked-msci`` through ``cli.main``, burnin 8, nsample 20: K1
              launched 2 + 3 + 4 + 1 = 10 times per iteration plus 1; ``out11.mcmc.txt.processed``
              (the label-switching correction) holds every sample, the
              theta columns are the linked owners', phi moves; then
              ``--msci-create`` prints ``tests/test_msci_create.py``'s
              bidirection newick; ``[cli]``: ``cli.main`` on the card for
              ``tests/fixtures/msci/m.ctl`` with its data (strict and
              clock = 2) and for linked-all / linked-inner thetas on
              ((A, B), (C, D)) with 100 of main 10's loci, 4 samples
              each (linked-inner with ``chains = 4``, on the batched
              route: 4 mcmc files).

23. main 12 — A00 under MSC-M migration at the bench shape: main 1's data
              shape (1000 loci, 4 x 4 sequences, 500 sites, theta 0.01,
              seed 137) simulated on ((A,B),(C,D)) with ``migration = 2``
              (A -> B and B -> A, M = 0.5) by the port's simulator, run
              through ``cli.main`` with the routes ``A B`` and ``B A`` and
              ``wprior = 20 40``, burnin 5, nsample 20: K1 launched 8 times
              per iteration (age 2
              + sim-SPR 3 + tau 2 + mixing 1; the event-age move runs no
              pass under the strict clock) plus 1, K2 never, K5 3 times an
              iteration (one walk a sim-SPR round); theta, tau and
              the ``W:`` rate columns move; every state's routes and events
              are consistent, the last passes ``validate_state`` (after
              the launch count is read) and holds migration events; the
              a1b1 log has the rates' rows; the ``[profile]`` of its step;
24. mig     — K1 and K2 against their float64 plain versions under both CLV
              stores: (a) every gene-tree batch ``spr_sim_move`` proposed
              over 5 eager iterations of main 12's engine (loci of failed walks,
              pruned and not regrafted, left out and counted) and the state
              after them; (b) the sub-edge branch lengths
              (``relaxed_branch_lengths_mig``) of a clock = 2 MSC-M chain on
              main 12's data, whose step launches K1 8 + 32 (one pass an
              event slot) + 7 (branch rates) = 47 times; (c) K2 with
              ``reduce_root`` on 200 diploid HKY+G4 loci simulated under
              migration;
25. main 13 — ``chains = 2`` on main 1's data (A00 JC69, 1000 loci) with
              ``checkpoint = 25 0`` through ``cli.main``, on the batched
              route (``driver.chain_route``: one step over both chains):
              K1 launched 8 x 50 + 2 = 402 times (once a pass for both
              chains, plus an initial state a chain), K2 never;
              ``out13.mcmc.txt`` and
              ``out13.c2.mcmc.txt`` hold 40 finite moving samples each, the
              summary the split-R-hat table; ``--resume`` rewrites both
              files byte for byte; the ``[profile]`` of the two-chain step.

26. main 14 — main 12's data and routes with ``geneflow = 1`` (the
              rjMCMC over all 22 candidate routes; A -> B and B -> A active
              at the start), burnin 5, nsample 20, through ``cli.main``: K1
              launched 8 times per iteration plus 1 (the flip and add/remove
              moves run no pass), K2 never, K5 3 times an iteration; routes
              and events consistent in every state, ``validate_state`` on
              the last; every ``W:`` column 0 exactly where its route is
              off; the geneflow moves proposed twice an iteration (the
              statistics' slot); the ``[profile]`` of its step;
27. main 15 — main 1's data with a trait file the script writes (numpy
              seed 137: 4 species x 20 continuous characters, 4 x 50
              discrete ones of 2-4 states, some missing) and ``check =
              10``: K1 launched 8 times per iteration plus 1 plus one a
              check; the cached trait logl equal to a fresh evaluation at
              every check; the trait move proposed and accepted; the
              ``[profile]`` of its step;
28. tools   — ``--bfdriver run.ctl --points 4`` writes four control files
              and the beta-weights table; the smallest beta's file runs
              through ``cli.main`` for 10 iterations (K1 8 an iteration
              plus 1, finite lnL); ``--summary run.ctl`` rewrites main 1's
              ``out.txt``, whose table must equal main 1's to the six
              decimals mcmc.txt keeps;
29. main 16 — main 1 with ``--x64``: K1's float64 build launched 8 times
              per iteration plus 1 and the float32 build never; the diploid
              chain of main 2 with ``--x64`` for 10 iterations: K2's float64
              build 12 an iteration plus 1; the ``[profile]`` of the float64
              JC69 step;
30. x64     — the diagnosis: K1 (JC69) on main 16's gene trees and K2
              (HKY) on the diploid data, each build x store x C in 1, 2,
              4, 8: device ms, the prologue's ms alone, blocks and warps an
              SM, shared bytes a block, registers and spills; the float64
              builds against their float64 plain versions on the card for
              JC69, HKY, TN93 and GTR x C in 1, 2, 4, 8 x both CLV stores
              (K1 within 1e-6 lnL a locus, K2 within 1e-8 a pattern and
              1e-6 a locus after ``reduce_root``; repeat launches and the
              stores bit-equal), and on [shapes]' batches and 128-tip trees
              with branches of 2e-8 that force the rescale; each timed
              with the profiler at its main path's model, beside its plain
              version and its bound in float64 bytes and operations; with
              ``--parent``, the parent's float64 builds on the same
              inputs;
31. native  — main 1's 1000 loci loaded through the port's native pattern
              compressor (``csrc/compress.cpp``, built with g++ into
              ``bpp_tpu_torch/_build/`` in [build]; asserted to run, one
              compression a locus at least) and again through the numpy
              path (``BPP_TPU_NATIVE=0``): the batches and every locus's
              patterns and weights bit-equal, both load times printed;
32. shard   — locus sharding (``--multihost``) on the one card: two ranks
              spawned by ``torch.multiprocessing`` (gloo: NCCL takes one
              rank a card), each ``cli.main(["--cfile", ..., "--x64",
              "--multihost", "127.0.0.1:P,2,r"])`` on main 16's run: rank
              0's mcmc.txt equal to main 16's (every column to rtol 1e-9,
              lnL to 1e-6), rank 1 writing nothing (it runs in an empty
              directory), each rank's K1 float64 build launched 8 x 50 + 1
              times on its own 500 loci of cuda:0 and the plain versions
              never; then main 16's diploid run likewise (K2's float64 build
              12 x 10 + 1 on each rank's 500 loci); the chain's wall ms an
              iteration beside main 16's, and each rank's peak device
              memory.  The ranks are killed on a failure or after
              ``SHARD_TIMEOUT`` seconds.

The configurations no earlier run took to the card, each through
``cli.main`` with its launches predicted, finite moving samples, ``check``
where set, its pruning kernel held against its float64 plain version on
the chain's last state, and the ``[profile]`` of its step there:

33. main 17 — main 1's run at 10,000 loci, burnin 2, nsample 8: K1 8 an
              iteration plus 1 = 81; the load through the native
              compressor timed; K1 held on all 10,000 loci;
34. main 18 — ``chains = 8`` on the first 100 loci (``bench.py``'s
              ``_bench_chains8`` shape), burnin 8, nsample 12: K1 8 x (8 x
              20 + 1) = 1,288 one chain at a time, 8 x 20 + 8 = 168 on
              the batched route, which it takes; eight finite moving
              mcmc files and the pooled split-R-hat table;
35. main 19 — TN93+G4 (``model = TN93``, ``alphaprior = 1 1 4``) on main
              1's data, 20 iterations: K1 8 + freqs 1 + qrates 2 (TN93's
              two free rates) + alpha 1 = 12 an iteration plus 1; the
              frequencies, rates and alpha (not in mcmc.txt) moved on the
              loci; K1 held on the state's own TN93+G4 parameters;
36. main 20 — GTR+G4 likewise: K1 8 + 1 + 5 + 1 = 15 an iteration plus 1;
              the eigensystems (``pmatrix.eigh_jacobi`` in float32 on the
              card) that came out NaN counted, each rejected;
37. main 21 — main 2's diploid data with Gamma-Dirichlet locus rates
              (``locusrate = 1 10 10 5``), the correlated clock (``clock = 3
              10 100 5 gdir LN``) and ``check = 10``, 20 iterations: K2 8 +
              freqs 1 + qrates 1 + alpha 1 + mu_i 1 (the root's rate is
              mu_i under clock 3) + 6 (the branch sweep skips the root) =
              18 an iteration plus 1 plus 1 a check, K4 2 an iteration
              (mu_i, nu_i); mu_i, nu_i and the branch rates moved; K2 held
              on the relaxed branch lengths; ``[moves]``: one
              ``gammadir_accept`` call (K4) at 1000 loci;
38. main 22 — main 15's traits under ``clock = 2 10 100 5 iid G`` with
              A01's species moves and ``check = 10``, 20 iterations: K1 8
              + species SPR and SNL 2 + 7 branch-rate passes = 17 an
              iteration plus 1 plus 1 a check; the cached trait logl equal
              to a fresh evaluation at every check, SPR and SNL kept, the A01
              report as main 6's; K1 held on the relaxed branch lengths;
39. memory  — every chain's peak device memory
              (``torch.cuda.max_memory_allocated`` from a reset just before
              the chain; ``run_chain`` prints it on the chain's line beside
              what the process held before it) in one line.
40. graph   — the captured step (``mcmc.graph.StepGraph``) against the
              eager step at the same seed, in this process, for mains 1,
              2, 13, 16, 17, 18 and 23, timed every other main path the
              route table captures (3, 4, 8, 9, 10, 11, 15, 16's diploid
              run, 19, 20), mains 5, 6, 7, 12, 14, 21 and 22 (whose
              accept chains, SNL and sim-SPR walks run on the device) and
              mains 24 and 25 (A10 and integrated thetas under chains =
              4), 26 and 27 (MSC-M and A10 x MSC-M under chains = 4),
              28 (MSC-I under chains = 4) and 29 (GTR+G4 under chains =
              4):
              the states, move statistics, traces and generator
              states bit-equal after 6 iterations on mains 1, 5 and 13,
              2 on the MSC-I and MSC-M mains (10, 11, 12, 14, 26-28) and
              3 on the others, and (mains 1, 5 and 13) the
              control file through ``cli.main`` at burnin 8, nsample 4
              both ways with every mcmc file byte-equal; each route's
              wall ms an
              iteration (eager the median of 3 windows of the compared
              iterations, 2 windows where 2 are compared, replayed of 3
              more windows of 3 replays, 1 for mains 10, 12, 14, 18 and
              24-29), device kernels, busy ms
              and idle share an iteration (a profiler trace of 1
              iteration of each route, both in one profiler session of
              the one engine built for both routes; the eager trace's
              kernels within 25 of the
              captured step's exact device nodes, counted with
              cudaGraphGetNodes), the capture's seconds and peak device
              memory, K1-K5 launched inside the graph (under ``chains =
              K`` on the batched route, mains 13, 18 and 23-29, one
              graph of the step over the stacked chains with its
              write-back, as ``run_mcmc_multi`` runs it); then
              ``[eigen]``: main 20's GTR step on the eager route with its
              eigensystems from ``pmatrix.eigh_jacobi`` and from
              ``torch.linalg.eigh``, windows in turn;
41. sync    — each main path's control file cut to 20 loci: one eager
              step under ``torch.cuda.set_sync_debug_mode("warn")``, every
              synchronising op by the line of the port that issued it,
              beside the route ``driver.step_route`` gives; a graph-route
              step must have none.
42. chains  — K3 (the integrated-theta accept chain) on main 5's and K4
              (the Gamma-Dirichlet chain) on main 21's engine, K5 (the
              sim-SPR walk) on main 12's and main 14's, eager iterations
              in which every call is held against its plain version on the
              same inputs (K3/K4 on the host in float64, K5 in torch ops
              on the card): decisions equal but where a margin is under
              1e-9 (K3/K4, at most 1 such locus a call; the error kept
              the largest |kernel - plain| of the 0/1 decisions, calls
              with a disagreement counted) or 1e-6 relative
              (K5, at most 1 locus in 1000; times within 1e-5 relative in
              float32); each kernel's device ms a launch (profiler) on the
              last call's inputs, its plain version's ms and its bound;
              K3/K4 also their proposing loci, ns a proposing locus and
              lookahead depth (``chains.chain_depth``), K5 the steps of
              its longest walk; each kernel's last call's inputs tiled to
              10,000 loci (K3's sums scaled to match): held against the
              plain version under the same gates and timed; with
              ``--parent``, the parent's K3/K4/K5 built and timed on the
              same inputs in a process of their own, their K3/K4
              decisions held against this tree's and their K5 walks
              bit-equal to this tree's (all eight outputs).
43. main 23 — main 2's diploid HKY+G4 control file with ``chains = 4`` on
              its 1000 loci through ``cli.main``, on the batched route: K2
              launched 12 x 50 + 4 = 604 times (12 an iteration for all
              four chains, not 48), K1 never; four mcmc files of finite
              samples with theta and tau moving (their mu_bar column is
              nan under ``chains = K``, as ``bpp_tpu`` writes it, and left
              out) and the split-R-hat table; K2 held on the last chain's
              last state;
44. chains-batch — mains 13, 18, 23-29, main 14's geneflow control
              file with chains = 4 on its first 100 loci, main 11's
              BDI fixture (linked-msci thetas) with chains = 4 ("main 11
              x 4"), main 9's WAG file, main 8's partition (20 loci a
              model, no check) and main 15's traits (no check) on their
              first 100 loci and main 5's dated file, each with chains =
              4 ("main 9 x 4", "main 8 x 4", "main 15 x 4", "main 5 x
              4"), per-chain against
              batched in this process from the same states and
              generators, at the control file's seed (windows of 2
              replays, 1 on an MSC-M or MSC-I step, a trace of 1
              iteration; every row's K mcmc files must be byte-equal):
              each
              way's exact device nodes of the captured step, device
              kernels, busy and replayed wall ms an iteration, capture
              seconds and peak MiB, pruning launches a replay; after one
              iteration the
              move statistics, per-locus lnL and state leaves of the two
              ways compared; the batched step's draw sites (K launches
              each); the control file's run at burnin 8, nsample 1 both
              ways, the K mcmc files compared (each way
              ``run_mcmc_multi`` on the graph already captured, the
              files written by ``cli.write_chain_files`` as
              ``cli.main`` writes them; both ways traced in one
              profiler session); main 18's
              batched step under 6,000 device nodes.
              Then K1 over main 13's 2, main 18's 8 and the 4 of mains
              28, 29, 11 x 4, 8 x 4 and 15 x 4 (main 29 and main 8 x 4
              with a per-chain eigensystem) and K2 over
              main 23's 4, float32 and float64 builds: one launch (a grid
              row a chain) bit-equal per (chain, locus) to one-chain
              launches, within the plain versions' gates, and timed
              against one chain's launch.  Mains 24, 25 and 5 x 4
              likewise (K3 / K4 launches a replay compared too), then K4
              over main 24's 4 chains and K3 over main 25's and main 5 x
              4's 4 (the batched step's last
              call's inputs, one eager batched iteration): one launch (a
              block a chain) bit-equal per (chain, locus) to one-chain
              launches, each chain's decisions against the plain version
              (near ties as in ``[chains]``), timed against one chain's
              launch, with the bound over the 4 x 1000 loci.  Then K5
              over the 4 chains of mains 26, 27 and 14 (the batched
              step's last walk, float32 and float64): one launch (a grid
              row a chain) bit-equal per (chain, locus), all eight
              outputs, to one-chain launches, each chain's walks against
              the plain version (ties as in ``[chains]``), timed (float32)
              against one chain's launch, with the bound over the 4 x L
              loci.  Main 9 x 4's 20-state plain pass (no kernel) once
              over the 4 chains' loci bit-equal per (chain, locus,
              pattern) to one call a chain, both timed.
45. main 24 — A10 (``speciesdelimitation = 1 0 2``, ``speciestree = 0``)
              on main 1's 1000 loci with Gamma-Dirichlet locus rates
              (``locusrate = 1 10 10 5``) and ``chains = 4`` through
              ``cli.main`` on the batched route: K1 launched (rj 1 + 8 +
              mu_i 1) x 50 + 4 = 504 times and K4 50 (once an iteration
              for all four chains), K2 and K3 never; four mcmc files of
              finite samples, theta and tau moving, the split-R-hat
              table and the pooled A10 report with each chain's
              P(#species); K1 held on the last chain's last state;
46. main 25 — main 1's data with integrated thetas (``thetaprior =
              invgamma 3 0.06 int``) and ``chains = 4`` on the batched
              route: K1 8 x 50 + 4 = 404, K3 5 x 50 = 250 (the age move's
              2 blocks and 3 SPR rounds, once for all four chains); four
              mcmc files without theta columns, tau moving; K1 held on the
              last chain's last state.
47. main 26 — main 12's control file (1000 loci, routes A B / B A,
              ``wprior = 20 40``, burnin 5, nsample 20) with ``chains =
              4`` through ``cli.main`` on the batched route: K1 8 x 25 +
              4 = 204, K5 3 x 25 = 75 (once a sim-SPR round for all four
              chains); routes and events consistent in every state of
              every chain, events in the chains' last states and
              ``validate_state`` on each; four mcmc files of finite samples
              with theta, tau and the W: columns moving and the
              split-R-hat table; K1 held on the last chain's last state
              and K5 on a sim-SPR move from it;
48. main 27 — A10 x MSC-M: main 26 with ``speciesdelimitation = 1 0 2``
              and ``speciestree = 0``: K1 9 x 25 + 4 = 229 (the rj move's
              pass), K5 75; as main 26, and the pooled A10 report with
              each chain's P(#species).
49. main 28 — main 10's control file (the MSC-I network, 1000 loci,
              ``phiprior = 1 1``, burnin 5, nsample 20) with ``chains =
              4`` through ``cli.main`` on the batched route: K1 11 x 25
              + 4 = 279 (once a pass for the four chains, plus an
              initial state a chain), K2-K5 never; routes consistent in
              every state of every chain and ``validate_state`` on each
              chain's last; four mcmc files of finite samples with
              theta, tau and phi moving in each and the split-R-hat
              table; K1 held on the last chain's last state.
50. main 29 — main 20's control file (GTR+G4, 1000 loci, burnin 8,
              nsample 12) with ``chains = 4`` through ``cli.main`` on the
              batched route, each chain with its own eigensystem: K1 15
              x 20 + 4 = 304, K2-K5 never; four mcmc files of finite
              samples with theta and tau moving in each and the
              split-R-hat table; in every chain the frequencies,
              exchangeabilities and alpha moved and no NaN eigensystem
              accepted; K1 held on the last chain's last state.

Every main path but ``[shard]``'s runs its chunks as replays of one
captured CUDA graph; the launch counts a replay adds are the graph's
captured launches, so the predicted counts hold on either route.  The
graph's warm-up iteration before its capture (one iteration of each
chain, undone) launches the kernels too but is left out of the counts
and of the ``launches`` in the kernels line, as the capture itself is.

Then a ``[time]`` line (the whole script, and the seconds of each group
of phases in the order they ran), one JSON line ``{"kernels": [...]}``
(K1 at JC69, K2 at HKY+G4: the
models of their chains; launches summed over main 1-15, 17-29 and [tools],
errors the largest of every hold; then the float64 builds, with main
16's and both [shard] ranks' launches and the [x64] holds; then K3, K4
and K5 with their mains' launches and ``[chains]``' times), the card's
name and power limit from
nvidia-smi, and the last line ``{"ok": true, "device": {...}}``.  Without
a CUDA device the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

SIM_CTL = """\
seed = 137
seqfile = sim.phy
treefile = sim.tre
Imapfile = sim.Imap.txt
modelparafile = sim.para.txt
species&tree = 4 A B C D
                 4 4 4 4
                ((A #0.01, B #0.01) :0.01 #0.01, (C #0.01, D #0.01) :0.012 #0.01) :0.02 #0.01;
loci&length = {nloci} 500
model = 0
"""

RUN_CTL = """\
seed = 11
seqfile = sim.phy
Imapfile = sim.Imap.txt
jobname = {job}
species&tree = 4 A B C D
                 4 4 4 4
                ((A, B), (C, D));
usedata = 1
nloci = {nloci}
cleandata = 0
thetaprior = 3 0.03
tauprior = 3 0.06
finetune = 1
print = 1 0 0 0
burnin = {burnin}
sampfreq = 1
nsample = {nsample}
{extra}"""

SIM2_CTL = """\
seed = 137
seqfile = sim2.phy
treefile = sim2.tre
Imapfile = sim2.Imap.txt
modelparafile = sim2.para.txt
species&tree = 4 A B C D
                 2 2 2 2
                ((A #0.01, B #0.01) :0.01 #0.01, (C #0.01, D #0.01) :0.012 #0.01) :0.02 #0.01;
diploid = 1 1 1 1
loci&length = {nloci} 500
model = 3
kappa = 2
basefreqs = 0.3 0.2 0.2 0.3
locusrate = 1 5
"""

RUN2_CTL = """\
seed = 11
seqfile = sim2.phy
Imapfile = sim2.Imap.txt
jobname = {job}
species&tree = 4 A B C D
                 2 2 2 2
                ((A, B), (C, D));
phase = 1 1 1 1
usedata = 1
nloci = {nloci}
cleandata = 0
model = HKY
alphaprior = 1 1 4
locusrate = 1 10 10 5 iid
heredity = 1 4 4
thetaprior = 3 0.03
tauprior = 3 0.06
finetune = 1
print = 1 0 0 0
burnin = {burnin}
sampfreq = 1
nsample = {nsample}
{extra}"""

# the new configurations' lines (main 3, main 4, main 5)
RELAXED = "locusrate = 1 10 10 5 iid\nclock = 2 10 100 5 iid G\n"
SIMPLE = "clock = 4 2.0\n"
DATED_RUN = ("thetaprior = invgamma 3 0.06 int\ndatefile = dates.txt\n"
             "locusrate = 3 10 10000\n")
DATED = DATED_RUN + "checkpoint = {ck} 0\n"
CHECKPOINT_AT = 25
A01 = "speciestree = 1 0.5 0.33 0.1 0.2\n"
A11 = ("speciesdelimitation = 1 0 2\nspeciestree = 1\n"
       "speciesmodelprior = 1\n")
TOPO_ITERS = 5
# main 8: the haploid data under a partition of five DNA models in blocks
# of 200 loci, with the runtime check and two loci's gene-tree files
CUSTOM_MODELS = ("JC69", "K80", "HKY", "TN93", "GTR")
CHECK_EVERY = 10
CUSTOM8 = ("model = custom parts.txt\ncheck = {check}\n"
           "printlocus = 2 1 {last}\n")
# main 9: bench.py's amino-acid workload (bench.py _bench_aa)
N_AA_LOCI, AA_SITES = 500, 500
AA_CTL = """\
seed = 11
seqfile = aa.phy
Imapfile = Imap.txt
jobname = out9
species&tree = 4 A B C D
                 4 4 4 4
                ((A, B), (C, D));
usedata = 1
nloci = {nloci}
cleandata = 0
model = WAG
thetaprior = 3 0.03
tauprior = 3 0.06
finetune = 1
print = 1 0 0 0
burnin = {burnin}
sampfreq = 1
nsample = {nsample}
"""

# main 10: the haploid bench shape simulated on an MSC-I network (B
# introgresses into the T lineage through H, phi 0.3); [net]'s diploid
# batch on the same network; main 11: the BDI fixture with linked thetas
SIM10_CTL = """\
seed = 137
seqfile = {prefix}.phy
treefile = {prefix}.tre
Imapfile = {prefix}.Imap.txt
modelparafile = {prefix}.para.txt
species&tree = 4 A B C D
                 {seqs}
                {tree};
loci&length = {nloci} 500
{extra}"""
NET_DIPLOID = ("diploid = 1 1 1 1\nmodel = 3\nkappa = 2\n"
               "basefreqs = 0.3 0.2 0.2 0.3\nlocusrate = 1 5\n")
N_NET_DIPLOID = 200
# [cli]'s linked-inner run takes chains = 4 (the batched route)
CLI_LINKED_CHAINS = 4
BDI_CTL = """\
seed = 7
seqfile = {fix}/bdi_seqs.txt
Imapfile = {fix}/bdi_imap.txt
jobname = {job}
species&tree = 3 A B C
               4 4 2
               (((A,Y[&phi=0.300000])X,(B,X[&phi=0.200000])Y)S, C)R;
usedata = 1
nloci = 30
cleandata = 0
model = JC69
thetaprior = gamma 2 1000
tauprior = gamma 4 100
phiprior = 1 1
finetune = 1
print = 1 0 0 0
burnin = {burnin}
sampfreq = 1
nsample = {nsample}
{extra}"""
# tests/test_msci_create.py's bidirection case and the newick it expects
MSCI_DEFS = """\
tree ((A,B),C);
define T as A,B
define R as A,B,C
bidirection A T, C R as X Y phi=0.2,0.3
"""
MSCI_NEWICK = "(((A,Y[&phi=0.300000])X,B)T,(C,X[&phi=0.200000])Y)R;"

N_LOCI = 1000
BURNIN, NSAMPLE = 10, 40
PASSES_PER_ITER = 8        # age 2 + SPR 3 + tau 2 + mixing 1
# the diploid HKY+G4 chain adds freqs 1 + qrates 1 + alpha 1 + mu_i 1
PASSES_PER_ITER_2 = PASSES_PER_ITER + 4
H_BRANCHES = 7             # species branches of ((A,B),(C,D)): one pass each
PASSES_PER_ITER_3 = PASSES_PER_ITER + H_BRANCHES
PASSES_PER_ITER_4 = PASSES_PER_ITER_2 + H_BRANCHES
PASSES_PER_ITER_5 = PASSES_PER_ITER     # tipdate mubar replaces mixing
# kernels K3-K5 an iteration: K3 under integrated thetas (main 5) once for
# each of the age move's 2 blocks and of 3 SPR rounds; K4 once each for mu_i
# and nu_i under Gamma-Dirichlet priors (main 21); K5 once for each of the
# 3 sim-SPR rounds under migration (mains 12, 14)
K3_PER_ITER_5 = 2 + 3
K4_PER_ITER_21 = 2
K5_PER_ITER_12 = 3
# with SNL on, both species moves are computed and one is kept
PASSES_PER_ITER_6 = PASSES_PER_ITER + 2   # + species SPR + SNL
PASSES_PER_ITER_7 = PASSES_PER_ITER_2 + 3  # + rj + species SPR + SNL
# + freqs 1 + one qrates pass for each slot some model of the partition
# frees (K80 / HKY slot 0, TN93 slots 0-1, GTR all but slot 1: 6 slots)
PASSES_PER_ITER_8 = PASSES_PER_ITER + 1 + 6
N_CHECKS = (BURNIN + NSAMPLE) // CHECK_EVERY   # one K1 pass each
# an MSC-I network's step: age 2 + SPR 3 + one tau pass for each inner
# node (tau_move_net; H - NS - HY = 10 - 4 - 1 = 5 on main 10's network,
# 9 - 3 - 2 = 4 on the BDI network) + mixing 1; the strict clock's
# repath and phi moves run no pass
PASSES_PER_ITER_10 = 2 + 3 + 5 + 1
PASSES_PER_ITER_11 = 2 + 3 + 4 + 1
# main 12: main 1's shape simulated with migration between A and B (M =
# 0.5 each way); the run's routes A -> B and B -> A with a Gamma(20, 40)
# prior on M (mean 0.5, the simulation's rate: a chain of 50 iterations
# from its event-free start holds M there and so carries events); [mig]
# (c): 200 diploid loci simulated likewise; main 13: two chains on main
# 1's data
MAIN1_TREE = ("((A #0.01, B #0.01) :0.01 #0.01, (C #0.01, D #0.01) :0.012 "
              "#0.01) :0.02 #0.01")
MIG_WPRIOR = "wprior = 20 40\n"
N_MIG_DIPLOID = 200
MIG_ITERS = 5
CHAINS = 2
# an MSC-M step under the strict clock: age 2 + sim-SPR 3 + tau 2 +
# mixing 1 (the event-age move runs no pass); under clock = 2 the
# event-age move takes one pass an event slot (ME = max(16, 2 x 16 tips))
# and the branch-rate sweep one a species branch
PASSES_PER_ITER_12 = 2 + 3 + 2 + 1
ME_12 = 32
PASSES_PER_ITER_12C = PASSES_PER_ITER_12 + ME_12 + H_BRANCHES
# main 10 and main 12 run 25 iterations (burnin 5, nsample 20): their
# steps take about a second each, and the script's time is bounded; main
# 11 runs 28 (burnin 8, the fewest with finetune marks)
SHORT_BURNIN, SHORT_NSAMPLE = 5, 20
BDI_BURNIN = 8
# main 14: main 12's data and routes with the geneflow rjMCMC over every
# candidate route (its flip and add/remove run no likelihood pass)
GENEFLOW = "geneflow = 1\n"
# main 15: main 1's data with a trait file (4 species x 20 continuous
# characters, 4 x 50 discrete ones); the trait move runs no pass, each
# check one
TRAITS15 = "traitfile = traits.txt\ncheck = {check}\n"
# [shard]: two ranks on the one card, each its half of main 16's loci
SHARD_RANKS = 2
SHARD_TIMEOUT = 400
# [tools]: --bfdriver's quadrature points, and the smallest beta's run
BF_POINTS = 4
BF_BURNIN, BF_NSAMPLE = 2, 8
# the haploid data: one simulation at bench.py's scale target (bench.py
# _ensure_sim); main 17 runs all of it, 10 iterations
N_LOCI_10K = 10000
BURNIN_17, NSAMPLE_17 = 2, 8
# main 18: bench.py's _bench_chains8 shape
CHAINS_18, N_LOCI_18 = 8, 100
CHAINS_23 = 4
# main 24: A10 with Gamma-Dirichlet locus rates on main 1's data, main 25:
# integrated thetas, 4 chains each on the batched route.  Main 24's step
# adds the rj move's pass and mu_i's (the strict clock's rate scales the
# likelihood) to the base moves' 8, and runs K4 once (mu_i); main 25's
# runs K3 as main 5's does (the age move's 2 blocks, 3 SPR rounds)
CHAINS_24 = CHAINS_25 = 4
A10_24 = ("speciesdelimitation = 1 0 2\nspeciestree = 0\n"
          "locusrate = 1 10 10 5\nchains = {k}\n")
INT_25 = "thetaprior = invgamma 3 0.06 int\nchains = {k}\n"
PASSES_PER_ITER_24 = PASSES_PER_ITER + 2
K4_PER_ITER_24 = 1
# main 26: main 12's control file (its data, routes and wprior, burnin 5,
# nsample 20) with chains = 4 on the batched route: K1 once a pass for the
# four chains (8 an iteration) + one initial state a chain, K5 once a
# sim-SPR round for the four (3 an iteration); main 27: A10 x MSC-M on it
# (speciesdelimitation = 1 0 2, speciestree = 0), whose rj move adds a pass
CHAINS_26 = CHAINS_27 = 4
A10_27 = "speciesdelimitation = 1 0 2\nspeciestree = 0\n"
PASSES_PER_ITER_27 = PASSES_PER_ITER_12 + 1
# [chains-batch]'s geneflow case: main 14's control file with chains = 4
# on the first 100 loci
CHAINS_14B, N_LOCI_14B = 4, 100
# main 28: main 10's control file (the MSC-I network, 1000 loci, burnin 5,
# nsample 20) with chains = 4 on the batched route: K1 once a pass for the
# four chains (11 an iteration) + one initial state a chain; [chains-
# batch]'s BDI case: main 11's control file (linked-msci) with chains = 4
CHAINS_28 = CHAINS_11B = 4
# main 29: main 20's control file (GTR+G4, 1000 loci, burnin 8, nsample
# 12) with chains = 4 on the batched route, each chain its own
# eigensystem: K1 once a pass for the four chains (15 an iteration) + one
# initial state a chain
CHAINS_29 = 4
# [chains-batch]'s rows of the configurations that join the batched route
# with main 29: main 9's WAG file (the 20-state plain pass), main 8's
# five-model partition (20 loci a model, no check) and main 15's traits
# (no check), each on its first 100 loci, and main 5's dated file with
# integrated thetas (K3 over the chains), each with chains = 4
CHAINS_B = 4
N_LOCI_B = 100
# mains 18-22: 20 iterations, burnin 8 (the fewest with finetune marks)
NEW_BURNIN, NEW_NSAMPLE = 8, 12
NEW_CHECKS = (NEW_BURNIN + NEW_NSAMPLE) // CHECK_EVERY
GAMMA4 = "alphaprior = 1 1 4\n"
# + freqs 1 + one qrates pass a free rate (TN93 2, GTR 5) + alpha 1
PASSES_PER_ITER_19 = PASSES_PER_ITER + 1 + 2 + 1
PASSES_PER_ITER_20 = PASSES_PER_ITER + 1 + 5 + 1
# main 21: main 2's move set (mu_i changes the likelihood under clock 3,
# whose root rate is mu_i) + the branch sweep, which skips the root
CORR21 = ("locusrate = 1 10 10 5\nclock = 3 10 100 5 gdir LN\n"
          "check = {check}\n")
PASSES_PER_ITER_21 = PASSES_PER_ITER_2 + H_BRANCHES - 1
# main 22: the species move 1 + the IID branch sweep (root included)
CLOCK2 = "clock = 2 10 100 5 iid G\n"
PASSES_PER_ITER_22 = PASSES_PER_ITER_6 + H_BRANCHES
TOL_SITE = 2e-3           # per-pattern |dlnL| of K2, float32
TOL_LNL = 0.02            # f32 bound of tests/test_kernel_consistency.py
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS = 67e12          # H100 SXM, float32 outside the tensor cores
F64_FLOPS = 34e12          # H100 SXM, float64 outside the tensor cores
TOL_LNL_F64 = 1e-6         # per-locus |dlnL| of the float64 builds
TOL_SITE_F64 = 1e-8        # per-pattern |dlnL| of K2's float64 build
# (model, gamma categories): the four families K1 special-cases
MODELS = [("JC69", 1), ("HKY", 4), ("TN93", 1), ("GTR", 4)]
# the category counts of the [x64] diagnosis and holds
X64_CATS = (1, 2, 4, 8)
# operations per child contraction of one (site, category), by family
CONTRACT_OPS = {"jc69": 14, "tn93": 27, "gtr": 64}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=30, warmup=3):
    """Median milliseconds of ``fn()`` on the card (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def pass_args(state, subst, ctx, dtype):
    """Positional arguments of site_logl_packed for one state (all but
    the last are site_logl_fels's)."""
    import torch

    from bpp_tpu_torch.trees.gtree import inner_order
    gt = state.gt
    rk = torch.cat([subst.rates, subst.kappa1[:, None],
                    subst.kappa2[:, None]], dim=1)
    return (inner_order(gt), gt.left, gt.right, gt.parent, ctx.n_seq,
            gt.age.to(dtype), subst.mu, rk, subst.freqs, subst.eigw,
            subst.eigT, subst.eigTi, ctx.tip_partials.to(dtype),
            ctx.weights.to(dtype))


def bound_ms(batch, model_name, n_cats, per_pattern=False, rb=4,
             flops=F32_FLOPS):
    """Least time the card could take for one pass on this run's data:
    the larger of the bytes it must move over the HBM rate and the
    operations it must do over the rate of the values' type (``rb``
    bytes a value: 4, float32 at ``F32_FLOPS``; 8, float64 at
    ``F64_FLOPS``).  Only real patterns, real
    tips and real levels count, and of the tree only what the kernels
    read: the schedule, the children and the ages (the parent of a
    scheduled child is its level's node, so ``parent`` is not read).  K1
    reads the pattern weights and writes
    one value per locus; K2 (``per_pattern``) reads no weights, reads the
    pattern counts and writes the whole ``[L, S]`` output."""
    import numpy as np

    from bpp_tpu_torch.config import SubstModel
    from bpp_tpu_torch.core.efactors import _KFAC, model_family
    fam = model_family(SubstModel[model_name])
    m = np.asarray(batch.locus_mask)
    ns = np.asarray(batch.n_seq)[m].astype(np.float64)
    npat = np.asarray(batch.n_pat)[m].astype(np.float64)
    L = float(m.sum())
    C, K = n_cats, _KFAC[fam]
    nbytes = (4.0 * rb * (ns * npat).sum()        # tip partials (x 4)
              + 8.0 * 3 * (ns - 1).sum()           # order, left, right
              + rb * (2 * ns - 1).sum()            # ages
              + rb * L * (4 + 1 + C + 2))          # freqs, mu, rates, kappas
    if per_pattern:
        nbytes += 8.0 * L + rb * L * batch.max_patterns    # n_pat; [L, S] out
    else:
        nbytes += rb * npat.sum() + rb * L         # weights; [L] out
    if fam == "gtr":
        nbytes += rb * L * (4 + 32)                # eigensystem
    site_levels = (npat * (ns - 1)).sum()
    ops = (site_levels * (C * (2 * CONTRACT_OPS[fam] + 4 + 4 + 4) + 2)
           + npat.sum() * (C * 8 + (2 if per_pattern else 4))
           + K * C * (2 * ns - 1).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


# uncounted kernels (``torch.cuda._sleep``'s spin kernel) that open and
# close every profiler window: a trace loses the first kernels launched
# after it starts (0-7 of an eager MSC-M step on one host, some 50 on a
# slower one; none once the window opened with these), so they take the
# loss in place of the traced work
TRACE_PAD = 256
TRACE_PAD_KERNEL = "spin_kernel"


def device_kernels(fn):
    """Run ``fn()`` under torch.profiler, between ``TRACE_PAD`` spin
    kernels on either side; (name, microseconds) of each device (CUDA)
    event of ``fn`` in the order they started, read from the trace's
    raw events: the events ``prof.events()`` would keep, without building
    its tree of host and device events, which takes the host seconds a
    10,000 events.  Host and device activity are traced: with the device
    activity alone a trace of an eager step of 40,000 kernels ran twice as
    fast but now and then dropped dozens of its kernels."""
    return device_kernels_each(fn)[0]


def device_kernels_each(*fns):
    """:func:`device_kernels` of each of ``fns``, run one after another
    in one profiler session with ``TRACE_PAD`` spin kernels between them:
    a list of each one's events (a session costs the host seconds to
    open and read)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACE_PAD):
            torch.cuda._sleep(50)
        for fn in fns:
            fn()
            for _ in range(TRACE_PAD):
                torch.cuda._sleep(50)
        torch.cuda.synchronize()
    raw = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    hidden = bool(raw) and hasattr(raw[0], "is_hidden_event")
    events = []
    for e in raw:
        if e.device_type() == cuda and not (hidden and e.is_hidden_event()):
            t0 = e.start_ns()
            events.append((t0, e.name(), (e.end_ns() - t0) / 1e3))
    events.sort()
    if len(fns) == 1:
        return [[(name, us) for _, name, us in events
                 if TRACE_PAD_KERNEL not in name]]
    # each fn's events lie between two runs of spin kernels
    parts, pad = [], True
    for _, name, us in events:
        if TRACE_PAD_KERNEL in name:
            pad = True
        else:
            if pad:
                parts.append([])
                pad = False
            parts[-1].append((name, us))
    if len(parts) != len(fns):
        raise AssertionError(f"a profiler session of {len(fns)} parts "
                             f"read {len(parts)} between its spin kernels")
    return parts


def kernel_device_ms(launch, kernel_name, reps=30, windows=3, attempts=10):
    """Median device time of one launch of the named kernel, from profiler
    traces: the median over ``windows`` traces of each trace's median over
    its last ``reps`` launches.  A trace may miss launches (a run of the
    first ones, or now and then all of a short window), and now and then
    one reads every launch at half its time: so each trace launches the
    kernel ``2 * reps`` times and counts only if it holds ``reps`` of them,
    one that holds fewer is taken again (``attempts`` traces in all), and
    the median over the windows drops the odd one out.  If no ``windows``
    traces of ``attempts`` are whole, the time is that of ``reps`` launches
    back to back between two CUDA events, a launch's share, and the line
    printed says so."""
    import torch

    def run():
        for _ in range(2 * reps):
            launch()
    medians, held = [], []
    for _ in range(attempts):
        times = [us / 1e3 for name, us in device_kernels(run)
                 if kernel_name in name]
        held.append(len(times))
        if reps <= len(times) <= 2 * reps:
            medians.append(statistics.median(times[-reps:]))
            if len(medians) == windows:
                return statistics.median(medians)
    ms = cuda_ms(lambda: [launch() for _ in range(reps)], reps=10) / reps
    print(f"[timing] profiler held {kernel_name}'s launches in {len(medians)}"
          f" of {attempts} traces ({windows} needed; launches held of "
          f"{2 * reps}: {held}): timed with CUDA events instead, "
          f"{ms:.4f} ms a launch over {reps} back to back")
    torch.cuda.synchronize()
    return ms


def profile_step(eng, state, step_ms, smi, kernel_name, label, passes,
                 iters=3, attempts=10, it=None):
    """Device time per iteration from a profiler trace: kernels launched,
    busy milliseconds (all kernels, and the pruning kernel's) and the idle
    share of the untraced wall time per iteration.  A trace that misses
    some of the ``passes`` pruning launches per iteration has missed other
    kernels too and is taken again; if none of the ``attempts`` is whole,
    the run fails, since its kernel count would read low.  A step with no
    pruning kernel (``kernel_name`` None: the 20-state pass) is taken
    once.  ``it`` (the iteration before the traced ones) takes the sample
    records the engine was asked for, as a run does."""
    for _ in range(attempts):
        kern = device_kernels(lambda: eng.chunk_step(state, iters, it))
        if not kern:
            raise AssertionError("no device events in the profiler trace")
        if kernel_name is None:
            mine = []
            break
        mine = [k for k in kern if kernel_name in k[0]]
        if len(mine) == passes * iters:
            break
    else:
        raise AssertionError(
            f"{label}: no profiler trace of {attempts} held all "
            f"{passes * iters} launches of {kernel_name} (the last held "
            f"{len(mine)})")
    busy = sum(us for _, us in kern) / 1e3 / iters
    k_ms = sum(us for _, us in mine) / 1e3 / iters
    pruning = (f"{kernel_name} {k_ms:.3f} in {len(mine) / iters:.0f} "
               "launches" if kernel_name else "no pruning kernel")
    print(f"[profile] {label}: {len(kern) / iters:.0f} device kernels/iter "
          f"| device busy {busy:.3f} ms/iter ({pruning}) | wall "
          f"{step_ms:.2f} ms/iter untraced | idle share "
          f"{1 - busy / step_ms:.3f} | {smi}")
    return len(kern) / iters


def step_ms(eng, state, iters=10, it=None):
    """Wall milliseconds an iteration of ``iters``, synchronised."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.chunk_step(state, iters, it)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def warm_engine(run, dev, warm=5, timed=10):
    """(engine, state after ``warm`` + ``timed`` iterations, iterations/s
    over the ``timed`` ones)."""
    import torch

    from bpp_tpu_torch.mcmc.driver import Engine
    eng = Engine(run, seed=1, device=dev)
    state = eng.init_state()
    state, _ = eng.chunk_step(state, warm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = eng.chunk_step(state, timed)
    torch.cuda.synchronize()
    return eng, state, timed / (time.perf_counter() - t0)


def wall_ms(fn, reps=5):
    """Median host milliseconds of ``fn()``, synchronised (a move's cost
    as the step sees it: launches, device time and host work)."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def check_chain_output(job, nsample, moving, figtree=True, every=True,
                       skip=()):
    """mcmc.txt of ``job``: ``nsample`` finite rows whose ``moving``
    columns moved (with ``every`` False: some column of each prefix in
    ``moving``); the summary and (``figtree``: not on a network) the tree
    file exist.  The columns ``skip`` names are left out (nan by
    design).  Returns the samples."""
    import numpy as np
    with open(f"{job}.mcmc.txt") as f:
        header = f.readline().split()
        data = np.loadtxt(f, ndmin=2)
    if data.shape != (nsample, len(header)):
        raise AssertionError(f"{job}.mcmc.txt shape {data.shape}")
    keep = [j for j, col in enumerate(header) if col not in skip]
    if not np.isfinite(data[:, keep]).all():
        raise AssertionError(f"non-finite values in {job}.mcmc.txt")
    sd = data.std(axis=0)
    seen, moved = set(), set()
    for j, col in enumerate(header):
        for prefix in moving:
            if col.startswith(prefix):
                seen.add(prefix)
                if sd[j] > 0:
                    moved.add(prefix)
                elif every:
                    raise AssertionError(f"{job}: column {col} never moved")
    if seen != set(moving):
        raise AssertionError(f"{job}: no column of {set(moving) - seen}")
    if moved != seen:
        raise AssertionError(f"{job}: no column of {seen - moved} moved")
    for fn in (f"{job}.txt", f"{job}.FigTree.tre")[:1 + figtree]:
        if not os.path.getsize(fn):
            raise AssertionError(f"{fn} is empty")
    if not figtree and os.path.exists(f"{job}.FigTree.tre"):
        raise AssertionError(f"{job}.FigTree.tre written for a network")
    return data


def run_chain(argv, job, iters, expect, moving, label, smi, figtree=True,
              nsample=NSAMPLE, clv_store="shared", every=True,
              chains=(0, 0, 0), skip=()):
    """Drive one chain through the CLI (``argv``) with every launch count
    (those of the float64 builds too) set to 0 just before and read just
    after; ``expect`` = (K1, K2) launches over ``iters`` iterations and
    the initial state, ``chains`` = (K3, K4, K5) launches (recorded in
    ``CHAIN_LAUNCHES``).  ``moving`` names the mcmc.txt columns that must
    move (``every``, ``skip``: see :func:`check_chain_output`), or is
    "A01" / "A11" for a run that writes species trees; the file holds
    ``nsample`` samples.  ``clv_store`` is the store the
    wrappers pick for the run: shared memory at 16 tips, but the device
    scratch for the float64 build above ``pack.F64_SHARED_MAX_CATS``
    categories.  The peak device memory of the run, from a reset just
    before it, goes on its line and into ``PEAKS``."""
    import torch

    from bpp_tpu_torch import cli
    from bpp_tpu_torch.core import chains as chain_kernels
    from bpp_tpu_torch.core import fels, pack
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 2**20
    torch.cuda.reset_peak_memory_stats()
    pack.LAUNCHES = fels.LAUNCHES = 0
    pack.LAUNCHES_F64 = fels.LAUNCHES_F64 = 0
    chain_kernels.set_launch_counts((0, 0, 0))
    t0 = time.perf_counter()
    rc = cli.main(argv + ["--quiet"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = (pack.LAUNCHES, fels.LAUNCHES)
    got_chains = chain_kernels.launch_counts()
    CHAIN_LAUNCHES.append((label, got_chains))
    peak = torch.cuda.max_memory_allocated() / 2**20
    PEAKS.append((label, peak, held))
    if rc != 0:
        raise AssertionError(f"cli.main returned {rc}")
    if got != expect:
        raise AssertionError(
            f"{label}: (K1, K2) launched {got} times on the main path, "
            f"expected {expect} over {iters} iterations + the initial state")
    if got_chains != tuple(chains):
        raise AssertionError(
            f"{label}: (K3, K4, K5) launched {got_chains} times on the main "
            f"path, expected {tuple(chains)} over {iters} iterations")
    store = pack.CLV_STORE if got[0] else fels.CLV_STORE
    if sum(got) and store != clv_store:
        raise AssertionError(f"{label}: the main path ran the {store} CLV "
                             f"store; at 16 tips the wrappers pick the "
                             f"{clv_store} one")
    if moving in ("A01", "A11"):
        result = check_species_output(job, nsample, moving)
    else:
        data = check_chain_output(job, nsample, moving, figtree, every, skip)
        result = f"mean lnL {data[:, -1].mean():.3f}"
    print(f"[{label}] cli {' '.join(argv)}: {iters} iterations, wall "
          f"{wall:.1f} "
          f"s (load + init + chain + summary), {iters / wall:.2f} iters/s "
          f"overall | K1 launches {got[0]} | K2 launches {got[1]} (float64 "
          f"build {pack.LAUNCHES_F64} / {fels.LAUNCHES_F64}) | K3 / K4 / K5 "
          f"launches {' / '.join(map(str, got_chains))} | CLV store "
          f"{store if sum(got) else '-'} | peak device memory {peak:.1f} "
          f"MiB ({held:.1f} held before the run) | {result} | {smi}")
    return got


# (label, peak MiB, MiB held before) of every run_chain and [shard] rank 0
PEAKS = []
# (label, (K3, K4, K5) launches) of every run_chain
CHAIN_LAUNCHES = []


def _prob_rows(lines, header):
    """The rows of the probability table under the line whose words are
    ``header``, up to a blank line."""
    i = next(k for k, ln in enumerate(lines) if ln.split() == header)
    rows = []
    for ln in lines[i + 1:]:
        if not ln.strip() or ln.strip().startswith("..."):
            break
        rows.append(ln.split())
    return rows


def check_species_output(job, nsample, method):
    """mcmc.txt of an A01/A11 run: ``nsample`` species trees in newick;
    the report's probability tables (topologies, or delimited trees and
    species counts) sum to 1.  Returns a line on the posterior."""
    from bpp_tpu_torch.io.newick import parse_newick
    with open(f"{job}.mcmc.txt") as f:
        trees = [ln.strip() for ln in f if ln.strip()]
    if len(trees) != nsample:
        raise AssertionError(f"{job}.mcmc.txt holds {len(trees)} trees, "
                             f"expected {nsample}")
    for t in trees:
        parse_newick(t)
    with open(f"{job}.txt") as f:
        lines = f.read().splitlines()
    tables = ([["P", "cum", "tree"]] if method == "A01" else
              [["P", "cum", "delimited", "tree"], ["P", "#species"]])
    first = None
    for header in tables:
        rows = _prob_rows(lines, header)
        total = sum(float(r[0]) for r in rows)
        if not rows or abs(total - 1.0) > 1e-4:
            raise AssertionError(f"{job}.txt: the {' '.join(header)} table "
                                 f"sums to {total} over {len(rows)} rows")
        first = first or f"{len(rows)} rows, top {rows[0][0]} {rows[0][-1]}"
    return f"{nsample} species trees | {method} report {first}"


class MoveTally:
    """While active, counts the species moves' proposals (by name) and,
    with ``record``, their acceptances (one host read a move), keeping
    each gene-tree batch the pruning kernel was launched on inside a move
    and the gene trees after each accepted move."""

    MOVES = (("stree_moves", "species_spr_move"),
             ("stree_moves", "snl_move"), ("rj_moves", "rj_move"))

    def __init__(self, record=False, moves=MOVES, accepted=True):
        self.record = record
        self.moves = moves
        self.accepted = accepted     # keep the trees after accepted moves
        self.counts = {name: [0, 0] for _, name in moves}
        self.trees = []          # (label, GTrees)
        self._inside = None
        self._saved = []

    def __enter__(self):
        from bpp_tpu_torch.mcmc import (
            mig_moves, rj_moves, stree_moves, trait_moves,
        )
        from bpp_tpu_torch.mcmc import state as state_mod
        mods = {"stree_moves": stree_moves, "rj_moves": rj_moves,
                "mig_moves": mig_moves, "trait_moves": trait_moves}
        for mod_name, name in self.moves:
            self._patch(mods[mod_name], name, self._move)
        for name in ("site_logl_packed", "site_logl_fels"):
            self._patch(state_mod, name, self._pass)
        return self

    def __exit__(self, *exc):
        for mod, name, orig in reversed(self._saved):
            setattr(mod, name, orig)

    def _patch(self, mod, name, wrap):
        orig = getattr(mod, name)
        self._saved.append((mod, name, orig))
        setattr(mod, name, wrap(name, orig))

    def _move(self, name, fn):
        def move(*args, **kw):
            self._inside = name
            try:
                state, (prop, acc) = fn(*args, **kw)
            finally:
                self._inside = None
            self.counts[name][0] += 1
            if self.record and bool(acc):
                self.counts[name][1] += 1
                if self.accepted:
                    self.trees.append((f"{name} accepted", state.gt))
            return state, (prop, acc)
        return move

    def _pass(self, name, fn):
        def wrapper(*args, **kw):
            if self.record and self._inside:
                from bpp_tpu_torch.trees.gtree import GTrees
                self.trees.append((f"{self._inside} proposal", GTrees(
                    *(x.clone() for x in (args[1], args[2], args[3],
                                          args[5])))))
            return fn(*args, **kw)
        return wrapper


class MoveStats:
    """While active, the move statistics ``stats`` [N_MOVES, 2]
    (proposed, accepted) summed over every chunk an engine runs, and the
    iterations ``iters`` those chunks ran: what a move did on either
    route (a replayed graph makes no Python call a move could count)."""

    def __enter__(self):
        import numpy as np

        from bpp_tpu_torch.mcmc.driver import Engine
        from bpp_tpu_torch.mcmc.state import N_MOVES
        self.stats = np.zeros((N_MOVES, 2), np.int64)
        self.iters = 0
        self._orig = orig = Engine._chunk
        tally = self

        def chunk(eng, state, n, it=None):
            out = orig(eng, state, n, it)
            tally.stats += out[1].cpu().numpy()
            tally.iters += n
            return out

        Engine._chunk = chunk
        return self

    def __exit__(self, *exc):
        from bpp_tpu_torch.mcmc.driver import Engine
        Engine._chunk = self._orig


def time_moves(eng, state, dev, smi):
    """``[moves]``: wall time of each new move on the diploid chain's
    state, and of GTR's eigendecomposition and the Gamma quantiles."""
    import torch

    from bpp_tpu_torch.config import SubstModel
    from bpp_tpu_torch.core.gammarates import discrete_gamma_rates
    from bpp_tpu_torch.core.pmatrix import gtr_eigen
    from bpp_tpu_torch.mcmc import clock_moves, subst_moves
    from bpp_tpu_torch.testing import fixed_subst
    ctx, cfg, gen = eng.ctx, eng.cfg, eng.gen
    L = state.gt.n_loci
    rows = []
    for name, fn in (("heredity", subst_moves.heredity_move),
                     ("freqs", subst_moves.freqs_move),
                     ("qrates(HKY)", subst_moves.qrates_move),
                     ("alpha", subst_moves.alpha_move),
                     ("mu_i(hierarchical)", clock_moves.mui_move),
                     ("mubar", clock_moves.mubar_move)):
        rows.append((name, wall_ms(lambda: fn(ctx, cfg, state, gen))))
    # the Gamma-Dirichlet prior's serial accept chain: kernel K4
    cfg0 = cfg.replace(locusrate_prior=0)
    rows.append(("mu_i(gamma-dirichlet, K4)", wall_ms(
        lambda: clock_moves.mui_move(ctx, cfg0, state, gen))))
    # the Dirichlet prior's compensating pairs
    rows.append(("locusrate(dirichlet pairs)", wall_ms(
        lambda: subst_moves.locusrate_move(ctx, cfg, state, gen))))
    # GTR: 5 likelihood passes, each with a batched eigendecomposition
    cfg_g = cfg.replace(model=SubstModel.GTR)
    _, s_g = fixed_subst("GTR", 4, L, torch.float32, dev)
    s_g = s_g._replace(mu=state.subst.mu, heredity=state.subst.heredity)
    from bpp_tpu_torch.mcmc.state import make_logl_fn
    st_g = state._replace(subst=s_g, logl=make_logl_fn(ctx, cfg_g)(
        state.gt, s_g, state.sp, state.clock))
    rows.append(("qrates(GTR, 5 passes)", wall_ms(
        lambda: subst_moves.qrates_move(ctx, cfg_g, st_g, gen))))
    rows.append(("gtr_eigen[L]", cuda_ms(
        lambda: gtr_eigen(s_g.freqs, s_g.qrates), reps=10)))
    rows.append(("gtr_eigen[L] (eigh_jacobi)", cuda_ms(
        lambda: gtr_eigen(s_g.freqs, s_g.qrates, jacobi=True), reps=10)))
    rows.append(("discrete_gamma_rates[L,4]", cuda_ms(
        lambda: discrete_gamma_rates(state.subst.alpha, 4), reps=10)))
    print("[moves] wall ms per call at " + f"{L} loci: "
          + " | ".join(f"{n} {t:.2f}" for n, t in rows) + f" | {smi}")


def hold_kernel(label, kernel_name, mod, state, ctx, batch, dev, smi,
                got_want, make_args, wrapper, plain, per_pattern):
    """Hold one kernel against its plain version on the four model
    families, under both CLV stores, and time it; returns ({model: max
    per-locus err over both stores}, {model: (device ms, plain ms, bound
    ms, bound by)}).

    ``got_want(a32, a64, kw, kkw)`` gives the kernel's per-locus lnL in
    float32 inputs, the plain version's in float64 and the per-pattern
    maximum difference (or None); ``make_args(a32, kw, kkw)`` prepares one
    bare launch of ``mod`` (``core.pack`` or ``core.fels``); ``wrapper`` /
    ``plain`` run one whole float32 pass.  ``kw`` holds the model, ``kkw``
    what only the kernel's wrapper takes (unit table, store, threads)."""
    import numpy as np
    import torch

    from bpp_tpu_torch.testing import fixed_subst
    mask = torch.as_tensor(np.asarray(batch.locus_mask), device=dev)
    L = batch.n_loci
    errs, rows = {}, {}
    for model_name, n_cats in MODELS:
        model, s32 = fixed_subst(model_name, n_cats, L, torch.float32, dev)
        _, s64 = fixed_subst(model_name, n_cats, L, torch.float64, dev)
        a32 = pass_args(state, s32, ctx, torch.float32)
        a64 = pass_args(state, s64, ctx, torch.float64)
        kw = dict(model=model, n_cats=n_cats)
        err_of = {}
        for store in (None, "global"):
            kkw = dict(units=ctx.units, clv_store=store)
            got, want, site_err = got_want(a32, a64, kw, kkw)
            torch.cuda.synchronize()
            ran = mod.CLV_STORE
            if ran != (store or "shared"):
                raise AssertionError(
                    f"{label} {model_name}: asked for the {store or 'default'}"
                    f" store, the {ran} store ran")
            if not bool(torch.isfinite(got[mask]).all()):
                raise AssertionError(f"{label} {model_name}: non-finite lnL")
            err = float((got - want)[mask].abs().max())
            err_of[ran] = (err, site_err)
            if not err < TOL_LNL:
                raise AssertionError(
                    f"{label} {model_name} ({ran} store): kernel and plain "
                    f"version differ by {err} lnL > {TOL_LNL}")
            if site_err is not None and not site_err < TOL_SITE:
                raise AssertionError(
                    f"{label} {model_name} ({ran} store): per-pattern "
                    f"difference {site_err} > {TOL_SITE}")
        errs[model_name] = max(e for e, _ in err_of.values())

        def timed(**kkw):
            targs = make_args(a32, kw, dict(units=ctx.units, **kkw))
            return targs.plan, kernel_device_ms(lambda: mod.launch(targs),
                                                kernel_name, reps=20)

        # two launches on the same inputs are bit-equal, and so are the
        # two stores: they differ in where the CLVs wait, not in the
        # arithmetic
        kargs = make_args(a32, kw, dict(units=ctx.units))
        plan = kargs.plan
        first = mod.launch(kargs).clone()
        if not torch.equal(first, mod.launch(kargs)):
            raise AssertionError(f"{label} {model_name}: two launches on "
                                 "the same inputs differ")
        gargs = make_args(a32, kw, dict(units=ctx.units, clv_store="global"))
        if not torch.equal(first, mod.launch(gargs)):
            raise AssertionError(f"{label} {model_name}: the global store "
                                 "differs from the shared one")
        gplan, gms = timed(clv_store="global")
        ms = timed()[1]
        launch_ms = cuda_ms(lambda: mod.launch(kargs))
        kkw = dict(units=ctx.units)
        wrap = cuda_ms(lambda: wrapper(a32, kw, kkw))
        plain_ms = cuda_ms(lambda: plain(a32, kw), reps=20)
        bms, by = bound_ms(batch, model_name, n_cats, per_pattern)
        rows[model_name] = (ms, plain_ms, bms, by)
        err, site_err = err_of["shared"]
        gerr, gsite = err_of["global"]
        site = "" if site_err is None else (
            f" | max per-pattern |dlnL| {site_err:.3e} / {gsite:.3e} (tol "
            f"{TOL_SITE})")
        print(f"[{label}] {model_name}+C{n_cats}: max per-locus |dlnL| "
              f"shared / global store {err:.3e} / {gerr:.3e} (tol "
              f"{TOL_LNL}){site} | device {ms:.4f} ms ({plan.clv_store} "
              f"store, {plan.threads} threads, {plan.shared_bytes} B shared "
              f"a block) | global store {gms:.4f} ms ({gplan.threads} threads, "
              f"{gplan.shared_bytes} B) | stores and repeat launch bit-equal "
              f"| one launch {launch_ms:.4f} ms | wrapper {wrap:.4f} ms/pass "
              f"| plain {plain_ms:.4f} ms/pass | bound {bms:.5f} ms ({by}) | "
              f"{smi}")
    return errs, rows


def relaxed_blen(eng, state, dtype):
    """The relaxed-clock branch lengths ``[L, N]`` of ``state`` in
    ``dtype``: what the engine hands the kernels as ``blen``."""
    from bpp_tpu_torch.config import Clock
    from bpp_tpu_torch.core import felsenstein as fe
    from bpp_tpu_torch.trees.gtree import assign_populations
    gt = state.gt._replace(age=state.gt.age.to(dtype))
    sp = state.sp._replace(tau=state.sp.tau.to(dtype))
    brate = state.clock.brate.to(dtype)
    if eng.cfg.clock == Clock.SIMPLE:
        brate = brate * state.subst.mu.to(dtype)[:, None]
    if state.mig is not None:
        # MSC-M: the sub-edge sweep through the migration events
        from bpp_tpu_torch.trees import migration as mg
        mig = state.mig._replace(time=state.mig.time.to(dtype))
        pops = mg.assign_populations_mig(gt, sp, eng.ctx.tip_pop, mig,
                                         eng.ctx.n_seq)
        return mg.relaxed_branch_lengths_mig(gt, sp, mig, pops,
                                             eng.ctx.n_seq, brate)
    pops = assign_populations(gt, sp, eng.ctx.tip_pop)
    return fe.relaxed_branch_lengths(gt, sp, pops, brate)


def fixed_cases(L, dev):
    """(label, model, categories, float32 state, float64 state) of the four
    model families K1 and K2 special-case, with fixed parameters."""
    import torch

    from bpp_tpu_torch.testing import fixed_subst
    cases = []
    for model_name, n_cats in MODELS:
        model, s32 = fixed_subst(model_name, n_cats, L, torch.float32, dev)
        _, s64 = fixed_subst(model_name, n_cats, L, torch.float64, dev)
        cases.append((f"{model_name}+G{n_cats}" if n_cats > 1
                      else model_name, model, n_cats, s32, s64))
    return cases


def own_cases(eng, state):
    """The one case of ``state``'s own substitution parameters (under
    ``model = custom`` each locus's model): their kappas and eigensystems
    computed in float32 and in float64."""
    import torch

    from bpp_tpu_torch.config import SubstModel
    from bpp_tpu_torch.mcmc import subst_moves
    from bpp_tpu_torch.mcmc.state import refresh_eigen
    model, cm = eng.cfg.model, eng.ctx.custom

    def subst(dtype):
        s = type(state.subst)(*(x.to(dtype) for x in state.subst))
        s = subst_moves._derive_kappas(s, model, cm)
        s = refresh_eigen(s, model, cm)
        return type(s)(*(x.contiguous() for x in s))

    n_cats = state.subst.rates.shape[1]
    name = (f"partition {'/'.join(CUSTOM_MODELS)}"
            if model == SubstModel.CUSTOM else f"{model.name} (own)")
    return [(name + (f"+G{n_cats}" if n_cats > 1 else ""), model, n_cats,
             subst(torch.float32), subst(torch.float64))]


def hold_given(label, eng, state, smi, blen_of=None, report=True,
               mask=None, cases=None, tag="given"):
    """``[given]``: the kernel of ``eng``'s batch (K1, or K2 and
    ``reduce_root`` with a diploid map) against its float64 plain version
    on ``state``'s gene trees, for each of ``cases`` (default: the four
    model families of :func:`fixed_cases`) under both CLV stores.
    ``blen_of(dtype)`` gives the branch lengths both get (None: the ages,
    dated tips included); ``mask`` [L] bool narrows the loci compared
    (default: the real loci).  Returns (max per-locus |dlnL|, max
    per-pattern |dlnL| or None)."""
    import torch

    from bpp_tpu_torch.core import fels, pack
    from bpp_tpu_torch.core import felsenstein as fe
    ctx = eng.ctx
    L = state.gt.n_loci
    k2 = ctx.res_map is not None
    mod = fels if k2 else pack
    b32 = None if blen_of is None else blen_of(torch.float32).contiguous()
    b64 = None if blen_of is None else blen_of(torch.float64)
    w64 = ctx.weights.double()
    worst, site_worst = 0.0, 0.0
    if cases is None:
        cases = fixed_cases(L, ctx.weights.device)
    for name, model, n_cats, s32, s64 in cases:
        a32 = pass_args(state, s32, ctx, torch.float32)
        a64 = pass_args(state, s64, ctx, torch.float64)
        kw = dict(model=model, n_cats=n_cats)
        for store in ("shared", "global"):
            if k2:
                got_s = fels.site_logl_fels(
                    *a32[:-1], blen=b32, n_pat=ctx.n_pat, units=ctx.units,
                    clv_store=store, **kw).double()
                want_s = fels.site_logl_fels_ref(*a64[:-1], blen=b64,
                                                 n_pat=ctx.n_pat, **kw)
                got = fe.reduce_root(got_s, w64, ctx.res_map, ctx.res_count)
                want = fe.reduce_root(want_s, w64, ctx.res_map,
                                      ctx.res_count)
            else:
                site = 0.0
                got = pack.site_logl_packed(*a32, blen=b32, units=ctx.units,
                                            clv_store=store, **kw).double()
                want = pack.site_logl_packed_ref(*a64, blen=b64, **kw)
            torch.cuda.synchronize()
            if mod.CLV_STORE != store:
                raise AssertionError(f"[{tag}] {label}: the "
                                     f"{mod.CLV_STORE} store ran, {store} "
                                     "was asked for")
            if mask is None:
                mask = ctx.locus_mask
            if not bool(torch.isfinite(got[mask]).all()):
                raise AssertionError(f"[{tag}] {label} {name}: "
                                     "non-finite lnL")
            err = float((got - want)[mask].abs().max())
            if k2:
                # per pattern over the compared loci only
                site = float((got_s - want_s)[mask].abs().max())
                site_worst = max(site_worst, site)
            if not (err < TOL_LNL and site < TOL_SITE):
                raise AssertionError(
                    f"[{tag}] {label} {name} ({store} store): kernel "
                    f"and plain version differ by {err} lnL a locus, "
                    f"{site} a pattern")
            worst = max(worst, err)
    site_txt = (f" | max per-pattern |dlnL| {site_worst:.3e} (tol "
                f"{TOL_SITE})" if k2 else "")
    if report:
        print(f"[{tag}] {label}: {'K2' if k2 else 'K1'} vs its float64 "
              f"plain version on {', '.join(c[0] for c in cases)} x "
              f"shared/global store: max per-locus |dlnL| {worst:.3e} (tol "
              f"{TOL_LNL}){site_txt} | {smi}")
    return worst, (site_worst if k2 else None)


def species_phase(label, ctl, dev, smi, kernel_name, passes):
    """``[profile]``, ``[moves]`` and ``[topo]`` on the engine of the
    control file ``ctl`` (A01 or A11): the step's device profile, the wall
    time of each species move, and the pruning kernel against its float64
    plain version on every gene-tree batch the species moves of
    ``TOPO_ITERS`` iterations proposed and on each accepted one.  Returns
    the largest per-locus error."""
    import torch

    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.mcmc import rj_moves, stree_moves
    eng, state, ips = warm_engine(load_run_from_ctl(ctl), dev)
    profile_step(eng, state, 1e3 / ips, smi, kernel_name, f"{label} step",
                 passes)
    print(f"[{label}] engine step: {ips:.2f} iters/s after warm-up | {smi}")
    ctx, cfg, gen = eng.ctx, eng.cfg, eng.gen
    rows = [("species_spr_move", wall_ms(lambda: stree_moves.species_spr_move(
        ctx, cfg, state, gen))),
        ("snl_move", wall_ms(
            lambda: stree_moves.snl_move(ctx, cfg, state, gen)))]
    if cfg.est_delimit:
        rows.append(("rj_move", wall_ms(lambda: rj_moves.rj_move(
            ctx, cfg, state, gen, eng.root_age0))))
    rows.append(("whole step", wall_ms(lambda: eng._step(state))))
    print(f"[moves] {label}, wall ms per call at {state.gt.n_loci} loci: "
          + " | ".join(f"{n} {t:.2f}" for n, t in rows) + f" | {smi}")
    # the proposals' trees are taken from the moves' Python calls, which
    # a replayed graph does not make: these iterations run eagerly
    eng.route = "eager"
    with MoveTally(record=True) as tally:
        state, _ = eng.chunk_step(state, TOPO_ITERS)
    torch.cuda.synchronize()
    # a proposal the move rejects by its own checks (a moved gene node
    # with no target branch keeps its rescaled age unregrafted) can hold
    # loci whose trees are not trees
    worst, site, held, left_out = hold_batches(label, eng, state,
                                               tally.trees, smi, "topo")
    kinds = ", ".join(f"{n} {c[0]} proposed / {c[1]} accepted"
                      for n, c in tally.counts.items() if c[0])
    print(f"[topo] {label}: {TOPO_ITERS} iterations ({kinds}); "
          f"{len(tally.trees)} gene-tree batches, {held} locus trees held "
          f"({left_out} of rejected proposals left out: a child older than "
          f"its parent), "
          f"{'K2' if ctx.res_map is not None else 'K1'} vs its float64 plain "
          f"version on JC69, HKY+G4, TN93, GTR+G4 x shared/global store: max "
          f"per-locus |dlnL| {worst:.3e} (tol {TOL_LNL})"
          + (f", per pattern {site:.3e}" if ctx.res_map is not None else "")
          + f" | {smi}")
    return worst


def launch_floor(dev, smi):
    """``[floor]``: an empty kernel's device time (profiler) and one launch
    of it seen from the host (CUDA events): what no kernel goes below."""
    from bpp_tpu_torch.core import pack
    dev_ms = kernel_device_ms(lambda: pack.launch_empty(dev), "empty_kernel")
    ev_ms = cuda_ms(lambda: pack.launch_empty(dev))
    print(f"[floor] empty kernel: device {dev_ms:.4f} ms | one launch "
          f"{ev_ms:.4f} ms (CUDA events) | {smi}")


def hold_shapes(dev, smi):
    """``[shapes]``: both kernels against their float64 plain versions on
    trees and pattern counts the bench data lacks, and on trees large
    enough that the wrappers must choose the CLV store."""
    import torch

    from bpp_tpu_torch.core import fels, pack
    from bpp_tpu_torch.core.units import Units
    from bpp_tpu_torch.testing import fixed_subst, shaped_batch
    from bpp_tpu_torch.trees.gtree import inner_order

    def args(gt, n_seq, subst, tips, dtype):
        rk = torch.cat([subst.rates, subst.kappa1[:, None],
                        subst.kappa2[:, None]], dim=1)
        return (inner_order(gt), gt.left, gt.right, gt.parent, n_seq,
                gt.age.to(dtype), subst.mu, rk, subst.freqs, subst.eigw,
                subst.eigT, subst.eigTi, tips.to(dtype))

    def hold(name, gt, n_seq, n_pat, tips, weights, model_name, n_cats,
             want_store, scale):
        L = gt.n_loci
        model, s32 = fixed_subst(model_name, n_cats, L, torch.float32, dev)
        _, s64 = fixed_subst(model_name, n_cats, L, torch.float64, dev)
        a32 = args(gt, n_seq, s32, tips, torch.float32)
        a64 = args(gt, n_seq, s64, tips, torch.float64)
        kw = dict(model=model, n_cats=n_cats)
        units = Units(n_pat.cpu().numpy(), tips.shape[2], dev)
        site = fels.site_logl_fels(*a32, n_pat=n_pat, units=units, **kw)
        logl = pack.site_logl_packed(*a32, weights, units=units, **kw)
        torch.cuda.synchronize()
        stores = (pack.CLV_STORE, fels.CLV_STORE)
        if stores != (want_store, want_store):
            raise AssertionError(f"[shapes] {name}: the wrappers picked the "
                                 f"{stores} stores, expected {want_store}")
        want = fels.site_logl_fels_ref(*a64, n_pat=n_pat, **kw)
        want_l = pack.site_logl_packed_ref(*a64, weights.double(), **kw)
        # a one-sequence locus: the kernels root it at tip 0, the plain
        # version at an unused inner slot
        one = n_seq < 2
        tip0 = (tips[:, 0].double() * s64.freqs[:, None, :]).sum(-1).log()
        live = torch.arange(tips.shape[2], device=dev) < n_pat[:, None]
        tip0 = torch.where(live, tip0, torch.zeros_like(tip0))
        want = torch.where(one[:, None], tip0, want)
        want_l = torch.where(one, (weights.double() * tip0).sum(1), want_l)
        if not bool(torch.isfinite(site).all() & torch.isfinite(logl).all()):
            raise AssertionError(f"[shapes] {name}: non-finite lnL")
        if not bool((site[~live] == 0).all()):
            raise AssertionError(f"[shapes] {name}: K2 left a column past "
                                 "n_pat that is not 0")
        site_err = float((site.double() - want).abs().max())
        err = float((logl.double() - want_l).abs().max())
        print(f"[shapes] {name}: {L} loci, {model_name}+C{n_cats}, "
              f"{want_store} store picked | K2 max per-pattern |dlnL| "
              f"{site_err:.3e} (tol {TOL_SITE * scale:.1e}) | K1 max "
              f"per-locus |dlnL| {err:.3e} (tol {TOL_LNL * scale:.2f}) | "
              f"{smi}")
        if not (site_err < TOL_SITE * scale and err < TOL_LNL * scale):
            raise AssertionError(f"[shapes] {name}: kernel and plain "
                                 "version differ")

    gt, n_seq, n_pat, tips, weights = shaped_batch(16, 200, seed=3,
                                                   device=dev)
    hold("1..16 sequences, caterpillar and balanced, 0..200 patterns", gt,
         n_seq, n_pat, tips, weights, "HKY", 4, "shared", 1.0)
    # float32 roundoff grows with the T - 1 levels: the 16-tip tolerances,
    # scaled by T / 16
    for T, model_name, n_cats, store in ((64, "HKY", 4, "shared"),
                                         (128, "GTR", 8, "global")):
        gt, n_seq, n_pat, tips, weights = shaped_batch(T, 72, seed=T,
                                                       device=dev)
        keep = slice(2 * T - 12, 2 * T)       # the 12 loci of most tips
        hold(f"{T} tips", type(gt)(*(x[keep].contiguous() for x in gt[:4])),
             n_seq[keep], n_pat[keep], tips[keep].contiguous(),
             weights[keep].contiguous(), model_name, n_cats, store, T / 16)


def check_a00_extras(job, nsample):
    """The A00 outputs beside mcmc.txt: the conditional a1b1 log (one row
    a sample, an a1 and a b1 column for each theta column of mcmc.txt),
    its Rao-Blackwellized section in the summary, and the species-tree
    PDF.  Returns a line on them."""
    import numpy as np
    with open(f"{job}.mcmc.txt") as f:
        thetas = [c for c in f.readline().split() if c.startswith("theta")]
    with open(f"{job}.conditional_a1b1.txt") as f:
        lines = f.read().splitlines()
    want = ["Gen"] + [f"{c}_{x}" for c in thetas for x in ("a1", "b1")]
    if lines[0].split("\t") != want or len(lines) != nsample + 1:
        raise AssertionError(f"{job}.conditional_a1b1.txt: header "
                             f"{lines[0]!r}, {len(lines) - 1} rows")
    rows = np.loadtxt(lines[1:], ndmin=2)
    if not (np.isfinite(rows).all() and (rows[:, 1::2] > 2).all()):
        raise AssertionError(f"{job}.conditional_a1b1.txt: a row is not "
                             "finite or an a1 is not above 2")
    with open(f"{job}.txt") as f:
        text = f.read()
    head = ("Summarizing parameter estimates using file "
            f"{job}.conditional_a1b1.txt ...")
    if head not in text:
        raise AssertionError(f"{job}.txt has no Rao-Blackwellized section")
    section = text.split(head)[1].splitlines()
    for c in thetas:
        if not any(r.startswith(c + " ") for r in section):
            raise AssertionError(f"{job}.txt: no a1b1 row for {c}")
    with open(f"{job}.pdf", "rb") as f:
        pdf = f.read()
    if not (pdf.startswith(b"%PDF-1.4") and pdf.endswith(b"%%EOF\n")):
        raise AssertionError(f"{job}.pdf is not a PDF")
    return (f"a1b1 log {nsample} rows x {len(thetas)} thetas, "
            f"Rao-Blackwellized summary, {job}.pdf {len(pdf)} bytes")


class Checks:
    """While active, the iteration of every ``Engine.validate_state`` call
    (``its``) and, where the state holds traits, the largest |cached -
    fresh| trait logl at it (``trait_diffs``), taken before the check."""

    def __enter__(self):
        from bpp_tpu_torch.mcmc import moves
        from bpp_tpu_torch.mcmc.driver import Engine
        self.its, self.trait_diffs = [], []
        self._orig = orig = Engine.validate_state
        checks = self

        def validate(eng, state, it=None):
            checks.its.append(it)
            if state.trait is not None:
                fresh = moves._trait_eval(eng.ctx, state.sp, state.sp.tau,
                                          state.trait.brate)
                checks.trait_diffs.append(
                    float((fresh - state.trait.logl).abs().max()))
            return orig(eng, state, it)

        Engine.validate_state = validate
        return self

    def __exit__(self, *exc):
        from bpp_tpu_torch.mcmc.driver import Engine
        Engine.validate_state = self._orig

    def expect(self, label, burnin, nsample, traits=False):
        """Every ``CHECK_EVERY``-th iteration from the start of burn-in
        was checked (and, with ``traits``, the trait caches were exact at
        each)."""
        want = list(range(-burnin + CHECK_EVERY, nsample + 1, CHECK_EVERY))
        if self.its != want:
            raise AssertionError(f"{label}: checks at {self.its}, expected "
                                 f"{want}")
        if traits and (len(self.trait_diffs) != len(want)
                       or any(d != 0.0 for d in self.trait_diffs)):
            raise AssertionError(f"{label}: the cached trait logl differs "
                                 f"from a fresh evaluation at the checks: "
                                 f"{self.trait_diffs}")


class ChainEnds:
    """While active, the state the first iteration was given (``first``)
    and the last (engine, state) an iteration returned (``last``; under
    ``chains = K``, the last chain's); :meth:`seen` gets every state an
    iteration returns.  On the eager route these are ``Engine._step``'s;
    on the graph route the static state around each
    ``StepGraph.replay`` (copied where a later replay would overwrite
    it), and the step's own calls, which only warm up and capture the
    graph, are not seen."""

    def __enter__(self):
        from bpp_tpu_torch.mcmc.driver import Engine, clone_state
        from bpp_tpu_torch.mcmc.graph import StepGraph
        self.first = self.last = None
        self._orig = orig = Engine._step
        self._orig_replay = orig_replay = StepGraph.replay
        ends = self

        def step(eng, state):
            if eng.route != "eager":
                return orig(eng, state)
            if ends.first is None:
                ends.first = state
            state, stats = orig(eng, state)
            ends.last = (eng, state)
            ends.seen(eng, state)
            return state, stats

        def replay(graph):
            if ends.first is None:
                ends.first = clone_state(graph.chain_states()[0])
            orig_replay(graph)
            for state in graph.chain_states():
                ends.last = (graph.eng, state)
                ends.seen(graph.eng, state)

        Engine._step = step
        StepGraph.replay = replay
        return self

    def seen(self, eng, state):
        """What a subclass keeps of each state."""

    def __exit__(self, *exc):
        from bpp_tpu_torch.mcmc.driver import Engine, clone_state
        from bpp_tpu_torch.mcmc.graph import StepGraph
        Engine._step = self._orig
        StepGraph.replay = self._orig_replay
        if self.last is not None and self.last[0].route == "graph":
            self.last = (self.last[0], clone_state(self.last[1]))


def main8(iters, smi):
    """Main 8 through the CLI: the partition chain with ``check`` and the
    gene-tree print files; every check passes and is counted.  Returns the
    K1 launches."""
    from bpp_tpu_torch.io.newick import parse_newick
    with Checks() as checks:
        launches, _ = run_chain(
            ["--cfile", "run8.ctl"], "out8", iters,
            (PASSES_PER_ITER_8 * iters + 1 + N_CHECKS, 0), ("theta", "tau"),
            "main 8", smi)
    checks.expect("main 8", BURNIN, NSAMPLE)
    files = sorted(f for f in os.listdir(".") if f.startswith("out8.")
                   and ("gtree" in f or "params" in f))
    if files != [f"out8.gtree.L{i}" for i in sorted((1, N_LOCI), key=str)]:
        raise AssertionError(f"main 8: print files {files}")
    for fn in files:
        with open(fn) as f:
            trees = f.read().splitlines()
        if len(trees) != NSAMPLE:
            raise AssertionError(f"{fn}: {len(trees)} trees")
        for t in trees:
            parse_newick(t)
    print(f"[main 8] {len(checks.its)} checks passed (float32, tol 0.5) at "
          f"iterations {checks.its} | {', '.join(files)}: {NSAMPLE} gene trees "
          f"each | {check_a00_extras('out8', NSAMPLE)} | {smi}")
    return launches


def aa_phase(dev, smi, iters):
    """Main 9: ``bench.py``'s amino-acid workload on the 20-state plain
    pass.  Returns (max per-locus |dlnL| of float32 against float64 on the
    card, ms a pass)."""
    import dataclasses

    import torch

    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.mcmc.state import make_logl_fn
    from bpp_tpu_torch.testing import generate_aa_benchmark
    t0 = time.perf_counter()
    generate_aa_benchmark(N_AA_LOCI, AA_SITES, ".")
    with open("run9.ctl", "w") as f:
        f.write(AA_CTL.format(nloci=N_AA_LOCI, burnin=BURNIN,
                              nsample=NSAMPLE))
    run9 = load_run_from_ctl("run9.ctl")
    b = run9.batch
    print(f"[data 9] {N_AA_LOCI} amino-acid loci written and loaded in "
          f"{time.perf_counter() - t0:.1f} s | L={b.n_loci} T={b.max_tips} "
          f"S={b.max_patterns} | real patterns {int(b.n_pat.sum())}")
    eng, state, ips = warm_engine(run9, dev)
    if eng.ctx.route != "plain":
        raise AssertionError(f"main 9: the WAG batch took {eng.ctx.route}")
    profile_step(eng, state, 1e3 / ips, smi, None,
                 "AA WAG step (20-state plain pass)", 0)
    ctx = eng.ctx
    args = (state.gt, state.subst, state.sp, state.clock)
    lnl32 = eng._logl_fn(*args)
    ctx64 = dataclasses.replace(ctx, tip_partials=ctx.tip_partials.double(),
                                weights=ctx.weights.double())
    gt64 = state.gt._replace(age=state.gt.age.double())
    s64 = type(state.subst)(*(x.double() for x in state.subst))
    lnl64 = make_logl_fn(ctx64, eng.cfg)(gt64, s64, state.sp, state.clock)
    m = ctx.locus_mask
    if not bool(torch.isfinite(lnl32[m]).all()):
        raise AssertionError("main 9: non-finite lnL in float32")
    err = float((lnl32.double() - lnl64)[m].abs().max())
    pass_ms = cuda_ms(lambda: eng._logl_fn(*args), reps=10)
    print(f"[aa pass] WAG, {N_AA_LOCI} loci: float32 vs float64 on the card "
          f"max per-locus |dlnL| {err:.3e} (tol {TOL_LNL}) | one pass "
          f"{pass_ms:.3f} ms (float32, CUDA events) | step {ips:.2f} iters/s "
          f"after warm-up | {smi}")
    if not err < TOL_LNL:
        raise AssertionError(f"main 9: float32 and float64 differ by {err}")
    del eng, state, args, lnl32, lnl64, ctx64, gt64, s64
    torch.cuda.empty_cache()
    run_chain(["--cfile", "run9.ctl"], "out9", iters, (0, 0),
              ("theta", "tau"), "main 9", smi)
    print(f"[main 9] {check_a00_extras('out9', NSAMPLE)} | {smi}")
    return err, pass_ms


class StepWatch(ChainEnds):
    """While active, keeps the route-consistency flag of every state an
    MSC-I engine's step returns (with ``mig``: an MSC-M engine's, whose
    events must lie in their edges and populations too, and under the
    geneflow rjMCMC its route mask ``on``; on the device: no host read;
    on a plain species tree no flag) and the last engine and state; with
    ``keep``, the first and the last ``keep`` states seen (``firsts``,
    ``kept``: under ``chains = K`` with ``keep = K``, each chain's state
    after its first iteration and its last state), copied."""

    def __init__(self, mig=False, keep=0):
        self.mig, self.keep = mig, keep

    def __enter__(self):
        self.flags, self.ons, self.kept, self.firsts = [], [], [], []
        return super().__enter__()

    def __exit__(self, *exc):
        from bpp_tpu_torch.mcmc.driver import clone_state
        super().__exit__(*exc)
        self.kept = [clone_state(st) for st in self.kept]

    def seen(self, eng, state):
        from bpp_tpu_torch.mcmc.driver import clone_state
        from bpp_tpu_torch.trees import migration as mg
        from bpp_tpu_torch.trees.gtree import (
            assign_populations, route_consistent,
        )
        ctx = eng.ctx
        if self.mig:
            pops = mg.assign_populations_mig(
                state.gt, state.sp, ctx.tip_pop, state.mig, ctx.n_seq)
            ok = mg.route_consistent_mig(state.gt, state.sp, state.mig,
                                         pops, ctx.n_seq)
            ok = ok | ~ctx.locus_mask
        elif state.sp.is_network:
            pops = assign_populations(state.gt, state.sp, ctx.tip_pop)
            ok = route_consistent(state.gt, state.sp, pops, ctx.n_seq)
        if self.mig or state.sp.is_network:
            self.flags.append(ok.all())
        if self.keep:
            # on the graph route a view of the static state: the last K
            # seen hold the K chains' final states
            self.kept = (self.kept + [state])[-self.keep:]
            if len(self.firsts) < self.keep:
                self.firsts.append(clone_state(state))
        if self.mig and state.mig.on is not None:
            # a copy: on the graph route the state is the static buffer,
            # which the next replay overwrites
            self.ons.append(state.mig.on.clone())


def write_dates(path):
    """The sample dates of main 1's 16 individuals (numpy seed 137): one
    line ``<individual> <date>`` each, dates in [0, 1)."""
    import numpy as np
    rng = np.random.default_rng(137)
    with open(path, "w") as f:
        for sp_name in "abcd":
            for k in range(1, 5):
                f.write(f"{sp_name}{k} {rng.uniform(0, 1):.3f}\n")


def write_net_data(prefix, nloci, seqs, extra):
    """Simulate ``nloci`` loci on main 10's network with the port's
    simulator (seed 137) into ``<prefix>.phy`` / ``.Imap.txt``."""
    from bpp_tpu_torch.sim.simulate import run_simulation
    from bpp_tpu_torch.testing import NET_SIM_TREE
    with open(f"{prefix}.ctl", "w") as f:
        f.write(SIM10_CTL.format(prefix=prefix, seqs=seqs, tree=NET_SIM_TREE,
                                 nloci=nloci, extra=extra))
    run_simulation(f"{prefix}.ctl")


def msci_phases(dev, smi, iters, n_loci=N_LOCI, n_diploid=N_NET_DIPLOID):
    """``[data 10]``, ``[main 10]``, ``[profile]`` of its step, ``[net]``
    (a)-(d) and ``[main 11]`` with ``--msci-create``.  Returns (K1
    launches of main 10, of main 11, [net]'s largest K1 error, its largest
    K2 error)."""
    import contextlib
    import io

    import numpy as np
    import torch

    from bpp_tpu_torch import cli
    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.testing import NET_GUIDE
    from bpp_tpu_torch.tools.msci_create import msci_create
    from bpp_tpu_torch.trees.stree import theta_link_map
    net_run = RUN_CTL.replace("((A, B), (C, D));", NET_GUIDE + ";").replace(
        "seqfile = sim.phy", "seqfile = sim10.phy").replace(
        "Imapfile = sim.Imap.txt", "Imapfile = sim10.Imap.txt")

    # [data 10]: the bench shape on the network
    t0 = time.perf_counter()
    write_net_data("sim10", n_loci, "4 4 4 4", "model = 0")
    for ctl, job, extra in (("run10.ctl", "out10", "phiprior = 1 1\n"),
                            ("run10c.ctl", "out10c",
                             "phiprior = 1 1\n" + RELAXED)):
        with open(ctl, "w") as f:
            f.write(net_run.format(nloci=n_loci, burnin=SHORT_BURNIN,
                                   nsample=SHORT_NSAMPLE, job=job,
                                   extra=extra))
    run10 = load_run_from_ctl("run10.ctl")
    st = run10.stree
    b = run10.batch
    print(f"[data 10] {n_loci} haploid loci simulated on the network "
          f"{NET_GUIDE} in {time.perf_counter() - t0:.1f} s | H={st.n_nodes} "
          f"(tips {st.n_tips}, hybridizations {st.n_hybrids}) L={b.n_loci} "
          f"T={b.max_tips} S={b.max_patterns} | real patterns "
          f"{int(np.asarray(b.n_pat).sum())}")

    # [main 10]: A00 on the network through the CLI, 25 iterations
    iters10 = SHORT_BURNIN + SHORT_NSAMPLE
    with StepWatch() as watch:
        launches10, _ = run_chain(
            ["--cfile", "run10.ctl"], "out10", iters10,
            (PASSES_PER_ITER_10 * iters10 + 1, 0), ("theta", "tau", "phi"),
            "main 10", smi, figtree=False, nsample=SHORT_NSAMPLE)
    consistent = bool(torch.stack(watch.flags).all())
    if len(watch.flags) != iters10 or not consistent:
        raise AssertionError(f"main 10: {len(watch.flags)} steps, routes "
                             f"consistent in all: {consistent}")
    eng10, state10 = watch.last
    eng10.validate_state(state10)
    print(f"[main 10] routes consistent in all {iters10} states; "
          f"validate_state passed on the last | {smi}")

    # its step, profiled on the chain's last state; [net] (a): K1 on the
    # chain's gene trees.  One iteration a trace: its ~56,000 kernels are
    # more events than three iterations of any other step
    ms = step_ms(eng10, state10, iters=3)
    profile_step(eng10, state10, ms, smi, "pack_logl_kernel",
                 "MSC-I JC69 step (main 10)", PASSES_PER_ITER_10, iters=1)
    print(f"[main 10] engine step (MSC-I JC69, {n_loci} loci): "
          f"{1e3 / ms:.2f} iters/s after the chain | {smi}")
    net = {}
    net["a"], _ = hold_given("(a) K1, main 10's gene trees (strict ages)",
                             eng10, state10, smi, tag="net")
    del eng10, state10, watch

    # (b) K1 on relaxed lengths through edge_passes (clock = 2); the
    # network steps are slow, so their engines warm for a few iterations
    engc, statec, ipsc = warm_engine(load_run_from_ctl("run10c.ctl"), dev,
                                     2, 3)
    net["b"], _ = hold_given(
        "(b) K1, blen of a clock = 2 chain on the network", engc, statec,
        smi, lambda dt: relaxed_blen(engc, statec, dt), tag="net")
    print(f"[net] clock = 2 network step: {ipsc:.2f} iters/s after warm-up "
          f"| {smi}")
    del engc, statec

    # (c) K1 on the BDI fixture's trees under clock = 2 (rate_owner)
    fix = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                       "fixtures", "bdi")
    for ctl, job, extra in (("run11c.ctl", "out11c", RELAXED),
                            ("run11.ctl", "out11",
                             "thetamodel = linked-msci\n")):
        with open(ctl, "w") as f:
            f.write(BDI_CTL.format(fix=fix, job=job, burnin=BDI_BURNIN,
                                   nsample=SHORT_NSAMPLE, extra=extra))
    engb, stateb, _ = warm_engine(load_run_from_ctl("run11c.ctl"), dev, 2, 3)
    if engb.run.stree.bdi is None or stateb.sp.rate_owner is None:
        raise AssertionError("the BDI fixture has no rate owners")
    net["c"], _ = hold_given(
        "(c) K1, BDI fixture under clock = 2 (mirrors at their partners' "
        "rates)", engb, stateb, smi, lambda dt: relaxed_blen(engb, stateb,
                                                             dt), tag="net")
    del engb, stateb

    # (d) K2 on a diploid HKY+G4 batch on the network
    write_net_data("sim10d", n_diploid, "2 2 2 2", NET_DIPLOID)
    text = RUN2_CTL.format(nloci=n_diploid, burnin=BURNIN, nsample=NSAMPLE,
                           job="out10d", extra="phiprior = 1 1\n")
    with open("run10d.ctl", "w") as f:
        f.write(text.replace("((A, B), (C, D));", NET_GUIDE + ";").replace(
            "sim2.", "sim10d."))
    engd, stated, _ = warm_engine(load_run_from_ctl("run10d.ctl"), dev, 2,
                                  3)
    if engd.ctx.route != "K2":
        raise AssertionError(f"the diploid network batch took "
                             f"{engd.ctx.route}")
    net["d"], net["d site"] = hold_given(
        "(d) K2 and reduce_root, diploid HKY+G4 on the network", engd,
        stated, smi, tag="net")
    del engd, stated
    torch.cuda.empty_cache()
    print(f"[net] K1 max per-locus |dlnL| (a) {net['a']:.3e} (b) "
          f"{net['b']:.3e} (c) {net['c']:.3e} | K2 (d) {net['d']:.3e} a "
          f"locus, {net['d site']:.3e} a pattern | tol {TOL_LNL} | {smi}")

    # [main 11]: BDI with linked thetas through the CLI, 28 iterations
    iters11 = BDI_BURNIN + SHORT_NSAMPLE
    launches11, _ = run_chain(
        ["--cfile", "run11.ctl"], "out11", iters11,
        (PASSES_PER_ITER_11 * iters11 + 1, 0), ("theta", "tau", "phi"),
        "main 11", smi, figtree=False, nsample=SHORT_NSAMPLE)
    st11 = load_run_from_ctl("run11.ctl").stree
    # the theta owners of linked-msci, less the BDI mirrors (no theta)
    mirrors = {int(st11.hybrid[i]) for i in range(st11.n_nodes)
               if st11.bdi[i] >= 0}
    owners = sorted(set(theta_link_map(st11, 3).tolist()) - mirrors)
    with open("out11.mcmc.txt") as f:
        head = f.readline().split()
    with open("out11.mcmc.txt.processed") as f:
        proc = f.read().splitlines()
    thetas = [c for c in head if c.startswith("theta")]
    if len(thetas) != len(owners) or len(proc) != SHORT_NSAMPLE + 1:
        raise AssertionError(f"main 11: theta columns {thetas} for owners "
                             f"{owners}; {len(proc)} processed lines")
    out = io.StringIO()
    with open("defs.txt", "w") as f:
        f.write(MSCI_DEFS)
    with contextlib.redirect_stdout(out):
        rc = cli.main(["--msci-create", "defs.txt"])
    lines = out.getvalue().splitlines()
    if rc or lines[-1] != MSCI_NEWICK or msci_create(MSCI_DEFS) != \
            MSCI_NEWICK:
        raise AssertionError(f"--msci-create printed {lines}")
    print(f"[main 11] out11.mcmc.txt.processed: {len(proc) - 1} relabelled "
          f"samples | theta columns {len(thetas)} (the linked-msci owners "
          f"{owners}) | --msci-create: {lines[-1]} | {smi}")

    # [cli] the slice's other combinations through the CLI on the card:
    # tests/fixtures/msci/m.ctl with its data, strict and clock = 2, and
    # linked-all / linked-inner thetas on ((A, B), (C, D)) with 100 of the
    # network's loci
    mdir = os.path.join(os.path.dirname(fix), "msci")
    with open(os.path.join(mdir, "m.ctl")) as f:
        mtext = f.read()
    for a, b in (("usedata = 0", "usedata = 1"),
                 ("seqfile = d.txt", f"seqfile = {mdir}/d.txt"),
                 ("Imapfile = d.imap", f"Imapfile = {mdir}/d.imap"),
                 ("burnin = 200", "burnin = 2"),
                 ("nsample = 2000", "nsample = 4")):
        mtext = mtext.replace(a, b)
    runs = [("outm", mtext.replace("jobname = out", "jobname = outm")),
            ("outmc", mtext.replace("jobname = out", "jobname = outmc")
             + "\n" + RELAXED)]
    tree_run = RUN_CTL.replace("seqfile = sim.phy", "seqfile = sim10.phy") \
        .replace("Imapfile = sim.Imap.txt", "Imapfile = sim10.Imap.txt")
    # linked-inner with chains = 4, on the batched route
    chains = {"out-linked-all": 1, "out-linked-inner": CLI_LINKED_CHAINS}
    for model in ("linked-all", "linked-inner"):
        job = f"out-{model}"
        runs.append((job, tree_run.format(
            nloci=100, burnin=2, nsample=4, job=job,
            extra=f"thetamodel = {model}\n" + (
                f"chains = {chains[job]}\n" if chains[job] > 1 else ""))))
    done = []
    for job, text in runs:
        with open(f"{job}.ctl", "w") as f:
            f.write(text)
        if cli.main(["--cfile", f"{job}.ctl", "--quiet"]) != 0:
            raise AssertionError(f"[cli] {job}: cli.main failed")
        k = chains.get(job, 1)
        for fn in [f"{job}.mcmc.txt"] + [f"{job}.c{c}.mcmc.txt"
                                         for c in range(2, k + 1)]:
            with open(fn) as f:
                rows = f.read().splitlines()
            n_theta = sum(c.startswith("theta") for c in rows[0].split())
            if len(rows) != 5 or (job.startswith("out-") and n_theta >= 7):
                raise AssertionError(f"[cli] {fn}: {len(rows) - 1} "
                                     f"samples, {n_theta} theta columns")
        done.append(f"{job} ({n_theta} theta columns"
                    + (f"; {k} chains, {k} mcmc files" if k > 1 else "")
                    + ")")
    print(f"[cli] 4 samples each on the card: {', '.join(done)} | {smi}")
    return (launches10, launches11, max(net["a"], net["b"], net["c"]),
            net["d"])


def write_mig_data(prefix, nloci, seqs, extra):
    """Simulate ``nloci`` loci on main 1's species tree with main 12's
    migration routes (the port's simulator, seed 137) into
    ``<prefix>.phy`` / ``.Imap.txt``."""
    from bpp_tpu_torch.sim.simulate import run_simulation
    from bpp_tpu_torch.testing import MIG_SIM
    with open(f"{prefix}.ctl", "w") as f:
        f.write(SIM10_CTL.format(prefix=prefix, seqs=seqs, tree=MAIN1_TREE,
                                 nloci=nloci, extra=extra + MIG_SIM))
    run_simulation(f"{prefix}.ctl")


def hold_batches(label, eng, state, trees, smi, tag):
    """The pruning kernel against its float64 plain version on each
    recorded ``(what, gene-tree batch)`` of ``trees``.  Loci that are not
    trees (a proposal the move itself rejects: the likelihood of those
    loci is never used) are left out and counted; a batch kept after an
    accepted move must be all trees.  Returns (largest per-locus error,
    largest per-pattern error, loci held, loci left out)."""
    import torch

    from bpp_tpu_torch.testing import gene_tree_faults
    ctx = eng.ctx
    worst = site = 0.0
    held = left_out = 0
    for what, gt in trees:
        bad = {f[0] for f in gene_tree_faults(gt, ctx.n_seq)}
        ok = torch.tensor([li not in bad for li in range(gt.n_loci)],
                          device=ctx.n_seq.device)
        if what.endswith("accepted") and not bool(ok[ctx.locus_mask].all()):
            raise AssertionError(f"[{tag}] {label}: an accepted move left "
                                 "an invalid gene tree")
        mask = ok & ctx.locus_mask
        held += int(mask.sum())
        left_out += int((~ok & ctx.locus_mask).sum())
        if bool(mask.any()):
            err, serr = hold_given(f"{label} {what}", eng,
                                   state._replace(gt=gt), smi, report=False,
                                   mask=mask, tag=tag)
            worst, site = max(worst, err), max(site, serr or 0.0)
    if not held:
        raise AssertionError(f"[{tag}] {label}: no gene tree was held")
    return worst, site, held, left_out


def mig_phases(dev, smi, iters, n_loci=N_LOCI, n_diploid=N_MIG_DIPLOID):
    """``[data 12]``, ``[main 12]``, the ``[profile]`` of its step and
    ``[mig]`` (a)-(c).  Returns (K1 launches of main 12, [mig]'s largest
    K1 error, its largest K2 error)."""
    import numpy as np
    import torch

    from bpp_tpu_torch.core import pack
    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.testing import MIG_RUN
    routes = MIG_RUN + MIG_WPRIOR
    mig_run = RUN_CTL.replace("seqfile = sim.phy", "seqfile = sim12.phy") \
        .replace("Imapfile = sim.Imap.txt", "Imapfile = sim12.Imap.txt")

    # [data 12]: main 1's shape with migration between A and B
    t0 = time.perf_counter()
    write_mig_data("sim12", n_loci, "4 4 4 4", "model = 0\n")
    for ctl, job, extra in (("run12.ctl", "out12", routes),
                            ("run12c.ctl", "out12c", routes + RELAXED)):
        with open(ctl, "w") as f:
            f.write(mig_run.format(nloci=n_loci, burnin=SHORT_BURNIN,
                                   nsample=SHORT_NSAMPLE, job=job,
                                   extra=extra))
    run12 = load_run_from_ctl("run12.ctl")
    b = run12.batch
    print(f"[data 12] {n_loci} haploid loci simulated with migration A <-> B "
          f"(M = 0.5 each way) in {time.perf_counter() - t0:.1f} s | "
          f"L={b.n_loci} T={b.max_tips} S={b.max_patterns} | real patterns "
          f"{int(np.asarray(b.n_pat).sum())} | routes "
          f"{[(s.source, s.target) for s in run12.cfg.mig_specs]}")

    # [main 12]: A00 MSC-M through the CLI, 25 iterations
    iters = SHORT_BURNIN + SHORT_NSAMPLE
    with StepWatch(mig=True) as watch:
        launches12, _ = run_chain(
            ["--cfile", "run12.ctl"], "out12", iters,
            (PASSES_PER_ITER_12 * iters + 1, 0), ("theta", "tau", "W:"),
            "main 12", smi, nsample=SHORT_NSAMPLE,
            chains=(0, 0, K5_PER_ITER_12 * iters))
    consistent = bool(torch.stack(watch.flags).all())
    if len(watch.flags) != iters or not consistent:
        raise AssertionError(f"main 12: {len(watch.flags)} steps, routes "
                             f"and events consistent in all: {consistent}")
    eng12, state12 = watch.last
    eng12.validate_state(state12)
    eng, state = eng12, state12
    events = state.mig.count()
    if not int(events.sum()):
        raise AssertionError("main 12: no migration event in the last state")
    with open("out12.conditional_a1b1.txt") as f:
        a1b1_head = f.readline().split()
    w_rows = [c for c in a1b1_head if c.startswith("W:")]
    if len(w_rows) != 4:
        raise AssertionError(f"main 12: a1b1 log header {a1b1_head}")
    print(f"[main 12] routes and events consistent in all {iters} states; "
          f"validate_state passed on the last; {int(events.sum())} "
          f"migration events on {int((events > 0).sum())} loci; M "
          f"{[round(float(m), 4) for m in state.mig.M]}; a1b1 log rows "
          f"{w_rows} | {smi}")
    del eng12, state12, watch

    # its step, profiled on the chain's last state; [mig] (a): the kernels
    # on every gene-tree batch spr_sim_move proposed
    ms = step_ms(eng, state, iters=3)
    profile_step(eng, state, ms, smi, "pack_logl_kernel",
                 "MSC-M JC69 step (main 12)", PASSES_PER_ITER_12, iters=1)
    print(f"[main 12] engine step (MSC-M JC69, {n_loci} loci): "
          f"{1e3 / ms:.2f} iters/s after the chain | {smi}")
    eng.route = "eager"      # the proposals' trees, from Python calls
    with MoveTally(record=True, moves=(("mig_moves", "spr_sim_move"),),
                   accepted=False) as tally:
        state, _ = eng.chunk_step(state, MIG_ITERS)
    torch.cuda.synchronize()
    mig = {}
    mig["a"], _, held, left_out = hold_batches(
        "(a) sim-SPR proposals", eng, state, tally.trees, smi, "mig")
    mig["a"] = max(mig["a"], hold_given(
        "(a) the state after them", eng, state, smi, report=False,
        tag="mig")[0])
    print(f"[mig] (a) K1 on {len(tally.trees)} gene-tree batches spr_sim_move "
          f"proposed over {MIG_ITERS} iterations ({tally.counts} calls / "
          f"calls with an accepted locus), {held} locus trees held ({left_out} "
          f"of failed walks left out: pruned, not regrafted), and the state "
          f"after them ({int(state.mig.count().sum())} events): max per-locus "
          f"|dlnL| {mig['a']:.3e} (tol {TOL_LNL}) | {smi}")
    del eng, state, tally

    # (b) K1 on the sub-edge lengths of a clock = 2 MSC-M chain, and the
    # event-age move's pass per event slot
    engc, statec, ipsc = warm_engine(load_run_from_ctl("run12c.ctl"), dev,
                                     2, 3)
    pack.LAUNCHES = 0
    statec, _ = engc.chunk_step(statec, 2)
    torch.cuda.synchronize()
    if pack.LAUNCHES != 2 * PASSES_PER_ITER_12C:
        raise AssertionError(f"[mig] clock = 2 MSC-M step: K1 launched "
                             f"{pack.LAUNCHES} times in 2 iterations, "
                             f"expected {2 * PASSES_PER_ITER_12C}")
    mig["b"], _ = hold_given(
        "(b) K1, blen of a clock = 2 MSC-M chain (the sub-edge sweep)", engc,
        statec, smi, lambda dt: relaxed_blen(engc, statec, dt), tag="mig")
    print(f"[mig] clock = 2 MSC-M step: {ipsc:.2f} iters/s after warm-up, "
          f"K1 {PASSES_PER_ITER_12C} launches an iteration (event slots "
          f"{ME_12}), {int(statec.mig.count().sum())} events | {smi}")
    del engc, statec

    # (c) K2 on a diploid HKY+G4 batch simulated under migration
    write_mig_data("sim12d", n_diploid, "2 2 2 2", NET_DIPLOID)
    with open("run12d.ctl", "w") as f:
        f.write(RUN2_CTL.format(nloci=n_diploid, burnin=BURNIN,
                                nsample=NSAMPLE, job="out12d",
                                extra=routes).replace("sim2.", "sim12d."))
    engd, stated, _ = warm_engine(load_run_from_ctl("run12d.ctl"), dev, 2,
                                  3)
    if engd.ctx.route != "K2":
        raise AssertionError(f"the diploid MSC-M batch took "
                             f"{engd.ctx.route}")
    mig["c"], mig["c site"] = hold_given(
        "(c) K2 and reduce_root, diploid HKY+G4 under migration", engd,
        stated, smi, tag="mig")
    del engd, stated
    torch.cuda.empty_cache()
    print(f"[mig] K1 max per-locus |dlnL| (a) {mig['a']:.3e} (b) "
          f"{mig['b']:.3e} | K2 (c) {mig['c']:.3e} a locus, "
          f"{mig['c site']:.3e} a pattern | tol {TOL_LNL} | {smi}")
    return launches12, max(mig["a"], mig["b"]), mig["c"]


class Chains:
    """``chunk_step`` over the K chains of an engine, each with its own
    generator, as ``Engine.run_mcmc_multi`` steps them: on the batched
    route (``driver.chain_route``) one step over the K stacked chains (on
    the graph route replays of one graph), on the per-chain route the
    chains in turn (replays of one graph a chain); ``batched=False``
    takes the per-chain route on any configuration.  What
    ``profile_step`` and ``step_ms`` time."""

    def __init__(self, eng, gens, batched=None):
        self.eng, self.gens = eng, gens
        self.batched = (eng.chains_route == "batched" if batched is None
                        else batched)

    @classmethod
    def start(cls, eng, k, batched=None):
        """(the K-chain stepper, the K initial states) of ``eng``, each
        chain seeded as ``run_mcmc_multi`` seeds it."""
        import torch
        gens = [torch.Generator(device=eng.device) for _ in range(k)]
        for c, g in enumerate(gens):
            g.manual_seed(eng.chain_seed(c))
        return cls(eng, gens, batched), eng.init_states(k)

    def graph(self, states):
        """The captured step of the K chains, ``states`` loaded."""
        from bpp_tpu_torch.mcmc.driver import stack_states
        if self.batched:
            return self.eng.step_graph([stack_states(states)], self.gens,
                                       batched=True)
        return self.eng.step_graph(states, self.gens)

    def chunk_step(self, states, n, it=None):
        from bpp_tpu_torch.mcmc.driver import (
            chain_views, clone_state, stack_states,
        )
        if self.eng.route == "graph":
            graph = self.graph(states)
            graph.run(n)
            return [clone_state(st) for st in graph.chain_states()], None
        if self.batched:
            stacked, _, _ = self.eng._chunk_multi(stack_states(states),
                                                  self.gens, n)
            return [clone_state(st) for st in
                    chain_views(stacked, len(self.gens))], None
        own = self.eng.gen
        try:
            for c, g in enumerate(self.gens):
                self.eng.gen = g
                states[c], _ = self.eng.chunk_step(states[c], n)
        finally:
            self.eng.gen = own
        return states, None


def check_chains(job, k, nsample, label, skip=(), moving=None):
    """The files of a ``chains = k`` run: chains 2..k's mcmc.txt hold
    ``nsample`` finite samples with every column but lnL moving (chain
    1's is :func:`run_chain`'s; the columns ``skip`` names left out; with
    ``moving``, a tuple of column prefixes, some column of each prefix
    moving instead), and the pooled summary its split-R-hat table.
    Returns (the mcmc files, the table's first two rows)."""
    import numpy as np
    files = [f"{job}.mcmc.txt"] + [f"{job}.c{c}.mcmc.txt"
                                   for c in range(2, k + 1)]
    for fn in files[1:]:
        with open(fn) as f:
            header = f.readline().split()
            data = np.loadtxt(f, ndmin=2)
        keep = [j for j, col in enumerate(header) if col not in skip]
        data = data[:, keep]
        still = [header[j] for j, sd in zip(keep[:-1],
                                            data.std(axis=0)[:-1])
                 if not sd > 0]
        if moving is not None:
            moved = {header[j] for j in keep[:-1]} - set(still)
            still = [p for p in moving
                     if not any(c.startswith(p) for c in moved)]
        if (data.shape[0] != nsample or not np.isfinite(data).all()
                or still):
            raise AssertionError(f"{label}: {fn} holds {data.shape} samples "
                                 f"or a column that never moved ({still})")
    with open(f"{job}.txt") as f:
        summary = f.read()
    if f"split-R-hat over {k} chains" not in summary:
        raise AssertionError(f"{label}: no split-R-hat table in {job}.txt")
    rows = summary.split("(values near 1 = converged):")[1].splitlines()[1:3]
    return files, "; ".join(r.strip() for r in rows)


def main13(iters, smi, dev):
    """``[main 13]``: ``chains = 2`` on main 1's data with ``checkpoint =
    25 0``, run whole and then resumed, on the batched route: K1 once a
    pass for both chains (8 an iteration) plus one initial state a chain;
    the ``[profile]`` of the two-chain step.  Returns K1's launches."""
    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.mcmc.driver import Engine
    with open("run13.ctl", "w") as f:
        f.write(RUN_CTL.format(nloci=N_LOCI, burnin=BURNIN, nsample=NSAMPLE,
                               job="out13", extra=f"chains = {CHAINS}\n"
                               f"checkpoint = {CHECKPOINT_AT} 0\n"))
    launches, _ = run_chain(
        ["--cfile", "run13.ctl"], "out13", iters,
        (PASSES_PER_ITER * iters + CHAINS, 0), ("theta", "tau"),
        "main 13", smi, figtree=False)
    files, rhat = check_chains("out13", CHAINS, NSAMPLE, "main 13")
    whole = []
    for fn in files:
        with open(fn, "rb") as f:
            whole.append(f.read())
        os.replace(fn, fn + ".whole")
    rest = NSAMPLE - CHECKPOINT_AT
    resumed, _ = run_chain(
        ["--resume", "out13.chk.npz"], "out13", rest,
        (PASSES_PER_ITER * rest + CHAINS, 0), ("theta", "tau"),
        "main 13 resumed", smi, figtree=False)
    for fn, w in zip(files, whole):
        with open(fn, "rb") as f:
            if f.read() != w:
                raise AssertionError(f"main 13: the resumed {fn} differs "
                                     "from the uninterrupted run's")
    print(f"[main 13] {CHAINS} chains: {', '.join(files)} {NSAMPLE} finite "
          f"moving samples each; split-R-hat table ({rhat}, ...); --resume "
          f"at it {CHECKPOINT_AT}: every file byte-identical to the whole "
          f"run's | {smi}")

    # the two-chain step, profiled
    both, states = Chains.start(
        Engine(load_run_from_ctl("run13.ctl"), seed=1, device=dev), CHAINS)
    states, _ = both.chunk_step(states, 5)
    profile_step(both, states, step_ms(both, states), smi,
                 "pack_logl_kernel", f"JC69 {CHAINS}-chain step (main 13, "
                 "batched)", PASSES_PER_ITER)
    return launches + resumed


def main14(smi):
    """``[main 14]``: main 12's data and routes with the geneflow rjMCMC
    (``geneflow = 1``: every candidate route, the configured A -> B and
    B -> A active at the start), burnin 5, nsample 20, through the CLI;
    routes and events consistent in every state, ``validate_state`` on the
    last, each ``W:`` column 0 exactly where its route is off, the
    geneflow moves counted; the ``[profile]`` of its step.  Returns K1's
    launches."""
    import numpy as np
    import torch

    from bpp_tpu_torch.testing import MIG_RUN
    mig_run = RUN_CTL.replace("seqfile = sim.phy", "seqfile = sim12.phy") \
        .replace("Imapfile = sim.Imap.txt", "Imapfile = sim12.Imap.txt")
    with open("run14.ctl", "w") as f:
        f.write(mig_run.format(nloci=N_LOCI, burnin=SHORT_BURNIN,
                               nsample=SHORT_NSAMPLE, job="out14",
                               extra=MIG_RUN + MIG_WPRIOR + GENEFLOW))
    iters = SHORT_BURNIN + SHORT_NSAMPLE
    from bpp_tpu_torch.mcmc.state import MV_GFRJ
    with StepWatch(mig=True) as watch, MoveStats() as tally:
        launches, _ = run_chain(
            ["--cfile", "run14.ctl"], "out14", iters,
            (PASSES_PER_ITER_12 * iters + 1, 0), ("theta",),
            "main 14", smi, nsample=SHORT_NSAMPLE,
            chains=(0, 0, K5_PER_ITER_12 * iters))
    consistent = bool(torch.stack(watch.flags).all())
    if len(watch.flags) != iters or not consistent:
        raise AssertionError(f"main 14: {len(watch.flags)} steps, routes "
                             f"and events consistent in all: {consistent}")
    eng, state = watch.last
    eng.validate_state(state)
    ons = torch.stack(watch.ons).cpu().numpy()              # [iters, K]
    with open("out14.mcmc.txt") as f:
        head = f.readline().split()
        data = np.loadtxt(f, ndmin=2)
    w = [j for j, c in enumerate(head) if c.startswith("W:")]
    if len(w) != ons.shape[1] or len(w) != eng.routes.n_routes:
        raise AssertionError(f"main 14: {len(w)} W: columns for "
                             f"{eng.routes.n_routes} candidate routes")
    # 25 iterations without finetune marks (burnin < 8): a tau column
    # may keep its value, but not every one
    taus = [j for j, c in enumerate(head) if c.startswith("tau")]
    if not (data[:, taus].std(axis=0) > 0).any():
        raise AssertionError("main 14: no tau column moved")
    W = data[:, w]
    on = ons[SHORT_BURNIN:]
    if not ((W == 0) == ~on).all():
        raise AssertionError("main 14: a W: column is 0 where its route is "
                             "on, or not 0 where it is off")
    # the flip and the add/remove move share one statistics slot
    counts = tuple(tally.stats[MV_GFRJ])
    if counts[0] != 2 * iters:
        raise AssertionError(f"main 14: geneflow moves (proposed, accepted) "
                             f"{counts}, expected {2 * iters} proposals")
    print(f"[main 14] {len(w)} candidate routes; routes and events "
          f"consistent in all {iters} states; validate_state passed on the "
          f"last; W: columns 0 exactly where their route is off in all "
          f"{SHORT_NSAMPLE} samples; active routes a sample "
          f"{sorted(set(on.sum(1).tolist()))}; geneflow moves (flip and "
          f"add/remove proposed, accepted) {counts}; {int(state.mig.count().sum())} events | "
          f"{smi}")
    ms = step_ms(eng, state, iters=3)
    profile_step(eng, state, ms, smi, "pack_logl_kernel",
                 "MSC-M geneflow JC69 step (main 14)", PASSES_PER_ITER_12,
                 iters=1)
    print(f"[main 14] engine step (MSC-M geneflow JC69, {N_LOCI} loci): "
          f"{1e3 / ms:.2f} iters/s after the chain | {smi}")
    return launches


def main15(smi, dev):
    """``[main 15]``: main 1's data with a trait file (numpy seed 137: 4
    species x 20 continuous characters, 4 x 50 discrete ones of 2-4
    states with some missing) and ``check = 10`` through the CLI; the
    cached trait logl equal to a fresh evaluation at every check, the trait
    move proposed and accepted; the ``[profile]`` of its step.  Returns
    K1's launches."""
    import torch

    from bpp_tpu_torch.mcmc.driver import Engine
    from bpp_tpu_torch.mcmc.state import MV_TRAIT
    from bpp_tpu_torch.testing import write_trait_file
    write_trait_file("traits.txt", seed=137)
    with open("run15.ctl", "w") as f:
        f.write(RUN_CTL.format(nloci=N_LOCI, burnin=BURNIN, nsample=NSAMPLE,
                               job="out15",
                               extra=TRAITS15.format(check=CHECK_EVERY)))
    iters = BURNIN + NSAMPLE
    with Checks() as checks, MoveStats() as tally:
        launches, _ = run_chain(
            ["--cfile", "run15.ctl"], "out15", iters,
            (PASSES_PER_ITER * iters + 1 + N_CHECKS, 0),
            ("theta", "tau"), "main 15", smi)
    checks.expect("main 15", BURNIN, NSAMPLE, traits=True)
    diffs = checks.trait_diffs
    eng = Engine(load_run("run15.ctl"), seed=1, device=dev)
    # under the strict clock one proposal a partition an iteration
    per_iter = len(eng.trait_data)
    prop, acc = tally.stats[MV_TRAIT]
    if tally.iters != iters or prop != per_iter * iters or not acc:
        raise AssertionError(f"main 15: {tally.iters} iterations, the trait "
                             f"move proposed {prop} rates ({per_iter} an "
                             f"iteration expected), accepted {acc}")
    state, _ = eng.chunk_step(eng.init_state(), 5)
    print(f"[main 15] {N_CHECKS} checks passed, the cached trait logl equal "
          f"to a fresh evaluation at each (max |d| {max(diffs)}); the trait "
          f"move proposed {prop} rates in {iters} iterations and accepted "
          f"{acc}; trait logl "
          f"{[round(float(x), 3) for x in state.trait.logl]} | {smi}")
    profile_step(eng, state, step_ms(eng, state), smi, "pack_logl_kernel",
                 "JC69 with traits step (main 15)", PASSES_PER_ITER)
    del eng, state
    torch.cuda.empty_cache()
    return launches


def new_ctl(n, nloci, burnin=NEW_BURNIN, nsample=NEW_NSAMPLE):
    """The control file of main ``n`` (17-22) at ``nloci`` loci, job
    ``out<n>``: main 1's run (main 21: main 2's) with the lines of its
    configuration."""
    job = f"out{n}"
    if n == 21:
        text = RUN2_CTL.format(nloci=nloci, burnin=burnin, nsample=nsample,
                               job=job, extra=CORR21.format(check=CHECK_EVERY))
        return text.replace("locusrate = 1 10 10 5 iid\n", "")
    extra = {17: "", 18: f"chains = {CHAINS_18}\n",
             19: "model = TN93\n" + GAMMA4, 20: "model = GTR\n" + GAMMA4,
             22: TRAITS15.format(check=CHECK_EVERY) + CLOCK2 + A01}[n]
    return RUN_CTL.format(nloci=nloci, burnin=burnin, nsample=nsample,
                          job=job, extra=extra)


def profile_last(eng, state, smi, kernel_name, label, passes, iters=3):
    """The ``[profile]`` of ``eng``'s step on the chain's last ``state``,
    and its iterations/s (wall, untraced) there."""
    ms = step_ms(eng, state, iters=5)
    profile_step(eng, state, ms, smi, kernel_name, label, passes,
                 iters=iters)
    print(f"[profile] {label}: {1e3 / ms:.2f} iters/s after the chain | "
          f"{smi}")


def moved_loci(first, last, mask, fields):
    """{field: real loci whose value of the per-locus ``fields`` differs
    between the ``first`` and ``last`` states}; fails if one moved
    nowhere.  ``fields`` name (state part, attribute) pairs."""
    out = {}
    for part, name in fields:
        a = getattr(getattr(first, part), name)
        b = getattr(getattr(last, part), name)
        out[name] = int(((a != b).reshape(a.shape[0], -1).any(1)
                         & mask).sum())
    if not all(out.values()):
        raise AssertionError(f"a parameter never moved: {out}")
    return out


def main17(smi):
    """``[main 17]``: main 1's run on all 10,000 loci through the CLI,
    burnin 2, nsample 8: K1 8 an iteration plus 1; the load through the
    native compressor timed; K1 against its float64 plain version on
    every locus of the last state; the ``[profile]`` of the step there.
    Returns (K1 launches, the hold's largest per-locus error)."""
    import torch

    from bpp_tpu_torch import loader
    from bpp_tpu_torch.data import cnative
    with open("run17.ctl", "w") as f:
        f.write(new_ctl(17, N_LOCI_10K, BURNIN_17, NSAMPLE_17))
    iters = BURNIN_17 + NSAMPLE_17
    loads = []
    orig = loader.load_run

    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return orig(*a, **kw)
        finally:
            loads.append(time.perf_counter() - t0)

    loader.load_run = timed
    cnative.CALLS = 0
    try:
        # 10 iterations, no finetune marks (burnin < 8), 10,000 loci: a
        # tau column may keep its value, but not every one
        with ChainEnds() as ends:
            launches, _ = run_chain(
                ["--cfile", "run17.ctl"], "out17", iters,
                (PASSES_PER_ITER * iters + 1, 0), ("theta", "tau"),
                "main 17", smi, nsample=NSAMPLE_17, every=False)
    finally:
        loader.load_run = orig
    if len(loads) != 1 or cnative.CALLS < N_LOCI_10K:
        raise AssertionError(f"main 17: {len(loads)} loads, "
                             f"{cnative.CALLS} native compressions")
    eng, state = ends.last
    print(f"[main 17] {N_LOCI_10K} loci loaded in {loads[0]:.2f} s through "
          f"the native compressor ({cnative.CALLS} compressions) | {smi}")
    err, _ = hold_given(f"K1, main 17's last state (all {N_LOCI_10K} loci)",
                        eng, state, smi, tag="main 17")
    profile_last(eng, state, smi, "pack_logl_kernel",
                 f"JC69 step at {N_LOCI_10K} loci (main 17)",
                 PASSES_PER_ITER)
    del eng, state, ends
    torch.cuda.empty_cache()
    return launches, err


def main18(smi):
    """``[main 18]``: ``chains = 8`` on main 1's first 100 loci (the shape
    of ``bench.py``'s ``_bench_chains8``) through the CLI, 20 iterations:
    K1 8 x (8 x 20 + 1); eight finite moving mcmc files and the pooled
    split-R-hat table; K1 held on the last chain's last state; the
    ``[profile]`` of the eight-chain step.  Returns (K1 launches, the
    hold's error)."""
    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.mcmc.driver import Engine
    with open("run18.ctl", "w") as f:
        f.write(new_ctl(18, N_LOCI_18))
    iters = NEW_BURNIN + NEW_NSAMPLE
    with ChainEnds() as ends:
        launches, _ = run_chain(
            ["--cfile", "run18.ctl"], "out18", iters,
            (PASSES_PER_ITER * iters + CHAINS_18, 0),
            ("theta", "tau"), "main 18", smi, figtree=False,
            nsample=NEW_NSAMPLE)
    files, rhat = check_chains("out18", CHAINS_18, NEW_NSAMPLE, "main 18")
    print(f"[main 18] {CHAINS_18} chains on {N_LOCI_18} loci: {len(files)} "
          f"mcmc files of {NEW_NSAMPLE} finite moving samples; split-R-hat "
          f"table ({rhat}, ...) | {smi}")
    eng, state = ends.last
    err, _ = hold_given("K1, main 18's last chain's last state", eng, state,
                        smi, tag="main 18")
    chains, states = Chains.start(
        Engine(load_run_from_ctl("run18.ctl"), seed=1, device=eng.device),
        CHAINS_18)
    states, _ = chains.chunk_step(states, 3)
    profile_last(chains, states, smi, "pack_logl_kernel",
                 f"JC69 {CHAINS_18}-chain step, {N_LOCI_18} loci (main 18, "
                 "batched)", PASSES_PER_ITER, iters=1)
    return launches, err


def main23(iters, smi):
    """``[main 23]``: main 2's diploid HKY+G4 control file with ``chains =
    4`` on its 1000 loci through the CLI, on the batched route: K2
    launched 12 times an iteration for all four chains (not 4 x 12) plus
    one initial state a chain, K1 never; four mcmc files of finite
    samples, some theta and some tau column moving in each (the mu_bar
    column left out: under ``chains = K`` it is nan, as ``bpp_tpu``
    writes it) and the pooled split-R-hat table;
    K2 held on the last chain's last state.  Returns (K2 launches, the
    hold's error)."""
    with open("run23.ctl", "w") as f:
        f.write(RUN2_CTL.format(nloci=N_LOCI, burnin=BURNIN, nsample=NSAMPLE,
                                job="out23",
                                extra=f"chains = {CHAINS_23}\n"))
    # at 1000 diploid loci a tau may stay put for 40 samples (chain 4's
    # tau:6 and tau:7 do, on either chains route): each chain must move
    # some theta and some tau
    with ChainEnds() as ends:
        _, launches = run_chain(
            ["--cfile", "run23.ctl"], "out23", iters,
            (0, PASSES_PER_ITER_2 * iters + CHAINS_23), ("theta", "tau"),
            "main 23", smi, figtree=False, every=False, skip=("mu_bar",))
    files, rhat = check_chains("out23", CHAINS_23, NSAMPLE, "main 23",
                               skip=("mu_bar",), moving=("theta", "tau"))
    eng, state = ends.last
    if eng.chains_route != "batched":
        raise AssertionError(f"main 23: chains route {eng.chains_route} "
                             f"({eng.chains_route_reason})")
    print(f"[main 23] {CHAINS_23} diploid HKY+G4 chains on {N_LOCI} loci: "
          f"{len(files)} mcmc files of {NSAMPLE} finite samples, theta and "
          f"tau moving; "
          f"split-R-hat table ({rhat}, ...); K2 {launches} launches = "
          f"{PASSES_PER_ITER_2} x {iters} + {CHAINS_23} | {smi}")
    err, _ = hold_given("K2, main 23's last chain's last state", eng, state,
                        smi, tag="main 23")
    return launches, err


def main24(iters, smi):
    """``[main 24]``: A10 on main 1's data (``speciesdelimitation = 1 0
    2``, ``speciestree = 0``) with Gamma-Dirichlet locus rates and
    ``chains = 4`` through the CLI, on the batched route: K1 once a pass
    for the four chains (10 an iteration) plus one initial state a chain,
    K4 once an iteration; four mcmc files of finite samples, some theta
    and some tau column moving in each, the split-R-hat table and the A10
    report (the pooled delimitations, each chain's P(#species)); K1 held
    on the last chain's last state.  Returns (K1 launches, the hold's
    error)."""
    with open("run24.ctl", "w") as f:
        f.write(RUN_CTL.format(nloci=N_LOCI, burnin=BURNIN, nsample=NSAMPLE,
                               job="out24",
                               extra=A10_24.format(k=CHAINS_24)))
    with ChainEnds() as ends:
        launches, _ = run_chain(
            ["--cfile", "run24.ctl"], "out24", iters,
            (PASSES_PER_ITER_24 * iters + CHAINS_24, 0), ("theta", "tau"),
            "main 24", smi, figtree=False, every=False,
            chains=(0, K4_PER_ITER_24 * iters, 0))
    files, rhat = check_chains("out24", CHAINS_24, NSAMPLE, "main 24",
                               moving=("theta", "tau"))
    eng, state = ends.last
    if eng.chains_route != "batched":
        raise AssertionError(f"main 24: chains route {eng.chains_route} "
                             f"({eng.chains_route_reason})")
    with open("out24.txt") as f:
        report = f.read()
    per_chain = report.split("Per-chain P(#species):\n")[-1].splitlines()
    if len([ln for ln in per_chain if ln.startswith("  chain ")]) \
            != CHAINS_24:
        raise AssertionError("main 24: out24.txt lacks a chain's "
                             "P(#species) line")
    print(f"[main 24] A10 with Gamma-Dirichlet locus rates, {CHAINS_24} "
          f"chains on {N_LOCI} loci: {len(files)} mcmc files of {NSAMPLE} "
          f"finite samples, theta and tau moving; split-R-hat table "
          f"({rhat}, ...); P(#species) " + "; ".join(
              ln.strip() for ln in per_chain[:CHAINS_24])
          + f"; K1 {launches} launches = {PASSES_PER_ITER_24} x {iters} + "
          f"{CHAINS_24}, K4 {K4_PER_ITER_24 * iters} | {smi}")
    err, _ = hold_given("K1, main 24's last chain's last state", eng, state,
                        smi, tag="main 24")
    return launches, err


def main25(iters, smi):
    """``[main 25]``: main 1's data with integrated thetas and ``chains =
    4`` through the CLI, on the batched route: K1 8 an iteration for the
    four chains plus one initial state a chain, K3 5 an iteration; four
    mcmc files of finite samples without theta columns, tau moving; K1
    held on the last chain's last state.  Returns (K1 launches, the
    hold's error)."""
    with open("run25.ctl", "w") as f:
        f.write(RUN_CTL.format(nloci=N_LOCI, burnin=BURNIN, nsample=NSAMPLE,
                               job="out25",
                               extra=INT_25.format(k=CHAINS_25)))
    with ChainEnds() as ends:
        launches, _ = run_chain(
            ["--cfile", "run25.ctl"], "out25", iters,
            (PASSES_PER_ITER * iters + CHAINS_25, 0), ("tau",), "main 25",
            smi, figtree=False, every=False,
            chains=(K3_PER_ITER_5 * iters, 0, 0))
    files, rhat = check_chains("out25", CHAINS_25, NSAMPLE, "main 25",
                               moving=("tau",))
    with open(files[0]) as f:
        if "theta" in f.readline():
            raise AssertionError("main 25: theta columns with thetas "
                                 "integrated out")
    eng, state = ends.last
    if eng.chains_route != "batched":
        raise AssertionError(f"main 25: chains route {eng.chains_route} "
                             f"({eng.chains_route_reason})")
    print(f"[main 25] integrated thetas, {CHAINS_25} chains on {N_LOCI} "
          f"loci: {len(files)} mcmc files of {NSAMPLE} finite samples, no "
          f"theta column, tau moving; split-R-hat table ({rhat}, ...); K1 "
          f"{launches} launches = {PASSES_PER_ITER} x {iters} + "
          f"{CHAINS_25}, K3 {K3_PER_ITER_5 * iters} | {smi}")
    err, _ = hold_given("K1, main 25's last chain's last state", eng, state,
                        smi, tag="main 25")
    return launches, err


def mig_chains_main(n, extra, passes, smi):
    """``[main 26]`` / ``[main 27]``: main 12's control file with ``extra``
    and ``chains = 4`` through ``cli.main`` on the batched route: K1 once
    a pass for the four chains (``passes`` an iteration) plus one initial
    state a chain, K5 once a sim-SPR round for the four (3 an iteration);
    routes and events consistent in every state of every chain, events in
    the chains' last states and ``validate_state`` on each; four mcmc files
    of finite samples with theta, tau and the ``W:`` columns moving, the
    split-R-hat table (under A10 the report's P(#species) of each chain);
    K1 held on the last chain's last state, and K5 on a sim-SPR move from
    it (one chain's walk, :class:`ChainHolds`).  Returns (K1 launches, the
    K1 hold's error, the K5 hold's)."""
    import torch

    from bpp_tpu_torch.mcmc import mig_moves
    from bpp_tpu_torch.testing import MIG_RUN
    K, label = CHAINS_26, f"main {n}"
    mig_run = RUN_CTL.replace("seqfile = sim.phy", "seqfile = sim12.phy") \
        .replace("Imapfile = sim.Imap.txt", "Imapfile = sim12.Imap.txt")
    with open(f"run{n}.ctl", "w") as f:
        f.write(mig_run.format(nloci=N_LOCI, burnin=SHORT_BURNIN,
                               nsample=SHORT_NSAMPLE, job=f"out{n}",
                               extra=MIG_RUN + MIG_WPRIOR + extra
                               + f"chains = {K}\n"))
    iters = SHORT_BURNIN + SHORT_NSAMPLE
    moving = ("theta", "tau", "W:")
    with StepWatch(mig=True, keep=K) as watch:
        launches, _ = run_chain(
            ["--cfile", f"run{n}.ctl"], f"out{n}", iters,
            (passes * iters + K, 0), moving, label, smi,
            nsample=SHORT_NSAMPLE, figtree=False, every=False,
            chains=(0, 0, K5_PER_ITER_12 * iters))
    eng, _ = watch.last
    if eng.chains_route != "batched":
        raise AssertionError(f"{label}: chains route {eng.chains_route} "
                             f"({eng.chains_route_reason})")
    consistent = bool(torch.stack(watch.flags).all())
    if len(watch.flags) != iters * K or not consistent:
        raise AssertionError(f"{label}: {len(watch.flags)} chain states, "
                             f"routes and events consistent in all: "
                             f"{consistent}")
    events = [int(st.mig.count().sum()) for st in watch.kept]
    if len(events) != K or not sum(events):
        raise AssertionError(f"{label}: migration events in the chains' "
                             f"last states {events}")
    for st in watch.kept:
        eng.validate_state(st)
    files, rhat = check_chains(f"out{n}", K, SHORT_NSAMPLE, label,
                               moving=moving)
    a10 = ""
    if eng.cfg.est_delimit:
        with open(f"out{n}.txt") as f:
            report = f.read()
        per_chain = report.split("Per-chain P(#species):\n")[-1] \
            .splitlines()[:K]
        if len([ln for ln in per_chain if ln.startswith("  chain ")]) != K:
            raise AssertionError(f"{label}: out{n}.txt lacks a chain's "
                                 "P(#species) line")
        a10 = "; P(#species) " + "; ".join(ln.strip() for ln in per_chain)
    print(f"[{label}] MSC-M{' x A10' if a10 else ''}, {K} chains on "
          f"{N_LOCI} loci: routes and events consistent in all {iters} x "
          f"{K} chain states; validate_state passed on each chain's last, "
          f"migration events there {events}; {len(files)} mcmc files of "
          f"{SHORT_NSAMPLE} finite samples, theta, tau and W: moving; "
          f"split-R-hat table ({rhat}, ...){a10}; K1 {launches} launches = "
          f"{passes} x {iters} + {K}, K5 {K5_PER_ITER_12 * iters} = "
          f"{K5_PER_ITER_12} x {iters} | {smi}")
    state = watch.kept[-1]
    err, _ = hold_given(f"K1, {label}'s last chain's last state", eng,
                        state, smi, tag=label)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(n)
    with ChainHolds() as holds:
        mig_moves.spr_sim_move(eng.ctx, eng.cfg, eng.mig_routes, state, gen)
    torch.cuda.synchronize()
    r = holds.rec["K5"]
    if r["calls"] != 1 or sum(r["near"]) > max(1, r["loci"] // 1000):
        raise AssertionError(f"[{label}] K5: {r['calls']} calls held, "
                             f"{sum(r['near'])} loci near a tie")
    print(f"[{label}] K5 on a sim-SPR move from the last chain's last state: "
          f"{r['loci']} walks compared with the plain version, decisions "
          f"equal where clear of a tie ({sum(r['near'])} near one), max "
          f"|dt| {r['err']:.3e} | {smi}")
    return launches, err, r["err"]


def main28(smi):
    """``[main 28]``: main 10's control file (the MSC-I network
    ``testing.NET_GUIDE``, 1000 loci, ``phiprior = 1 1``, burnin 5,
    nsample 20) with ``chains = 4`` through ``cli.main`` on the batched
    route: K1 once a pass for the four chains (11 an iteration) plus one
    initial state a chain, K2-K5 never; the routes consistent in every
    state of every chain and ``validate_state`` on each chain's last;
    four mcmc files of finite samples with theta, tau and phi moving in
    each, the split-R-hat table; K1 held on the last chain's last state.
    Returns (K1 launches, the hold's error)."""
    import torch
    K, label = CHAINS_28, "main 28"
    cut_ctl("run10.ctl", "run28.ctl", job="out28")
    with open("run28.ctl", "a") as f:
        f.write(f"chains = {K}\n")
    iters = SHORT_BURNIN + SHORT_NSAMPLE
    moving = ("theta", "tau", "phi")
    with StepWatch(keep=K) as watch:
        launches, _ = run_chain(
            ["--cfile", "run28.ctl"], "out28", iters,
            (PASSES_PER_ITER_10 * iters + K, 0), moving, label, smi,
            nsample=SHORT_NSAMPLE, figtree=False, every=False)
    eng, _ = watch.last
    if eng.chains_route != "batched":
        raise AssertionError(f"{label}: chains route {eng.chains_route} "
                             f"({eng.chains_route_reason})")
    consistent = bool(torch.stack(watch.flags).all())
    if len(watch.flags) != iters * K or not consistent:
        raise AssertionError(f"{label}: {len(watch.flags)} chain states, "
                             f"routes consistent in all: {consistent}")
    for st in watch.kept:
        eng.validate_state(st)
    files, rhat = check_chains("out28", K, SHORT_NSAMPLE, label,
                               moving=moving)
    print(f"[{label}] MSC-I, {K} chains on {N_LOCI} loci: routes "
          f"consistent in all {iters} x {K} chain states; validate_state "
          f"passed on each chain's last; {len(files)} mcmc files of "
          f"{SHORT_NSAMPLE} finite samples, theta, tau and phi moving in "
          f"each; split-R-hat table ({rhat}, ...); K1 {launches} launches "
          f"= {PASSES_PER_ITER_10} x {iters} + {K} | {smi}")
    err, _ = hold_given(f"K1, {label}'s last chain's last state", eng,
                        watch.kept[-1], smi, tag=label)
    return launches, err


def main29(smi):
    """``[main 29]``: main 20's control file (GTR+G4, 1000 loci, burnin
    8, nsample 12) with ``chains = 4`` through ``cli.main`` on the
    batched route, each chain with its own eigensystem (``eigh_jacobi``
    over the four chains' loci in the captured step): K1 once a pass for
    the four chains (15 an iteration) plus one initial state a chain,
    K2-K5 never; four mcmc files of finite samples with theta and tau
    moving in each, the split-R-hat table; in every chain the
    frequencies, exchangeabilities and alpha moved between its first and
    last iteration and no NaN eigensystem accepted; K1 held on the last
    chain's last state against its float64 plain version.  Returns (K1
    launches, the hold's error)."""
    import torch
    K, label = CHAINS_29, "main 29"
    cut_ctl("run20.ctl", "run29.ctl", job="out29")
    with open("run29.ctl", "a") as f:
        f.write(f"chains = {K}\n")
    iters = NEW_BURNIN + NEW_NSAMPLE
    moving = ("theta", "tau")
    with StepWatch(keep=K) as watch:
        launches, _ = run_chain(
            ["--cfile", "run29.ctl"], "out29", iters,
            (PASSES_PER_ITER_20 * iters + K, 0), moving, label, smi,
            nsample=NEW_NSAMPLE, figtree=False, every=False)
    eng, _ = watch.last
    if eng.chains_route != "batched":
        raise AssertionError(f"{label}: chains route {eng.chains_route} "
                             f"({eng.chains_route_reason})")
    files, rhat = check_chains("out29", K, NEW_NSAMPLE, label,
                               moving=moving)
    mask = eng.ctx.locus_mask
    moved = []
    for first, last in zip(watch.firsts, watch.kept):
        moved.append(moved_loci(first, last, mask, (
            ("subst", "freqs"), ("subst", "qrates"), ("subst", "alpha"))))
        if not bool(torch.isfinite(last.subst.eigw[mask]).all()):
            raise AssertionError(f"{label}: a NaN eigensystem was accepted")
    print(f"[{label}] GTR+G4, {K} chains on {N_LOCI} loci, batched: "
          f"{len(files)} mcmc files of {NEW_NSAMPLE} finite samples, theta "
          f"and tau moving in each; split-R-hat table ({rhat}, ...); loci "
          f"whose parameters moved, a chain: {moved}; no NaN eigensystem "
          f"accepted; K1 {launches} launches = {PASSES_PER_ITER_20} x "
          f"{iters} + {K} | {smi}")
    last = watch.kept[-1]
    err, _ = hold_given(f"K1, {label}'s last chain's last state", eng, last,
                        smi, cases=own_cases(eng, last), tag=label)
    return launches, err


def subst_main(n, model, passes, smi):
    """``[main 19]`` / ``[main 20]``: main 1's data under ``model`` + G4
    (``alphaprior = 1 1 4``) through the CLI, 20 iterations: K1 ``passes``
    times an iteration plus 1; the frequencies, rates and alpha, which
    mcmc.txt does not print, moved; under GTR the eigensystems the moves
    computed (``pmatrix.eigh_jacobi`` in float32 on the card) that came
    out NaN, which the moves reject, counted on the device (a replayed
    graph adds its count each replay; its warm-up iteration counts too);
    K1 held on the last state's own parameters; the ``[profile]`` of the
    step there.  Returns (K1 launches, the hold's error)."""
    import torch

    from bpp_tpu_torch.mcmc import subst_moves
    label = f"main {n}"
    with open(f"run{n}.ctl", "w") as f:
        f.write(new_ctl(n, N_LOCI))
    iters = NEW_BURNIN + NEW_NSAMPLE
    eigen = []                       # the loci of each refresh call
    nan = torch.zeros((), dtype=torch.int64, device="cuda")
    orig = subst_moves.refresh_eigen

    def counted(subst, model_, custom=None, jacobi=False):
        out = orig(subst, model_, custom, jacobi)
        if out.eigw is not subst.eigw:
            nan.add_((~torch.isfinite(out.eigw).all(-1)).sum())
            eigen.append(out.eigw.shape[0])
        return out

    subst_moves.refresh_eigen = counted
    try:
        with ChainEnds() as ends:
            launches, _ = run_chain(
                ["--cfile", f"run{n}.ctl"], f"out{n}", iters,
                (passes * iters + 1, 0), ("theta", "tau"), label, smi,
                nsample=NEW_NSAMPLE)
    finally:
        subst_moves.refresh_eigen = orig
    eng, state = ends.last
    mask = eng.ctx.locus_mask
    moved = moved_loci(ends.first, state, mask, (
        ("subst", "freqs"), ("subst", "qrates"), ("subst", "alpha")))
    if not bool(torch.isfinite(state.subst.eigw[mask]).all()):
        raise AssertionError(f"{label}: a NaN eigensystem was accepted")
    nans = (f"; {int(nan)} NaN eigensystems proposed ({eigen[0]} a "
            f"refresh), each rejected" if model == "GTR" else "")
    if model == "GTR" and not eigen:
        raise AssertionError(f"{label}: no eigensystem was computed")
    print(f"[{label}] {model}+G4: loci whose parameters moved {moved} of "
          f"{int(mask.sum())}{nans} | {smi}")
    err, _ = hold_given(f"K1, {label}'s last state", eng, state, smi,
                        cases=own_cases(eng, state), tag=label)
    profile_last(eng, state, smi, "pack_logl_kernel",
                 f"{model}+G4 step ({label})", passes)
    return launches, err


def main21(smi):
    """``[main 21]``: main 2's diploid data with Gamma-Dirichlet locus rates
    and the correlated clock (``CORR21``) through the CLI, 20 iterations:
    K2 ``PASSES_PER_ITER_21`` times an iteration plus 1 plus 1 a check,
    every check passing; mu_i, nu_i and the branch rates moved; K2 held on
    the relaxed branch lengths of the last state (the four families and
    the state's own HKY+G4); ``[moves]``: one ``gammadir_accept`` call, the
    mu_i, nu_i and branch-rate moves; the ``[profile]`` of the step.
    Returns (K2 launches, the hold's error)."""
    import torch

    from bpp_tpu_torch.mcmc import clock_moves
    with open("run21.ctl", "w") as f:
        f.write(new_ctl(21, N_LOCI))
    iters = NEW_BURNIN + NEW_NSAMPLE
    with Checks() as checks, ChainEnds() as ends:
        _, launches = run_chain(
            ["--cfile", "run21.ctl"], "out21", iters,
            (0, PASSES_PER_ITER_21 * iters + 1 + NEW_CHECKS),
            ("theta", "tau", "nu"), "main 21", smi, nsample=NEW_NSAMPLE,
            chains=(0, K4_PER_ITER_21 * iters, 0))
    checks.expect("main 21", NEW_BURNIN, NEW_NSAMPLE)
    eng, state = ends.last
    ctx, cfg, gen = eng.ctx, eng.cfg, eng.gen
    moved = moved_loci(ends.first, state, ctx.locus_mask, (
        ("subst", "mu"), ("clock", "nu"), ("clock", "brate")))
    print(f"[main 21] {len(checks.its)} checks passed at iterations "
          f"{checks.its}; loci whose rates moved {moved} of "
          f"{int(ctx.locus_mask.sum())} | {smi}")
    cases = fixed_cases(state.gt.n_loci, ctx.weights.device) + \
        own_cases(eng, state)
    err, _ = hold_given("K2, main 21's relaxed blen (clock = 3)", eng,
                        state, smi, lambda dt: relaxed_blen(eng, state, dt),
                        cases=cases, tag="main 21")
    mu = state.subst.mu
    zero = torch.zeros_like(mu)
    u = torch.rand(mu.shape, dtype=mu.dtype, device=mu.device)
    rows = [("gammadir_accept (mu_i, K4)", wall_ms(lambda: clock_moves.gammadir_accept(
        ctx, mu, mu * 1.01, zero, zero, u, cfg.locusrate_mubar_a,
        cfg.locusrate_mubar_b, cfg.locusrate_alpha)))]
    for name, fn in (("mu_i", clock_moves.mui_move),
                     ("nu_i", clock_moves.nui_move),
                     ("branch rates (clock = 3)", clock_moves.brate_move)):
        rows.append((name, wall_ms(lambda: fn(ctx, cfg, state, gen))))
    print(f"[moves] main 21, wall ms per call at {state.gt.n_loci} loci: "
          + " | ".join(f"{n} {t:.2f}" for n, t in rows) + f" | {smi}")
    profile_last(eng, state, smi, "fels_site_logl_kernel",
                 "diploid HKY+G4 clock = 3, Gamma-Dirichlet step (main 21)",
                 PASSES_PER_ITER_21)
    return launches, err


def main22(smi):
    """``[main 22]``: main 15's data and traits under ``clock = 2`` with
    A01's species moves and ``check = 10`` through the CLI, 20
    iterations: K1 ``PASSES_PER_ITER_22`` times an iteration plus 1 plus 1
    a check; the cached trait logl equal to a fresh evaluation at every
    check; SPR, SNL and the trait move proposed, the trait move accepted;
    the A01 report as main 6's; K1 held on the relaxed branch lengths of
    the last state; the ``[profile]`` of the step.  Returns (K1 launches,
    the hold's error)."""
    from bpp_tpu_torch.testing import write_trait_file
    write_trait_file("traits.txt", seed=137)
    with open("run22.ctl", "w") as f:
        f.write(new_ctl(22, N_LOCI))
    iters = NEW_BURNIN + NEW_NSAMPLE
    from bpp_tpu_torch.mcmc.state import MV_SNL, MV_SSPR, MV_TRAIT
    with Checks() as checks, ChainEnds() as ends, MoveStats() as tally:
        launches, _ = run_chain(
            ["--cfile", "run22.ctl"], "out22", iters,
            (PASSES_PER_ITER_22 * iters + 1 + NEW_CHECKS, 0), "A01",
            "main 22", smi, nsample=NEW_NSAMPLE)
    checks.expect("main 22", NEW_BURNIN, NEW_NSAMPLE, traits=True)
    counts = {n: tuple(tally.stats[mv]) for n, mv in (
        ("species SPR", MV_SSPR), ("SNL", MV_SNL), ("traits", MV_TRAIT))}
    if not (counts["species SPR"][0] and counts["SNL"][0]
            and counts["species SPR"][0] + counts["SNL"][0] == iters
            and counts["traits"][0] and counts["traits"][1]):
        raise AssertionError(f"main 22: moves (proposed, accepted) "
                             f"{counts}")
    print(f"[main 22] {len(checks.its)} checks passed at iterations "
          f"{checks.its}, the cached trait logl equal to a fresh evaluation "
          f"at each; moves (proposed, accepted) {counts} | {smi}")
    eng, state = ends.last
    err, _ = hold_given("K1, main 22's relaxed blen (clock = 2, A01)", eng,
                        state, smi, lambda dt: relaxed_blen(eng, state, dt),
                        tag="main 22")
    profile_last(eng, state, smi, "pack_logl_kernel",
                 "A01 JC69 traits clock = 2 step (main 22)",
                 PASSES_PER_ITER_22)
    return launches, err


# [chains]: eager iterations whose K3/K4 calls (mains 5, 21) and K5 calls
# (mains 12, 14) are each held against the plain version on the same
# inputs; a decision whose margin is under the tie width may go either way
# (lgamma/log on the card and on the host differ by ulps; a float32 sum
# of another order), and such loci are counted and gated
CHAIN_ITERS = 5
WALK_ITERS = 2
CHAIN_TIE = 1e-9          # |log u - ln acceptance|, K3/K4
WALK_TIE = 1e-6           # relative, K5
WALK_RTOL = {"torch.float32": 1e-5, "torch.float64": 1e-12}


def chain_masks_agree(name, got, want, margin):
    """K3/K4's accept masks equal up to the first disagreement, which must
    sit at a near tie (the chains part there), with at most one near tie:
    (loci compared before the first disagreement, near ties, the largest
    |kernel - plain| of the 0/1 decisions through the first disagreement,
    whether they disagree)."""
    import numpy as np
    got = got.cpu().numpy()
    want = want.cpu().numpy()
    near = margin < CHAIN_TIE
    differ = np.flatnonzero(got != want)
    upto = len(got) if not len(differ) else differ[0]
    if len(differ) and not near[differ[0]]:
        raise AssertionError(
            f"[chains] {name}: the kernel's accept mask differs from the "
            f"plain version's at locus {differ[0]} (margin "
            f"{margin[differ[0]]:.3e} >= {CHAIN_TIE})")
    if near.sum() > 1:
        raise AssertionError(f"[chains] {name}: {int(near.sum())} loci "
                             f"of one call within {CHAIN_TIE} of a tie")
    seen = min(int(upto) + 1, len(got))
    err = float(np.abs(got[:seen].astype(np.float64)
                       - want[:seen].astype(np.float64)).max(initial=0.0))
    return int(upto), int(near.sum()), err, len(differ) > 0


class ChainHolds:
    """While active, every call of the K3 (``notheta.chain_accept``), K4
    (``clock_moves.gammadir_accept``) and K5 (``mig_moves.simspr_walk``)
    wrappers on the card launches the kernel and then runs the plain
    version on the same inputs (K3/K4 on the host in float64, K5 in torch
    ops on the card), compares, and keeps the last call's inputs for
    timing.  These comparison calls are not main-path runs."""

    def __init__(self):
        self.rec = {k: {"calls": 0, "loci": 0, "near": [], "err": None,
                        "differ": 0, "last": None}
                    for k in ("K3", "K4", "K5")}

    def __enter__(self):
        from bpp_tpu_torch.mcmc import clock_moves, mig_moves, notheta
        self._saved = [(notheta, "chain_accept", notheta.chain_accept),
                       (clock_moves, "gammadir_accept",
                        clock_moves.gammadir_accept),
                       (mig_moves, "simspr_walk", mig_moves.simspr_walk)]
        notheta.chain_accept = self._k3(notheta.chain_accept)
        clock_moves.gammadir_accept = self._k4(clock_moves.gammadir_accept)
        mig_moves.simspr_walk = self._k5(mig_moves.simspr_walk)
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self._saved:
            setattr(mod, name, orig)

    def _masks(self, name, got, want, margin):
        upto, near, err, differ = chain_masks_agree(name, got, want, margin)
        r = self.rec[name]
        r["calls"] += 1
        r["loci"] += upto
        r["near"].append(near)
        r["err"] = err if r["err"] is None else max(r["err"], err)
        r["differ"] += int(differ)

    def _k3(self, orig):
        import numpy as np

        def held(a, b, cols, sums, H, margin=None):
            got = orig(a, b, cols, sums, H)
            m = np.full(cols.shape[0], np.inf)
            want = orig(a, b, cols.cpu(), sums.cpu(), H, margin=m)
            self._masks("K3", got, want, m)
            self.rec["K3"]["last"] = (a, b, cols.clone(), sums.clone(), H)
            return got
        return held

    def _k4(self, orig):
        import types

        import numpy as np
        import torch

        def held(ctx, old, new, dlog, ddens, us, a_bar, b_bar, a_i,
                 margin=None):
            got = orig(ctx, old, new, dlog, ddens, us, a_bar, b_bar, a_i)
            m = np.full(old.shape[0], np.inf)
            host = types.SimpleNamespace(locus_mask=ctx.locus_mask.cpu(),
                                         shard=None)
            want = orig(host, *(x.cpu() for x in (old, new, dlog, ddens, us)),
                        a_bar, b_bar, a_i, margin=m)
            self._masks("K4", got, want, m)
            terms = torch.stack([x.double() for x in (
                old, new, dlog, ddens, us, ctx.locus_mask)], 1)
            self.rec["K4"]["last"] = (terms, a_bar, b_bar, a_i)
            return got
        return held

    def _k5(self, orig):
        def held(*args):
            got = orig(*args)
            valid, near, err, steps = walks_agree("K5", args, got)
            r = self.rec["K5"]
            r["calls"] += 1
            r["loci"] += valid
            r["near"].append(near)
            r["err"] = err if r["err"] is None else max(r["err"], err)
            r["last"] = (args, steps)
            return got
        return held


def walks_agree(name, args, got):
    """K5's walks ``got`` on ``args`` held against the plain version
    (``simspr_walk_ref``, on the card) on the same inputs: ends,
    populations, outcomes, event counts, sources and destinations equal,
    times within ``WALK_RTOL``, on every valid locus whose decisions clear
    a relative margin of ``WALK_TIE``.  Returns (valid loci, valid loci
    near a tie, max |dt| of a clear walk, the steps each locus took)."""
    import torch

    from bpp_tpu_torch.mcmc import mig_moves
    L, dt = args[0].shape[0], args[0].dtype
    margin = torch.empty(L, dtype=dt, device=args[0].device)
    steps = torch.zeros(L, dtype=torch.int64, device=args[0].device)
    want = mig_moves.simspr_walk_ref(*args, margin=margin, steps=steps)
    valid = args[17]
    clear = (margin >= WALK_TIE) & valid
    tol = WALK_RTOL[str(dt)]
    t, p, done, fail, nt, ns, nd, nn = got
    tw, pw, dw, fw, ntw, nsw, ndw, nnw = want
    same = ((done == dw) & (fail == fw) & (p == pw) & (nn == nnw)
            & (ns == nsw).all(1) & (nd == ndw).all(1)
            & ((t - tw).abs() <= tol * tw.abs())
            & ((nt - ntw).abs() <= tol * ntw.abs()).all(1))
    bad = clear & ~same
    if bool(bad.any()):
        i = int(torch.nonzero(bad)[0])
        raise AssertionError(
            f"[chains] {name}: locus {i} (relative margin "
            f"{float(margin[i]):.3e}) walked otherwise: kernel t "
            f"{float(t[i])} p {int(p[i])} done {bool(done[i])} fail "
            f"{bool(fail[i])} nn {int(nn[i])}, plain t "
            f"{float(tw[i])} p {int(pw[i])} done {bool(dw[i])} fail "
            f"{bool(fw[i])} nn {int(nnw[i])}")
    err = float(torch.where(clear, (t - tw).abs(),
                            torch.zeros_like(t)).max())
    return int(valid.sum()), int((~clear & valid).sum()), err, steps


def chain_bounds(name, last):
    """(bound ms, what bounds it) of one launch of K3/K4/K5 on ``last``:
    each input read once and each output written once over the HBM rate,
    against the operations the inputs need over the float64 (K3, K4) or
    the state's type's (K5) peak.  K3 counts 2 differences a population
    and, for each changed population of a proposing locus, 10 operations
    (lgamma and log as one each); K4 7 a locus and 8 a proposing one; K5,
    for each step each locus took, 8 a sub-edge, 6 a route and 20."""
    import torch
    if name == "K3":
        a, b, cols, sums, H = last
        L = cols.shape[0]
        ops = chain_proposing(name, last) * (2 * H + 3) + 10.0 * float(
            chain_changed(last).sum())
        nbytes = 8.0 * (cols.numel() + sums.numel()) + L
        flops = F64_FLOPS
    elif name == "K4":
        terms = last[0]
        L = terms.shape[0]
        ops = 7.0 * L + 8.0 * float((terms[:, 5] > 0.5).sum())
        nbytes = 8.0 * terms.numel() + L
        flops = F64_FLOPS
    else:
        args, steps = last
        t_lo, route_M, unif = args[0], args[13], args[18]
        L, E = t_lo.shape
        K = route_M.shape[1]
        ME = args[19]
        H = args[5].shape[0]
        tb = t_lo.element_size()
        n_steps = float(steps.sum())
        nbytes = (L * E * (2 * tb + 8 + 1) + L * K * tb + H * H
                  + H * (3 * tb + 8) + K * (2 * tb + 16)
                  + L * (2 * tb + 8 + 1) + 3 * tb * n_steps
                  + L * (tb + 8 + 2 + 8) + L * ME * (tb + 16))
        ops = n_steps * (8.0 * E + 6.0 * K + 20.0)
        flops = F64_FLOPS if t_lo.dtype == torch.float64 else F32_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


# [chains]: the kernels' names in the profiler, and the held K3/K4/K5
# inputs tiled to this many loci (a timing input, not a main path)
CHAIN_KERNELS = {"K3": "notheta_chain_kernel", "K4": "gammadir_chain_kernel",
                 "K5": "simwalk_kernel"}
CHAIN_TILED_LOCI = 10000


def chain_launch(name, args):
    """One launch of K3 (``args``: a, b, cols, sums, H), K4 (terms, a_bar,
    b_bar, a_i) or K5 (``simspr_walk``'s arguments) through its launcher;
    returns the accept mask (K3, K4) or the eight outputs of the walks
    (K5)."""
    from bpp_tpu_torch.core import chains
    if name == "K3":
        a, b, cols, sums, H = args
        return chains.launch_notheta(cols, sums, H, a, b)
    if name == "K5":
        from bpp_tpu_torch.mcmc import mig_moves
        return chains.launch_simwalk(*args[:19], args[19],
                                     mig_moves.mg._FINITE_BIG,
                                     mig_moves.rng.tiny_floor(args[0].dtype))
    terms, a_bar, b_bar, a_i = args
    return chains.launch_gammadir(terms, a_bar, b_bar, a_i)


def chain_plain(name, args, margin=None):
    """K3's or K4's plain version on ``args`` (on the host, float64): the
    accept mask; ``margin`` as the plain versions take it."""
    import torch

    from bpp_tpu_torch.mcmc import notheta
    from bpp_tpu_torch.mcmc.clock_moves import _gammadir_chain
    if name == "K3":
        a, b, cols, sums, H = args
        return notheta.chain_accept(a, b, cols.cpu(), sums.cpu(), H,
                                    margin=margin)
    terms, a_bar, b_bar, a_i = args
    host = terms.cpu().T.numpy()
    mask = host[5] > 0.5
    nl = float(mask.sum())
    return torch.from_numpy(_gammadir_chain(host[:5], mask, a_bar, a_i * nl,
                                            b_bar / nl, a_i, margin))


def chain_proposing(name, args):
    """The proposing loci of a K3/K4 call."""
    if name == "K3":
        cols, H = args[2], args[4]
        return int((cols[:, 4 * H + 3] > 0.5).sum())
    return int((args[0][:, 5] > 0.5).sum())


def chain_changed(args):
    """[proposing loci, H]: the populations each proposing locus of a K3
    call changes."""
    _, _, cols, _, H = args
    prop = cols[:, 4 * H + 3] > 0.5
    changed = ((cols[:, H:2 * H] != cols[:, :H])
               | (cols[:, 3 * H:4 * H] != cols[:, 2 * H:3 * H]))
    return changed[prop]


# K5's per-locus arguments: the sub-edges, route rates, heredity, start
# and validity [L, ...]; the uniforms [3, S, L] carry loci last
WALK_PER_LOCUS = (0, 1, 2, 3, 13, 14, 15, 16, 17)


def tile_chain(name, args, loci=CHAIN_TILED_LOCI):
    """A K3/K4/K5 call's ``args`` repeated to about ``loci`` loci (whole
    copies; K3's starting sums times the copies, the sums of the copies'
    loci; K5's species and route tables as they are)."""
    import torch
    rows = args[2] if name == "K3" else args[0]
    n = max(1, round(loci / rows.shape[0]))
    if name == "K5":
        return tuple(torch.cat([x] * n) if i in WALK_PER_LOCUS else x
                     for i, x in enumerate(args[:18])) + (
            torch.cat([args[18]] * n, dim=2), args[19])
    if name == "K3":
        a, b, cols, sums, H = args
        return (a, b, cols.repeat(n, 1).contiguous(), sums * n, H)
    terms, a_bar, b_bar, a_i = args
    return (terms.repeat(n, 1).contiguous(), a_bar, b_bar, a_i)


def time_chain_cases(src, dst):
    """Launch and time every K3/K4/K5 case of ``src`` (``torch.save`` of
    [(kernel, args on the host)]) with the ``bpp_tpu_torch`` that is first
    on ``sys.path``: writes [(device ms a launch (profiler, one window of
    20), the accept mask or the walks' eight outputs)] to ``dst``."""
    import torch

    from bpp_tpu_torch.core import _build
    _build.build_all(("chain_kernel", "simwalk_kernel"))
    out = []
    for name, args in torch.load(src, weights_only=False):
        args = tuple(x.cuda() if torch.is_tensor(x) else x for x in args)
        ms = kernel_device_ms(lambda: chain_launch(name, args),
                              CHAIN_KERNELS[name], reps=20, windows=1)
        got = chain_launch(name, args)
        out.append((ms, tuple(x.cpu() for x in got) if name == "K5"
                    else got.cpu()))
    torch.save(out, dst)


def bits(x):
    """``x`` as integers of its width: floats compared bit for bit (NaN
    equal to itself, -0 apart from 0)."""
    import torch
    widths = {torch.float64: torch.int64, torch.float32: torch.int32}
    return x.view(widths[x.dtype]) if x.dtype in widths else x


def parent_chain_times(parent, cases, smi):
    """``[chains] parent``: the parent's K3/K4/K5 (``parent``, a checkout
    of the parent commit) built and timed on ``cases`` ([(kernel, args)])
    in a process of their own, then this tree's on the same cases; the
    parent's K3/K4 decisions held against this tree's (equal but at a near
    tie of the plain version's margins), its K5 walks bit-equal to this
    tree's in all eight outputs (the lineage count and the next boundary
    are order-free, the route sums keep their order: any difference is a
    fault).  Prints one line a case; returns [(kernel, loci, parent ms,
    this tree's ms)]."""
    import numpy as np
    import torch
    host = [(name, tuple(x.cpu() if torch.is_tensor(x) else x
                         for x in args)) for name, args in cases]
    with tempfile.TemporaryDirectory(prefix="bpp_parent_") as tmp:
        src, dst = os.path.join(tmp, "cases.pt"), os.path.join(tmp, "out.pt")
        torch.save(host, src)
        code = ("import importlib.util, sys\n"
                "sys.path.insert(0, sys.argv[1])\n"
                "spec = importlib.util.spec_from_file_location("
                "'smoke', sys.argv[2])\n"
                "m = importlib.util.module_from_spec(spec)\n"
                "spec.loader.exec_module(m)\n"
                "m.time_chain_cases(sys.argv[3], sys.argv[4])\n")
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c", code, os.path.abspath(parent),
                        os.path.abspath(__file__), src, dst],
                       cwd=os.path.abspath(parent), check=True, timeout=900)
        before = torch.load(dst, weights_only=False)
        print(f"[chains] parent: built and timed in "
              f"{time.perf_counter() - t0:.1f} s | {smi}")
        time_chain_cases(src, dst)
        after = torch.load(dst, weights_only=False)
    rows = []
    for (name, args), (p_ms, p_acc), (n_ms, n_acc) in zip(host, before,
                                                          after):
        L = (args[2] if name == "K3" else args[0]).shape[0]
        if name == "K5":
            differ = [what for what, a, b in zip(WALK_OUTPUTS, p_acc, n_acc)
                      if not torch.equal(bits(a), bits(b))]
            if differ:
                raise AssertionError(
                    f"[chains] K5 (L={L}): this tree's walks differ from the "
                    f"parent's build in {', '.join(differ)}")
            print(f"[chains] parent vs this tree: K5 {CHAIN_KERNELS[name]} "
                  f"(L={L}, E={args[0].shape[1]}, S={args[18].shape[1]}) | "
                  f"parent {p_ms:.4f} ms | this tree {n_ms:.4f} ms a launch "
                  f"({p_ms / n_ms:.2f}x) | walks bit-equal (all "
                  f"{len(WALK_OUTPUTS)} outputs) | {smi}")
            rows.append((name, L, p_ms, n_ms))
            continue
        margin = np.full(L, np.inf)
        chain_plain(name, args, margin)
        _, near, _, differ = chain_masks_agree(f"{name} parent vs this tree",
                                               n_acc, p_acc, margin)
        print(f"[chains] parent vs this tree: {name} {CHAIN_KERNELS[name]} "
              f"(L={L}, {chain_proposing(name, args)} proposing) | parent "
              f"{p_ms:.4f} ms | this tree {n_ms:.4f} ms a launch "
              f"({p_ms / n_ms:.2f}x) | decisions "
              + ("part at a near tie" if differ else "equal")
              + f" ({near} near a tie) | {smi}")
        rows.append((name, L, p_ms, n_ms))
    return rows


# K5's outputs, in the order the launcher returns them
WALK_OUTPUTS = ("t", "p", "done", "fail", "nt", "ns", "nd", "nn")


def walk_tiled(last, smi):
    """K5's line beyond the held call's: the held call (``last``: its
    arguments and steps) tiled to ``CHAIN_TILED_LOCI`` loci, held against
    the plain version under the held calls' gate and timed.  Returns the
    held and the tiled cases [(kernel, args)] for
    :func:`parent_chain_times`."""
    import torch

    from bpp_tpu_torch.core import chains
    args, _ = last
    saved = chains.launch_counts()
    tiled = tile_chain("K5", args)
    L = tiled[0].shape[0]
    got = chain_launch("K5", tiled)
    torch.cuda.synchronize()
    valid, near, err, steps = walks_agree("K5 tiled", tiled, got)
    if near > L // 1000:
        raise AssertionError(f"[chains] K5 tiled: {near} of {valid} loci "
                             f"within {WALK_TIE} of a tie")
    ms = kernel_device_ms(lambda: chain_launch("K5", tiled),
                          CHAIN_KERNELS["K5"], reps=20)
    chains.set_launch_counts(saved)
    bms, by = chain_bounds("K5", (tiled, steps))
    print(f"[chains] K5 {CHAIN_KERNELS['K5']} on the held call tiled to {L} "
          f"loci (a timing input): {valid} loci compared, decisions equal "
          f"where clear of a tie, {near} near a tie (gate at most "
          f"{L // 1000}), max |dt| {err:.3e} | device {ms:.4f} ms a launch "
          f"(profiler) | longest walk {int(steps.max())} steps | bound "
          f"{bms:.3e} ms ({by}) | {smi}")
    return [("K5", args), ("K5", tiled)]


def chain_tiled(name, last, smi):
    """K3's or K4's line beyond the held call's: the held call tiled to
    ``CHAIN_TILED_LOCI`` loci, held against the plain version under the
    same gates and timed.  Returns the held and the tiled cases [(kernel,
    args)] for :func:`parent_chain_times`."""
    import numpy as np
    import torch

    from bpp_tpu_torch.core import chains
    kname = CHAIN_KERNELS[name]
    saved = chains.launch_counts()
    tiled = tile_chain(name, last)
    L = (tiled[2] if name == "K3" else tiled[0]).shape[0]
    got = chain_launch(name, tiled)
    torch.cuda.synchronize()
    margin = np.full(L, np.inf)
    want = chain_plain(name, tiled, margin)
    _, near, _, differ = chain_masks_agree(f"{name} tiled", got, want, margin)
    ms = kernel_device_ms(lambda: chain_launch(name, tiled), kname, reps=20)
    chains.set_launch_counts(saved)
    prop = chain_proposing(name, tiled)
    bms, by = chain_bounds(name, tiled)
    print(f"[chains] {name} {kname} on the held call tiled to {L} loci (a "
          "timing input): decisions "
          + ("part at a near tie" if differ else "equal")
          + f" ({near} near a tie) | device {ms:.4f} ms a launch "
          f"(profiler) | {prop} proposing loci, {ms * 1e6 / prop:.1f} ns a "
          f"proposing locus | bound {bms:.3e} ms ({by}) | {smi}")
    return [(name, last), (name, tiled)]


def chains_phase(smi, parent=None):
    """``[chains]``: K3 on main 5's and K4 on main 21's accept chains, K5
    on main 12's and main 14's sim-SPR walks: eager iterations
    (``CHAIN_ITERS``, ``WALK_ITERS``) in which every call is held against
    the plain version (``ChainHolds``); then each kernel's device ms a
    launch (profiler) on the last call's inputs, the plain version's ms
    on them, and the bound.  K3/K4 also: proposing loci, ns a proposing
    locus and lookahead depth; K5 the steps of its longest walk; each
    kernel's last call tiled to ``CHAIN_TILED_LOCI`` loci, held and timed;
    with ``parent``, the parent's build on the held and tiled inputs
    (:func:`parent_chain_times`).  Returns {kernel: (device ms, plain ms,
    bound ms, bound by, max_abs_err)}."""
    import torch

    from bpp_tpu_torch.core import chains
    from bpp_tpu_torch.mcmc import mig_moves
    from bpp_tpu_torch.mcmc.driver import Engine
    holds = ChainHolds()
    with holds:
        for ctl, iters in (("run5.ctl", CHAIN_ITERS),
                           ("run21.ctl", CHAIN_ITERS),
                           ("run12.ctl", WALK_ITERS),
                           ("run14.ctl", WALK_ITERS)):
            eng = Engine(load_run(ctl), seed=1, device="cuda")
            eng.route = "eager"
            eng.chunk_step(eng.init_state(), iters)
            torch.cuda.synchronize()
            del eng
    torch.cuda.empty_cache()
    per_iter = {"K3": (K3_PER_ITER_5, "main 5"),
                "K4": (K4_PER_ITER_21, "main 21"),
                "K5": (K5_PER_ITER_12, "mains 12, 14")}
    rows, parent_cases = {}, []
    for name, kname in CHAIN_KERNELS.items():
        r = holds.rec[name]
        if not r["calls"]:
            raise AssertionError(f"[chains] {name}: no call held")
        last = r["last"]
        saved = chains.launch_counts()
        if name == "K5":
            args, steps = last

            def launch():
                chain_launch(name, args)

            def plain():
                mig_moves.simspr_walk_ref(*args)
            shape = (f"L={args[0].shape[0]} E={args[0].shape[1]} "
                     f"S={args[18].shape[1]} ME={args[19]}")
        else:
            def launch():
                chain_launch(name, last)

            def plain():
                chain_plain(name, last)
            L = (last[2] if name == "K3" else last[0]).shape[0]
            shape = f"L={L}" + (f" H={last[4]}" if name == "K3" else "")
            depth = chains.chain_depth(last[4] if name == "K3" else 1)
        ms = kernel_device_ms(launch, kname, reps=20)
        chains.set_launch_counts(saved)
        plain_ms = wall_ms(plain)
        bms, by = chain_bounds(name, last)
        n_iter, where = per_iter[name]
        near = r["near"]
        gate = ("at most 1 a call" if name != "K5" else
                f"at most {r['loci'] // 1000} in {r['loci']} loci")
        if name == "K5" and sum(near) > r["loci"] // 1000:
            raise AssertionError(f"[chains] K5: {sum(near)} of {r['loci']} "
                                 f"loci within {WALK_TIE} of a tie")
        held = (f"{r['loci']} loci compared, calls whose decisions "
                f"differ {r['differ']} (each at a near tie), max |kernel - "
                f"plain| of the 0/1 decisions {r['err']:.0f}"
                if name != "K5" else f"{r['loci']} loci compared, decisions "
                "equal where clear of a tie")
        walk = ""
        if name == "K5":
            walking = steps[steps > 0].double()
            walk = (f" | longest walk {int(steps.max())} steps (mean "
                    f"{float(walking.mean()):.1f} over {walking.numel()} "
                    "walking loci)")
        else:
            prop = chain_proposing(name, last)
            per = (float(chain_changed(last).sum(1).double().mean())
                   if name == "K3" else 0.0)
            walk = (f" | {prop} proposing loci, {ms * 1e6 / prop:.1f} ns a "
                    f"proposing locus" + (
                        f" ({per:.2f} populations changed a proposing locus)"
                        if name == "K3" else "")
                    + f" | lookahead depth {depth}")
        print(f"[chains] {name} {kname} ({shape}): {r['calls']} calls held, "
              f"{held}; loci near a tie "
              f"(< {CHAIN_TIE if name != 'K5' else WALK_TIE}) {sum(near)} "
              f"(max {max(near)} a call; gate {gate})"
              + (f", max |dt| {r['err']:.3e}" if name == "K5" else "")
              + f" | device {ms:.4f} ms a launch (profiler){walk} | {n_iter} "
              f"launches an iteration ({where}) | plain version {plain_ms:.2f}"
              f" ms | bound {bms:.3e} ms ({by}) | {smi}")
        rows[name] = (ms, plain_ms, bms, by, r["err"])
        parent_cases += (walk_tiled(last, smi) if name == "K5"
                         else chain_tiled(name, last, smi))
    if parent is not None:
        parent_chain_times(parent, parent_cases, smi)
    return rows


# [sync]: each main path's control file cut to this many loci (the ops a
# step runs do not depend on the locus count)
SYNC_LOCI = 20
# the main paths [sync] reads, by control file (x64: with --x64)
SYNC_MAINS = (
    ("main 1", "run.ctl", False), ("main 2", "run2.ctl", False),
    ("main 3", "run3.ctl", False), ("main 4", "run4.ctl", False),
    ("main 5", "run5.ctl", False), ("main 6", "run6.ctl", False),
    ("main 7", "run7.ctl", False), ("main 8", "run8.ctl", False),
    ("main 9", "run9.ctl", False), ("main 10", "run10.ctl", False),
    ("main 11", "run11.ctl", False), ("main 12", "run12.ctl", False),
    ("main 13", "run13.ctl", False), ("main 14", "run14.ctl", False),
    ("main 15", "run15.ctl", False), ("main 16", "run.ctl", True),
    ("main 16 diploid", "run2.ctl", True), ("main 17", "run17.ctl", False),
    ("main 18", "run18.ctl", False), ("main 19", "run19.ctl", False),
    ("main 20", "run20.ctl", False), ("main 21", "run21.ctl", False),
    ("main 22", "run22.ctl", False))
# [graph]: states compared after GRAPH_ITERS iterations on the mains
# whose CLI runs are compared too (main 1's eager wall, the host's
# marker, among them), GRAPH_FEW_ITERS on the others, from the initial
# state; the eager route's wall the median of GRAPH_WINDOWS timed windows
# of those iterations, the replayed route's the median of GRAPH_WINDOWS
# more windows of GRAPH_WINDOW_ITERS replays (GRAPH_HEAVY_WINDOW where an
# eager iteration takes about a second); a profiler trace of
# GRAPH_TRACE_ITERS iterations, the eager
# step's taken up to GRAPH_RETRACES times where it reads more than
# GRAPH_GATE below the replayed step's exact count (the fullest kept),
# the replayed step's once (its exact count is the graph's nodes, held
# within GRAPH_GATE of the eager trace); the CLI runs
# compared at burnin 8 (the first with finetune marks), nsample 4;
# [eigen]'s windows take GRAPH_WINDOW_ITERS iterations
GRAPH_WINDOWS = 3
GRAPH_WINDOW_ITERS = 3
GRAPH_HEAVY_WINDOW = 1
GRAPH_TRACE_ITERS = 1
GRAPH_RETRACES = 3
GRAPH_GATE = 25
GRAPH_ITERS = 6
GRAPH_FEW_ITERS = 3
# the mains whose eager iteration takes about a second (MSC-I, MSC-M):
# GRAPH_SLOW_ITERS compared iterations, a window each
GRAPH_SLOW = ("main 10", "main 11", "main 12", "main 14", "main 26",
              "main 27", "main 28")
GRAPH_SLOW_ITERS = 2
GRAPH_BURNIN, GRAPH_NSAMPLE = 8, 4


# cudaGraphNodeType (the runtime's driver_types.h): the device work a
# replay issues is its kernel, memcpy and memset nodes, the three kinds of
# device activity the profiler's trace holds
GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
                    4: "child graph", 5: "empty", 6: "event wait",
                    7: "event record", 8: "semaphore signal",
                    9: "semaphore wait", 10: "memory alloc",
                    11: "memory free", 12: "batch memop", 13: "conditional"}
GRAPH_DEVICE_NODES = ("kernel", "memcpy", "memset")


def cudart():
    """The CUDA runtime through ctypes, with the graph calls' signatures:
    the ``libcudart`` of torch's CUDA major version where the loader finds
    one (the process's own, where torch loaded it), else the toolkit's."""
    import ctypes

    import torch

    from bpp_tpu_torch.core import _build
    cuda_home = os.path.dirname(os.path.dirname(_build.nvcc_path()))
    names = [f"libcudart.so.{torch.version.cuda.split('.')[0]}",
             os.path.join(cuda_home, "lib64", "libcudart.so")]
    for name in names:
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError:
            continue
    else:
        raise RuntimeError(f"no CUDA runtime library among {names}")
    P, S = ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)
    lib.cudaGraphGetNodes.argtypes = [P, P, S]
    lib.cudaGraphGetNodes.restype = ctypes.c_int
    lib.cudaGraphNodeGetType.argtypes = [P, ctypes.POINTER(ctypes.c_int)]
    lib.cudaGraphNodeGetType.restype = ctypes.c_int
    lib.cudaGraphChildGraphNodeGetGraph.argtypes = [P, ctypes.POINTER(P)]
    lib.cudaGraphChildGraphNodeGetGraph.restype = ctypes.c_int
    return lib


def graph_nodes(graphs):
    """The nodes of captured CUDA graphs (``torch.cuda.CUDAGraph`` with
    ``keep_graph=True``), counted by type from each ``raw_cuda_graph()``
    with ``cudaGraphGetNodes`` / ``cudaGraphNodeGetType`` (a child graph's
    nodes counted in): {type name: count}, summed over ``graphs``.  Exact:
    no trace, nothing dropped."""
    import collections
    import ctypes
    lib = cudart()
    counts = collections.Counter()

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"[graph] {what} returned cudaError {rc}")

    def walk(handle):
        n = ctypes.c_size_t(0)
        check(lib.cudaGraphGetNodes(handle, None, ctypes.byref(n)),
              "cudaGraphGetNodes")
        nodes = (ctypes.c_void_p * n.value)()
        check(lib.cudaGraphGetNodes(handle, nodes, ctypes.byref(n)),
              "cudaGraphGetNodes")
        for node in nodes:
            kind = ctypes.c_int(-1)
            check(lib.cudaGraphNodeGetType(node, ctypes.byref(kind)),
                  "cudaGraphNodeGetType")
            name = GRAPH_NODE_TYPES.get(kind.value, f"type {kind.value}")
            counts[name] += 1
            if name == "child graph":
                child = ctypes.c_void_p()
                check(lib.cudaGraphChildGraphNodeGetGraph(
                    node, ctypes.byref(child)),
                    "cudaGraphChildGraphNodeGetGraph")
                walk(child)

    for graph in graphs:
        walk(ctypes.c_void_p(graph.raw_cuda_graph()))
    return dict(counts)


class ForcedEager:
    """While active, every new engine takes the eager route (the route
    table patched): [graph]'s runs to compare with."""

    def __enter__(self):
        from bpp_tpu_torch.mcmc import driver
        self._orig = driver.step_route
        driver.step_route = lambda cfg, shard=None: ("eager", "compared")
        return self

    def __exit__(self, *exc):
        from bpp_tpu_torch.mcmc import driver
        driver.step_route = self._orig


def cut_ctl(ctl, dst, nloci=None, burnin=None, nsample=None, job=None):
    """A copy of the control file ``ctl`` at ``dst`` with its nloci,
    burnin, nsample and jobname lines replaced where given."""
    import re
    with open(ctl) as f:
        text = f.read()
    for key, val in (("nloci", nloci), ("burnin", burnin),
                     ("nsample", nsample), ("jobname", job)):
        if val is not None:
            text = re.sub(rf"(?m)^{key} = .*$", f"{key} = {val}", text)
    with open(dst, "w") as f:
        f.write(text)
    return dst


def sync_pass(label, ctl, smi, x64=False, nloci=SYNC_LOCI):
    """``[sync]``: one eager step of ``label``'s configuration (``ctl`` cut
    to ``nloci`` loci) under ``torch.cuda.set_sync_debug_mode("warn")``,
    after a step that warms it up: every synchronising op, by the line of
    the port that called it, beside the route the table gives.  A graph-
    route step must have none (its capture would fail).  Returns the
    synchronising lines."""
    import collections
    import traceback
    import warnings

    import torch

    import bpp_tpu_torch
    from bpp_tpu_torch.mcmc.driver import Engine
    small = cut_ctl(ctl, f"sync_{os.path.basename(ctl)}", nloci=nloci)
    with open(small) as f:
        text = f.read()
    if "model = custom parts.txt" in text:
        # the partition file covers the loci read
        from bpp_tpu_torch.testing import write_partition_file
        write_partition_file("sync_parts.txt", CUSTOM_MODELS, nloci)
        with open(small, "w") as f:
            f.write(text.replace("custom parts.txt", "custom sync_parts.txt"))
    eng = Engine(load_run(small, "float64" if x64 else None), seed=1,
                 device="cuda")
    route, why = eng.route, eng.route_reason
    eng.route = "eager"
    state, _ = eng.chunk_step(eng.init_state(), 1)
    torch.cuda.synchronize()
    root = os.path.dirname(os.path.abspath(bpp_tpu_torch.__file__))
    found = collections.Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" not in str(message):
            return
        for fr in reversed(traceback.extract_stack()[:-1]):
            if fr.filename.startswith(root):
                found[f"{os.path.relpath(fr.filename, root)}:{fr.lineno}"] += 1
                return
        found[f"{os.path.basename(filename)}:{lineno}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng.chunk_step(state, 1)
            torch.cuda.set_sync_debug_mode(0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    ops = ", ".join(f"{k} x{v}" for k, v in sorted(found.items())) or "none"
    print(f"[sync] {label}: route {route} ({why}) | synchronising ops in "
          f"one eager step ({nloci} loci): {ops} | {smi}")
    if route == "graph" and found:
        raise AssertionError(f"[sync] {label}: the graph route's step "
                             f"synchronises at {ops}")
    return found


def graph_phase(label, ctl, smi, x64=False, cli_compare=True,
                trace_iters=GRAPH_TRACE_ITERS,
                window_iters=GRAPH_WINDOW_ITERS, iters=GRAPH_ITERS):
    """``[graph]``: ``label``'s configuration (``ctl``; ``x64``: in
    float64) run eagerly and through its captured step (one graph of the
    K chains under ``chains = K``) at the same seed, in this process.
    From the same initial states, ``iters`` iterations each way, in
    ``GRAPH_WINDOWS`` timed windows: the states, move statistics, traces
    and generator states after them must be bit-equal.  The eager route's
    wall ms an iteration is the median of those windows (an eager
    iteration dwarfs a chunk's fixed cost); the replayed route's the
    median of ``GRAPH_WINDOWS`` more windows of ``window_iters`` replays
    (a replayed chunk's fixed cost would weigh on a window of two).
    Then its device kernels,
    busy ms and idle share an iteration (a profiler trace of
    ``trace_iters``; the eager step's taken again where it may have
    dropped kernels, the replayed step's once), the replayed step's exact
    device nodes (kernels, memcpy and memset: :func:`graph_nodes`; the
    graph route runs first, so the eager trace is read against them),
    held within ``GRAPH_GATE`` of the eager trace's device kernels, the
    capture's seconds
    and peak device memory (from
    a reset just before it), and K1-K5 launched inside the graph.  ``cli_compare``: the
    control file run through ``cli.main`` at
    burnin 8, nsample 4 both ways: every mcmc file byte-equal.  Returns
    (eager, graph) wall ms an iteration."""
    import torch

    from bpp_tpu_torch import cli
    from bpp_tpu_torch.mcmc import graph as graph_mod
    from bpp_tpu_torch.mcmc.driver import (
        Engine, _nu_column, chain_views, clone_state, stack_states,
    )
    from bpp_tpu_torch.mcmc.graph import flatten
    run = load_run(ctl, "float64" if x64 else None)
    K = max(1, run.cfg.n_chains)
    res = {}
    # one engine for both routes: the graph's captured step, then the
    # eager step (eng.route "eager") from copies of the same states
    eng = Engine(run, seed=1, device="cuda")
    if eng.route != "graph":
        raise AssertionError(f"[graph] {label}: the route table sends it "
                             f"{eng.route} ({eng.route_reason})")
    start = eng.init_states(K) if K > 1 else [eng.init_state()]
    batched = K > 1 and eng.chains_route == "batched"
    n_windows = min(GRAPH_WINDOWS, iters)

    def seeded():
        gens = [torch.Generator(device="cuda") for _ in range(K)]
        for c, g in enumerate(gens):
            g.manual_seed(eng.chain_seed(c))
        return gens

    def windows(advance):
        """``iters`` iterations in ``GRAPH_WINDOWS`` timed windows (one
        an iteration where there are fewer): (the median window's wall ms
        an iteration, the move statistics, each chain's traces)."""
        n = iters // n_windows
        times, accs, parts = [], [], []
        for _ in range(n_windows):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            acc, traces = advance(n)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / n)
            accs.append(acc)
            parts.append(traces)
        traces = [{k: torch.cat([p[c][k] for p in parts]) for k in parts[0][c]}
                  for c in range(K)]
        return statistics.median(times), sum(accs), traces

    def traced(route, advance, passes, retraces, floor=0, attempts=10,
               first=None):
        """(device kernels, busy ms, memcpy and memset events) an
        iteration; ``first``, the first trace's kernels where a trace of
        both routes in one profiler session took it.  A profiler trace
        that misses some of the ``passes`` pruning launches an iteration
        has missed other kernels too and is taken again (as in
        ``profile_step``; a step with none takes the first).  A trace can
        lose a few dozen other kernels while it holds every pruning
        launch (either route; main 22's replayed step once lost 764 of
        20,642 in two traces, main 13's eager step 54 of 6,870): a trace
        of fewer than ``floor`` kernels an iteration is taken again, up to
        ``retraces`` whole traces, and the fullest kept.  Where a step was
        traced more than once, prints each trace's kernels an iteration
        and the one kept."""
        n = trace_iters
        whole, seen = [], []
        for i in range(attempts):
            kern = (first if i == 0 and first is not None else
                    device_kernels(lambda: advance(n)))
            held = sum(1 for name, _ in kern if "pack_logl_kernel" in name
                       or "fels_site_logl_kernel" in name)
            seen.append(f"{len(kern) / n:.0f}" + (
                "" if held == n * passes else
                f" (held {held} of {n * passes} pruning launches)"))
            if held == n * passes:
                whole.append(kern)
                if len(whole) == retraces or len(kern) >= floor * n:
                    break
        if not whole:
            raise AssertionError(f"[graph] {label}: no profiler trace of "
                                 f"{attempts} held all {n * passes} pruning "
                                 f"launches (the last held {held})")
        kern = max(whole, key=len)
        if len(seen) > 1:
            print(f"[graph] {label} {route}: {len(seen)} profiler traces of "
                  f"{n} iterations, device kernels an iteration "
                  + ", ".join(seen) + f"; kept {len(kern) / n:.0f}",
                  flush=True)
        copies = {kind: sum(name.startswith(kind.capitalize())
                            for name, _ in kern) / n
                  for kind in ("memcpy", "memset")}
        return (len(kern) / n, sum(us for _, us in kern) / 1e3 / n,
                copies)

    advances = {}
    for route in ("graph", "eager"):
        gens = seeded()
        states = [clone_state(st) for st in start]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        r = res[route] = {"pass": eng.ctx.route}
        if batched:
            # one step over the stacked chains, as run_mcmc_multi takes it
            stacked = [stack_states(states)]
        if route == "graph":
            graph = (eng.step_graph(stacked, gens, batched=True) if batched
                     else eng.step_graph(states, gens))
            graph.capture(keep=True)
            r["nodes"] = graph_nodes(graph.graphs)
            r["capture_s"] = graph.capture_s
            r["peak"] = (torch.cuda.max_memory_allocated() - held) / 2**20
            r["per_replay"] = graph.per_replay
            eng.route = "eager"

            def advance(n, graph=graph):
                acc, traces = graph.run(n)
                return acc, [_nu_column(t) for t in traces]
        elif batched:
            def advance(n, stacked=stacked, gens=gens):
                stacked[0], acc, traces = eng._chunk_multi(stacked[0], gens,
                                                           n)
                return acc, [_nu_column(t) for t in traces]
            r["capture_s"], r["per_replay"] = 0.0, None
        else:
            def advance(n, states=states, gens=gens):
                own, accs, traces = eng.gen, [], []
                try:
                    for c in range(K):
                        eng.gen = gens[c]
                        states[c], acc, trace, _ = eng._chunk(states[c], n)
                        accs.append(acc)
                        traces.append(trace)
                finally:
                    eng.gen = own
                return torch.stack(accs), traces
            r["capture_s"], r["per_replay"] = 0.0, None
        advances[route] = advance
        counts = graph_mod.launch_counts()
        r["ms"], acc, traces = windows(advance)
        # K1 and K2 launches (each count includes its float64 build's)
        after = graph_mod.launch_counts()
        r["passes"] = (after[0] - counts[0] + after[2] - counts[2]) \
            // iters
        final = (graph.chain_states() if route == "graph" else
                 chain_views(stacked[0], K) if batched else states)
        r["leaves"] = [flatten(clone_state(st))[1] for st in final]
        r["acc"], r["traces"] = acc.clone(), traces
        r["gens"] = [g.get_state() for g in gens]
        if route == "eager":
            r["peak"] = (torch.cuda.max_memory_allocated() - held) / 2**20
    g = res["graph"]
    times = []
    for _ in range(GRAPH_WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        advances["graph"](window_iters)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / window_iters)
    g["ms"] = statistics.median(times)
    nodes = g["nodes"]
    exact = sum(nodes.get(kind, 0) for kind in GRAPH_DEVICE_NODES)
    # both routes in one profiler session; the replayed step's trace is
    # kept, the eager step's taken again where it may have dropped
    # kernels (it issues what the captured one does, but for the
    # write-back: a trace further below is short)
    first = device_kernels_each(
        *(lambda adv=advances[route]: adv(trace_iters)
          for route in ("graph", "eager")))
    for route, kern, retraces, floor in (
            ("graph", first[0], 1, 0),
            ("eager", first[1], GRAPH_RETRACES, exact - GRAPH_GATE)):
        r = res[route]
        r["kernels"], r["busy"], r["copies"] = traced(
            route, advances[route], r["passes"], retraces, floor=floor,
            first=kern)
    del eng, states, gens, graph, advances, start
    if batched:
        del stacked
    torch.cuda.empty_cache()
    e, g = res["eager"], res["graph"]
    same = (all(torch.equal(a, b) for la, lb in zip(e["leaves"], g["leaves"])
                for a, b in zip(la, lb))
            and torch.equal(e["acc"], g["acc"])
            and all(torch.equal(ta[k], tb[k])
                    for ta, tb in zip(e["traces"], g["traces"]) for k in ta)
            and all(torch.equal(a, b) for a, b in zip(e["gens"], g["gens"])))
    if not same:
        raise AssertionError(f"[graph] {label}: after {iters} "
                             "iterations the replayed chain's state differs "
                             "from the eager chain's")
    k1, k1d, k2, k2d, k3, k4, k5 = g["per_replay"]
    if bool(k1 + k2) != (g["pass"] != "plain"):
        raise AssertionError(f"[graph] {label}: K1 {k1}, K2 {k2} launched "
                             f"inside the graph on the {g['pass']} route")
    if abs(exact - e["kernels"]) > GRAPH_GATE:
        raise AssertionError(f"[graph] {label}: the captured step issues "
                             f"{exact} device nodes a replay, the eager "
                             f"step's trace {e['kernels']:.0f} device "
                             "kernels an iteration")
    files = "not compared"
    if cli_compare:
        argv = ["--quiet"] + (["--x64"] if x64 else [])
        out = {}
        for route in ("eager", "graph"):
            job = f"graph_{os.path.splitext(ctl)[0]}_{route}"
            cut_ctl(ctl, f"{job}.ctl", burnin=GRAPH_BURNIN,
                    nsample=GRAPH_NSAMPLE, job=job)
            if route == "eager":
                with ForcedEager():
                    rc = cli.main(["--cfile", f"{job}.ctl"] + argv)
            else:
                rc = cli.main(["--cfile", f"{job}.ctl"] + argv)
            if rc != 0:
                raise AssertionError(f"[graph] {label}: cli.main returned "
                                     f"{rc} on the {route} route")
            names = [f"{job}.mcmc.txt"] + [f"{job}.c{c}.mcmc.txt"
                                           for c in range(2, K + 1)]
            out[route] = []
            for fn in names:
                with open(fn, "rb") as f:
                    out[route].append(f.read())
        if out["eager"] != out["graph"]:
            raise AssertionError(f"[graph] {label}: the replayed run's mcmc "
                                 "files differ from the eager run's")
        files = (f"{K} mcmc file{'s' if K > 1 else ''} byte-equal "
                 f"({sum(map(len, out['graph']))} bytes, "
                 f"{GRAPH_BURNIN + GRAPH_NSAMPLE} iterations)")
    print(f"[graph] {label} ({K} chain{'s' if K > 1 else ''}, "
          f"{run.batch.n_loci} loci{', float64' if x64 else ''}): states, "
          f"move statistics, traces and generators bit-equal after "
          f"{iters} iterations; {files} | wall ms/iter eager "
          f"{e['ms']:.2f} graph {g['ms']:.2f} (the median of "
          f"{n_windows} windows: eager of {iters // n_windows}"
          f", the compared iterations, replayed of {window_iters} more; "
          f"iters/s {1e3 / e['ms']:.2f} / "
          f"{1e3 / g['ms']:.2f}) | device kernels/iter {e['kernels']:.0f} / "
          f"{g['kernels']:.0f} (traced; memcpy {e['copies']['memcpy']:.0f}"
          f" / {g['copies']['memcpy']:.0f}, memset "
          f"{e['copies']['memset']:.0f} / {g['copies']['memset']:.0f} of "
          f"them) | exact, the captured step's nodes a replay: {exact} "
          f"device ({nodes.get('kernel', 0)} kernel + "
          f"{nodes.get('memcpy', 0)} memcpy + {nodes.get('memset', 0)} "
          "memset; the trace counts all three)" + "".join(
              f", {v} {k}" for k, v in sorted(nodes.items())
              if k not in GRAPH_DEVICE_NODES)
          + f" | busy ms/iter {e['busy']:.3f} / "
          f"{g['busy']:.3f} | idle share {1 - e['busy'] / e['ms']:.3f} / "
          f"{1 - g['busy'] / g['ms']:.3f} | inside the graph K1 {k1} "
          f"(float64 {k1d}) K2 {k2} (float64 {k2d}) K3 {k3} K4 {k4} K5 {k5} "
          f"a replay | capture "
          f"{g['capture_s']:.2f} s, peak {g['peak']:.1f} MiB (eager step "
          f"peak {e['peak']:.1f} MiB) | {smi}")
    return e["ms"], g["ms"]


# [graph]: (label, control file, x64, compared through the CLI too,
# iterations a replayed timing window: fewer on the slowest eager steps
# and the batched chains = K ones); the CLI runs are compared on mains 1,
# 5 and 13 only (every main's states, statistics, traces and
# generators are; the chains = K mains' files are compared per-chain
# against batched in [chains-batch]); the mains the comparison must cover
# first, then every other main path on the graph route, timed
_LIGHT = GRAPH_WINDOW_ITERS
_HEAVY = GRAPH_HEAVY_WINDOW
GRAPH_MAINS = (
    ("main 1", "run.ctl", False, True, _LIGHT),
    ("main 2", "run2.ctl", False, False, _LIGHT),
    ("main 13", "run13.ctl", False, True, _LIGHT),
    ("main 16", "run.ctl", True, False, _LIGHT),
    ("main 17", "run17.ctl", False, False, _LIGHT),
    ("main 18", "run18.ctl", False, False, _HEAVY),
    ("main 23", "run23.ctl", False, False, _LIGHT),
    ("main 3", "run3.ctl", False, False, _LIGHT),
    ("main 4", "run4.ctl", False, False, _LIGHT),
    ("main 9", "run9.ctl", False, False, _LIGHT),
    ("main 10", "run10.ctl", False, False, _HEAVY),
    ("main 11", "run11.ctl", False, False, _LIGHT),
    ("main 15", "run15.ctl", False, False, _LIGHT),
    ("main 16 diploid", "run2.ctl", True, False, _LIGHT),
    ("main 8", "run8.ctl", False, False, _LIGHT),
    ("main 19", "run19.ctl", False, False, _LIGHT),
    ("main 20", "run20.ctl", False, False, _LIGHT),
    # the schedules whose device control flow became kernels K3-K5 and
    # torch ops on the device
    ("main 5", "run5.ctl", False, True, _LIGHT),
    ("main 6", "run6.ctl", False, False, _LIGHT),
    ("main 7", "run7.ctl", False, False, _LIGHT),
    ("main 12", "run12.ctl", False, False, _HEAVY),
    ("main 14", "run14.ctl", False, False, _HEAVY),
    ("main 21", "run21.ctl", False, False, _LIGHT),
    ("main 22", "run22.ctl", False, False, _LIGHT),
    # chains = 4 on the batched route with the rj move and K4 (main 24)
    # and K3 (main 25) over the chains
    ("main 24", "run24.ctl", False, False, _HEAVY),
    ("main 25", "run25.ctl", False, False, _HEAVY),
    # chains = 4 on the batched route under MSC-M (K5 over the chains),
    # and A10 x MSC-M; their eager CLI runs are not compared
    ("main 26", "run26.ctl", False, False, _HEAVY),
    ("main 27", "run27.ctl", False, False, _HEAVY),
    # chains = 4 on the batched route on the MSC-I network
    ("main 28", "run28.ctl", False, False, _HEAVY),
    # chains = 4 on the batched route under GTR+G4 (eager CLI not
    # compared)
    ("main 29", "run29.ctl", False, False, _HEAVY))


# [chains-batch]: the mains of chains = K whose per-chain and batched
# routes are compared, their timing windows and traced iterations, and the
# most device nodes main 18's batched step may hold (8 chains' glue as one)
CB_MAINS = (("main 13", "run13.ctl"), ("main 18", "run18.ctl"),
            ("main 23", "run23.ctl"), ("main 24", "run24.ctl"),
            ("main 25", "run25.ctl"), ("main 26", "run26.ctl"),
            ("main 27", "run27.ctl"), ("main 14 x 4", "run14b.ctl"),
            ("main 28", "run28.ctl"), ("main 11 x 4", "run11b.ctl"),
            ("main 29", "run29.ctl"), ("main 9 x 4", "run9b.ctl"),
            ("main 8 x 4", "run8b.ctl"), ("main 5 x 4", "run5b.ctl"),
            ("main 15 x 4", "run15b.ctl"))
# the accept chain or walk each main holds over its chains (the others
# hold their pruning kernel; main 9 x 4's 20-state plain pass is held as
# one call over the chains against one call a chain)
CB_CHAIN_KERNEL = {"main 24": "K4", "main 25": "K3", "main 26": "K5",
                   "main 27": "K5", "main 14 x 4": "K5", "main 5 x 4": "K3",
                   "main 9 x 4": "plain"}
CB_WINDOWS = 3
CB_WINDOW_ITERS = 2
CB_TRACE_ITERS = 1
# the control file's run both ways: burnin 8 (the first with finetune
# marks), one sample
CB_BURNIN, CB_NSAMPLE = GRAPH_BURNIN, 1
# an MSC-M or MSC-I step issues ~38,000-56,000 device nodes a chain: 1
# replay a window
CB_HEAVY_ITERS = 1
CB_NODES_18 = 6000


def batch_launches(label, eng, states, smi):
    """``[chains-batch]`` launches: the pruning kernel of ``eng``'s batch
    (K1, or K2 with a diploid map) once over the K chains ``states``
    (their own trees and substitution parameters stacked, the batch's
    tips one copy) against K one-chain launches, float32 and float64
    builds: bit-equal per (chain, locus) and, for K2, per pattern; the
    batched output against the float64 plain version (per locus, after
    ``reduce_root`` for K2).  Device ms of the batched launch and of one
    chain's launch (profiler).  Returns (the largest per-locus |dlnL| of
    the float32 launch, its ms, one chain's ms)."""
    import torch

    from bpp_tpu_torch.core import fels, pack
    from bpp_tpu_torch.core import felsenstein as fe
    ctx = eng.ctx
    k2 = ctx.res_map is not None
    K, L = len(states), states[0].gt.n_loci
    C = states[0].subst.rates.shape[1]
    mod, kname = ((fels, "fels_site_logl_kernel") if k2 else
                  (pack, "pack_logl_kernel"))
    shared = {4, 12, 13}        # n_seq, tips, weights: the batch's
    worst, times = 0.0, {}
    for dt in (torch.float32, torch.float64):
        chains = []
        for st in states:
            sub = type(st.subst)(*(x.to(dt) if x.is_floating_point() else x
                                   for x in st.subst))
            chains.append(pass_args(st, sub, ctx, dt))
        stacked = tuple(a if i in shared else
                        torch.stack([c[i] for c in chains])
                        for i, a in enumerate(chains[0]))
        kw = dict(model=eng.cfg.model, n_cats=C, units=ctx.units)

        def args(a):
            if k2:
                return fels.kernel_args(*a[:-1], n_pat=ctx.n_pat, **kw)
            return pack.kernel_args(*a, **kw)

        batched = args(stacked)
        got = mod.launch(batched)
        ones = [mod.launch(args(a)) for a in chains]
        torch.cuda.synchronize()
        if tuple(got.shape[:2]) != (K, L):
            raise AssertionError(f"[chains-batch] {label}: output "
                                 f"{tuple(got.shape)}")
        for k, one in enumerate(ones):
            if not torch.equal(got[k], one):
                raise AssertionError(
                    f"[chains-batch] {label} {dt}: chain {k}'s row of the "
                    "batched launch differs from its one-chain launch")
        mask = ctx.locus_mask
        w64 = ctx.weights.double()
        for k, a in enumerate(chains):
            a64 = tuple(t.double() if t.is_floating_point() else t for t in a)
            kw64 = dict(model=kw["model"], n_cats=C)
            if k2:
                want = fe.reduce_root(fels.site_logl_fels_ref(
                    *a64[:-1], n_pat=ctx.n_pat, **kw64), w64, ctx.res_map,
                    ctx.res_count)
                have = fe.reduce_root(got[k].double(), w64, ctx.res_map,
                                      ctx.res_count)
            else:
                want = pack.site_logl_packed_ref(*a64, **kw64)
                have = got[k].double()
            err = float((have - want)[mask].abs().max())
            tol = TOL_LNL if dt == torch.float32 else TOL_LNL_F64
            if not err < tol:
                raise AssertionError(f"[chains-batch] {label} {dt}: chain "
                                     f"{k} {err} lnL a locus off its plain "
                                     "version")
            if dt == torch.float32:
                worst = max(worst, err)
        times[dt] = (kernel_device_ms(lambda: mod.launch(batched), kname),
                     kernel_device_ms(lambda: mod.launch(args(chains[0])),
                                      kname))
    (b32, o32), (b64, o64) = times[torch.float32], times[torch.float64]
    print(f"[chains-batch] {label}: {'K2' if k2 else 'K1'} once over {K} "
          f"chains x {L} loci (a grid row a chain) bit-equal per (chain, "
          f"locus{', pattern' if k2 else ''}) to {K} one-chain launches, "
          f"float32 and float64 builds; max per-locus |dlnL| against the "
          f"float64 plain version {worst:.3e} (tol {TOL_LNL}) | device ms "
          f"(profiler): float32 batched {b32:.4f}, one chain {o32:.4f} "
          f"({K} launches {K * o32:.4f}); float64 batched {b64:.4f}, one "
          f"chain {o64:.4f} ({K * o64:.4f}) | {smi}")
    return worst, b32, o32


def chains_ab(label, ctl, smi):
    """``[chains-batch]`` A/B: ``label``'s ``chains = K`` configuration
    in this process both ways from the same initial states and generator
    states: per-chain (one captured graph a chain and the write-back) and
    batched (one graph of the step over the K stacked chains with its
    write-back).  Each way: the captured step's exact device nodes
    (:func:`graph_nodes`), capture seconds and peak MiB, the replayed wall
    ms an iteration (the median of ``CB_WINDOWS`` windows of
    ``CB_WINDOW_ITERS`` replays, ``CB_HEAVY_ITERS`` under MSC-M and
    MSC-I), device kernels and busy ms an iteration (a profiler trace of
    ``CB_TRACE_ITERS``); after
    the first
    iteration the two ways' move statistics, per-locus lnL and state
    leaves compared; the batched step's draw sites an iteration (each K
    launches, one a chain; counted over the capture's warm-up and
    capture, each one step); the control file's run at burnin
    ``CB_BURNIN``, nsample ``CB_NSAMPLE`` both ways, its K mcmc
    files compared (they must be byte-equal): each
    way ``run_mcmc_multi`` on the graph captured here (as ``cli.main``
    runs the control file, whose batched route every ``chains = K`` main
    takes through ``cli.main``), its files written by
    ``cli.write_chain_files``, as ``cli.main`` writes them.  The engine
    takes the control file's seed, as ``cli.main`` does; both ways are
    traced in one profiler session.  Returns (the chains' states after
    the batched route's first iteration, the engine, the batched exact
    nodes)."""
    import torch

    import numpy as np

    from bpp_tpu_torch import cli
    from bpp_tpu_torch.mcmc import rng
    from bpp_tpu_torch.mcmc.driver import Engine, SampleLog, clone_state
    from bpp_tpu_torch.mcmc.graph import flatten
    from bpp_tpu_torch.mcmc.state import N_MOVES
    run = load_run(ctl)
    K = run.cfg.n_chains
    # at the control file's seed, as cli.main runs it
    eng = Engine(run, device="cuda")
    if eng.chains_route != "batched":
        raise AssertionError(f"[chains-batch] {label}: chains route "
                             f"{eng.chains_route} ({eng.chains_route_reason})")
    start = eng.init_states(K)

    def seeded(gens=None):
        gens = gens or [torch.Generator(device="cuda") for _ in range(K)]
        for c, g in enumerate(gens):
            g.manual_seed(eng.chain_seed(c))
        return gens

    heavy = eng.cfg.migration or run.stree.n_hybrids > 0
    w_iters = CB_HEAVY_ITERS if heavy else CB_WINDOW_ITERS
    t_iters = CB_TRACE_ITERS
    res, graphs = {}, {}
    jobs = {mode: f"cb_{os.path.splitext(ctl)[0]}_{mode[0]}"
            for mode in ("per-chain", "batched")}
    for mode in ("per-chain", "batched"):
        ch = Chains(eng, seeded(), batched=mode == "batched")
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        graph = ch.graph([clone_state(st) for st in start])
        draws = rng.CHAIN_DRAWS
        graph.capture(keep=True)
        r = res[mode] = {"capture_s": graph.capture_s}
        # the warm-up and the capture each run the batched step once
        r["sites"] = (rng.CHAIN_DRAWS - draws) // 2
        r["peak"] = (torch.cuda.max_memory_allocated() - held) / 2**20
        nodes = graph_nodes(graph.graphs)
        r["exact"] = sum(nodes.get(k, 0) for k in GRAPH_DEVICE_NODES)
        r["passes"] = graph.per_replay[0] + graph.per_replay[2]
        r["chains"] = sum(graph.per_replay[4:7])
        # the control file's run (burnin CB_BURNIN, nsample CB_NSAMPLE)
        # as cli.main takes it on this route, on this
        # graph: run_mcmc_multi loads the initial states into it and
        # resets its generators; the files written as cli.main writes
        # them
        job, own = jobs[mode], eng.cfg
        eng.cfg = own.replace(burnin=CB_BURNIN, nsample=CB_NSAMPLE,
                              jobname=job)
        eng.chains_route = mode
        # a fresh run from the initial states, as a "resume" at its first
        # generation: the states are not made again
        fresh = ([clone_state(st) for st in start],
                 [g.get_state() for g in seeded(ch.gens)], -CB_BURNIN,
                 np.zeros((K, N_MOVES, 2)), [SampleLog() for _ in range(K)])
        try:
            logs = eng.run_mcmc_multi(K, progress_every=0, resume=fresh,
                                      gens=ch.gens)
            cli.write_chain_files(eng.cfg, run.stree, logs,
                                  f"{job}.mcmc.txt")
        finally:
            eng.cfg, eng.chains_route = own, "batched"
        seeded(ch.gens)
        ch.graph([clone_state(st) for st in start])
        acc, traces = graph.run(1)
        r["acc"] = acc.clone()
        r["states"] = [clone_state(st) for st in graph.chain_states()]
        r["lnl"] = [t["lnl"].clone() for t in traces]
        times = []
        for _ in range(CB_WINDOWS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            graph.run(w_iters)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / w_iters)
        r["ms"] = statistics.median(times)
        graphs[mode] = graph
    # both ways' traces in one profiler session
    for mode, kern in zip(graphs, device_kernels_each(
            *(lambda g=g: g.run(t_iters) for g in graphs.values()))):
        res[mode]["kernels"] = len(kern) / t_iters
        res[mode]["busy"] = sum(us for _, us in kern) / 1e3 / t_iters
    del graphs, graph, ch
    eng._graphs.clear()
    torch.cuda.empty_cache()
    runs = {}
    for mode, job in jobs.items():
        runs[mode] = []
        for fn in [f"{job}.mcmc.txt"] + [f"{job}.c{c}.mcmc.txt"
                                         for c in range(2, K + 1)]:
            with open(fn, "rb") as f:
                raw = f.read()
            runs[mode].append((raw, np.loadtxt(fn, skiprows=1, ndmin=2)))
    same_files = sum(a[0] == b_[0] for a, b_ in zip(runs["per-chain"],
                                                    runs["batched"]))
    file_diff = max(float(np.nanmax(np.abs(a[1] - b_[1])))
                    for a, b_ in zip(runs["per-chain"], runs["batched"]))
    p, b = res["per-chain"], res["batched"]
    sites = b["sites"]
    same_stats = sum(bool(torch.equal(p["acc"][k], b["acc"][k]))
                     for k in range(K))
    rel, loci_equal, n_loci = 0.0, 0, 0
    for sp_, sb in zip(p["states"], b["states"]):
        for x, y in zip(flatten(sp_)[1], flatten(sb)[1]):
            if x.is_floating_point():
                d = (x.double() - y.double()).abs() / y.double().abs().clamp(
                    min=1e-30)
                d = d[torch.isfinite(d)]
                if d.numel():
                    rel = max(rel, float(d.max()))
        mask = eng.ctx.locus_mask
        loci_equal += int((sp_.logl == sb.logl)[mask].sum())
        n_loci += int(mask.sum())
    for what in ("passes", "chains"):
        if b[what] * K != p[what]:
            raise AssertionError(
                f"[chains-batch] {label}: {b[what]} "
                f"{'pruning' if what == 'passes' else 'K3-K5'} launches a "
                f"batched replay, {p[what]} a per-chain one, over {K} "
                "chains")
    if not b["exact"] < p["exact"]:
        raise AssertionError(f"[chains-batch] {label}: the batched step "
                             f"holds {b['exact']} device nodes, the "
                             f"per-chain {p['exact']}")
    print(f"[chains-batch] {label} ({K} chains, {run.batch.n_loci} loci, "
          f"{eng.ctx.route}): per-chain | batched: exact device nodes/iter "
          f"{p['exact']} | {b['exact']}; traced device kernels/iter "
          f"{p['kernels']:.0f} | {b['kernels']:.0f}; busy ms/iter "
          f"{p['busy']:.3f} | {b['busy']:.3f}; wall ms/iter (replayed, the "
          f"median of {CB_WINDOWS} windows of {w_iters}) "
          f"{p['ms']:.2f} | {b['ms']:.2f} (iters/s x {K}: "
          f"{1e3 / p['ms']:.2f} | {1e3 / b['ms']:.2f}); idle share "
          f"{1 - p['busy'] / p['ms']:.3f} | {1 - b['busy'] / b['ms']:.3f}; "
          f"capture s {p['capture_s']:.2f} | {b['capture_s']:.2f}; capture "
          f"peak MiB {p['peak']:.1f} | {b['peak']:.1f}; pruning launches a "
          f"replay {p['passes']} | {b['passes']}; K3-K5 launches a replay "
          f"{p['chains']} | {b['chains']} | batched draws: {sites} "
          f"sites an iteration, {sites * K} launches (one a chain) | after "
          f"one iteration from the same states: move statistics equal on "
          f"{same_stats} of {K} chains, per-locus lnL bit-equal on "
          f"{loci_equal} of {n_loci} loci, largest relative leaf "
          f"difference {rel:.3e} | the control file's run both ways "
          f"({CB_BURNIN + CB_NSAMPLE} iterations, on the graphs "
          f"above): {same_files} of {K} "
          f"mcmc files byte-equal, the largest difference of a value "
          f"{file_diff:.1e} | {smi}")
    if same_files != K:
        raise AssertionError(f"[chains-batch] {label}: {same_files} of {K} "
                             "mcmc files byte-equal both ways")
    return b["states"], eng, b["exact"]


def batch_accept_chain(label, name, eng, states, smi):
    """``[chains-batch]`` K3 or K4 (``name``) over ``label``'s K chains:
    the inputs of the batched step's last call of the kernel's wrapper
    (``notheta.chain_accept`` / ``clock_moves.gammadir_chain``, handed
    ``[K, L, ...]`` by ``pack.chain_pass``) in one eager batched
    iteration from the chains' ``states``; on them one launch over the K
    chains (a block a chain) against K one-chain launches, bit-equal per
    (chain, locus), and each chain's decisions against the plain version
    (:func:`chain_masks_agree`: equal but at near ties).  Device ms of the
    batched launch and of one chain's (profiler), the plain version's ms
    over the K chains (host, with the copy) and the bound over the K x L
    loci (:func:`chain_bounds`).  Returns (the largest |kernel - plain|
    of the 0/1 decisions, batched ms, one chain's ms, bound ms, what
    bounds it, plain ms)."""
    import numpy as np
    import torch

    from bpp_tpu_torch.mcmc import clock_moves, notheta
    from bpp_tpu_torch.mcmc.driver import clone_state, stack_states
    mod, attr, rows = ((notheta, "chain_accept", "cols") if name == "K3"
                       else (clock_moves, "gammadir_chain", "terms"))
    orig = getattr(mod, attr)
    calls = []

    def record(**kw):
        if kw[rows].dim() == 3:
            calls.append({k: v.clone() if torch.is_tensor(v) else v
                          for k, v in kw.items()})
        return orig(**kw)

    K = len(states)
    gens = [torch.Generator(device="cuda") for _ in range(K)]
    for c, g in enumerate(gens):
        g.manual_seed(eng.chain_seed(c) + 1)
    setattr(mod, attr, record)
    try:
        eng._step_batched(stack_states([clone_state(st) for st in states]),
                          gens)
    finally:
        setattr(mod, attr, orig)
    if not calls:
        raise AssertionError(f"[chains-batch] {label}: the batched step "
                             f"made no {name} call over its chains")
    kw = calls[-1]
    if name == "K3":
        args = (kw["a"], kw["b"], kw["cols"], kw["sums"], kw["H"])

        def chain(k):
            return (args[0], args[1], args[2][k], args[3][k], args[4])
        flat = (args[0], args[1], args[2].reshape(-1, args[2].shape[-1]),
                args[3].reshape(-1), args[4])
    else:
        args = (kw["terms"], kw["a_bar"], kw["b_bar"], kw["a_i"])

        def chain(k):
            return (args[0][k],) + args[1:]
        flat = (args[0].reshape(-1, 6),) + args[1:]
    got = chain_launch(name, args)
    ones = [chain_launch(name, chain(k)) for k in range(K)]
    torch.cuda.synchronize()
    L = got.shape[1]
    if tuple(got.shape) != (K, L):
        raise AssertionError(f"[chains-batch] {label}: {name} output "
                             f"{tuple(got.shape)}")
    agree, near, err = 0, 0, 0.0
    t0 = time.perf_counter()
    wants = []
    for k in range(K):
        margin = np.full(L, np.inf)
        wants.append((chain_plain(name, chain(k), margin), margin))
    plain_ms = (time.perf_counter() - t0) * 1e3
    for k, (want, margin) in enumerate(wants):
        if not torch.equal(got[k], ones[k]):
            raise AssertionError(f"[chains-batch] {label}: chain {k}'s row "
                                 f"of the batched {name} launch differs "
                                 "from its one-chain launch")
        upto, n_near, e, _ = chain_masks_agree(f"{name} ({label}, chain "
                                               f"{k})", got[k], want, margin)
        agree += upto
        near += n_near
        err = max(err, e)
    ms = kernel_device_ms(lambda: chain_launch(name, args),
                          CHAIN_KERNELS[name])
    one = kernel_device_ms(lambda: chain_launch(name, chain(0)),
                           CHAIN_KERNELS[name])
    bms, by = chain_bounds(name, flat)
    print(f"[chains-batch] {label}: {name} once over {K} chains x {L} loci "
          f"(a block a chain; the batched step's last call, "
          f"{chain_proposing(name, flat)} proposing loci) bit-equal per "
          f"(chain, locus) to {K} one-chain launches; against the plain "
          f"version: equal on {agree} of {K * L} loci compared, {near} near "
          f"ties (< {CHAIN_TIE}), max |kernel - plain| {err:.0f} | device "
          f"ms (profiler): batched {ms:.4f}, one chain {one:.4f} ({K} "
          f"launches {K * one:.4f}) | bound {bms:.2e} ms ({by}) over {K} x "
          f"{L} | plain version {plain_ms:.2f} ms ({K} chains, host, with "
          f"the copy) | {smi}")
    return err, ms, one, bms, by, plain_ms


def batch_walk(label, eng, states, smi):
    """``[chains-batch]`` K5 over ``label``'s K chains: the inputs of the
    batched step's last call of ``mig_moves.simspr_walk_chains`` (handed
    ``[K, L, ...]`` by ``pack.chain_pass``, the route table one copy) in
    one eager batched iteration from the chains' ``states``; on them, in
    float32 and float64, one launch over the K chains (a grid row a chain)
    against K one-chain launches, all eight outputs bit-equal per (chain,
    locus), and each chain's walks against the plain version
    (:func:`walks_agree`: equal where clear of a tie, at most 1 locus in
    1000 near one).  Device ms of the batched launch and of one chain's
    (profiler, float32), the plain version's ms over the K chains (torch
    ops on the card) and the bound over the K x L loci
    (:func:`chain_bounds`).
    Returns (max |dt| of a clear walk, float32 batched ms, one chain's ms,
    bound ms, what bounds it, plain ms)."""
    import torch

    from bpp_tpu_torch.core import chains
    from bpp_tpu_torch.mcmc import mig_moves
    from bpp_tpu_torch.mcmc.driver import clone_state, stack_states
    orig = mig_moves.simspr_walk_chains
    calls = []

    def record(**kw):
        if kw["t_lo"].dim() == 3:
            calls.append({k: v.clone() if torch.is_tensor(v) else v
                          for k, v in kw.items()})
        return orig(**kw)

    K = len(states)
    gens = [torch.Generator(device="cuda") for _ in range(K)]
    for c, g in enumerate(gens):
        g.manual_seed(eng.chain_seed(c) + 1)
    saved = chains.launch_counts()
    mig_moves.simspr_walk_chains = record
    try:
        eng._step_batched(stack_states([clone_state(st) for st in states]),
                          gens)
    finally:
        mig_moves.simspr_walk_chains = orig
    if len(calls) != K5_PER_ITER_12:
        raise AssertionError(f"[chains-batch] {label}: {len(calls)} K5 "
                             "calls over the chains in a batched iteration")
    kw = calls[-1]
    ME = kw["ME"]
    own = [n in mig_moves.WALK_PER_CHAIN for n in mig_moves.WALK_ARGS]
    out, steps_all = {}, []
    for dt in (torch.float32, torch.float64):
        args = tuple(kw[n].to(dt) if kw[n].is_floating_point() else kw[n]
                     for n in mig_moves.WALK_ARGS) + (ME,)

        def chain(k, args=args):
            return tuple(a[k] if o else a
                         for a, o in zip(args[:19], own)) + (ME,)
        got = chain_launch("K5", args)
        ones = [chain_launch("K5", chain(k)) for k in range(K)]
        torch.cuda.synchronize()
        L = got[0].shape[1]
        if tuple(got[0].shape) != (K, L):
            raise AssertionError(f"[chains-batch] {label}: K5 output "
                                 f"{tuple(got[0].shape)}")
        valid = near = 0
        err = 0.0
        for k in range(K):
            for name, x, y in zip(WALK_OUTPUTS, got, ones[k]):
                if not torch.equal(x[k], y):
                    raise AssertionError(
                        f"[chains-batch] {label} {dt}: chain {k}'s {name} "
                        "of the batched K5 launch differs from its "
                        "one-chain launch")
            v, n_near, e, steps = walks_agree(
                f"K5 ({label}, chain {k}, {dt})", chain(k),
                tuple(x[k] for x in got))
            valid, near, err = valid + v, near + n_near, max(err, e)
            if dt == torch.float32:
                steps_all.append(steps)
        if near > max(1, valid // 1000):
            raise AssertionError(f"[chains-batch] {label} K5 {dt}: {near} "
                                 f"of {valid} walks within {WALK_TIE} of a "
                                 "tie")
        out[dt] = (valid, near, err, args, chain)
    # timed in the main paths' float32
    valid, near, err, args, chain = out[torch.float32]
    ms = kernel_device_ms(lambda: chain_launch("K5", args),
                          CHAIN_KERNELS["K5"])
    one = kernel_device_ms(lambda: chain_launch("K5", chain(0)),
                           CHAIN_KERNELS["K5"])
    t0 = time.perf_counter()
    for k in range(K):
        mig_moves.simspr_walk_ref(*chain(k))
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    chains.set_launch_counts(saved)
    # the bound over the K x L loci: the chains' per-locus arguments as
    # one walk of K L loci (the species tables of chain 0)
    flat = list(chain(0))
    for i in WALK_PER_LOCUS:
        flat[i] = torch.cat([chain(k)[i] for k in range(K)])
    flat[18] = torch.cat([chain(k)[18] for k in range(K)], dim=2)
    steps = torch.cat(steps_all)
    bms, by = chain_bounds("K5", (tuple(flat), steps))
    print(f"[chains-batch] {label}: K5 once over {K} chains x {L} loci (a "
          f"grid row a chain; the batched step's last walk, "
          f"{args[9].shape[0]} routes one copy, E={args[0].shape[2]}, "
          f"S={args[18].shape[2]}, ME={ME}) bit-equal per (chain, locus), "
          f"all eight outputs, to {K} one-chain launches, float32 and "
          f"float64; against the plain version {valid} walks compared "
          f"(float32), equal where clear of a tie, {near} near one, max "
          f"|dt| {err:.3e}; float64 {out[torch.float64][0]} compared, "
          f"{out[torch.float64][1]} near, max |dt| "
          f"{out[torch.float64][2]:.3e} | longest walk {int(steps.max())} "
          f"steps | device ms (profiler, float32): batched {ms:.4f}, one "
          f"chain {one:.4f} ({K} launches {K * one:.4f}) | bound "
          f"{bms:.2e} ms ({by}) "
          f"over {K} x {L} | plain version {plain_ms:.2f} ms ({K} chains, "
          f"torch ops on the card) | {smi}")
    return err, ms, one, bms, by, plain_ms


def write_batch_ctls():
    """The control files of ``[chains-batch]``'s rows of main 9, 8, 5 and
    15 with ``chains = 4``: main 9's WAG file, main 8's partition (with
    20 loci a model, no check or print files) and main 15's traits (no
    check) on their first ``N_LOCI_B`` loci, main 5's dated file with
    integrated thetas (no checkpoint) on its 1000."""
    from bpp_tpu_torch.testing import write_partition_file
    chains = f"chains = {CHAINS_B}\n"
    cut_ctl("run9.ctl", "run9b.ctl", nloci=N_LOCI_B, job="out9b")
    with open("run9b.ctl", "a") as f:
        f.write(chains)
    write_partition_file("parts8b.txt", CUSTOM_MODELS, N_LOCI_B)
    for ctl, job, nloci, extra in (
            ("run8b.ctl", "out8b", N_LOCI_B, "model = custom parts8b.txt\n"),
            ("run5b.ctl", "out5b", N_LOCI, DATED_RUN),
            ("run15b.ctl", "out15b", N_LOCI_B, "traitfile = traits.txt\n")):
        with open(ctl, "w") as f:
            f.write(RUN_CTL.format(nloci=nloci, burnin=BURNIN,
                                   nsample=NSAMPLE, job=job,
                                   extra=extra + chains))


def batch_plain(label, eng, states, smi):
    """``[chains-batch]`` the 20-state plain pass over ``label``'s K
    chains (no kernel takes 20 states): ``fels.site_logl_fels_ref`` once
    on the K chains' states (their loci as one batch, as the batched step
    calls it through ``pack.chain_pass``) against once a chain, bit-equal
    per (chain, locus, pattern); ms of each (CUDA events)."""
    import torch

    from bpp_tpu_torch.core import fels
    ctx = eng.ctx
    K = len(states)
    C = states[0].subst.rates.shape[1]
    shared = {4, 12}            # n_seq, tips: the batch's
    chains = [pass_args(st, st.subst, ctx, ctx.tip_partials.dtype)[:-1]
              for st in states]
    stacked = tuple(a if i in shared else torch.stack([c[i] for c in chains])
                    for i, a in enumerate(chains[0]))
    kw = dict(model=eng.cfg.model, n_cats=C, n_pat=ctx.n_pat)
    got = fels.site_logl_fels_ref(*stacked, **kw)
    ones = [fels.site_logl_fels_ref(*a, **kw) for a in chains]
    same = sum(bool(torch.equal(got[k], one)) for k, one in enumerate(ones))
    if same != K:
        raise AssertionError(f"[chains-batch] {label}: the 20-state pass "
                             f"over {K} chains equals the one-chain passes "
                             f"on {same} chains")
    ms = cuda_ms(lambda: fels.site_logl_fels_ref(*stacked, **kw), reps=5)
    one_ms = cuda_ms(lambda: fels.site_logl_fels_ref(*chains[0], **kw),
                     reps=5)
    print(f"[chains-batch] {label}: the 20-state plain pass once over {K} "
          f"chains x {ctx.n_pat.shape[0]} loci bit-equal per (chain, locus, "
          f"pattern) to {K} one-chain passes | ms (CUDA events): batched "
          f"{ms:.3f}, one chain {one_ms:.3f} ({K} passes {K * one_ms:.3f}) "
          f"| {smi}")


def chains_batch_phase(smi):
    """``[chains-batch]``: mains 13, 18, 23-29, main 14 with 4 chains on
    100 loci, main 11 with 4 chains and mains 9, 8, 5 and 15 with 4
    chains (:func:`write_batch_ctls`) per-chain against batched
    (:func:`chains_ab`), then the batched launches of K1 (main 18's 8
    chains, main 13's 2, the 4 of mains 28, 29, 11, 8 and 15) and K2
    (main 23's 4) on the chains' states against one-chain launches
    (:func:`batch_launches`), of K4 (main 24's 4) and K3 (main 25's and
    main 5's 4) on the batched step's inputs (:func:`batch_accept_chain`),
    of K5 (mains 26, 27 and 14's 4; :func:`batch_walk`), and main 9's
    20-state plain pass over its 4 chains (:func:`batch_plain`).  Main
    18's batched step must hold fewer than ``CB_NODES_18`` device nodes,
    and every row's files must be byte-equal both ways.  Returns {label: (max |dlnL|,
    batched ms, one chain's ms)} of the pruning kernels and {label:
    :func:`batch_accept_chain`'s or :func:`batch_walk`'s row} of the
    accept chains and walks."""
    out, chain_rows = {}, {}
    # main 14's control file with chains = 4 on its first 100 loci
    cut_ctl("run14.ctl", "run14b.ctl", nloci=N_LOCI_14B, job="out14b")
    with open("run14b.ctl", "a") as f:
        f.write(f"chains = {CHAINS_14B}\n")
    # main 11's BDI fixture (linked-msci thetas) with chains = 4
    cut_ctl("run11.ctl", "run11b.ctl", job="out11b")
    with open("run11b.ctl", "a") as f:
        f.write(f"chains = {CHAINS_11B}\n")
    write_batch_ctls()
    for label, ctl in CB_MAINS:
        states, eng, exact = chains_ab(label, ctl, smi)
        if label == "main 18" and not exact < CB_NODES_18:
            raise AssertionError(f"[chains-batch] main 18's batched step "
                                 f"holds {exact} device nodes, not under "
                                 f"{CB_NODES_18}")
        kernel = CB_CHAIN_KERNEL.get(label)
        if kernel == "K5":
            chain_rows[label] = batch_walk(label, eng, states, smi)
        elif kernel == "plain":
            batch_plain(label, eng, states, smi)
        elif kernel is not None:
            chain_rows[label] = batch_accept_chain(label, kernel, eng,
                                                   states, smi)
        if kernel is None:
            out[label] = batch_launches(label, eng, states, smi)
        del states, eng
    return out, chain_rows


def graph_phases(smi):
    """``[graph]`` for every main of ``GRAPH_MAINS``, then a summary
    line."""
    rows = []
    for label, ctl, x64, whole, w in GRAPH_MAINS:
        e, g = graph_phase(label, ctl, smi, x64, cli_compare=whole,
                           window_iters=w,
                           iters=(GRAPH_ITERS if whole else
                                  GRAPH_SLOW_ITERS if label in GRAPH_SLOW
                                  else GRAPH_FEW_ITERS))
        rows.append(f"{label} {e:.2f} -> {g:.2f}")
    print("[graph] wall ms/iter eager -> replayed: " + ", ".join(rows)
          + f" | {smi}")


def eigen_phase(smi, windows=GRAPH_WINDOWS, iters=GRAPH_WINDOW_ITERS):
    """``[eigen]``: main 20's GTR+G4 step on the eager route (the route
    of GTR under ``--multihost``), its
    eigensystems from ``pmatrix.eigh_jacobi`` (``Ctx.captured``: what the
    captured step runs) and from ``torch.linalg.eigh`` (which reads its
    status back to the host each call; what an eager step runs): wall ms
    an iteration, the median of ``windows`` windows of ``iters`` taken in
    turn, and device kernels an iteration."""
    import dataclasses

    import torch

    from bpp_tpu_torch.mcmc.driver import Engine
    run = load_run("run20.ctl")
    eng = Engine(run, seed=1, device="cuda")
    eng.route = "eager"
    state = eng.init_state()
    solvers = (("eigh_jacobi", True), ("torch.linalg.eigh", False))
    times = {name: [] for name, _ in solvers}
    kernels = {}
    for w in range(windows + 1):
        for name, captured in solvers:
            eng.ctx = dataclasses.replace(eng.ctx, captured=captured)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _, _, _ = eng._chunk(state, iters)
            torch.cuda.synchronize()
            if w:      # the first round warms both up
                times[name].append((time.perf_counter() - t0) * 1e3
                                   / iters)
    for name, captured in solvers:
        eng.ctx = dataclasses.replace(eng.ctx, captured=captured)
        kernels[name] = len(device_kernels(
            lambda: eng._chunk(state, 2))) / 2
    print(f"[eigen] main 20 (GTR+G4, {run.batch.n_loci} loci) on the eager "
          f"route (wall the median of {windows} windows of {iters}, the "
          "solvers in turn): " + "; ".join(
              f"{name} {statistics.median(times[name]):.2f} ms/iter, "
              f"{kernels[name]:.0f} device kernels/iter"
              for name, _ in solvers) + f" | {smi}")
    del eng, state
    torch.cuda.empty_cache()


def memory_report(smi):
    """``[memory]``: every chain's peak device memory, one line."""
    print("[memory] peak device memory a run (torch.cuda.max_memory_"
          "allocated from a reset just before it; MiB held before it): "
          + " | ".join(f"{label} {peak:.1f} ({held:.1f})"
                       for label, peak, held in PEAKS) + f" | {smi}")


def load_run(ctl, dtype=None):
    """``load_run_from_ctl``, in ``dtype`` when one is given."""
    from bpp_tpu_torch.loader import load_run_from_ctl
    run = load_run_from_ctl(ctl)
    if dtype is not None:
        run.cfg = run.cfg.replace(dtype=dtype)
    return run


def _table(path):
    """The rows of the posterior table in a summary: {param: [values]}."""
    with open(path) as f:
        lines = f.read().splitlines()
    i = next(k for k, ln in enumerate(lines) if ln.startswith("param"))
    rows = {}
    for ln in lines[i + 2:]:
        if not ln.strip():
            break
        parts = ln.split()
        rows[parts[0]] = [float(x) for x in parts[1:]]
    return lines[i].split(), rows


def tools_phase(smi):
    """``[tools]``: ``--bfdriver`` on main 1's control file with 4 points,
    and the smallest beta's control file through ``cli.main`` for 10
    iterations; then ``--summary`` on main 1's control file, whose table
    must equal main 1's to the six decimals mcmc.txt keeps.  Returns K1's
    launches."""
    import contextlib
    import io
    import shutil

    import numpy as np

    from bpp_tpu_torch import cli
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["--bfdriver", "run.ctl", "--points", str(BF_POINTS)])
    with open("run.ctl.betaweights.csv") as f:
        rows = f.read().splitlines()
    betas = [float(r.split(",")[0]) for r in rows[1:]]
    if rc or len(betas) != BF_POINTS or betas != sorted(betas) or \
            not all(os.path.exists(f"run.ctl.{i + 1}")
                    for i in range(BF_POINTS)):
        raise AssertionError(f"--bfdriver: rc {rc}, betas {betas}")
    with open("run.ctl.1") as f:
        text = f.read()
    for a, b in ((f"burnin = {BURNIN}\n", f"burnin = {BF_BURNIN}\n"),
                 (f"nsample = {NSAMPLE}\n", f"nsample = {BF_NSAMPLE}\n"),
                 ("jobname = out\n", "jobname = outbf\n")):
        if a not in text:
            raise AssertionError(f"run.ctl.1 has no line {a!r}")
        text = text.replace(a, b)
    with open("runbf.ctl", "w") as f:
        f.write(text)
    iters = BF_BURNIN + BF_NSAMPLE
    launches, _ = run_chain(
        ["--cfile", "runbf.ctl"], "outbf", iters,
        (PASSES_PER_ITER * iters + 1, 0), ("theta",),
        f"tools: beta {betas[0]}", smi, nsample=BF_NSAMPLE)
    shutil.copy("out.txt", "out.main1.txt")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["--summary", "run.ctl", "--quiet"])
    head1, main1 = _table("out.main1.txt")
    head2, again = _table("out.txt")
    if rc or head1 != head2 or list(main1) != list(again):
        raise AssertionError(f"--summary: rc {rc}, rows {list(again)} for "
                             f"{list(main1)}")
    worst = 0.0
    # ESS*, Eff* and rho1 as the table prints them (2, 4, 4 decimals,
    # summary/allfixed.format_summary): two values within the tolerance
    # may print one unit of the last decimal apart
    unit = np.array([1e-2, 1e-4, 1e-4])
    for name, vals in main1.items():
        a, b = np.asarray(vals), np.asarray(again[name])
        # mcmc.txt keeps six decimals; the table prints six digits
        ok = np.abs(a - b) <= 1e-6 + 2e-4 * np.abs(a)
        ok[-3:] = (np.abs(a - b)[-3:]
                   <= 2e-3 * np.abs(a[-3:]) + 2e-4 + unit)
        if not ok.all():
            raise AssertionError(f"--summary: row {name} {list(b)} for "
                                 f"main 1's {list(a)}")
        worst = max(worst, float(np.abs(a - b)[:-3].max()))
    print(f"[tools] --bfdriver run.ctl --points {BF_POINTS}: betas {betas}; "
          f"the beta {betas[0]} file ran through cli.main | --summary "
          f"run.ctl: {len(again)} rows equal to main 1's table to the "
          f"precision of mcmc.txt (max |d| {worst:.2e} but ESS/Eff/rho1) | "
          f"{smi}")
    return launches


def hold_f64(label, eng, state, smi, keep=None):
    """``[x64]``: the float64 build of ``eng``'s kernel (K1, or K2 with a
    diploid map) against its float64 plain version on ``state``'s gene
    trees, for the four model families (JC69, HKY, TN93, GTR) x C in
    ``X64_CATS`` x both CLV stores: K1 within ``TOL_LNL_F64`` a locus, K2
    within ``TOL_SITE_F64`` a pattern and ``TOL_LNL_F64`` a locus after
    ``reduce_root``; a repeat launch and the other store bit-equal.  Then
    the main path's model (JC69 for K1, HKY+G4 for K2) is timed at the
    wrapper's plan, beside its plain version and its bound.  ``keep``, a
    list, gets that launch's inputs (:func:`parent_times`).  Returns (max
    per-locus error, (device ms, plain ms, bound ms, bound by))."""
    import torch

    from bpp_tpu_torch.core import fels, pack
    from bpp_tpu_torch.core import felsenstein as fe
    from bpp_tpu_torch.testing import fixed_subst
    ctx = eng.ctx
    k2 = ctx.res_map is not None
    mod = fels if k2 else pack
    w64 = ctx.weights.double()
    mask = ctx.locus_mask
    L = state.gt.n_loci
    worst = site_worst = 0.0
    for model_name in ("JC69", "HKY", "TN93", "GTR"):
        for n_cats in X64_CATS:
            name = f"{model_name}+C{n_cats}"
            model, s64 = fixed_subst(model_name, n_cats, L, torch.float64,
                                     w64.device)
            a64 = pass_args(state, s64, ctx, torch.float64)
            kw = dict(model=model, n_cats=n_cats)
            if k2:
                want_s = fels.site_logl_fels_ref(*a64[:-1], n_pat=ctx.n_pat,
                                                 **kw)
                want = fe.reduce_root(want_s, w64, ctx.res_map,
                                      ctx.res_count)
            else:
                want = pack.site_logl_packed_ref(*a64, **kw)
            first = None
            for store in ("shared", "global"):
                n0 = mod.LAUNCHES_F64
                if k2:
                    got_s = fels.site_logl_fels(
                        *a64[:-1], n_pat=ctx.n_pat, units=ctx.units,
                        clv_store=store, **kw)
                    site = float((got_s - want_s).abs().max())
                    got = fe.reduce_root(got_s, w64, ctx.res_map,
                                         ctx.res_count)
                    again = fels.site_logl_fels(
                        *a64[:-1], n_pat=ctx.n_pat, units=ctx.units,
                        clv_store=store, **kw)
                    raw = got_s
                else:
                    site = 0.0
                    got = pack.site_logl_packed(*a64, units=ctx.units,
                                                clv_store=store, **kw)
                    again = pack.site_logl_packed(*a64, units=ctx.units,
                                                  clv_store=store, **kw)
                    raw = got
                torch.cuda.synchronize()
                if mod.LAUNCHES_F64 != n0 + 2 or mod.CLV_STORE != store or \
                        got.dtype != torch.float64:
                    raise AssertionError(
                        f"[x64] {label} {name}: not two launches of the "
                        f"float64 build's {store} store")
                if not bool(torch.isfinite(got[mask]).all()):
                    raise AssertionError(f"[x64] {label} {name}: non-finite "
                                         "lnL")
                if not torch.equal(raw, again) or (
                        first is not None and not torch.equal(raw, first)):
                    raise AssertionError(
                        f"[x64] {label} {name}: a repeat launch or the "
                        "other store is not bit-equal")
                first = raw
                err = float((got - want)[mask].abs().max())
                if not (err < TOL_LNL_F64 and site < TOL_SITE_F64):
                    raise AssertionError(
                        f"[x64] {label} {name} ({store} store): the float64 "
                        f"build and its plain version differ by {err} lnL a "
                        f"locus, {site} a pattern")
                worst, site_worst = max(worst, err), max(site_worst, site)
    model_name, n_cats = ("HKY", 4) if k2 else ("JC69", 1)
    model, s64 = fixed_subst(model_name, n_cats, L, torch.float64, w64.device)
    a64 = pass_args(state, s64, ctx, torch.float64)
    kw = dict(model=model, n_cats=n_cats)
    if k2:
        kargs = fels.kernel_args(*a64[:-1], n_pat=ctx.n_pat, units=ctx.units,
                                 **kw)
        plain = cuda_ms(lambda: fels.site_logl_fels_ref(
            *a64[:-1], n_pat=ctx.n_pat, **kw), reps=10)
    else:
        kargs = pack.kernel_args(*a64, units=ctx.units, **kw)
        plain = cuda_ms(lambda: pack.site_logl_packed_ref(*a64, **kw),
                        reps=10)
    kname = "fels_site_logl_kernel" if k2 else "pack_logl_kernel"
    ms = kernel_device_ms(lambda: mod.launch(kargs), kname, reps=20)
    bms, by = bound_ms(eng.run.batch, model_name, n_cats, per_pattern=k2,
                       rb=8, flops=F64_FLOPS)
    if keep is not None:
        keep.append(x64_case(k2, ctx, a64, model, n_cats,
                             kargs.plan.clv_store))
    name = f"{model_name}+G{n_cats}" if n_cats > 1 else model_name
    print(f"[x64] {label} {name}: float64 build {ms:.4f} ms a launch "
          f"({kargs.plan.clv_store} store, {kargs.plan.threads} threads, "
          f"{kargs.plan.shared_bytes} B shared a block) | plain version "
          f"(float64) {plain:.4f} ms/pass | bound {bms:.5f} ms ({by}, "
          f"float64) | {smi}")
    site_txt = (f", {site_worst:.3e} a pattern (tol {TOL_SITE_F64})"
                if k2 else "")
    print(f"[x64] {label}: {'K2' if k2 else 'K1'} float64 build vs its "
          f"float64 plain version on JC69, HKY, TN93, GTR x C "
          f"{'/'.join(map(str, X64_CATS))} x shared/global store, repeat "
          f"launches and stores bit-equal: max |dlnL| {worst:.3e} a locus "
          f"(tol {TOL_LNL_F64}){site_txt} | {smi}")
    return worst, (ms, plain, bms, by)


def x64_case(k2, ctx, a64, model, n_cats, store):
    """One float64 launch's inputs, on the host, for :func:`time_cases`."""
    return {"kernel": "K2" if k2 else "K1", "C": n_cats, "store": store,
            "model": model.name, "args": [t.cpu() for t in a64],
            "n_pat": ctx.n_pat.cpu(), "n_cols": ctx.tip_partials.shape[2]}


def time_cases(src, dst):
    """Time every launch of ``src`` (a list of :func:`x64_case`) with the
    ``bpp_tpu_torch`` that is first on ``sys.path``, and write the device
    ms of each (profiler, one window of 20) to ``dst`` as JSON."""
    import torch

    from bpp_tpu_torch.config import SubstModel
    from bpp_tpu_torch.core import fels, pack
    from bpp_tpu_torch.core.units import Units
    times = []
    for case in torch.load(src, weights_only=False):
        a = [t.cuda() for t in case["args"]]
        n_pat = case["n_pat"].cuda()
        kw = dict(model=SubstModel[case["model"]], n_cats=case["C"],
                  units=Units(case["n_pat"].numpy(), case["n_cols"], "cuda"),
                  clv_store=case["store"])
        if case["kernel"] == "K2":
            kargs = fels.kernel_args(*a[:-1], n_pat=n_pat, **kw)
            launch, name = fels.launch, "fels_site_logl_kernel"
        else:
            kargs = pack.kernel_args(*a, **kw)
            launch, name = pack.launch, "pack_logl_kernel"
        times.append(kernel_device_ms(lambda: launch(kargs), name, reps=20,
                                      windows=1))
    with open(dst, "w") as f:
        json.dump(times, f)


def parent_times(parent, cases, smi):
    """``[x64] parent``: the float64 builds of ``parent`` (a checkout of
    the parent commit, ``--parent DIR``) timed on ``cases`` in a process of
    their own, which builds the parent's kernels into its own
    ``_build/``, then the same cases with this tree's builds.  Prints one
    line a case; returns [(case, parent ms, this tree's ms)]."""
    import torch
    with tempfile.TemporaryDirectory(prefix="bpp_parent_") as tmp:
        src, dst = os.path.join(tmp, "cases.pt"), os.path.join(tmp, "ms.json")
        torch.save(cases, src)
        code = ("import importlib.util, sys\n"
                "sys.path.insert(0, sys.argv[1])\n"
                "spec = importlib.util.spec_from_file_location("
                "'smoke', sys.argv[2])\n"
                "m = importlib.util.module_from_spec(spec)\n"
                "spec.loader.exec_module(m)\n"
                "m.time_cases(sys.argv[3], sys.argv[4])\n")
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c", code, os.path.abspath(parent),
                        os.path.abspath(__file__), src, dst],
                       cwd=os.path.abspath(parent), check=True, timeout=900)
        with open(dst) as f:
            before = json.load(f)
        print(f"[x64] parent: built and timed in "
              f"{time.perf_counter() - t0:.1f} s | {smi}")
        time_cases(src, dst)
        with open(dst) as f:
            after = json.load(f)
    rows = []
    for case, p_ms, n_ms in zip(cases, before, after):
        print(f"[x64] parent vs this tree: {case['kernel']} float64 "
              f"{case['model']}+C{case['C']}, {case['store']} store | "
              f"parent {p_ms:.4f} ms | this tree {n_ms:.4f} ms a launch | "
              f"{smi}")
        rows.append((case, p_ms, n_ms))
    return rows


def hold_shapes_f64(dev, smi):
    """``[x64] shapes``: both float64 builds against their float64 plain
    versions on ``[shapes]``' batches (1..16 sequences, caterpillar and
    balanced trees, 0..200 patterns; 64 and 128 tips) under the store the
    wrappers pick and under the other one where a warp fits, and on
    128-tip trees with branches of about 2e-8 (ages x 1e-5), whose
    patterns' likelihoods fall far below double's range unless the
    kernels rescale (held at JC69): K2 within ``TOL_SITE_F64`` a pattern,
    K1 within ``TOL_LNL_F64`` a locus."""
    import torch

    from bpp_tpu_torch.core import fels, pack
    from bpp_tpu_torch.core.units import Units
    from bpp_tpu_torch.testing import fixed_subst, shaped_batch
    from bpp_tpu_torch.trees.gtree import inner_order

    def hold(name, gt, n_seq, n_pat, tips, weights, model_name, n_cats):
        L = gt.n_loci
        model, s64 = fixed_subst(model_name, n_cats, L, torch.float64, dev)
        rk = torch.cat([s64.rates, s64.kappa1[:, None], s64.kappa2[:, None]],
                       dim=1)
        a = (inner_order(gt), gt.left, gt.right, gt.parent, n_seq, gt.age,
             s64.mu, rk, s64.freqs, s64.eigw, s64.eigT, s64.eigTi, tips)
        kw = dict(model=model, n_cats=n_cats)
        units = Units(n_pat.cpu().numpy(), tips.shape[2], dev)
        # the plain versions' closed-form P(t) is written with expm1, as
        # the kernels' factors are, so it keeps short branches' entries
        want = fels.site_logl_fels_ref(*a, n_pat=n_pat, **kw)
        want_l = pack.site_logl_packed_ref(*a, weights, **kw)
        # a one-sequence locus: the kernels root it at tip 0
        one = n_seq < 2
        tip0 = (tips[:, 0] * s64.freqs[:, None, :]).sum(-1).log()
        live = torch.arange(tips.shape[2], device=dev) < n_pat[:, None]
        tip0 = torch.where(live, tip0, torch.zeros_like(tip0))
        want = torch.where(one[:, None], tip0, want)
        want_l = torch.where(one, (weights * tip0).sum(1), want_l)
        picked = None
        for store in (None, "shared", "global"):
            try:
                site = fels.site_logl_fels(*a, n_pat=n_pat, units=units,
                                           clv_store=store, **kw)
                logl = pack.site_logl_packed(*a, weights, units=units,
                                             clv_store=store, **kw)
            except ValueError:
                if store != "shared":
                    raise
                continue            # a warp's CLVs do not fit a block
            torch.cuda.synchronize()
            if store is None:
                picked = fels.CLV_STORE
                if pack.CLV_STORE != picked:
                    raise AssertionError(f"[x64] shapes {name}: the wrappers "
                                         "picked different stores")
            if not bool(torch.isfinite(site).all()
                        & torch.isfinite(logl).all()):
                raise AssertionError(f"[x64] shapes {name}: non-finite lnL")
            if not bool((site[~live] == 0).all()):
                raise AssertionError(f"[x64] shapes {name}: K2 left a column "
                                     "past n_pat that is not 0")
            site_err = float((site - want).abs().max())
            err = float((logl - want_l).abs().max())
            print(f"[x64] shapes {name}: {L} loci, {model_name}+C{n_cats}, "
                  f"{store or 'picked: ' + picked} store | K2 max per-pattern"
                  f" |dlnL| {site_err:.3e} (tol {TOL_SITE_F64}) | K1 max per-"
                  f"locus |dlnL| {err:.3e} (tol {TOL_LNL_F64}) | {smi}")
            if not (site_err < TOL_SITE_F64 and err < TOL_LNL_F64):
                raise AssertionError(f"[x64] shapes {name}: the float64 "
                                     "builds and their plain versions differ")

    def batch(T, n_cols, seed, age_scale=1.0):
        gt, n_seq, n_pat, tips, weights = shaped_batch(
            T, n_cols, seed=seed, dtype=torch.float64, device=dev)
        gt = gt._replace(age=gt.age * age_scale)
        if T == 16:
            return gt, n_seq, n_pat, tips, weights
        keep = slice(2 * T - 12, 2 * T)       # the 12 loci of most tips
        return (type(gt)(*(x[keep].contiguous() for x in gt[:4])),
                n_seq[keep], n_pat[keep], tips[keep].contiguous(),
                weights[keep].contiguous())

    hold("1..16 sequences, caterpillar and balanced, 0..200 patterns",
         *batch(16, 200, 3), "HKY", 4)
    hold("64 tips", *batch(64, 72, 64), "HKY", 4)
    hold("128 tips", *batch(128, 72, 128), "GTR", 8)
    hold("128 tips, branches x 1e-5", *batch(128, 72, 7, 1e-5), "JC69", 1)


def ptxas_usage(name):
    """{(scalar "f" or "d", family, C, shared): (registers, spill store
    bytes, spill load bytes)} of every instantiation of ``csrc/<name>.cu``'s
    kernel, from the ``-Xptxas -v`` report ``core/_build`` keeps beside the
    library."""
    import re

    from bpp_tpu_torch.core import _build
    text = _build.library_path(name).with_suffix(".log").read_text()
    # float: <name>_kernel<float, FAM, C, SHARED>; double:
    # <name>_kernel_f64<FAM, C, SHARED>
    tag = re.compile(r"_kernel(?:I([fd])|_f64I)Li(\d)ELi(\d)ELb([01])E")
    usage, spills, regs = {}, {}, {}
    key = None
    for line in text.splitlines():
        if "entry function" in line or "Function properties" in line:
            m = tag.search(line)
            key = ((m[1] or "d", int(m[2]), int(m[3]), m[4] == "1") if m
                   else None)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and key is not None:
            spills[key] = (int(m[1]), int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        if m and key is not None:
            regs[key] = int(m[1])
    for key in regs:
        usage[key] = (regs[key], *spills.get(key, (-1, -1)))
    return usage


def x64_diagnosis(label, eng, state, smi, cats=X64_CATS, keep=None):
    """``[x64] diagnosis``: ``eng``'s kernel (K2 at HKY with a diploid map,
    else K1 at JC69) on ``state``'s gene trees for each build (float32,
    float64) x CLV store x C in ``cats``: device ms a launch (profiler, one
    window of 10), the prologue's ms alone (the same launch with no real
    pattern in any unit, so that no lane walks), blocks and warps an SM
    (the CUDA occupancy API at the launch plan), shared bytes a block, and
    the instantiation's registers and spills (:func:`ptxas_usage`).
    ``keep``, a list, gets the float64 launches' inputs
    (:func:`parent_times`).  Returns {(build, store, C): (ms, prologue ms,
    blocks an SM)}."""
    import torch

    from bpp_tpu_torch.core import fels, pack
    from bpp_tpu_torch.core.pack import KernelArgs
    from bpp_tpu_torch.testing import fixed_subst
    ctx = eng.ctx
    k2 = ctx.res_map is not None
    mod, kname = (fels, "fels_site_logl_kernel") if k2 else \
        (pack, "pack_logl_kernel")
    model_name = "HKY" if k2 else "JC69"
    usage = ptxas_usage("fels_kernel" if k2 else "pack_kernel")
    fam = {"HKY": 1, "JC69": 0}[model_name]
    rows = {}
    for dtype, build in ((torch.float32, "f"), (torch.float64, "d")):
        for C in cats:
            model, subst = fixed_subst(model_name, C, state.gt.n_loci,
                                       dtype, ctx.weights.device)
            a = pass_args(state, subst, ctx, dtype)
            kw = dict(model=model, n_cats=C, units=ctx.units)
            for store in ("shared", "global"):
                kargs = (fels.kernel_args(*a[:-1], n_pat=ctx.n_pat,
                                          clv_store=store, **kw) if k2 else
                         pack.kernel_args(*a, clv_store=store, **kw))
                # the same launch with no real pattern: only the prologue
                idle = ctx.units.units.clone()
                idle[:, 2:] = 0
                tensors = list(kargs.tensors)
                tensors[13] = idle
                pargs = KernelArgs(tuple(tensors), kargs.dims, kargs.plan)
                ms = kernel_device_ms(lambda: mod.launch(kargs), kname,
                                      reps=10, windows=1)
                pro = kernel_device_ms(lambda: mod.launch(pargs), kname,
                                       reps=10, windows=1)
                blocks = mod.blocks_per_sm(kargs)
                regs, sst, sld = usage.get((build, fam, C, store == "shared"),
                                           (-1, -1, -1))
                rows[(build, store, C)] = (ms, pro, blocks)
                if keep is not None and build == "d":
                    keep.append(x64_case(k2, ctx, a, model, C, store))
                print(f"[x64] diagnosis {label}: {model_name}+C{C} "
                      f"{'float64' if build == 'd' else 'float32'} build, "
                      f"{store} store | {ms:.4f} ms a launch | prologue "
                      f"alone {pro:.4f} ms | {blocks} blocks of "
                      f"{kargs.plan.threads} threads an SM "
                      f"({blocks * kargs.plan.threads // 32} warps) | "
                      f"{kargs.plan.shared_bytes} B shared a block | "
                      f"{regs} registers, spill stores {sst} B, loads {sld} "
                      f"B | {smi}")
    return rows


def x64_phases(dev, smi, iters, parent=None):
    """``[main 16]``: main 1 with ``--x64`` through the CLI, K1's float64
    build launched 8 times an iteration plus 1 and the float32 build
    never, and the diploid chain of main 2 with ``--x64`` for 10
    iterations through K2's float64 build; ``[x64]``: both float64 builds
    held and timed (:func:`hold_f64`); the ``[profile]`` of the float64
    step.  Returns (K1 float64 launches, K2 float64 launches, K1 error,
    K1 row, K2 error, K2 row, the chain seconds of the two runs)."""
    import torch

    from bpp_tpu_torch.core import fels, pack
    with open("run16.ctl", "w") as f:
        f.write(RUN_CTL.format(nloci=N_LOCI, burnin=BURNIN, nsample=NSAMPLE,
                               job="out16", extra=""))
    with ChainTimer() as timer:
        launches, _ = run_chain(
            ["--cfile", "run16.ctl", "--x64"], "out16", iters,
            (PASSES_PER_ITER * iters + 1, 0), ("theta", "tau"), "main 16",
            smi)
    k1_f64 = pack.LAUNCHES_F64
    if k1_f64 != launches:
        raise AssertionError(f"main 16: {k1_f64} of {launches} K1 launches "
                             "were of the float64 build")
    short = BF_BURNIN + BF_NSAMPLE
    with open("run16d.ctl", "w") as f:
        f.write(RUN2_CTL.format(nloci=N_LOCI, burnin=BF_BURNIN,
                                nsample=BF_NSAMPLE, job="out16d", extra=""))
    with timer:
        # HKY+G4: 4 categories, on the device scratch in float64
        _, k2_launches = run_chain(
            ["--cfile", "run16d.ctl", "--x64"], "out16d", short,
            (0, PASSES_PER_ITER_2 * short + 1), ("theta", "tau"),
            "main 16 diploid", smi, nsample=BF_NSAMPLE,
            clv_store=("global" if 4 > pack.F64_SHARED_MAX_CATS
                       else "shared"))
    k2_f64 = fels.LAUNCHES_F64
    if k2_f64 != k2_launches:
        raise AssertionError(f"main 16 diploid: {k2_f64} of {k2_launches} "
                             "K2 launches were of the float64 build")
    print(f"[main 16] --x64: K1 float64 build {k1_f64} launches, float32 "
          f"build 0; K2 float64 build {k2_f64} launches, float32 build 0 | "
          f"{smi}")
    eng, state, ips = warm_engine(load_run("run16.ctl", "float64"), dev)
    profile_step(eng, state, 1e3 / ips, smi, "pack_logl_kernel",
                 "JC69 float64 step (main 16)", PASSES_PER_ITER)
    t0 = time.perf_counter()
    keep = []
    x64_diagnosis("K1, main 1's batch", eng, state, smi, keep=keep)
    err1, row1 = hold_f64("K1, main 16's gene trees", eng, state, smi,
                          keep=keep)
    del eng, state
    engd, stated, _ = warm_engine(load_run("run16d.ctl", "float64"), dev, 2,
                                  3)
    x64_diagnosis("K2, main 2's batch", engd, stated, smi, keep=keep)
    err2, row2 = hold_f64("K2, the diploid data", engd, stated, smi,
                          keep=keep)
    del engd, stated
    hold_shapes_f64(dev, smi)
    print(f"[x64] diagnosis, holds and shapes in "
          f"{time.perf_counter() - t0:.1f} s | {smi}")
    if parent is not None:
        parent_times(parent, keep, smi)
    torch.cuda.empty_cache()
    return k1_f64, k2_f64, err1, row1, err2, row2, timer.seconds


class ChainTimer:
    """While active, the wall seconds of every ``Engine.run_mcmc`` call
    (the initial state and the chain: no loading, no summary), kept in
    ``seconds`` across activations."""

    def __init__(self):
        self.seconds = []

    def __enter__(self):
        from bpp_tpu_torch.mcmc import driver
        self._orig = orig = driver.Engine.run_mcmc

        def timed(eng, *a, **kw):
            import torch
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return orig(eng, *a, **kw)
            finally:
                torch.cuda.synchronize()
                self.seconds.append(time.perf_counter() - t0)
        driver.Engine.run_mcmc = timed
        return self

    def __exit__(self, *exc):
        from bpp_tpu_torch.mcmc import driver
        driver.Engine.run_mcmc = self._orig
        return False


def native_phase(smi):
    """``[native]``: main 1's data loaded through the native compressor
    (asserted to run) and through the numpy path: the batches and every
    locus's patterns and weights bit-equal.  Returns the two load times
    (seconds)."""
    import numpy as np

    from bpp_tpu_torch.data import cnative
    from bpp_tpu_torch.loader import load_run_from_ctl
    if not cnative.available():
        raise AssertionError(f"[native] the native compressor does not "
                             f"load: {cnative.ERROR}")
    cnative.CALLS = 0
    t0 = time.perf_counter()
    nat = load_run_from_ctl("run.ctl")
    t_nat = time.perf_counter() - t0
    calls = cnative.CALLS
    if calls < nat.batch.n_loci:
        raise AssertionError(f"[native] {calls} native compressions for "
                             f"{nat.batch.n_loci} loci")
    os.environ["BPP_TPU_NATIVE"] = "0"
    try:
        t0 = time.perf_counter()
        ref = load_run_from_ctl("run.ctl")
        t_np = time.perf_counter() - t0
    finally:
        del os.environ["BPP_TPU_NATIVE"]
    if cnative.CALLS != calls:
        raise AssertionError("[native] BPP_TPU_NATIVE=0 still compressed "
                             "natively")
    for f in ("tip_codes", "weights", "n_pat", "n_seq", "tip_pop",
              "locus_mask", "res_map", "res_count", "n_sites"):
        a, b = getattr(nat.batch, f), getattr(ref.batch, f)
        if not (a.dtype == b.dtype and np.array_equal(a, b)):
            raise AssertionError(f"[native] batch.{f} differs from the "
                                 "numpy path's")
    for la, lb in zip(nat.loci, ref.loci, strict=True):
        if not (np.array_equal(la.codes, lb.codes)
                and np.array_equal(la.weights, lb.weights)
                and la.codes.dtype == lb.codes.dtype
                and la.weights.dtype == lb.weights.dtype):
            raise AssertionError(f"[native] locus {la.index}: patterns or "
                                 "weights differ from the numpy path's")
    print(f"[native] {nat.batch.n_loci} loci of run.ctl loaded in "
          f"{t_nat * 1e3:.1f} ms through the native compressor ({calls} "
          f"compressions) and in {t_np * 1e3:.1f} ms through numpy; patterns "
          f"and weights bit-equal | {smi}")
    return t_nat, t_np


def shard_rank(rank, port, ctl, result_dir):
    """One rank of ``[shard]`` (spawned): ``cli.main --multihost`` on the
    card, rank 1 in an empty directory of its own; writes its launch
    counts, the (loci, device) of every launch, the calls of the plain
    versions, the backend and the chain's wall seconds to
    ``rank<r>.json``."""
    import torch

    from bpp_tpu_torch import cli
    from bpp_tpu_torch.core import fels, pack
    from bpp_tpu_torch.parallel import multihost
    seen = {"K1": set(), "K2": set()}
    plain = {"K1": 0, "K2": 0}
    for key, mod, ref in (("K1", pack, "site_logl_packed_ref"),
                          ("K2", fels, "site_logl_fels_ref")):
        def launch(args, orig=mod.launch, key=key):
            out = args.tensors[-1]
            seen[key].add((int(out.shape[0]), str(out.device)))
            return orig(args)

        def plain_pass(*a, orig=getattr(mod, ref), key=key, **kw):
            plain[key] += 1
            return orig(*a, **kw)
        mod.launch = launch
        setattr(mod, ref, plain_pass)
    backend = []
    orig_shutdown = multihost.shutdown

    def shutdown():
        import torch.distributed as dist
        backend.append(dist.get_backend())
        orig_shutdown()
    multihost.shutdown = shutdown
    if rank:
        os.makedirs(f"rank{rank}", exist_ok=True)
        os.chdir(f"rank{rank}")
    pack.LAUNCHES = fels.LAUNCHES = 0
    pack.LAUNCHES_F64 = fels.LAUNCHES_F64 = 0
    with ChainTimer() as timer:
        rc = cli.main(["--cfile", ctl, "--x64", "--quiet", "--multihost",
                       f"127.0.0.1:{port},{SHARD_RANKS},{rank}"])
    torch.cuda.synchronize()
    with open(os.path.join(result_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"rc": rc, "K1": pack.LAUNCHES, "K1_f64": pack.LAUNCHES_F64,
                   "K2": fels.LAUNCHES, "K2_f64": fels.LAUNCHES_F64,
                   "seen": {k: sorted(v) for k, v in seen.items()},
                   "plain": plain, "backend": backend,
                   "device": torch.cuda.current_device(),
                   "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
                   "chain_s": timer.seconds}, f)


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _same_chain(job, ref_job, label):
    """``job``'s mcmc.txt equals ``ref_job``'s: the header, lnL to 1e-6
    and every other column to rtol 1e-9."""
    import numpy as np
    tabs = []
    for j in (job, ref_job):
        with open(f"{j}.mcmc.txt") as f:
            head = f.readline().split()
            tabs.append((head, np.loadtxt(f, ndmin=2)))
    (h1, a), (h2, b) = tabs
    if h1 != h2 or a.shape != b.shape:
        raise AssertionError(f"{label}: {job}.mcmc.txt is not shaped as "
                             f"{ref_job}'s")
    j = h1.index("lnL")
    dl = float(np.abs(a[:, j] - b[:, j]).max())
    rest_a, rest_b = np.delete(a, j, 1), np.delete(b, j, 1)
    rel = float((np.abs(rest_a - rest_b)
                 / np.maximum(np.abs(rest_b), 1e-300)).max())
    if not (dl <= 1e-6 and np.allclose(rest_a, rest_b, rtol=1e-9, atol=0)):
        raise AssertionError(f"{label}: {job}.mcmc.txt differs from "
                             f"{ref_job}'s: lnL by {dl}, the other columns "
                             f"by {rel} relative")
    return dl, rel


def shard_phase(smi, main16_s):
    """``[shard]``: main 16's JC69 and diploid runs on two ranks of the one
    card (see the module docstring).  ``main16_s``: the chain seconds of
    main 16's two runs.  Returns (K1 float64 launches, K2 float64
    launches) summed over the ranks."""
    import torch.multiprocessing as mp
    work = os.getcwd()
    runs = (("runsh.ctl", "run16.ctl", "outsh", "out16", BURNIN, NSAMPLE,
             "K1", PASSES_PER_ITER, main16_s[0]),
            ("runshd.ctl", "run16d.ctl", "outshd", "out16d", BF_BURNIN,
             BF_NSAMPLE, "K2", PASSES_PER_ITER_2, main16_s[1]))
    totals = {"K1": 0, "K2": 0}
    for ctl, ref_ctl, job, ref_job, burnin, nsample, kern, passes, ref_s \
            in runs:
        iters = burnin + nsample
        with open(ref_ctl) as f:
            text = f.read()
        # the data by absolute path: rank 1 runs in a directory of its own
        for key in ("seqfile", "Imapfile"):
            text = text.replace(f"{key} = ", f"{key} = {work}/")
        with open(ctl, "w") as f:
            f.write(text.replace(f"jobname = {ref_job}\n",
                                 f"jobname = {job}\n"))
        for r in range(SHARD_RANKS):
            if os.path.exists(f"rank{r}.json"):
                os.unlink(f"rank{r}.json")
        t0 = time.perf_counter()
        procs = mp.spawn(shard_rank,
                         args=(_free_port(), os.path.join(work, ctl), work),
                         nprocs=SHARD_RANKS, join=False)
        try:
            while not procs.join(timeout=5):
                if time.perf_counter() - t0 > SHARD_TIMEOUT:
                    raise AssertionError(f"[shard] {job}: the ranks still "
                                         f"run after {SHARD_TIMEOUT} s")
        finally:
            for p in procs.processes:
                if p.is_alive():
                    p.kill()
            for p in procs.processes:
                p.join(timeout=30)
        wall = time.perf_counter() - t0
        res = []
        for r in range(SHARD_RANKS):
            with open(f"rank{r}.json") as f:
                res.append(json.load(f))
        per = -(-N_LOCI // SHARD_RANKS)
        want = passes * iters + 1
        other = "K2" if kern == "K1" else "K1"
        for r, got in enumerate(res):
            lo, hi = r * per, min((r + 1) * per, N_LOCI)
            if got["rc"] != 0:
                raise AssertionError(f"[shard] {job} rank {r}: cli.main "
                                     f"returned {got['rc']}")
            if (got[kern], got[f"{kern}_f64"], got[other]) != (want, want, 0):
                raise AssertionError(
                    f"[shard] {job} rank {r}: {kern} launched {got[kern]} "
                    f"times ({got[f'{kern}_f64']} float64), {other} "
                    f"{got[other]}; expected {want} float64 launches")
            if got["seen"][kern] != [[hi - lo, "cuda:0"]]:
                raise AssertionError(f"[shard] {job} rank {r}: {kern} "
                                     f"launched on {got['seen'][kern]}, not "
                                     f"its {hi - lo} loci on cuda:0")
            if got["device"] != 0 or any(got["plain"].values()):
                raise AssertionError(f"[shard] {job} rank {r}: device "
                                     f"{got['device']}, plain passes "
                                     f"{got['plain']}")
            if got["backend"] != ["gloo"]:
                raise AssertionError(f"[shard] {job} rank {r}: backend "
                                     f"{got['backend']}")
        if os.listdir("rank1"):
            raise AssertionError(f"[shard] rank 1 wrote {os.listdir('rank1')}")
        files = sorted(f for f in os.listdir(".") if f.startswith(job + ".")
                       and f != ctl)
        want_files = sorted(f"{job}.{x}" for x in
                            ("FigTree.tre", "mcmc.txt", "pdf", "txt"))
        if files != want_files:
            raise AssertionError(f"[shard] {job}: wrote {files}, expected "
                                 f"{want_files}")
        dl, rel = _same_chain(job, ref_job, f"[shard] {job}")
        check_chain_output(job, nsample, ("theta", "tau"))
        ms = [1e3 * g["chain_s"][0] / iters for g in res]
        totals[kern] += sum(g[f"{kern}_f64"] for g in res)
        PEAKS.append((f"[shard] {job} rank 0", res[0]["peak_mib"], 0.0))
        peaks = " / ".join(f"{g['peak_mib']:.1f}" for g in res)
        print(f"[shard] {SHARD_RANKS} ranks on cuda:0 (backend "
              f"{res[0]['backend'][0]}), --x64, {job} = main 16's {ref_job} "
              f"split {per} loci a rank: {kern} float64 launches "
              f"{' / '.join(str(g[f'{kern}_f64']) for g in res)} "
              f"(expected {want} each), plain passes 0 | rank 0's mcmc.txt "
              f"vs {ref_job}'s: max |dlnL| {dl:.3e}, other columns "
              f"{rel:.3e} relative | peak device memory {peaks} MiB a "
              f"rank | chain wall "
              f"{' / '.join(f'{m:.1f}' for m in ms)} ms/iter a rank vs "
              f"{1e3 * ref_s / iters:.1f} ms/iter on one process | phase "
              f"wall {wall:.1f} s (start-up, load, chain, summary) | {smi}")
    return totals["K1"], totals["K2"]


def spill_report(smi):
    """``[build]``: the float64 instantiations' registers and spills from
    the ``-Xptxas -v`` report; fails if one of C <= 4 spills."""
    for name in ("pack_kernel", "fels_kernel"):
        usage = {k: v for k, v in ptxas_usage(name).items() if k[0] == "d"}
        if len(usage) != 3 * 8 * 2:
            raise AssertionError(f"[build] {name}: {len(usage)} float64 "
                                 "instantiations in the build log, not 48")
        spilled = sorted(k[1:] for k, (_, st, ld) in usage.items()
                         if st or ld)
        regs = [v[0] for v in usage.values()]
        print(f"[build] {name} float64 build: {min(regs)}..{max(regs)} "
              f"registers a thread; spilling (family, C, shared): "
              f"{spilled or 'none'} | {smi}")
        if any(c <= 4 for _, c, _ in spilled):
            raise AssertionError(f"[build] {name}: a float64 instantiation "
                                 "of C <= 4 spills")


def start_simulation(ctl):
    """The port's simulator on the control file ``ctl`` in a process of
    its own, its output in ``<ctl>.log``; :func:`finish_simulation` waits
    for it."""
    repo = os.path.dirname(os.path.abspath(__file__))
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=repo + (os.pathsep + path if path
                                              else ""))
    code = ("import sys, time\n"
            "from bpp_tpu_torch.sim.simulate import run_simulation\n"
            "t0 = time.perf_counter()\n"
            "run_simulation(sys.argv[1])\n"
            "print(f'{time.perf_counter() - t0:.1f} s')\n")
    log = open(ctl + ".log", "w")
    proc = subprocess.Popen([sys.executable, "-c", code, ctl], stdout=log,
                            stderr=subprocess.STDOUT, env=env)
    return proc, log, ctl


def finish_simulation(sim, timeout=600):
    """Wait for a :func:`start_simulation` process; (its own time as it
    printed it, the seconds waited here)."""
    proc, log, ctl = sim
    t0 = time.perf_counter()
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise
    finally:
        log.close()
    with open(ctl + ".log") as f:
        out = f.read().strip()
    if rc != 0:
        raise AssertionError(f"the simulation of {ctl} failed (rc {rc}): "
                             f"{out[-2000:]}")
    return out.splitlines()[-1], time.perf_counter() - t0


def main(argv=None) -> int:
    t_start = time.perf_counter()
    argv = sys.argv[1:] if argv is None else argv
    parent = None
    if len(argv) == 2 and argv[0] == "--parent" and os.path.isdir(
            os.path.join(argv[1], "bpp_tpu_torch")):
        parent = os.path.abspath(argv[1])     # the phases run elsewhere
    elif argv:
        print("usage: chip_smoke.py [--parent DIR]  (DIR holds the parent "
              "commit's bpp_tpu_torch/)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from bpp_tpu_torch.core import _build, fels, pack
    from bpp_tpu_torch.core import felsenstein as fe
    from bpp_tpu_torch.loader import load_run_from_ctl
    from bpp_tpu_torch.testing import write_partition_file

    laps = [("", t_start)]

    def lap(name):
        laps.append((name, time.perf_counter()))

    # 1. device
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{name} | nvidia-smi: {smi}")

    iters = BURNIN + NSAMPLE
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="bpp_smoke_") as work:
        os.chdir(work)
        sims = {}
        try:
            # 3, 6. the data of main 1 and main 2, each simulated in a
            # process of its own while the phases that need neither run
            for ctl, text in (("sim.ctl", SIM_CTL.format(nloci=N_LOCI_10K)),
                              ("sim2.ctl", SIM2_CTL.format(nloci=N_LOCI))):
                with open(ctl, "w") as f:
                    f.write(text)
                sims[ctl] = start_simulation(ctl)

            # 2. build: one nvcc per source, started together
            t0 = time.perf_counter()
            libs = _build.build_all(_build.KERNELS)
            libs.append(_build.build_host("compress"))
            print(f"[build] {', '.join(p.name for p in libs)} in "
                  f"{time.perf_counter() - t0:.2f} s")
            spill_report(smi)

            lap("build")

            # 13. shapes the bench data lacks; stores picked by the wrappers
            hold_shapes(dev, smi)

            lap("[shapes]")

            # 19. main path 9: amino acids through the 20-state plain pass
            aa_phase(dev, smi, iters)
            torch.cuda.empty_cache()

            lap("main 9")

            # 20-22. MSC-I: main 10, [net] (a)-(d), main 11
            launches10, launches11, err_net1, err_net2 = msci_phases(
                dev, smi, iters)
            torch.cuda.empty_cache()

            lap("MSC-I (main 10, [net], main 11, [cli])")

            # 3. data 1
            own, waited = finish_simulation(sims.pop("sim.ctl"))
            write_dates("dates.txt")
            for ctl, job, extra in (
                    ("run.ctl", "out", ""), ("run3.ctl", "out3", RELAXED),
                    ("run5.ctl", "out5", DATED.format(ck=CHECKPOINT_AT)),
                    ("run6.ctl", "out6", A01),
                    ("run8.ctl", "out8", CUSTOM8.format(check=CHECK_EVERY,
                                                        last=N_LOCI))):
                text = RUN_CTL.format(nloci=N_LOCI, burnin=BURNIN,
                                      nsample=NSAMPLE, job=job, extra=extra)
                if job == "out8":
                    text = text.replace("print = 1 0 0 0", "print = 1 0 0 1 0")
                with open(ctl, "w") as f:
                    f.write(text)
            write_partition_file("parts.txt", CUSTOM_MODELS, N_LOCI)
            print(f"[data 1] {N_LOCI_10K} haploid loci simulated in {own} "
                  f"(a process of its own since the start; waited "
                  f"{waited:.1f} s for it here); the 1000-locus paths read "
                  f"the first {N_LOCI}")

            # 4. kernel 1 against its plain version
            run = load_run_from_ctl("run.ctl")
            eng, state, step_ips = warm_engine(run, dev)
            profile_step(eng, state, 1e3 / step_ips, smi,
                         "pack_logl_kernel", "JC69 step", PASSES_PER_ITER)
            b = run.batch
            print(f"[kernel 1] L={b.n_loci} T={b.max_tips} "
                  f"S={b.max_patterns} real patterns "
                  f"{int(np.asarray(b.n_pat).sum())}")

            def k1_got_want(a32, a64, kw, kkw):
                return (pack.site_logl_packed(*a32, **kw, **kkw).double(),
                        pack.site_logl_packed_ref(*a64, **kw), None)

            errs1, rows1 = hold_kernel(
                "kernel 1", "pack_logl_kernel", pack, state, eng.ctx, b, dev,
                smi, k1_got_want,
                lambda a, kw, kkw: pack.kernel_args(*a, **kw, **kkw),
                lambda a, kw, kkw: pack.site_logl_packed(*a, **kw, **kkw),
                lambda a, kw: pack.site_logl_packed_ref(*a, **kw), False)
            launch_floor(dev, smi)
            print(f"[kernel 1] engine step (JC69, {N_LOCI} loci): "
                  f"{step_ips:.2f} iters/s after warm-up | {smi}")
            # the step as main 1 runs it: the a1b1 record every iteration
            eng.record_samples(a1b1=True)
            profile_step(eng, state, step_ms(eng, state, it=0), smi,
                         "pack_logl_kernel", "JC69 step with the a1b1 record",
                         PASSES_PER_ITER, it=0)
            del eng, state

            # 5. main path 1, through the CLI
            launches1, _ = run_chain(
                ["--cfile", "run.ctl"], "out", iters,
                (PASSES_PER_ITER * iters + 1, 0), ("theta", "tau"), "main 1",
                smi)
            print(f"[main 1] {check_a00_extras('out', NSAMPLE)} | {smi}")

            # 9. K1 on relaxed-clock branch lengths and on dated tips
            run3 = load_run_from_ctl("run3.ctl")
            eng3, state3, ips3 = warm_engine(run3, dev)
            profile_step(eng3, state3, 1e3 / ips3, smi, "pack_logl_kernel",
                         "JC69 relaxed clock 2 step", PASSES_PER_ITER_3)
            strict = fe.branch_lengths(state3.gt, torch.ones_like(
                state3.subst.mu))
            relaxed = relaxed_blen(eng3, state3, torch.float32)
            if bool(torch.isclose(relaxed, strict).all()):
                raise AssertionError("the relaxed clock's branch lengths "
                                     "equal the strict clock's")
            err_k1_blen, _ = hold_given(
                "K1, blen of the clock = 2 chain", eng3, state3, smi,
                lambda dt: relaxed_blen(eng3, state3, dt))
            print(f"[kernel 1] engine step (JC69, clock = 2, {N_LOCI} "
                  f"loci): {ips3:.2f} iters/s after warm-up | {smi}")
            del eng3, state3
            run5 = load_run_from_ctl("run5.ctl")
            eng5, state5, ips5 = warm_engine(run5, dev)
            T = state5.gt.n_tips
            if not bool((state5.gt.age[:, :T] > 0).any()):
                raise AssertionError("the dated chain has no dated tip")
            profile_step(eng5, state5, 1e3 / ips5, smi, "pack_logl_kernel",
                         "JC69 dated tips, integrated thetas step",
                         PASSES_PER_ITER_5)
            err_k1_dated, _ = hold_given("K1, dated tips", eng5, state5,
                                         smi)
            print(f"[kernel 1] engine step (JC69, dated, thetas integrated "
                  f"out, {N_LOCI} loci): {ips5:.2f} iters/s after warm-up | "
                  f"{smi}")
            del eng5, state5

            # 10. main path 3: the IID relaxed clock
            launches3, _ = run_chain(
                ["--cfile", "run3.ctl"], "out3", iters,
                (PASSES_PER_ITER_3 * iters + 1, 0),
                ("theta", "tau", "mu_bar", "nu_bar"), "main 3", smi)

            # 12. main path 5: integrated thetas, dated tips, checkpoint,
            # resume
            launches5, _ = run_chain(
                ["--cfile", "run5.ctl"], "out5", iters,
                (PASSES_PER_ITER_5 * iters + 1, 0), ("tau", "mu_bar"),
                "main 5", smi, chains=(K3_PER_ITER_5 * iters, 0, 0))
            os.replace("out5.mcmc.txt", "out5.whole.txt")
            with open("out5.whole.txt", "rb") as f:
                whole = f.read()
            with open("out5.mcmc.txt", "wb") as f:
                f.write(whole)
            rest = NSAMPLE - CHECKPOINT_AT
            resumed, _ = run_chain(
                ["--resume", "out5.chk.npz"], "out5", rest,
                (PASSES_PER_ITER_5 * rest + 1, 0), ("tau", "mu_bar"),
                "main 5 resumed", smi, chains=(K3_PER_ITER_5 * rest, 0, 0))
            with open("out5.mcmc.txt", "rb") as f:
                again = f.read()
            if again != whole:
                raise AssertionError("main 5: the resumed mcmc.txt differs "
                                     "from the uninterrupted run's")
            with open("out5.txt") as f:
                summary = f.read()
            if f"({NSAMPLE} samples" not in summary:
                raise AssertionError("main 5: the resumed summary does not "
                                     f"count all {NSAMPLE} samples")
            if "theta" in whole.split(b"\n")[0].decode():
                raise AssertionError("main 5: theta columns with thetas "
                                     "integrated out")
            print(f"[main 5] --resume at it {CHECKPOINT_AT}: mcmc.txt "
                  f"byte-identical to the whole run's ({len(whole)} bytes), "
                  f"summary over {NSAMPLE} samples, no theta column | {smi}")
            launches5 += resumed

            # 14. main path 6: A01 (SPR and SNL) through the CLI
            from bpp_tpu_torch.mcmc.state import MV_RJ, MV_SNL, MV_SSPR
            with MoveStats() as tally6:
                launches6, _ = run_chain(
                    ["--cfile", "run6.ctl"], "out6", iters,
                    (PASSES_PER_ITER_6 * iters + 1, 0), "A01", "main 6", smi)
            # the statistics count the move the SNL-or-SPR draw kept
            spr6, snl6 = tally6.stats[MV_SSPR], tally6.stats[MV_SNL]
            if not (spr6[0] and snl6[0] and spr6[0] + snl6[0] == iters):
                raise AssertionError(f"main 6: species moves (proposed, "
                                     f"accepted) SPR {spr6}, SNL {snl6}; "
                                     f"SPR and SNL must both run, one an "
                                     f"iteration")
            print(f"[main 6] species moves (proposed, accepted): SPR "
                  f"{tuple(spr6)}, SNL {tuple(snl6)} | {smi}")
            # 16. the kernels on the trees the species moves make
            err_topo1 = species_phase("A01 JC69", "run6.ctl", dev, smi,
                                      "pack_logl_kernel", PASSES_PER_ITER_6)
            torch.cuda.empty_cache()

            # 17. K1 on the per-locus eigensystems of a partition
            eng8, state8, ips8 = warm_engine(load_run_from_ctl("run8.ctl"),
                                             dev)
            if eng8.ctx.route != "K1":
                raise AssertionError(f"the partition took {eng8.ctx.route}")
            profile_step(eng8, state8, 1e3 / ips8, smi, "pack_logl_kernel",
                         "custom partition step", PASSES_PER_ITER_8)
            err_k1_custom, _ = hold_given(
                "K1, per-locus models", eng8, state8, smi,
                cases=own_cases(eng8, state8), tag="custom")
            print(f"[custom] engine step (partition, {N_LOCI} loci): "
                  f"{ips8:.2f} iters/s after warm-up | {smi}")
            del eng8, state8

            # 18. main path 8: the partition, check and print files
            launches8 = main8(iters, smi)

            lap("data 1, kernel 1, given, main 1, 3, 5, 6, 8, topo, custom")

            # 6. data 2
            t0 = time.perf_counter()
            own2, _ = finish_simulation(sims.pop("sim2.ctl"))
            for ctl, job, extra in (("run2.ctl", "out2", ""),
                                    ("run4.ctl", "out4", SIMPLE),
                                    ("run7.ctl", "out7", A11)):
                with open(ctl, "w") as f:
                    f.write(RUN2_CTL.format(nloci=N_LOCI, burnin=BURNIN,
                                            nsample=NSAMPLE, job=job,
                                            extra=extra))
            run2 = load_run_from_ctl("run2.ctl")
            b2 = run2.batch
            print(f"[data 2] {N_LOCI} diploid loci simulated in {own2} (a "
                  f"process of its own), waited for and loaded in "
                  f"{time.perf_counter() - t0:.1f} s | L={b2.n_loci} "
                  f"T={b2.max_tips} S={b2.max_patterns} "
                  f"W={b2.weights.shape[1]} R={b2.res_map.shape[2]} | real "
                  f"likelihood patterns {int(b2.n_pat.sum())} | real weight "
                  f"patterns {int((b2.weights > 0).sum())}")

            # 7. kernel 2 against its plain version
            eng2, state2, step_ips2 = warm_engine(run2, dev)
            ctx2 = eng2.ctx
            if ctx2.res_map is None:
                raise AssertionError("the diploid batch carries no "
                                     "resolution map")
            profile_step(eng2, state2, 1e3 / step_ips2, smi,
                         "fels_site_logl_kernel", "diploid HKY+G4 step",
                         PASSES_PER_ITER_2)
            w64 = ctx2.weights.double()

            def k2_got_want(a32, a64, kw, kkw):
                got = fels.site_logl_fels(*a32[:-1], n_pat=ctx2.n_pat, **kw,
                                          **kkw).double()
                want = fels.site_logl_fels_ref(*a64[:-1], n_pat=ctx2.n_pat,
                                               **kw)
                return (fe.reduce_root(got, w64, ctx2.res_map,
                                       ctx2.res_count),
                        fe.reduce_root(want, w64, ctx2.res_map,
                                       ctx2.res_count),
                        float((got - want).abs().max()))

            errs2, rows2 = hold_kernel(
                "kernel 2", "fels_site_logl_kernel", fels, state2, ctx2, b2,
                dev, smi, k2_got_want,
                lambda a, kw, kkw: fels.kernel_args(
                    *a[:-1], n_pat=ctx2.n_pat, **kw, **kkw),
                lambda a, kw, kkw: fels.site_logl_fels(
                    *a[:-1], n_pat=ctx2.n_pat, **kw, **kkw),
                lambda a, kw: fels.site_logl_fels_ref(
                    *a[:-1], n_pat=ctx2.n_pat, **kw), True)
            print(f"[kernel 2] engine step (diploid HKY+G4, {N_LOCI} loci): "
                  f"{step_ips2:.2f} iters/s after warm-up | {smi}")
            time_moves(eng2, state2, dev, smi)
            del eng2, state2, ctx2, w64
            torch.cuda.empty_cache()

            # 8. main path 2, through the CLI
            _, launches2 = run_chain(
                ["--cfile", "run2.ctl"], "out2", iters,
                (0, PASSES_PER_ITER_2 * iters + 1),
                ("theta", "tau", "mu_bar"), "main 2", smi)

            # 9. K2 on the SIMPLE clock's branch lengths
            run4 = load_run_from_ctl("run4.ctl")
            eng4, state4, ips4 = warm_engine(run4, dev)
            profile_step(eng4, state4, 1e3 / ips4, smi,
                         "fels_site_logl_kernel",
                         "diploid HKY+G4 clock 4 step", PASSES_PER_ITER_4)
            err_k2_blen, _ = hold_given(
                "K2, blen of the clock = 4 chain", eng4, state4, smi,
                lambda dt: relaxed_blen(eng4, state4, dt))
            print(f"[kernel 2] engine step (diploid HKY+G4, clock = 4, "
                  f"{N_LOCI} loci): {ips4:.2f} iters/s after warm-up | {smi}")
            del eng4, state4
            torch.cuda.empty_cache()

            # 11. main path 4: the SIMPLE relaxed clock on diploid data
            _, launches4 = run_chain(
                ["--cfile", "run4.ctl"], "out4", iters,
                (0, PASSES_PER_ITER_4 * iters + 1),
                ("theta", "tau", "mu_bar", "r:"), "main 4", smi)

            # 15. main path 7: A11 on the diploid data through the CLI
            with MoveStats() as tally7:
                _, launches7 = run_chain(
                    ["--cfile", "run7.ctl"], "out7", iters,
                    (0, PASSES_PER_ITER_7 * iters + 1), "A11", "main 7", smi)
            print("[main 7] moves (proposed, accepted): " + ", ".join(
                f"{n} {tuple(tally7.stats[mv])}" for n, mv in (
                    ("species SPR", MV_SSPR), ("SNL", MV_SNL),
                    ("rj", MV_RJ))) + f" | {smi}")
            if tally7.stats[MV_RJ][0] != iters:
                raise AssertionError("main 7: the rj move did not run once "
                                     "an iteration")
            # 16. K2 on the trees the species and rj moves make
            err_topo2 = species_phase("A11 diploid HKY+G4", "run7.ctl", dev,
                                      smi, "fels_site_logl_kernel",
                                      PASSES_PER_ITER_7)
            torch.cuda.empty_cache()

            # 17. K2 on the per-locus eigensystems of the partition
            from bpp_tpu_torch.mcmc.driver import Engine
            with open("run8d.ctl", "w") as f:
                f.write(RUN2_CTL.format(
                    nloci=N_LOCI, burnin=BURNIN, nsample=NSAMPLE, job="out8d",
                    extra="").replace("model = HKY", "model = custom parts.txt"))
            eng8d = Engine(load_run_from_ctl("run8d.ctl"), seed=1, device=dev)
            if eng8d.ctx.route != "K2":
                raise AssertionError(f"the diploid partition took "
                                     f"{eng8d.ctx.route}")
            state8d, _ = eng8d.chunk_step(eng8d.init_state(), 3)
            err_k2_custom, _ = hold_given(
                "K2, per-locus models (diploid)", eng8d, state8d, smi,
                cases=own_cases(eng8d, state8d), tag="custom")
            del eng8d, state8d
            torch.cuda.empty_cache()

            lap("data 2, kernel 2, main 2, 4, 7, topo, custom")

            # 23-24. MSC-M: main 12, [mig] (a)-(c)
            launches12, err_mig1, err_mig2 = mig_phases(dev, smi, iters)
            torch.cuda.empty_cache()

            lap("MSC-M (main 12, [mig])")

            # 25. chains = 2: main 13
            launches13 = main13(iters, smi, dev)
            # 43. chains = 4 on the diploid data: main 23
            launches23, err23 = main23(iters, smi)
            # 45-46. chains = 4 with A10 and Gamma-Dirichlet rates (K4),
            # and with integrated thetas (K3), batched
            launches24, err24 = main24(iters, smi)
            launches25, err25 = main25(iters, smi)
            torch.cuda.empty_cache()

            # 26. geneflow rjMCMC on main 12's data: main 14
            launches14 = main14(smi)
            torch.cuda.empty_cache()
            # 47-48. chains = 4 under MSC-M, and A10 x MSC-M, batched (K5
            # over the chains)
            launches26, err26, err26w = mig_chains_main(
                26, "", PASSES_PER_ITER_12, smi)
            launches27, err27, err27w = mig_chains_main(
                27, A10_27, PASSES_PER_ITER_27, smi)
            torch.cuda.empty_cache()
            # 49. chains = 4 on the MSC-I network, batched
            launches28, err28 = main28(smi)
            torch.cuda.empty_cache()

            # 27. morphological traits on main 1's data: main 15
            launches15 = main15(smi, dev)

            # 28. --bfdriver and --summary: [tools]
            launches_bf = tools_phase(smi)

            lap("main 13, 23, 24, 25, 14, 26, 27, 28, 15, [tools]")

            # 33-38. the configurations no earlier run took to the card
            launches17, err17 = main17(smi)
            launches18, err18 = main18(smi)
            launches19, err19 = subst_main(19, "TN93", PASSES_PER_ITER_19,
                                           smi)
            launches20, err20 = subst_main(20, "GTR", PASSES_PER_ITER_20, smi)
            # 50. chains = 4 under GTR+G4, batched: a per-chain
            # eigensystem
            launches29, err29 = main29(smi)
            launches21, err21 = main21(smi)
            launches22, err22 = main22(smi)
            torch.cuda.empty_cache()

            lap("main 17-22, 29")

            # 42. K3, K4 and K5 against their plain versions on the main
            # paths' calls
            chain_rows = chains_phase(smi, parent)

            lap("[chains]")

            # 44. chains = K per-chain against batched, and the batched
            # launches against one-chain launches
            batch_rows, batch_chain_rows = chains_batch_phase(smi)
            torch.cuda.empty_cache()

            lap("[chains-batch]")

            # 40. the eager step against the replayed one, in one process
            graph_phases(smi)
            eigen_phase(smi)

            lap("[graph]")

            # 29-30. --x64 through the float64 builds: main 16, [x64]
            (k1_f64, k2_f64, err_x1, row_x1, err_x2,
             row_x2, main16_s) = x64_phases(dev, smi, iters, parent)

            # 31. the native pattern compressor: [native]
            native_phase(smi)

            # 32. locus sharding on two ranks of the card: [shard]
            k1_shard, k2_shard = shard_phase(smi, main16_s)

            lap("main 16, [x64], [native], [shard]")

            # 41. the synchronising ops of every main path's step
            for label, ctl, x64 in SYNC_MAINS:
                sync_pass(label, ctl, smi, x64)

            lap("[sync]")

            # 39. every run's peak device memory
            memory_report(smi)
        finally:
            for proc, log, _ in sims.values():
                proc.kill()
                proc.wait()
                log.close()
            os.chdir(cwd)

    def entry(kname, source, replaces, launches, errs, row):
        if not launches:
            raise AssertionError(f"{kname}: not launched on its main paths")
        ms, plain, bms, by = row[:4]
        return {"name": kname, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(errs), "ms": ms,
                "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                "library_ms": None}

    print(f"[time] whole script {time.perf_counter() - t_start:.1f} s, "
          f"the kernels' build included: " + " | ".join(
              f"{n} {t1 - t0:.1f}" for (_, t0), (n, t1)
              in zip(laps, laps[1:])) + f" | {smi}")
    print("[launches] the kernels line's launches: every main path's run; "
          "on the graph route a graph's captured launches times its "
          "replays, the warm-up iteration before each capture (run, then "
          "undone) and the capture itself left out; K3-K5 as K1/K2 (main "
          "5 and its resume, main 25: K3; mains 21, 24: K4; mains 12, 14, "
          "26, 27: K5; under chains = 4 one launch for the four chains), "
          "their "
          "errors from [chains] and [chains-batch] (K3/K4: the largest "
          "|kernel - plain| of "
          "the 0/1 accept decisions over the loci compared, each call "
          "through its first disagreement; K5: max |dt| of a walk clear "
          "of a tie)")
    chain_total = [sum(c[k] for _, c in CHAIN_LAUNCHES) for k in range(3)]
    # launches: every main path's run (on the graph route its replays; a
    # graph's warm-up iteration before capture is not counted); errors:
    # the bench models' holds,
    # those on relaxed-clock lengths and dated tips, on the trees of the
    # species and rj moves, on a partition's per-locus eigensystems, on
    # network gene trees ([net]), on migration gene trees ([mig]) and on
    # the last states of mains 17-22; the
    # float64 builds: main 16's and the [shard] ranks' launches and the
    # [x64] holds
    print(json.dumps({"kernels": [
        entry("K1 pallas_pack._make_kernel -> pack_logl_kernel",
              "bpp_tpu_torch/csrc/pack_kernel.cu",
              "bpp_tpu/core/pallas_pack.py:315",
              launches1 + launches3 + launches5 + launches6 + launches8
              + launches10 + launches11 + launches12 + launches13
              + launches14 + launches15 + launches_bf + launches17
              + launches18 + launches19 + launches20 + launches22
              + launches24 + launches25 + launches26 + launches27
              + launches28 + launches29,
              [*errs1.values(), err_k1_blen, err_k1_dated, err_topo1,
               err_k1_custom, err_net1, err_mig1, err17, err18, err19,
               err20, err22, err24, err25, err26, err27, err28, err29,
               *(batch_rows[m][0] for m in (
                   "main 13", "main 18", "main 28", "main 11 x 4",
                   "main 29", "main 8 x 4", "main 15 x 4"))],
              rows1["JC69"]),
        entry("K2 pallas_fels._make_kernel -> fels_site_logl_kernel",
              "bpp_tpu_torch/csrc/fels_kernel.cu",
              "bpp_tpu/core/pallas_fels.py:92",
              launches2 + launches4 + launches7 + launches21 + launches23,
              [*errs2.values(), err_k2_blen, err_topo2, err_k2_custom,
               err_net2, err_mig2, err21, err23,
               batch_rows["main 23"][0]], rows2["HKY"]),
        entry("K1 pallas_pack._make_kernel -> pack_logl_kernel "
              "(float64 build)", "bpp_tpu_torch/csrc/pack_kernel.cu",
              "bpp_tpu/core/pallas_pack.py:315", k1_f64 + k1_shard, [err_x1],
              row_x1),
        entry("K2 pallas_fels._make_kernel -> fels_site_logl_kernel "
              "(float64 build)", "bpp_tpu_torch/csrc/fels_kernel.cu",
              "bpp_tpu/core/pallas_fels.py:92", k2_f64 + k2_shard, [err_x2],
              row_x2),
        entry("K3 notheta.scan_accept lax.scan -> notheta_chain_kernel",
              "bpp_tpu_torch/csrc/chain_kernel.cu",
              "bpp_tpu/mcmc/notheta.py:86", chain_total[0],
              [chain_rows["K3"][4], batch_chain_rows["main 25"][0],
               batch_chain_rows["main 5 x 4"][0]],
              chain_rows["K3"]),
        entry("K4 clock_moves Gamma-Dirichlet lax.scan -> "
              "gammadir_chain_kernel", "bpp_tpu_torch/csrc/chain_kernel.cu",
              "bpp_tpu/mcmc/clock_moves.py:212", chain_total[1],
              [chain_rows["K4"][4], batch_chain_rows["main 24"][0]],
              chain_rows["K4"]),
        entry("K5 mig_moves.spr_sim_move lax.while_loop -> simwalk_kernel",
              "bpp_tpu_torch/csrc/simwalk_kernel.cu",
              "bpp_tpu/mcmc/mig_moves.py:765", chain_total[2],
              [chain_rows["K5"][4], err26w, err27w,
               batch_chain_rows["main 26"][0],
               batch_chain_rows["main 27"][0],
               batch_chain_rows["main 14 x 4"][0]], chain_rows["K5"]),
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
