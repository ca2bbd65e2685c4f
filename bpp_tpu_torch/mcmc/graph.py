"""The MCMC step as one captured CUDA graph, replayed once an iteration.

The counterpart of ``bpp_tpu``'s jitted chunk (``bpp_tpu/mcmc/driver.py``
``_chunk``, a ``lax.scan`` over the step, and ``_chunk_multi``, the same
over K chains): where ``bpp_tpu`` hands XLA one program a chunk, the port
captures one iteration of :meth:`driver.Engine._step` (under ``chains =
K`` each chain's, with its own generator) into CUDA graphs
(``torch.cuda.CUDAGraph``) and replays them n times.  A replay issues every kernel of the step, K1
to K5 among them, with one host call.

Under ``chains = K`` on the batched route (``driver.chain_route``) a
:class:`StepGraph` made with ``batched=True`` holds one state, the K
chains stacked on a leading axis, and captures one graph of
:meth:`driver.Engine._step_batched` (``bpp_tpu``'s ``_chunk_multi``: the
step vmapped over the chains, each kernel launched once a call for all K)
with the write-back, all K generators registered on it: one replay, one
host call, steps every chain.

A :class:`StepGraph` owns static buffers: every tensor of the K states
(``McmcState``, flattened), the move statistics ``[K, N_MOVES, 2]`` and
rings of ``CAP`` trace rows (:meth:`Engine._trace_of`, one ring a dtype)
with a cursor on the device.  The captured body runs each chain's step on
views of the buffers and adds its statistics into the accumulator; then
it copies the K chains' new states and trace rows back into the buffers
(one multi-tensor copy a dtype for all K), so that replay k + 1 reads
replay k's result, and writes the row into the ring at the cursor.  Each
chain's step is a graph of its own, the write-back another, all on one
memory pool (one graph of all of it replayed slower, ``PERF.md`` §6).  A
host that changes a state between chunks writes through the views
(``Engine._reset_finetune``) or hands a new state to :meth:`load`.

Capture follows PyTorch's rule: one warm-up iteration on a side stream
(which also builds the kernels' block tables and raises their shared-
memory limit), undone (buffers, generators and launch counts restored),
then the capture.  Each chain's ``torch.Generator`` is registered with the
graph, so a replay advances its Philox offset as the eager step would: n
replays draw what n eager steps draw, and ``get_state()`` after them is
the eager chain's (checkpoints store it).  A failed capture or replay
raises; nothing runs the eager step in its place.  The kernel wrappers
count launches per Python call, which a replay does not make: a graph
counts its captured launches once and :meth:`replay` adds them.

On the CPU nothing is captured: :meth:`replay` runs the same body eagerly,
so the CPU tests hold the buffer handling to the eager chunk.
"""

from __future__ import annotations

import time
import weakref

import torch

from .state import N_MOVES

# trace rows a chunk of replays holds; a longer chunk is taken in pieces
CAP = 500
# one side stream a device for every warm-up and capture: the libraries
# keep a workspace a stream (cuBLAS 32 MiB on an H100), so a new stream a
# graph would hold a new workspace for the life of the process
_STREAMS = {}


def capture_stream(device):
    if device not in _STREAMS:
        _STREAMS[device] = torch.cuda.Stream(device)
    return _STREAMS[device]


def flatten(tree):
    """(structure, leaves) of a NamedTuple tree of tensors; ``None``
    fields are part of the structure."""
    if tree is None:
        return None, []
    if torch.is_tensor(tree):
        return "T", [tree]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        specs, leaves = [], []
        for v in tree:
            s, lv = flatten(v)
            specs.append(s)
            leaves += lv
        return (type(tree), tuple(specs)), leaves
    raise TypeError(f"a state holds {type(tree).__name__}; a captured step "
                    "takes tensors, NamedTuples of them and None")


def unflatten(spec, leaves):
    """The tree of :func:`flatten`'s ``spec`` over the iterator
    ``leaves``."""
    if spec is None:
        return None
    if spec == "T":
        return next(leaves)
    typ, specs = spec
    return typ(*(unflatten(s, leaves) for s in specs))


def stack_states(states):
    """The K states as one: every tensor with a leading chain axis."""
    specs, chains = zip(*(flatten(s) for s in states))
    if any(sp != specs[0] for sp in specs):
        raise ValueError("the chains' states differ in structure")
    return unflatten(specs[0], iter([torch.stack(ts) for ts in
                                     zip(*chains)]))


def chain_views(state, n_chains):
    """Chain k's state, as views of a stacked state (writes go through)."""
    spec, leaves = flatten(state)
    return [unflatten(spec, iter([t[k] for t in leaves]))
            for k in range(n_chains)]


def launch_counts():
    """The kernel wrappers' launch counters (K1, K1 float64, K2, K2
    float64, K3, K4, K5)."""
    from ..core import chains, fels, pack
    return (pack.LAUNCHES, pack.LAUNCHES_F64, fels.LAUNCHES,
            fels.LAUNCHES_F64) + chains.launch_counts()


def set_launch_counts(counts):
    from ..core import chains, fels, pack
    (pack.LAUNCHES, pack.LAUNCHES_F64, fels.LAUNCHES,
     fels.LAUNCHES_F64) = counts[:4]
    chains.set_launch_counts(counts[4:])


class StepGraph:
    """One iteration of ``eng``'s step over the K chains ``states`` (chain
    c drawing from ``gens[c]``), captured on the card at the first
    :meth:`replay`: one CUDA graph a chain and one that writes the K
    chains' states and trace rows back, on one memory pool.  With
    ``batched``, ``states`` is one state of the K chains stacked and the
    step is :meth:`driver.Engine._step_batched`, one graph with its
    write-back."""

    def __init__(self, eng, states, gens, batched=False):
        if len(states) != (1 if batched else len(gens)):
            raise ValueError(f"{len(states)} states, {len(gens)} generators"
                             + (" (batched: one stacked state)" if batched
                                else ""))
        self._eng = weakref.ref(eng)      # the engine keeps its graphs
        self.batched = batched
        self.gens = list(gens)
        self.device = eng.device
        self.graphs = None
        self.per_replay = (0,) * 7       # launch counts a replay adds
        self.capture_s = None
        specs, chains = zip(*(flatten(s) for s in states))
        self.specs = specs
        self.bufs = [[t.detach().clone() for t in lv] for lv in chains]
        self._views = [unflatten(s, iter(b))
                       for s, b in zip(self.specs, self.bufs)]
        self._chain_views = None
        K = len(gens)
        self.acc = torch.zeros((K, N_MOVES, 2), dtype=torch.int64,
                               device=self.device)
        self.cursor = torch.zeros((1,), dtype=torch.int64, device=self.device)
        # the K chains' trace rows: the write-back copies each chain's row
        # into its columns of one row buffer a dtype (with the states, one
        # multi-tensor copy a dtype), then one indexed write a dtype puts
        # the row in the ring at the cursor; _layout holds (chain, key,
        # dtype, first column, size, shape)
        # (batched: the row of the stacked state, [K, ...] a key, whose
        # chain c lies at its columns c size .. (c + 1) size)
        self._layout, width = [], {}
        if batched:
            for k, v in eng._trace_batched(self._views[0]).items():
                col = width.get(v.dtype, 0)
                size = v[0].numel()
                self._layout += [(c, k, v.dtype, col + c * size, size,
                                  tuple(v.shape[1:])) for c in range(K)]
                width[v.dtype] = col + K * size
        else:
            row = eng._trace_of(self._views[0])
            for c in range(K):
                for k, v in row.items():
                    col = width.get(v.dtype, 0)
                    self._layout.append((c, k, v.dtype, col, v.numel(),
                                         tuple(v.shape)))
                    width[v.dtype] = col + v.numel()
        self.row = {dt: torch.zeros((w,), dtype=dt, device=self.device)
                    for dt, w in width.items()}
        self.rings = {dt: torch.zeros((CAP, w), dtype=dt, device=self.device)
                      for dt, w in width.items()}
        if batched:
            # one slot a key: its K chains' columns
            self._row_slots = [[self.row[dt][col:col + K * size]
                                for c, _, dt, col, size, _ in self._layout
                                if c == 0]]
        else:
            self._row_slots = [[self.row[dt][col:col + size]
                                for cc, _, dt, col, size, _ in self._layout
                                if cc == c] for c in range(K)]
        # each chain's new leaves and trace row, held (so that no later
        # capture on the pool reuses them) until the write-back reads them
        self._outs = [None] * len(self.bufs)

    @property
    def eng(self):
        return self._eng()

    # --- the static state ---------------------------------------------------

    def states(self):
        """The K states as views of the buffers (the same objects every
        call); a replay overwrites them."""
        return self._views

    def state(self, c=0):
        return self._views[c]

    def chain_states(self):
        """The K chains' states as views of the buffers: :meth:`states`,
        or with ``batched`` chain k's rows of the stacked state."""
        if not self.batched:
            return self._views
        if self._chain_views is None:
            self._chain_views = chain_views(self._views[0], len(self.gens))
        return self._chain_views

    def load(self, states):
        """Copy the K states into the buffers (an initial state, a resumed
        or restored one, or one the host rebuilt): their structure, shapes
        and dtypes must be the captured ones."""
        if len(states) != len(self.bufs):
            raise ValueError(f"{len(states)} states for {len(self.bufs)} "
                             "chains")
        for c, st in enumerate(states):
            if st is self._views[c]:
                continue
            spec, leaves = flatten(st)
            self._check(c, spec, leaves, "load")
            for b, t in zip(self.bufs[c], leaves):
                if t is not b:
                    b.copy_(t)

    def _check(self, c, spec, leaves, what):
        if spec != self.specs[c]:
            raise ValueError(f"{what}: the state's structure (its None "
                             "fields) differs from the captured one")
        for b, t in zip(self.bufs[c], leaves):
            if t.shape != b.shape or t.dtype != b.dtype:
                raise ValueError(
                    f"{what}: a state tensor of {tuple(t.shape)} {t.dtype} "
                    f"where the buffers hold {tuple(b.shape)} {b.dtype}; a "
                    "captured step keeps every shape and dtype")

    # --- the captured body --------------------------------------------------

    def _chain_body(self, c):
        """One iteration of chain c; its new state's leaves and trace row
        wait in ``_outs[c]`` for :meth:`_write_back`."""
        eng = self.eng
        own = eng.gen
        eng.gen = self.gens[c]
        try:
            new, stats = eng._step(self._views[c])
        finally:
            eng.gen = own
        self.acc[c] += stats
        spec, leaves = flatten(new)
        self._check(c, spec, leaves, "the step")
        self._outs[c] = (leaves, [v.reshape(-1)
                                  for v in eng._trace_of(new).values()])

    def _batched_body(self):
        """One iteration of the K stacked chains; the new state's leaves
        and the trace rows wait in ``_outs[0]`` for :meth:`_write_back`."""
        eng = self.eng
        new, stats = eng._step_batched(self._views[0], self.gens)
        self.acc += stats
        spec, leaves = flatten(new)
        self._check(0, spec, leaves, "the batched step")
        self._outs[0] = (leaves, [v.reshape(-1) for v in
                                  eng._trace_batched(new).values()])

    def _write_back(self):
        """The K chains' new states and trace rows into the buffers, one
        multi-tensor copy a dtype, then the row into the ring at the
        cursor."""
        pairs = []
        for bufs, slots, (leaves, row) in zip(self.bufs, self._row_slots,
                                              self._outs):
            for b, t in zip(bufs, leaves):
                if t is b or (t.data_ptr() == b.data_ptr()
                              and t.stride() == b.stride()):
                    continue
                pairs.append((b, t))
            pairs += list(zip(slots, row))
        # a source that lies in a buffer another copy writes is copied
        # first (the copies of one call run in no set order)
        written = {b.untyped_storage().data_ptr() for b, _ in pairs}
        copies = {}
        for b, t in pairs:
            if t.untyped_storage().data_ptr() in written:
                t = t.clone()
            dst, src = copies.setdefault(b.dtype, ([], []))
            dst.append(b)
            src.append(t)
        for dst, src in copies.values():
            torch._foreach_copy_(dst, src)
        for dt, ring in self.rings.items():
            ring.index_copy_(0, self.cursor, self.row[dt][None])
        self.cursor += 1

    def _body(self):
        if self.batched:
            self._batched_body()
        else:
            for c in range(len(self.gens)):
                self._chain_body(c)
        self._write_back()

    # --- capture and replay -------------------------------------------------

    def capture(self, keep=False):
        """Warm up on a side stream, undo the warm-up, capture (the card
        only).  ``keep``: each graph keeps its ``cudaGraph_t`` beside the
        executable graph (``torch.cuda.CUDAGraph(keep_graph=True)``), so
        that ``raw_cuda_graph()`` can be read (its nodes counted)."""
        dev = self.device
        t0 = time.perf_counter()
        counts = launch_counts()
        saved = [[b.clone() for b in chain] for chain in self.bufs]
        gen_states = [g.get_state() for g in self.gens]
        side = capture_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._body()
        torch.cuda.current_stream(dev).wait_stream(side)
        self._outs = [None] * len(self.bufs)
        for chain, snap in zip(self.bufs, saved):
            for b, s in zip(chain, snap):
                b.copy_(s)
        del saved
        for g, s in zip(self.gens, gen_states):
            g.set_state(s)
        self.acc.zero_()
        self.cursor.zero_()
        if self.batched:
            # one graph: the batched step and its write-back
            parts = [(tuple(self.gens), self._body)]
        else:
            parts = [((g,), lambda c=c: self._chain_body(c))
                     for c, g in enumerate(self.gens)]
            parts.append(((), self._write_back))
        pool = torch.cuda.graph_pool_handle()
        before = launch_counts()
        graphs = []
        try:
            for gens, body in parts:
                graph = (torch.cuda.CUDAGraph(keep_graph=True) if keep
                         else torch.cuda.CUDAGraph())
                for g in gens:
                    graph.register_generator_state(g)
                with torch.cuda.graph(graph, pool=pool, stream=side):
                    body()
                if keep:
                    graph.instantiate()
                graphs.append(graph)
        except Exception as exc:
            raise RuntimeError(
                f"capturing the MCMC step failed: {exc} (the traceback "
                "names the op; a step that reads the device from the host "
                "belongs on the eager route, driver.step_route)") from exc
        self.per_replay = tuple(b - a for a, b in
                                zip(before, launch_counts()))
        set_launch_counts(counts)
        torch.cuda.synchronize(dev)
        self.graphs = graphs
        self.capture_s = time.perf_counter() - t0

    def replay(self):
        """One iteration of every chain: replays of the captured graphs
        (captured on the first call), or on the CPU the body itself."""
        if self.device.type != "cuda":
            self._body()
            return
        if self.graphs is None:
            self.capture()
        for graph in self.graphs:
            graph.replay()
        set_launch_counts(tuple(a + b for a, b in
                                zip(launch_counts(), self.per_replay)))

    def run(self, n, on_replay=None):
        """n replays; returns (move statistics [K, N_MOVES, 2], the K
        chains' traces {key: [n, ...]}), both on the device.
        ``on_replay(i)`` runs after replay i (0-based), eagerly on the
        static state."""
        acc = None
        pieces = []
        for lo in range(0, n, CAP):
            m = min(CAP, n - lo)
            self.acc.zero_()
            self.cursor.zero_()
            for i in range(lo, lo + m):
                self.replay()
                if on_replay is not None:
                    on_replay(i)
            acc = self.acc.clone() if acc is None else acc + self.acc
            pieces.append({dt: r[:m].clone() for dt, r in self.rings.items()})
        rows = {dt: torch.cat([p[dt] for p in pieces]) for dt in self.rings}
        traces = [{} for _ in self.gens]
        for c, k, dt, col, size, shape in self._layout:
            traces[c][k] = rows[dt][:, col:col + size].reshape((n,) + shape)
        return acc, traces
