"""The matcher facade: :class:`Matcher` binds a :class:`MatcherConfig`
variant and a named warm start, and :meth:`Matcher.run` computes a maximum
matching of a :class:`TorchCSR` graph on the graph's device.

As the JAX package compiles warm start and solve into one program per
size bucket, ``run`` takes one entry of the compile cache (:mod:`.cache`)
per (bucket shape, config, warm start, entry point): a
:class:`~repro_torch.matching.solve.MatcherProgram`.  On a CUDA card its
steps are CUDA graphs captured at the first call (the cold call, as a jit
compile) and replayed after, each loop one conditional WHILE node on the
card; the host reads the device twice a phase.  On the CPU the same steps
run uncaptured.  Every single-device config of the JAX package runs here.

:meth:`Matcher.run_many` solves a stacked batch of one size bucket
(``TorchCSR.stack``) as one ``"run_many"`` entry (:mod:`.batch`): each
level of the whole batch is one launch of a frontier kernel with a lane
dimension, and every lane gets the JAX package's ``run_many`` result for
its graph, bit for bit.
"""
from __future__ import annotations

from typing import Optional

from . import batch
from .cache import compile_cache_fit, compile_cache_key, get_compiled
from .config import MatcherConfig
from .device_csr import TorchCSR
from .device_loop import COUNTERS, SolveCounters
from .solve import MatcherProgram
from .state import MatchState, MatchStats
from .warmstart import get_warm_start, stages, warm_start_version


class Matcher:
    """A paper variant + warm start, one cached program per size bucket.

    >>> m = Matcher(MatcherConfig(algo="apfb"), warm_start="karp_sipser")
    >>> state = m.run(graph)            # init + solve on graph.device
    >>> int(state.cardinality)

    ``last_counts`` holds the solver counts (BFS levels, ``ALTERNATE``
    steps, host syncs) of the last :meth:`run`; the device counts are read
    when it is first accessed, so ``run`` itself does not wait for them.
    """

    def __init__(self, config: MatcherConfig = MatcherConfig(),
                 warm_start: str = "none"):
        self.config = config.canonical()
        self.warm_start = warm_start
        get_warm_start(warm_start)      # fail fast on unknown names
        self._counts = None
        self._last_counts: Optional[dict] = None

    @property
    def last_counts(self) -> Optional[dict]:
        if self._last_counts is None and self._counts is not None:
            self._last_counts = SolveCounters.between(*self._counts)
        return self._last_counts

    @staticmethod
    def _check_state(graph: TorchCSR, state: MatchState) -> None:
        """A state sized for another graph, or on another device, would read
        out of range; refuse it."""
        if state.batch_shape != graph.batch_shape:
            raise ValueError(f"MatchState of batch {state.batch_shape} for a "
                             f"graph of batch {graph.batch_shape}")
        if (state.cmatch.shape[-1] != graph.nc + 1
                or state.rmatch.shape[-1] != graph.nr + 1):
            raise ValueError(
                f"MatchState sized {state.cmatch.shape[-1] - 1} x "
                f"{state.rmatch.shape[-1] - 1} does not fit graph "
                f"({graph.nc}, {graph.nr})")
        if state.cmatch.device != graph.device:
            raise ValueError(f"MatchState on {state.cmatch.device}, graph on "
                             f"{graph.device}")

    def _check_graph(self, graph: TorchCSR) -> None:
        if self.config.dirop and not graph.has_csc:
            raise ValueError(
                "MatcherConfig(dirop=True) needs the CSC mirror; build it "
                "once with graph.with_csc()")

    def _cache_tag(self, cold: bool):
        """Warm-start identity for the compile cache; versioned so that
        re-registering a name invalidates programs built from the old fn."""
        if not cold:
            return "<resume>"
        return (self.warm_start, warm_start_version(self.warm_start))

    def _call(self, graph: TorchCSR, cfg, entry, state: Optional[MatchState],
              shards: Optional[int] = None) -> MatchState:
        """Run the cache entry of ``(graph's bucket, cfg, warm start or
        resume, entry)`` on ``graph`` from ``state`` (``shards``: its solve
        edge-sharded so); then hold the cache to its byte budget, the
        entry just run kept."""
        cold = state is None or entry == "init"
        key = compile_cache_key(graph.bucket_key, cfg, self._cache_tag(cold),
                                entry)
        ws = stages(self.warm_start) if cold else None
        prog = get_compiled(key, lambda: MatcherProgram(
            graph.nc, graph.nr, graph.nnz_pad, cfg, ws, shards))
        out = prog(graph, state)
        compile_cache_fit(keep=key)
        return out

    def init(self, graph: TorchCSR, state: Optional[MatchState] = None
             ) -> MatchState:
        """Warm-start-initialized state (no solve): the ``"init"`` entry."""
        if state is not None:
            self._check_state(graph, state)
        return self._call(graph, None, "init", state)

    def solve(self, graph: TorchCSR, state: MatchState) -> MatchState:
        """Run the solver from ``state`` (no warm start applied): the
        resume entry, as :meth:`run` with a state."""
        self._check_state(graph, state)
        self._check_graph(graph)
        return self._call(graph, self.config, "run", state)

    def run(self, graph: TorchCSR, state: Optional[MatchState] = None
            ) -> MatchState:
        """Maximum matching on the graph's device.

        ``state=None``: warm start, then solve, in one entry.  With an
        explicit ``state`` (e.g. resuming after graph updates) the warm
        start is skipped and the solver continues from it.
        """
        if graph.batch_shape:
            raise ValueError("run() takes a single graph; use run_many for "
                             "a stacked TorchCSR")
        return self._run(graph, state, "run")

    def _run(self, graph: TorchCSR, state: Optional[MatchState], entry,
             shards: Optional[int] = None) -> MatchState:
        """:meth:`run` through the cache entry ``entry``, its counts kept
        for :attr:`last_counts`."""
        if state is not None:
            self._check_state(graph, state)
        self._check_graph(graph)
        before = COUNTERS.snapshot(graph.device)
        out = self._call(graph, self.config, entry, state, shards)
        self._counts = (before, COUNTERS.snapshot(graph.device))
        self._last_counts = None
        return out

    def run_many(self, graphs: TorchCSR,
                 states: Optional[MatchState] = None) -> MatchState:
        """Batched matching over a stacked same-bucket ``TorchCSR``: one
        ``"run_many"`` entry solves the whole batch, each level one kernel
        launch for every lane.  ``states`` (batched, as ``run_many``
        returns them): resume every lane from its state, no warm start.
        ``last_counts`` then counts lane-levels and lane-steps.
        ``adaptive_frontier`` is refused (:class:`~.batch.BatchSolver`)."""
        if len(graphs.batch_shape) != 1:
            raise ValueError("run_many expects a TorchCSR stacked along one "
                             "batch dimension (TorchCSR.stack)")
        cold = states is None
        if not cold:
            self._check_state(graphs, states)
        self._check_graph(graphs)
        key = compile_cache_key(graphs.bucket_key, self.config,
                                self._cache_tag(cold), "run_many")
        ws = batch.stages(self.warm_start) if cold else None
        prog = get_compiled(key, lambda: batch.BatchProgram(
            graphs.nc, graphs.nr, graphs.nnz_pad, graphs.batch_shape[0],
            self.config, ws))
        before = COUNTERS.snapshot(graphs.device)
        out = prog(graphs, states)
        compile_cache_fit(keep=key)
        self._counts = (before, COUNTERS.snapshot(graphs.device))
        self._last_counts = None
        return out

    def stats(self, state: MatchState) -> MatchStats:
        """Device-scalar stats labelled with this matcher's variant name."""
        return MatchStats.of(state, self.config.name)


def match_many(graphs: TorchCSR, config: MatcherConfig = MatcherConfig(),
               warm_start: str = "cheap",
               states: Optional[MatchState] = None) -> MatchState:
    """Functional alias: ``Matcher(config, warm_start).run_many(graphs)``."""
    return Matcher(config, warm_start).run_many(graphs, states)


def maximum_matching_device(graph: TorchCSR,
                            config: MatcherConfig = MatcherConfig(),
                            warm_start: str = "none") -> MatchState:
    """Single-graph device-resident matching (state in, state out)."""
    return Matcher(config, warm_start).run(graph)
