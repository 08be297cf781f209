"""The matcher facade: :class:`Matcher` binds a :class:`MatcherConfig`
variant and a named warm start, and :meth:`Matcher.run` computes a maximum
matching of a :class:`TorchCSR` graph on the graph's device.

There is no compile step: the solver runs eagerly, its loops on the host
and its array work on the device.  Batched ``run_many`` comes in a later
slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import solve
from .config import MatcherConfig
from .device_csr import TorchCSR
from .solve import check_ported, make_solver
from .state import MatchState, MatchStats, empty_like_graph
from .warmstart import get_warm_start


class Matcher:
    """A paper variant + warm start.

    >>> m = Matcher(MatcherConfig(algo="apfb"), warm_start="karp_sipser")
    >>> state = m.run(graph)            # init + solve on graph.device
    >>> int(state.cardinality)

    ``last_counts`` holds the solver counts (BFS levels, ``ALTERNATE``
    steps, host syncs) of the last :meth:`run`.
    """

    def __init__(self, config: MatcherConfig = MatcherConfig(),
                 warm_start: str = "none"):
        self.config = config.canonical()
        check_ported(self.config)       # fail fast on unported sweep paths
        self.warm_start = warm_start
        get_warm_start(warm_start)      # fail fast on unknown names
        self.last_counts: Optional[dict] = None

    @staticmethod
    def _check_state(graph: TorchCSR, state: MatchState) -> None:
        """A state sized for another graph, or on another device, would read
        out of range; refuse it."""
        if (state.cmatch.shape[-1] != graph.nc + 1
                or state.rmatch.shape[-1] != graph.nr + 1):
            raise ValueError(
                f"MatchState sized {state.cmatch.shape[-1] - 1} x "
                f"{state.rmatch.shape[-1] - 1} does not fit graph "
                f"({graph.nc}, {graph.nr})")
        if state.cmatch.device != graph.device:
            raise ValueError(f"MatchState on {state.cmatch.device}, graph on "
                             f"{graph.device}")

    def init(self, graph: TorchCSR, state: Optional[MatchState] = None
             ) -> MatchState:
        """Warm-start-initialized state (no solve)."""
        if state is None:
            state = empty_like_graph(graph)
        self._check_state(graph, state)
        cm, rm = get_warm_start(self.warm_start)(
            graph.ecol, graph.cadj, state.cmatch, state.rmatch)
        return dataclasses.replace(state, cmatch=cm, rmatch=rm)

    def solve(self, graph: TorchCSR, state: MatchState) -> MatchState:
        """Run the solver from ``state`` (no warm start applied)."""
        self._check_state(graph, state)
        cm, rm, phases, fb, cert = make_solver(self.config)(
            graph.ecol, graph.cadj, state.cmatch, state.rmatch)
        return MatchState(cmatch=cm, rmatch=rm,
                          phases=state.phases + phases,
                          fallbacks=state.fallbacks + fb,
                          certified=torch.full((), cert, dtype=torch.bool,
                                               device=cm.device))

    def run(self, graph: TorchCSR, state: Optional[MatchState] = None
            ) -> MatchState:
        """Maximum matching on the graph's device.

        ``state=None``: warm start, then solve.  With an explicit ``state``
        (e.g. resuming after graph updates) the warm start is skipped and
        the solver continues from it.
        """
        before = solve.COUNTERS.as_dict()
        if state is None:
            state = self.init(graph)
        out = self.solve(graph, state)
        after = solve.COUNTERS.as_dict()
        self.last_counts = {k: after[k] - before[k] for k in after}
        return out

    def stats(self, state: MatchState) -> MatchStats:
        """Device-scalar stats labelled with this matcher's variant name."""
        return MatchStats.of(state, self.config.name)


def maximum_matching_device(graph: TorchCSR,
                            config: MatcherConfig = MatcherConfig(),
                            warm_start: str = "none") -> MatchState:
    """Single-graph device-resident matching (state in, state out)."""
    return Matcher(config, warm_start).run(graph)
