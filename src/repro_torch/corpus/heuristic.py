"""Deterministic replay of the direction-optimizing push/pull heuristic.

The dirop engine decides push vs pull per BFS level from two O(n) degree
sums (``fe`` = frontier columns' outgoing edges, ``pe`` = unreached rows'
incoming edges — see :func:`repro_torch.matching.solve._dirop_plan`).
Wall-clock benchmarks of that decision vary from host to host, so the
per-family gate instead replays the *exact* level states the solver sweeps
(every sweep path is bit-identical, so the push replay sees the same
``bfs``/``rmatch`` trajectory dirop would) and prices the decisions with a
fixed work model:

* a push level sweeps every padded edge tile and merges:
  ``cost = ntiles * LANE`` (= the padded edge count);
* a pull level pays ``PULL_TILE_OVERHEAD`` lanes per CSC tile (the stream +
  skip decision) and full ``LANE`` cost only for tiles that actually
  contain an unreached row's edge — the tile-skip win of a streaming pull,
  which is large when the remaining rows are clustered (late levels,
  road/comb-like instances) and small when RCP permutation scatters them.

``modelled_rel`` = dirop cost / push-only cost is then a pure function of
(instance, warm start, alpha, beta): deterministic, portable across
machines, and sensitive to exactly the regression class the gate is for —
an always-pull ``alpha``/``beta`` prices early levels (every tile occupied)
at ``~(1 + PULL_TILE_OVERHEAD/LANE)`` of a push sweep.  The JAX package's
committed alpha/beta sweep (``BENCH_PR7.json``, ``corpus.alpha_sweep``) is
what the :class:`~repro_torch.matching.MatcherConfig` dirop defaults cite.

This is the JAX package's ``repro.corpus.heuristic``, number for number.
The replay runs on the device the caller names (the CUDA card by default):
each level's sweep is the default path's fused sweep (on a card the
hand-written kernel, one launch a level; on the CPU its plain version),
folded by the solver's own ``_apply_winner``; ``fe``, ``pe`` and the
touched-tile count are reductions on the device, read back once a level
with the level's verdict; the phases between advance on the device
through the real solver (``max_phases=1``), the graph uploaded once.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.csr import BipartiteCSR
from repro_torch.kernels.frontier_expand import frontier_expand_fused
from repro_torch.matching import Matcher, MatcherConfig, MatchState, TorchCSR
from repro_torch.matching.solve import (L0, _apply_winner, _frontier,
                                        _unreached_rows, level0_state)

# the model's tile geometry: LANE matches the reference kernels' 128-lane
# tiles; PULL_TILE_OVERHEAD is the lanes-equivalent a pull sweep pays per
# tile just to stream it and decide to skip.  Model constants, not
# measurements: they only need to make always-pull measurably worse than
# push on early levels (every tile occupied) and tile-skipping pulls
# measurably better.
LANE = 128
PULL_TILE_OVERHEAD = 16
# kept as the documented ratio for reporting; the cost formulas use the
# tile constants directly
PULL_STREAM_FRACTION = PULL_TILE_OVERHEAD / LANE

# the replayed solver: the default variant (APFB, GPUBFS-WR)
_BASE = MatcherConfig(algo="apfb", kernel="gpubfs_wr")


@dataclasses.dataclass(frozen=True)
class HeuristicTrace:
    """Per-phase, per-level ``(fe, pe, touched_tiles)`` for one instance +
    warm start.  ``fe``/``pe`` are the solver's exact decision inputs;
    ``touched_tiles`` counts CSC edge tiles containing at least one
    unreached row's edge (the pull sweep's non-skippable tiles)."""
    phases: Tuple[Tuple[Tuple[float, float, int], ...], ...]
    nnz_pad: int

    @property
    def ntiles(self) -> int:
        return -(-self.nnz_pad // LANE)

    @property
    def levels(self) -> int:
        return sum(len(p) for p in self.phases)


@dataclasses.dataclass(frozen=True)
class _Replay:
    """What every level of one instance reads: the graph, the column and
    row degrees (int64, so the sums are exact), and the row-sorted mirror's
    rows padded with the sentinel row to whole ``LANE`` tiles."""
    graph: TorchCSR
    cdeg: torch.Tensor
    rdeg: torch.Tensor
    erow: torch.Tensor

    @classmethod
    def of(cls, graph: TorchCSR) -> "_Replay":
        mirror = graph.with_csc()
        ntiles = -(-graph.nnz_pad // LANE)
        erow = F.pad(mirror.erow, (0, ntiles * LANE - graph.nnz_pad),
                     value=graph.nr)
        return cls(graph=graph,
                   cdeg=(graph.cxadj[1:] - graph.cxadj[:-1]).long(),
                   rdeg=(mirror.rxadj[1:] - mirror.rxadj[:-1]).long(),
                   erow=erow.long())


def _replay_phase(rp: _Replay, state: MatchState
                  ) -> List[Tuple[float, float, int]]:
    """Run one phase's BFS levels from ``state``, recording (fe, pe) before
    each expansion — the exact sums ``_dirop_plan`` computes — plus the
    pull sweep's touched-tile count for the work model."""
    g = rp.graph
    bfs, root = level0_state(state.cmatch)
    pred = torch.full_like(state.rmatch, g.nc)
    rmatch = state.rmatch.clone()
    no_row = torch.zeros(1, dtype=torch.bool, device=g.device)
    out: List[Tuple[float, float, int]] = []
    level = L0
    while True:
        isf = _frontier(bfs, root, level, wr=True)
        fe = torch.where(isf, rp.cdeg, 0).sum()
        unreached = _unreached_rows(bfs, rmatch)
        pe = torch.where(unreached, rp.rdeg, 0).sum()
        # a tile is touched when one of its LANE slots holds an unreached
        # row's edge (the sentinel row, nr, is never unreached)
        hit = torch.cat([unreached, no_row])[rp.erow]
        touched = hit.view(-1, LANE).any(1).sum()
        winner = frontier_expand_fused(g.ecol, g.cadj, bfs, root, rmatch,
                                       level)
        bfs, root, pred, rmatch, ins, _ = _apply_winner(
            winner, bfs, root, pred, rmatch, level, wr=True, wr_exact=False,
            inplace=True)
        fe, pe, touched, ins = torch.stack(
            [fe, pe, touched, ins.long()]).tolist()
        out.append((float(fe), float(pe), int(touched)))
        if not ins:
            return out
        level += 1


def trace_instance(g: BipartiteCSR, warm_start: str = "cheap",
                   max_phases: int = 128, device=None) -> HeuristicTrace:
    """Replay every BFS phase of the default solver on ``g`` and collect the
    per-level (fe, pe) direction inputs, on ``device`` (the CUDA card by
    default).

    Phase starting states advance through the *real* solver
    (``max_phases=1`` per step, ``degrade_maximal`` off, so no greedy
    round changes the trajectory), so the trace is exactly the level
    sequence any sweep path executes on this instance — the decisions
    priced by :func:`modelled_rel` are the ones dirop would take online.
    """
    graph = TorchCSR.from_host(g, device=device)
    rp = _Replay.of(graph)
    state = Matcher(warm_start=warm_start).init(graph)
    step = Matcher(dataclasses.replace(_BASE, max_phases=1))
    phases = []
    card = int(state.cardinality)
    for _ in range(max_phases):
        phases.append(tuple(_replay_phase(rp, state)))
        state = step.run(graph, state)
        gained = int(state.cardinality) - card
        card += gained
        if gained <= 0:
            break
    return HeuristicTrace(phases=tuple(phases), nnz_pad=g.nnz_pad)


def modelled_rel(trace: HeuristicTrace, alpha: float, beta: float
                 ) -> Tuple[float, int]:
    """(dirop cost / push-only cost, pull-level count) under the work model.

    Applies the solver's exact decision rule — ``pull = fe*alpha > pe`` or,
    while already pulling, ``fe*beta > pe`` (``dir_prev`` resets each phase,
    as in the solver's phase loop) — to the traced (fe, pe) sequence, then
    prices each level with the tile work model (module docstring).
    """
    ntiles = trace.ntiles
    push_level = float(ntiles * LANE)
    push_total = dirop_total = 0.0
    pulls = 0
    for phase in trace.phases:
        prev = False
        for fe, pe, touched in phase:
            pull = (fe * alpha > pe) or (prev and fe * beta > pe)
            dirop_total += ((ntiles * PULL_TILE_OVERHEAD + touched * LANE)
                            if pull else push_level)
            push_total += push_level
            pulls += int(pull)
            prev = pull
    return dirop_total / max(push_total, 1.0), pulls


def sweep_grid() -> Sequence[Tuple[float, float]]:
    """The committed (alpha, beta) sweep: never-pull and always-pull anchors
    around a log-spaced band (beta = 4*alpha keeps the hysteresis shape)."""
    return ((1e-6, 1e-6), (1.0, 4.0), (2.0, 8.0), (4.0, 16.0), (8.0, 32.0),
            (16.0, 64.0), (1e6, 1e6))
