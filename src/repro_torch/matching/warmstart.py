"""Pluggable warm-start registry: matching initializers on device tensors.

Every entry is a function ``(ecol, cadj, cmatch, rmatch) -> (cmatch,
rmatch)`` over sentinel-padded int32 tensors, run on the graph's device
before the solve, with no round trip through the host beyond the one sync
per round that ends its loop (counted in ``solve.COUNTERS``).

Built-ins: ``"none"`` (cold), ``"cheap"`` (the paper's greedy warm start),
``"karp_sipser"`` (beyond-paper degree-1 peeling + greedy residual).
Register custom initializers with :func:`register_warm_start`.  Each
computes what the JAX package's initializer of the same name computes, bit
for bit.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from .solve import I32, IINF, _arange, _fix_matching, _sync, scatter_min

InitFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
                  Tuple[torch.Tensor, torch.Tensor]]


def none_init(ecol, cadj, cmatch, rmatch):
    """Cold start: pass the incoming (all-unmatched) state through."""
    del ecol, cadj
    return cmatch, rmatch


def cheap_init(ecol, cadj, cmatch, rmatch):
    """Parallel cheap matching (the paper's common warm start).

    Speculative round-based greedy (propose -> resolve -> commit): each round
    every unmatched column proposes its lowest-index unmatched neighbor row;
    each proposed row accepts its lowest proposing column; accepted pairs
    commit.  Rounds repeat until no proposal survives -> a maximal greedy
    matching.  The commit scatter writes distinct columns (a column proposes
    to one row, so it wins at most one), plus the sentinel slot ``nc`` with
    one common value, so its order on duplicates cannot matter.
    """
    nc = cmatch.shape[0] - 1
    nr = rmatch.shape[0] - 1
    ecol_l, cadj_l = ecol.long(), cadj.long()       # once per graph
    cols = _arange(nc + 1, cmatch)
    rows = _arange(nr + 1, rmatch)
    while True:
        col_free = cmatch.index_select(0, ecol_l) == -1
        row_free = rmatch.index_select(0, cadj_l) == -1
        cand = torch.where(col_free & row_free, cadj, IINF)
        best_r = scatter_min(nc, ecol_l, cand)
        propose = best_r < IINF
        best_c = scatter_min(nr, torch.where(propose, best_r, nr),
                             torch.where(propose, cols, IINF))
        won = best_c < IINF                                  # per-row accept
        rmatch = torch.where(won, best_c, rmatch)
        cmatch = cmatch.scatter(0, torch.where(won, best_c, nc).long(),
                                torch.where(won, rows, cmatch[nc]))
        cmatch[nc] = -3
        if not _sync(won.any())[0]:
            return cmatch, rmatch


def karp_sipser_init(ecol, cadj, cmatch, rmatch):
    """Karp–Sipser peeling, data-parallel (beyond the paper's cheap init).

    While the residual graph has a degree-1 vertex, matching its only edge is
    optimal; each round peels *all* current degree-1 vertices speculatively
    with min-scatter conflict resolution, then the parallel cheap matching
    finishes the residual and a repair pass clears asymmetric remnants.
    """
    nc = cmatch.shape[0] - 1
    nr = rmatch.shape[0] - 1
    ecol_l, cadj_l = ecol.long(), cadj.long()       # once per graph
    cols = _arange(nc + 1, cmatch)
    rows = _arange(nr + 1, rmatch)
    ones = torch.ones(ecol.shape[0], dtype=I32, device=ecol.device)
    while True:
        alive = ((cmatch.index_select(0, ecol_l) == -1)
                 & (rmatch.index_select(0, cadj_l) == -1))
        cdeg = torch.zeros(nc + 1, dtype=I32, device=ecol.device).index_add_(
            0, torch.where(alive, ecol, nc).long(), ones)
        rdeg = torch.zeros(nr + 1, dtype=I32, device=ecol.device).index_add_(
            0, torch.where(alive, cadj, nr).long(), ones)
        # forced edges: endpoint with residual degree 1
        forced = alive & ((cdeg.index_select(0, ecol_l) == 1)
                          | (rdeg.index_select(0, cadj_l) == 1))

        # speculative commit of all forced edges, min-scatter per column/row
        prop_r = scatter_min(nc, torch.where(forced, ecol, nc),
                             torch.where(forced, cadj, IINF))
        col_has = prop_r < IINF
        # rows accept lowest proposing column among columns that picked them
        prop_c = scatter_min(nr, torch.where(col_has, prop_r, nr),
                             torch.where(col_has, cols, IINF))
        won_r = prop_c < IINF                       # row r matched to prop_c[r]
        rmatch = torch.where(won_r & (rmatch == -1), prop_c, rmatch)
        # commit winning columns (repair: only pairs where row accepted col)
        won_pair = won_r & (rmatch == prop_c)
        cmatch = cmatch.scatter_reduce(
            0, torch.where(won_pair, prop_c.clamp(0, nc), nc).long(),
            torch.where(won_pair, rows, -1), "amax", include_self=True)
        cmatch[nc] = -3
        rmatch[nr] = -3
        if not _sync(forced.any())[0]:
            break
    cmatch, rmatch = cheap_init(ecol, cadj, cmatch, rmatch)
    # clear asymmetric remnants of the speculative commits (same symmetric
    # repair the solver uses; the -2 endpoint clear is a no-op here)
    return _fix_matching(cmatch, rmatch)


WARM_STARTS: dict = {
    "none": none_init,
    "cheap": cheap_init,
    "karp_sipser": karp_sipser_init,
}
_VERSIONS: dict = {name: 0 for name in WARM_STARTS}


def register_warm_start(name: str, fn: InitFn) -> None:
    """Add a custom initializer to the registry.

    Re-registering a name bumps its version (kept for parity with the JAX
    package, where the version is part of the compile-cache key).
    """
    if not callable(fn):
        raise TypeError(f"warm start {name!r} must be callable")
    WARM_STARTS[name] = fn
    _VERSIONS[name] = _VERSIONS.get(name, -1) + 1


def warm_start_version(name: str) -> int:
    """Monotonic per-name counter."""
    return _VERSIONS.get(name, 0)


def warm_start_names() -> tuple:
    return tuple(WARM_STARTS)


def get_warm_start(name: str) -> InitFn:
    try:
        return WARM_STARTS[name]
    except KeyError:
        raise KeyError(
            f"unknown warm start {name!r}; registered: {warm_start_names()}"
        ) from None
