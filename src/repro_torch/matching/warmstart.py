"""Pluggable warm-start registry: matching initializers on device tensors.

Every entry is a function ``(ecol, cadj, cmatch, rmatch) -> (cmatch,
rmatch)`` over sentinel-padded int32 tensors, run on the graph's device
before the solve.

Built-ins: ``"none"`` (cold), ``"cheap"`` (the paper's greedy warm start),
``"karp_sipser"`` (beyond-paper degree-1 peeling + greedy residual).  Each
computes what the JAX package's initializer of the same name computes, bit
for bit.  Their rounds are device loops (:func:`stages`): a round is a step
on the compile-cache entry's buffers, run while ``ws_live`` is set, a
conditional WHILE node on a card, as the solver's loops, with no host
read.  Called directly, the functions below run the same steps
uncaptured.

Register custom initializers with :func:`register_warm_start`.  As the
JAX package traces a registered warm start into its program, a card
captures it into a CUDA graph, whole: it must run on the device alone, and
one that reads a device value on the host raises at its capture.  It may
call the built-ins: inside the entry's capture their loops become WHILE
nodes of the captured graph, on buffers of their own that the entry keeps
(:meth:`~repro_torch.matching.device_loop.Program.sub`).
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from .device_loop import Buffers, Loop, Once, Program, current_program
from .solve import (I32, IINF, _fix_matching, _seal, scatter_kept,
                    scatter_min)

InitFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
                  Tuple[torch.Tensor, torch.Tensor]]


def _cheap_round(B: Buffers) -> None:
    """One round of the parallel cheap matching.

    Speculative round-based greedy (propose -> resolve -> commit): every
    unmatched column proposes its lowest-index unmatched neighbor row;
    each proposed row accepts its lowest proposing column; accepted pairs
    commit.  ``ws_live`` stays set while a proposal survives.  The commit
    scatter writes distinct columns (a column proposes to one row, so it
    wins at most one), so its order on duplicates cannot matter.
    """
    cmatch, rmatch = B.cmatch, B.rmatch
    nc, nr = cmatch.shape[0] - 1, rmatch.shape[0] - 1
    col_free = cmatch.index_select(0, B.ecol_l) == -1
    row_free = rmatch.index_select(0, B.cadj_l) == -1
    cand = torch.where(col_free & row_free, B.cadj, IINF)
    best_r = scatter_min(nc, B.ecol_l, cand)
    propose = best_r < IINF
    best_c = scatter_min(nr, torch.where(propose, best_r, nr),
                         torch.where(propose, B.cols, IINF))
    won = best_c < IINF                                  # per-row accept
    # an accepted column is free (-1): its row is the max
    _seal(scatter_kept(cmatch, best_c, B.rows, won, "amax", inplace=True),
          -3)
    torch.where(won, best_c, rmatch, out=rmatch)
    B.ws_live.copy_(won.any())


def _karp_sipser_round(B: Buffers) -> None:
    """One round of Karp–Sipser peeling: every current degree-1 vertex is peeled speculatively, with min-scatter
    conflict resolution.  ``ws_live`` stays set while a forced edge
    exists."""
    cmatch, rmatch = B.cmatch, B.rmatch
    nc, nr = cmatch.shape[0] - 1, rmatch.shape[0] - 1
    ecol_l, cadj_l = B.ecol_l, B.cadj_l
    alive = ((cmatch.index_select(0, ecol_l) == -1)
             & (rmatch.index_select(0, cadj_l) == -1))
    cdeg = scatter_kept(torch.zeros(nc + 1, dtype=I32, device=alive.device),
                        ecol_l, 1, alive, "sum")
    rdeg = scatter_kept(torch.zeros(nr + 1, dtype=I32, device=alive.device),
                        cadj_l, 1, alive, "sum")
    # forced edges: endpoint with residual degree 1
    forced = alive & ((cdeg.index_select(0, ecol_l) == 1)
                             | (rdeg.index_select(0, cadj_l) == 1))

    # speculative commit of all forced edges, min-scatter per column/row
    prop_r = scatter_min(nc, torch.where(forced, B.ecol, nc),
                         torch.where(forced, B.cadj, IINF))
    col_has = prop_r < IINF
    # rows accept lowest proposing column among columns that picked them
    prop_c = scatter_min(nr, torch.where(col_has, prop_r, nr),
                         torch.where(col_has, B.cols, IINF))
    won_r = prop_c < IINF                       # row r matched to prop_c[r]
    _seal(torch.where(won_r & (rmatch == -1), prop_c, rmatch, out=rmatch),
          -3)
    # commit winning columns (repair: only pairs where row accepted col)
    won_pair = won_r & (rmatch == prop_c)
    _seal(scatter_kept(cmatch, prop_c.clamp(0, nc), B.rows, won_pair, "amax",
                       inplace=True), -3)
    B.ws_live.copy_(forced.any())


def _fix(B: Buffers) -> None:
    """Clear asymmetric remnants of the speculative commits (the solver's
    symmetric repair; its -2 endpoint clear is a no-op here)."""
    cm, rm = _fix_matching(B.cmatch, B.rmatch)
    B.cmatch.copy_(cm)
    B.rmatch.copy_(rm)


# the built-ins as device stages
CHEAP = (Loop("cheap", _cheap_round, "ws_live"),)
KARP_SIPSER = (Loop("karp_sipser", _karp_sipser_round, "ws_live"), *CHEAP,
               Once("karp_sipser_fix", _fix))


def _stage_program(device, nc: int, nr: int, m: int,
                   capture: bool) -> Program:
    """A program of the buffers the built-ins' stages use."""
    P = Program(device, capture=capture)
    for name, n in (("ecol", m), ("cadj", m), ("cmatch", nc + 1),
                    ("rmatch", nr + 1)):
        P.alloc(name, n)
    P.alloc("ecol_l", m, torch.int64)
    P.alloc("cadj_l", m, torch.int64)
    P.constant("rows", torch.arange(nr + 1, dtype=I32, device=device))
    P.constant("cols", torch.arange(nc + 1, dtype=I32, device=device))
    P.scalars(("ws_live",))
    return P


def _run(stages, name: str, ecol, cadj, cmatch, rmatch):
    """``stages`` on the given tensors; returns (cmatch, rmatch) and leaves
    the inputs as they were.  Inside a step of a program on a card (a
    registered warm start calling a built-in one) the stages run on
    buffers the program keeps, their loops WHILE nodes of its graphs;
    elsewhere uncaptured."""
    nc, nr, m = cmatch.shape[0] - 1, rmatch.shape[0] - 1, ecol.shape[0]
    outer = current_program()
    if outer is not None and outer.capture:
        P = outer.sub(("warm start", name, nc, nr, m),
                      lambda: _stage_program(cmatch.device, nc, nr, m, True))
    else:
        P = _stage_program(cmatch.device, nc, nr, m, False)
    B = P.buf
    for t, src in ((B.ecol, ecol), (B.cadj, cadj), (B.cmatch, cmatch),
                   (B.rmatch, rmatch), (B.ecol_l, ecol), (B.cadj_l, cadj)):
        t.copy_(src)
    P.run_stages(stages)
    return B.cmatch.clone(), B.rmatch.clone()


def none_init(ecol, cadj, cmatch, rmatch):
    """Cold start: pass the incoming (all-unmatched) state through."""
    del ecol, cadj
    return cmatch, rmatch


def cheap_init(ecol, cadj, cmatch, rmatch):
    """Parallel cheap matching (the paper's common warm start): rounds of
    :func:`_cheap_round` until no proposal survives -> a maximal greedy
    matching."""
    return _run(CHEAP, "cheap", ecol, cadj, cmatch, rmatch)


def karp_sipser_init(ecol, cadj, cmatch, rmatch):
    """Karp–Sipser peeling, data-parallel (beyond the paper's cheap init).

    While the residual graph has a degree-1 vertex, matching its only edge is
    optimal; each round peels *all* current degree-1 vertices speculatively
    with min-scatter conflict resolution, then the parallel cheap matching
    finishes the residual and a repair pass clears asymmetric remnants.
    """
    return _run(KARP_SIPSER, "karp_sipser", ecol, cadj, cmatch, rmatch)


WARM_STARTS: dict = {
    "none": none_init,
    "cheap": cheap_init,
    "karp_sipser": karp_sipser_init,
}
_VERSIONS: dict = {name: 0 for name in WARM_STARTS}
_STAGES = {none_init: (), cheap_init: CHEAP, karp_sipser_init: KARP_SIPSER}


def register_warm_start(name: str, fn: InitFn) -> None:
    """Add a custom initializer to the registry.

    Re-registering a name bumps its version, which is part of the
    compile-cache key: an entry built from the old function is not reused.
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


def stages(name: str) -> tuple:
    """The device stages of the warm start registered as ``name``: the
    built-ins' loops, or a registered function as one step (which may run
    the built-ins' loops)."""
    fn = get_warm_start(name)
    if fn in _STAGES:
        return _STAGES[fn]

    def run(B: Buffers) -> None:
        cm, rm = fn(B.ecol, B.cadj, B.cmatch, B.rmatch)
        B.cmatch.copy_(cm)
        B.rmatch.copy_(rm)

    return (Once(f"warm start {name!r}", run, loops=True),)
