"""Eager PyTorch solver for the paper's GPU matching algorithms (APFB / APsB).

The same algorithm, step for step, as the JAX package's ``solve.py``, so
both return the same matching bit for bit:

* a BFS level is one sweep producing a per-row winner vector (the lowest
  proposing column: the paper's "first writer wins" race made
  deterministic), folded into the BFS state by :func:`_apply_winner`.  The
  sweeps, all giving the same winners:

  - push, the dense O(nnz) edge sweep: the fused kernel, or (``use_pallas``
    with ``pallas_fused=False``, the legacy path) the per-edge proposal
    kernel merged by :func:`scatter_min`;
  - ``adaptive_frontier``: a compact column gather (O(cap·dmax), torch
    ops) on levels whose frontier fits the geometry;
  - ``dirop``: per level, a Beamer-style estimate picks push or pull; the
    pull is a compact row gather over the CSC mirror (torch ops, when the
    unreached rows fit) or, with ``use_pallas``, the pull kernel.

  On a CUDA graph every kernel sweep is a hand-written kernel; on a CPU
  graph it is the kernel's plain PyTorch version (:mod:`repro_torch.
  kernels.frontier_expand`);
* ``ALTERNATE`` (Alg. 3) walks all augmenting paths in lock-step;
* ``FIXMATCHING`` repairs both directions, so every phase ends valid;
* a cardinality guard re-runs ``ALTERNATE`` with a single walker if the
  speculative phase gained nothing.

Where the JAX solver is one compiled ``lax.while_loop`` program, this one
is Python loops over device tensors: each loop test reads one device value
(a host sync), the BFS level is a Python int the loop owns, and a
``lax.cond`` becomes a Python ``if`` on a synced value (a level's
adaptive or direction decision is read in the same sync as the previous
level's flags, so it costs one sync per phase, not per level).
:data:`COUNTERS` counts the BFS levels (and which sweep each ran), the
``ALTERNATE`` steps and the host syncs.

Indexing rules.  Every gather is ``index_select`` and every scatter
``scatter``/``scatter_reduce``, with int64 indices and int32 values; a
scatter whose entries do not all take part goes through
:func:`scatter_kept`, which sends those entries to no shared slot.
Unlike JAX, which clamps or drops an out-of-range index, these raise on
the CPU (and fault on the card), so the clamps of the reference are all
kept and the CPU tests show that no index leaves its range.

State layout (all int32, one sentinel slot at the end of every array):
``bfs`` (nc+1,) BFS level per column (L0-1 == 1 unvisited, L0 == 2 roots,
sentinel NEG); ``root`` (nc+1,) root column of the BFS tree (GPUBFS-WR);
``pred`` (nr+1,) predecessor column of a row; ``cmatch`` (nc+1,) /
``rmatch`` (nr+1,) the matching, -1 unmatched, rmatch == -2 an
augmenting-path endpoint.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.frontier_expand import (frontier_expand,
                                                 frontier_expand_fused,
                                                 frontier_expand_pull)

from .config import MatcherConfig
from .device_csr import LANE

L0 = 2                       # paper's suggested start level (keeps bfs positive)
UNVISITED = 1                # L0 - 1
FOUND = 0                    # L0 - 2 : root's augmenting path already found (WR)
NEG = -(2**30)               # sentinel level: never active, never unvisited
IINF = 2**30                 # scatter-min identity
I32 = torch.int32


@dataclasses.dataclass
class SolveCounters:
    """Plain counts of the eager solver's work, beside the kernels'
    launch counts: BFS levels, split by the sweep each ran (``push_levels``
    the dense edge sweep, ``pull_levels`` a pull over the CSC mirror,
    ``compact_levels`` the adaptive column gather), ``ALTERNATE`` steps,
    and host syncs (each read of a device value that the host loop waits
    for)."""

    levels: int = 0
    push_levels: int = 0
    pull_levels: int = 0
    compact_levels: int = 0
    alternate_steps: int = 0
    host_syncs: int = 0

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


COUNTERS = SolveCounters()


def _sync(*flags: torch.Tensor) -> list:
    """Read device bools/ints in ONE host sync (counted)."""
    COUNTERS.host_syncs += 1
    if len(flags) == 1:
        return [flags[0].item()]
    return torch.stack([f.to(I32) for f in flags]).tolist()


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=like.device)


# the identity of each int32 reduction: an entry that carries it changes no
# slot
_IDENTITY = {"amin": 2**31 - 1, "amax": -2**31, "sum": 0}


def scatter_kept(out: torch.Tensor, index: torch.Tensor, values, keep,
                 reduce: str | None = None) -> torch.Tensor:
    """``out`` with ``values`` (a tensor like ``index``, or a scalar)
    scattered into it at ``index`` for the entries where ``keep`` holds:
    reduced by ``reduce`` ("amin", "amax" or "sum", ``include_self``), or
    written when ``reduce`` is None.  ``out`` itself is not changed.

    The entries that do not take part share no slot.  The reference sends
    them all to one sentinel slot, which on the card is one address taking
    every one of their writes or atomics, one after another.  Here, in a
    reduction, entry ``i`` carries the reduction's identity to slot ``i mod
    len(out)``, which it leaves as it was; in a plain write, to a slot of
    its own past the end of a longer buffer, which is then dropped.  Either
    way the kept entries give what the sentinel form gives, with no host
    sync and no compaction.
    """
    n1, m = out.shape[0], index.shape[0]
    spread = torch.arange(m, device=out.device)
    index = index.long()
    if reduce is None:
        buf = torch.cat([out, out.new_empty(m)])
        spread.add_(n1)
        buf.scatter_(0, torch.where(keep, index, spread, out=spread), values)
        return buf[:n1]
    if not isinstance(values, torch.Tensor):
        # a fill, not torch.tensor(values): a host-to-card copy waits for
        # the stream
        values = torch.full((m,), values, dtype=out.dtype, device=out.device)
    if m > n1:
        spread.remainder_(n1)
    return out.scatter_reduce(
        0, torch.where(keep, index, spread, out=spread),
        torch.where(keep, values, _IDENTITY[reduce]), reduce,
        include_self=True)


def scatter_min(n: int, index: torch.Tensor, values: torch.Tensor
                ) -> torch.Tensor:
    """Deterministic "first writer wins": per-slot min over proposals.

    ``index`` may use slot ``n`` as the discard sentinel and ``values`` IINF
    for "no proposal"; neither kind of entry touches a slot
    (:func:`scatter_kept`), so the sentinel slot stays the identity and
    never reads back as a winner.
    """
    out = torch.full((n + 1,), IINF, dtype=I32, device=values.device)
    return scatter_kept(out, index, values, (index < n) & (values < IINF),
                        "amin")


def _seal(t: torch.Tensor, value) -> torch.Tensor:
    """Set the trailing sentinel slot of ``t`` to ``value``, in place.  A
    ``fill_`` that takes the number as its argument: item assignment
    (``t[n] = value``) copies the number from the host and so waits for the
    card."""
    t[-1:].fill_(value)
    return t


def level0_state(cmatch: torch.Tensor):
    """BFS state at the paper's start level for a given matching: ``bfs``
    (unmatched columns are L0 roots, matched UNVISITED, sentinel NEG) and
    ``root`` (own index if root, else ``nc``)."""
    nc = cmatch.shape[0] - 1
    matched = cmatch >= 0
    bfs = _seal(torch.full_like(cmatch, L0).masked_fill_(matched, UNVISITED),
                NEG)
    root = torch.where(matched, nc, _arange(nc + 1, cmatch))
    return bfs, root


def default_block_edges(nnz_pad: int, schedule: str) -> int:
    """The JAX package's edge-tile size for the TPU kernel (CT 4096, MT 512,
    clamped to the padded edge count, floor 128).  Kept so configs mirror;
    the CUDA kernel's launch shape does not depend on it, and neither do
    the winners."""
    desired = 4096 if schedule == "ct" else 512
    return min(desired, -(-nnz_pad // LANE) * LANE)


# ---------------------------------------------------------------------------
# BFS level expansion — the paper's Algorithms 2 (GPUBFS) and 4 (GPUBFS-WR)
# ---------------------------------------------------------------------------
def _winner_full(ecol, cadj, bfs, root, rmatch, level: int, *,
                 use_pallas: bool = False, pallas_fused: bool = True
                 ) -> torch.Tensor:
    """Dense O(nnz) push sweep -> per-row winner vector (nr+1,).

    The legacy path (``use_pallas`` and not ``pallas_fused``) is the
    per-edge proposal kernel, merged here by :func:`scatter_min` as the
    reference merges it outside its kernel; every other config is the fused
    kernel (the reference's jnp and fused branches give the same winners).
    A kernel on a CUDA graph, its plain version on a CPU graph.
    """
    if use_pallas and not pallas_fused:
        nr = rmatch.shape[0] - 1
        prop = frontier_expand(ecol, cadj, bfs, root, rmatch, level)
        return scatter_min(nr, cadj, prop)
    return frontier_expand_fused(ecol, cadj, bfs, root, rmatch, level)


def _nonzero_fixed(mask: torch.Tensor, cap: int, fill: int) -> torch.Tensor:
    """``jnp.nonzero(mask, size=cap, fill_value=fill)[0]`` with no host
    sync: the ascending indices of ``mask``, padded with ``fill`` to
    ``cap`` (Trues past the first ``cap`` are dropped, as there).  Each
    True lands at its rank (a cumsum); the rest touch no slot."""
    n = mask.shape[0]
    rank = torch.cumsum(mask, 0, dtype=torch.int64) - 1
    out = torch.full((cap,), fill, dtype=I32, device=mask.device)
    return scatter_kept(out, rank, _arange(n, mask), mask & (rank < cap))


def _unreached_rows(bfs, rmatch) -> torch.Tensor:
    """The (nr,) mask of rows still reachable this phase, the row side of
    the proposal predicate: unmatched-and-not-yet-endpoint rows, or rows
    whose matched column is still UNVISITED.  Winners are IINF everywhere
    else, which is what makes a pull restricted to these rows exact."""
    nc = bfs.shape[0] - 1
    rm = rmatch[:-1]
    return (rm == -1) | ((rm >= 0) & (
        bfs.index_select(0, rm.clamp(0, nc).long()) == UNVISITED))


def _gather_adjacency(xadj, adj, ids, n: int, dmax: int):
    """The compact gathers' shared step: for the (cap,) vertex ids (``n``
    = padding) the (cap, dmax) adjacency slots via the offsets ``xadj``,
    and which of them are real edges."""
    nnz_pad = adj.shape[0]
    starts = xadj.index_select(0, ids.clamp(max=n).long())
    ends = xadj.index_select(0, (ids + 1).clamp(max=n).long())  # fill: deg 0
    offs = _arange(dmax, ids)
    eidx = starts[:, None] + offs[None, :]                      # (cap, dmax)
    valid = offs[None, :] < (ends - starts)[:, None]
    nbr = adj.index_select(0, eidx.clamp(0, nnz_pad - 1).reshape(-1).long())
    return nbr.reshape(eidx.shape), valid


def _winner_pull_compact(rxadj, radj, bfs, root, rmatch, level: int,
                         unreached, *, cap: int, dmax: int) -> torch.Tensor:
    """Compact pull sweep: gather the unreached rows' adjacency via the CSC
    mirror, O(cap·dmax) torch ops instead of O(nnz).

    Only called when every unreached row fits (at most ``cap`` rows, each
    of degree at most ``dmax``); then each row's min over its proposing
    columns is exactly the dense sweep's winner.
    """
    nc = bfs.shape[0] - 1
    nr = rmatch.shape[0] - 1
    # the column side of the proposal predicate, for every column at once
    colok = bfs == level                                         # (nc+1,)
    if root is not None:
        colok &= bfs.index_select(0, root.clamp(0, nc).long()) >= UNVISITED
    rows = _nonzero_fixed(unreached, cap, nr)                    # (cap,)
    nbr, valid = _gather_adjacency(rxadj, radj, rows, nr, dmax)
    cols = torch.where(valid, nbr, nc)
    # colok[nc] is False (bfs NEG)
    ok = valid & colok.index_select(0, cols.reshape(-1).long()).reshape(
        cols.shape)
    win_rows = torch.where(ok, cols, IINF).amin(dim=1)           # (cap,)
    return scatter_min(nr, rows.clamp(max=nr), win_rows)


def _winner_pull_stream(radj, erow, bfs, root, rmatch, level: int, *,
                        use_pallas: bool) -> torch.Tensor:
    """Streaming pull sweep over the whole CSC edge list.

    With ``use_pallas`` it is the pull kernel.  Otherwise it is the dense
    sweep on the permuted arrays, the fused kernel over ``radj``/``erow``,
    which gives the reference's jnp form's winners (the reference takes
    that form only on its sharded path; a single device pulls compactly).
    """
    if use_pallas:
        return frontier_expand_pull(radj, erow, bfs, root, rmatch, level)
    return frontier_expand_fused(radj, erow, bfs, root, rmatch, level)


def _winner_compact(cxadj, cadj, bfs, rmatch, isf, *, cap: int,
                    dmax: int) -> torch.Tensor:
    """Compact column-gather sweep: O(cap·dmax) torch ops instead of
    O(nnz).

    ``isf`` is the (nc,) frontier mask (WR test already applied).  Only
    called when the frontier fits (at most ``cap`` columns, each of degree
    at most ``dmax``); then every proposal of the dense sweep is present
    and the min-merge winner is bit-identical.
    """
    nc = bfs.shape[0] - 1
    nr = rmatch.shape[0] - 1
    cols = _nonzero_fixed(isf, cap, nc)                          # (cap,)
    nbr, valid = _gather_adjacency(cxadj, cadj, cols, nc, dmax)
    rows = torch.where(valid, nbr, nr)
    cm = rmatch.index_select(0, rows.reshape(-1).long()).reshape(rows.shape)
    col_unvis = bfs.index_select(
        0, cm.clamp(0, nc).reshape(-1).long()).reshape(cm.shape) == UNVISITED
    target = valid & (((cm >= 0) & col_unvis) | (cm == -1))
    prop = torch.where(target, cols[:, None], IINF)
    rows_ix = torch.where(target, rows, nr)
    return scatter_min(nr, rows_ix.reshape(-1), prop.reshape(-1))


def _frontier(bfs, root, level: int, wr: bool) -> torch.Tensor:
    """The (nc,) frontier mask: columns at ``level`` (WR: whose root is
    not yet satisfied)."""
    nc = bfs.shape[0] - 1
    isf = bfs[:-1] == level
    if wr:
        isf &= bfs.index_select(0, root[:-1].clamp(0, nc).long()) >= UNVISITED
    return isf


def _apply_winner(winner, bfs, root, pred, rmatch, level: int, *, wr: bool,
                  wr_exact: bool):
    """Fold a per-row winner vector into the BFS state (the paper's Alg. 2
    lines 8-17 / Alg. 4 lines 11-18).

    Returns ``(bfs, root, pred, rmatch, vertex_inserted, aug_found)``, the
    last two as 0-d device bools.  The reference's ``.at[i].set`` becomes
    :func:`scatter_kept`, whose order on duplicate indices is unspecified;
    it cannot matter here: the visited rows' matched columns are distinct
    (``rmatch`` is a valid matching during a phase), and the other rows
    touch no slot.  The reference's other rows write the sentinel slots,
    ``root[nc]`` with 0, which is sealed here to the same value.
    """
    nc = bfs.shape[0] - 1
    nr = pred.shape[0] - 1
    upd_r = winner < IINF                                 # (nr+1,) rows reached

    pred = torch.where(upd_r, winner, pred)
    cm_r = rmatch                                         # row-wise matched col
    visit_r = upd_r & (cm_r >= 0)                         # Alg.2 l.8-12
    end_r = upd_r & (cm_r == -1)                          # Alg.2 l.14-17

    bfs = scatter_kept(bfs, cm_r, level + 1, visit_r)
    if wr:
        rootvals = root.index_select(0, winner.clamp(0, nc).long())
        root = _seal(scatter_kept(root, cm_r, rootvals, visit_r), 0)
        # mark the root "satisfied": plain WR writes L0-2, the exact variant
        # encodes the endpoint row as -(r+1) so ALTERNATE can start only the
        # winning endpoint of each tree (paper Sec. 3, last paragraph).
        if wr_exact:
            enc = -(_arange(nr + 1, winner) + 1)
        else:
            enc = torch.full((nr + 1,), FOUND, dtype=I32,
                             device=winner.device)
        bfs = scatter_kept(bfs, rootvals, enc, end_r, "amin")
    rmatch = torch.where(end_r, -2, rmatch)
    _seal(bfs, NEG)                                       # restore sentinel

    return bfs, root, pred, rmatch, visit_r.any(), end_r.any()


def _compact_plan(cxadj, bfs, root, level: int, *, wr: bool, cap: int,
                  dmax: int):
    """A level's adaptive decision, not yet read: (``eligible``, a 0-d
    device bool: the frontier fits ``cap`` columns of degree at most
    ``dmax``; the frontier mask the compact gather takes)."""
    isf = _frontier(bfs, root, level, wr)
    deg = cxadj[1:] - cxadj[:-1]
    eligible = (isf.sum() <= cap) & (torch.where(isf, deg, 0).amax() <= dmax)
    return eligible, isf


def _dirop_plan(cxadj, rxadj, bfs, root, rmatch, level: int, dir_prev: bool,
                *, wr: bool, use_pallas: bool, dirop_alpha: float,
                dirop_beta: float, pull_cap: int, pull_dmax: int):
    """A level's direction, not yet read: (``use_pull``, a 0-d device
    bool; the unreached-row mask the compact pull takes).

    The frontier columns' outgoing edges ``fe`` against the unreached
    rows' incoming edges ``pe``, int sums compared in float32 as the
    reference compares them: pull when ``fe * dirop_alpha > pe``, or, if
    the previous level pulled (``dir_prev``, the hysteresis), while
    ``fe * dirop_beta > pe``.  Without ``use_pallas`` the pull is the
    compact row gather, so every unreached row must also fit its
    (cap, dmax) geometry.
    """
    isf = _frontier(bfs, root, level, wr)
    cdeg = cxadj[1:] - cxadj[:-1]
    fe = torch.where(isf, cdeg, 0).sum().to(torch.float32)
    unreached = _unreached_rows(bfs, rmatch)
    rdeg = rxadj[1:] - rxadj[:-1]
    pe = torch.where(unreached, rdeg, 0).sum().to(torch.float32)
    pull = fe * dirop_alpha > pe
    if dir_prev:
        pull |= fe * dirop_beta > pe
    if not use_pallas:
        pull &= ((unreached.sum() <= pull_cap)
                 & (torch.where(unreached, rdeg, 0).amax() <= pull_dmax))
    return pull, unreached


def _expand_level(ecol, cadj, bfs, root, pred, rmatch, level: int, *,
                  wr: bool, wr_exact: bool, use_pallas: bool = False,
                  pallas_fused: bool = True, cxadj=None,
                  adaptive: bool = False, compact_cap: int = 0,
                  compact_dmax: int = 0, plan=None):
    """One level-synchronous frontier expansion. Returns updated state.

    ``adaptive`` (needs ``cxadj``) runs the compact column gather when the
    frontier fits; the geometry must be resolved through ``MatcherConfig``
    (0 = unresolved is an error, not a default).  ``plan`` is the level's
    decision already read, ``(eligible, frontier mask)``; without it this
    computes it (:func:`_compact_plan`) and reads it in one host sync.
    """
    rt = root if wr else None
    if adaptive and plan is None:
        assert cxadj is not None, "adaptive_frontier needs the cxadj offsets"
        assert compact_cap > 0 and compact_dmax > 0, \
            "resolve the compact geometry via MatcherConfig.resolve_cap/" \
            "resolve_dmax (0 means unresolved, not a default)"
        eligible, isf = _compact_plan(cxadj, bfs, root, level, wr=wr,
                                      cap=compact_cap, dmax=compact_dmax)
        plan = (bool(_sync(eligible)[0]), isf)
    if plan is not None and plan[0]:
        COUNTERS.compact_levels += 1
        winner = _winner_compact(cxadj, cadj, bfs, rmatch, plan[1],
                                 cap=compact_cap, dmax=compact_dmax)
    else:
        COUNTERS.push_levels += 1
        winner = _winner_full(ecol, cadj, bfs, rt, rmatch, level,
                              use_pallas=use_pallas,
                              pallas_fused=pallas_fused)
    return _apply_winner(winner, bfs, root, pred, rmatch, level, wr=wr,
                         wr_exact=wr_exact)


def _expand_level_dirop(ecol, cadj, cxadj, rxadj, radj, erow, bfs, root,
                        pred, rmatch, level: int, dir_prev: bool, *,
                        wr: bool, wr_exact: bool, use_pallas: bool,
                        pallas_fused: bool, dirop_alpha: float,
                        dirop_beta: float, pull_cap: int, pull_dmax: int,
                        plan=None):
    """Direction-optimizing frontier expansion (Beamer-style): the push
    sweep, or a pull over the CSC mirror, as :func:`_dirop_plan` decides.
    The pull is the compact row gather, or with ``use_pallas`` the pull
    kernel, which streams the mirror and needs no geometry.  Either branch
    gives the dense sweep's winners.

    ``plan`` is the level's decision already read, ``(use_pull, unreached
    mask)``; without it this computes it and reads it in one host sync.
    Returns the updated state plus this level's direction (a Python bool).
    """
    rt = root if wr else None
    if plan is None:
        pull, unreached = _dirop_plan(
            cxadj, rxadj, bfs, root, rmatch, level, dir_prev, wr=wr,
            use_pallas=use_pallas, dirop_alpha=dirop_alpha,
            dirop_beta=dirop_beta, pull_cap=pull_cap, pull_dmax=pull_dmax)
        plan = (bool(_sync(pull)[0]), unreached)
    use_pull, unreached = plan
    if use_pull:
        COUNTERS.pull_levels += 1
        if use_pallas:
            winner = _winner_pull_stream(radj, erow, bfs, rt, rmatch, level,
                                         use_pallas=True)
        else:
            winner = _winner_pull_compact(rxadj, radj, bfs, rt, rmatch,
                                          level, unreached, cap=pull_cap,
                                          dmax=pull_dmax)
    else:
        COUNTERS.push_levels += 1
        winner = _winner_full(ecol, cadj, bfs, rt, rmatch, level,
                              use_pallas=use_pallas,
                              pallas_fused=pallas_fused)
    return _apply_winner(winner, bfs, root, pred, rmatch, level, wr=wr,
                         wr_exact=wr_exact) + (use_pull,)


# ---------------------------------------------------------------------------
# ALTERNATE (Alg. 3) + FIXMATCHING
# ---------------------------------------------------------------------------
def _alternate(cmatch, rmatch, pred, start_mask, max_steps: int):
    """Lock-step speculative alternation of all augmenting paths.

    ``start_mask`` selects the endpoint rows that launch walkers.  Writes of
    concurrent walkers are merged with min-scatters; the paper's line-8
    predecessor check breaks walkers that would chase another path.  One
    ``pred`` gather per step, carried to the next.  The reference skips the
    two scatters on a step where every walker broke; here they always run,
    which gives the same matching and the same step count.  Returns
    ``(cmatch, rmatch, steps)`` with ``steps`` a Python int.
    """
    nc = cmatch.shape[0] - 1
    nr = rmatch.shape[0] - 1
    rows = _arange(nr + 1, rmatch)
    cur = torch.where(start_mask, rows, -1)
    pmc = pred.index_select(0, cur.clamp(0, nr).long())   # pred[cur], hoisted
    steps = 0
    while steps < max_steps and _sync((cur >= 0).any())[0]:
        active = cur >= 0
        curc = cur.clamp(0, nr)
        mc = pmc                                          # matched_col = pred[cur]
        mcc = mc.clamp(0, nc)
        mr = cmatch.index_select(0, mcc.long())           # matched_row (snapshot)
        pmr = pred.index_select(0, mr.clamp(0, nr).long())  # the step's gather
        # paper line 8: if predecessor[matched_row] == matched_col: break
        brk = active & (mr >= 0) & (pmr == mc)
        act = active & ~brk
        # cmatch[mc] <- cur ; rmatch[cur] <- mc  (speculative, min-merged)
        cprop = scatter_min(nc, torch.where(act, mcc, nc),
                            torch.where(act, cur, IINF))
        cmatch = torch.where(cprop < IINF, cprop, cmatch)
        rprop = scatter_min(nr, torch.where(act, curc, nr),
                            torch.where(act, mc, IINF))
        rmatch = torch.where(rprop < IINF, rprop, rmatch)
        cur = torch.where(act, mr, -1)
        pmc = pmr
        steps += 1
    COUNTERS.alternate_steps += steps
    return cmatch, rmatch, steps


def _fix_matching(cmatch, rmatch):
    """Paper's FIXMATCHING, both directions -> a valid matching."""
    nc = cmatch.shape[0] - 1
    nr = rmatch.shape[0] - 1
    rows = _arange(nr + 1, rmatch)
    cols = _arange(nc + 1, cmatch)
    rmatch = torch.where(rmatch == -2, -1, rmatch)
    ok_r = (rmatch >= 0) & (
        cmatch.index_select(0, rmatch.clamp(0, nc).long()) == rows)
    rmatch = torch.where((rmatch >= 0) & ~ok_r, -1, rmatch)
    ok_c = (cmatch >= 0) & (
        rmatch.index_select(0, cmatch.clamp(0, nr).long()) == cols)
    cmatch = torch.where((cmatch >= 0) & ~ok_c, -1, cmatch)
    return cmatch, rmatch


def _cardinality(cmatch) -> torch.Tensor:
    return (cmatch[:-1] >= 0).sum(dtype=I32)


# ---------------------------------------------------------------------------
# Drivers — Algorithm 1 (APsB) and its APFB variant
# ---------------------------------------------------------------------------
def make_solver(cfg: MatcherConfig):
    """Build the matcher ``(ecol, cadj, cmatch, rmatch[, cxadj, rxadj,
    radj, erow]) -> (cmatch, rmatch, phases, fallbacks, certified)``; the
    last three are Python values.

    ``certified`` is True iff the final phase's BFS proved no augmenting
    path remains (the matching is maximum, Berge).  A run cut short by a
    positive ``cfg.max_phases`` budget returns ``certified=False``; with
    ``cfg.degrade_maximal`` the matching is then made maximal by one greedy
    augmentation round.

    ``cfg.adaptive_frontier`` also needs the ``cxadj`` offsets;
    ``cfg.dirop`` needs ``cxadj`` and the CSC mirror (``rxadj``/``radj``/
    ``erow`` of ``TorchCSR.with_csc``).  ``Matcher.solve`` passes them.
    """
    wr = cfg.kernel == "gpubfs_wr"

    def match_fn(ecol, cadj, cmatch, rmatch, cxadj=None, rxadj=None,
                 radj=None, erow=None):
        if cfg.adaptive_frontier and cxadj is None:
            raise ValueError(
                "adaptive_frontier needs the cxadj column offsets; call the "
                "solver with cxadj= (Matcher.solve passes graph.cxadj)")
        if cfg.dirop and (cxadj is None or rxadj is None or radj is None
                          or erow is None):
            raise ValueError(
                "dirop needs cxadj plus the CSC mirror (rxadj/radj/erow); "
                "build it with TorchCSR.with_csc() (Matcher.solve passes it "
                "through when present)")
        nc = cmatch.shape[0] - 1
        nr = rmatch.shape[0] - 1
        # compact/pull geometry: the one auto rule lives on MatcherConfig
        compact_cap = cfg.resolve_cap(cfg.compact_cap, nc)
        compact_dmax = cfg.resolve_dmax(cfg.compact_dmax)
        pull_cap = cfg.resolve_cap(cfg.pull_cap, nr)
        pull_dmax = cfg.resolve_dmax(cfg.pull_dmax)
        sweep = dict(wr=wr, wr_exact=cfg.wr_exact, use_pallas=cfg.use_pallas,
                     pallas_fused=cfg.pallas_fused)
        dirop_kw = dict(dirop_alpha=cfg.dirop_alpha,
                        dirop_beta=cfg.dirop_beta, pull_cap=pull_cap,
                        pull_dmax=pull_dmax)

        def plan_of(bfs, root, rmatch, level, dir_prev):
            """A level's branch decision, unread (None: push only)."""
            if cfg.dirop:
                return _dirop_plan(cxadj, rxadj, bfs, root, rmatch, level,
                                   dir_prev, wr=wr, use_pallas=cfg.use_pallas,
                                   **dirop_kw)
            if cfg.adaptive_frontier:
                return _compact_plan(cxadj, bfs, root, level, wr=wr,
                                     cap=compact_cap, dmax=compact_dmax)
            return None

        def phase_bfs(cmatch, rmatch):
            """Inner loop of Alg. 1: level-synchronous BFS to exhaustion or
            first hit."""
            bfs, root = level0_state(cmatch)
            pred = torch.full((nr + 1,), nc, dtype=I32, device=cmatch.device)
            level, ins, aug, aug_lvl, dir_prev = L0, True, False, IINF, False
            plan = None       # the first level reads its own decision

            def go():
                if cfg.algo == "apsb":
                    return ins and not aug               # Alg.1 l.9-10 break
                if cfg.tail_levels > 0:
                    # bounded tail: at most tail_levels past the first
                    # augmenting level (beyond-paper, see MatcherConfig)
                    return ins and level <= aug_lvl + cfg.tail_levels
                return ins

            while go():
                if cfg.dirop:
                    (bfs, root, pred, rmatch, ins_t, aug_t,
                     dir_prev) = _expand_level_dirop(
                        ecol, cadj, cxadj, rxadj, radj, erow, bfs, root,
                        pred, rmatch, level, dir_prev, plan=plan,
                        **dirop_kw, **sweep)
                else:
                    bfs, root, pred, rmatch, ins_t, aug_t = _expand_level(
                        ecol, cadj, bfs, root, pred, rmatch, level,
                        cxadj=cxadj, adaptive=cfg.adaptive_frontier,
                        compact_cap=compact_cap, compact_dmax=compact_dmax,
                        plan=plan, **sweep)
                # the next level's decision rides on this level's read
                nxt = plan_of(bfs, root, rmatch, level + 1, dir_prev)
                if nxt is None:
                    ins, aug_l = (bool(v) for v in _sync(ins_t, aug_t))
                else:
                    ins, aug_l, go_next = (
                        bool(v) for v in _sync(ins_t, aug_t, nxt[0]))
                    plan = (go_next, nxt[1])
                COUNTERS.levels += 1
                if aug_l and aug_lvl == IINF:
                    aug_lvl = level
                level += 1
                aug = aug or aug_l
            return bfs, root, pred, rmatch, aug

        def start_mask_fn(bfs, rmatch):
            mask = rmatch == -2
            if cfg.wr_exact:
                # only the winning endpoint of each satisfied tree starts a walker
                enc = bfs[:-1]                                   # (nc,)
                wins = _seal(scatter_kept(
                    torch.zeros(nr + 1, dtype=torch.bool, device=bfs.device),
                    -(enc + 1), True, enc <= -1), False)
                mask = mask & wins
            return mask

        max_steps = 2 * (min(nc, nr) + 2)
        limit = cfg.max_phases if cfg.max_phases > 0 else nc + 2
        phases, fallbacks, aug = 0, 0, True
        while aug and phases < limit:
            cm0, rm0 = cmatch, rmatch                            # phase snapshot
            bfs, root, pred, rmatch_b, aug = phase_bfs(cmatch, rmatch)
            if aug:
                mask = start_mask_fn(bfs, rmatch_b)
                cm1, rm1, _ = _alternate(cm0, torch.where(mask, -2, rm0),
                                         pred, mask, max_steps)
                cm1, rm1 = _fix_matching(cm1, rm1)
                if not _sync(_cardinality(cm1) > _cardinality(cm0))[0]:
                    # guard: the speculative phase gained nothing -> augment
                    # exactly one shortest path on the snapshot (a single
                    # walker cannot conflict).  argmax over an int mask is
                    # the first True: the lowest endpoint row.
                    any_ep = rmatch_b == -2
                    first = torch.argmax(any_ep.to(I32)).reshape(1)
                    one = torch.zeros(nr + 1, dtype=torch.bool,
                                      device=cm0.device)
                    one = one.scatter(0, first, any_ep.any().reshape(1))
                    cm2, rm2, _ = _alternate(cm0, rm0, pred, one, max_steps)
                    cm1, rm1 = _fix_matching(cm2, rm2)
                    fallbacks += 1
                cmatch, rmatch = cm1, rm1
            else:
                cmatch, rmatch = cm0, rm0
            phases += 1
        # aug is the last BFS verdict: False means the phase found no
        # augmenting path — Berge certifies the matching maximum.  A
        # budget-truncated exit leaves aug True: valid but uncertified.
        certified = not aug
        if cfg.degrade_maximal and cfg.max_phases > 0 and not certified:
            # one speculative greedy round restores maximality (local
            # import: warmstart.py imports solver internals from here)
            from .warmstart import cheap_init
            cmatch, rmatch = cheap_init(ecol, cadj, cmatch, rmatch)
        return cmatch, rmatch, phases, fallbacks, certified

    return match_fn
