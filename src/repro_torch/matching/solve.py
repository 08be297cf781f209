"""PyTorch solver for the paper's GPU matching algorithms (APFB / APsB).

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
    unreached rows fit) or, with ``use_pallas``, the pull kernel;
  - edge-sharded (``ShardedMatcher``, ``Solver(..., shards=D)``): the
    path's sweep once per shard over that shard's slice of the edge list,
    into a winner vector of its own, then :func:`_merge_shards`, the min
    of the D vectors, where the reference's one ``lax.pmin`` a level
    stands.  ``dirop`` pulls there by the streamed pull over each shard's
    slice of the CSC mirror, never by the compact one, as the reference
    does under a mesh axis.

  On a CUDA graph every kernel sweep is a hand-written kernel; on a CPU
  graph it is the kernel's plain PyTorch version (:mod:`repro_torch.
  kernels.frontier_expand`);
* ``ALTERNATE`` (Alg. 3) walks all augmenting paths in lock-step;
* ``FIXMATCHING`` repairs both directions, so every phase ends valid;
* a cardinality guard re-runs ``ALTERNATE`` with a single walker if the
  speculative phase gained nothing.

Where the JAX solver is one compiled program of ``lax.while_loop``s, this
one is device steps over the static buffers of a
:class:`~repro_torch.matching.device_loop.Program` (:class:`Solver`): the
BFS level and the ``ALTERNATE`` step are loop steps that run while their
``live`` flags are set, each loop one CUDA conditional WHILE node on a
card, and the phase bookkeeping is one-shot steps between them.  On the two paths
whose ``lax.cond`` picks between torch-op sweeps (``adaptive_frontier``,
and ``dirop`` without ``use_pallas``) each branch's level is a graph of its
own under an IF node on the device's decision, so only the taken branch
runs.  The host reads the device twice a phase: the BFS verdict ``aug``,
and the cardinality guard.  :class:`MatcherProgram` is one compile-cache
entry: warm start and solve for one size bucket.

Indexing rules.  Every gather is ``index_select`` (``gather`` along the
last dimension for a batch: :func:`_take`) and every scatter
``scatter``/``scatter_reduce``, with int64 indices and int32 values; a
scatter whose entries do not all take part goes through
:func:`scatter_kept`, which sends those entries to no shared slot.  The
helpers shared with the batched solve (:mod:`.batch`) take ``(n,)``
arrays or ``(B, n)`` lanes alike.
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
import types
from typing import Optional, Sequence

import torch

from repro_torch.distributed.comm import all_reduce_min_
from repro_torch.kernels.frontier_expand import (frontier_expand,
                                                 frontier_expand_fused,
                                                 frontier_expand_pull)

from .config import MatcherConfig
from .device_csr import LANE
from .device_loop import (ALT, COMPACT, COUNTERS, LEVELS, MERGES, PULL,
                          PUSH, Branch, Buffers, Loop, Once, Program,
                          SolveCounters)
from .state import SENTINEL, MatchState

__all__ = ["COUNTERS", "SolveCounters", "MatcherProgram", "Solver",
           "make_solver", "scatter_kept", "scatter_min"]

L0 = 2                       # paper's suggested start level (keeps bfs positive)
UNVISITED = 1                # L0 - 1
FOUND = 0                    # L0 - 2 : root's augmenting path already found (WR)
NEG = -(2**30)               # sentinel level: never active, never unvisited
IINF = 2**30                 # scatter-min identity
I32 = torch.int32


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=like.device)


def _same(t: torch.Tensor, like: torch.Tensor) -> Optional[torch.Tensor]:
    """``t`` as the ``out=`` of a result shaped as ``like``, where the
    shapes agree (one graph); None (a new tensor) for a batch."""
    return t if t.shape == like.shape else None


# the identity of each int32 reduction: an entry that carries it changes no
# slot
_IDENTITY = {"amin": 2**31 - 1, "amax": -2**31, "sum": 0}


def scatter_kept(out: torch.Tensor, index: torch.Tensor, values, keep,
                 reduce: str | None = None,
                 inplace: bool = False) -> torch.Tensor:
    """``out`` with ``values`` (a tensor that broadcasts to ``index``, a 0-d
    tensor or a scalar) scattered into it at ``index`` for the entries where
    ``keep`` holds: reduced by ``reduce`` ("amin", "amax" or "sum",
    ``include_self``), or written when ``reduce`` is None.  ``out`` itself
    is not changed, unless ``inplace`` (a reduction only) writes into it.
    Along the last dimension: a batch ``(B, n)`` scatters lane by lane.

    The entries that do not take part share no slot.  The reference sends
    them all to one sentinel slot, which on the card is one address taking
    every one of their writes or atomics, one after another.  Here, in a
    reduction, entry ``i`` carries the reduction's identity to slot ``i mod
    len(out)``, which it leaves as it was; in a plain write, to a slot of
    its own past the end of a longer buffer, which is then dropped.  Either
    way the kept entries give what the sentinel form gives, with no host
    sync and no compaction.
    """
    n1, m = out.shape[-1], index.shape[-1]
    spread = torch.arange(m, device=out.device)
    index = index.long()
    if isinstance(values, torch.Tensor):
        values = values.to(out.dtype).expand(index.shape)
    if reduce is None:
        assert not inplace, "an in-place scatter_kept must reduce"
        buf = torch.cat([out, out.new_empty(index.shape)], dim=-1)
        spread.add_(n1)
        buf.scatter_(-1, torch.where(keep, index, spread, out=_same(spread,
                                                                   index)),
                     values)
        return buf[..., :n1]
    if not isinstance(values, torch.Tensor):
        # a fill, not torch.tensor(values): a host-to-card copy waits for
        # the stream
        values = torch.full(index.shape, values, dtype=out.dtype,
                            device=out.device)
    if m > n1:
        spread.remainder_(n1)
    scatter = out.scatter_reduce_ if inplace else out.scatter_reduce
    return scatter(-1, torch.where(keep, index, spread,
                                   out=_same(spread, index)),
                   torch.where(keep, values, _IDENTITY[reduce]), reduce,
                   include_self=True)


def scatter_min(n: int, index: torch.Tensor, values: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Deterministic "first writer wins": per-slot min over proposals.

    ``index`` may use slot ``n`` as the discard sentinel and ``values`` IINF
    for "no proposal"; neither kind of entry touches a slot
    (:func:`scatter_kept`), so the sentinel slot stays the identity and
    never reads back as a winner.  ``out``: the ``(n+1,)`` vector to fill,
    in place.
    """
    keep = (index < n) & (values < IINF)
    if out is not None:
        return scatter_kept(out.fill_(IINF), index, values, keep, "amin",
                            inplace=True)
    out = torch.full((*index.shape[:-1], n + 1), IINF, dtype=I32,
                     device=values.device)
    return scatter_kept(out, index, values, keep, "amin")


def _seal(t: torch.Tensor, value) -> torch.Tensor:
    """Set the trailing sentinel slot of ``t`` to ``value``, in place.  A
    ``fill_`` that takes the number as its argument: item assignment
    (``t[n] = value``) copies the number from the host and so waits for the
    card."""
    t[..., -1:].fill_(value)
    return t


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` lane by lane: ``x`` ``(*lanes, n)``, ``idx``
    ``(*lanes, *shape)`` of any integer type -> ``(*lanes, *shape)``."""
    flat = idx.reshape(*x.shape[:-1], -1).long()
    out = (x.index_select(0, flat) if x.dim() == 1
           else torch.gather(x, -1, flat))
    return out.reshape(idx.shape)


def _col(v):
    """A per-lane value, ``(*lanes,)``, as a column that broadcasts along
    the last dimension; one graph's (a number or a 0-d tensor) as it is."""
    return v[..., None] if isinstance(v, torch.Tensor) and v.dim() else v


def level0_state(cmatch: torch.Tensor):
    """BFS state at the paper's start level for a given matching: ``bfs``
    (unmatched columns are L0 roots, matched UNVISITED, sentinel NEG) and
    ``root`` (own index if root, else ``nc``)."""
    nc = cmatch.shape[-1] - 1
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
# ``level`` is a Python int or a 0-d int32 device tensor throughout.
# ---------------------------------------------------------------------------
def _out(out: Optional[torch.Tensor]) -> dict:
    """A sweep's ``out=`` where there is one: an unsharded solve calls the
    sweeps with their arguments alone, as a caller wrapping them sees."""
    return {} if out is None else {"out": out}


def _winner_full(ecol, cadj, bfs, root, rmatch, level, *,
                 use_pallas: bool = False, pallas_fused: bool = True,
                 gate: Optional[torch.Tensor] = None,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense O(nnz) push sweep -> per-row winner vector (nr+1,).

    The legacy path (``use_pallas`` and not ``pallas_fused``) is the
    per-edge proposal kernel, merged here by :func:`scatter_min` as the
    reference merges it outside its kernel; every other config is the fused
    kernel (the reference's jnp and fused branches give the same winners).
    A kernel on a CUDA graph, its plain version on a CPU graph.  ``gate``
    (a 0-d int32 tensor) off: no winner.  ``out``: the vector to fill.
    """
    if use_pallas and not pallas_fused:
        nr = rmatch.shape[-1] - 1
        prop = frontier_expand(ecol, cadj, bfs, root, rmatch, level, gate)
        return scatter_min(nr, cadj, prop, out)
    return frontier_expand_fused(ecol, cadj, bfs, root, rmatch, level, gate,
                                 **_out(out))


def _nonzero_fixed(mask: torch.Tensor, cap: int, fill: int) -> torch.Tensor:
    """``jnp.nonzero(mask, size=cap, fill_value=fill)[0]`` with no host
    sync: the ascending indices of ``mask``, padded with ``fill`` to
    ``cap`` (Trues past the first ``cap`` are dropped, as there).  Each
    True lands at its rank (a cumsum); the rest touch no slot."""
    n = mask.shape[-1]
    rank = torch.cumsum(mask, -1, dtype=torch.int64) - 1
    out = torch.full((*mask.shape[:-1], cap), fill, dtype=I32,
                     device=mask.device)
    return scatter_kept(out, rank, _arange(n, mask), mask & (rank < cap))


def _unreached_rows(bfs, rmatch) -> torch.Tensor:
    """The (nr,) mask of rows still reachable this phase, the row side of
    the proposal predicate: unmatched-and-not-yet-endpoint rows, or rows
    whose matched column is still UNVISITED.  Winners are IINF everywhere
    else, which is what makes a pull restricted to these rows exact."""
    nc = bfs.shape[-1] - 1
    rm = rmatch[..., :-1]
    return (rm == -1) | ((rm >= 0) & (
        _take(bfs, rm.clamp(0, nc)) == UNVISITED))


def _gather_adjacency(xadj, adj, ids, n: int, dmax: int):
    """The compact gathers' shared step: for the (cap,) vertex ids (``n``
    = padding) the (cap, dmax) adjacency slots via the offsets ``xadj``,
    and which of them are real edges."""
    nnz_pad = adj.shape[-1]
    starts = _take(xadj, ids.clamp(max=n))
    ends = _take(xadj, (ids + 1).clamp(max=n))                  # fill: deg 0
    offs = _arange(dmax, ids)
    eidx = starts[..., None] + offs                             # (cap, dmax)
    valid = offs < (ends - starts)[..., None]
    return _take(adj, eidx.clamp(0, nnz_pad - 1)), valid


def _winner_pull_compact(rxadj, radj, bfs, root, rmatch, level,
                         unreached, *, cap: int, dmax: int) -> torch.Tensor:
    """Compact pull sweep: gather the unreached rows' adjacency via the CSC
    mirror, O(cap·dmax) torch ops instead of O(nnz).

    Only called when every unreached row fits (at most ``cap`` rows, each
    of degree at most ``dmax``); then each row's min over its proposing
    columns is exactly the dense sweep's winner.
    """
    nc = bfs.shape[-1] - 1
    nr = rmatch.shape[-1] - 1
    # the column side of the proposal predicate, for every column at once
    colok = bfs == _col(level)                                   # (nc+1,)
    if root is not None:
        colok &= _take(bfs, root.clamp(0, nc)) >= UNVISITED
    rows = _nonzero_fixed(unreached, cap, nr)                    # (cap,)
    nbr, valid = _gather_adjacency(rxadj, radj, rows, nr, dmax)
    cols = torch.where(valid, nbr, nc)
    # colok[nc] is False (bfs NEG)
    ok = valid & _take(colok, cols)
    win_rows = torch.where(ok, cols, IINF).amin(dim=-1)          # (cap,)
    return scatter_min(nr, rows.clamp(max=nr), win_rows)


def _winner_pull_stream(radj, erow, bfs, root, rmatch, level, *,
                        use_pallas: bool,
                        gate: Optional[torch.Tensor] = None,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Streaming pull sweep over the CSC edge list (or a shard's slice of
    it).

    With ``use_pallas`` it is the pull kernel.  Otherwise it is the dense
    sweep on the permuted arrays, the fused kernel over ``radj``/``erow``,
    which gives the reference's jnp form's winners (the reference takes
    that form only on its sharded path; a single device pulls compactly).
    """
    if use_pallas:
        return frontier_expand_pull(radj, erow, bfs, root, rmatch, level,
                                    gate, **_out(out))
    return frontier_expand_fused(radj, erow, bfs, root, rmatch, level, gate,
                                 **_out(out))


def _merge_shards(shard_win: torch.Tensor, winner: torch.Tensor
                  ) -> torch.Tensor:
    """The per-level merge of an edge-sharded sweep: the elementwise min of
    the shards' winner vectors (the rows of ``shard_win``), in place into
    ``winner``.  It stands where the reference's one ``lax.pmin`` over the
    mesh axis stands; min does not depend on order or partition, so the
    merged winners are the single-device sweep's."""
    return torch.amin(shard_win, dim=0, out=winner)


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


def _frontier(bfs, root, level, wr: bool) -> torch.Tensor:
    """The (nc,) frontier mask: columns at ``level`` (WR: whose root is
    not yet satisfied)."""
    nc = bfs.shape[-1] - 1
    isf = bfs[..., :-1] == _col(level)
    if wr:
        isf &= _take(bfs, root[..., :-1].clamp(0, nc)) >= UNVISITED
    return isf


def _apply_winner(winner, bfs, root, pred, rmatch, level, *, wr: bool,
                  wr_exact: bool, inplace: bool = False):
    """Fold a per-row winner vector into the BFS state (the paper's Alg. 2
    lines 8-17 / Alg. 4 lines 11-18).

    Returns ``(bfs, root, pred, rmatch, vertex_inserted, aug_found)``, the
    last two as 0-d device bools; ``inplace``: the four state tensors are
    updated in place and returned, else new ones.  The reference's
    ``.at[i].set`` becomes a reduction of :func:`scatter_kept` that gives
    the same values: a row is reached only through a matched column that
    is UNVISITED, with ``root`` still ``nc``, and the matched columns of
    the visited rows are distinct (``rmatch`` is a valid matching during a
    phase), so their new level is the max and their new root the min of
    old and new; the other rows touch no slot.  The reference's other rows
    write the sentinel slots, ``root[nc]`` with 0, which is sealed here to
    the same value.
    """
    if not inplace:
        bfs, root, pred, rmatch = (bfs.clone(), root.clone(), pred.clone(),
                                   rmatch.clone())
    nc = bfs.shape[-1] - 1
    nr = pred.shape[-1] - 1
    upd_r = winner < IINF                                 # (nr+1,) rows reached

    cm_r = rmatch                                         # row-wise matched col
    visit_r = upd_r & (cm_r >= 0)                         # Alg.2 l.8-12
    end_r = upd_r & (cm_r == -1)                          # Alg.2 l.14-17

    scatter_kept(bfs, cm_r, _col(level + 1), visit_r, "amax", inplace=True)
    if wr:
        rootvals = _take(root, winner.clamp(0, nc))
        scatter_kept(root, cm_r, rootvals, visit_r, "amin", inplace=True)
        _seal(root, 0)
        # mark the root "satisfied": plain WR writes L0-2, the exact variant
        # encodes the endpoint row as -(r+1) so ALTERNATE can start only the
        # winning endpoint of each tree (paper Sec. 3, last paragraph).
        if wr_exact:
            enc = -(_arange(nr + 1, winner) + 1)
        else:
            enc = torch.full((nr + 1,), FOUND, dtype=I32,
                             device=winner.device)
        scatter_kept(bfs, rootvals, enc, end_r, "amin", inplace=True)
    torch.where(upd_r, winner, pred, out=pred)
    rmatch.masked_fill_(end_r, -2)               # cm_r's last use is above
    _seal(bfs, NEG)                                       # restore sentinel

    return bfs, root, pred, rmatch, visit_r.any(-1), end_r.any(-1)


def _compact_plan(cxadj, bfs, root, level, *, wr: bool, cap: int,
                  dmax: int):
    """A level's adaptive decision, not yet read: (``eligible``, a 0-d
    device bool: the frontier fits ``cap`` columns of degree at most
    ``dmax``; the frontier mask the compact gather takes)."""
    isf = _frontier(bfs, root, level, wr)
    deg = cxadj[1:] - cxadj[:-1]
    eligible = (isf.sum() <= cap) & (torch.where(isf, deg, 0).amax() <= dmax)
    return eligible, isf


def _dirop_plan(cxadj, rxadj, bfs, root, rmatch, level, dir_prev, *,
                wr: bool, use_pallas: bool, dirop_alpha: float,
                dirop_beta: float, pull_cap: int, pull_dmax: int):
    """A level's direction, not yet read: (``use_pull``, a 0-d device
    bool; the unreached-row mask the compact pull takes).

    The frontier columns' outgoing edges ``fe`` against the unreached
    rows' incoming edges ``pe``, int sums compared in float32 as the
    reference compares them: pull when ``fe * dirop_alpha > pe``, or, if
    the previous level pulled (``dir_prev``, a bool or a 0-d device bool:
    the hysteresis), while ``fe * dirop_beta > pe``.  Without
    ``use_pallas`` the pull is the compact row gather, so every unreached
    row must also fit its (cap, dmax) geometry.
    """
    isf = _frontier(bfs, root, level, wr)
    cdeg = cxadj[..., 1:] - cxadj[..., :-1]
    fe = torch.where(isf, cdeg, 0).sum(-1).to(torch.float32)
    unreached = _unreached_rows(bfs, rmatch)
    rdeg = rxadj[..., 1:] - rxadj[..., :-1]
    pe = torch.where(unreached, rdeg, 0).sum(-1).to(torch.float32)
    pull = (fe * dirop_alpha > pe) | (dir_prev & (fe * dirop_beta > pe))
    if not use_pallas:
        pull &= ((unreached.sum(-1) <= pull_cap)
                 & (torch.where(unreached, rdeg, 0).amax(-1) <= pull_dmax))
    return pull, unreached


# ---------------------------------------------------------------------------
# ALTERNATE (Alg. 3) + FIXMATCHING
# ---------------------------------------------------------------------------
def _start_mask(bfs, rmb, wr_exact: bool) -> torch.Tensor:
    """The rows whose walkers start: the endpoints the BFS found; with
    ``wr_exact`` only the winning endpoint of each satisfied tree."""
    mask = rmb == -2
    if wr_exact:
        enc = bfs[..., :-1]                                    # (nc,)
        wins = _seal(scatter_kept(
            torch.zeros(rmb.shape, dtype=torch.bool, device=enc.device),
            -(enc + 1), True, enc <= -1), False)
        mask = mask & wins
    return mask


def _walkers(B: Buffers, start_mask: torch.Tensor) -> None:
    """Start the ``ALTERNATE`` walkers at the rows of ``start_mask``: ``cur``
    (the walker's row or -1), ``pmc`` (``pred[cur]``, hoisted), ``steps``
    0, ``alt_live`` whether any walker runs."""
    nr = B.pred.shape[-1] - 1
    cur = torch.where(start_mask, B.rows, -1)
    B.cur.copy_(cur)
    B.pmc.copy_(_take(B.pred, cur.clamp(0, nr)))
    B.steps.zero_()
    B.alt_live.copy_((cur >= 0).any(-1))


def _alternate_step(B: Buffers, max_steps: int) -> None:
    """One lock-step ``ALTERNATE`` step over the walk's matching ``acm`` /
    ``arm``.

    Writes of concurrent walkers are merged with min-scatters; the paper's
    line-8 predecessor check breaks walkers that would chase another path.
    One ``pred`` gather per step, carried to the next.  The reference skips
    the two scatters on a step where every walker broke; here they always
    run, which gives the same matching and the same step count.
    ``alt_live`` stays set while ``steps < max_steps`` and a walker is left.
    """
    nc = B.acm.shape[0] - 1
    nr = B.arm.shape[0] - 1
    cur, mc = B.cur, B.pmc                                # matched_col = pred[cur]
    active = cur >= 0
    curc = cur.clamp(0, nr)
    mcc = mc.clamp(0, nc)
    mr = B.acm.index_select(0, mcc.long())                # matched_row (snapshot)
    pmr = B.pred.index_select(0, mr.clamp(0, nr).long())  # the step's gather
    # paper line 8: if predecessor[matched_row] == matched_col: break
    brk = active & (mr >= 0) & (pmr == mc)
    act = active & ~brk
    # cmatch[mc] <- cur ; rmatch[cur] <- mc  (speculative, min-merged)
    cprop = scatter_min(nc, torch.where(act, mcc, nc),
                        torch.where(act, cur, IINF))
    rprop = scatter_min(nr, torch.where(act, curc, nr),
                        torch.where(act, mc, IINF))
    torch.where(cprop < IINF, cprop, B.acm, out=B.acm)
    torch.where(rprop < IINF, rprop, B.arm, out=B.arm)
    B.cur.copy_(mr.masked_fill_(~act, -1))            # walk on to matched_row
    B.pmc.copy_(pmr)
    B.steps.add_(1)
    B.counts[ALT].add_(1)
    B.alt_live.copy_((B.steps < max_steps) & (B.cur >= 0).any())


def _alternate(cmatch, rmatch, pred, start_mask, max_steps: int):
    """Lock-step speculative alternation of all augmenting paths, on its
    own: the ``ALTERNATE`` loop of the solver (:func:`_alternate_step`)
    run uncaptured from ``start_mask``.  Returns ``(cmatch, rmatch,
    steps)`` with ``steps`` a Python int."""
    P = Program(cmatch.device, capture=False)
    nr = rmatch.shape[0] - 1
    P.constant("acm", cmatch.clone())
    P.constant("arm", rmatch.clone())
    P.constant("pred", pred)
    P.constant("rows", _arange(nr + 1, rmatch))
    P.alloc("cur", nr + 1)
    P.alloc("pmc", nr + 1)
    P.scalars(("steps", "alt_live"))
    _walkers(P.buf, start_mask)
    P.loop(Loop("alt", lambda B: _alternate_step(B, max_steps), "alt_live",
                start=False))
    return P.buf.acm, P.buf.arm, int(P.buf.steps)


def _fix_matching(cmatch, rmatch):
    """Paper's FIXMATCHING, both directions -> a valid matching."""
    nc = cmatch.shape[-1] - 1
    nr = rmatch.shape[-1] - 1
    rows = _arange(nr + 1, rmatch)
    cols = _arange(nc + 1, cmatch)
    rmatch = torch.where(rmatch == -2, -1, rmatch)
    ok_r = (rmatch >= 0) & (_take(cmatch, rmatch.clamp(0, nc)) == rows)
    rmatch = torch.where((rmatch >= 0) & ~ok_r, -1, rmatch)
    ok_c = (cmatch >= 0) & (_take(rmatch, cmatch.clamp(0, nr)) == cols)
    cmatch = torch.where((cmatch >= 0) & ~ok_c, -1, cmatch)
    return cmatch, rmatch


def _cardinality(cmatch) -> torch.Tensor:
    return (cmatch[..., :-1] >= 0).sum(-1, dtype=I32)


# ---------------------------------------------------------------------------
# Drivers — Algorithm 1 (APsB) and its APFB variant, as device steps
# ---------------------------------------------------------------------------
# the loops' scalars, in the Program's order; level .. bfs_live are set
# together at the start of a phase
SCALARS = ("level", "ins", "aug", "aug_lvl", "dir_prev", "bfs_live", "plan",
           "steps", "alt_live", "gained", "ws_live", "phases", "fallbacks",
           "certified")
_PHASE_START = (L0, 1, 0, IINF, 0, 1)


class Solver:
    """The APFB/APsB solve of one config and graph size: the steps over a
    :class:`Program`'s buffers, and the host loop that runs them
    (:meth:`run`).

    Steps: ``phase_begin`` (the BFS state at L0; the first level's branch
    decision), the BFS level (a loop step run while ``bfs_live`` is set; on
    the branching paths one step per branch, picked by ``plan``),
    ``alt_begin`` (the walkers), ``ALTERNATE`` (a loop step run while
    ``alt_live`` is set), ``alt_end`` (the
    repair and the cardinality guard, which also starts the single walker
    of the fallback), ``fallback_end``, ``commit`` and ``phase_done`` (the
    phase count), ``finish`` (``certified``).

    ``bfs_live`` carries the exact stopping rules of the reference's inner
    loop: APFB runs while a vertex was inserted; APsB also stops at its
    first augmenting level; ``tail_levels`` runs at most that many levels
    past it.  ``cfg.max_phases`` and ``cfg.degrade_maximal`` act on the
    host, from values it has read.

    ``shards``: the edge-sharded solve of ``ShardedMatcher`` over a mesh
    axis of that many shards (None: one device, no mesh).  Each level then
    sweeps each shard's contiguous slice of the edge buffers into a row of
    its own and merges the rows (:func:`_merge_shards`), all inside the
    level step, so it is captured and looped as the single-device level
    is and makes the same host syncs.

    ``world``: the edge-sharded solve over the ranks of a world, this rank
    holding one shard.  Each level sweeps that shard and merges the ranks'
    winners with one ``all_reduce_min_`` inside the level step: in an NCCL
    world of one rank captured with it; under gloo, which no capture can
    hold, and across several NCCL ranks, whose captured collective no WHILE
    node's body can hold, the entry's program runs uncaptured
    (:class:`MatcherProgram`), the host testing every loop's flag (a
    counted host sync a test on a card).  The
    ``degrade_maximal`` round is then the matcher's, on rank 0 over the
    whole edge list.
    """

    lanes: tuple = ()           # one graph; a batch's solver has (B,)

    def __init__(self, cfg: MatcherConfig, nc: int, nr: int,
                 shards: Optional[int] = None, world=None):
        if shards is not None and cfg.adaptive_frontier:
            raise ValueError(
                "adaptive_frontier is single-device only; the sharded "
                "solve keeps the dense per-shard sweep and one merge per "
                "level (MatcherConfig(dirop=True) is the direction "
                "heuristic that composes with sharding)")
        self.cfg, self.nc, self.nr = cfg, nc, nr
        self.shards = shards
        self.world = world
        # the shards this process sweeps: one over a world's ranks
        self.local = None if shards is None else (
            1 if world is not None else shards)
        self.wr = cfg.kernel == "gpubfs_wr"
        # compact/pull geometry: the one auto rule lives on MatcherConfig
        self.compact_cap = cfg.resolve_cap(cfg.compact_cap, nc)
        self.compact_dmax = cfg.resolve_dmax(cfg.compact_dmax)
        self.pull_cap = cfg.resolve_cap(cfg.pull_cap, nr)
        self.pull_dmax = cfg.resolve_dmax(cfg.pull_dmax)
        self.max_steps = 2 * (min(nc, nr) + 2)
        self.limit = cfg.max_phases if cfg.max_phases > 0 else nc + 2
        # the lax.cond of these two picks between torch-op sweeps: one step
        # per branch, picked by the level's decision ``plan``; a sharded
        # dirop pulls by the streamed sweep, gated as dirop_pallas is
        self.branching = shards is None and (
            cfg.adaptive_frontier or (cfg.dirop and not cfg.use_pallas))
        self.degrade = (cfg.degrade_maximal and cfg.max_phases > 0
                        and world is None)
        self.phase_begin = Once("phase_begin", self._phase_begin)
        body = self._level
        if self.branching:
            body = Branch("plan", lambda B: self._branch_level(B, True),
                          lambda B: self._branch_level(B, False))
        self.level = Loop("level", body, "bfs_live", start=False)
        self.alt_begin = Once("alt_begin", self._alt_begin)
        self.alt = Loop("alt", self._alternate, "alt_live", start=False)
        self.alt_end = Once("alt_end", self._alt_end)
        self.fallback_end = Once("fallback_end", self._fallback_end)
        self.commit = Once("commit", self._commit)
        self.phase_done = Once("phase_done", self._phase_done)
        self.finish = Once("finish", self._finish)

    @property
    def needs_cxadj(self) -> bool:
        return self.cfg.adaptive_frontier or self.cfg.dirop

    def alloc(self, P: Program) -> None:
        """The loops' scalars and the solver's own buffers (the graph, the
        matching and ``rows`` are the entry's)."""
        P.scalars(SCALARS)
        self._alloc_state(P)
        P.buf["bfs_scalars"] = P.scalar_slice("level", "bfs_live")
        if self.shards is not None:
            # a row per shard's sweep (dirop: the push rows, then the pull
            # rows) and the merged winners
            rows = self.local * (2 if self.cfg.dirop else 1)
            P.alloc("shard_win", (rows, self.nr + 1))
            P.alloc("winner", self.nr + 1)

    def _alloc_state(self, P: Program) -> None:
        nc, nr = self.nc, self.nr
        for name in ("bfs", "root", "acm"):
            P.alloc(name, (*self.lanes, nc + 1))
        for name in ("pred", "rmb", "arm", "cur", "pmc"):
            P.alloc(name, (*self.lanes, nr + 1))
        P.constant("phase_start", torch.tensor(_PHASE_START, dtype=I32))

    # -- steps ----------------------------------------------------------------
    def _sweep_kw(self) -> dict:
        return dict(use_pallas=self.cfg.use_pallas,
                    pallas_fused=self.cfg.pallas_fused)

    def _plan(self, B: Buffers) -> torch.Tensor:
        """This level's branch decision (a 0-d device bool).  Sharded, the
        pull is the streamed one, so no unreached row need fit the compact
        geometry (``use_pallas`` drops that test)."""
        if self.cfg.dirop:
            return _dirop_plan(
                B.cxadj, B.rxadj, B.bfs, B.root, B.rmb, B.level,
                B.dir_prev != 0, wr=self.wr,
                use_pallas=self.cfg.use_pallas or self.shards is not None,
                dirop_alpha=self.cfg.dirop_alpha,
                dirop_beta=self.cfg.dirop_beta, pull_cap=self.pull_cap,
                pull_dmax=self.pull_dmax)[0]
        return _compact_plan(B.cxadj, B.bfs, B.root, B.level, wr=self.wr,
                             cap=self.compact_cap, dmax=self.compact_dmax)[0]

    def _phase_begin(self, B: Buffers) -> None:
        bfs, root = level0_state(B.cmatch)
        B.bfs.copy_(bfs)
        B.root.copy_(root)
        B.pred.fill_(self.nc)
        B.rmb.copy_(B.rmatch)
        B.bfs_scalars.copy_(B.phase_start)
        if self.branching:
            B.plan.copy_(self._plan(B))

    def _fold(self, B: Buffers, winner: torch.Tensor) -> None:
        """Fold a level's winners into the BFS state, then the level's
        bookkeeping: ``aug_lvl``, ``ins``, ``aug``, ``level`` and
        ``bfs_live`` (Alg. 1 l.9-10 for APsB, the tail bound)."""
        *_, ins, aug_t = _apply_winner(
            winner, B.bfs, B.root, B.pred, B.rmb, B.level, wr=self.wr,
            wr_exact=self.cfg.wr_exact, inplace=True)
        B.aug_lvl.copy_(torch.where(aug_t & (B.aug_lvl == IINF), B.level,
                                    B.aug_lvl))
        aug = (B.aug != 0) | aug_t
        B.ins.copy_(ins)
        B.aug.copy_(aug)
        B.level.add_(1)
        if self.cfg.algo == "apsb":
            go = ins & ~aug                              # Alg.1 l.9-10 break
        elif self.cfg.tail_levels > 0:
            # bounded tail: at most tail_levels past the first augmenting
            # level (beyond-paper, see MatcherConfig)
            go = ins & (B.level <= B.aug_lvl + self.cfg.tail_levels)
        else:
            go = ins
        B.bfs_live.copy_(go)

    def _level(self, B: Buffers) -> None:
        """One BFS level: the sweep (:meth:`_sweep`), over a world's ranks
        the merge (in an NCCL world of one, captured with the step), then
        the fold."""
        winner = self._sweep(B)
        if self.world is not None:
            all_reduce_min_(winner, self.world)
        self._fold(B, winner)

    def _sweep(self, B: Buffers) -> torch.Tensor:
        """A level's winners: the push sweep, or with ``dirop`` +
        ``use_pallas`` (or sharded ``dirop``) both sweeps, each gated by the
        level's direction (decided on the device), so that only one of them
        sweeps; sharded, each sweep once a shard this process holds, then
        the merge of those; the level's counts."""
        rt = B.root if self.wr else None
        pull = self._plan(B) if self.cfg.dirop else None
        if self.shards is not None:
            winner = self._shard_sweeps(B, rt, pull)
            B.counts[MERGES].add_(1)
        elif pull is not None:
            winner = torch.minimum(
                _winner_full(B.ecol, B.cadj, B.bfs, rt, B.rmb, B.level,
                             gate=(~pull).to(I32), **self._sweep_kw()),
                _winner_pull_stream(B.radj, B.erow, B.bfs, rt, B.rmb,
                                    B.level, use_pallas=True,
                                    gate=pull.to(I32)))
        else:
            winner = _winner_full(B.ecol, B.cadj, B.bfs, rt, B.rmb, B.level,
                                  **self._sweep_kw())
        if pull is not None:
            B.dir_prev.copy_(pull)
            B.counts[LEVELS].add_(1)
            B.counts[PUSH].add_(~pull)
            B.counts[PULL].add_(pull)
        else:
            B.counts[LEVELS:PUSH + 1].add_(1)
        return winner

    def _shard_sweeps(self, B: Buffers, rt, pull) -> torch.Tensor:
        """The level's winners of a sharded solve: shard ``d``'s sweep over
        its slice of the edge buffers into row ``d`` of ``shard_win`` (with
        ``dirop``, gated off on a pull level, and its streamed pull over
        its slice of the mirror into row ``D + d``, gated off on a push
        level), then the rows merged into ``winner``.  Over a world's ranks
        ``D`` is this rank's one shard."""
        D, win = self.local, B.shard_win
        push_gate = None if pull is None else (~pull).to(I32)
        for d, (ecol, cadj) in enumerate(zip(B.ecol.chunk(D),
                                             B.cadj.chunk(D))):
            _winner_full(ecol, cadj, B.bfs, rt, B.rmb, B.level,
                         gate=push_gate, out=win[d], **self._sweep_kw())
        if pull is not None:
            pull_gate = pull.to(I32)
            for d, (radj, erow) in enumerate(zip(B.radj.chunk(D),
                                                 B.erow.chunk(D))):
                _winner_pull_stream(radj, erow, B.bfs, rt, B.rmb, B.level,
                                    use_pallas=self.cfg.use_pallas,
                                    gate=pull_gate, out=win[D + d])
        return _merge_shards(win, B.winner)

    def _branch_level(self, B: Buffers, take: bool) -> None:
        """One BFS level of a branching path: the push sweep, or (``take``)
        the compact column gather (``adaptive_frontier``) or the compact
        pull (``dirop``); then the next level's decision."""
        rt = B.root if self.wr else None
        if not take:
            slot = PUSH
            winner = _winner_full(B.ecol, B.cadj, B.bfs, rt, B.rmb, B.level,
                                  **self._sweep_kw())
        elif self.cfg.adaptive_frontier:
            slot = COMPACT
            winner = _winner_compact(
                B.cxadj, B.cadj, B.bfs, B.rmb,
                _frontier(B.bfs, B.root, B.level, self.wr),
                cap=self.compact_cap, dmax=self.compact_dmax)
        else:
            slot = PULL
            winner = _winner_pull_compact(
                B.rxadj, B.radj, B.bfs, rt, B.rmb, B.level,
                _unreached_rows(B.bfs, B.rmb), cap=self.pull_cap,
                dmax=self.pull_dmax)
        B.counts[LEVELS].add_(1)
        B.counts[slot].add_(1)
        if self.cfg.dirop:
            B.dir_prev.fill_(int(take))
        self._fold(B, winner)
        B.plan.copy_(self._plan(B))

    def _alt_begin(self, B: Buffers) -> None:
        mask = _start_mask(B.bfs, B.rmb, self.cfg.wr_exact)
        B.acm.copy_(B.cmatch)
        B.arm.copy_(torch.where(mask, -2, B.rmatch))
        _walkers(B, mask)

    def _alternate(self, B: Buffers) -> None:
        _alternate_step(B, self.max_steps)

    def _alt_end(self, B: Buffers) -> None:
        """FIXMATCHING of the walk, then the guard: if the speculative phase
        gained nothing, restart from the phase's matching with exactly one
        walker on one shortest path (a single walker cannot conflict).
        argmax over an int mask is the first True: the lowest endpoint
        row."""
        cm1, rm1 = _fix_matching(B.acm, B.arm)
        gained = _cardinality(cm1) > _cardinality(B.cmatch)
        B.gained.copy_(gained)
        B.acm.copy_(torch.where(gained, cm1, B.cmatch))
        B.arm.copy_(torch.where(gained, rm1, B.rmatch))
        any_ep = B.rmb == -2
        first = torch.argmax(any_ep.to(I32)).reshape(1)
        one = torch.zeros(self.nr + 1, dtype=torch.bool, device=first.device)
        one = one.scatter(0, first, (any_ep.any() & ~gained).reshape(1))
        _walkers(B, one)
        B.fallbacks.add_(~gained)

    def _fallback_end(self, B: Buffers) -> None:
        cm, rm = _fix_matching(B.acm, B.arm)
        B.acm.copy_(cm)
        B.arm.copy_(rm)

    def _commit(self, B: Buffers) -> None:
        B.cmatch.copy_(B.acm)
        B.rmatch.copy_(B.arm)
        B.phases.add_(1)

    def _phase_done(self, B: Buffers) -> None:
        B.phases.add_(1)

    def _finish(self, B: Buffers) -> None:
        # aug is the last BFS verdict: False means the phase found no
        # augmenting path — Berge certifies the matching maximum.  A
        # budget-truncated exit leaves aug True: valid but uncertified.
        B.certified.copy_(B.aug == 0)

    # -- the host loop --------------------------------------------------------
    def run(self, P: Program) -> None:
        """The solve from the matching in ``cmatch`` / ``rmatch``: the
        phases, each a BFS and (if it found an augmenting path) an
        ``ALTERNATE`` walk.  The host reads the device once a phase for the
        BFS verdict and once an augmenting phase for the guard."""
        P.scalar_slice("phases", "fallbacks").zero_()
        phases, aug = 0, True
        while aug and phases < self.limit:
            P.once(self.phase_begin)
            P.loop(self.level)
            aug = P.read("aug")[0]
            if aug:
                P.once(self.alt_begin)
                P.loop(self.alt)
                P.once(self.alt_end)
                if not P.read("gained")[0]:
                    P.loop(self.alt)
                    P.once(self.fallback_end)
                P.once(self.commit)
            else:
                P.once(self.phase_done)
            phases += 1
        P.once(self.finish)
        if self.degrade and aug:
            # one speculative greedy round restores maximality (local
            # import: warmstart.py imports solver internals from here)
            from .warmstart import CHEAP
            P.run_stages(CHEAP)


# ---------------------------------------------------------------------------
# One compile-cache entry: warm start and solve for one size bucket
# ---------------------------------------------------------------------------
def _device_key(device) -> torch.device:
    """``device`` as an entry keys its programs: a card with its index
    (``"cuda"`` is the current card), so ``"cuda"`` and ``"cuda:0"`` name
    one program."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class MatcherProgram:
    """The counterpart of one compiled program of the JAX package: the warm
    start ``stages`` (None: the state is given) and the solve of ``cfg``
    (None: warm start only) for graphs of one size bucket, ``(nc, nr,
    nnz_pad)``.

    Per device it holds a :class:`Program`: the static buffers (the graph's
    arrays, its CSC mirror where the config pulls, the matching, the
    solver's state and the loops' scalars) and, on a card, the captured
    graphs.  A call copies its graph and state into the buffers and runs
    the steps (replays them on a card), so two graphs of one bucket each
    get their own answer.  Calls are serialized by the entry's lock.

    ``shards``: the solve is edge-sharded over that many shards (the
    ``"sharded_run"`` entry of ``ShardedMatcher``); the warm start and the
    ``degrade_maximal`` round still run over the whole edge list.
    ``world``: the solve over the ranks of a world, ``nnz_pad`` this rank's
    shard's (the warm start and the degrade round are then the matcher's).
    Under gloo, whose collectives no CUDA graph can hold, and across
    several NCCL ranks, its program runs uncaptured on a card too.
    """

    lanes: tuple = ()           # one graph; a batch's entry has (B,)

    def __init__(self, nc: int, nr: int, nnz_pad: int,
                 cfg: Optional[MatcherConfig], stages: Optional[Sequence],
                 shards: Optional[int] = None, world=None):
        self.nc, self.nr, self.nnz_pad = nc, nr, nnz_pad
        self.cfg = cfg
        self.stages = tuple(stages or ())
        self.shards = shards
        self.world = world
        self.solver = self._solver(cfg) if cfg is not None else None
        self._programs: dict = {}

    def _solver(self, cfg: MatcherConfig) -> Solver:
        return Solver(cfg, self.nc, self.nr, self.shards, self.world)

    def program(self, device) -> Program:
        """The entry's :class:`Program` on ``device`` (built on first use;
        its graphs are captured at the first run of each step)."""
        device = _device_key(device)
        P = self._programs.get(device)
        if P is None:
            P = self._programs[device] = self._build(device)
        return P

    def _build(self, device) -> Program:
        nc, nr, m = self.nc, self.nr, self.nnz_pad
        # every loop ends within nc + nr + 4 iterations (levels, ALTERNATE
        # steps, warm-start rounds); the guard stops a runaway past that
        # a WHILE node's body cannot hold NCCL's captured collective across
        # ranks: instantiating it fails (CUDA error 1, read on four H100s)
        w = self.world
        host_loops = w is not None and (w.backend != "nccl" or w.size > 1)
        P = Program(device, capture=False if host_loops else None,
                    loop_limit=nc + nr + 8)

        def alloc(name, n, dtype=I32):
            P.alloc(name, (*self.lanes, n), dtype)

        alloc("ecol", m)
        alloc("cadj", m)
        solver = self.solver
        if solver is not None and solver.needs_cxadj:
            alloc("cxadj", nc + 1)
        if solver is not None and self.cfg.dirop:
            alloc("rxadj", nr + 1)
            alloc("radj", m)
            alloc("erow", m)
        if (solver is not None and solver.degrade) or self.stages:
            # the warm starts' edge gathers and scatters take int64 indices
            alloc("ecol_l", m, torch.int64)
            alloc("cadj_l", m, torch.int64)
        alloc("cmatch", nc + 1)
        alloc("rmatch", nr + 1)
        P.constant("rows", torch.arange(nr + 1, dtype=I32, device=device))
        P.constant("cols", torch.arange(nc + 1, dtype=I32, device=device))
        if solver is None:
            P.scalars(SCALARS)          # the warm starts' ws_live
        else:
            solver.alloc(P)
        return P

    def load(self, P: Program, graph, state: Optional[MatchState]) -> None:
        """Copy ``graph`` and ``state`` (None: all unmatched) into the
        buffers of ``P``."""
        B = P.buf
        for name in ("ecol", "cadj", "cxadj", "rxadj", "radj", "erow"):
            if name in B:
                B[name].copy_(getattr(graph, name))
        if "ecol_l" in B:
            B.ecol_l.copy_(graph.ecol)
            B.cadj_l.copy_(graph.cadj)
        B.runaway.zero_()
        if state is None:
            _seal(B.cmatch.fill_(-1), SENTINEL)
            _seal(B.rmatch.fill_(-1), SENTINEL)
        else:
            B.cmatch.copy_(state.cmatch)
            B.rmatch.copy_(state.rmatch)

    def __call__(self, graph, state: Optional[MatchState] = None
                 ) -> MatchState:
        """Warm start (if the entry has one) and solve (if it has a
        config) of ``graph`` from ``state`` (None: all unmatched)."""
        P = self.program(graph.device)
        with P.lock:
            self.load(P, graph, state)
            P.run_stages(self.stages)
            if self.solver is not None:
                self.solver.run(P)
            P.check()           # a loop after the last read: read its guard
            B = P.buf
            cm, rm = B.cmatch.clone(), B.rmatch.clone()
            if self.solver is None:
                if state is None:
                    zero = torch.zeros((), dtype=I32, device=cm.device)
                    return MatchState(cmatch=cm, rmatch=rm, phases=zero,
                                      fallbacks=zero.clone(),
                                      certified=zero.bool())
                return dataclasses.replace(state, cmatch=cm, rmatch=rm)
            phases, fallbacks = B.phases.clone(), B.fallbacks.clone()
            if state is not None:
                phases += state.phases
                fallbacks += state.fallbacks
            return MatchState(cmatch=cm, rmatch=rm, phases=phases,
                              fallbacks=fallbacks,
                              certified=B.certified != 0)

    def nbytes(self, device=None) -> int:
        """Bytes the entry holds on ``device`` (None: on every device): its
        static buffers and the card memory its captures reserved."""
        if device is None:
            return sum(P.total_bytes() for P in self._programs.values())
        P = self._programs.get(_device_key(device))
        return 0 if P is None else P.total_bytes()

    def static_bytes(self, device) -> int:
        """Bytes of the static buffers on ``device`` (the graphs' memory
        pool not included)."""
        P = self._programs.get(_device_key(device))
        return 0 if P is None else P.nbytes()

    def captures(self, device) -> int:
        """CUDA graphs captured on ``device`` so far."""
        P = self._programs.get(_device_key(device))
        return 0 if P is None else P.total_captures()


def make_solver(cfg: MatcherConfig):
    """Build the matcher ``(ecol, cadj, cmatch, rmatch[, cxadj, rxadj,
    radj, erow]) -> (cmatch, rmatch, phases, fallbacks, certified)``, the
    last three 0-d device tensors: the solver steps in an entry of its own
    (not the compile cache).

    ``certified`` is True iff the final phase's BFS proved no augmenting
    path remains (the matching is maximum, Berge).  A run cut short by a
    positive ``cfg.max_phases`` budget returns ``certified=False``; with
    ``cfg.degrade_maximal`` the matching is then made maximal by one greedy
    augmentation round.

    ``cfg.adaptive_frontier`` also needs the ``cxadj`` offsets;
    ``cfg.dirop`` needs ``cxadj`` and the CSC mirror (``rxadj``/``radj``/
    ``erow`` of ``TorchCSR.with_csc``).  ``Matcher.solve`` passes them.
    """

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
        nc, nr = cmatch.shape[0] - 1, rmatch.shape[0] - 1
        graph = types.SimpleNamespace(ecol=ecol, cadj=cadj, cxadj=cxadj,
                                      rxadj=rxadj, radj=radj, erow=erow,
                                      device=cmatch.device)
        zero = torch.zeros((), dtype=I32, device=cmatch.device)
        state = MatchState(cmatch=cmatch, rmatch=rmatch, phases=zero,
                           fallbacks=zero, certified=zero.bool())
        out = MatcherProgram(nc, nr, ecol.shape[0], cfg, None)(graph, state)
        return (out.cmatch, out.rmatch, out.phases, out.fallbacks,
                out.certified)

    return match_fn
