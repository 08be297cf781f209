"""The batched solve: ``Matcher.run_many`` over B graphs of one size bucket.

The JAX package batches by ``jax.vmap`` of its single-graph program.  Under
``vmap`` each ``lax.while_loop`` runs while *any* lane's condition holds,
and a lane whose condition is false is frozen: its carry passes through a
select, unchanged.  Each ``lax.cond`` on a lane value becomes a select of
both branches.  So every lane ends with what the single-graph program gives
on its graph, bit for bit, and this module does the same on the port's
device programs:

* every buffer has a leading lane dimension, ``(B, n)``; every gather and
  scatter runs along the last dimension, so lanes never touch each other's
  slots: the single-graph solver's helpers (:mod:`.solve`,
  :mod:`.warmstart`) take ``(n,)`` or ``(B, n)`` alike, and only the steps
  that mask lanes are this module's own;
* each loop has a per-lane ``live`` row (``bfs_live``, ``alt_live``,
  ``ws_live``, ``phase_live``) and a 0-d flag, "any lane live", computed on
  the device at the end of each step: the flag is what the WHILE node
  tests.  A step changes nothing of a lane whose ``live`` is 0: the frontier
  kernels are gated off for it (they return no winner), and every other
  write is masked by the lane's row;
* the host branches of the single-graph solve (``if aug``, ``if not
  gained``, ``max_phases``, ``degrade_maximal``) are per-lane masks on the
  device; the host reads "any lane walks / goes on" after the BFS and "any
  lane falls back" after the walk, two reads a phase of the slowest lane;
* the branching path (``dirop`` without ``use_pallas``) runs both branches
  and selects per lane, as ``vmap`` does: the push kernel gated to the
  lanes that push, the compact pull (torch ops) for every lane.

The frontier kernels take the whole batch in one launch a level (their
lane dimension, :mod:`repro_torch.kernels.frontier_expand`).  The solver
counts (:data:`~.device_loop.COUNTERS`) count lane-levels and lane-steps.
``adaptive_frontier`` is refused (:class:`BatchSolver`), as in the JAX
package.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels.frontier_expand import frontier_expand_pull

from .config import MatcherConfig
from .device_loop import (ALT, LEVELS, PULL, PUSH, Buffers, Loop, Once,
                          Program)
from .solve import (I32, IINF, MatcherProgram, Solver, _apply_winner,
                    _cardinality, _dirop_plan, _fix_matching, _start_mask,
                    _take, _unreached_rows, _walkers, _winner_full,
                    _winner_pull_compact, level0_state, scatter_min)
from . import warmstart

# the loops' flags and the host's reads: 0-d scalars of the Program
FLAGS = ("bfs_any", "alt_any", "ws_any", "walk_any", "next_any", "fb_any")
# per-lane rows, each a contiguous (B,) int32 view of one matrix; level ..
# bfs_live are set together at the start of a phase (as _PHASE_START)
LANES = ("level", "ins", "aug", "aug_lvl", "dir_prev", "bfs_live", "plan",
         "steps", "alt_live", "gained", "ws_live", "phase_live", "do_alt",
         "do_fb", "next_live", "phases", "fallbacks", "certified")


def _any_walkers(B: Buffers, start_mask) -> None:
    """The walkers of every lane from ``start_mask`` (:func:`~.solve.
    _walkers`), and the loop's "any lane" flag."""
    _walkers(B, start_mask)
    B.alt_any.copy_(B.alt_live.any())


# ---------------------------------------------------------------------------
# warm starts, lane by lane (the built-ins' rounds, frozen lanes untouched)
# ---------------------------------------------------------------------------
def _ws_begin(B: Buffers) -> None:
    B.ws_live.fill_(1)
    B.ws_any.fill_(1)


def _lane_round(round_fn):
    """A warm start's round (:mod:`.warmstart`) on the lanes with
    ``ws_live``, then the loop's "any lane" flag."""
    def step(B: Buffers) -> None:
        round_fn(B, B.ws_live != 0)
        B.ws_any.copy_(B.ws_live.any())
    return step


def _fix(B: Buffers) -> None:
    cm, rm = _fix_matching(B.cmatch, B.rmatch)
    B.cmatch.copy_(cm)
    B.rmatch.copy_(rm)


WS_BEGIN = Once("ws_begin", _ws_begin)
CHEAP = (WS_BEGIN, Loop("cheap", _lane_round(warmstart._cheap_round),
                        "ws_any", start=False))
KARP_SIPSER = (WS_BEGIN, Loop("karp_sipser",
                              _lane_round(warmstart._karp_sipser_round),
                              "ws_any", start=False),
               *CHEAP, Once("karp_sipser_fix", _fix))


def _degrade_begin(B: Buffers) -> None:
    """The budget's greedy round runs on the lanes left uncertified."""
    go = B.aug != 0
    B.ws_live.copy_(go)
    B.ws_any.copy_(go.any())


DEGRADE = (Once("degrade_begin", _degrade_begin), CHEAP[1])


def stages(name: str) -> tuple:
    """The batched device stages of the warm start registered as ``name``:
    the built-ins' rounds lane by lane, or a registered function as one
    step that calls it on each lane (captured whole on a card, as the
    single-graph entry captures it)."""
    fn = warmstart.get_warm_start(name)
    builtin = {warmstart.none_init: (), warmstart.cheap_init: CHEAP,
               warmstart.karp_sipser_init: KARP_SIPSER}.get(fn)
    if builtin is not None:
        return builtin

    def run(B: Buffers) -> None:
        for i in range(B.cmatch.shape[0]):
            cm, rm = fn(B.ecol[i], B.cadj[i], B.cmatch[i], B.rmatch[i])
            B.cmatch[i].copy_(cm)
            B.rmatch[i].copy_(rm)

    return (Once(f"warm start {name!r}", run, loops=True),)


# ---------------------------------------------------------------------------
# the batched APFB / APsB solve
# ---------------------------------------------------------------------------
class BatchSolver(Solver):
    """The solve of one config over the ``lanes`` of one size bucket: the
    steps of :class:`~.solve.Solver` with per-lane ``live`` rows (module
    doc), and the host loop that runs them (:meth:`run`).  On the
    branching path (``dirop`` without the pull kernel) both sweeps run,
    selected per lane."""

    def __init__(self, cfg: MatcherConfig, nc: int, nr: int, lanes: tuple):
        if cfg.adaptive_frontier:
            # vmap turns the per-level branch into a select: every graph
            # would run both sweeps each level, so the reference refuses it
            raise ValueError(
                "adaptive_frontier composes with per-graph run() only; "
                "under run_many both sweeps would execute each level")
        super().__init__(cfg, nc, nr)
        self.lanes = lanes
        self.level = Loop("level", self._level, "bfs_any", start=False)
        self.bfs_end = Once("bfs_end", self._bfs_end)
        self.alt = Loop("alt", self._alternate, "alt_any", start=False)
        self.phase_end = Once("phase_end", self._phase_end)

    def alloc(self, P: Program) -> None:
        """The loops' flags, the per-lane rows and the solver's buffers."""
        P.scalars(FLAGS)
        rows = P.constant("lanes", torch.zeros((len(LANES), *self.lanes),
                                               dtype=I32))
        for i, name in enumerate(LANES):
            P.buf[name] = rows[i]
        self._alloc_state(P)

    # -- steps ----------------------------------------------------------------
    def _push(self, B: Buffers, gate) -> torch.Tensor:
        return _winner_full(B.ecol, B.cadj, B.bfs,
                            B.root if self.wr else None, B.rmb, B.level,
                            use_pallas=self.cfg.use_pallas,
                            pallas_fused=self.cfg.pallas_fused, gate=gate)

    def _plan(self, B: Buffers) -> torch.Tensor:
        """The dirop decision of each lane (:func:`~.solve._dirop_plan`)."""
        return _dirop_plan(
            B.cxadj, B.rxadj, B.bfs, B.root, B.rmb, B.level, B.dir_prev != 0,
            wr=self.wr, use_pallas=self.cfg.use_pallas,
            dirop_alpha=self.cfg.dirop_alpha, dirop_beta=self.cfg.dirop_beta,
            pull_cap=self.pull_cap, pull_dmax=self.pull_dmax)[0]

    def _phase_begin(self, B: Buffers) -> None:
        live = B.phase_live != 0
        lv = live[:, None]
        bfs, root = level0_state(B.cmatch)
        torch.where(lv, bfs, B.bfs, out=B.bfs)
        torch.where(lv, root, B.root, out=B.root)
        B.pred.masked_fill_(lv, self.nc)
        torch.where(lv, B.rmatch, B.rmb, out=B.rmb)
        block = B.lanes[LANES.index("level"):LANES.index("bfs_live") + 1]
        torch.where(live, B.phase_start[:, None], block, out=block)
        B.bfs_live.copy_(live)
        B.bfs_any.copy_(live.any())
        if self.branching:
            B.plan.copy_(torch.where(live, self._plan(B), B.plan != 0))

    def _fold(self, B: Buffers, winner, live) -> None:
        """A level's winners into the live lanes' BFS state, then their
        bookkeeping (:meth:`~.solve.Solver._fold`).  A lane that is not
        live has no winner (its sweeps were gated off), so the fold leaves
        it as it was."""
        *_, ins, aug_t = _apply_winner(
            winner, B.bfs, B.root, B.pred, B.rmb, B.level, wr=self.wr,
            wr_exact=self.cfg.wr_exact, inplace=True)
        torch.where(live & aug_t & (B.aug_lvl == IINF), B.level, B.aug_lvl,
                    out=B.aug_lvl)
        aug = (B.aug != 0) | (live & aug_t)
        B.aug.copy_(aug)
        B.ins.copy_(torch.where(live, ins, B.ins != 0))
        B.level.add_(live)
        if self.cfg.algo == "apsb":
            go = ins & ~aug
        elif self.cfg.tail_levels > 0:
            go = ins & (B.level <= B.aug_lvl + self.cfg.tail_levels)
        else:
            go = ins
        go &= live
        B.bfs_live.copy_(go)
        B.bfs_any.copy_(go.any())

    def _level(self, B: Buffers) -> None:
        """One BFS level of every live lane: one launch of the frontier
        kernel(s) for the batch, gated by lane."""
        live = B.bfs_live != 0
        rt = B.root if self.wr else None
        n_live = live.sum()
        if self.branching:
            take = B.plan != 0
            push = self._push(B, (live & ~take).to(I32))
            pull = _winner_pull_compact(
                B.rxadj, B.radj, B.bfs, rt, B.rmb, B.level,
                _unreached_rows(B.bfs, B.rmb), cap=self.pull_cap,
                dmax=self.pull_dmax)
            winner = torch.where((live & take)[:, None], pull, push)
        elif self.cfg.dirop:
            take = self._plan(B)
            winner = torch.minimum(
                self._push(B, (live & ~take).to(I32)),
                frontier_expand_pull(B.radj, B.erow, B.bfs, rt, B.rmb,
                                     B.level, (live & take).to(I32)))
        else:
            winner = self._push(B, B.bfs_live)
            B.counts[LEVELS:PUSH + 1].add_(n_live)
            self._fold(B, winner, live)
            return
        B.counts[LEVELS].add_(n_live)
        B.counts[PUSH].add_((live & ~take).sum())
        B.counts[PULL].add_((live & take).sum())
        B.dir_prev.copy_(torch.where(live, take, B.dir_prev != 0))
        self._fold(B, winner, live)
        if self.branching:
            B.plan.copy_(torch.where(live, self._plan(B), B.plan != 0))

    def _bfs_end(self, B: Buffers) -> None:
        """Per lane: whether it walks (``if aug``) and whether its phase
        loop goes on; the two "any lane" flags the host reads."""
        walk = (B.phase_live != 0) & (B.aug != 0)
        B.do_alt.copy_(walk)
        nxt = walk & (B.phases + 1 < self.limit)
        B.next_live.copy_(nxt)
        B.walk_any.copy_(walk.any())
        B.next_any.copy_(nxt.any())

    def _alt_begin(self, B: Buffers) -> None:
        mask = (_start_mask(B.bfs, B.rmb, self.cfg.wr_exact)
                & (B.do_alt != 0)[:, None])
        B.acm.copy_(B.cmatch)
        B.arm.copy_(torch.where(mask, -2, B.rmatch))
        _any_walkers(B, mask)

    def _alternate(self, B: Buffers) -> None:
        """One lock-step ``ALTERNATE`` step of every lane whose walk is
        live (:func:`~.solve._alternate_step`)."""
        nc, nr = self.nc, self.nr
        live = B.alt_live != 0
        lv = live[:, None]
        cur, mc = B.cur, B.pmc
        active = (cur >= 0) & lv
        curc = cur.clamp(0, nr)
        mcc = mc.clamp(0, nc)
        mr = _take(B.acm, mcc)
        pmr = _take(B.pred, mr.clamp(0, nr))
        brk = active & (mr >= 0) & (pmr == mc)
        act = active & ~brk
        cprop = scatter_min(nc, torch.where(act, mcc, nc),
                            torch.where(act, cur, IINF))
        rprop = scatter_min(nr, torch.where(act, curc, nr),
                            torch.where(act, mc, IINF))
        torch.where(cprop < IINF, cprop, B.acm, out=B.acm)
        torch.where(rprop < IINF, rprop, B.arm, out=B.arm)
        torch.where(lv, mr.masked_fill_(~act, -1), cur, out=B.cur)
        torch.where(lv, pmr, B.pmc, out=B.pmc)
        B.steps.add_(live)
        B.counts[ALT].add_(live.sum())
        go = live & (B.steps < self.max_steps) & (B.cur >= 0).any(dim=1)
        B.alt_live.copy_(go)
        B.alt_any.copy_(go.any())

    def _alt_end(self, B: Buffers) -> None:
        """Per walking lane: FIXMATCHING, then the guard; the single walker
        of each lane that gained nothing (:meth:`~.solve.Solver._alt_end`).
        """
        walk = B.do_alt != 0
        cm1, rm1 = _fix_matching(B.acm, B.arm)
        gained = _cardinality(cm1) > _cardinality(B.cmatch)
        B.gained.copy_(gained)
        g = gained[:, None]
        B.acm.copy_(torch.where(g, cm1, B.cmatch))
        B.arm.copy_(torch.where(g, rm1, B.rmatch))
        any_ep = B.rmb == -2
        first = torch.argmax(any_ep.to(I32), dim=1, keepdim=True)
        fb = walk & ~gained
        one = torch.zeros(B.rmb.shape, dtype=torch.bool, device=fb.device)
        one = one.scatter(1, first, (any_ep.any(dim=1) & fb)[:, None])
        _any_walkers(B, one)
        B.fallbacks.add_(fb)
        B.do_fb.copy_(fb)
        B.fb_any.copy_(fb.any())

    def _fallback_end(self, B: Buffers) -> None:
        fb = (B.do_fb != 0)[:, None]
        cm, rm = _fix_matching(B.acm, B.arm)
        torch.where(fb, cm, B.acm, out=B.acm)
        torch.where(fb, rm, B.arm, out=B.arm)

    def _commit(self, B: Buffers) -> None:
        walk = (B.do_alt != 0)[:, None]
        torch.where(walk, B.acm, B.cmatch, out=B.cmatch)
        torch.where(walk, B.arm, B.rmatch, out=B.rmatch)

    def _phase_end(self, B: Buffers) -> None:
        B.phases.add_(B.phase_live)
        B.phase_live.copy_(B.next_live)

    def _finish(self, B: Buffers) -> None:
        B.certified.copy_(B.aug == 0)

    # -- the host loop --------------------------------------------------------
    def run(self, P: Program, every_step: bool = False) -> None:
        """The solve of every lane from its matching in ``cmatch`` /
        ``rmatch``; the host reads twice a phase in which a lane walks.
        ``every_step``: the walk's steps and the fallback's run in every
        phase, also where no lane walks (they leave such lanes as they
        were), so that each step runs, and on a card is captured."""
        B = P.buf
        B.phases.zero_()
        B.fallbacks.zero_()
        B.phase_live.fill_(1)
        while True:
            P.once(self.phase_begin)
            P.loop(self.level)
            P.once(self.bfs_end)
            walk, nxt = P.read("walk_any", "next_any")
            if walk or every_step:
                P.once(self.alt_begin)
                P.loop(self.alt)
                P.once(self.alt_end)
                if P.read("fb_any")[0] or every_step:
                    P.loop(self.alt)
                    P.once(self.fallback_end)
                P.once(self.commit)
            P.once(self.phase_end)
            if not nxt:
                break
        P.once(self.finish)
        if self.degrade:
            P.run_stages(DEGRADE)


class BatchProgram(MatcherProgram):
    """One ``"run_many"`` compile-cache entry: warm start ``stages`` (None:
    the states are given) and the batched solve of ``cfg`` for ``lanes``
    graphs of one size bucket, ``(nc, nr, nnz_pad)``.  The single-graph
    entry's buffers with a leading lane dimension, ``(lanes, n)``; a call
    copies its batch in, as the single-graph entry does."""

    def __init__(self, nc: int, nr: int, nnz_pad: int, lanes: int,
                 cfg: MatcherConfig, stages: Optional[Sequence]):
        self.lanes = (lanes,)
        super().__init__(nc, nr, nnz_pad, cfg, stages)

    def _solver(self, cfg: MatcherConfig) -> BatchSolver:
        return BatchSolver(cfg, self.nc, self.nr, self.lanes)

    def warm(self, graph) -> None:
        """One call on ``graph`` that runs every step of the entry
        (:meth:`BatchSolver.run` with ``every_step``), its result dropped:
        on a card every step is captured now, so that no later call
        captures."""
        P = self.program(graph.device)
        with P.lock:
            self.load(P, graph, None)
            P.run_stages(self.stages)
            self.solver.run(P, every_step=True)
            P.check()
