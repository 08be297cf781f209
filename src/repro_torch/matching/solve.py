"""Eager PyTorch solver for the paper's GPU matching algorithms (APFB / APsB).

The same algorithm, step for step, as the JAX package's ``solve.py``, so
both return the same matching bit for bit:

* a BFS level is one edge-parallel sweep producing a per-row winner vector
  (the lowest proposing column: the paper's "first writer wins" race made
  deterministic), folded into the BFS state by :func:`_apply_winner`.  On a
  CUDA graph the sweep is the hand-written kernel; on a CPU graph it is
  the kernel's plain PyTorch version (:mod:`repro_torch.kernels.
  frontier_expand`);
* ``ALTERNATE`` (Alg. 3) walks all augmenting paths in lock-step;
* ``FIXMATCHING`` repairs both directions, so every phase ends valid;
* a cardinality guard re-runs ``ALTERNATE`` with a single walker if the
  speculative phase gained nothing.

Where the JAX solver is one compiled ``lax.while_loop`` program, this one
is Python loops over device tensors: each loop test reads one device value
(a host sync), the BFS level is a Python int the loop owns, and a
``lax.cond`` becomes a Python ``if`` on a synced value.  :data:`COUNTERS`
counts the BFS levels, the ``ALTERNATE`` steps and the host syncs.

Indexing rules.  Every gather is ``index_select`` and every scatter
``scatter``/``scatter_reduce``/``index_fill``/``index_add_``, with int64
indices and int32 values.  Unlike JAX, which clamps or drops an
out-of-range index, these raise on the CPU (and fault on the card), so the
clamps of the reference are all kept and the CPU tests show that no index
leaves its range.

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

from repro_torch.kernels.frontier_expand import frontier_expand_fused

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
    """Plain counts of the eager solver's work, beside the kernel's
    launch counts: BFS levels, ``ALTERNATE`` steps, and host syncs (each
    read of a device value that the host loop waits for)."""

    levels: int = 0
    alternate_steps: int = 0
    host_syncs: int = 0

    def reset(self) -> None:
        self.levels = self.alternate_steps = self.host_syncs = 0

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


def check_ported(cfg: MatcherConfig) -> None:
    """Refuse the configs whose sweep path this package does not carry
    yet, naming the slice of the port that brings it."""
    if cfg.dirop:
        raise NotImplementedError(
            "MatcherConfig(dirop=True) needs the CSC mirror and the pull "
            "kernel, which come in slice 3 of the port (ROADMAP.md)")
    if cfg.adaptive_frontier:
        raise NotImplementedError(
            "MatcherConfig(adaptive_frontier=True) comes in slice 3 of the "
            "port (ROADMAP.md)")
    if cfg.use_pallas and not cfg.pallas_fused:
        raise NotImplementedError(
            "MatcherConfig(use_pallas=True, pallas_fused=False) is the legacy "
            "two-step kernel path, which comes in slice 2 of the port "
            "(ROADMAP.md)")


def scatter_min(n: int, index: torch.Tensor, values: torch.Tensor
                ) -> torch.Tensor:
    """Deterministic "first writer wins": per-slot min over proposals.

    ``index`` may use slot ``n`` as the discard sentinel; the sentinel slot
    is reset to the identity so it never reads back as a winner.
    """
    out = torch.full((n + 1,), IINF, dtype=I32, device=values.device)
    out.scatter_reduce_(0, index.long(), values, "amin", include_self=True)
    out[n] = IINF
    return out


def level0_state(cmatch: torch.Tensor):
    """BFS state at the paper's start level for a given matching: ``bfs``
    (unmatched columns are L0 roots, matched UNVISITED, sentinel NEG) and
    ``root`` (own index if root, else ``nc``)."""
    nc = cmatch.shape[0] - 1
    matched = cmatch >= 0
    bfs = torch.full_like(cmatch, L0).masked_fill_(matched, UNVISITED)
    bfs[nc] = NEG
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
def _winner_full(ecol, cadj, bfs, root, rmatch, level: int) -> torch.Tensor:
    """Dense O(nnz) sweep -> per-row winner vector (nr+1,).  The kernel on
    a CUDA graph, its plain version on a CPU graph; ``use_pallas`` plays no
    part (both of the reference's branches give these winners)."""
    return frontier_expand_fused(ecol, cadj, bfs, root, rmatch, level)


def _apply_winner(winner, bfs, root, pred, rmatch, level: int, *, wr: bool,
                  wr_exact: bool):
    """Fold a per-row winner vector into the BFS state (the paper's Alg. 2
    lines 8-17 / Alg. 4 lines 11-18).

    Returns ``(bfs, root, pred, rmatch, vertex_inserted, aug_found)``, the
    last two as 0-d device bools.  The reference's ``.at[i].set`` becomes
    ``index_fill``/``scatter``, whose order on duplicate indices is
    unspecified; it cannot matter here: the visited rows' matched columns
    are distinct (``rmatch`` is a valid matching during a phase), and every
    other row writes the sentinel slot ``nc`` with one common value.
    """
    nc = bfs.shape[0] - 1
    nr = pred.shape[0] - 1
    upd_r = winner < IINF                                 # (nr+1,) rows reached

    pred = torch.where(upd_r, winner, pred)
    cm_r = rmatch                                         # row-wise matched col
    visit_r = upd_r & (cm_r >= 0)                         # Alg.2 l.8-12
    end_r = upd_r & (cm_r == -1)                          # Alg.2 l.14-17

    vidx = torch.where(visit_r, cm_r, nc).long()
    bfs = bfs.index_fill(0, vidx, level + 1)
    if wr:
        rootvals = root.index_select(0, winner.clamp(0, nc).long())
        root = root.scatter(0, vidx, torch.where(visit_r, rootvals, 0))
        # mark the root "satisfied": plain WR writes L0-2, the exact variant
        # encodes the endpoint row as -(r+1) so ALTERNATE can start only the
        # winning endpoint of each tree (paper Sec. 3, last paragraph).
        if wr_exact:
            enc = -(_arange(nr + 1, winner) + 1)
        else:
            enc = torch.full((nr + 1,), FOUND, dtype=I32,
                             device=winner.device)
        bfs = bfs.scatter_reduce(0, torch.where(end_r, rootvals, nc).long(),
                                 torch.where(end_r, enc, IINF), "amin",
                                 include_self=True)
    rmatch = torch.where(end_r, -2, rmatch)
    bfs[nc] = NEG                                         # restore sentinel

    return bfs, root, pred, rmatch, visit_r.any(), end_r.any()


def _expand_level(ecol, cadj, bfs, root, pred, rmatch, level: int, *,
                  wr: bool, wr_exact: bool):
    """One level-synchronous frontier expansion. Returns updated state."""
    winner = _winner_full(ecol, cadj, bfs, root if wr else None, rmatch,
                          level)
    return _apply_winner(winner, bfs, root, pred, rmatch, level, wr=wr,
                         wr_exact=wr_exact)


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
    """Build the matcher ``(ecol, cadj, cmatch, rmatch) -> (cmatch, rmatch,
    phases, fallbacks, certified)``; the last three are Python values.

    ``certified`` is True iff the final phase's BFS proved no augmenting
    path remains (the matching is maximum, Berge).  A run cut short by a
    positive ``cfg.max_phases`` budget returns ``certified=False``; with
    ``cfg.degrade_maximal`` the matching is then made maximal by one greedy
    augmentation round.  Raises ``NotImplementedError`` for a config whose
    sweep path is not ported (:func:`check_ported`).
    """
    check_ported(cfg)
    wr = cfg.kernel == "gpubfs_wr"

    def match_fn(ecol, cadj, cmatch, rmatch):
        nc = cmatch.shape[0] - 1
        nr = rmatch.shape[0] - 1

        def phase_bfs(cmatch, rmatch):
            """Inner loop of Alg. 1: level-synchronous BFS to exhaustion or
            first hit."""
            bfs, root = level0_state(cmatch)
            pred = torch.full((nr + 1,), nc, dtype=I32, device=cmatch.device)
            level, ins, aug, aug_lvl = L0, True, False, IINF

            def go():
                if cfg.algo == "apsb":
                    return ins and not aug               # Alg.1 l.9-10 break
                if cfg.tail_levels > 0:
                    # bounded tail: at most tail_levels past the first
                    # augmenting level (beyond-paper, see MatcherConfig)
                    return ins and level <= aug_lvl + cfg.tail_levels
                return ins

            while go():
                bfs, root, pred, rmatch, ins_t, aug_t = _expand_level(
                    ecol, cadj, bfs, root, pred, rmatch, level, wr=wr,
                    wr_exact=cfg.wr_exact)
                ins, aug_l = (bool(v) for v in _sync(ins_t, aug_t))
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
                endpoint = torch.where(enc <= -1, -(enc + 1), nr)
                wins = torch.zeros(nr + 1, dtype=torch.bool,
                                   device=bfs.device)
                wins = wins.index_fill(0, endpoint.long(), True)
                wins[nr] = False
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
