"""The plain reference that decides ``correct``: is each returned matching a
maximum matching of the graph the benchmark made?

It reads the benchmark's own CSR arrays and the matching the program
returned, and judges the matching by its definition:

* ``bad_pairs``: matched entries that are not a pair of the graph, i.e. a
  partner out of range, a column and a row that do not point at each
  other, or a pair that is not an edge of the benchmark's edge list;
* ``aug_rows``: free rows that an alternating search from every free
  column reaches (column to row over an edge, row to column over its
  matched pair).  By Berge's theorem a valid matching is maximum exactly
  when no free row is reached, so 0 certifies the cardinality as the
  maximum.  The search stops at the first level that reaches one.

Answers are judged many at once: their graphs are laid side by side as one
graph (vertex ids offset), up to ``EDGE_BUDGET`` edges a block.  Each graph's
edge arrays go to the device once and serve every answer to it.  Plain
PyTorch, on whatever device it is given; it imports nothing of the program.
"""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np
import torch

EDGE_BUDGET = 1 << 26


def _blocks(items: Sequence, budget: int) -> Iterable[List]:
    block, edges = [], 0
    for it in items:
        if block and edges + it[0].nnz > budget:
            yield block
            block, edges = [], 0
        block.append(it)
        edges += it[0].nnz
    if block:
        yield block


def _range_faults(nc: int, nr: int, cm: np.ndarray, rm: np.ndarray
                  ) -> Tuple[int, np.ndarray, np.ndarray]:
    """Entries whose partner is out of range (or whose array has the wrong
    length), and the two arrays with those entries set free."""
    bad = 0
    if cm.shape != (nc,) or rm.shape != (nr,):
        return nc + nr, np.full(nc, -1, np.int64), np.full(nr, -1, np.int64)
    cm = cm.astype(np.int64)
    rm = rm.astype(np.int64)
    out_c = (cm < -1) | (cm >= nr)
    out_r = (rm < -1) | (rm >= nc)
    bad = int(out_c.sum() + out_r.sum())
    return bad, np.where(out_c, -1, cm), np.where(out_r, -1, rm)


def check_block(block, device, edges: dict) -> Tuple[int, int, int]:
    """``(bad_pairs, aug_rows, levels)`` of the answers ``block``, a list of
    ``(graph, cmatch, rmatch)``, judged as one graph on ``device``.
    ``edges``: each graph's int64 edge arrays on the device, by ``id``,
    filled as graphs come."""
    cols, rows, cms, rms = [], [], [], []
    oc = orr = 0
    bad = 0
    for g, cm, rm in block:
        b, cm, rm = _range_faults(g.nc, g.nr, np.asarray(cm), np.asarray(rm))
        bad += b
        if id(g) not in edges:
            edges[id(g)] = tuple(
                torch.from_numpy(np.asarray(a[: g.nnz], np.int64)).to(device)
                for a in (g.ecol, g.cadj))
        ec, ca = edges[id(g)]
        cols.append(ec + oc)
        rows.append(ca + orr)
        cms.append(np.where(cm >= 0, cm + orr, -1))
        rms.append(np.where(rm >= 0, rm + oc, -1))
        oc += g.nc
        orr += g.nr
    nc, nr = oc, orr
    put = lambda parts: torch.from_numpy(                     # noqa: E731
        np.concatenate(parts)).to(device)
    ecol, cadj, cm, rm = torch.cat(cols), torch.cat(rows), put(cms), put(rms)
    keys, _ = torch.sort(ecol * nr + cadj)

    # every matched column: its row points back, and the pair is an edge
    mc = torch.nonzero(cm >= 0).squeeze(1)
    r = cm[mc]
    mutual = rm[r] == mc
    want = mc * nr + r
    pos = torch.searchsorted(keys, want).clamp(max=max(keys.numel() - 1, 0))
    edge = (keys[pos] == want) if keys.numel() else torch.zeros_like(mutual)
    bad += int((~mutual).sum()) + int((mutual & ~edge).sum())
    # every matched row: its column points back
    mr = torch.nonzero(rm >= 0).squeeze(1)
    bad += int((cm[rm[mr]] != mr).sum())

    # the alternating search runs over the sound pairs only
    ok_c = torch.zeros(nc, dtype=torch.bool, device=device)
    ok_c[mc[mutual & edge]] = True
    partner = torch.full((nr,), -1, dtype=torch.int64, device=device)
    partner[cm[ok_c.nonzero().squeeze(1)]] = ok_c.nonzero().squeeze(1)
    seen_c = ~ok_c
    front = seen_c.clone()
    seen_r = torch.zeros(nr, dtype=torch.bool, device=device)
    levels = aug = 0
    while True:
        reach = cadj[front[ecol]]
        new_r = torch.zeros(nr, dtype=torch.bool, device=device)
        new_r[reach] = True
        new_r &= ~seen_r
        if not bool(new_r.any()):
            break
        levels += 1
        seen_r |= new_r
        aug = int((new_r & (partner < 0)).sum())
        if aug:
            break
        front = torch.zeros(nc, dtype=torch.bool, device=device)
        front[partner[new_r]] = True
        front &= ~seen_c
        seen_c |= front
    return bad, aug, levels


def check(answers: Sequence, device, budget: int = EDGE_BUDGET) -> dict:
    """Judge ``answers``, a list of ``(graph, cmatch, rmatch)``: the sums of
    ``bad_pairs`` and ``aug_rows`` over them, and the deepest search."""
    out = dict(bad_pairs=0, aug_rows=0, levels=0, answers=len(answers))
    edges: dict = {}
    for block in _blocks(answers, budget):
        bad, aug, levels = check_block(block, device, edges)
        out["bad_pairs"] += bad
        out["aug_rows"] += aug
        out["levels"] = max(out["levels"], levels)
    return out
