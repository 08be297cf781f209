"""Sequential reference algorithms — the paper's comparison baselines.

* ``cheap_matching``  — the standard greedy initialization heuristic every
  algorithm in the paper starts from ([8]'s "cheap matching").
* ``hopcroft_karp``   — HK, O(sqrt(n)*tau): the sequential champion on the
  paper's original instances.
* ``pfp``             — Pothen–Fan with lookahead (PFP), the sequential
  champion on the permuted instances.

These run in plain numpy/python on the host and serve as (a) correctness
oracles for the device matchers (maximum cardinality is unique even though
the matching is not), and (b) the sequential baselines of the paper's
Tables 1–2 and Figures 3–5.  They are the JAX package's ``core.oracles``
line for line, over this package's host container, so both give the same
arrays.
"""
from __future__ import annotations

from collections import deque
from typing import Tuple

import numpy as np

from .csr import INT, UNMATCHED, BipartiteCSR

INF = np.iinfo(np.int32).max


def cheap_matching(g: BipartiteCSR) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy: match every column to its first unmatched neighbor row."""
    cmatch = np.full(g.nc, UNMATCHED, dtype=INT)
    rmatch = np.full(g.nr, UNMATCHED, dtype=INT)
    cxadj, cadj = g.cxadj, g.cadj
    for c in range(g.nc):
        for j in range(cxadj[c], cxadj[c + 1]):
            r = cadj[j]
            if rmatch[r] == UNMATCHED:
                rmatch[r] = c
                cmatch[c] = r
                break
    return cmatch, rmatch


def hopcroft_karp(g: BipartiteCSR, cmatch=None, rmatch=None) -> Tuple[np.ndarray, np.ndarray]:
    """Hopcroft–Karp with an optional warm-start matching."""
    if cmatch is None:
        cmatch = np.full(g.nc, UNMATCHED, dtype=INT)
        rmatch = np.full(g.nr, UNMATCHED, dtype=INT)
    else:
        cmatch, rmatch = cmatch.copy(), rmatch.copy()
    cxadj, cadj = g.cxadj, g.cadj
    nc = g.nc
    dist = np.zeros(nc, dtype=np.int64)

    def bfs() -> bool:
        q = deque()
        for c in range(nc):
            if cmatch[c] == UNMATCHED:
                dist[c] = 0
                q.append(c)
            else:
                dist[c] = INF
        found = INF
        while q:
            c = q.popleft()
            if dist[c] >= found:
                continue
            for j in range(cxadj[c], cxadj[c + 1]):
                r = cadj[j]
                c2 = rmatch[r]
                if c2 == UNMATCHED:
                    found = min(found, dist[c] + 1)
                elif dist[c2] == INF:
                    dist[c2] = dist[c] + 1
                    q.append(c2)
        return found != INF

    def dfs(c: int) -> bool:
        for j in range(cxadj[c], cxadj[c + 1]):
            r = cadj[j]
            c2 = rmatch[r]
            if c2 == UNMATCHED or (dist[c2] == dist[c] + 1 and dfs(c2)):
                cmatch[c] = r
                rmatch[r] = c
                return True
        dist[c] = INF
        return False

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, g.nc + g.nr + 100))
    try:
        while bfs():
            for c in range(nc):
                if cmatch[c] == UNMATCHED:
                    dfs(c)
    finally:
        sys.setrecursionlimit(old)
    return cmatch, rmatch


def pfp(g: BipartiteCSR, cmatch=None, rmatch=None) -> Tuple[np.ndarray, np.ndarray]:
    """Pothen–Fan: phase-wise disjoint DFS augmentation with lookahead.

    Iterative DFS (explicit stack) so deep paths do not overflow recursion.
    """
    if cmatch is None:
        cmatch = np.full(g.nc, UNMATCHED, dtype=INT)
        rmatch = np.full(g.nr, UNMATCHED, dtype=INT)
    else:
        cmatch, rmatch = cmatch.copy(), rmatch.copy()
    cxadj, cadj = g.cxadj, g.cadj
    nc = g.nc
    lookahead = g.cxadj[:-1].astype(np.int64).copy()   # per-column lookahead cursor
    visited_row = np.full(g.nr, -1, dtype=np.int64)    # phase stamp

    phase = 0
    while True:
        phase += 1
        augmented = 0
        for c0 in range(nc):
            if cmatch[c0] != UNMATCHED:
                continue
            # Iterative DFS from unmatched column c0.
            path_c = [c0]
            ptr = [cxadj[c0]]
            end_row = -1
            while path_c:
                c = path_c[-1]
                # 1) lookahead: any unmatched row directly adjacent?
                la = lookahead[c]
                hit = -1
                while la < cxadj[c + 1]:
                    r = cadj[la]
                    la += 1
                    if rmatch[r] == UNMATCHED:
                        hit = r
                        break
                lookahead[c] = la
                if hit >= 0:
                    end_row = hit
                    visited_row[hit] = phase
                    break
                # 2) advance DFS over matched rows not yet visited this phase
                j = ptr[-1]
                advanced = False
                while j < cxadj[c + 1]:
                    r = cadj[j]
                    j += 1
                    if visited_row[r] != phase and rmatch[r] != UNMATCHED:
                        visited_row[r] = phase
                        ptr[-1] = j
                        path_c.append(rmatch[r])
                        ptr.append(cxadj[rmatch[r]])
                        advanced = True
                        break
                if advanced:
                    continue
                path_c.pop()
                ptr.pop()
            if end_row >= 0:
                # augment along path_c; path rows recovered from matches
                r = end_row
                for c in reversed(path_c):
                    nxt = cmatch[c]
                    cmatch[c] = r
                    rmatch[r] = c
                    r = nxt
                augmented += 1
        if augmented == 0:
            break
    return cmatch, rmatch


def maximum_cardinality(g: BipartiteCSR) -> int:
    """Oracle cardinality via scipy's csgraph matching (independent code path)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import maximum_bipartite_matching

    m = sp.csr_matrix(
        (np.ones(g.nnz, dtype=np.int8), g.cadj[: g.nnz], g.cxadj),
        shape=(g.nc, g.nr),
    )
    match = maximum_bipartite_matching(m, perm_type="column")
    return int((match >= 0).sum())


def push_relabel(g: BipartiteCSR, cmatch=None, rmatch=None,
                 max_ops: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Push-relabel matching (the paper's second algorithm class [12, 16]).

    Kaya et al. (2012) style double-push: an unmatched column either grabs a
    free row or steals the row whose owner has the lowest height, relabels,
    and re-queues the evicted column. O(n*tau); used as a third sequential
    baseline in the benchmarks.
    """
    from collections import deque

    if cmatch is None:
        cmatch = np.full(g.nc, UNMATCHED, dtype=INT)
        rmatch = np.full(g.nr, UNMATCHED, dtype=INT)
    else:
        cmatch, rmatch = cmatch.copy(), rmatch.copy()
    cxadj, cadj = g.cxadj, g.cadj
    psi = np.zeros(g.nc, dtype=np.int64)             # heights
    limit = max_ops or 4 * (g.nc + 1) * max(1, g.nnz)
    q = deque(c for c in range(g.nc) if cmatch[c] == UNMATCHED)
    ops = 0
    while q and ops < limit:
        c = q.popleft()
        if cxadj[c] == cxadj[c + 1]:
            continue                                  # isolated column
        if psi[c] >= g.nc:
            continue      # height >= n: no augmenting path exists (standard
            #               push-relabel termination bound for matching)
        best_r, best_psi = -1, None
        done = False
        for j in range(cxadj[c], cxadj[c + 1]):
            ops += 1
            r = cadj[j]
            if rmatch[r] == UNMATCHED:
                cmatch[c] = r
                rmatch[r] = c
                done = True
                break
            h = psi[rmatch[r]]
            if best_psi is None or h < best_psi:
                best_psi, best_r = h, r
        if done:
            continue
        # double push: steal best_r, relabel, re-queue the evicted column
        c2 = rmatch[best_r]
        rmatch[best_r] = c
        cmatch[c] = best_r
        cmatch[c2] = UNMATCHED
        psi[c] = best_psi + 1
        psi[c2] += 1
        q.append(c2)
    return cmatch, rmatch
