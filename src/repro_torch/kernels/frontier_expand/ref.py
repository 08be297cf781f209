"""Plain PyTorch versions of the frontier-expansion kernel.

Semantics (one BFS level of the paper's Alg. 2 / Alg. 4, proposal half):
for every edge e = (c, r):
  active  = bfs[c] == level            (and, WR: bfs[root[c]] >= L0-1)
  propose = active and ( (rmatch[r] >= 0 and bfs[rmatch[r]] == L0-1)
                         or rmatch[r] == -1 )
  out[e]  = c if propose else IINF

:func:`frontier_expand_ref` is that proposal sweep alone;
:func:`frontier_expand_fused_ref` composes it with the deterministic per-row
min-merge ("first writer wins" = lowest proposing column), which is the
fused kernel's contract: a ``(nr+1,)`` winner vector with IINF in every
unreached row and in the trailing sentinel slot.

These run on any device.  The CPU path of the solver uses them, and the
chip check holds the CUDA kernel against them.  Like the kernel, they skip
an edge slot whose column is outside [0, nc] or whose row is outside
[0, nr], and a column whose root is outside [0, nc]: such a slot proposes
nothing, so a malformed graph gives the same winners on either device.
"""
from __future__ import annotations

import torch

UNVISITED = 1
IINF = 2**30


def frontier_expand_ref(ecol, cadj, bfs, root, rmatch, level):
    nc, nr = bfs.shape[0] - 1, rmatch.shape[0] - 1
    ok = (ecol >= 0) & (ecol <= nc) & (cadj >= 0) & (cadj <= nr)
    ecol_l = torch.where(ok, ecol, nc).long()
    active = ok & (bfs.index_select(0, ecol_l) == level)
    if root is not None:
        myroot = root.index_select(0, ecol_l)
        active &= (myroot >= 0) & (myroot <= nc)
        active &= bfs.index_select(0, myroot.clamp(0, nc).long()) >= UNVISITED
    cm = rmatch.index_select(0, torch.where(ok, cadj, nr).long())
    col_unvis = bfs.index_select(0, cm.clamp(0, nc).long()) == UNVISITED
    target = active & (((cm >= 0) & col_unvis) | (cm == -1))
    return torch.where(target, ecol, IINF)


def frontier_expand_fused_ref(ecol, cadj, bfs, root, rmatch, level):
    """Proposals + per-row min-merge: the fused kernel's plain version."""
    nr = rmatch.shape[0] - 1
    prop = frontier_expand_ref(ecol, cadj, bfs, root, rmatch, level)
    rows = torch.where(prop < IINF, cadj, nr).long()
    win = torch.full((nr + 1,), IINF, dtype=torch.int32, device=prop.device)
    win.scatter_reduce_(0, rows, prop, "amin", include_self=True)
    win[nr] = IINF
    return win
