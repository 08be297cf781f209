"""Plain PyTorch versions of the frontier-expansion kernel.

Semantics (one BFS level of the paper's Alg. 2 / Alg. 4, proposal half):
for every edge e = (c, r):
  active  = bfs[c] == level            (and, WR: bfs[root[c]] >= L0-1)
  propose = active and ( (rmatch[r] >= 0 and bfs[rmatch[r]] == L0-1)
                         or rmatch[r] == -1 )
  out[e]  = c if propose else IINF

:func:`frontier_expand_ref` is that proposal sweep alone (the legacy
proposal kernel's contract); :func:`frontier_expand_fused_ref` composes it
with the deterministic per-row min-merge ("first writer wins" = lowest
proposing column), which is the fused kernel's contract: a ``(nr+1,)``
winner vector with IINF in every unreached row and in the trailing sentinel
slot.  :func:`frontier_expand_pull_ref` is the pull kernel's: the same
winners over the row-sorted CSC mirror.  :func:`frontier_bits_ref` is the
pull kernel's column pass: the ``active`` half above, once per column,
packed 32 columns to an int32 word.

These run on any device.  The CPU path of the solver uses them, and the
chip check holds the CUDA kernel against them.  ``level`` is a Python int
or a 0-d int32 tensor; ``gate`` (the sweeps', optional) a 0-d tensor that,
where 0, leaves no proposal and no winner, as a gated-off kernel does.
Like the kernel, they skip an edge slot whose column is outside [0, nc]
or whose row is outside [0, nr], and a column whose root is outside
[0, nc]: such a slot proposes nothing, so a malformed graph gives the
same winners on either device.

Lanes: each also takes a batch of B graphs, every array ``(B, n)`` and
``level`` / ``gate`` ``(B,)`` tensors (``level`` may stay one int), as the
batched kernels do; every gather and scatter runs along the last dimension,
so lane ``l``'s result is the single-graph result on lane ``l``'s arrays.
"""
from __future__ import annotations

import torch

UNVISITED = 1
IINF = 2**30


def _per_lane(v, like: torch.Tensor):
    """``level`` or ``gate`` shaped to broadcast against ``like``'s lanes:
    a ``(B,)`` tensor becomes ``(B, 1)``; an int or a 0-d tensor stays."""
    if isinstance(v, torch.Tensor) and like.dim() == 2:
        return v.reshape(-1, 1)
    return v


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` lane by lane (an int64 index)."""
    return torch.gather(x, -1, idx.long())


def frontier_expand_ref(ecol, cadj, bfs, root, rmatch, level, gate=None):
    nc, nr = bfs.shape[-1] - 1, rmatch.shape[-1] - 1
    ok = (ecol >= 0) & (ecol <= nc) & (cadj >= 0) & (cadj <= nr)
    if gate is not None:
        ok &= _per_lane(gate, ecol) != 0
    ecol_l = torch.where(ok, ecol, nc)
    active = ok & (_take(bfs, ecol_l) == _per_lane(level, ecol))
    if root is not None:
        myroot = _take(root, ecol_l)
        active &= (myroot >= 0) & (myroot <= nc)
        active &= _take(bfs, myroot.clamp(0, nc)) >= UNVISITED
    cm = _take(rmatch, torch.where(ok, cadj, nr))
    col_unvis = _take(bfs, cm.clamp(0, nc)) == UNVISITED
    target = active & (((cm >= 0) & col_unvis) | (cm == -1))
    return torch.where(target, ecol, IINF)


def frontier_expand_fused_ref(ecol, cadj, bfs, root, rmatch, level,
                              gate=None):
    """Proposals + per-row min-merge: the fused kernel's plain version."""
    nr = rmatch.shape[-1] - 1
    prop = frontier_expand_ref(ecol, cadj, bfs, root, rmatch, level, gate)
    rows = torch.where(prop < IINF, cadj, nr).long()
    win = torch.full(prop.shape[:-1] + (nr + 1,), IINF, dtype=torch.int32,
                     device=prop.device)
    win.scatter_reduce_(-1, rows, prop, "amin", include_self=True)
    win[..., nr:].fill_(IINF)
    return win


def frontier_expand_pull_ref(radj, erow, bfs, root, rmatch, level,
                             gate=None):
    """Proposals + per-row min-merge over the row-sorted (CSC) edge view:
    the pull kernel's plain version.  The predicate is per edge and min is
    the merge, so this is the fused plain version on permuted arrays, and
    it skips the same out-of-range slots."""
    return frontier_expand_fused_ref(radj, erow, bfs, root, rmatch, level,
                                     gate)


def frontier_bits_ref(bfs, root, level):
    """The column half of the predicate for every column c in [0, nc],
    packed: bit ``c & 31`` of word ``c >> 5`` is ``bfs[c] == level`` (and,
    WR, ``root[c]`` in [0, nc] with ``bfs[root[c]] >= UNVISITED``).
    ``ceil((nc+1)/32)`` int32 words (a lane); the bits past column nc are
    0."""
    nc = bfs.shape[-1] - 1
    lanes = tuple(bfs.shape[:-1])
    on = bfs == _per_lane(level, bfs)
    if root is not None:
        on &= (root >= 0) & (root <= nc)
        on &= _take(bfs, root.clamp(0, nc)) >= UNVISITED
    n_words = (nc + 32) // 32
    flat = torch.zeros(lanes + (n_words * 32,), dtype=torch.int64,
                       device=bfs.device)
    flat[..., :nc + 1].copy_(on)
    weights = torch.ones(32, dtype=torch.int64, device=bfs.device) << \
        torch.arange(32, device=bfs.device)
    words = (flat.view(lanes + (n_words, 32)) * weights).sum(-1)  # [0, 2^32)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
