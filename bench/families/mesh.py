"""The bipartite double cover of a 2-D mesh, with its diagonal.

``side`` s gives s^2 columns and rows; vertex v is joined to itself and to
its right, left, lower and upper neighbours: s^2 + 4 s (s - 1) edges, and a
perfect matching (the diagonal).  Augmenting paths are long, as in the
paper's Delaunay and road instances.  With ``rcp`` the columns and the
rows are relabelled by two permutations drawn from the seed, the paper's
random row/column permutation (RCP), which keeps the graph and its
maximum and takes its locality away.
"""
from __future__ import annotations

import torch


def edges(spec: dict, gen: torch.Generator, device):
    side = int(spec["side"])
    n = side * side
    idx = torch.arange(n, dtype=torch.int64, device=device).view(side, side)
    right, left = idx[:, :-1].reshape(-1), idx[:, 1:].reshape(-1)
    up, down = idx[:-1, :].reshape(-1), idx[1:, :].reshape(-1)
    diag = idx.reshape(-1)
    cols = torch.cat([diag, right, left, up, down])
    rows = torch.cat([diag, left, right, down, up])
    if spec.get("rcp"):
        cols = torch.randperm(n, generator=gen, device=device)[cols]
        rows = torch.randperm(n, generator=gen, device=device)[rows]
    return cols, rows, n, n
