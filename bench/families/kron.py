"""Graph500 Kronecker (RMAT) graphs as symmetric matrices, drawn on the device.

``scale`` s gives 2^s vertices and ``edge_factor`` * 2^s edge draws (the
Graph500 specification's edge factor is 16); each draw picks one quadrant
per bit with the Graph500 probabilities A, B, C = 0.57, 0.19, 0.19
(D = 0.05).  One uniform draw per edge and bit, a bit at a time (``scale``
calls of ``torch.rand`` over every edge).  Graph500's graph is undirected,
so its adjacency matrix, which the matcher reads as a bipartite graph of
2^s columns and 2^s rows, holds each drawn edge both ways: (c, r) and
(r, c).  Self-loops stay as diagonal entries; duplicates are dropped when
the CSR is built.  The vertex labels are not scrambled as Graph500's
generator scrambles them.
"""
from __future__ import annotations

import torch

A, B, C = 0.57, 0.19, 0.19


def edges(spec: dict, gen: torch.Generator, device):
    scale, factor = int(spec["scale"]), int(spec["edge_factor"])
    n = 1 << scale
    m = n * factor
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    for bit in range(scale):
        u = torch.rand(m, generator=gen, device=device)
        sbit = u >= A + B
        dbit = torch.where(sbit, u >= A + B + C, u >= A)
        src |= sbit.to(torch.int64) << bit
        dst |= dbit.to(torch.int64) << bit
        del u, sbit, dbit
    return torch.cat([src, dst]), torch.cat([dst, src]), n, n
