"""Synthetic bipartite instance families standing in for the UFL collection.

The paper evaluates on 70 UFL sparse matrices spanning road networks
(italy_osm, europe_osm), Delaunay meshes, social/web graphs (soc-LiveJournal,
wikipedia), Kronecker graphs (kron_g500) and linear-programming matrices, plus
randomly row/column-permuted copies (RCP sets) that destroy locality and make
the problems harder for augmenting-path algorithms.

Offline we reproduce the same *structure classes*:

* ``random_bipartite`` — Erdos-Renyi-like sparse matrices (LP-style),
* ``kron_graph``       — RMAT/Kronecker power-law (kron_g500-style),
* ``grid_graph``       — 2-D mesh adjacency (road/Delaunay-style: long paths),
* ``scaled_free``      — heavy-tail degree columns (web/social-style),
* ``banded``           — banded LP/PDE matrices,
* ``community_graph``  — stochastic-block bipartite (clustered social-style),
* ``comb_chain``       — adversarial single long augmenting path (the BFS
  worst case: one phase whose search tree is ``O(n)`` levels deep),

``BipartiteCSR.permuted()`` provides the RCP transform, and
:func:`instance_sets` bundles one instance per family at every scale
(``rcp=True`` adds the permuted twins) so per-family gates compare like to
like across scales.  Real UFL/SuiteSparse matrices enter through the
Matrix Market loader, :mod:`.mtx`.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.csr import BipartiteCSR


def random_bipartite(nc: int, nr: int, avg_deg: float, seed: int = 0,
                     pad_to=None) -> BipartiteCSR:
    """Uniform random bipartite graph with ~avg_deg edges per column."""
    rng = np.random.default_rng(seed)
    nnz = int(nc * avg_deg)
    cols = rng.integers(0, nc, size=nnz)
    rows = rng.integers(0, nr, size=nnz)
    return BipartiteCSR.from_edges(cols, rows, nc, nr, pad_to=pad_to)


# edges a chunk of kron_graph's quadrant tests: their temporaries stay in
# the cache, where whole-array passes over 2^25 edges went to memory
_KRON_CHUNK = 1 << 16


def kron_graph(scale: int, edge_factor: int = 8, seed: int = 0,
               pad_to=None) -> BipartiteCSR:
    """RMAT/Kronecker bipartite graph (Graph500 parameters a,b,c=.57,.19,.19).

    One uniform draw per edge and bit, bit by bit, as the JAX package's
    generator draws them, so both give the same graph."""
    n = 1 << scale
    nnz = n * edge_factor
    rng = np.random.default_rng(seed)
    a, b, c = 0.57, 0.19, 0.19
    ids = np.uint32 if scale <= 32 else np.uint64
    cols = np.zeros(nnz, dtype=ids)
    rows = np.zeros(nnz, dtype=ids)
    u = np.empty(nnz)
    for bit in range(scale):
        rng.random(out=u)
        for s in range(0, nnz, _KRON_CHUNK):
            uc = u[s:s + _KRON_CHUNK]
            # quadrant probabilities: (0,0)=a, (0,1)=b, (1,0)=c, (1,1)=d;
            # the row bit is u >= a+b+c in the column's upper half, else
            # a <= u (< a+b)
            cbit = uc >= a + b
            rbit = np.where(cbit, uc >= a + b + c, uc >= a)
            cols[s:s + _KRON_CHUNK] |= cbit.astype(ids) << bit
            rows[s:s + _KRON_CHUNK] |= rbit.astype(ids) << bit
    return BipartiteCSR.from_edges(cols, rows, n, n, pad_to=pad_to)


def grid_graph(side: int, pad_to=None) -> BipartiteCSR:
    """Bipartite double cover of a 2-D grid — long augmenting paths, like the
    paper's road/Delaunay instances (the hard cases for BFS matchers)."""
    n = side * side
    idx = np.arange(n).reshape(side, side)
    cols_l: List[np.ndarray] = [np.arange(n)]
    rows_l: List[np.ndarray] = [np.arange(n)]          # self edge (diagonal)
    right_c = idx[:, :-1].ravel()
    right_r = idx[:, 1:].ravel()
    down_c = idx[:-1, :].ravel()
    down_r = idx[1:, :].ravel()
    cols_l += [right_c, right_r, down_c, down_r]
    rows_l += [right_r, right_c, down_r, down_c]
    cols = np.concatenate(cols_l)
    rows = np.concatenate(rows_l)
    return BipartiteCSR.from_edges(cols, rows, n, n, pad_to=pad_to)


def scaled_free(nc: int, nr: int, avg_deg: float, alpha: float = 1.8,
                seed: int = 0, pad_to=None) -> BipartiteCSR:
    """Power-law column degrees (web/social-matrix style)."""
    rng = np.random.default_rng(seed)
    w = rng.zipf(alpha, size=nc).astype(np.float64)
    w = np.minimum(w, nr // 2)
    w *= (nc * avg_deg) / w.sum()
    degs = np.maximum(1, rng.poisson(w)).astype(np.int64)
    cols = np.repeat(np.arange(nc, dtype=np.int64), degs)
    rows = rng.integers(0, nr, size=int(degs.sum()))
    return BipartiteCSR.from_edges(cols, rows, nc, nr, pad_to=pad_to)


def community_graph(nc: int, nr: int, blocks: int = 8, avg_deg: float = 4.0,
                    p_in: float = 0.9, seed: int = 0,
                    pad_to=None) -> BipartiteCSR:
    """Bipartite stochastic-block graph (community-structured social-style).

    Columns and rows are split into ``blocks`` aligned groups; each edge
    stays inside its column's row-group with probability ``p_in`` and lands
    uniformly at random otherwise.  RCP permutation destroys exactly this
    block locality, which is what makes the paper's RCP sets harder.
    """
    assert 1 <= blocks <= min(nc, nr), (blocks, nc, nr)
    rng = np.random.default_rng(seed)
    nnz = int(nc * avg_deg)
    cols = rng.integers(0, nc, size=nnz)
    cblk = cols * blocks // nc
    r_lo = cblk * nr // blocks
    r_hi = (cblk + 1) * nr // blocks
    row_in = r_lo + (rng.random(nnz) * (r_hi - r_lo)).astype(np.int64)
    row_out = rng.integers(0, nr, size=nnz)
    rows = np.where(rng.random(nnz) < p_in, row_in, row_out)
    return BipartiteCSR.from_edges(cols, rows, nc, nr, pad_to=pad_to)


def comb_chain(length: int, teeth: int = 0, seed: int = 0,
               pad_to=None) -> BipartiteCSR:
    """Adversarial long-augmenting-path "comb" (worst case for BFS matchers).

    A chain of ``length+1`` columns over ``length+1`` spine rows:

    * column 0 sees rows {0, 1}; column i (0<i<length) sees {i, i+1};
    * column ``length`` sees only row 0.

    The sequential cheap/greedy init (which always picks the lowest free row)
    matches column i to row i, leaving column ``length`` unmatched — and the
    *only* augmenting path left is c_len→r_0→c_0→r_1→…→c_{len-1}→r_len, of
    length ``2*length+1``.  One BFS phase must therefore run ``O(length)``
    level iterations: the deep-search stressor the paper's road instances
    approximate.  ``teeth`` extra free rows (ids above the spine, so the
    greedy init ignores them) inflate the pull-side degree mass the
    direction-optimizing heuristic reads; they attach only to columns in the
    last quarter of the spine — a free tooth row on an early column would
    short-circuit the alternating tree and collapse the BFS depth, so this
    keeps the shortest augmenting path at ``>= 3*length/4`` levels.
    """
    assert length >= 1
    cols_l = [np.repeat(np.arange(length, dtype=np.int64), 2),
              np.asarray([length], dtype=np.int64)]
    spine = np.arange(length, dtype=np.int64)
    rows_l = [np.stack([spine, spine + 1], axis=1).ravel(),
              np.asarray([0], dtype=np.int64)]
    nr = length + 1 + teeth
    if teeth:
        rng = np.random.default_rng(seed)
        tooth_deg = 4
        lo = max(0, (3 * length) // 4)
        cols_l.append(rng.integers(lo, length, size=teeth * tooth_deg))
        rows_l.append(np.repeat(np.arange(length + 1, nr, dtype=np.int64),
                                tooth_deg))
    return BipartiteCSR.from_edges(np.concatenate(cols_l),
                                   np.concatenate(rows_l),
                                   length + 1, nr, pad_to=pad_to)


# one parameter tuple per scale; every scale instantiates the SAME families
# (keys below) so per-family gate rows compare like to like across scales.
# n = square-family vertex count, rect = (nc, nr), kron = log2 scale,
# grid = side, comb = chain length (BFS depth ~ 2*comb).
_SCALE_PARAMS = {
    "mini":  dict(n=256, deg=4.0, rect=(192, 320), kron=7, grid=12,
                  free_deg=5.0, sparse_deg=2.5, band=3, blocks=4, comb=64,
                  teeth=16),
    "tiny":  dict(n=1024, deg=4.0, rect=(768, 1280), kron=10, grid=24,
                  free_deg=6.0, sparse_deg=2.5, band=4, blocks=8, comb=192,
                  teeth=48),
    "small": dict(n=16384, deg=5.0, rect=(12288, 20480), kron=14, grid=96,
                  free_deg=8.0, sparse_deg=2.5, band=6, blocks=16, comb=2048,
                  teeth=512),
    "large": dict(n=1 << 18, deg=5.0, rect=(3 << 16, 5 << 16), kron=17,
                  grid=384, free_deg=8.0, sparse_deg=2.5, band=8, blocks=32,
                  comb=8192, teeth=2048),
}

INSTANCE_FAMILIES = ("rand", "sparse", "rand_rect", "band", "kron", "grid",
                     "free", "community", "comb")


def instance_sets(scale: str = "small", rcp: bool = False,
                  rcp_seed: int = 13) -> Dict[str, BipartiteCSR]:
    """Named instance suite: one instance per family, same families at every
    scale (:data:`INSTANCE_FAMILIES`).

    ``scale``: "mini" (fast unit tests), "tiny" (tests), "small" (CI
    benchmarks), "large" (full bench).  ``rcp=True`` appends a
    ``<family>_rcp`` row/column-permuted twin per family — the paper's RCP
    sets, which destroy locality without changing the matching number.
    """
    if scale not in _SCALE_PARAMS:
        raise ValueError(scale)
    p = _SCALE_PARAMS[scale]
    n = p["n"]
    out = {
        "rand": random_bipartite(n, n, p["deg"], seed=1),
        "sparse": random_bipartite(n, n, p["sparse_deg"], seed=5),
        "rand_rect": random_bipartite(*p["rect"], p["deg"] + 1.0, seed=2),
        "band": banded(n, band=p["band"], density=0.5, seed=6),
        "kron": kron_graph(p["kron"], 8, seed=3),
        "grid": grid_graph(p["grid"]),
        "free": scaled_free(n, n, p["free_deg"], seed=4),
        "community": community_graph(n, n, blocks=p["blocks"],
                                     avg_deg=p["deg"], seed=7),
        "comb": comb_chain(p["comb"], teeth=p["teeth"], seed=8),
    }
    if rcp:
        out.update({f"{k}_rcp": g.permuted(rcp_seed)
                    for k, g in tuple(out.items())})
    return out


def banded(n: int, band: int = 5, density: float = 0.6, seed: int = 0,
           pad_to=None) -> BipartiteCSR:
    """Banded matrix (LP/PDE-style UFL class): edges within |c-r| <= band."""
    rng = np.random.default_rng(seed)
    offs = np.arange(-band, band + 1)
    cols_l, rows_l = [np.arange(n)], [np.arange(n)]   # keep the diagonal
    for off in offs:
        if off == 0:
            continue
        c = np.arange(max(0, -off), min(n, n - off))
        r = c + off
        keep = rng.random(c.shape[0]) < density
        cols_l.append(c[keep])
        rows_l.append(r[keep])
    return BipartiteCSR.from_edges(np.concatenate(cols_l),
                                   np.concatenate(rows_l), n, n,
                                   pad_to=pad_to)
