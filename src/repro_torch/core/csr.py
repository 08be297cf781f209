"""Bipartite graph container in CSR form, the paper's data layout (host side).

Column-major CSR (``cxadj``/``cadj``): for column ``c`` the adjacent rows are
``cadj[cxadj[c]:cxadj[c+1]]``.  The edge-parallel view ``ecol`` (the column
endpoint of every edge) makes a BFS level one dense pass over all edges.

All arrays are int32 and padded: padded edges point at the sentinel column
``nc`` and the sentinel row ``nr``.  The arrays, their padding and the
constructors are the same as the JAX package's host container, so the same
generator call yields the same graph in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

INT = np.int32

UNMATCHED = -1          # vertex not matched
ENDPOINT = -2           # row discovered as an augmenting-path endpoint (paper's -2)


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class BipartiteCSR:
    """Column-major CSR bipartite graph with an edge-parallel view.

    ``nc``/``nr``/``nnz`` are the true sizes; ``cxadj`` (nc+1,) the offsets;
    ``cadj``/``ecol`` (nnz_pad,) the row/column endpoint of every edge slot,
    sentinel ``nr``/``nc`` in the padding.
    """

    nc: int
    nr: int
    nnz: int
    cxadj: np.ndarray
    cadj: np.ndarray
    ecol: np.ndarray

    @property
    def nnz_pad(self) -> int:
        return int(self.cadj.shape[0])

    @staticmethod
    def from_csr(cxadj: np.ndarray, cadj: np.ndarray, nc: int, nr: int,
                 pad_to: Optional[int] = None, lane: int = 128) -> "BipartiteCSR":
        cxadj = np.asarray(cxadj, dtype=INT)
        cadj = np.asarray(cadj, dtype=INT)
        nnz = int(cadj.shape[0])
        assert cxadj.shape == (nc + 1,)
        assert cxadj[-1] == nnz
        npad = pad_to if pad_to is not None else max(lane, _round_up(nnz, lane))
        assert npad >= nnz
        degrees = np.diff(cxadj)
        ecol = np.repeat(np.arange(nc, dtype=INT), degrees)
        cadj_p = np.full(npad, nr, dtype=INT)
        ecol_p = np.full(npad, nc, dtype=INT)
        cadj_p[:nnz] = cadj
        ecol_p[:nnz] = ecol
        return BipartiteCSR(nc=nc, nr=nr, nnz=nnz, cxadj=cxadj, cadj=cadj_p,
                            ecol=ecol_p)

    @staticmethod
    def from_edges(cols: np.ndarray, rows: np.ndarray, nc: int, nr: int,
                   pad_to: Optional[int] = None) -> "BipartiteCSR":
        """Build from an unsorted edge list, deduplicating."""
        cols = np.asarray(cols, dtype=np.int64)
        rows = np.asarray(rows, dtype=np.int64)
        assert cols.shape == rows.shape
        keys = cols * np.int64(nr) + rows
        keys = np.unique(keys)
        cols = (keys // nr).astype(INT)
        rows = (keys % nr).astype(INT)
        order = np.argsort(cols, kind="stable")
        cols, rows = cols[order], rows[order]
        counts = np.bincount(cols, minlength=nc).astype(INT)
        cxadj = np.zeros(nc + 1, dtype=INT)
        np.cumsum(counts, out=cxadj[1:])
        return BipartiteCSR.from_csr(cxadj, rows, nc, nr, pad_to=pad_to)

    def to_scipy(self):
        import scipy.sparse as sp
        data = np.ones(self.nnz, dtype=np.int8)
        return sp.csr_matrix(
            (data, self.cadj[: self.nnz], self.cxadj), shape=(self.nc, self.nr)
        )

    def permuted(self, seed: int = 0) -> "BipartiteCSR":
        """Random row/column permutation — the paper's RCP instance transform."""
        rng = np.random.default_rng(seed)
        cperm = rng.permutation(self.nc).astype(INT)   # new id of old column
        rperm = rng.permutation(self.nr).astype(INT)
        cols = cperm[self.ecol[: self.nnz]]
        rows = rperm[self.cadj[: self.nnz]]
        return BipartiteCSR.from_edges(cols, rows, self.nc, self.nr,
                                       pad_to=self.nnz_pad)

    def transpose(self) -> "BipartiteCSR":
        """Row-major view (rxadj/radj) as a BipartiteCSR with roles swapped."""
        return BipartiteCSR.from_edges(self.cadj[: self.nnz],
                                       self.ecol[: self.nnz],
                                       self.nr, self.nc, pad_to=self.nnz_pad)


def validate_matching(g: BipartiteCSR, cmatch: np.ndarray,
                      rmatch: np.ndarray) -> int:
    """Check matching validity; return its cardinality.

    Raises ``AssertionError`` on the first violation, in the order a
    column-by-column then row-by-row scan meets it: a matched column's row
    out of range, an asymmetric pair, a matched non-edge, then a matched
    row whose column is out of range or does not point back.  Vectorized,
    so it checks graphs of tens of millions of edges in seconds.
    """
    cmatch = np.asarray(cmatch)[: g.nc].astype(np.int64)
    rmatch = np.asarray(rmatch)[: g.nr].astype(np.int64)
    cols = np.nonzero(cmatch != UNMATCHED)[0]
    r = cmatch[cols]
    bad_range = (r < 0) | (r >= g.nr)
    rc = np.clip(r, 0, max(g.nr - 1, 0))
    bad_sym = ~bad_range & (rmatch[rc] != cols) if g.nr else bad_range
    keys = (np.asarray(g.ecol[: g.nnz], np.int64) * g.nr
            + np.asarray(g.cadj[: g.nnz], np.int64))
    if keys.size and np.any(keys[1:] < keys[:-1]):
        keys = np.sort(keys)
    want = cols * np.int64(g.nr) + rc
    pos = np.minimum(np.searchsorted(keys, want), max(keys.size - 1, 0))
    is_edge = keys[pos] == want if keys.size else np.zeros(want.shape, bool)
    bad_edge = ~bad_range & ~bad_sym & ~is_edge
    bad = bad_range | bad_sym | bad_edge
    if np.any(bad):
        i = int(np.argmax(bad))
        c, rv = int(cols[i]), int(r[i])
        if bad_range[i]:
            raise AssertionError(f"cmatch[{c}]={rv} out of range")
        if bad_sym[i]:
            raise AssertionError(
                f"asymmetric match c={c} r={rv} rmatch[r]={rmatch[rv]}")
        raise AssertionError(f"matched non-edge ({c},{rv})")
    rows = np.nonzero(rmatch != UNMATCHED)[0]
    c = rmatch[rows]
    ok = (c >= 0) & (c < g.nc)
    ok &= cmatch[np.clip(c, 0, max(g.nc - 1, 0))] == rows if g.nc else ok
    if not np.all(ok):
        i = int(np.argmin(ok))
        raise AssertionError(f"asymmetric match r={int(rows[i])} c={int(c[i])}")
    return int(cols.size)


def is_maximal(g: BipartiteCSR, cmatch: np.ndarray, rmatch: np.ndarray
               ) -> bool:
    """True iff no edge joins a free column to a free row (the guarantee a
    phase-budget-truncated solve with ``degrade_maximal`` keeps)."""
    cmatch = np.asarray(cmatch)[: g.nc]
    rmatch = np.asarray(rmatch)[: g.nr]
    cols, rows = g.ecol[: g.nnz], g.cadj[: g.nnz]
    return not bool(np.any((cmatch[cols] == UNMATCHED)
                           & (rmatch[rows] == UNMATCHED)))
