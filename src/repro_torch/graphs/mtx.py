"""Matrix Market loader: real SuiteSparse/UFL instances enter the corpus.

The paper's evaluation set is 70 UFL sparse matrices (plus RCP-permuted
copies).  :func:`load_mtx` turns any ``.mtx`` file into a
:class:`~repro_torch.core.csr.BipartiteCSR`: matrix columns become column
vertices, matrix rows become row vertices (the paper matches the columns of
A onto its rows), values are ignored, since only the sparsity pattern
matters for cardinality matching.  Explicit stored zeros are kept as edges,
as the UFL pattern collection treats them.

``fixtures/`` holds one tiny committed instance, so the loader and the
corpus built on it run without network access; pointing :func:`load_mtx` at
a downloaded SuiteSparse file is the production path.  The JAX package's
loader reads the same files into the same arrays.
"""
from __future__ import annotations

import os

from repro_torch.core.csr import BipartiteCSR

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures")


def load_mtx(path: str, pad_to=None) -> BipartiteCSR:
    """Load a Matrix Market (coordinate or array) file as a bipartite graph.

    Symmetric storage is expanded by scipy, so a symmetric UFL matrix yields
    the same edge set as its ``general`` form; duplicate entries collapse in
    ``from_edges``.  The array format stores every entry, so there the
    pattern is the nonzero entries.  (The JAX package's loader reads the
    coordinate format alike and raises on the array format.)
    """
    import scipy.sparse as sp
    from scipy.io import mmread

    m = mmread(path)
    m = m.tocoo() if sp.issparse(m) else sp.coo_matrix(m)
    nr, nc = (int(s) for s in m.shape)
    return BipartiteCSR.from_edges(m.col, m.row, nc, nr, pad_to=pad_to)


def mtx_fixture(name: str = "ufl_tiny", pad_to=None) -> BipartiteCSR:
    """A committed fixture instance from ``fixtures/<name>.mtx``."""
    return load_mtx(os.path.join(FIXTURE_DIR, f"{name}.mtx"), pad_to=pad_to)
