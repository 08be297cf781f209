"""The port's Matrix Market loader against the JAX package's.

``load_mtx`` and ``mtx_fixture`` must give the reference's graph field for
field (``cxadj``, ``cadj``, ``ecol``, ``nc``, ``nr``, ``nnz``, ``nnz_pad``),
with and without ``pad_to``, on the committed fixture and on files in the
other layouts a SuiteSparse download arrives in (symmetric storage, the
dense array format, a rectangular pattern with stored values).  The port's
fixture is byte for byte the reference's.
"""
import os

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp

import repro.graphs as ref_graphs
from repro.graphs import mtx as ref_mtx

from repro_torch.graphs import load_mtx, mtx_fixture
from repro_torch.graphs import mtx as port_mtx

FIELDS = ("cxadj", "cadj", "ecol", "nc", "nr", "nnz", "nnz_pad")


def _same(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f


def test_fixture_bytes_equal_reference():
    ours = os.path.join(port_mtx.FIXTURE_DIR, "ufl_tiny.mtx")
    ref = os.path.join(ref_mtx.FIXTURE_DIR, "ufl_tiny.mtx")
    assert os.path.abspath(ours) != os.path.abspath(ref)
    with open(ours, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("pad_to", [None, 64, 512])
def test_mtx_fixture_equals_reference(pad_to):
    g = mtx_fixture(pad_to=pad_to)
    _same(g, ref_graphs.mtx_fixture(pad_to=pad_to))
    assert (g.nc, g.nr, g.nnz) == (14, 16, 30)
    assert g.nnz_pad == (pad_to or 128)


def _write(path, kind):
    rng = np.random.default_rng(3)
    if kind == "symmetric":
        a = sp.random(40, 40, density=0.08, random_state=4, format="coo")
        a = sp.triu(a + a.T).tocoo()
        scipy.io.mmwrite(path, a, symmetry="symmetric")
    elif kind == "array":
        dense = (rng.random((9, 7)) < 0.3) * rng.integers(1, 5, (9, 7))
        scipy.io.mmwrite(path, dense.astype(np.float64))
    else:                                  # rectangular, real values, zeros
        a = sp.random(25, 60, density=0.05, random_state=5, format="coo")
        a.data[::4] = 0.0                  # explicit stored zeros stay edges
        scipy.io.mmwrite(path, a)


@pytest.mark.parametrize("pad_to", [None, 1024])
@pytest.mark.parametrize("kind", ["symmetric", "rectangular"])
def test_load_mtx_equals_reference(tmp_path, kind, pad_to):
    path = str(tmp_path / f"{kind}.mtx")
    _write(path, kind)
    g = load_mtx(path, pad_to=pad_to)
    _same(g, ref_graphs.load_mtx(path, pad_to=pad_to))
    assert g.nnz > 0 and (pad_to is None or g.nnz_pad == pad_to)


@pytest.mark.parametrize("pad_to", [None, 1024])
def test_load_mtx_array_format(tmp_path, pad_to):
    """The dense array format: its nonzero entries are the pattern, the
    graph the reference loads from the same matrix in coordinate form (the
    reference's loader raises on the array file itself)."""
    path = str(tmp_path / "array.mtx")
    _write(path, "array")
    coo = str(tmp_path / "array_as_coordinate.mtx")
    scipy.io.mmwrite(coo, sp.coo_matrix(scipy.io.mmread(path)))
    g = load_mtx(path, pad_to=pad_to)
    _same(g, ref_graphs.load_mtx(coo, pad_to=pad_to))
    assert (g.nc, g.nr) == (7, 9) and g.nnz > 0
    with pytest.raises(AttributeError):
        ref_graphs.load_mtx(path)
