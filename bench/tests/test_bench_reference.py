"""The reference is right on graphs of known maximum: a comb chain whose
greedy matching leaves one long augmenting path, a mesh with a perfect
matching, and small random graphs against scipy's Hopcroft-Karp."""
import numpy as np
import pytest
import torch

from bench import graphs, reference


def _graph(cols, rows, nc, nr):
    return graphs.to_csr(torch.as_tensor(cols), torch.as_tensor(rows),
                         nc, nr)


def comb(length):
    """Columns 0..length-1 see rows {i, i+1}; column ``length`` sees row 0.
    Matching column i to row i leaves column ``length`` free with one
    augmenting path through every column; shifting (i to i+1, ``length``
    to 0) is perfect."""
    cols = list(np.repeat(np.arange(length), 2)) + [length]
    rows = [r for i in range(length) for r in (i, i + 1)] + [0]
    return _graph(cols, rows, length + 1, length + 1)


def judge(g, cm, rm, budget=reference.EDGE_BUDGET):
    return reference.check([(g, np.asarray(cm), np.asarray(rm))], "cpu",
                           budget)


def test_comb_greedy_is_caught_and_the_shift_is_maximum():
    n = 40
    g = comb(n)
    greedy = judge(g, list(range(n)) + [-1], list(range(n)) + [-1])
    assert greedy["bad_pairs"] == 0 and greedy["aug_rows"] == 1
    assert greedy["levels"] == n + 1          # the path crosses every row
    shift_c = list(range(1, n + 1)) + [0]
    shift_r = [n] + list(range(n))
    best = judge(g, shift_c, shift_r)
    assert best["bad_pairs"] == 0 and best["aug_rows"] == 0


def test_mesh_diagonal_is_maximum_and_each_fault_is_caught():
    g = graphs.make_pool(dict(family="mesh", side=8, pool=1),
                         graphs.generator(0, "cpu"), "cpu")[0]
    diag = np.arange(g.nc)
    assert judge(g, diag, diag) == dict(bad_pairs=0, aug_rows=0, levels=0,
                                        answers=1)
    short_c, short_r = diag.copy(), diag.copy()
    short_c[5] = short_r[5] = -1
    assert judge(g, short_c, short_r)["aug_rows"] > 0
    swapped = diag.copy()
    swapped[[0, 63]] = swapped[[63, 0]]        # (0, 63) is not an edge
    assert judge(g, swapped, swapped)["bad_pairs"] > 0
    one_sided = diag.copy()
    one_sided[3] = -1                          # row 3 still points at 3
    assert judge(g, one_sided, diag)["bad_pairs"] > 0
    out = diag.copy()
    out[7] = g.nr + 5
    assert judge(g, out, diag)["bad_pairs"] > 0
    assert judge(g, diag[:-1], diag)["bad_pairs"] > 0


@pytest.mark.parametrize("seed", range(6))
def test_agrees_with_scipy_on_random_graphs(seed):
    sp = pytest.importorskip("scipy.sparse")
    csgraph = pytest.importorskip("scipy.sparse.csgraph")
    rng = np.random.default_rng(seed)
    nc, nr, m = 60, 70, 120
    g = _graph(rng.integers(0, nc, m), rng.integers(0, nr, m), nc, nr)
    a = sp.csr_matrix((np.ones(g.nnz), g.cadj[: g.nnz], g.cxadj),
                      shape=(nc, nr))
    best = csgraph.maximum_bipartite_matching(a, perm_type="column")
    rm = np.full(nr, -1)
    rm[best[best >= 0]] = np.nonzero(best >= 0)[0]
    assert judge(g, best, rm)["aug_rows"] == 0
    # greedy in column order: valid, and short of scipy's exactly when
    # the reference finds an augmenting path
    cm, rm = np.full(nc, -1), np.full(nr, -1)
    for c in range(nc):
        for r in g.cadj[g.cxadj[c]:g.cxadj[c + 1]]:
            if rm[r] < 0:
                cm[c], rm[r] = r, c
                break
    out = judge(g, cm, rm)
    assert out["bad_pairs"] == 0
    assert (out["aug_rows"] > 0) == ((cm >= 0).sum() < (best >= 0).sum())


def test_blocks_judge_as_one():
    pool = graphs.make_pool(dict(family="kron", scale=6, edge_factor=8,
                                 pool=5), graphs.generator(4, "cpu"), "cpu")
    free = [(g, np.full(g.nc, -1), np.full(g.nr, -1)) for g in pool]
    whole = reference.check(free, "cpu")
    split = reference.check(free, "cpu", budget=pool[0].nnz)
    assert whole["aug_rows"] > 0 and split["aug_rows"] >= whole["aug_rows"]
    assert whole["bad_pairs"] == split["bad_pairs"] == 0
