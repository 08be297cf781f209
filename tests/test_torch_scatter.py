"""``scatter_kept`` against the sentinel-slot scatters it replaced.

The solver and the warm starts once sent every entry that does not take
part in a scatter to one sentinel slot (index ``n``, or the value IINF),
then sealed that slot.  ``scatter_kept`` sends those entries to no shared
slot.  Here each old form is copied as it was and held against the helper
on seeded inputs, tolerance 0: duplicates, every entry masked, none masked,
``n = 0`` and IINF values.  Then a fixed small solve per solve path must
count the host syncs, BFS levels and ``ALTERNATE`` steps it counted before
the change.
"""
import numpy as np
import pytest
import torch

from repro_torch.graphs import instance_sets, kron_graph, random_bipartite
from repro_torch.matching import SOLVE_PATHS, MatcherConfig
from repro_torch.matching.solve import (COUNTERS, IINF, scatter_kept,
                                        scatter_min)

I32 = torch.int32


# ---- the sentinel-slot forms, as they were --------------------------------
def sentinel_scatter_min(n, index, values):
    out = torch.full((n + 1,), IINF, dtype=I32)
    out.scatter_reduce_(0, index.long(), values, "amin", include_self=True)
    out[n] = IINF
    return out


def sentinel_reduce(out, index, values, keep, reduce, fill):
    """``keep`` entries at ``index``; the rest carry ``fill`` to the last
    slot, which is then sealed to what it held."""
    n = out.shape[0] - 1
    got = out.scatter_reduce(0, torch.where(keep, index, n).long(),
                             torch.where(keep, values, fill), reduce,
                             include_self=True)
    got[n] = out[n]
    return got


def sentinel_index_add(out, index, keep):
    n = out.shape[0] - 1
    got = out.clone().index_add_(0, torch.where(keep, index, n).long(),
                                 torch.ones(index.shape[0], dtype=I32))
    got[n] = out[n]
    return got


def sentinel_index_fill(out, index, value, keep):
    n = out.shape[0] - 1
    got = out.index_fill(0, torch.where(keep, index, n).long(), value)
    got[n] = out[n]
    return got


def sentinel_scatter(out, index, values, keep):
    n = out.shape[0] - 1
    got = out.scatter(0, torch.where(keep, index, n).long(),
                      torch.where(keep, values, out[n]))
    got[n] = out[n]
    return got


# ---- the inputs -----------------------------------------------------------
def _case(kind, n, m, seed):
    """(index in [0, n], values in [0, IINF], keep) of one kind."""
    rng = np.random.default_rng(seed)
    index = rng.integers(0, n + 1, size=m)
    values = rng.integers(0, IINF + 1, size=m)
    keep = rng.random(m) < 0.5
    if kind == "duplicates":            # a few hot slots, many writers each
        index = rng.integers(0, min(n + 1, 4), size=m)
    elif kind == "all_masked":
        keep[:] = False
    elif kind == "none_masked":
        keep[:] = True
    elif kind == "iinf_values":
        values[rng.random(m) < 0.5] = IINF
    return (torch.from_numpy(index.astype(np.int64)),
            torch.from_numpy(values.astype(np.int32)),
            torch.from_numpy(keep))


KINDS = ["random", "duplicates", "all_masked", "none_masked", "iinf_values"]
# (n, m): more entries than slots, fewer, and n = 0 (the sentinel alone)
SIZES = [(40, 500), (300, 50), (0, 30), (7, 0)]


@pytest.mark.parametrize("n,m", SIZES)
@pytest.mark.parametrize("kind", KINDS)
def test_scatter_min_equals_sentinel_form(kind, n, m):
    index, values, keep = _case(kind, n, m, seed=n + m)
    # the callers' form: the sentinel index n or the value IINF for an
    # entry that does not take part
    index = torch.where(keep, index, n)
    got = scatter_min(n, index, values)
    assert torch.equal(got, sentinel_scatter_min(n, index, values))
    assert int(got[n]) == IINF


@pytest.mark.parametrize("n,m", SIZES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("reduce,fill", [("amin", IINF), ("amax", -1)])
def test_reductions_equal_sentinel_form(kind, n, m, reduce, fill):
    index, values, keep = _case(kind, n, m, seed=3 * n + m)
    out = torch.from_numpy(np.random.default_rng(n).integers(
        -1, IINF, size=n + 1).astype(np.int32))
    out[n] = -3
    # an entry that takes part writes a real slot, as at every call site
    keep &= index < n
    got = scatter_kept(out, index, values, keep, reduce)
    assert torch.equal(got, sentinel_reduce(out, index, values, keep,
                                            reduce, fill))
    assert int(got[n]) == -3


@pytest.mark.parametrize("n,m", SIZES)
@pytest.mark.parametrize("kind", KINDS)
def test_sum_equals_sentinel_index_add(kind, n, m):
    index, _, keep = _case(kind, n, m, seed=5 * n + m)
    keep &= index < n
    out = torch.zeros(n + 1, dtype=I32)
    got = scatter_kept(out, index, 1, keep, "sum")
    assert torch.equal(got, sentinel_index_add(out, index, keep))
    assert int(got.sum()) == int(keep.sum())


def _distinct_case(kind, n, m, seed):
    """A plain write takes distinct indices among its kept entries, as at
    every call site (a valid matching's partners)."""
    _, values, keep = _case(kind, n, m, seed)
    perm = np.random.default_rng(seed).permutation(max(n, m))[:m]
    index = torch.from_numpy(perm.astype(np.int64)).clamp(max=n)
    return index, values, keep & (index < n)


@pytest.mark.parametrize("n,m", SIZES)
@pytest.mark.parametrize("kind", ["random", "all_masked", "none_masked"])
def test_plain_writes_equal_sentinel_forms(kind, n, m):
    index, values, keep = _distinct_case(kind, n, m, seed=7 * n + m)
    out = torch.from_numpy(np.random.default_rng(m).integers(
        -1, 50, size=n + 1).astype(np.int32))
    out[n] = -3
    got = scatter_kept(out, index, values, keep)
    assert torch.equal(got, sentinel_scatter(out, index, values, keep))
    got = scatter_kept(out, index, 9, keep)
    assert torch.equal(got, sentinel_index_fill(out, index, 9, keep))
    flags = torch.zeros(n + 1, dtype=torch.bool)
    got = scatter_kept(flags, index, True, keep)
    assert torch.equal(got, sentinel_index_fill(flags, index, True, keep))
    assert got.shape == (n + 1,) and int(out[n]) == -3


def test_out_is_not_changed():
    out = torch.arange(10, dtype=I32)
    idx = torch.tensor([1, 2, 3])
    keep = torch.tensor([True, False, True])
    val = torch.tensor([-5, -6, -7], dtype=I32)
    for reduce in (None, "amin", "amax", "sum"):
        scatter_kept(out, idx, val, keep, reduce)
    assert torch.equal(out, torch.arange(10, dtype=I32))
    assert scatter_kept(out, idx, val, keep, "amin").tolist() == \
        [0, -5, 2, -7, 4, 5, 6, 7, 8, 9]


# ---- the solver's counts, before and after the change --------------------
# (host syncs, ALTERNATE steps, levels, push / pull / compact levels,
# phases, fallbacks), as the sentinel-slot solver counted them; the host
# syncs are those of the device loops: the BFS verdict of each phase and
# the guard of each phase that augments, 2 * phases - 1, on every path
_CASES = {
    "rand": (lambda: random_bipartite(400, 360, 3.0, seed=5), {}, "cheap"),
    "kron": (lambda: kron_graph(9, 8, seed=3), dict(kernel="gpubfs"),
             "karp_sipser"),
    "sparse": (lambda: instance_sets("mini")["sparse"],
               dict(algo="apsb", wr_exact=True), "cheap"),
}
_PINNED = {
    ("rand", "jnp"): (7, 17, 34, 34, 0, 0, 4, 0),
    ("rand", "legacy"): (7, 17, 34, 34, 0, 0, 4, 0),
    ("rand", "fused"): (7, 17, 34, 34, 0, 0, 4, 0),
    ("rand", "adaptive"): (7, 17, 34, 10, 0, 24, 4, 0),
    ("rand", "dirop"): (7, 17, 34, 34, 0, 0, 4, 0),
    ("rand", "dirop_pallas"): (7, 17, 34, 3, 31, 0, 4, 0),
    ("kron", "jnp"): (1, 0, 5, 5, 0, 0, 1, 0),
    ("kron", "legacy"): (1, 0, 5, 5, 0, 0, 1, 0),
    ("kron", "fused"): (1, 0, 5, 5, 0, 0, 1, 0),
    ("kron", "adaptive"): (1, 0, 5, 3, 0, 2, 1, 0),
    ("kron", "dirop"): (1, 0, 5, 5, 0, 0, 1, 0),
    ("kron", "dirop_pallas"): (1, 0, 5, 2, 3, 0, 1, 0),
    ("sparse", "jnp"): (17, 47, 64, 64, 0, 0, 9, 0),
    ("sparse", "legacy"): (17, 47, 64, 64, 0, 0, 9, 0),
    ("sparse", "fused"): (17, 47, 64, 64, 0, 0, 9, 0),
    ("sparse", "adaptive"): (17, 47, 64, 1, 0, 63, 9, 0),
    ("sparse", "dirop"): (17, 47, 64, 64, 0, 0, 9, 0),
    ("sparse", "dirop_pallas"): (17, 47, 64, 50, 14, 0, 9, 0),
}


@pytest.mark.parametrize("case,path", sorted(_PINNED))
def test_solver_counts_unchanged(case, path):
    make, kw, ws = _CASES[case]
    COUNTERS.reset()
    st = SOLVE_PATHS[path].solve(make(), MatcherConfig(**kw), ws,
                                 device="cpu")
    c = COUNTERS
    assert (c.host_syncs, c.alternate_steps, c.levels, c.push_levels,
            c.pull_levels, c.compact_levels, int(st.phases),
            int(st.fallbacks)) == _PINNED[case, path]
    assert bool(st.certified)
