"""The port's graph side against the JAX package: host container, the
generators, ``TorchCSR`` against ``DeviceCSR`` field for field, structural
validation, and the vectorized ``validate_matching``.

Every comparison is exact (integer arrays, tolerance 0).  The port runs on
the CPU (``device="cpu"``), the JAX package with ``JAX_PLATFORMS=cpu``.
"""
import dataclasses
import functools

import numpy as np
import pytest

import repro.graphs as rg
from repro.core import validate_matching as ref_validate_matching
from repro.core.csr import BipartiteCSR as RefCSR
from repro.matching import DeviceCSR, MatcherConfig as RefConfig
from repro.matching import VARIANTS as REF_VARIANTS
from repro.matching.device_csr import (bucket_nnz as ref_bucket_nnz,
                                       validate_structure as ref_validate)

import repro_torch.graphs as tg
from repro_torch.core import BipartiteCSR, is_maximal, validate_matching
from repro_torch.matching import (VARIANTS, GraphValidationError,
                                  MatcherConfig, TorchCSR,
                                  validate_structure)
from repro_torch.matching.device_csr import bucket_nnz

MINI = tuple(rg.instance_sets("mini", rcp=True))


@functools.lru_cache(maxsize=None)
def _mini(rcp=True):
    return rg.instance_sets("mini", rcp=rcp)


def _host_equal(a, b):
    assert (a.nc, a.nr, a.nnz) == (b.nc, b.nr, b.nnz)
    for f in ("cxadj", "cadj", "ecol"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype == np.int32, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def _dev_equal(t: TorchCSR, d: DeviceCSR):
    assert (t.nc, t.nr, t.nnz, t.nnz_pad) == (d.nc, d.nr, int(d.nnz),
                                              d.nnz_pad)
    assert t.bucket_key == d.bucket_key
    for f in ("cxadj", "cadj", "ecol"):
        x = getattr(t, f)
        assert x.dtype.is_floating_point is False and str(x.dtype) == \
            "torch.int32", f
        np.testing.assert_array_equal(x.numpy(), np.asarray(getattr(d, f)),
                                      err_msg=f)


# ---------------------------------------------------------------------------
# generators: same seeds, same arrays
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rcp", [False, True])
def test_instance_sets_equal_reference(rcp):
    ours = tg.instance_sets("mini", rcp=rcp)
    ref = _mini(rcp)
    assert tuple(ours) == tuple(ref)
    for name in ref:
        _host_equal(ours[name], ref[name])


@pytest.mark.parametrize("call", [
    ("random_bipartite", (300, 200, 3.5), dict(seed=4, pad_to=2048)),
    ("kron_graph", (8, 6), dict(seed=9)),
    ("grid_graph", (9,), {}),
    ("scaled_free", (150, 170, 5.0), dict(seed=2)),
    ("banded", (120,), dict(band=4, density=0.3, seed=1)),
    ("community_graph", (200, 160), dict(blocks=5, avg_deg=3.0, seed=6)),
    ("comb_chain", (40,), dict(teeth=9, seed=3)),
], ids=lambda c: c[0])
def test_generators_equal_reference(call):
    name, args, kw = call
    _host_equal(getattr(tg, name)(*args, **kw), getattr(rg, name)(*args, **kw))


def test_csr_transforms_equal_reference():
    g = rg.random_bipartite(90, 70, 3.0, seed=8)
    ours = BipartiteCSR(g.nc, g.nr, g.nnz, g.cxadj, g.cadj, g.ecol)
    _host_equal(ours.permuted(5), g.permuted(5))
    _host_equal(ours.transpose(), g.transpose())
    _host_equal(BipartiteCSR.from_csr(g.cxadj, g.cadj[: g.nnz], g.nc, g.nr,
                                      pad_to=1000),
                RefCSR.from_csr(g.cxadj, g.cadj[: g.nnz], g.nc, g.nr,
                                pad_to=1000))
    assert (ours.to_scipy() != g.to_scipy()).nnz == 0


# ---------------------------------------------------------------------------
# TorchCSR == DeviceCSR, through every shape operation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", MINI)
def test_torch_csr_equals_device_csr(name):
    g = _mini()[name]
    t = TorchCSR.from_host(g, device="cpu")
    d = DeviceCSR.from_host(g)
    _dev_equal(t, d)
    _dev_equal(t.pad_to(t.nnz_pad + 384), d.pad_to(d.nnz_pad + 384))
    _dev_equal(t.bucketed(), d.bucketed())
    _dev_equal(t.pad_vertices(g.nc + 7, g.nr + 3),
               d.pad_vertices(g.nc + 7, g.nr + 3))
    _dev_equal(t.bucketed().pad_vertices(g.nc + 1, g.nr + 9),
               d.bucketed().pad_vertices(g.nc + 1, g.nr + 9))
    _dev_equal(TorchCSR.from_host(g, pad_to=g.nnz + 5, device="cpu"),
               DeviceCSR.from_host(g, pad_to=g.nnz + 5))
    _host_equal(t.to_host(), d.to_host())
    assert t.validate() is t


def test_bucket_nnz_equals_reference():
    for n in (0, 1, 127, 128, 129, 1000, 4096, 4097, 10**6):
        assert bucket_nnz(n) == ref_bucket_nnz(n)
        assert bucket_nnz(n, 256) == ref_bucket_nnz(n, 256)


def _corruptions():
    g = rg.random_bipartite(40, 30, 3.0, seed=2)
    n = g.nnz

    def mut(**arrays):
        out = dict(cxadj=g.cxadj.copy(), cadj=g.cadj.copy(),
                   ecol=g.ecol.copy(), nnz=n, nc=g.nc, nr=g.nr)
        for k, fn in arrays.items():
            out[k] = fn(out[k])
        return out

    def setat(i, v):
        def f(a):
            a = a.copy()
            a[i] = v
            return a
        return f

    return {
        "valid": mut(),
        "cxadj_shape": mut(cxadj=lambda a: a[:-1]),
        "ecol_shape": mut(ecol=lambda a: a[:-1]),
        "nnz_range": mut(nnz=lambda v: g.nnz_pad + 1),
        "cxadj_start": mut(cxadj=setat(0, 1)),
        "not_monotone": mut(cxadj=setat(5, 0)),
        "cxadj_end": mut(cxadj=setat(-1, n - 1)),
        "row_range": mut(cadj=setat(3, g.nr + 2)),
        "row_negative": mut(cadj=setat(0, -1)),
        "col_range": mut(ecol=setat(2, g.nc)),
        "col_disagrees": mut(ecol=setat(n - 1, 0)),
        "pad_row": mut(cadj=setat(n, 0)),
        "pad_col": mut(ecol=setat(n + 1, 1)),
    }


@pytest.mark.parametrize("case", list(_corruptions()))
def test_validate_structure_finds_same_problems(case):
    a = _corruptions()[case]
    ours = validate_structure(a["cxadj"], a["cadj"], a["ecol"], a["nnz"],
                              a["nc"], a["nr"])
    ref = ref_validate(a["cxadj"], a["cadj"], a["ecol"], a["nnz"], a["nc"],
                       a["nr"])
    assert ours == ref
    assert bool(ours) == (case != "valid")
    if case in ("valid", "cxadj_shape", "ecol_shape", "nnz_range"):
        return
    t = TorchCSR.from_host(rg.random_bipartite(40, 30, 3.0, seed=2),
                           device="cpu")
    import torch
    t = dataclasses.replace(t, cxadj=torch.from_numpy(a["cxadj"]),
                            cadj=torch.from_numpy(a["cadj"]),
                            ecol=torch.from_numpy(a["ecol"]))
    with pytest.raises(GraphValidationError) as ei:
        t.validate()
    assert ei.value.problems == ref


# ---------------------------------------------------------------------------
# the vectorized validate_matching agrees with the loop version
# ---------------------------------------------------------------------------
def _matchings():
    g = rg.random_bipartite(60, 50, 3.0, seed=11)
    rng = np.random.default_rng(0)
    cm = np.full(g.nc, -1, np.int32)
    rm = np.full(g.nr, -1, np.int32)
    for e in rng.permutation(g.nnz):           # a greedy valid matching
        c, r = int(g.ecol[e]), int(g.cadj[e])
        if cm[c] == -1 and rm[r] == -1:
            cm[c], rm[r] = r, c
    c0 = int(np.nonzero(cm >= 0)[0][0])
    r0 = int(cm[c0])
    free_c = int(np.nonzero(cm == -1)[0][0])
    free_r = int(np.nonzero(rm == -1)[0][0])
    nonedge = next(r for r in range(g.nr) if rm[r] == -1 and
                   r not in set(g.cadj[g.cxadj[free_c]:g.cxadj[free_c + 1]]))
    cases = {"valid": (cm, rm), "empty": (np.full(g.nc, -1), np.full(g.nr, -1))}

    def edit(cm_ed=(), rm_ed=()):
        a, b = cm.copy(), rm.copy()
        for i, v in cm_ed:
            a[i] = v
        for i, v in rm_ed:
            b[i] = v
        return a, b

    cases["col_out_of_range"] = edit([(free_c, g.nr)])
    cases["col_endpoint_mark"] = edit([(free_c, -2)])
    cases["asymmetric_col"] = edit(rm_ed=[(r0, free_c)])
    cases["non_edge"] = edit([(free_c, nonedge)], [(nonedge, free_c)])
    cases["row_out_of_range"] = edit(rm_ed=[(free_r, g.nc + 4)])
    cases["row_dangling"] = edit(rm_ed=[(free_r, free_c)])
    cases["row_negative"] = edit(rm_ed=[(free_r, -2)])
    return g, cases


@pytest.mark.parametrize("case", list(_matchings()[1]))
def test_validate_matching_agrees_with_reference(case):
    g, cases = _matchings()
    cm, rm = cases[case]
    ours_g = BipartiteCSR(g.nc, g.nr, g.nnz, g.cxadj, g.cadj, g.ecol)
    try:
        want = ref_validate_matching(g, cm, rm)
    except AssertionError as e:
        with pytest.raises(AssertionError) as ei:
            validate_matching(ours_g, cm, rm)
        assert str(ei.value) == str(e)
        assert case not in ("valid", "empty")
        return
    assert case in ("valid", "empty")
    assert validate_matching(ours_g, cm, rm) == want
    assert is_maximal(ours_g, cm, rm) == (case == "valid")


def test_validate_matching_unsorted_edges():
    """Edge slots in any order (not the sorted CSR a generator emits)."""
    g = tg.random_bipartite(50, 40, 3.0, seed=5)
    perm = np.random.default_rng(1).permutation(g.nnz)
    shuffled = dataclasses.replace(g, cadj=g.cadj[perm], ecol=g.ecol[perm])
    cm = np.full(g.nc, -1, np.int32)
    rm = np.full(g.nr, -1, np.int32)
    c, r = int(g.ecol[perm[0]]), int(g.cadj[perm[0]])
    cm[c], rm[r] = r, c
    assert validate_matching(shuffled, cm, rm) == 1


# ---------------------------------------------------------------------------
# the config mirror cannot drift
# ---------------------------------------------------------------------------
def test_config_fields_mirror_reference():
    ours = [(f.name, f.default) for f in dataclasses.fields(MatcherConfig)]
    ref = [(f.name, f.default) for f in dataclasses.fields(RefConfig)]
    assert ours == ref
    assert [v.name for v in VARIANTS] == [v.name for v in REF_VARIANTS]
    assert [dataclasses.astuple(v) for v in VARIANTS] == \
        [dataclasses.astuple(v) for v in REF_VARIANTS]
    for n, auto in ((10, 0), (5000, 0), (10**6, 0), (10, 33)):
        assert MatcherConfig.resolve_cap(auto, n) == RefConfig.resolve_cap(
            auto, n)
    assert MatcherConfig.resolve_dmax(0) == RefConfig.resolve_dmax(0)
    assert MatcherConfig().canonical().pallas_interpret is False
