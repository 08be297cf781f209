"""The port's host oracles and warm-start wrappers against the JAX package's.

``repro_torch.core.oracles`` (greedy cheap matching, Hopcroft–Karp,
Pothen–Fan, push-relabel, scipy's cardinality) must return the reference's
arrays, element for element, on every mini and tiny family, its RCP twin
and the committed ``.mtx`` fixture: they are the oracle behind every
correctness claim of the port, and the card host has no JAX to run the
reference's.  Hopcroft–Karp is also run warm-started from the greedy
matching, and its cardinality must be scipy's.  ``cheap_matching_torch``
and ``karp_sipser_torch`` (the numpy wrappers of the device warm starts,
run on the CPU) must equal the reference's ``*_jax`` wrappers bit for bit.
"""
import functools

import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.graphs import instance_sets as ref_instance_sets
from repro.graphs import mtx_fixture as ref_mtx_fixture

from repro_torch.core import (cheap_matching, cheap_matching_torch,
                              hopcroft_karp, karp_sipser_torch,
                              maximum_cardinality, pfp, push_relabel,
                              validate_matching)
from repro_torch.graphs import INSTANCE_FAMILIES, instance_sets, mtx_fixture

# push-relabel is O(n * tau) in Python: the tiny families run it to this
# many edge visits (the reference's own ``max_ops`` budget), the others to
# the end
TINY_PUSH_RELABEL_OPS = 50_000

CASES = ([("mini", f) for f in INSTANCE_FAMILIES]
         + [("mini", f"{f}_rcp") for f in INSTANCE_FAMILIES]
         + [("tiny", f) for f in INSTANCE_FAMILIES]
         + [("tiny", f"{f}_rcp") for f in INSTANCE_FAMILIES]
         + [("fixture", "ufl_tiny"), ("fixture", "ufl_tiny_rcp")])
# the wrappers' cases: mini and the fixture (tiny adds nothing a warm start
# would show)
WRAPPER_CASES = CASES[:18] + CASES[-2:]


@functools.lru_cache(maxsize=None)
def _sets(scale):
    if scale == "fixture":
        return ({"ufl_tiny": mtx_fixture(),
                 "ufl_tiny_rcp": mtx_fixture().permuted(13)},
                {"ufl_tiny": ref_mtx_fixture(),
                 "ufl_tiny_rcp": ref_mtx_fixture().permuted(13)})
    return (instance_sets(scale, rcp=True),
            ref_instance_sets(scale, rcp=True))


def _pair(scale, name):
    ours, ref = _sets(scale)
    return ours[name], ref[name]


def _same(got, want, what):
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == np.asarray(b).dtype, (what, i)
        np.testing.assert_array_equal(a, np.asarray(b),
                                      err_msg=f"{what}[{i}]")


@pytest.mark.parametrize("scale,name", CASES,
                         ids=[f"{s}-{n}" for s, n in CASES])
def test_oracles_equal_reference(scale, name):
    g, rg = _pair(scale, name)
    _same(cheap_matching(g), ref_core.cheap_matching(rg), "cheap_matching")
    hk = hopcroft_karp(g)
    _same(hk, ref_core.hopcroft_karp(rg), "hopcroft_karp")
    warm = cheap_matching(g)
    _same(hopcroft_karp(g, *warm),
          ref_core.hopcroft_karp(rg, *ref_core.cheap_matching(rg)),
          "hopcroft_karp from cheap_matching")
    _same(pfp(g), ref_core.pfp(rg), "pfp")
    ops = TINY_PUSH_RELABEL_OPS if scale == "tiny" else 0
    _same(push_relabel(g, max_ops=ops),
          ref_core.push_relabel(rg, max_ops=ops), "push_relabel")
    want = maximum_cardinality(g)
    assert want == ref_core.maximum_cardinality(rg)
    # HK is maximum: scipy's cardinality, cold and warm-started alike
    assert validate_matching(g, *hk) == want
    assert validate_matching(g, *hopcroft_karp(g, *warm)) == want
    assert validate_matching(g, *pfp(g)) == want


@pytest.mark.parametrize("scale,name", WRAPPER_CASES,
                         ids=[f"{s}-{n}" for s, n in WRAPPER_CASES])
def test_warm_start_wrappers_equal_reference(scale, name):
    g, rg = _pair(scale, name)
    _same(cheap_matching_torch(g, device="cpu"),
          ref_core.cheap_matching_jax(rg), "cheap_matching_torch")
    _same(karp_sipser_torch(g, device="cpu"),
          ref_core.karp_sipser_jax(rg), "karp_sipser_torch")


def test_wrappers_default_to_the_card():
    """No device named: the CUDA card, which this host may not have."""
    g = instance_sets("mini")["rand"]
    if torch.cuda.is_available():
        cm, _ = cheap_matching_torch(g)
        assert cm.shape == (g.nc,)
        return
    for fn in (cheap_matching_torch, karp_sipser_torch):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            fn(g)
