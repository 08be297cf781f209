"""Carrying state across: a graph and a matching state made by the JAX
package, handed over as numpy leaves, resume in the port and give the JAX
resume's result bit for bit; and the port's state goes back the same way."""
import jax
import numpy as np
import pytest

from repro.graphs import instance_sets
from repro.matching import DeviceCSR, Matcher as RefMatcher
from repro.matching import MatcherConfig as RefConfig

from repro_torch.interop import (csr_from_reference, csr_to_reference,
                                 state_from_reference, state_to_reference)
from repro_torch.matching import Matcher, MatcherConfig, TorchCSR


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("ws", ["cheap", "karp_sipser"])
@pytest.mark.parametrize("family", ["rand", "free", "grid"])
def test_resume_from_jax_warm_start(family, ws):
    g = instance_sets("mini", rcp=True)[family + "_rcp"]
    d = DeviceCSR.from_host(g).bucketed()
    ref_m = RefMatcher(RefConfig(), ws)
    warm = ref_m.init(d)
    want = RefMatcher(RefConfig()).run(d, warm)

    graph = csr_from_reference(_leaves(d), d.nc, d.nr, device="cpu")
    state = state_from_reference(_leaves(warm), device="cpu")
    out = Matcher(MatcherConfig()).run(graph, state)
    for a, b in zip(state_to_reference(out), _leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # and back: the port's result unflattens into a JAX MatchState
    back = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(want), state_to_reference(out))
    assert int(back.cardinality) == int(want.cardinality)


def test_resume_truncated_jax_solve():
    """A phase-budget-truncated JAX solve finishes in the port."""
    g = instance_sets("mini")["comb"]
    d = DeviceCSR.from_host(g)
    part = RefMatcher(RefConfig(max_phases=1), "none").run(d)
    assert not bool(part.certified)
    want = RefMatcher(RefConfig()).run(d, part)
    out = Matcher(MatcherConfig()).run(
        TorchCSR.from_host(g, device="cpu"),
        state_from_reference(_leaves(part), device="cpu"))
    for a, b in zip(state_to_reference(out), _leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_csr_round_trip_and_refusals():
    g = instance_sets("mini")["kron"]
    d = DeviceCSR.from_host(g)
    t = csr_from_reference(_leaves(d), d.nc, d.nr, device="cpu")
    for a, b in zip(csr_to_reference(t), _leaves(d)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    back = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(d),
                                        csr_to_reference(t))
    assert back.bucket_key == d.bucket_key
    with pytest.raises(NotImplementedError, match="CSC"):
        csr_from_reference(_leaves(d.with_csc()), d.nc, d.nr, device="cpu")
    with pytest.raises(ValueError, match="5 MatchState leaves"):
        state_from_reference(_leaves(d), device="cpu")
