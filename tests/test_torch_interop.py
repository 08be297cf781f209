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
    with pytest.raises(ValueError, match="4 leaves"):
        csr_from_reference(_leaves(d)[:3], d.nc, d.nr, device="cpu")
    with pytest.raises(ValueError, match="5 MatchState leaves"):
        state_from_reference(_leaves(d), device="cpu")


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["dirop", "dirop_pallas"])
def test_csc_mirror_round_trip_and_dirop_solve(use_pallas):
    """A JAX graph with the CSC mirror crosses over with its mirror, solves
    with ``dirop`` to JAX's result bit for bit, and crosses back."""
    g = instance_sets("mini")["grid"]
    d = DeviceCSR.from_host(g).bucketed().with_csc()
    t = csr_from_reference(_leaves(d), d.nc, d.nr, device="cpu")
    assert t.has_csc and t.bucket_key == d.bucket_key
    for a, b in zip(csr_to_reference(t), _leaves(d)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    back = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(d),
                                        csr_to_reference(t))
    assert back.has_csc and back.bucket_key == d.bucket_key
    kw = dict(dirop=True, use_pallas=use_pallas)
    want = RefMatcher(RefConfig(**kw), "cheap").run(d)
    out = Matcher(MatcherConfig(**kw), "cheap").run(t)
    for a, b in zip(state_to_reference(out), _leaves(want)):
        np.testing.assert_array_equal(a, b)


def _stacked(csc: bool):
    sets = instance_sets("mini")
    gs = [DeviceCSR.from_host(sets[f]).bucketed() for f in ("rand", "free")]
    nc = max(g.nc for g in gs)
    nr = max(g.nr for g in gs)
    gs = [g.pad_vertices(nc, nr) for g in gs]
    if csc:
        gs = [g.with_csc() for g in gs]
    return DeviceCSR.stack(gs)


@pytest.mark.parametrize("csc", [False, True], ids=["bare", "csc"])
def test_stacked_csr_round_trip(csc):
    """A stacked JAX graph (``nnz`` of shape (B,)) crosses over lane for lane
    and back, its mirror included."""
    d = _stacked(csc)
    t = csr_from_reference(_leaves(d), d.nc, d.nr, device="cpu")
    assert t.batch_shape == d.batch_shape and t.bucket_key == d.bucket_key
    assert t.nnz == tuple(int(x) for x in np.asarray(d.nnz))
    for a, b in zip(csr_to_reference(t), _leaves(d)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    back = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(d),
                                        csr_to_reference(t))
    assert back.bucket_key == d.bucket_key
    for lane, ref in zip(t.unstack(), d.unstack()):
        assert lane.nnz == int(ref.nnz)
    with pytest.raises(ValueError, match="stack along one batch"):
        csr_from_reference(_leaves(d)[:3] + [np.int32(5)], d.nc, d.nr,
                           device="cpu")


def test_stacked_state_round_trip_and_batched_resume():
    """A batched JAX state (a one-phase ``run_many``) resumes in the port's
    ``run_many`` to JAX's batched resume bit for bit, and crosses back."""
    d = _stacked(False)
    part = RefMatcher(RefConfig(max_phases=1), "none").run_many(d)
    want = RefMatcher(RefConfig()).run_many(d, part)
    state = state_from_reference(_leaves(part), device="cpu")
    assert state.batch_shape == (2,)
    for a, b in zip(state_to_reference(state), _leaves(part)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    graph = csr_from_reference(_leaves(d), d.nc, d.nr, device="cpu")
    out = Matcher(MatcherConfig()).run_many(graph, state)
    for a, b in zip(state_to_reference(out), _leaves(want)):
        np.testing.assert_array_equal(a, b)
    back = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(want),
                                        state_to_reference(out))
    np.testing.assert_array_equal(np.asarray(back.cardinality),
                                  np.asarray(want.cardinality))
