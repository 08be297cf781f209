"""The port's MoE routers against the JAX package's, on the CPU.

The same numpy logits go through ``repro.moe`` and ``repro_torch.moe``:
``assign`` and ``slot`` must be bit-identical, the combine probabilities
within 1e-6 (two softmax implementations).  Logits with exact ties pin
the top-k order (the lower expert index first, ``jax.lax.top_k``'s).
Then the reference's router properties (``tests/test_router.py``), held
on the port: feasibility, matching beats greedy under skew, the exact
router drops no more than either, and scipy's maximum matching bounds
the approximate router.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
from scipy.sparse.csgraph import maximum_bipartite_matching
import torch

from repro.moe import route_matching as jax_route_matching
from repro.moe import route_matching_exact as jax_route_matching_exact
from repro.moe import route_topk as jax_route_topk

from repro_torch.matching import Matcher, MatcherConfig
from repro_torch.matching.device_csr import bucket_nnz
from repro_torch.moe import (route_matching, route_matching_exact,
                             route_topk, router_stats)
from repro_torch.moe.matching_router import _gadget_graph, _top

ROUTERS = {"topk": (route_topk, jax_route_topk),
           "matching": (route_matching, jax_route_matching)}

# (T, E, k, cf) of tests/test_router.py, then k + 2 > E (m = E < k + 2)
SHAPES = [(256, 8, 2, 1.0), (512, 16, 4, 1.25), (128, 4, 1, 1.0),
          (300, 10, 2, 0.75), (96, 3, 2, 1.0), (80, 4, 3, 1.0)]


def _capacity(T, E, k, cf):
    return max(4, int(cf * T * k / E))


def _logits(T, E, seed, skew=1.5, ties=True):
    """Skewed normal logits, float32; with ``ties``, every 5th row repeats
    one value at two experts and every 11th row is constant."""
    rng = np.random.default_rng(seed)
    lg = (rng.standard_normal((T, E)) + np.linspace(skew, 0, E)[None]
          ).astype(np.float32)
    if ties:
        lg[::5, E - 1] = lg[::5, 0]
        lg[::11] = 0.25
    return lg


def _same(got, want, what):
    g = [t.numpy() for t in got]
    w = [np.asarray(a) for a in want]
    for name, a, b in zip(("assign", "slot"), g, w):
        assert a.dtype == b.dtype == np.int32, (what, name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: {name}")
    np.testing.assert_allclose(g[2], w[2], rtol=0, atol=1e-6,
                               err_msg=f"{what}: p")


@pytest.mark.parametrize("T,E,k,cf", SHAPES)
@pytest.mark.parametrize("router", sorted(ROUTERS))
def test_router_matches_reference(router, T, E, k, cf):
    mine, ref = ROUTERS[router]
    C = _capacity(T, E, k, cf)
    lg = _logits(T, E, seed=T + E)
    _same(mine(torch.from_numpy(lg), k, C), ref(jnp.asarray(lg), k, C),
          f"{router} T={T} E={E} k={k} C={C}")


@pytest.mark.parametrize("kw", [dict(n_cand=4, aug_phases=4),
                                dict(n_cand=3, aug_phases=1, max_path=4),
                                dict(aug_phases=0)],
                         ids=["m4-aug4", "m3-aug1-path4", "aug0"])
def test_matching_router_options_match_reference(kw):
    T, E, k = 200, 8, 2
    C = _capacity(T, E, k, 0.8)
    lg = _logits(T, E, seed=9, skew=2.0)
    _same(route_matching(torch.from_numpy(lg), k, C, **kw),
          jax_route_matching(jnp.asarray(lg), k, C, **kw), str(kw))


def test_top_order_puts_the_lower_index_first_on_ties():
    lg = torch.tensor([[0.5, 1.0, 1.0, 0.5, 1.0],
                       [2.0, 2.0, 2.0, 2.0, 2.0]])
    assert _top(lg, 4).tolist() == [[1, 2, 4, 0], [0, 1, 2, 3]]
    assert _top(lg, 2).dtype == torch.int32


@pytest.mark.parametrize("ties", [False, True], ids=["no-ties", "ties"])
def test_exact_router_matches_reference(ties):
    """T=64, E=6, k=2, m=4 (tests/test_router.py): the gadget graph solved
    by the port's Matcher gives the JAX router's assignment bit for bit."""
    T, E, k, m = 64, 6, 2, 4
    C = int(0.9 * T * k / E)
    lg = _logits(T, E, seed=7, skew=2.0, ties=ties)
    _same(route_matching_exact(torch.from_numpy(lg), k, C, n_cand=m),
          jax_route_matching_exact(jnp.asarray(lg), k, C, n_cand=m),
          f"exact ties={ties}")


@pytest.mark.parametrize("T,m", [(64, 4), (63, 3)])
def test_gadget_graph_solves_the_same_unpadded_and_bucketed(T, m):
    """The gadget graph is not bucketed (its edge count is arbitrary, here
    also no multiple of the kernel's four slots a thread); the same graph
    padded to its ``bucket_nnz`` gives the same matching."""
    E, k = 6, 2
    C = int(0.9 * 64 * k / E)
    cand = _top(torch.from_numpy(_logits(T, E, seed=7, skew=2.0)), m)
    g = _gadget_graph(cand, k, E, C)
    assert (g.nc, g.nr) == (T * k + T * m, T * m + E * C)
    assert g.nnz == g.nnz_pad == T * m * (k + 1 + C)
    assert bucket_nnz(g.nnz) > g.nnz
    g.validate()
    padded = g.pad_to(bucket_nnz(g.nnz))
    a = Matcher(MatcherConfig(), warm_start="cheap").run(g)
    b = Matcher(MatcherConfig(), warm_start="cheap").run(padded)
    assert torch.equal(a.cmatch, b.cmatch) and torch.equal(a.rmatch, b.rmatch)
    assert bool(a.certified) and bool(b.certified)


# ---- properties (tests/test_router.py, on the port) -----------------------
def _check_feasible(assign, slot, E, C, k):
    assign, slot = assign.numpy(), slot.numpy()
    live = assign >= 0
    loads = np.bincount(assign[live], minlength=E)
    assert loads.max(initial=0) <= C
    pairs = assign[live] * C + slot[live]
    assert len(np.unique(pairs)) == len(pairs), "slot collision"
    for t in range(assign.shape[0]):
        a = assign[t][assign[t] >= 0]
        assert len(set(a.tolist())) == len(a), "duplicate expert in token"


@pytest.mark.parametrize("T,E,k,cf", SHAPES[:4])
def test_routers_feasible(T, E, k, cf):
    C = _capacity(T, E, k, cf)
    logits = torch.from_numpy(_logits(T, E, seed=T * E, ties=False))
    for fn in (route_topk, route_matching):
        assign, slot, p = fn(logits, k, C)
        _check_feasible(assign, slot, E, C, k)
        live = (assign >= 0).any(-1)
        np.testing.assert_allclose(p.sum(-1)[live].numpy(), 1.0, rtol=1e-4)


def test_matching_beats_greedy_under_skew():
    """Max-cardinality matching routes more tokens than greedy truncation
    when experts are contended."""
    T, E, k = 512, 16, 4
    C = int(1.0 * T * k / E)
    wins = 0
    for i in range(5):
        logits = torch.from_numpy(_logits(T, E, seed=100 + i, skew=2.0,
                                          ties=False))
        d1 = float(router_stats(route_topk(logits, k, C)[0], k)["drop_rate"])
        d2 = float(router_stats(route_matching(logits, k, C)[0],
                                k)["drop_rate"])
        assert d2 <= d1 + 1e-9, (i, d1, d2)
        wins += d2 < d1 - 1e-9
    assert wins >= 3, "matching router should strictly win on skewed logits"


def test_matching_within_ten_percent_of_scipy_bound():
    """scipy's maximum matching of tokens' demand clones x expert slots
    over the top-m candidates (which ignores the one-expert-per-token
    rule, so an upper bound): the router lands within 10 % of it."""
    T, E, k, m = 64, 6, 2, 4
    C = int(0.9 * T * k / E)
    lg = torch.from_numpy(_logits(T, E, seed=7, skew=2.0, ties=False))
    cand = _top(lg, m).numpy()
    rows, cols = [], []
    for t in range(T):
        for j in range(k):
            for e in cand[t]:
                rows += [t * k + j] * C
                cols += list(range(int(e) * C, int(e) * C + C))
    a = scipy.sparse.csr_matrix((np.ones(len(rows)), (rows, cols)),
                                shape=(T * k, E * C))
    opt = int((maximum_bipartite_matching(a, perm_type="column") >= 0).sum())
    assign, _, _ = route_matching(lg, k, C, n_cand=m, aug_phases=4)
    assert int((assign >= 0).sum()) >= 0.9 * opt


def test_exact_router_feasible_and_dominates():
    T, E, k, m = 64, 6, 2, 4
    C = int(0.9 * T * k / E)
    logits = torch.from_numpy(_logits(T, E, seed=7, skew=2.0, ties=False))
    assign, slot, p = route_matching_exact(logits, k, C, n_cand=m)
    _check_feasible(assign, slot, E, C, k)
    live = (assign >= 0).any(-1)
    np.testing.assert_allclose(p.sum(-1)[live].numpy(), 1.0, rtol=1e-4)
    d_exact = float(router_stats(assign, k)["drop_rate"])
    a1 = route_topk(logits, k, C)[0]
    a2 = route_matching(logits, k, C, n_cand=m, aug_phases=4)[0]
    assert d_exact <= float(router_stats(a1, k)["drop_rate"]) + 1e-9
    assert d_exact <= float(router_stats(a2, k)["drop_rate"]) + 1e-9


def test_router_stats_on_tensors_and_arrays():
    a = torch.tensor([[0, -1], [1, 2], [-1, -1]], dtype=torch.int32)
    s = router_stats(a, 2)
    assert int(s["assigned"]) == 3 and s["demand"] == 6
    assert float(s["drop_rate"]) == pytest.approx(0.5)
    assert float(router_stats(a.numpy(), 2)["drop_rate"]) == pytest.approx(0.5)
