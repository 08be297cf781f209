"""The port's solver internals and warm starts against the JAX package's.

Each function gets the same inputs (made with numpy from a seed, or the
states the JAX solver itself reaches) in both packages and must return the
same integers, tolerance 0.  The port runs on the CPU, where every
``index_select``/``scatter`` raises on an out-of-range index: a pass here
also shows that no index of the solver leaves its range.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.matching.solve as js
import repro.matching.warmstart as jw
from repro.graphs import instance_sets, random_bipartite
from repro.matching import DeviceCSR, Matcher as RefMatcher
from repro.matching import MatcherConfig as RefConfig

import repro_torch.matching.solve as ts
import repro_torch.matching.warmstart as tw
from repro_torch.matching import Matcher, MatcherConfig, TorchCSR


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.int32))


def _eq(a, b, msg=""):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_array_equal(a, np.asarray(b), err_msg=msg)


def _state(g, ws="cheap"):
    st = RefMatcher(warm_start=ws).init(DeviceCSR.from_host(g))
    return st.cmatch, st.rmatch


def test_constants_equal_reference():
    for k in ("L0", "UNVISITED", "FOUND", "NEG", "IINF"):
        assert getattr(ts, k) == int(getattr(js, k)), k
    assert ts.default_block_edges(1000, "ct") == js.default_block_edges(
        1000, "ct")
    assert ts.default_block_edges(10**6, "mt") == js.default_block_edges(
        10**6, "mt")


def test_scatter_min_equals_reference():
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 41, size=500).astype(np.int32)
    val = rng.integers(0, 2**30 + 1, size=500).astype(np.int32)
    _eq(ts.scatter_min(40, _t(idx), _t(val)),
        js.scatter_min(40, jnp.asarray(idx), jnp.asarray(val)))


@pytest.mark.parametrize("ws", ["none", "cheap"])
def test_level0_state_equals_reference(ws):
    cm, _ = _state(random_bipartite(70, 60, 3.0, seed=2), ws)
    bfs, root = ts.level0_state(_t(cm))
    jb, jr = js.level0_state(cm)
    _eq(bfs, jb)
    _eq(root, jr)


@pytest.mark.parametrize("wr,wr_exact", [(False, False), (True, False),
                                         (True, True)],
                         ids=["plain", "wr", "wr_exact"])
@pytest.mark.parametrize("family", ["rand", "grid", "comb"])
def test_apply_winner_all_outputs_equal_reference(family, wr, wr_exact):
    """Walk whole BFS phases in both packages from the same state: every
    one of the six outputs agrees at every level."""
    g = instance_sets("mini")[family]
    cm, rm = _state(g)
    ecol, cadj = jnp.asarray(g.ecol), jnp.asarray(g.cadj)
    jb, jr = js.level0_state(cm)
    jp = jnp.full(g.nr + 1, g.nc, jnp.int32)
    jm = rm
    tb, tr, tp, tm = _t(jb), _t(jr), _t(jp), _t(jm)
    levels = 0
    for level in range(2, 2 + g.nc):
        win = js._winner_full(ecol, cadj, jb, jr if wr else None, jm, level,
                              g.nr, use_pallas=False, pallas_fused=True,
                              block_edges=128, interpret=True)
        twin = ts._winner_full(_t(g.ecol), _t(g.cadj), tb,
                               tr if wr else None, tm, level)
        _eq(twin, win, f"winner level {level}")
        jout = js._apply_winner(win, jb, jr, jp, jm, jnp.int32(level), wr=wr,
                                wr_exact=wr_exact)
        tout = ts._apply_winner(twin, tb, tr, tp, tm, level, wr=wr,
                                wr_exact=wr_exact)
        for name, a, b in zip(("bfs", "root", "pred", "rmatch", "ins", "aug"),
                              tout, jout):
            _eq(a, b, f"{name} level {level}")
        jb, jr, jp, jm = jout[:4]
        tb, tr, tp, tm = tout[:4]
        levels += 1
        if not bool(jout[4]):
            break
    assert levels >= 2


def _phase_end(g, ws="cheap"):
    """State at the end of one full APFB BFS phase (JAX side)."""
    cm, rm0 = _state(g, ws)
    rm = rm0
    bfs, root = js.level0_state(cm)
    pred = jnp.full(g.nr + 1, g.nc, jnp.int32)
    level = 2
    while True:
        bfs, root, pred, rm_b, ins, aug = js._expand_level(
            jnp.asarray(g.ecol), jnp.asarray(g.cadj), bfs, root, pred, rm,
            jnp.int32(level), wr=True, wr_exact=False, use_pallas=False,
            block_edges=128)
        rm = rm_b
        level += 1
        if not bool(ins):
            break
    return cm, rm0, pred, rm


@pytest.mark.parametrize("family", ["rand", "kron", "grid", "comb"])
def test_alternate_equals_reference_including_steps(family):
    g = instance_sets("mini")[family]
    cm0, rm0, pred, rm_b = _phase_end(g)
    mask = rm_b == -2
    max_steps = 2 * (min(g.nc, g.nr) + 2)
    rm_start = jnp.where(mask, jnp.int32(-2), rm0)
    jcm, jrm, jsteps = js._alternate(cm0, rm_start, pred, mask,
                                     jnp.int32(max_steps))
    tcm, trm, tsteps = ts._alternate(_t(cm0), _t(rm_start), _t(pred),
                                     torch.from_numpy(np.array(mask)),
                                     max_steps)
    _eq(tcm, jcm)
    _eq(trm, jrm)
    assert tsteps == int(jsteps)
    # a step budget that cuts the walk short
    jcm, jrm, jsteps = js._alternate(cm0, rm_start, pred, mask, jnp.int32(1))
    tcm, trm, tsteps = ts._alternate(_t(cm0), _t(rm_start), _t(pred),
                                     torch.from_numpy(np.array(mask)), 1)
    _eq(tcm, jcm)
    _eq(trm, jrm)
    assert tsteps == int(jsteps)


@pytest.mark.parametrize("seed", range(4))
def test_fix_matching_equals_reference(seed):
    rng = np.random.default_rng(seed)
    nc, nr = 60, 45
    cm = rng.integers(-2, nr, size=nc + 1).astype(np.int32)
    rm = rng.integers(-2, nc, size=nr + 1).astype(np.int32)
    cm[-1] = rm[-1] = -3
    # some symmetric pairs so both outcomes of each check occur
    for c in rng.choice(nc, 15, replace=False):
        r = int(rng.integers(0, nr))
        cm[c], rm[r] = r, c
    jc, jr = js._fix_matching(jnp.asarray(cm), jnp.asarray(rm))
    tc, tr = ts._fix_matching(_t(cm), _t(rm))
    _eq(tc, jc)
    _eq(tr, jr)
    assert int(ts._cardinality(tc)) == int(js._cardinality(jc))


@pytest.mark.parametrize("init", ["cheap_init", "karp_sipser_init",
                                  "none_init"])
@pytest.mark.parametrize("family", ["rand", "sparse", "free", "comb"])
def test_warm_starts_equal_reference(init, family):
    g = instance_sets("mini", rcp=True)[family + "_rcp"]
    d = DeviceCSR.from_host(g)
    st = RefMatcher().init(d)          # fresh state, sentinels attached
    jc, jr = getattr(jw, init)(d.ecol, d.cadj, st.cmatch, st.rmatch)
    tc, tr = getattr(tw, init)(_t(g.ecol), _t(g.cadj), _t(st.cmatch),
                               _t(st.rmatch))
    _eq(tc, jc)
    _eq(tr, jr)


def test_warm_start_registry_mirrors_reference():
    assert tw.warm_start_names() == jw.warm_start_names()
    with pytest.raises(KeyError, match="unknown warm start"):
        Matcher(MatcherConfig(), "nope")


@pytest.mark.parametrize("overrides", [
    dict(dirop=True), dict(adaptive_frontier=True),
    dict(use_pallas=True, pallas_fused=False)], ids=str)
def test_unported_paths_raise(overrides):
    """Each config once refused as unported (``NotImplementedError``) now
    raises nothing: it runs through its own sweeps and gives the JAX
    package's result."""
    g = instance_sets("mini")["kron"]
    d = DeviceCSR.from_host(g)
    t = TorchCSR.from_host(g, device="cpu")
    if overrides.get("dirop"):
        d, t = d.with_csc(), t.with_csc()
    want = RefMatcher(RefConfig(**overrides), "cheap").run(d)
    m = Matcher(MatcherConfig(**overrides), "cheap")
    got = m.run(t)
    _eq(got.cmatch, want.cmatch)
    _eq(got.rmatch, want.rmatch)
    assert (int(got.phases), int(got.fallbacks), bool(got.certified)) == \
        (int(want.phases), int(want.fallbacks), bool(want.certified))
    c = m.last_counts
    assert c["levels"] == c["push_levels"] + c["pull_levels"] + \
        c["compact_levels"]


def test_dirop_requires_the_csc_mirror():
    g = random_bipartite(64, 64, 2.0, seed=1)
    m = Matcher(MatcherConfig(dirop=True))
    with pytest.raises(ValueError, match="with_csc"):
        m.run(TorchCSR.from_host(g, device="cpu"))
    st = m.run(TorchCSR.from_host(g, device="cpu").with_csc())
    want = RefMatcher(RefConfig(dirop=True)).run(
        DeviceCSR.from_host(g).with_csc())
    _eq(st.cmatch, want.cmatch)
    solver = ts.make_solver(MatcherConfig(dirop=True))
    t = TorchCSR.from_host(g, device="cpu")
    with pytest.raises(ValueError, match="CSC mirror"):
        solver(t.ecol, t.cadj, st.cmatch, st.rmatch, cxadj=t.cxadj)
    with pytest.raises(ValueError, match="cxadj"):
        ts.make_solver(MatcherConfig(adaptive_frontier=True))(
            t.ecol, t.cadj, st.cmatch, st.rmatch)


def test_dirop_config_validation():
    with pytest.raises(ValueError, match="generalizes"):
        MatcherConfig(dirop=True, adaptive_frontier=True)
    with pytest.raises(AssertionError, match="hysteresis"):
        MatcherConfig(dirop_alpha=8.0, dirop_beta=4.0)  # beta < alpha
    a = MatcherConfig(dirop=True)
    b = MatcherConfig(dirop=True, dirop_alpha=2.0, dirop_beta=2.0)
    assert a != b and hash(a) != hash(b)


def test_counters_count_levels_steps_and_syncs():
    """The counts of one solve, pinned: its 8 BFS levels and 6 ``ALTERNATE``
    steps, and its 3 host syncs: the BFS verdict of each of its 2 phases
    and the guard of the one that augments.  The loops' own tests are the
    device's, so no loop step is a host sync."""
    g = instance_sets("mini")["grid"]
    m = Matcher(MatcherConfig(), "cheap")
    st = m.run(TorchCSR.from_host(g, device="cpu"))
    c = m.last_counts
    assert (c["levels"], c["alternate_steps"], int(st.phases)) == (8, 6, 2)
    assert c["host_syncs"] == 3


@pytest.mark.parametrize("overrides", [
    dict(adaptive_frontier=True), dict(dirop=True),
    dict(dirop=True, use_pallas=True)], ids=str)
def test_branch_decision_rides_on_the_level_sync(overrides):
    """The adaptive and direction-optimizing paths decide each level's
    sweep on the device, in the level before it (an IF node a branch on a
    card): they read the device as often as the push path, twice a phase
    that augments and once the last."""
    g = instance_sets("mini")["comb"]
    t = TorchCSR.from_host(g, device="cpu")
    if overrides.get("dirop"):
        t = t.with_csc()
    base_m = Matcher(MatcherConfig(), "cheap")
    st = base_m.run(t)
    base = base_m.last_counts
    m = Matcher(MatcherConfig(**overrides), "cheap")
    m.run(t)
    c = m.last_counts
    assert c["levels"] == base["levels"] == 52
    assert c["host_syncs"] == base["host_syncs"] == 2 * int(st.phases) - 1
