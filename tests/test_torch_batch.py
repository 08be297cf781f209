"""The port's batched solve against the JAX package's.

``TorchCSR.stack`` / ``unstack`` and batched states have the JAX package's
shapes and refusals; ``Matcher.run_many`` gives, lane by lane, the JAX
``run_many``'s ``cmatch``, ``rmatch``, ``phases``, ``fallbacks`` and
``certified`` bit for bit (tolerance 0) on graphs of one bucket with
different edge counts, through every solve path ``run_many`` serves, both
BFS kernels, APFB / APsB, exact WR, a phase budget with maximal
degradation, every warm start, resumed from batched states, and with
padding lanes beside the real ones.  The JAX package's ``run_many`` lanes
equal its ``run`` on the same graph (checked here too), so the port's
``run_many`` lanes equal the port's ``run``.  The plain versions of the
batched kernels equal the single-graph ones lane by lane.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.graphs import random_bipartite
from repro.matching import DeviceCSR, Matcher as RefMatcher
from repro.matching import MatcherConfig as RefConfig
from repro.serving.bucketizer import _pad_host_vertices

from repro_torch.kernels.frontier_expand import (
    frontier_bits, frontier_bits_ref, frontier_expand, frontier_expand_fused,
    frontier_expand_fused_ref, frontier_expand_pull, frontier_expand_pull_ref,
    frontier_expand_ref)
from repro_torch.matching import (Matcher, MatcherConfig, TorchCSR,
                                  match_many, register_warm_start)
from repro_torch.matching.state import empty_like_graph
from repro_torch.matching.warmstart import WARM_STARTS, _VERSIONS, cheap_init

NC = NR = 256
CAP = 2048
FIELDS = ("cmatch", "rmatch", "phases", "fallbacks", "certified")
PATHS = {
    "jnp": {},
    "legacy": dict(use_pallas=True, pallas_fused=False),
    "fused": dict(use_pallas=True, pallas_fused=True),
    "dirop": dict(dirop=True),
    "dirop_pallas": dict(dirop=True, use_pallas=True),
}


@functools.lru_cache(maxsize=None)
def _hosts():
    """Three graphs of the (256, 256) bucket with different edge counts
    (the first two fit 1024 edge slots, the third needs 2048)."""
    gs = [random_bipartite(200, 180, 3.0, seed=1),
          random_bipartite(150, 200, 2.0, seed=2),
          random_bipartite(256, 256, 5.0, seed=3)]
    return tuple(_pad_host_vertices(g, NC, NR, CAP if g.nnz > 1024 else 1024)
                 for g in gs)


def _ref_batch(csc: bool, lanes=(0, 1, 2)):
    ds = [DeviceCSR.from_host(_hosts()[i]) for i in lanes]
    if csc:
        ds = [d.with_csc() for d in ds]
    return DeviceCSR.stack(ds)


def _port_batch(csc: bool, lanes=(0, 1, 2)):
    ts = [TorchCSR.from_host(_hosts()[i], device="cpu") for i in lanes]
    if csc:
        ts = [t.with_csc() for t in ts]
    return TorchCSR.stack(ts)


def _assert_lanes_equal(out, want, lanes=None):
    lanes = range(out.cmatch.shape[0]) if lanes is None else lanes
    for f in FIELDS:
        got, ref = getattr(out, f).numpy(), np.asarray(getattr(want, f))
        for i in lanes:
            np.testing.assert_array_equal(got[i], ref[i], err_msg=f"{f}[{i}]")


# ---------------------------------------------------------------------------
# stacking and batched state
# ---------------------------------------------------------------------------
def test_stack_pads_every_lane_to_the_largest_and_unstacks():
    ts = [TorchCSR.from_host(h, device="cpu") for h in _hosts()]
    assert [t.nnz_pad for t in ts] == [1024, 1024, 2048]
    b = TorchCSR.stack(ts)
    ref = _ref_batch(False)
    assert b.batch_shape == (3,) and b.nnz_pad == CAP
    assert b.bucket_key == ref.bucket_key == (3, NC, NR, CAP)
    assert b.nnz == tuple(int(x) for x in np.asarray(ref.nnz))
    for name in ("cxadj", "cadj", "ecol"):
        np.testing.assert_array_equal(getattr(b, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    for t, lane in zip(ts, b.unstack()):
        assert lane.batch_shape == () and lane.nnz == t.nnz
        assert torch.equal(lane.cadj, t.pad_to(CAP).cadj)
        assert torch.equal(lane.ecol, t.pad_to(CAP).ecol)
    mirrored = _port_batch(True)
    assert mirrored.bucket_key == _ref_batch(True).bucket_key
    for name in ("rxadj", "radj", "erow", "eperm"):
        np.testing.assert_array_equal(getattr(mirrored, name).numpy(),
                                      np.asarray(getattr(_ref_batch(True),
                                                         name)))


def test_stack_refusals():
    a = TorchCSR.from_host(_hosts()[0], device="cpu")
    with pytest.raises(ValueError, match="all or none"):
        TorchCSR.stack([a, a.with_csc()])
    small = TorchCSR.from_host(random_bipartite(10, 12, 2.0, seed=4),
                               device="cpu")
    with pytest.raises(ValueError, match="bucket mismatch"):
        TorchCSR.stack([a, small])
    with pytest.raises(ValueError, match="empty"):
        TorchCSR.stack([])
    b = TorchCSR.stack([a, a])
    for call in (b.with_csc, b.validate, b.to_host,
                 lambda: b.pad_vertices(300, 300), lambda: TorchCSR.stack([b])):
        with pytest.raises(ValueError, match="single graph"):
            call()
    with pytest.raises(ValueError, match="not a batched"):
        a.unstack()


def test_batched_state_shapes():
    b = _port_batch(False)
    s = empty_like_graph(b)
    ref = jax.tree.map(np.array, RefMatcher().run_many(_ref_batch(False)))
    for f in FIELDS:
        assert tuple(getattr(s, f).shape) == ref.__dict__[f].shape, f
        assert getattr(s, f).dtype == torch.from_numpy(
            ref.__dict__[f]).dtype, f
    assert tuple(s.cardinality.shape) == (3,)
    assert s.batch_shape == (3,)
    assert (s.cmatch[:, -1] == -3).all() and (s.rmatch[:, -1] == -3).all()
    lanes = s.unstack()
    assert len(lanes) == 3 and lanes[0].cmatch.shape == (NC + 1,)
    for f in FIELDS:
        assert torch.equal(torch.stack([getattr(ln, f) for ln in lanes]),
                           getattr(s, f))
    d = Matcher().stats(s).as_dict()
    assert d["phases"].shape == (3,) and d["certified"].dtype == bool


# ---------------------------------------------------------------------------
# run_many against the JAX package's run_many, lane by lane
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ws", ["none", "cheap", "karp_sipser"])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_run_many_equals_reference(path, ws):
    kw = PATHS[path]
    csc = kw.get("dirop", False)
    rm = RefMatcher(RefConfig(**kw), ws)
    want = rm.run_many(_ref_batch(csc))
    out = Matcher(MatcherConfig(**kw), ws).run_many(_port_batch(csc))
    _assert_lanes_equal(out, want)
    # the reference's lanes are its single-graph runs
    for i, d in enumerate(_ref_batch(csc).unstack()):
        one = rm.run(d)
        for f in FIELDS:
            np.testing.assert_array_equal(np.asarray(want.__dict__[f])[i],
                                          np.asarray(one.__dict__[f]))


@pytest.mark.parametrize("variant", [
    dict(kernel="gpubfs"), dict(algo="apsb"),
    dict(algo="apsb", wr_exact=True), dict(algo="apsb", kernel="gpubfs"),
    dict(tail_levels=1), dict(schedule="mt", use_pallas=True),
], ids=["gpubfs", "apsb", "apsb-wr_exact", "apsb-gpubfs", "tail1",
        "mt-fused"])
def test_run_many_variants_equal_reference(variant):
    want = RefMatcher(RefConfig(**variant), "cheap").run_many(
        _ref_batch(False))
    out = Matcher(MatcherConfig(**variant), "cheap").run_many(
        _port_batch(False))
    _assert_lanes_equal(out, want)


@pytest.mark.parametrize("path", ["jnp", "dirop"])
@pytest.mark.parametrize("ws", ["none", "cheap"])
def test_run_many_phase_budget_degrades_per_lane(ws, path):
    kw = dict(PATHS[path], max_phases=1, degrade_maximal=True)
    csc = kw.get("dirop", False)
    want = RefMatcher(RefConfig(**kw), ws).run_many(_ref_batch(csc))
    out = Matcher(MatcherConfig(**kw), ws).run_many(_port_batch(csc))
    _assert_lanes_equal(out, want)
    if ws == "none":
        # a cold one-phase solve leaves some lane uncertified
        assert not bool(out.certified.all())


@pytest.mark.parametrize("path", ["jnp", "dirop_pallas"])
def test_run_many_resumes_from_batched_states(path):
    kw = PATHS[path]
    csc = kw.get("dirop", False)
    part_ref = RefMatcher(RefConfig(max_phases=1, **kw), "none").run_many(
        _ref_batch(csc))
    want = RefMatcher(RefConfig(**kw)).run_many(_ref_batch(csc), part_ref)
    part = Matcher(MatcherConfig(max_phases=1, **kw), "none").run_many(
        _port_batch(csc))
    _assert_lanes_equal(part, part_ref)
    out = Matcher(MatcherConfig(**kw)).run_many(_port_batch(csc), part)
    _assert_lanes_equal(out, want)
    assert (out.phases > part.phases).all()


def test_padding_lanes_change_no_real_lane():
    """The service pads a flush with copies of its first graph: the real
    lanes give what a batch without them gives, and the reference's."""
    padded = Matcher(MatcherConfig(), "cheap").run_many(
        _port_batch(False, lanes=(1, 2, 1, 1)))
    real = Matcher(MatcherConfig(), "cheap").run_many(
        _port_batch(False, lanes=(1, 2)))
    want = RefMatcher(RefConfig(), "cheap").run_many(
        _ref_batch(False, lanes=(1, 2, 1, 1)))
    _assert_lanes_equal(padded, want)
    for f in FIELDS:
        assert torch.equal(getattr(padded, f)[:2], getattr(real, f))


def test_run_many_lanes_equal_run_and_counts_add_up():
    """Each lane equals the port's single-graph run; the batched counts are
    the lanes' counts summed (lane-levels, lane-steps); the host reads at
    most twice a phase of the slowest lane."""
    m = Matcher(MatcherConfig(), "karp_sipser")
    batch = _port_batch(False)
    out = m.run_many(batch)
    counts = m.last_counts
    total, phases = {}, []
    for i, lane in enumerate(batch.unstack()):
        one = m.run(lane)
        for f in FIELDS:
            assert torch.equal(getattr(out, f)[i], getattr(one, f)), f
        for k, v in m.last_counts.items():
            total[k] = total.get(k, 0) + v
        phases.append(int(one.phases))
    for k in ("levels", "push_levels", "alternate_steps"):
        assert counts[k] == total[k], k
    assert counts["host_syncs"] <= 2 * max(phases)


def test_match_many_and_refusals():
    b = _port_batch(False)
    out = match_many(b)
    want = RefMatcher(RefConfig(), "cheap").run_many(_ref_batch(False))
    _assert_lanes_equal(out, want)
    with pytest.raises(ValueError, match="adaptive_frontier"):
        Matcher(MatcherConfig(adaptive_frontier=True)).run_many(b)
    single = b.lane(0)
    with pytest.raises(ValueError, match="stacked"):
        Matcher().run_many(single)
    with pytest.raises(ValueError, match="run_many"):
        Matcher().run(b)
    with pytest.raises(ValueError, match="batch"):
        Matcher().run_many(b, empty_like_graph(single))
    with pytest.raises(ValueError, match="CSC mirror"):
        Matcher(MatcherConfig(dirop=True)).run_many(b)


def test_run_many_with_a_registered_warm_start():
    """A registered initializer is called on each lane (the reference vmaps
    it); one that calls a built-in gives the built-in's result."""
    name = "test-batch-custom"
    register_warm_start(name, lambda e, c, cm, rm: cheap_init(e, c, cm, rm))
    try:
        out = Matcher(MatcherConfig(), name).run_many(_port_batch(False))
    finally:
        WARM_STARTS.pop(name, None)
        _VERSIONS.pop(name, None)
    want = RefMatcher(RefConfig(), "cheap").run_many(_ref_batch(False))
    _assert_lanes_equal(out, want)


# ---------------------------------------------------------------------------
# the batched plain kernels against the single-graph ones, lane by lane
# ---------------------------------------------------------------------------
def _sweep_states(seed: int, nb: int = 4):
    """A batch whose lanes sit at different BFS levels: each lane a few
    levels into its first phase from a cheap start."""
    from repro_torch.matching.solve import _apply_winner, level0_state
    ts = _port_batch(True, lanes=tuple(i % 3 for i in range(nb)))
    warm = Matcher(MatcherConfig(), "cheap").init(ts.lane(0))
    lanes = []
    for i, lane in enumerate(ts.unstack()):
        st = Matcher(MatcherConfig(), "cheap").init(lane)
        bfs, root = level0_state(st.cmatch)
        pred = torch.full((NR + 1,), NC, dtype=torch.int32)
        rm, level = st.rmatch, 2
        for _ in range(i % 3):
            win = frontier_expand_fused_ref(lane.ecol, lane.cadj, bfs, root,
                                            rm, level)
            bfs, root, pred, rm, _, _ = _apply_winner(
                win, bfs, root, pred, rm, level, wr=True, wr_exact=False)
            level += 1
        lanes.append((bfs, root, rm, level))
    del warm
    bfs, root, rm = (torch.stack([x[k] for x in lanes]) for k in range(3))
    level = torch.tensor([x[3] for x in lanes], dtype=torch.int32)
    gen = np.random.default_rng(seed)
    gate = torch.from_numpy(gen.integers(0, 2, nb).astype(np.int32))
    gate[0] = 1
    return ts, bfs, root, rm, level, gate


@pytest.mark.parametrize("wr", [True, False], ids=["wr", "plain"])
def test_batched_plain_kernels_equal_single_lane_by_lane(wr):
    ts, bfs, root, rm, level, gate = _sweep_states(seed=5)
    rt = root if wr else None
    sweeps = [
        (frontier_expand_fused_ref, frontier_expand_fused, ts.ecol, ts.cadj),
        (frontier_expand_ref, frontier_expand, ts.ecol, ts.cadj),
        (frontier_expand_pull_ref, frontier_expand_pull, ts.radj, ts.erow),
    ]
    for ref, wrapper, cols, rows in sweeps:
        got = ref(cols, rows, bfs, rt, rm, level, gate)
        via = wrapper(cols, rows, bfs, rt, rm, level, gate)
        assert torch.equal(got, via)
        for i in range(bfs.shape[0]):
            one = ref(cols[i], rows[i], bfs[i], None if rt is None else rt[i],
                      rm[i], level[i], gate[i])
            assert torch.equal(got[i], one), (ref.__name__, i)
            off = ref(cols[i], rows[i], bfs[i],
                      None if rt is None else rt[i], rm[i], level[i],
                      torch.zeros((), dtype=torch.int32))
            if not int(gate[i]):
                assert torch.equal(got[i], off)
    bits = frontier_bits_ref(bfs, rt, level)
    assert torch.equal(bits, frontier_bits(bfs, rt, level))
    for i in range(bfs.shape[0]):
        assert torch.equal(bits[i], frontier_bits_ref(
            bfs[i], None if rt is None else rt[i], level[i]))
    # one int level for every lane
    assert torch.equal(
        frontier_expand_fused_ref(ts.ecol, ts.cadj, bfs, rt, rm, 2)[1],
        frontier_expand_fused_ref(ts.ecol[1], ts.cadj[1], bfs[1],
                                  None if rt is None else rt[1], rm[1], 2))


def test_batched_kernel_wrappers_check_their_lanes():
    ts, bfs, root, rm, level, gate = _sweep_states(seed=6)
    with pytest.raises(TypeError, match="level"):
        frontier_expand_fused(ts.ecol, ts.cadj, bfs, root, rm, level[:2])
    with pytest.raises(TypeError, match="gate"):
        frontier_expand_fused(ts.ecol, ts.cadj, bfs, root, rm, level,
                              gate[0])
    with pytest.raises(ValueError, match="lanes"):
        frontier_expand_fused(ts.ecol[:2], ts.cadj[:2], bfs, root, rm, level)
    with pytest.raises(ValueError, match="2-D"):
        frontier_expand_fused(ts.ecol[0], ts.cadj[0], bfs, root, rm, level)


def test_run_many_entry_key_and_bytes():
    """One ``"run_many"`` cache entry per (batch + bucket, config, warm
    start): a second call hits it; its bytes on the CPU (static buffers, no
    captures) are what the cache counts, the batch's arrays among them."""
    from repro_torch.matching import compile_cache_clear, compile_cache_info
    from repro_torch.matching.cache import compile_cache_entry
    compile_cache_clear()
    cfg = MatcherConfig(dirop=True)
    m = Matcher(cfg, "cheap")
    b = _port_batch(True)
    m.run_many(b)
    m.run_many(b)
    info = compile_cache_info()
    assert info["misses"] == 1 and info["hits"] == 1
    (key,) = info["keys"]
    assert key[0] == (3, NC, NR, CAP, "csc") and key[-1] == "run_many"
    prog = compile_cache_entry(key)
    graph = sum(t.nbytes for t in (b.ecol, b.cadj, b.cxadj, b.rxadj, b.radj,
                                   b.erow))
    assert prog.nbytes("cpu") == info["bytes"] > graph


def test_warm_runs_every_step_and_leaves_each_lane_as_a_call_does():
    """``BatchProgram.warm`` (the service's warm-up) runs the walk's and
    the fallback's steps even on a batch where no lane walks, so that a
    card captures them all; on lanes that do not walk they change nothing,
    so a warm run ends with each lane as a plain call leaves it."""
    from repro_torch.matching import compile_cache_clear, compile_cache_info
    from repro_torch.matching.cache import compile_cache_entry
    from repro_torch.matching.device_loop import Program
    from repro_torch.serving import SizeBucket
    from repro_torch.serving.warmup import synthetic_bucket_graph
    compile_cache_clear()
    m = Matcher(MatcherConfig(), "cheap")
    b = _port_batch(False)
    want = m.run_many(b)
    prog = compile_cache_entry(compile_cache_info()["keys"][-1])
    P = prog.program("cpu")
    prog.warm(b)
    B = P.buf
    for f, got in (("cmatch", B.cmatch), ("rmatch", B.rmatch),
                   ("phases", B.phases), ("fallbacks", B.fallbacks),
                   ("certified", B.certified != 0)):
        assert torch.equal(got, getattr(want, f)), f
    empty = synthetic_bucket_graph(SizeBucket(NC, NR, CAP), device="cpu")
    m.run_many(TorchCSR.stack([empty] * 3))
    prog = compile_cache_entry(compile_cache_info()["keys"][-1])
    P = prog.program("cpu")
    ran = []
    P.once = lambda step: (ran.append(step.name), Program.once(P, step))[1]
    P.loop = lambda lp: (ran.append(lp.name), Program.loop(P, lp))[1]
    prog.warm(TorchCSR.stack([empty] * 3))
    assert {"alt_begin", "alt", "alt_end", "fallback_end",
            "commit"} <= set(ran), ran
    assert P.buf.phases.tolist() == [1, 1, 1]
    assert not P.buf.fallbacks.any() and bool(P.buf.certified.all())
