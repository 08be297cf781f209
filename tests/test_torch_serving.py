"""The port's matching service against the JAX package's.

The scenarios of ``tests/test_serving.py``: bucketizer admission (the
admitted graph's arrays equal the reference's), scheduler policy on a fake
clock, the batch ladder, the service's per-request results (the same
cardinality, and the same ``MatchState`` as the reference's ``Matcher`` on
the same admitted graph, bit for bit), deadline flushes, the warm-up
zero-miss contract on every kernel path, typed errors and refusals, and the
metrics snapshot's keys.  The oversize graph is rejected by default; with
a mesh (``oversize="shard"``, ``mesh=``) it is served on the sharded lane,
its state the single-device ``Matcher.run``'s bit for bit (the port's and
the reference's).  Every service here runs on the CPU (``device="cpu"``;
the mesh: four shards on the CPU).
"""
import dataclasses
import functools
import inspect

import numpy as np
import pytest
import torch

from repro.graphs import (banded, comb_chain, community_graph, grid_graph,
                          kron_graph, mtx_fixture, random_bipartite,
                          scaled_free)
from repro.matching import Matcher as RefMatcher
from repro.matching import MatcherConfig as RefConfig
import repro.serving as ref_serving
from repro.serving import Bucketizer as RefBucketizer

from repro_torch.core import validate_matching
from repro_torch.core.csr import BipartiteCSR
from repro_torch.matching import (Matcher, MatcherConfig, TorchCSR,
                                  compile_cache_clear, compile_cache_info,
                                  make_mesh)
import repro_torch.serving as serving
from repro_torch.serving import (Bucketizer, FaultInjector, MatchingService,
                                 MicroBatcher, OversizeGraphError,
                                 PoisonedGraphFault, ServiceMetrics,
                                 SizeBucket, batch_bucket, batch_ladder,
                                 synthetic_bucket_graph)

CFG = MatcherConfig(algo="apfb", kernel="gpubfs_wr", schedule="ct")
REF_CFG = RefConfig(algo="apfb", kernel="gpubfs_wr", schedule="ct")
BUCKET = SizeBucket(256, 256, 2048)
FIELDS = ("cmatch", "rmatch", "phases", "fallbacks", "certified")
T = 120          # every future's timeout, seconds


def port(g) -> BipartiteCSR:
    """A reference host graph as the port's container (same arrays)."""
    return BipartiteCSR(nc=g.nc, nr=g.nr, nnz=g.nnz, cxadj=g.cxadj,
                        cadj=g.cadj, ecol=g.ecol)


@functools.lru_cache(maxsize=None)
def families():
    """One instance of every corpus generator family, all sized to share
    one declared bucket (the reference's generators: the same arrays)."""
    return {
        "random": random_bipartite(200, 180, 3.0, seed=1),
        "kron": kron_graph(7, 6, seed=2),
        "grid": grid_graph(12),
        "free": scaled_free(150, 160, 4.0, seed=3),
        "band": banded(200, band=3, density=0.5, seed=5),
        "community": community_graph(192, 192, blocks=6, avg_deg=3.0, seed=6),
        "comb": comb_chain(96, teeth=16, seed=7),
        "mtx": mtx_fixture(),
    }


def bucketizer(**kw):
    return Bucketizer((BUCKET,), device="cpu", **kw)


def service(**kw):
    kw.setdefault("bucketizer", bucketizer())
    kw.setdefault("config", CFG)
    kw.setdefault("warm_start", "cheap")
    return MatchingService(**kw)


@functools.lru_cache(maxsize=None)
def ref_state(name_or_seed, cfg=REF_CFG, ws="cheap"):
    """The reference's ``Matcher.run`` on the reference's admission of the
    graph (its lanes of ``run_many`` are the same, test_torch_batch.py)."""
    g = _graph(name_or_seed)
    adm = RefBucketizer((ref_serving.SizeBucket(*BUCKET.key),)).admit(
        g, csc=cfg.dirop or None)
    return RefMatcher(cfg, ws).run(adm.graph)


def _graph(name_or_seed):
    if isinstance(name_or_seed, str):
        return families()[name_or_seed]
    return random_bipartite(*name_or_seed)


def assert_same_state(res, key, cfg=REF_CFG, ws="cheap"):
    want = ref_state(key, cfg, ws)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(res.state, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


# ---------------------------------------------------------------------------
# Bucketizer: placement, padding, typed rejection
# ---------------------------------------------------------------------------
def test_bucketizer_pads_onto_declared_bucket():
    g = random_bipartite(200, 180, 3.0, seed=1)
    adm = bucketizer().admit(port(g))
    ref = RefBucketizer((ref_serving.SizeBucket(*BUCKET.key),)).admit(g)
    assert adm.route == "bucket" and adm.bucket == BUCKET
    assert (adm.graph.nc, adm.graph.nr) == (256, 256)
    assert adm.graph.nnz_pad == 2048
    assert (adm.nc, adm.nr, adm.nnz) == (200, 180, g.nnz)
    assert adm.pad_edges == ref.pad_edges == 2048 - g.nnz
    assert adm.pad_vertex_slots == ref.pad_vertex_slots
    for name in ("cxadj", "cadj", "ecol"):
        np.testing.assert_array_equal(getattr(adm.graph, name).numpy(),
                                      np.asarray(getattr(ref.graph, name)))
    st = Matcher(CFG, warm_start="cheap").run(adm.graph)
    assert int(st.cardinality) == int(ref_state((200, 180, 3.0, 1))
                                      .cardinality)


def test_bucketizer_accepts_device_graph():
    g = random_bipartite(100, 90, 3.0, seed=4)
    adm = bucketizer().admit(TorchCSR.from_host(port(g), device="cpu"))
    assert adm.bucket == BUCKET and adm.graph.nnz_pad == 2048
    st = Matcher(CFG, warm_start="cheap").run(adm.graph)
    assert int(st.cardinality) == int(ref_state((100, 90, 3.0, 4))
                                      .cardinality)


def test_bucketizer_oversize_typed_rejection():
    big = random_bipartite(400, 400, 3.0, seed=5)
    with pytest.raises(OversizeGraphError) as ei:
        bucketizer().admit(port(big))
    assert (ei.value.nc, ei.value.nr) == (400, 400)
    assert ei.value.largest == BUCKET
    assert isinstance(ei.value, ValueError)


def test_bucketizer_picks_smallest_fitting_bucket():
    small, large = SizeBucket(128, 128, 1024), SizeBucket(512, 512, 4096)
    bz = Bucketizer((large, small), device="cpu")   # order must not matter
    assert bz.admit(port(random_bipartite(100, 100, 3.0, seed=6))
                    ).bucket == small
    assert bz.admit(port(random_bipartite(300, 300, 3.0, seed=6))
                    ).bucket == large


# ---------------------------------------------------------------------------
# The sharded lane: oversize graphs through ShardedMatcher over a CPU mesh
# ---------------------------------------------------------------------------
MESH = make_mesh((4,), ("data",), devices=["cpu"] * 4)
BIG = (320, 320, 3.0, 11)          # random_bipartite arguments and seed


def sharded_service(**kw):
    kw.setdefault("bucketizer", bucketizer(oversize="shard"))
    return service(mesh=MESH, **kw)


def single_device_state(g, cfg=CFG, ws="cheap"):
    """The port's single-device ``Matcher.run`` of the admitted (edge-
    bucketed) graph and the reference's, which must agree."""
    ours = Matcher(cfg, ws).run(
        TorchCSR.from_host(port(g), device="cpu").bucketed())
    ref = RefMatcher(REF_CFG, ws).run(
        RefBucketizer((ref_serving.SizeBucket(*BUCKET.key),),
                      oversize="shard").admit(g).graph)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ours, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)
    return ours


def test_bucketizer_admits_oversize_on_the_sharded_route():
    big = random_bipartite(*BIG[:3], seed=BIG[3])
    adm = bucketizer(oversize="shard").admit(port(big))
    ref = RefBucketizer((ref_serving.SizeBucket(*BUCKET.key),),
                        oversize="shard").admit(big)
    assert adm.route == ref.route == "sharded"
    assert adm.bucket is None and ref.bucket is None
    assert (adm.nc, adm.nr, adm.nnz) == (ref.nc, ref.nr, ref.nnz)
    for name in ("cxadj", "cadj", "ecol"):
        np.testing.assert_array_equal(getattr(adm.graph, name).numpy(),
                                      np.asarray(getattr(ref.graph, name)))
    assert bucketizer(oversize="shard").admit(
        port(big), csc=True).graph.has_csc


def test_service_routes_oversize_to_sharded_matcher():
    big = random_bipartite(*BIG[:3], seed=BIG[3])
    with sharded_service() as svc:
        res = svc.submit(port(big)).result(timeout=T)
        snap = svc.metrics.snapshot()
    assert res.route == "sharded" and res.bucket is None
    assert res.stats.variant == f"sharded-{CFG.name}@4"
    want = single_device_state(big)
    for f in FIELDS:
        assert torch.equal(getattr(res.state, f), getattr(want, f)), f
    cm, rm = res.matching()
    assert validate_matching(port(big), cm, rm) == res.cardinality
    assert res.certified
    assert snap["sharded"] == 1 and snap["completed"] == 1
    assert snap["dispatches"] == 1


def test_service_mesh_serves_both_lanes():
    """A mesh-built service makes its own bucketizer shard oversize graphs
    (on the mesh's device); in-bucket requests still batch, each result
    the reference's, and the oversize one goes down the sharded lane."""
    big = random_bipartite(4200, 4200, 2.0, seed=12)     # past the ladder
    with MatchingService(config=CFG, warm_start="cheap", mesh=MESH,
                         max_batch=4) as svc:
        assert svc.bucketizer.oversize == "shard"
        assert svc.device == torch.device("cpu")
        small = [svc.submit(port(families()[n])) for n in ("random", "kron")]
        over = svc.submit(port(big))
        svc.drain()
        snap = svc.metrics.snapshot()
    res = over.result(timeout=T)
    assert res.route == "sharded" and res.certified
    assert res.cardinality == int(Matcher(CFG, "cheap").run(
        TorchCSR.from_host(port(big), device="cpu").bucketed()).cardinality)
    assert [f.result(timeout=T).route for f in small] == ["bucket"] * 2
    assert snap["sharded"] == 1 and snap["completed"] == 3
    with pytest.raises(AssertionError, match="needs a mesh"):
        MatchingService(bucketizer=bucketizer(oversize="shard"))


def test_sharded_lane_quarantines_a_failure(tmp_path):
    """A request whose sharded dispatch fails gets the real error and a
    quarantine artifact; the lane goes on serving."""
    faults = FaultInjector(seed=0)
    faults.poison("bad")
    big = random_bipartite(*BIG[:3], seed=BIG[3])
    with sharded_service(faults=faults,
                         quarantine_dir=str(tmp_path)) as svc:
        bad = svc.submit(port(big), tag="bad")
        exc = bad.exception(timeout=T)
        good = svc.submit(port(big)).result(timeout=T)
        snap = svc.metrics.snapshot()
    assert isinstance(exc, PoisonedGraphFault)
    assert exc.quarantine_artifact.endswith("quarantine_bad.json")
    assert good.route == "sharded" and good.certified
    assert snap["quarantined"] == 1 and snap["failed"] == 1
    assert snap["sharded"] == 1


# ---------------------------------------------------------------------------
# Scheduler: full/deadline/drain policy, adaptive target, batch ladder
# ---------------------------------------------------------------------------
def test_batch_ladder_and_bucket():
    for n in (1, 2, 6, 8, 16):
        assert batch_ladder(n) == ref_serving.batch_ladder(n)
        for k in range(1, n + 1):
            assert batch_bucket(k, n) == ref_serving.batch_bucket(k, n)
    assert batch_ladder(8) == (1, 2, 4, 8)
    assert batch_ladder(6) == (1, 2, 4, 6)
    assert batch_bucket(3, 8) == 4 and batch_bucket(5, 6) == 6


def test_scheduler_fixed_target_flushes_on_full():
    mb = MicroBatcher(max_batch=4, max_delay_s=1.0, adaptive=False)
    for i in range(3):
        assert mb.add("k", i, now=0.0) is None
    flush = mb.add("k", 3, now=0.0)
    assert flush is not None and flush.reason == "full"
    assert len(flush.items) == 4 and mb.pending == 0


def test_scheduler_deadline_flush_with_fake_clock():
    mb = MicroBatcher(max_batch=4, max_delay_s=0.5, adaptive=False)
    mb.add("k", "a", now=10.0)
    assert mb.due(now=10.4) == []
    assert mb.next_deadline() == 10.5
    (flush,) = mb.due(now=10.5)
    assert flush.reason == "deadline" and len(flush.items) == 1
    assert mb.next_deadline() is None


def test_scheduler_adaptive_target_follows_the_reference():
    """The same fake-clock trace through both batchers: the same flushes,
    reasons and targets at every step."""
    ours = MicroBatcher(max_batch=8, max_delay_s=0.5, adaptive=True)
    ref = ref_serving.MicroBatcher(max_batch=8, max_delay_s=0.5,
                                   adaptive=True)
    trace = [("add", 0.0), ("add", 0.0), ("add", 0.0), ("add", 1.0),
             ("due", 2.0), ("add", 3.0), ("add", 3.1), ("add", 3.1),
             ("due", 4.0), ("add", 5.0)]
    for i, (op, now) in enumerate(trace):
        if op == "add":
            a, b = ours.add("k", i, now=now), ref.add("k", i, now=now)
            got = None if a is None else (a.reason, len(a.items), a.target)
            want = None if b is None else (b.reason, len(b.items), b.target)
        else:
            got = [(f.reason, len(f.items)) for f in ours.due(now)]
            want = [(f.reason, len(f.items)) for f in ref.due(now)]
        assert got == want, (i, op)
        assert ours.target("k") == ref.target("k")


def test_scheduler_drain_and_evict_oldest():
    mb = MicroBatcher(max_batch=8, max_delay_s=9.0, adaptive=False)
    mb.add("a", 1, now=1.0)
    mb.add("b", 2, now=0.5)
    mb.add("b", 3, now=2.0)
    assert mb.oldest_enqueued_at() == 0.5
    assert mb.evict_oldest().payload == 2
    flushes = mb.drain()
    assert {f.key for f in flushes} == {"a", "b"}
    assert all(f.reason == "drain" for f in flushes)
    assert mb.pending == 0 and mb.evict_oldest() is None


# ---------------------------------------------------------------------------
# Service: parity, deadline flush, warm-up, refusals
# ---------------------------------------------------------------------------
def test_service_parity_across_generator_families():
    fams = families()
    with service(max_batch=4, max_delay_ms=20.0) as svc:
        svc.warm_up()
        futs = {name: svc.submit(port(g)) for name, g in fams.items()}
        for name, g in fams.items():
            res = futs[name].result(timeout=T)
            assert res.route == "bucket"
            assert res.cardinality == int(ref_state(name).cardinality), name
            assert_same_state(res, name)
            cm, rm = res.matching()
            assert cm.shape == (g.nc,) and rm.shape == (g.nr,)
            assert validate_matching(port(g), cm, rm) == res.cardinality
        snap = svc.metrics.snapshot()
    assert snap["completed"] == len(fams)
    assert 1 <= snap["dispatches"] <= len(fams)


@pytest.mark.parametrize("family", sorted(families()))
def test_service_submit_matches_reference(family):
    g = families()[family]
    with service(max_batch=2, max_delay_ms=5.0) as svc:
        res = svc.submit(port(g)).result(timeout=T)
    assert res.cardinality == int(ref_state(family).cardinality)
    assert_same_state(res, family)
    cm, rm = res.matching()
    assert validate_matching(port(g), cm, rm) == res.cardinality


def test_service_deadline_flush_resolves_single_request():
    g = random_bipartite(128, 128, 3.0, seed=9)
    with service(max_batch=8, max_delay_ms=30.0, adaptive=False) as svc:
        res = svc.submit(port(g)).result(timeout=T)
        snap = svc.metrics.snapshot()
    assert_same_state(res, (128, 128, 3.0, 9))
    # one request against max_batch=8 (fixed target) can only flush via the
    # deadline path
    assert snap["flushes_deadline"] == 1 and snap["flushes_full"] == 0
    assert snap["dispatches"] == 1 and res.batch_size == 1


def test_warmup_makes_first_dispatch_compile_free():
    compile_cache_clear()
    g = random_bipartite(200, 180, 3.0, seed=1)
    with service(max_batch=4, max_delay_ms=5.0) as svc:
        report = svc.warm_up()
        assert report.cells == len(batch_ladder(4))   # 1 bucket x 1 cfg x 1 ws
        assert report.compiled == report.cells        # cold cache: all built
        assert report.entry_bytes > 0
        misses0 = compile_cache_info()["misses"]
        res = svc.submit(port(g)).result(timeout=T)
        svc.drain()
        snap = svc.metrics.snapshot()
    assert res.cardinality > 0
    # a warmed bucket's first dispatch is a pure cache hit
    assert compile_cache_info()["misses"] == misses0
    assert snap["compile_misses"] == 0 and snap["compile_hits"] >= 1
    # warming again is a no-op
    with service(max_batch=4) as svc2:
        report2 = svc2.warm_up()
    assert report2.compiled == 0 and report2.already == report2.cells


@pytest.mark.parametrize("kernel_cfg", [
    dict(use_pallas=True),
    dict(use_pallas=True, pallas_fused=False),
    dict(dirop=True),
    dict(dirop=True, use_pallas=True),
], ids=["pallas_fused", "legacy", "dirop", "dirop_pallas"])
def test_warmup_zero_miss_across_kernel_paths(kernel_cfg):
    """A service on each kernel path gets a compile-free first dispatch
    after warm-up (the mirrored shape for dirop included), and the
    reference's state."""
    compile_cache_clear()
    cfg = dataclasses.replace(CFG, **kernel_cfg)
    g = random_bipartite(200, 180, 3.0, seed=1)
    with service(config=cfg, max_batch=4, max_delay_ms=5.0) as svc:
        report = svc.warm_up()
        assert report.compiled == report.cells
        misses0 = compile_cache_info()["misses"]
        res = svc.submit(port(g)).result(timeout=T)
        svc.drain()
        snap = svc.metrics.snapshot()
    assert compile_cache_info()["misses"] == misses0
    assert snap["compile_misses"] == 0 and snap["compile_hits"] >= 1
    assert_same_state(res, (200, 180, 3.0, 1),
                      dataclasses.replace(REF_CFG, **kernel_cfg))


def test_service_rejects_adaptive_frontier_synchronously():
    g = random_bipartite(128, 128, 3.0, seed=21)
    acfg = dataclasses.replace(CFG, adaptive_frontier=True)
    with pytest.raises(ValueError, match="dirop"):
        MatchingService(bucketizer=bucketizer(), config=acfg)
    with service(max_batch=4, max_delay_ms=5.0) as svc:
        with pytest.raises(ValueError, match="dirop"):
            svc.submit(port(g), config=acfg)
        res = svc.submit(port(g)).result(timeout=T)   # service still serves
        assert_same_state(res, (128, 128, 3.0, 21))


def test_dirop_admission_attaches_csc_mirror():
    bz = bucketizer()
    g = port(random_bipartite(200, 180, 3.0, seed=1))
    assert not bz.admit(g).graph.has_csc
    assert bz.admit(g, csc=True).graph.has_csc
    mirrored = bucketizer(build_csc=True).admit(g).graph
    assert mirrored.has_csc and mirrored.bucket_key == BUCKET.key + ("csc",)


def test_service_rejects_oversize():
    big = random_bipartite(320, 320, 3.0, seed=11)
    with service() as svc:
        with pytest.raises(OversizeGraphError):
            svc.submit(port(big))
        snap = svc.metrics.snapshot()
    assert snap["rejected"] == 1 and snap["submitted"] == 0


def test_service_cancelled_future_does_not_poison_the_flush():
    g1 = random_bipartite(128, 128, 3.0, seed=13)
    g2 = random_bipartite(130, 130, 3.0, seed=14)
    with service(max_batch=4, max_delay_ms=60.0, adaptive=False) as svc:
        f1 = svc.submit(port(g1))
        f2 = svc.submit(port(g2))
        assert f1.cancel()                     # still queued: cancel wins
        res2 = f2.result(timeout=T)            # deadline flush serves g2
        assert_same_state(res2, (130, 130, 3.0, 14))
    assert f1.cancelled()


def test_service_survives_bad_per_request_warm_start():
    g = random_bipartite(128, 128, 3.0, seed=12)
    with service(max_batch=4, max_delay_ms=5.0) as svc:
        with pytest.raises(KeyError):
            svc.submit(port(g), warm_start="not-a-warm-start")
        res = svc.submit(port(g)).result(timeout=T)
        assert_same_state(res, (128, 128, 3.0, 12))


def test_synthetic_bucket_graph_shape():
    g = synthetic_bucket_graph(BUCKET, device="cpu")
    ref = ref_serving.synthetic_bucket_graph(
        ref_serving.SizeBucket(*BUCKET.key))
    assert g.bucket_key == ref.bucket_key == BUCKET.key and g.nnz == 0
    for name in ("cxadj", "cadj", "ecol"):
        np.testing.assert_array_equal(getattr(g, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    assert synthetic_bucket_graph(BUCKET, csc=True, device="cpu").has_csc


# the world lane's names: the reference's one controller drives its mesh
# and has no other ranks to serve
WORLD_LANE_NAMES = {"LaneRankError", "WorldLane", "serve_followers"}


def test_metrics_snapshot_keys_and_public_names_equal_the_reference():
    assert set(ServiceMetrics().snapshot()) == \
        set(ref_serving.ServiceMetrics().snapshot())
    assert set(serving.__all__) - WORLD_LANE_NAMES == \
        set(ref_serving.__all__)
    assert WORLD_LANE_NAMES <= set(serving.__all__)
    for name in ref_serving.__all__:
        ours, ref = getattr(serving, name), getattr(ref_serving, name)
        if inspect.isclass(ref) and issubclass(ref, BaseException):
            assert [c.__name__ for c in ours.__mro__] == \
                [c.__name__ for c in ref.__mro__], name


@pytest.mark.parametrize("extra", [[], ["--chaos"], ["--shards", "4"],
                                   ["--world", "2"]],
                         ids=["smoke", "chaos", "sharded", "world"])
def test_serve_matching_smoke_on_cpu(extra, capfd):
    """``python -m repro_torch.launch.serve_matching --smoke --device cpu``
    (and with the fault drill, with four shards for the oversize lane, and
    with the lane over a world of two ranks, whose rank 0 prints from its
    own process) exits 0: every request at the direct matcher's
    cardinality, the poison isolated, the thread restarted, the oversize
    graph sharded, its state the direct run's bit for bit."""
    from repro_torch.launch.serve_matching import main
    assert main(["--smoke", "--device", "cpu", *extra]) == 0
    out = capfd.readouterr().out
    assert "smoke OK" in out
    lane = "--shards" in extra or "--world" in extra
    assert ("oversize route=sharded" in out) == lane
    if lane:
        assert "(ok)" in out.split("oversize route=sharded")[1]
    assert ("rank 1 of 2 joined 1 sharded runs" in out) == \
        ("--world" in extra)
