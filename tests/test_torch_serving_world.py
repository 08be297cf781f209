"""The matching service's oversize lane over a world of ranks (gloo, the
CPU), against the port's single-device ``Matcher.run`` and the JAX
package's matcher and service.

A ``MatchingService`` whose mesh spans a world runs on rank 0; the other
ranks run ``serve_followers``.  In one world of 2 (a module fixture):

* the oversize graph under ``none``, ``cheap`` and ``karp_sipser``: rank
  0's ``cmatch``, ``rmatch``, ``phases``, ``fallbacks`` and ``certified``
  and every follower's (by digest and counts) equal the port's
  single-device ``Matcher.run`` of the admitted (edge-bucketed) graph and
  the reference's ``Matcher`` of the reference's admitted graph, bit for
  bit; the variant reads ``sharded-<config>@2``; through the ``legacy``
  and ``dirop_pallas`` paths too (the CSC mirror's slice built on each
  rank), against the port's single-device run;
* in-bucket requests stay on rank 0: no header is sent for them;
* the fault drill: a poisoned request quarantined before any header, a
  flush thread killed before a sharded dispatch (restarted), the next
  request served on every rank, a request the follower refuses (its
  matcher patched in the rank function) quarantined on rank 0
  (``LaneRankError``); ``close()`` sends one
  ``stop``, and each follower's served count equals rank 0's ``sharded``
  metric; a service whose dead flush thread nobody restarts still
  releases the followers at ``close()``;
* an idle lane past a world timeout cut to ``IDLE_TIMEOUT``: the idle
  headers keep the followers' waits within it, and the lane then serves;
  then in-bucket traffic alone, a batch ready on every pass of the flush
  thread, for longer than that timeout: the idle headers still go out
  between the dispatches, and the lane then serves on both ranks.

A world of 4 under ``warm_start="none"`` against the reference's
``MatchingService(mesh=...)`` on a forced four-device host (one
subprocess, started first and read last).  Every comparison is exact.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import torch_world_ranks as ranks
from repro.graphs import random_bipartite
from repro.matching import Matcher as RefMatcher
from repro.matching import MatcherConfig as RefConfig
from repro.serving import Bucketizer as RefBucketizer
from repro.serving import SizeBucket as RefBucket

from repro_torch.core.csr import BipartiteCSR
from repro_torch.distributed import run_world
from repro_torch.matching import (SOLVE_PATHS, Matcher, MatcherConfig,
                                  TorchCSR)
from repro_torch.serving import Bucketizer, SizeBucket
from repro_torch.serving.world_lane import matching_digest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARM_STARTS = ("none", "cheap", "karp_sipser")
RUNS = [("jnp", ws) for ws in WARM_STARTS] + [("legacy", "cheap"),
                                              ("dirop_pallas", "cheap")]
BIG = (320, 320, 3.0, 11)            # random_bipartite, past the bucket
SMALL = ((200, 180, 3.0, 1), (150, 160, 3.0, 3))
IDLE_TIMEOUT = 3.0                   # the world's timeout, cut, seconds


def port(g) -> BipartiteCSR:
    return BipartiteCSR(nc=int(g.nc), nr=int(g.nr), nnz=int(g.nnz),
                        cxadj=np.asarray(g.cxadj), cadj=np.asarray(g.cadj),
                        ecol=np.asarray(g.ecol))


def graph(spec) -> BipartiteCSR:
    return port(random_bipartite(*spec[:3], seed=spec[3]))


REF_SERVICE = """
import sys
import time
import jax, numpy as np
from repro.graphs import random_bipartite
from repro.matching import MatcherConfig
from repro.serving import Bucketizer, MatchingService, SizeBucket
assert jax.device_count() == 4, jax.device_count()
svc = MatchingService(
    bucketizer=Bucketizer((SizeBucket(*%r),), oversize="shard",
                          validate=True),
    config=MatcherConfig(), warm_start="none",
    mesh=jax.make_mesh((4,), ("data",)))
res = svc.submit(random_bipartite(*%r, seed=%r)).result(timeout=300)
svc.close()
np.savez(sys.argv[1], variant=res.stats.variant, route=res.route,
         **{f: np.asarray(getattr(res.state, f))
            for f in ("cmatch", "rmatch", "phases", "fallbacks",
                      "certified")})
print("REF_OK")
""" % (ranks.LANE_BUCKET, BIG[:3], BIG[3])


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's service lane on four forced devices, started at
    once and read when first needed."""
    path = str(tmp_path_factory.mktemp("ref_lane") / "state.npz")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=f"{REPO}/src")
    proc = subprocess.Popen([sys.executable, "-c", REF_SERVICE, path],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
    proc.wait()


@pytest.fixture(scope="module")
def world(reference, tmp_path_factory):
    store = str(tmp_path_factory.mktemp("lane_world") / "store")
    return run_world(ranks.lane_suite, 2, graph(BIG),
                     [graph(s) for s in SMALL], RUNS, store,
                     IDLE_TIMEOUT, device="cpu", timeout=300)


def single_device_state(ws: str, path: str = "jnp"):
    """The port's single-device ``Matcher.run`` of the admitted graph and,
    on the default path, the reference's, which must agree."""
    g = random_bipartite(*BIG[:3], seed=BIG[3])
    cfg = SOLVE_PATHS[path].configure(MatcherConfig())
    t = TorchCSR.from_host(port(g), device="cpu").bucketed()
    ours = Matcher(cfg, ws).run(t.with_csc() if cfg.dirop else t)
    if path != "jnp":
        return ranks.outcome(ours)
    ref = RefMatcher(RefConfig(), ws).run(
        RefBucketizer((RefBucket(*ranks.LANE_BUCKET),),
                      oversize="shard").admit(g).graph)
    want = ranks.outcome(ours)
    for f, a, b in zip(ranks.FIELDS, want, (getattr(ref, f)
                                            for f in ranks.FIELDS)):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)
    return want


def check_served(res: dict, want, size: int, path: str = "jnp") -> None:
    assert res.get("error") is None, res
    assert res["route"] == "sharded" and res["bucket"] is None
    cfg = SOLVE_PATHS[path].configure(MatcherConfig())
    assert res["variant"] == f"sharded-{cfg.name}@{size}"
    for f, a, b in zip(ranks.FIELDS, res["state"], want):
        np.testing.assert_array_equal(a, b, err_msg=f)


def check_follower_run(run: dict, want) -> None:
    assert run["digest"] == matching_digest(want[0], want[1])
    assert [run["phases"], run["fallbacks"], run["certified"]] == \
        [int(want[2]), int(want[3]), bool(want[4])]


@pytest.mark.parametrize("path,ws", RUNS)
def test_world_lane_equals_single_device(world, path, ws):
    want = single_device_state(ws, path)
    rank0, follower = world
    check_served(rank0["suite"][(path, ws)], want, 2, path)
    check_follower_run(follower["suite"]["runs"][RUNS.index((path, ws))],
                       want)


def test_in_bucket_requests_stay_on_rank_0(world):
    rank0, follower = world
    assert [r["route"] for r in rank0["suite"]["small"]] == ["bucket"] * 2
    before, after = rank0["sent_around_small"]
    assert before["run"] == after["run"] == len(RUNS)
    for spec, res in zip(SMALL, rank0["suite"]["small"]):
        adm = Bucketizer((SizeBucket(*ranks.LANE_BUCKET),),
                         device="cpu").admit(graph(spec))
        want = Matcher(MatcherConfig(), "cheap").run(adm.graph)
        for f, a, b in zip(ranks.FIELDS, res["state"], ranks.outcome(want)):
            np.testing.assert_array_equal(a, b, err_msg=f)


def test_fault_drill_keeps_the_followers_in_step(world):
    """The poisoned request and the killed flush thread fail before any
    header (rank 0 sent headers for the served runs and the request the
    follower refused alone), the follower's refusal quarantines on rank 0,
    and the served counts agree."""
    rank0, follower = world
    got, snap = rank0["suite"], rank0["snap"]
    assert got["poisoned"]["error"] == "PoisonedGraphFault"
    assert got["killed"]["error"] == "FlushThreadDiedError"
    assert got["follower-bad"]["error"] == "LaneRankError"
    assert "rank 1 of 2 could not take" in got["follower-bad"]["message"]
    want = single_device_state("cheap")
    check_served(got["after"], want, 2)
    served = follower["suite"]
    assert served["served"] == snap["sharded"] == len(RUNS) + 1
    assert served["failed"] == 1 and "this rank refuses the request" in \
        served["errors"][0]
    check_follower_run(served["runs"][-1], want)
    assert snap["quarantined"] == 2 and snap["restarts"] == 1
    assert rank0["sent"]["run"] == len(RUNS) + 2
    assert rank0["sent"]["stop"] == 1


def test_close_releases_followers_after_a_dead_flush_thread(world):
    rank0, follower = world
    assert rank0["dead"]["result"]["error"] == "ServiceClosedError"
    assert rank0["dead"]["sent"]["stop"] == 1
    assert rank0["dead"]["sent"]["run"] == 0
    assert follower["dead"]["served"] == follower["dead"]["failed"] == 0


def test_idle_lane_outlives_the_world_timeout(world):
    rank0, follower = world
    idle = rank0["idle"]
    assert idle["timeout"] == IDLE_TIMEOUT
    assert idle["idle_s"] == IDLE_TIMEOUT / 4
    check_served(idle["result"], single_device_state("cheap"), 2)
    assert idle["sent"]["idle"] >= 2 and idle["sent"]["run"] == 1
    assert follower["idle"]["runs"][0]["digest"] == matching_digest(
        *single_device_state("cheap")[:2])


def test_in_bucket_traffic_alone_outlives_the_world_timeout(world):
    """A batch ready on every pass for 1.5 world timeouts: the flush
    thread still sends idle headers between the dispatches (no run
    header), the followers outlive the stretch, and the next oversize
    request is served on both ranks."""
    rank0, follower = world
    idle, busy = rank0["idle"], rank0["busy"]
    assert len(busy["routes"]) >= 12
    assert set(busy["routes"]) == {"bucket"}
    assert busy["sent"]["run"] == idle["sent"]["run"] == 1
    assert busy["sent"]["idle"] - idle["sent"]["idle"] >= 4
    want = single_device_state("cheap")
    check_served(busy["result"], want, 2)
    assert busy["closed"]["stop"] == 1 and busy["closed"]["run"] == 2
    assert follower["idle"]["served"] == 2 and not follower["idle"]["failed"]
    check_follower_run(follower["idle"]["runs"][1], want)
    assert follower["idle"]["idle"] == busy["closed"]["idle"]


def test_world_of_four_equals_reference_service(reference):
    got = [r["got"] for r in run_world(
        ranks.lane_runs, 4, graph(BIG), [("jnp", "none")], device="cpu",
        timeout=300)]
    proc, path = reference
    out, err = proc.communicate(timeout=400)
    assert "REF_OK" in out, err[-3000:]
    ref = dict(np.load(path))
    want = tuple(ref[f] for f in ranks.FIELDS)
    assert str(ref["route"]) == "sharded"
    assert str(ref["variant"]) == f"sharded-{MatcherConfig().name}@4"
    check_served(got[0][0], want, 4)
    check_served(got[0][0], single_device_state("none"), 4)
    for follower in got[1:]:
        assert follower["served"] == 1 and not follower["failed"]
        check_follower_run(follower["runs"][0], want)


def test_a_failed_lane_fails_later_requests_and_sends_nothing(tmp_path):
    """A world of one rank in this process: once a collective of the
    lane's own has failed (``lane.error``), every later oversize request
    is quarantined with it, no idle header or ``stop`` is sent, and the
    flush thread keeps running (nothing restarts it)."""
    from repro_torch.distributed import close_world, init_world
    world = init_world(0, 1, f"file://{tmp_path}/store", device="cpu",
                       timeout=0.4)
    try:
        svc = ranks._lane_service(world)
        assert svc.submit(graph(BIG)).result(timeout=120).route == "sharded"
        svc.lane.error = RuntimeError("a rank is gone")
        exc = svc.submit(graph(BIG)).exception(timeout=120)
        time.sleep(4 * svc.lane.idle_s)
        svc.close()
        snap = svc.metrics.snapshot()
    finally:
        close_world()
    assert isinstance(exc, RuntimeError) and "failed earlier" in str(exc)
    assert snap["quarantined"] == 1 and snap["restarts"] == 0
    assert svc.lane.sent["run"] == 1 and svc.lane.sent["stop"] == 0
    assert svc.lane.next_idle() is None
