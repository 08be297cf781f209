"""The port's fault-tolerant serving against the JAX package's.

The scenarios of ``tests/test_serving_faults.py``, driven through the
port's :class:`repro_torch.serving.FaultInjector` on the CPU: structural
validation at admission, bisection quarantine (innocents get the
reference's state; the poison fails with the real error and a
``repro-serving-quarantine/1`` artifact whose keys equal the reference's),
the singleton retry, flush-thread death and restart, deadline shedding,
both shed policies under overload with the metrics sum invariant, the
phase budget's certified-False maximal matching (served, and through
``run_many`` on every batchable path against the reference), and
``close()`` stranding no future.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

from repro.graphs import instance_sets, random_bipartite
from repro.matching import DeviceCSR, Matcher as RefMatcher
from repro.matching import MatcherConfig as RefConfig
import repro.serving as ref_serving

from repro_torch.core import is_maximal, validate_matching
from repro_torch.core.csr import BipartiteCSR
from repro_torch.matching import (GraphValidationError, Matcher,
                                  MatcherConfig, TorchCSR)
from repro_torch.serving import (Bucketizer, DeadlineExceededError,
                                 FaultInjector, FlushThreadDiedError,
                                 MatchingService, PoisonedGraphFault,
                                 QueueFullError, ServiceClosedError,
                                 SheddedError, SizeBucket)
from repro_torch.serving.service import QUARANTINE_SCHEMA

CFG = MatcherConfig(algo="apfb", kernel="gpubfs_wr", schedule="ct")
BUCKET = SizeBucket(256, 256, 2048)
T = 120          # every future's timeout, seconds


def port(g) -> BipartiteCSR:
    return BipartiteCSR(nc=g.nc, nr=g.nr, nnz=g.nnz, cxadj=g.cxadj,
                        cadj=g.cadj, ecol=g.ecol)


def graphs(n, seed0=100):
    return [random_bipartite(180 + i, 170 + i, 3.0, seed=seed0 + i)
            for i in range(n)]


def make_service(**kw):
    kw.setdefault("bucketizer", Bucketizer((BUCKET,), validate=True,
                                           device="cpu"))
    kw.setdefault("config", CFG)
    kw.setdefault("warm_start", "cheap")
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_delay_ms", 60.0)
    kw.setdefault("adaptive", False)
    kw.setdefault("supervisor_interval_s", 0.02)
    return MatchingService(**kw)


def check_sum_invariant(snap):
    """Every accepted request is accounted for exactly once."""
    assert snap["submitted"] == (snap["completed"] + snap["failed"]
                                 + snap["cancelled"] + snap["shed_oldest"]
                                 + snap["deadline_misses"]), snap


def ref_run(g, cfg=RefConfig(), ws="cheap"):
    adm = ref_serving.Bucketizer((ref_serving.SizeBucket(*BUCKET.key),)
                                 ).admit(g)
    return RefMatcher(cfg, ws).run(adm.graph)


def assert_reference_state(res, g):
    want = ref_run(g)
    for f in ("cmatch", "rmatch", "phases", "fallbacks", "certified"):
        np.testing.assert_array_equal(getattr(res.state, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


# ---------------------------------------------------------------------------
# validate: structural admission checks
# ---------------------------------------------------------------------------
def test_admission_rejects_structurally_corrupt_graph():
    g = port(graphs(1)[0])
    bad_cadj = g.cadj.copy()
    bad_cadj[0] = g.nr + 5                       # row endpoint out of range
    bad = dataclasses.replace(g, cadj=bad_cadj)
    with make_service() as svc:
        with pytest.raises(GraphValidationError) as ei:
            svc.submit(bad)
        assert any("cadj" in p for p in ei.value.problems)
        res = svc.submit(g).result(timeout=T)    # service unharmed
        snap = svc.metrics.snapshot()
    assert res.cardinality > 0
    assert snap["rejected"] == 1 and snap["submitted"] == 1


# ---------------------------------------------------------------------------
# quarantine: bisection isolates the poison, innocents succeed
# ---------------------------------------------------------------------------
def _ref_quarantine_keys(tmp_path) -> set:
    """The keys of the reference's quarantine artifact for one poisoned
    request (its own service, on the CPU)."""
    faults = ref_serving.FaultInjector(seed=3)
    faults.poison("bad")
    with ref_serving.MatchingService(
            bucketizer=ref_serving.Bucketizer(
                (ref_serving.SizeBucket(*BUCKET.key),), validate=True),
            config=RefConfig(), warm_start="cheap", max_batch=1,
            max_delay_ms=5.0, adaptive=False, faults=faults,
            quarantine_dir=str(tmp_path / "ref")) as svc:
        fut = svc.submit(graphs(1)[0], tag="bad")
        svc.drain()
    with open(fut.exception(timeout=T).quarantine_artifact) as f:
        return set(json.load(f))


def test_bisection_isolates_exactly_the_poisoned_request(tmp_path):
    faults = FaultInjector(seed=3)
    faults.poison("bad")
    gs = graphs(4)
    with make_service(faults=faults, quarantine_dir=str(tmp_path)) as svc:
        futs = [svc.submit(port(g), tag="bad" if i == 2 else f"ok{i}")
                for i, g in enumerate(gs)]
        svc.drain()
        snap = svc.metrics.snapshot()
    for i, fut in enumerate(futs):
        if i == 2:
            continue
        res = fut.result(timeout=T)              # innocents all served
        assert_reference_state(res, gs[i])
        cm, rm = res.matching()
        assert validate_matching(port(gs[i]), cm, rm) == res.cardinality
    exc = futs[2].exception(timeout=T)
    assert isinstance(exc, PoisonedGraphFault) and exc.tag == "bad"
    art = exc.quarantine_artifact
    assert art and os.path.exists(art)
    with open(art) as f:
        payload = json.load(f)
    assert payload["schema"] == QUARANTINE_SCHEMA == \
        ref_serving.service.QUARANTINE_SCHEMA == "repro-serving-quarantine/1"
    assert payload["tag"] == "bad"
    assert payload["nnz"] == len(payload["edges"]) == gs[2].nnz
    assert set(payload) == _ref_quarantine_keys(tmp_path)
    assert set(payload["config"]) == set(dataclasses.asdict(RefConfig()))
    assert snap["quarantined"] == 1 and snap["failed"] == 1
    assert snap["completed"] == 3
    check_sum_invariant(snap)


def test_singleton_retry_absorbs_transient_fault():
    faults = FaultInjector(seed=4)
    faults.script(RuntimeError("transient device hiccup"))
    g = graphs(1)[0]
    with make_service(faults=faults, max_delay_ms=5.0,
                      dispatch_retries=2) as svc:
        res = svc.submit(port(g)).result(timeout=T)
        snap = svc.metrics.snapshot()
    assert_reference_state(res, g)
    assert snap["quarantined"] == 0 and snap["failed"] == 0
    assert faults.injected == 1                  # the fault did fire


# ---------------------------------------------------------------------------
# restart: flush-thread death -> supervisor fail-over + restart
# ---------------------------------------------------------------------------
def test_thread_death_supervisor_restarts_and_serves():
    faults = FaultInjector(seed=5)
    gs = graphs(4)
    with make_service(faults=faults) as svc:
        faults.kill_thread_after(0)              # very next dispatch dies
        futs = [svc.submit(port(g)) for g in gs]
        excs = [f.exception(timeout=T) for f in futs]
        died = [e for e in excs if isinstance(e, FlushThreadDiedError)]
        assert died, excs                        # in-flight failed over
        assert all(e is None or isinstance(e, FlushThreadDiedError)
                   for e in excs)
        res = svc.submit(port(gs[0])).result(timeout=T)   # after restart
        snap = svc.metrics.snapshot()
    assert_reference_state(res, gs[0])
    assert snap["restarts"] >= 1 and faults.kills == 1
    check_sum_invariant(snap)


def test_close_fails_pending_futures_when_thread_is_dead():
    faults = FaultInjector(seed=6)
    gs = graphs(2)
    svc = make_service(faults=faults, supervise=False)   # nobody restarts
    faults.kill_thread_after(0)
    futs = [svc.submit(port(g)) for g in gs[:2]]
    svc.flush()
    svc._thread.join(timeout=60)                 # let the injected crash land
    assert not svc._thread.is_alive()
    svc.close()                                  # must not strand the futures
    excs = [f.exception(timeout=60) for f in futs]
    assert all(isinstance(e, ServiceClosedError) for e in excs), excs


# ---------------------------------------------------------------------------
# shed: deadlines and bounded-queue policies under overload
# ---------------------------------------------------------------------------
def test_deadline_miss_is_shed_at_flush_time():
    g1, g2 = graphs(2)
    with make_service(max_delay_ms=5.0) as svc:
        late = svc.submit(port(g1), deadline_s=0.0)   # expired at once
        ok = svc.submit(port(g2))
        res = ok.result(timeout=T)
        snap = svc.metrics.snapshot()
    assert isinstance(late.exception(timeout=T), DeadlineExceededError)
    assert_reference_state(res, g2)
    assert snap["deadline_misses"] == 1
    check_sum_invariant(snap)


@pytest.mark.parametrize("policy", ["reject-newest", "reject-oldest"])
def test_shed_policy_under_sustained_overload(policy):
    faults = FaultInjector(seed=7, latency_s=0.08)   # slow device
    gs = graphs(8)
    refused = 0
    futs = []
    with make_service(faults=faults, max_batch=1, max_delay_ms=1.0,
                      max_queue=2, shed_policy=policy) as svc:
        for g in gs:
            try:
                futs.append(svc.submit(port(g)))
            except QueueFullError:
                refused += 1
        svc.drain()
        snap = svc.metrics.snapshot()
    excs = [f.exception(timeout=T) for f in futs]
    evicted = sum(isinstance(e, SheddedError) for e in excs)
    assert all(e is None or isinstance(e, SheddedError) for e in excs), excs
    if policy == "reject-newest":
        assert refused >= 1 and refused == snap["shed_newest"]
        assert evicted == 0 and snap["shed_oldest"] == 0
        assert snap["submitted"] == len(futs)
    else:
        assert refused == 0 and snap["shed_newest"] == 0
        assert evicted >= 1 and evicted == snap["shed_oldest"]
        assert snap["submitted"] == len(gs)
    check_sum_invariant(snap)


def test_cancelled_future_is_counted():
    g1, g2 = graphs(2)
    with make_service() as svc:                  # 60ms delay: stays queued
        f1 = svc.submit(port(g1))
        f2 = svc.submit(port(g2))
        assert f1.cancel()
        assert f2.result(timeout=T).cardinality > 0
        svc.drain()
        snap = svc.metrics.snapshot()
    assert snap["cancelled"] == 1 and snap["completed"] == 1
    check_sum_invariant(snap)


# ---------------------------------------------------------------------------
# degrade: phase budget -> valid maximal matching, certified=False
# ---------------------------------------------------------------------------
def test_phase_budget_degrades_to_certified_false_maximal():
    g = random_bipartite(220, 200, 3.0, seed=42)
    budget = dataclasses.replace(CFG, max_phases=1, degrade_maximal=True)
    with make_service(max_delay_ms=5.0) as svc:
        degraded = svc.submit(port(g), config=budget, warm_start="none"
                              ).result(timeout=T)
        full = svc.submit(port(g)).result(timeout=T)
    assert not degraded.certified                # budget truncated the solve
    cm, rm = degraded.matching()
    card = validate_matching(port(g), cm, rm)    # still a valid matching...
    assert is_maximal(port(g), cm, rm)           # ...and maximal (>= M*/2)
    assert card == degraded.cardinality
    want = ref_run(g, RefConfig(max_phases=1, degrade_maximal=True), "none")
    np.testing.assert_array_equal(degraded.state.cmatch.numpy(),
                                  np.asarray(want.cmatch))
    assert full.certified
    assert full.cardinality == int(ref_run(g).cardinality)
    assert card <= full.cardinality
    assert 2 * card >= full.cardinality          # the maximal-matching bound


@pytest.mark.parametrize("path", [
    {}, dict(use_pallas=True, pallas_fused=False), dict(use_pallas=True),
    dict(dirop=True), dict(dirop=True, use_pallas=True)],
    ids=["jnp", "legacy", "fused", "dirop", "dirop_pallas"])
def test_batched_paths_stay_maximal_under_phase_budget(path):
    """Every batchable solve path at ``max_phases=1`` with degradation:
    each lane valid and maximal, and the reference's ``run_many`` lane."""
    sets = instance_sets("mini")
    names = ("rand", "free", "comb")
    hosts = [sets[n] for n in names]
    nc = max(g.nc for g in hosts)
    nr = max(g.nr for g in hosts)
    cap = max(g.nnz_pad for g in hosts)
    ref_gs = [DeviceCSR.from_host(g, pad_to=cap).pad_vertices(nc, nr)
              for g in hosts]
    kw = dict(path, max_phases=1, degrade_maximal=True)
    if kw.get("dirop"):
        ref_gs = [g.with_csc() for g in ref_gs]
    want = RefMatcher(RefConfig(**kw), "none").run_many(
        DeviceCSR.stack(ref_gs))
    ts = [TorchCSR.from_host(port(g), pad_to=cap, device="cpu")
          .pad_vertices(nc, nr) for g in hosts]
    if kw.get("dirop"):
        ts = [t.with_csc() for t in ts]
    out = Matcher(MatcherConfig(**kw), "none").run_many(TorchCSR.stack(ts))
    for f in ("cmatch", "rmatch", "phases", "fallbacks", "certified"):
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    cms, rms = out.to_host()
    for g, cm, rm in zip(hosts, cms, rms):
        cm, rm = cm[:g.nc], rm[:g.nr]
        assert validate_matching(port(g), cm, rm) >= 0
        assert is_maximal(port(g), cm, rm)
