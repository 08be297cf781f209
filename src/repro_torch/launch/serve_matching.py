"""Open-loop synthetic traffic replay against the matching service.

Generates a mixed trace from the four generator families standing in for the
paper's UFL classes (random / Kronecker / grid / scaled-free), fires it at
the :class:`repro_torch.serving.MatchingService` with Poisson (open-loop)
arrivals
— the trace keeps its own pace whether or not the service keeps up, so
queueing shows up as latency exactly like production traffic — and prints
warmup, per-family, and service-level metrics.

    python -m repro_torch.launch.serve_matching --smoke          # on the card
    python -m repro_torch.launch.serve_matching --smoke --device cpu
    python -m repro_torch.launch.serve_matching --rate 500 --requests 256
    python -m repro_torch.launch.serve_matching --smoke --chaos  # + drill

``--smoke`` shrinks the trace and asserts cardinality parity against a
direct ``Matcher.run`` for every request and, where the service has a
mesh, sends one graph larger than every bucket down the sharded lane.
``--device`` picks where the service runs (default: the CUDA card).  The
mesh: ``--shards D`` puts D shards on that device; by default none.  (The
JAX package's default, a mesh over every card when there are several,
needs a world of ranks, and the service is one process: the launcher says
so and serves without the lane, ROADMAP.md, Queue 1, item 15.)  ``--chaos`` arms a seeded
:class:`repro_torch.serving.FaultInjector` and, after the replay, runs a fault
drill: poisons one tagged request among innocents (asserting bisection
isolates exactly it), then kills the flush thread mid-batch (asserting the
supervisor fails the in-flight futures and restarts, and later submits are
served).  Exit status is non-zero if any fault-tolerance contract is
violated.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Tuple

import numpy as np

from repro_torch.core.csr import BipartiteCSR
from repro_torch.graphs import (grid_graph, kron_graph, random_bipartite,
                                scaled_free)
from repro_torch.matching import Matcher, MatcherConfig, TorchCSR, make_mesh
from repro_torch.matching.sharded import every_device
from repro_torch.serving import (Bucketizer, FaultInjector,
                                 FlushThreadDiedError, MatchingService,
                                 PoisonedGraphFault, SizeBucket, ladder,
                                 percentile)

FAMILIES: Dict[str, Callable[[int, int], BipartiteCSR]] = {
    # name -> (size hint n, seed) -> instance
    "random": lambda n, s: random_bipartite(n, n - n // 8, 3.0, seed=s),
    "kron": lambda n, s: kron_graph(max(4, int(np.log2(max(n, 16)))),
                                    6, seed=s),
    "grid": lambda n, s: grid_graph(max(4, int(np.sqrt(n)))),
    "free": lambda n, s: scaled_free(n, n, 4.0, seed=s),
}


def build_trace(n_requests: int, n_hint: int, seed: int
                ) -> List[Tuple[str, BipartiteCSR]]:
    """Round-robin over the families with varying seeds (mixed workload)."""
    names = list(FAMILIES)
    return [(names[i % len(names)],
             FAMILIES[names[i % len(names)]](n_hint, seed + i))
            for i in range(n_requests)]


def replay(service: MatchingService, trace, rate_rps: float, seed: int):
    """Open-loop submit: arrival i fires at its Poisson timestamp."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate_rps, size=len(trace)))
    t0 = time.perf_counter()
    futures = []
    for (family, g), t_arr in zip(trace, arrivals):
        lag = t0 + t_arr - time.perf_counter()
        if lag > 0:
            time.sleep(lag)
        futures.append((family, g, service.submit(g)))
    return futures


def chaos_drill(service: MatchingService, injector: FaultInjector,
                size: int, seed: int) -> int:
    """The two headline fault drills; returns the number of contract
    violations (0 = the failure model held)."""
    failures = 0
    graphs = [random_bipartite(size, size - size // 8, 3.0, seed=seed + 7000 + i)
              for i in range(6)]

    # 1. poisoned batch: bisection must isolate exactly the tagged request
    injector.poison("bad")
    futs = [service.submit(g, tag="bad" if i == 2 else None)
            for i, g in enumerate(graphs)]
    service.drain()
    for i, fut in enumerate(futs):
        exc = fut.exception(timeout=60)
        if i == 2 and not isinstance(exc, PoisonedGraphFault):
            print(f"[chaos] poisoned request resolved {exc!r}, "
                  "expected PoisonedGraphFault")
            failures += 1
        elif i != 2 and exc is not None:
            print(f"[chaos] innocent co-batched request {i} failed: {exc!r}")
            failures += 1
    injector.cure("bad")

    # 2. flush-thread death: supervisor fails in-flight, restarts, serves
    injector.kill_thread_after(0)       # the very next dispatch dies
    futs = [service.submit(g) for g in graphs[:4]]
    service.flush()
    died = sum(isinstance(f.exception(timeout=60), FlushThreadDiedError)
               for f in futs)
    res = service.submit(graphs[0]).result(timeout=60)   # post-restart
    snap = service.metrics.snapshot()
    print(f"[chaos] quarantined={snap['quarantined']} "
          f"restarts={snap['restarts']} in-flight-failed={died} "
          f"post-restart |M|={res.cardinality}")
    if snap["quarantined"] < 1:
        print("[chaos] FAIL: poisoned request was not quarantined")
        failures += 1
    if snap["restarts"] < 1 or died < 1:
        print("[chaos] FAIL: supervisor did not fail over + restart")
        failures += 1
    return failures


def build_mesh(shards: int, device):
    """The oversize lane's mesh: ``shards`` shards on ``device``.  With
    ``shards`` 0 and one card, none.  With several cards, none either: the
    service is one process, and a lane over cards needs a world of ranks
    (ROADMAP.md, Queue 1, item 15); said, and no lane."""
    if shards:
        return make_mesh((shards,), ("data",),
                         every_device(device)[:1] * shards)
    devices = every_device(device)
    if len(devices) > 1:
        print(f"[serve_matching] {len(devices)} cards, no sharded lane: the "
              f"service is one process, and a lane over cards needs a "
              f"torch.distributed world (ROADMAP.md, Queue 1, item 15); "
              f"--shards D puts D shards on one card")
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="replay synthetic open-loop traffic at the service")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny trace + parity assertions (CI)")
    ap.add_argument("--requests", type=int, default=128)
    ap.add_argument("--rate", type=float, default=300.0,
                    help="offered load, requests/second (open loop)")
    ap.add_argument("--size", type=int, default=1024,
                    help="family size hint (vertices)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--delay-ms", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chaos", action="store_true",
                    help="arm a FaultInjector and run the fault drill "
                         "(poison isolation + flush-thread death/restart) "
                         "after the replay")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="FaultInjector seed (deterministic fault schedule)")
    ap.add_argument("--device", default=None,
                    help="where the service runs (default: the CUDA card)")
    ap.add_argument("--shards", type=int, default=0,
                    help="edge shards of the oversize lane's mesh, all on "
                         "the service's device (default: no lane)")
    args = ap.parse_args(argv)

    if args.smoke:
        args.requests, args.rate, args.size = 12, 500.0, 224
        buckets = (SizeBucket(256, 256, 2048),)
        args.max_batch = 4
    else:
        buckets = ladder(max_vertices=max(256, args.size * 2))

    mesh = build_mesh(args.shards, args.device)
    injector = FaultInjector(seed=args.chaos_seed) if args.chaos else None
    service = MatchingService(
        bucketizer=Bucketizer(buckets,
                              oversize="shard" if mesh else "reject",
                              validate=True, device=args.device),
        config=MatcherConfig(algo="apfb", kernel="gpubfs_wr", schedule="ct"),
        warm_start="cheap", max_batch=args.max_batch,
        max_delay_ms=args.delay_ms, mesh=mesh, faults=injector)
    report = service.warm_up()
    print(f"[serve_matching] {report}")

    trace = build_trace(args.requests, args.size, args.seed)
    futures = replay(service, trace, args.rate, args.seed)
    results = [(fam, g, fut.result(timeout=300)) for fam, g, fut in futures]
    service.drain()

    failures = 0
    per_family: Dict[str, List[float]] = {}
    for fam, g, res in results:
        per_family.setdefault(fam, []).append(res.latency_s)
        if args.smoke:
            direct = Matcher(service.config, service.warm_start).run(
                TorchCSR.from_host(g, device=service.device).bucketed())
            if res.cardinality != int(direct.cardinality):
                print(f"[serve_matching] PARITY FAIL {fam}: "
                      f"{res.cardinality} != {int(direct.cardinality)}")
                failures += 1
    for fam, lats in sorted(per_family.items()):
        print(f"[serve_matching] {fam:>7}: {len(lats):3d} req, "
              f"p50 {percentile(lats, 50) * 1e3:.1f} ms, "
              f"max {max(lats) * 1e3:.1f} ms")

    if args.smoke and mesh is not None:
        # oversize admission: bigger than every declared bucket -> sharded
        big = random_bipartite(512, 512, 4.0, seed=args.seed + 999)
        res = service.submit(big).result(timeout=300)
        direct = Matcher(service.config, service.warm_start).run(
            TorchCSR.from_host(big, device=service.device).bucketed())
        ok = (res.route == "sharded"
              and res.cardinality == int(direct.cardinality))
        print(f"[serve_matching] oversize route={res.route} "
              f"|M|={res.cardinality} ({'ok' if ok else 'FAIL'})")
        failures += 0 if ok else 1

    if args.chaos:
        failures += chaos_drill(service, injector, args.size, args.seed)

    snap = service.metrics.snapshot()
    service.close()
    print(f"[serve_matching] {snap['submitted']} submitted, "
          f"{snap['dispatches']} dispatches "
          f"({snap['submitted'] / max(1, snap['dispatches']):.2f} req/dispatch), "
          f"occupancy {snap['occupancy']:.2f}, "
          f"pad-waste {snap['pad_edge_waste']:.2f}, "
          f"compile {snap['compile_hits']}h/{snap['compile_misses']}m, "
          f"flushes full/deadline/drain = {snap['flushes_full']}/"
          f"{snap['flushes_deadline']}/{snap['flushes_drain']}")
    print(f"[serve_matching] latency p50 {snap['latency_p50_ms']:.1f} ms, "
          f"p99 {snap['latency_p99_ms']:.1f} ms; queue wait p50 "
          f"{snap['queue_wait_p50_ms']:.1f} ms")
    if args.smoke:
        assert snap["dispatches"] <= snap["submitted"], \
            "batched path must not dispatch more than once per request"
        print(f"[serve_matching] smoke {'OK' if not failures else 'FAILED'}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
