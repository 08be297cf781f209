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
    python -m repro_torch.launch.serve_matching --smoke --device cpu --world 2

``--smoke`` shrinks the trace and asserts cardinality parity against a
direct ``Matcher.run`` for every request and, where the service has a
mesh, sends one graph larger than every bucket down the sharded lane, its
state the direct run's bit for bit.  ``--device`` picks where the service
runs (default: the CUDA card).  The mesh, as the JAX package's default:
over every card where there are several, a world of one rank per card
(NCCL, :func:`repro_torch.distributed.run_world`) whose rank 0 runs the
service and whose other ranks join each oversize request's solve
(:func:`repro_torch.serving.serve_followers`).  ``--world N`` makes that
world of N ranks from the service's device (every rank on it on the CPU or
a one-card host, gloo: the counterpart of the reference's forced-device
host; round the cards from it on a host with several); ``--shards D`` puts D shards on
the service's device in one process; with one device and neither, no
lane.  ``--chaos`` arms a seeded
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
import torch

from repro_torch.core.csr import BipartiteCSR
from repro_torch.distributed import run_world
from repro_torch.graphs import (grid_graph, kron_graph, random_bipartite,
                                scaled_free)
from repro_torch.matching import Matcher, MatcherConfig, TorchCSR, make_mesh
from repro_torch.matching.sharded import every_device
from repro_torch.serving import (Bucketizer, FaultInjector,
                                 FlushThreadDiedError, MatchingService,
                                 PoisonedGraphFault, SizeBucket, ladder,
                                 percentile, serve_followers)

FIELDS = ("cmatch", "rmatch", "phases", "fallbacks", "certified")
# seconds a world's replay may take, each of its collectives too
WORLD_TIMEOUT = 1800.0

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
    """The one-process lane's mesh: ``shards`` shards on ``device`` (0:
    none)."""
    if shards:
        return make_mesh((shards,), ("data",),
                         every_device(device)[:1] * shards)
    return None


def world_size(args) -> int:
    """The ranks of the service's world: ``--world``, else one a card where
    there are several and no ``--shards``; 0: no world."""
    if args.world:
        return args.world
    if args.shards:
        return 0
    n = len(every_device(args.device))
    return n if n > 1 else 0


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
                         "the service's device, in one process")
    ap.add_argument("--world", type=int, default=0,
                    help="ranks of the oversize lane's world, from the "
                         "service's device (default: one a card where "
                         "there are several)")
    args = ap.parse_args(argv)
    if args.world and args.shards:
        ap.error("--world and --shards are two lanes; give one")
    size = world_size(args)
    if not size:
        return serve(args, build_mesh(args.shards, args.device))[0]
    results = run_world(world_rank, size, args, device=args.device,
                        timeout=WORLD_TIMEOUT)
    code, sharded = results[0]
    for r, got in enumerate(results[1:], 1):
        ok = got["served"] == sharded and not got["failed"]
        print(f"[serve_matching] rank {r} of {size} joined {got['served']} "
              f"sharded runs of rank 0's {sharded} "
              f"({'ok' if ok else 'FAIL'})")
        code = code or (0 if ok else 1)
    return code


def world_rank(world, args):
    """A rank of the service's world: rank 0 serves (its exit code and
    sharded count), the others join the lane (what they served)."""
    if world.rank:
        return serve_followers(world)
    args.device = world.device
    return serve(args, make_mesh((world.size,), ("data",)))


def serve(args, mesh) -> tuple:
    """Warm up, replay and check the service over ``mesh`` (None: no
    oversize lane); (exit code, requests served on the sharded lane)."""
    if args.smoke:
        args.requests, args.rate, args.size = 12, 500.0, 224
        buckets = (SizeBucket(256, 256, 2048),)
        args.max_batch = 4
    else:
        buckets = ladder(max_vertices=max(256, args.size * 2))

    injector = FaultInjector(seed=args.chaos_seed) if args.chaos else None
    service = MatchingService(
        bucketizer=Bucketizer(buckets,
                              oversize="shard" if mesh is not None
                              else "reject",
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
        ok = (res.route == "sharded" and all(
            torch.equal(getattr(res.state, f), getattr(direct, f))
            for f in FIELDS))
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
    return (1 if failures else 0), snap["sharded"]


if __name__ == "__main__":
    raise SystemExit(main())
