"""Minimal end-to-end matching service demo: warm-up, a mixed burst,
metrics.

Builds a :class:`repro_torch.serving.MatchingService` over one declared
size bucket, captures its (bucket x config x warm start x batch) grid
ahead of traffic, fires a burst of mixed-family graphs at it, and prints
per-request stats plus the service counters.  Its mesh holds four shards
on the one device, so the oversize -> ``ShardedMatcher`` route is
exercised too:

    PYTHONPATH=src python examples/torch/matching_service.py         # card
    PYTHONPATH=src python examples/torch/matching_service.py --device cpu
"""
import argparse

from repro_torch._device import resolve_device
from repro_torch.core import validate_matching
from repro_torch.graphs import (grid_graph, kron_graph, random_bipartite,
                                scaled_free)
from repro_torch.matching import Matcher, MatcherConfig, TorchCSR, make_mesh
from repro_torch.serving import Bucketizer, MatchingService, SizeBucket

SHARDS = 4


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = MatcherConfig(algo="apfb", kernel="gpubfs_wr", schedule="ct")
    mesh = make_mesh((SHARDS,), ("data",), devices=[device] * SHARDS)
    service = MatchingService(
        bucketizer=Bucketizer((SizeBucket(256, 256, 2048),),
                              oversize="shard", device=device),
        config=cfg, warm_start="cheap",
        max_batch=4, max_delay_ms=2.0, mesh=mesh)
    try:
        print(service.warm_up())             # traffic captures nothing

        burst = {
            "random": random_bipartite(200, 180, 3.0, seed=1),
            "kron": kron_graph(7, 6, seed=2),
            "grid": grid_graph(12),
            "free": scaled_free(150, 160, 4.0, seed=3),
            "oversize": random_bipartite(400, 400, 4.0, seed=4),  # sharded
        }
        futures = {name: service.submit(g) for name, g in burst.items()}

        for name, fut in futures.items():
            res = fut.result(timeout=300)
            g = burst[name]
            cm, rm = res.matching()
            if validate_matching(g, cm, rm) != res.cardinality:
                raise SystemExit(f"{name}: the served matching's size "
                                 f"differs from its reported cardinality")
            direct = Matcher(cfg, warm_start="cheap").run(
                TorchCSR.from_host(g, device=device).bucketed())
            if res.cardinality != int(direct.cardinality):
                raise SystemExit(f"{name}: served {res.cardinality} != "
                                 f"direct {int(direct.cardinality)}")
            print(f"{name:>9}: route={res.route:<7} |M|={res.cardinality:4d} "
                  f"batch={res.batch_size} "
                  f"wait={res.queue_wait_s * 1e3:6.1f} ms "
                  f"latency={res.latency_s * 1e3:6.1f} ms")
        snap = service.metrics.snapshot()
    finally:
        service.close()
    print(f"service: {snap['submitted']} submitted, "
          f"{snap['dispatches']} dispatches, "
          f"occupancy {snap['occupancy']:.2f}, "
          f"pad-waste {snap['pad_edge_waste']:.2f}, "
          f"compile {snap['compile_hits']}h/{snap['compile_misses']}m")
    print("OK — every request matched the direct Matcher, one dispatch "
          "per flushed bucket")


if __name__ == "__main__":
    main()
