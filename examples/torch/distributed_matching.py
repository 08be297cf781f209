"""The paper's stated future work: distributed-memory matching.

``ShardedMatcher`` — edge-partitioned APFB over a device mesh, one
min-merge of the shards' winners per BFS level, the same solve loop as the
single-device ``Matcher``.  Here the mesh holds eight shards on one device
(a mesh over several cards waits for ROADMAP.md, Queue 1, item 13):

    PYTHONPATH=src python examples/torch/distributed_matching.py     # card
    PYTHONPATH=src python examples/torch/distributed_matching.py --device cpu
"""
import argparse

from repro_torch._device import resolve_device
from repro_torch.core import maximum_cardinality, validate_matching
from repro_torch.graphs import random_bipartite
from repro_torch.matching import (Matcher, MatcherConfig, ShardedMatcher,
                                  TorchCSR, make_mesh)

SHARDS = 8


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    mesh = make_mesh((SHARDS,), ("data",), devices=[device] * SHARDS)
    g = random_bipartite(4096, 4096, 6.0, seed=0)
    graph = TorchCSR.from_host(g, device=device).shard(mesh, "data")
    print(f"graph: {g.nc}x{g.nr}, {g.nnz} edges, sharded {SHARDS} ways on "
          f"{device} ({graph.nnz_pad // SHARDS} edge slots a shard)")
    cfg = MatcherConfig(algo="apfb", kernel="gpubfs_wr")
    sharded = ShardedMatcher(mesh, config=cfg, warm_start="cheap")
    state = sharded.run(graph)            # warm start + solve, one program
    cmatch, rmatch = state.to_host()
    card = validate_matching(g, cmatch, rmatch)
    opt = maximum_cardinality(g)
    stats = sharded.stats(state).as_dict()
    print(f"distributed {stats['variant']}: |M| = {card} "
          f"(optimal {opt}) in {stats['phases']} phases, "
          f"{sharded.last_counts['merges']} merges")
    if card != opt:
        raise SystemExit(f"sharded |M| = {card} != scipy's {opt}")
    single = Matcher(cfg, warm_start="cheap").run(
        TorchCSR.from_host(g, device=device))
    if int(single.cardinality) != card:
        raise SystemExit(f"single-device |M| = {int(single.cardinality)} != "
                         f"sharded {card}")
    print("OK — one merge per BFS level, state whole, edges sharded; "
          "cardinality matches the single-device Matcher")


if __name__ == "__main__":
    main()
