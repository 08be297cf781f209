"""The paper's stated future work: distributed-memory matching.

``ShardedMatcher`` — edge-partitioned APFB over a device mesh, one
min-merge of the shards' winners per BFS level, the same solve loop as the
single-device ``Matcher``.  By default the mesh holds eight shards on one
device; ``--ranks N`` runs it over a ``torch.distributed`` world of N ranks
instead, one shard a rank (NCCL where each rank has a card of its own,
gloo where they share one or run on the CPU), rank 0 printing:

    PYTHONPATH=src python examples/torch/distributed_matching.py     # card
    PYTHONPATH=src python examples/torch/distributed_matching.py --device cpu
    PYTHONPATH=src python examples/torch/distributed_matching.py --ranks 2 \\
        --device cpu
"""
import argparse

from repro_torch._device import resolve_device
from repro_torch.core import maximum_cardinality, validate_matching
from repro_torch.distributed import run_world
from repro_torch.graphs import random_bipartite
from repro_torch.matching import (Matcher, MatcherConfig, ShardedMatcher,
                                  TorchCSR, make_mesh)

SHARDS = 8
CFG = MatcherConfig(algo="apfb", kernel="gpubfs_wr")


def solve(g, mesh, device) -> tuple:
    """The sharded solve of ``g`` over ``mesh`` (warm start + solve, one
    program; over a world's ranks each uploads its shard of the host
    graph); returns (host cmatch, host rmatch, stats, merges)."""
    graph = g if mesh.world is not None else TorchCSR.from_host(
        g, device=device)
    sharded = ShardedMatcher(mesh, config=CFG, warm_start="cheap")
    state = sharded.run(graph)
    cmatch, rmatch = state.to_host()
    return (cmatch, rmatch, sharded.stats(state).as_dict(),
            sharded.last_counts["merges"])


def rank(world, g):
    """One rank of ``--ranks``: its shard of the solve."""
    mesh = make_mesh((world.size,), ("data",))
    return solve(g, mesh, world.device) + (world.backend,)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--ranks", type=int, default=0,
                    help="run over a world of this many ranks, one shard "
                         "each (default: 8 shards in this process)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    g = random_bipartite(4096, 4096, 6.0, seed=0)
    if args.ranks:
        out = run_world(rank, args.ranks, g, device=args.device)
        if any((r[0] != out[0][0]).any() or (r[1] != out[0][1]).any()
               for r in out):
            raise SystemExit("the ranks returned different matchings")
        cmatch, rmatch, stats, merges, backend = out[0]
        where = f"{args.ranks} ranks ({backend}), one shard each"
    else:
        mesh = make_mesh((SHARDS,), ("data",), devices=[device] * SHARDS)
        cmatch, rmatch, stats, merges = solve(g, mesh, device)
        where = f"{SHARDS} shards on {device}"
    print(f"graph: {g.nc}x{g.nr}, {g.nnz} edges, sharded over {where}")
    card = validate_matching(g, cmatch, rmatch)
    opt = maximum_cardinality(g)
    print(f"distributed {stats['variant']}: |M| = {card} "
          f"(optimal {opt}) in {stats['phases']} phases, {merges} merges")
    if card != opt:
        raise SystemExit(f"sharded |M| = {card} != scipy's {opt}")
    single = Matcher(CFG, warm_start="cheap").run(
        TorchCSR.from_host(g, device=device))
    if int(single.cardinality) != card:
        raise SystemExit(f"single-device |M| = {int(single.cardinality)} != "
                         f"sharded {card}")
    print("OK — one merge per BFS level, state whole, edges sharded; "
          "cardinality matches the single-device Matcher")


if __name__ == "__main__":
    main()
