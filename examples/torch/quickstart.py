"""Quickstart: maximum cardinality bipartite matching with the paper's
GPU algorithms (APFB / APsB) on the PyTorch port's device-resident API.

    PYTHONPATH=src python examples/torch/quickstart.py               # card
    PYTHONPATH=src python examples/torch/quickstart.py --device cpu
"""
import argparse

from repro_torch.core import hopcroft_karp, validate_matching
from repro_torch.graphs import kron_graph, random_bipartite
from repro_torch.matching import (Matcher, MatcherConfig, TorchCSR, VARIANTS,
                                  compile_cache_info, match_many)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    # a power-law bipartite graph (kron_g500-style, as in the paper's suite)
    g = kron_graph(scale=12, edge_factor=8, seed=1)
    print(f"graph: {g.nc} cols, {g.nr} rows, {g.nnz} edges")

    # upload once; the graph stays on the device from here on
    graph = TorchCSR.from_host(g, device=args.device)

    # the paper's winning variant: APFB + GPUBFS-WR + CT, warm-started with
    # cheap matching — warm start and solve are one cached program
    best = MatcherConfig(algo="apfb", kernel="gpubfs_wr", schedule="ct")
    matcher = Matcher(best, warm_start="cheap")
    state = matcher.run(graph)
    stats = matcher.stats(state).as_dict()          # first host sync
    cmatch, rmatch = state.to_host()
    card = validate_matching(g, cmatch, rmatch)
    print(f"{best.name}: |M| = {card} in {stats['phases']} phases "
          f"({stats['fallbacks']} fallbacks) on {graph.device}")

    # cross-check against sequential Hopcroft-Karp (the paper's baseline)
    cm_hk, _ = hopcroft_karp(g)
    hk = int((cm_hk >= 0).sum())
    if card != hk:
        raise SystemExit(f"{best.name}: |M| = {card} != Hopcroft-Karp's {hk}")
    print(f"Hopcroft-Karp cardinality {hk}: matches")

    # all eight variants of Table 1 share the uploaded graph
    for cfg in VARIANTS:
        st = Matcher(cfg, warm_start="cheap").run(graph)
        got = int(st.cardinality)
        if got != hk:
            raise SystemExit(f"{cfg.name}: |M| = {got} != Hopcroft-Karp's "
                             f"{hk}")
        print(f"  {cfg.name:28s} phases={int(st.phases):3d} card={got}")

    # batched serving: 8 independent graphs of one size bucket, each BFS
    # level of the whole batch one kernel launch
    batch = TorchCSR.stack([
        TorchCSR.from_host(random_bipartite(512, 512, 3.0, seed=s,
                                            pad_to=2048), device=args.device)
        for s in range(8)])
    many = match_many(batch, best, warm_start="karp_sipser")
    print("match_many cardinalities:", many.cardinality.tolist())
    print("compiled programs cached:", compile_cache_info()["entries"])


if __name__ == "__main__":
    main()
