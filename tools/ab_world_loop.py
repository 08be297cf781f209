"""Same-card A/B of the matcher's solve over gloo worlds sharing the card.

    python tools/ab_world_loop.py PARENT_DIR [--sizes 2,4] [--warm 3]
        [--runs parent,change,change,parent]

PARENT_DIR is another checkout of the repo (for example ``git archive`` of
the parent commit unpacked under ``build/``).  kron-21 of
``chip_smoke.MAIN_PATH`` is made once, by this checkout's
``chip_smoke.generate``, and written with ``chip_smoke.save_graph``; then
each run starts a fresh process on one tree, which starts a gloo world of
each size on the card through that tree's ``run_world``.  Every rank
uploads the whole graph and solves it through that tree's
``ShardedMatcher`` under ``MatcherConfig()`` and the ``cheap`` warm start
(phase 5c's kron ``jnp`` run): one cold call, then ``--warm`` warm ones.
It prints one line a run: the tree and, per world size, every rank's walls,
host syncs, levels and a sha256 of the matching.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rank(world, graph_file: str, warm: int) -> dict:
    """One rank: the cold and warm solves of the graph over the world."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels._build import load_library
    from repro_torch.matching import (MatcherConfig, ShardedMatcher,
                                      TorchCSR, make_mesh)
    from repro_torch.matching.solve import COUNTERS
    for name in ("frontier_expand", "graph_loop"):
        load_library(name)
    g = cs.load_graph(graph_file)
    mesh = make_mesh((world.size,), ("data",))
    m = ShardedMatcher(mesh, "data", MatcherConfig(), "cheap")
    out = dict(walls_s=[], host_syncs=[], levels=[])
    for _ in range(1 + warm):
        graph = TorchCSR.from_host(g, device=world.device)
        torch.cuda.synchronize()
        COUNTERS.reset()
        t0 = time.perf_counter()
        state = m.run(graph)
        torch.cuda.synchronize()
        out["walls_s"].append(time.perf_counter() - t0)
        out["host_syncs"].append(m.last_counts["host_syncs"])
        out["levels"].append(m.last_counts["levels"])
        del graph
    out["digest"] = cs.digest(state.cmatch, state.rmatch)
    return out


def one_tree(tree: str, graph_file: str, sizes, warm: int) -> None:
    """Child process: every world size on ``tree``'s code."""
    sys.path[:0] = [tree, os.path.join(tree, "src")]
    from repro_torch.distributed import run_world
    rows = {}
    for size in sizes:
        rows[size] = run_world(rank, size, graph_file, warm, timeout=600)
    print("AB_ROWS " + json.dumps(rows), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--graph", help=argparse.SUPPRESS)
    ap.add_argument("--sizes", default="2,4")
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--runs", default="parent,change,change,parent")
    args = ap.parse_args()
    sizes = [int(s) for s in args.sizes.split(",")]
    if args.child:
        one_tree(args.child, args.graph, sizes, args.warm)
        return 0
    sys.path[:0] = [HERE, os.path.join(HERE, "src")]
    import chip_smoke as cs
    trees = dict(parent=os.path.abspath(args.parent), change=HERE)
    t0 = time.perf_counter()
    g, _ = cs.generate(cs.MAIN_PATH[cs.KRON])
    with tempfile.TemporaryDirectory() as tmp:
        graph_file = os.path.join(tmp, "kron.npz")
        cs.save_graph(g, graph_file)
        del g
        print(f"graph made in {time.perf_counter() - t0:.1f} s", flush=True)
        failed = 0
        for name in args.runs.split(","):
            t = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), args.parent,
                 "--child", trees[name], "--graph", graph_file,
                 "--sizes", args.sizes, "--warm", str(args.warm)],
                capture_output=True, text=True)
            rows = [ln[8:] for ln in proc.stdout.splitlines()
                    if ln.startswith("AB_ROWS ")]
            failed |= proc.returncode != 0 or not rows
            print("RUN", name, proc.returncode,
                  f"{time.perf_counter() - t:.1f} s",
                  rows[0] if rows else proc.stderr[-3000:], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
