"""Same-card A/B of the single-graph main path's warm walls.

    python tools/ab_main_path.py PARENT_DIR [--runs parent,change,change,parent]
                                            [--kernels]

PARENT_DIR is another checkout of the repo (for example ``git archive`` of
the parent commit unpacked under ``build/``).  The three main-path graphs
of ``chip_smoke.MAIN_PATH`` are made once, by this checkout's
``chip_smoke.make_graph``; then each run starts a fresh process on one tree
that builds its kernels and calls that tree's ``chip_smoke.solve_once`` on
each graph (one cold call, then ``WARM_RUNS`` warm ones).  It prints one
line a run: the tree and, per graph, the best warm wall and all of them;
with ``--kernels`` also that tree's ``chip_smoke.kernel_checks`` rows (each
frontier kernel's time over the first BFS phase, CUDA events and profiler
device time).  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import pickle
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one_tree(tree: str, graphs_file: str, kernels: bool) -> None:
    """Child process: the main path of ``tree`` on the pickled graphs."""
    sys.path[:0] = [tree, os.path.join(tree, "src")]
    import torch
    import chip_smoke as cs
    from repro_torch.matching import MatcherConfig, compile_cache_clear
    with open(graphs_file, "rb") as f:
        graphs = pickle.load(f)
    cs.warm_up()
    rows = []
    for entry, (g, _) in zip(cs.MAIN_PATH, graphs):
        _, _, row = cs.solve_once(g, MatcherConfig(**entry[3]), entry[4])
        rows.append(dict(graph=entry[0], warm_wall_s=row["warm_wall_s"],
                         warm_walls_s=row["warm_walls_s"],
                         cold_wall_s=row["cold_wall_s"]))
        compile_cache_clear()
        torch.cuda.empty_cache()
    if kernels:
        rows += [{k: v for k, v in r.items() if k == "graph" or k == "kernel"
                  or k.startswith(("kernel_ms", "device_ms"))}
                 for r in cs.kernel_checks(graphs)]
    print("AB_ROWS " + json.dumps(rows), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--graphs", help=argparse.SUPPRESS)
    ap.add_argument("--runs", default="parent,change,change,parent")
    ap.add_argument("--kernels", action="store_true")
    args = ap.parse_args()
    if args.child:
        one_tree(args.child, args.graphs, args.kernels)
        return 0
    sys.path[:0] = [HERE, os.path.join(HERE, "src")]
    import chip_smoke as cs
    trees = dict(parent=os.path.abspath(args.parent), change=HERE)
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(len(cs.MAIN_PATH)) as p:
        graphs = [(g, want) for g, want, *_ in
                  p.map(cs.make_graph, cs.MAIN_PATH)]
    with tempfile.TemporaryDirectory() as tmp:
        graphs_file = os.path.join(tmp, "graphs.pkl")
        with open(graphs_file, "wb") as f:
            pickle.dump(graphs, f)
        print(f"graphs made in {time.perf_counter() - t0:.1f} s", flush=True)
        failed = 0
        for name in args.runs.split(","):
            t = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), args.parent,
                 "--child", trees[name], "--graphs", graphs_file,
                 *(["--kernels"] if args.kernels else [])],
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
