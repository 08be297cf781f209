"""Phase 1 of ``chip_smoke.py`` (the main-path graphs drawn in worker
processes) under two layouts of the workers, on one host.

    python tools/smoke_phase1_probe.py [alone] [old] [new]

* ``alone``: each main-path graph drawn in this process, one after another,
  with no worker running;
* ``old``: the workers as ``chip_smoke.py`` started them before the CPU
  main-path solves took the drawn graphs: every CPU solve draws its graph
  again itself, started with the graph workers;
* ``new``: ``chip_smoke.start_workers`` and ``collect_graphs`` as they are.

Each layout runs in a fresh pool of ``chip_smoke.py``'s size and prints the
seconds each graph took in its worker and the seconds until the last graph
arrived; the pool is terminated after it (the CPU solves are not waited
for).  Needs no card.
"""
from __future__ import annotations

import json
import multiprocessing
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import chip_smoke as cs  # noqa: E402


def regenerate_and_solve(entry, threads: int) -> tuple:
    """Worker process: the earlier CPU main-path job, which drew its graph
    again before solving it."""
    g, _ = cs.generate(entry)
    return cs.main_path_cpu(entry, g, threads)


def alone() -> dict:
    out = {}
    for entry in cs.MAIN_PATH:
        _, s = cs.generate(entry)
        out[cs.label(entry)] = s
    return out


def layout(name: str, paths) -> dict:
    pool = multiprocessing.get_context("spawn").Pool(2 * len(cs.MAIN_PATH)
                                                     + 1)
    try:
        t0 = time.perf_counter()
        if name == "old":
            graphs = [pool.apply_async(cs.generate, (e,))
                      for e in cs.MAIN_PATH]
            [pool.apply_async(cs.make_graph, (e,)) for e in cs.SHARDED_GRAPHS]
            [pool.apply_async(regenerate_and_solve, (e, cs.CPU_THREADS[i]))
             for i, e in enumerate(cs.MAIN_PATH)]
            [pool.apply_async(cs.small_sets_cpu, (p,)) for p in paths]
            pool.apply_async(cs.small_traces_cpu)
            gen = {cs.label(e): r.get()[1] for e, r in zip(cs.MAIN_PATH,
                                                            graphs)}
        else:
            graphs, _, _, _ = cs.start_workers(pool, paths)
            got, _, _ = cs.collect_graphs(pool, graphs)
            gen = None
        return {"layout": name, "graphs_s": time.perf_counter() - t0,
                "generated_s": gen}
    finally:
        pool.terminate()
        pool.join()


def main() -> int:
    cs.use_src()
    from repro_torch.matching import SOLVE_PATHS
    paths = list(SOLVE_PATHS)
    for mode in sys.argv[1:] or ["alone", "old", "new"]:
        if mode == "alone":
            print(json.dumps({"layout": "alone", "generated_s": alone()}),
                  flush=True)
        else:
            print(json.dumps(layout(mode, paths)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
