"""The control of a cell's correctness check, on the card at the cell's size.

    python3 -m bench.control --workload kron21.solve --seeds 1,2,3 --seconds 5

Runs the cell as ``bench.run`` does, once a seed in one process, with the
program's own lower guarantee in its place: ``MatcherConfig(max_phases=1,
degrade_maximal=True)``, a solve cut to one phase that still returns a
valid maximal matching, not a maximum one.  Prints each run's numbers
compared; the check must call every run not correct.  The benchmark's own
runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from bench import registry, system
from bench.run import run_cell

CONTROL = dict(max_phases=1, degrade_maximal=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on the card; none here", file=sys.stderr)
        return 2
    system.port()
    bench = registry.benchmark()
    cell = registry.workload(bench, args.workload)
    caught = True
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run_cell(registry.config(bench, cell["config"]),
                       registry.traffic(cell["traffic"]), [], seed,
                       args.seconds, False, override=CONTROL)
        caught &= not out["correct"]
        print(json.dumps(dict(seed=seed, correct=out["correct"],
                              attempted=out["attempted"],
                              checks=out["checks"])), flush=True)
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
