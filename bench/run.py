"""Runs one cell of the benchmark once and prints its result line.

    python3 -m bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card the cell asks for.
The run makes its inputs from the seed on the card and copies them to the
host, builds and warms the system under test (the kernels' libraries go to
the checkout's ``build/repro_torch_kernels/``, built by the first run
there), measures for ``--seconds``, and then judges every answer the
window produced against the plain reference (``bench/reference.py``).  With
``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read under ``torch.profiler``; there
``device.busy_s`` is a lower bound (``busy_s_is_lower_bound``), as the
profiler does not see the kernels inside the solver's conditional WHILE
bodies.

The last line on standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``, each number compared and its limit,
which also end standard error.  With no CUDA card, with fewer cards than
the cell asks for, or with ``jax``, ``jaxlib``, ``flax`` or ``repro``
loaded once the window has closed, it prints no result and exits 2.
"""
import time

T0 = time.perf_counter()      # set-up is counted from here

import argparse                # noqa: E402
import dataclasses             # noqa: E402
import hashlib                 # noqa: E402
import importlib               # noqa: E402
import json                    # noqa: E402
import os                      # noqa: E402
import sys                     # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

import torch                   # noqa: E402

from bench import graphs, reference, registry, system  # noqa: E402
from bench.trace import Tracer, breakdown  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# every number compared, and its limit: each answer must be a maximum
# matching of its graph, so every count is held to 0
LIMITS = {"missing": 0, "bad_pairs": 0, "aug_rows": 0}
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton"}


@dataclasses.dataclass
class Run:
    """One run of a cell: what the loop reads and what it records."""

    config: dict
    traffic: dict
    seed: int
    seconds: float
    device: torch.device
    tracer: Tracer
    override: dict = dataclasses.field(default_factory=dict)
    gen: Optional[torch.Generator] = None
    pool: list = dataclasses.field(default_factory=list)
    t0: float = 0.0
    setup_s: float = 0.0
    attempted: int = 0
    rec: dict = dataclasses.field(default_factory=dict)
    answers: list = dataclasses.field(default_factory=list)
    failures: list = dataclasses.field(default_factory=list)
    trace: dict = dataclasses.field(default_factory=dict)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def fail(self, why: str) -> None:
        self.failures.append(why)

    def device_clock(self) -> Callable[[], float]:
        """Starts a clock of the device's stream; calling what it returns
        waits for the device and gives the seconds since (on the CPU, the
        host's clock)."""
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            return lambda: time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        start.record()

        def read() -> float:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        return read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the port must not load,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def judge(run: Run) -> Dict[str, int]:
    """Every answer against the reference, each distinct one once."""
    seen, items = set(), []
    for k, cm, rm in run.answers:
        h = hashlib.blake2b(cm.tobytes(), digest_size=16)
        h.update(rm.tobytes())
        if (k, h.digest()) not in seen:
            seen.add((k, h.digest()))
            items.append((run.pool[k], cm, rm))
    out = reference.check(items, run.device)
    return dict(missing=run.attempted - len(run.answers),
                bad_pairs=out["bad_pairs"], aug_rows=out["aug_rows"])


def device_info(run: Run, peak: int) -> dict:
    if run.device.type == "cuda":
        info = dict(platform="gpu", kind=torch.cuda.get_device_name(
            run.device), count=1, memory_peak_bytes=peak)
    else:
        info = dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)
    if run.tracer.enabled and run.trace:
        # the profiler does not see the kernels inside the solver's
        # conditional WHILE bodies, so its busy time is a lower bound
        info.update(busy_s=run.trace["busy_s"],
                    window_s=run.trace["window_s"],
                    busy_s_is_lower_bound=True)
    return info


def run_cell(config: dict, traffic: dict, metrics: List[dict], seed: int,
             seconds: float, trace: bool, device="cuda",
             override: Optional[dict] = None) -> dict:
    """One run of a cell; returns the result line as a dict.
    ``metrics``: the entries of ``BENCHMARK.json`` it reports;
    ``override``: ``MatcherConfig`` fields put over the configuration's
    (the control)."""
    dev = torch.device(device)
    run = Run(config=config, traffic=traffic, seed=seed, seconds=seconds,
              device=dev, tracer=Tracer(trace), override=override or {})
    loop = importlib.import_module(f"bench.loops.{traffic['loop']}")
    marks = [time.perf_counter()]
    run.gen = graphs.generator(seed, dev)
    run.pool = graphs.make_pool(traffic["graphs"], run.gen, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    marks.append(time.perf_counter())
    loop.setup(run)
    marks.append(time.perf_counter())
    misses = system.cache_info()["misses"]
    run.tracer.start()
    run.t0 = time.perf_counter()
    run.setup_s = run.t0 - T0
    loop.window(run)
    run.sync()
    run.trace = run.tracer.stop()
    built = system.cache_info()["misses"] - misses
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if hasattr(loop, "close"):
        loop.close(run)
    system.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    marks.append(time.perf_counter())
    checks = judge(run)
    marks.append(time.perf_counter())
    values = {}
    for m in metrics:
        v = registry.reader(m["name"])(run)
        if v is not None:
            values[m["name"]] = dict(value=v, unit=m["unit"])
    bad = len(run.failures) + sum(1 for k in checks if checks[k] > LIMITS[k])
    out = dict(correct=bad == 0, attempted=run.attempted,
               failed=checks["missing"], metrics=values,
               device=device_info(run, peak))
    if trace:
        out["breakdown"] = breakdown(run.trace)
    out["checks"] = {k: dict(value=v, limit=LIMITS[k])
                     for k, v in checks.items()}
    out["_notes"] = dict(
        failures=run.failures[:5], programs_built=built,
        answers=len(run.answers), import_s=marks[0] - T0,
        inputs_s=marks[1] - marks[0], warm_s=marks[2] - marks[1],
        judge_s=marks[4] - marks[3], trace_events=run.trace.get("events"))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = registry.benchmark()
    cell = registry.workload(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"cell {cell['name']} needs {cell['chips']} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    root = registry.ROOT
    for var, sub in CACHES.items():     # fixed paths inside the checkout
        os.environ[var] = str(root / "build" / sub)
    system.port()
    metrics = (registry.per_layer(bench, cell["name"]) if args.trace
               else registry.end_to_end(bench, cell["name"]))
    out = run_cell(registry.config(bench, cell["config"]),
                   registry.traffic(cell["traffic"]), metrics, args.seed,
                   args.seconds, bool(args.trace))
    notes = out.pop("_notes")
    print(f"notes: {json.dumps(notes)}", file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"modules loaded that the port must not load: {found}",
              file=sys.stderr)
        return 2
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
