#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the root of a checkout on a machine with a CUDA card::

    python3 chip_smoke.py

What it does, in order; any failure raises and the exit code is not 0:

1. prints the card's name and power limit (``nvidia-smi``) and builds every
   CUDA kernel of the port from ``src/repro_torch/csrc`` (``nvcc``,
   ``sm_90a``), printing the build time; then worker processes, one per
   graph, make the main-path graphs and their cardinalities by scipy;
2. drives the main path, ``TorchCSR.from_host`` -> warm start -> APFB/APsB
   solve, on three full-size graphs made by the port's own generators, with
   every kernel launch counter and solver counter set to 0 just before each
   run and read just after.  Each result is checked four ways: a valid
   matching, a cardinality equal to scipy's ``maximum_bipartite_matching``
   (independent of the code under test), ``certified`` True, and launches of
   the graph's kernel body > 0;
3. holds each kernel against its plain PyTorch version on the card: the
   first BFS phase of every main-path graph, level by level, for the WR and
   the plain body, bit for bit (tolerance 0: the winners are integers), and
   times both with CUDA events;
4. solves ``instance_sets("small")`` (all nine families) on the card and on
   the CPU and requires identical ``cmatch``, ``rmatch``, ``phases``,
   ``fallbacks`` and ``certified``;
5. profiles one more kron solve with ``torch.profiler`` (device time by
   kernel, the device's busy share of the wall time);
6. prints one ``{"kernels": [...]}`` line, then as its last line
   ``{"ok": true, "device": {...}}``.

It imports neither JAX nor the JAX package.  It needs a CUDA card and the
repository's ``src/``; without either it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import multiprocessing
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)

# (generator, its arguments, config, warm start, what it exercises)
MAIN_PATH = [
    ("kron_graph", (21, 16), dict(seed=1), dict(), "cheap", "WR body"),
    ("random_bipartite", (1 << 22, 1 << 22, 8.0), dict(seed=2),
     dict(kernel="gpubfs"), "karp_sipser", "plain body"),
    ("grid_graph", (1024,), dict(), dict(algo="apsb", wr_exact=True),
     "cheap", "exact-WR encoding"),
]
KERNELS = {
    "frontier_expand_fused_wr": ("src/repro/kernels/frontier_expand/"
                                 "frontier_expand.py:187"),
    "frontier_expand_fused_plain": ("src/repro/kernels/frontier_expand/"
                                    "frontier_expand.py:195"),
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def say(*parts) -> None:
    print(*parts, flush=True)


def label(entry) -> str:
    name, args, kw = entry[:3]
    parts = [repr(a) for a in args] + [f"{k}={v!r}" for k, v in kw.items()]
    return f"{name}({', '.join(parts)})"


def make_graph(entry):
    """Worker process: one main-path graph from the port's generators, and
    its maximum cardinality by scipy (independent of the code under test).
    """
    if os.path.join(HERE, "src") not in sys.path:
        sys.path.insert(0, os.path.join(HERE, "src"))
    from scipy.sparse.csgraph import maximum_bipartite_matching
    from repro_torch import graphs
    name, args, kw = entry[:3]
    t0 = time.perf_counter()
    g = getattr(graphs, name)(*args, **kw)
    t1 = time.perf_counter()
    m = maximum_bipartite_matching(g.to_scipy().tocsr(), perm_type="column")
    return g, int((m >= 0).sum()), t1 - t0, time.perf_counter() - t1


def make_graphs() -> list:
    """All main-path graphs, one worker process each, all started together."""
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(len(MAIN_PATH), mp_context=ctx) as pool:
        out = list(pool.map(make_graph, MAIN_PATH))
    for entry, (g, want, gen_s, scipy_s) in zip(MAIN_PATH, out):
        say(f"graph {label(entry)}: {g.nc} x {g.nr}, {g.nnz} edges, "
            f"generated in {gen_s:.1f} s; scipy cardinality {want} in "
            f"{scipy_s:.1f} s")
    return out


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(ecol, cadj, bfs, root, rmatch, level: int) -> float:
    """Least time of one sweep on this card for this level's inputs: the
    bytes it must move over HBM bandwidth.  It reads ecol and bfs whole and
    writes the (nr+1,) winner vector; only for the edges whose column is on
    the frontier (WR: and whose root is alive) must it read cadj, and root
    and rmatch once for each distinct column and row those edges touch."""
    nc, nr = bfs.numel() - 1, rmatch.numel() - 1
    c = ecol.long()
    on = bfs[c] == level
    nbytes = 4 * ecol.numel() + 4 * (nc + 1) + 4 * (nr + 1)
    if root is not None:
        cols = torch.zeros(nc + 1, dtype=torch.bool, device=bfs.device)
        cols[c[on]] = True
        nbytes += 4 * int(cols.sum())
        on &= bfs[root[c].long()] >= 1
    rows = torch.zeros(nr + 1, dtype=torch.bool, device=bfs.device)
    rows[cadj[on].long()] = True
    nbytes += 4 * int(on.sum()) + 4 * int(rows[:nr].sum())
    return nbytes / HBM_BYTES_PER_S * 1e3


def warm_up() -> None:
    """One small solve first, so CUDA context and module loading do not
    land in the first main-path wall time."""
    from repro_torch.graphs import instance_sets
    from repro_torch.matching import Matcher, TorchCSR
    Matcher(warm_start="cheap").run(
        TorchCSR.from_host(instance_sets("mini")["rand"]))
    torch.cuda.synchronize()


def main_path(graphs) -> list:
    """Phase 2: the user's entry points, counts zeroed just before each run.
    ``graphs`` holds (graph, scipy cardinality) pairs."""
    from repro_torch.core import validate_matching
    from repro_torch.kernels.frontier_expand import LAUNCHES, reset_launches
    from repro_torch.matching import Matcher, MatcherConfig, TorchCSR
    from repro_torch.matching.solve import COUNTERS

    results = []
    for entry, (g, want) in zip(MAIN_PATH, graphs):
        expr, (cfg_kw, ws, what) = label(entry), entry[3:]
        cfg = MatcherConfig(**cfg_kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        COUNTERS.reset()
        t0 = time.perf_counter()
        graph = TorchCSR.from_host(g)
        state = Matcher(cfg, ws).run(graph)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        counts = COUNTERS.as_dict()
        peak = torch.cuda.max_memory_allocated()
        cm, rm = state.to_host()
        card = validate_matching(g, cm, rm)
        row = dict(graph=expr, config=cfg.name, warm_start=ws, exercises=what,
                   nc=g.nc, nr=g.nr, nnz=g.nnz, wall_s=wall,
                   phases=int(state.phases), fallbacks=int(state.fallbacks),
                   certified=bool(state.certified), cardinality=card,
                   scipy_cardinality=want, launches=launches,
                   max_memory_allocated=peak, **counts)
        say("main path:", json.dumps(row))
        if card != want:
            fail(f"{expr}: cardinality {card} != scipy's {want}")
        if not row["certified"]:
            fail(f"{expr}: result not certified maximum")
        body = "wr" if cfg.kernel == "gpubfs_wr" else "plain"
        if launches[f"frontier_expand_fused_{body}"] <= 0:
            fail(f"{expr}: the {body} kernel was not launched")
        results.append(row)
    return results


def kernel_checks(graphs) -> dict:
    """Phase 3: kernel against plain version over the first BFS phase of
    every main-path graph, both bodies; timing with CUDA events."""
    from repro_torch.kernels.frontier_expand import (
        frontier_expand_fused, frontier_expand_fused_ref)
    from repro_torch.matching import Matcher, MatcherConfig, TorchCSR
    from repro_torch.matching.solve import _apply_winner, level0_state

    per_body = {"wr": [], "plain": []}
    for entry, (g, _) in zip(MAIN_PATH, graphs):
        expr, cfg_kw, ws = label(entry), entry[3], entry[4]
        graph = TorchCSR.from_host(g)
        warm = Matcher(MatcherConfig(**cfg_kw), ws).init(graph)
        for wr in (True, False):
            wr_exact = wr and cfg_kw.get("wr_exact", False)
            bfs, root = level0_state(warm.cmatch)
            pred = torch.full((g.nr + 1,), g.nc, dtype=torch.int32,
                              device="cuda")
            rmatch = warm.rmatch
            states, bounds, max_err, level = [], [], 0, 2
            while True:
                rt = root if wr else None
                args = (graph.ecol, graph.cadj, bfs, rt, rmatch, level)
                got = frontier_expand_fused(*args)
                want = frontier_expand_fused_ref(*args)
                torch.cuda.synchronize()
                err = int((got.long() - want.long()).abs().max())
                max_err = max(max_err, err)
                if err:
                    fail(f"{expr}: {'WR' if wr else 'plain'} kernel differs "
                         f"from its plain version at level {level}")
                states.append(args)
                bounds.append(bound_ms(*args))
                bfs, root, pred, rmatch, ins, _ = _apply_winner(
                    got, bfs, root, pred, rmatch, level, wr=wr,
                    wr_exact=wr_exact)
                level += 1
                if not bool(ins):
                    break

            def sweep(fn):
                return lambda: [fn(*a) for a in states]

            n = len(states)
            k_ms = cuda_ms(sweep(frontier_expand_fused)) / n
            p_ms = cuda_ms(sweep(frontier_expand_fused_ref)) / n
            row = dict(graph=expr, body="wr" if wr else "plain",
                       levels_checked=n, max_abs_err=max_err,
                       kernel_ms=k_ms, plain_ms=p_ms,
                       bound_ms=sum(bounds) / n,
                       nnz_pad=graph.nnz_pad)
            say("kernel vs plain:", json.dumps(row))
            per_body[row["body"]].append(row)
        del graph, warm, states
        torch.cuda.empty_cache()
    return per_body


def profile_main_path(entry, g) -> dict:
    """Phase 5: one main-path solve again under ``torch.profiler``: device
    time by kernel, and the device's busy share of the wall time (the
    profiler's own cost lands in the wall time, so the share is a floor)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.matching import Matcher, MatcherConfig, TorchCSR

    graph = TorchCSR.from_host(g)
    matcher = Matcher(MatcherConfig(**entry[3]), entry[4])
    matcher.run(graph)                                  # warm the allocator
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        matcher.run(graph)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernel events only: a CPU op's device time repeats its kernels'
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us, evt.count, evt.key))
    rows.sort(reverse=True)
    device_s = sum(r[0] for r in rows) / 1e6
    sweep_s = sum(r[0] for r in rows if "fused_sweep" in r[2]) / 1e6
    out = dict(graph=label(entry), wall_s=wall,
               device_s=device_s if rows else "not measured",
               busy_share=device_s / wall if rows else "not measured",
               sweep_share_of_device=(sweep_s / device_s if rows
                                      else "not measured"),
               top=[dict(kernel=k[:80], ms=us / 1e3, count=n)
                    for us, n, k in rows[:8]])
    say("profile:", json.dumps(out))
    return out


def small_sets_bit_exact() -> None:
    """Phase 4: the card (kernel) and the CPU (plain) give one answer."""
    from repro_torch.graphs import instance_sets
    from repro_torch.matching import Matcher, MatcherConfig, TorchCSR

    for name, g in instance_sets("small").items():
        outs = []
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            s = Matcher(MatcherConfig(), "cheap").run(
                TorchCSR.from_host(g, device=dev))
            outs.append((s.cmatch.cpu(), s.rmatch.cpu(), int(s.phases),
                         int(s.fallbacks), bool(s.certified),
                         time.perf_counter() - t0))
        (ca, ra, pa, fa, za, ta), (cb, rb, pb, fb, zb, tb) = outs
        same = (torch.equal(ca, cb) and torch.equal(ra, rb)
                and (pa, fa, za) == (pb, fb, zb))
        say(f"small {name}: cuda==cpu {same} phases {pa} fallbacks {fa} "
            f"certified {za} cuda_s {ta:.3f} cpu_s {tb:.3f}")
        if not same:
            fail(f"instance_sets('small')[{name!r}] differs between the "
                 f"card and the CPU")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a card",
              file=sys.stderr)
        return 2
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: src/repro_torch not found; run from the root of a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch.kernels._build import load_library

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    say(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}")
    say("torch", torch.__version__, "cuda", torch.version.cuda, "device",
        torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    lib = load_library("frontier_expand")
    regs = [ln.strip() for ln in lib.build_log.splitlines()
            if "registers" in ln]
    say(f"kernel build: {time.perf_counter() - t0:.2f} s (nvcc "
        f"{lib.build_seconds:.2f} s), {'; '.join(regs)}")

    t0 = time.perf_counter()
    graphs = [(g, want) for g, want, *_ in make_graphs()]
    say(f"graphs and scipy cardinalities: {time.perf_counter() - t0:.1f} s")

    warm_up()
    runs = main_path(graphs)
    checks = kernel_checks(graphs)
    small_sets_bit_exact()
    profile_main_path(MAIN_PATH[0], graphs[0][0])

    # one line for the kernels: timed on the main-path graph of each body
    main_graph = {"wr": label(MAIN_PATH[0]), "plain": label(MAIN_PATH[1])}
    kernels = []
    for body, name in (("wr", "frontier_expand_fused_wr"),
                       ("plain", "frontier_expand_fused_plain")):
        row = next(r for r in checks[body] if r["graph"] == main_graph[body])
        kernels.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/frontier_expand.cu",
            replaces=KERNELS[name],
            launches=sum(r["launches"][name] for r in runs),
            max_abs_err=max(r["max_abs_err"] for r in checks[body]),
            ms=row["kernel_ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by="bytes", library_ms=None,
            timed_on=row["graph"],
            levels_checked=sum(r["levels_checked"] for r in checks[body])))
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
