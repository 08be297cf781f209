#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the root of a checkout on a machine with a CUDA card::

    python3 chip_smoke.py

What it does, in order; any failure raises and the exit code is not 0:

1. prints the card's name and power limit (``nvidia-smi``) and builds every
   CUDA kernel of the port from ``src/repro_torch/csrc`` (``nvcc``,
   ``sm_90a``), printing the build time; then worker processes make the
   main-path graphs and their cardinalities by scipy, and solve the small
   corpus on the CPU through every solve path (for step 4);
2. drives the main path, ``TorchCSR.from_host`` (then ``with_csc`` for the
   direction-optimizing paths) -> warm start -> APFB/APsB solve, on three
   full-size graphs made by the port's own generators, through every solve
   path: the fused push sweep, the legacy proposal kernel, the pull kernel,
   the compact pull and the adaptive compact gather.  Every kernel launch
   counter and solver counter is set to 0 just before each run and read
   just after.  Each result is checked four ways: a valid matching, a
   cardinality equal to scipy's ``maximum_bipartite_matching`` (independent
   of the code under test), ``certified`` True, and the run's own kernel
   launched or compact branch taken;
3. holds each kernel against its plain PyTorch version on the card, over
   the first BFS phase of the main-path graphs, level by level, bit for bit
   (tolerance 0: the outputs are integers): the fused sweep on every graph
   and body, the proposal and the pull kernel on kron (WR) and the random
   graph (plain), the pull kernel also against the fused one; and times
   each kernel and plain version with CUDA events;
4. solves ``instance_sets("small")`` (all nine families) through every
   solve path on the card and requires the CPU's ``cmatch``, ``rmatch``,
   ``phases``, ``fallbacks`` and ``certified``;
5. profiles one more kron solve with ``torch.profiler`` (device time by
   kernel, the device's busy share of the wall time);
6. prints one ``{"kernels": [...]}`` line, then as its last line
   ``{"ok": true, "device": {...}}``.

It imports neither JAX nor the JAX package.  It needs a CUDA card and the
repository's ``src/``; without either it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import multiprocessing
import os
import subprocess
import sys
import time

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
KRON, RANDOM, GRID = range(3)
_APSB_EXACT = dict(algo="apsb", wr_exact=True)
# the other solve paths: (main-path graph, solve path, config on top of the
# path's overrides, warm start, what the run must show: a launch counter or
# a solver counter that must be > 0, and counters that must stay 0)
PATH_RUNS = [
    (KRON, "legacy", dict(), "cheap", "frontier_expand_wr",
     ("frontier_expand_fused_wr", "frontier_expand_fused_plain")),
    (RANDOM, "legacy", dict(kernel="gpubfs"), "karp_sipser",
     "frontier_expand_plain", ()),
    (KRON, "dirop_pallas", dict(), "cheap", "frontier_expand_pull_wr", ()),
    # forced pull: every level streams the mirror
    (RANDOM, "dirop_pallas", dict(kernel="gpubfs", dirop_alpha=1e6,
                                  dirop_beta=1e6), "karp_sipser",
     "frontier_expand_pull_plain", ()),
    # the auto pull geometry (1024 rows of degree <= 8) admits the compact
    # pull on no level of this grid (the first run shows it); a quarter of
    # the rows does, still a gather of fewer slots than the dense sweep's
    (GRID, "dirop", _APSB_EXACT, "cheap", "push_levels", ()),
    (GRID, "dirop", dict(_APSB_EXACT, pull_cap=1 << 18), "cheap",
     "pull_levels", ()),
    (GRID, "adaptive", _APSB_EXACT, "cheap", "compact_levels", ()),
]
_SRC = "src/repro/kernels/frontier_expand/frontier_expand.py"
KERNELS = {          # kernel body -> the TPU kernel it replaces
    "frontier_expand_fused_wr": f"{_SRC}:187",
    "frontier_expand_fused_plain": f"{_SRC}:195",
    "frontier_expand_wr": f"{_SRC}:146",
    "frontier_expand_plain": f"{_SRC}:154",
    "frontier_expand_pull_wr": f"{_SRC}:233",
    "frontier_expand_pull_plain": f"{_SRC}:241",
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def say(*parts) -> None:
    print(*parts, flush=True)


def label(entry) -> str:
    name, args, kw = entry[:3]
    parts = [repr(a) for a in args] + [f"{k}={v!r}" for k, v in kw.items()]
    return f"{name}({', '.join(parts)})"


def use_src() -> None:
    """Import the port from this checkout (worker processes start bare)."""
    if os.path.join(HERE, "src") not in sys.path:
        sys.path.insert(0, os.path.join(HERE, "src"))


def make_graph(entry):
    """Worker process: one main-path graph from the port's generators, and
    its maximum cardinality by scipy (independent of the code under test).
    """
    use_src()
    from scipy.sparse.csgraph import maximum_bipartite_matching
    from repro_torch import graphs
    name, args, kw = entry[:3]
    t0 = time.perf_counter()
    g = getattr(graphs, name)(*args, **kw)
    t1 = time.perf_counter()
    m = maximum_bipartite_matching(g.to_scipy().tocsr(), perm_type="column")
    return g, int((m >= 0).sum()), t1 - t0, time.perf_counter() - t1


def small_sets_cpu(path: str) -> dict:
    """Worker process: ``instance_sets("small")`` solved on the CPU through
    one solve path; family -> (cmatch, rmatch, phases, fallbacks,
    certified), the matching as numpy arrays with sentinel slots."""
    use_src()
    torch.set_num_threads(1)
    return {name: outcome(run_path(path, g, "cpu"))
            for name, g in small_sets().items()}


def small_sets() -> dict:
    from repro_torch.graphs import instance_sets
    return instance_sets("small")


def run_path(path: str, g, device):
    """One solve of ``g`` through a registered solve path, cheap start."""
    from repro_torch.matching import SOLVE_PATHS
    return SOLVE_PATHS[path].solve(g, device=device)


def outcome(state) -> tuple:
    return (state.cmatch.cpu().numpy(), state.rmatch.cpu().numpy(),
            int(state.phases), int(state.fallbacks), bool(state.certified))


def start_workers(pool, paths) -> tuple:
    """Start the graph workers and the CPU small-set workers together."""
    graphs = [pool.apply_async(make_graph, (e,)) for e in MAIN_PATH]
    small = {p: pool.apply_async(small_sets_cpu, (p,)) for p in paths}
    return graphs, small


def collect_graphs(pending) -> list:
    out = [r.get() for r in pending]
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


def distinct(ids, n: int) -> int:
    """How many distinct values in [0, n) ``ids`` holds."""
    seen = torch.zeros(n + 1, dtype=torch.bool, device=ids.device)
    seen[ids.long().clamp(0, n)] = True
    return int(seen[:n].sum())


def push_bytes(ecol, cadj, bfs, root, rmatch, level: int) -> int:
    """Bytes one push sweep (the fused kernel) must move for this level's
    inputs: ecol and bfs whole, the (nr+1,) winner write; cadj only for
    the edges whose column is on the frontier (WR: and whose root is
    alive), root and rmatch once per distinct column and row those edges
    touch."""
    nc, nr = bfs.numel() - 1, rmatch.numel() - 1
    c = ecol.long()
    on = bfs[c] == level
    nbytes = 4 * ecol.numel() + 4 * (nc + 1) + 4 * (nr + 1)
    if root is not None:
        nbytes += 4 * distinct(c[on], nc)
        on &= bfs[root[c].long()] >= 1
    return nbytes + 4 * int(on.sum()) + 4 * distinct(cadj[on], nr)


def proposal_bytes(ecol, cadj, bfs, root, rmatch, level: int) -> int:
    """The proposal kernel's bytes: the push sweep's reads, and the
    (nnz_pad,) proposal write in place of the winner write."""
    return (push_bytes(ecol, cadj, bfs, root, rmatch, level)
            - 4 * rmatch.numel() + 4 * ecol.numel())


def pull_bytes(radj, erow, bfs, root, rmatch, level: int) -> int:
    """Bytes one pull sweep must move for this level's inputs: erow whole;
    rmatch once per distinct row of the mirror; bfs of the matched column
    once per distinct matched row; radj only for the edges of unreached
    rows; bfs (WR: and root) once per distinct column those edges touch;
    the (nr+1,) winner write."""
    nc, nr = bfs.numel() - 1, rmatch.numel() - 1
    real = erow < nr
    r = erow[real].long()
    cm = rmatch[r]
    unreached = (cm == -1) | ((cm >= 0) & (bfs[cm.clamp(0, nc).long()] == 1))
    rows = distinct(r, nr)
    matched_rows = distinct(r[cm >= 0], nr)
    cols = distinct(radj[real][unreached], nc)
    return (4 * erow.numel() + 4 * rows + 4 * matched_rows
            + 4 * int(unreached.sum())
            + 4 * cols * (2 if root is not None else 1) + 4 * (nr + 1))


def bound_ms(nbytes: int) -> float:
    """Least time on this card to move ``nbytes`` over HBM bandwidth."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def warm_up() -> None:
    """One small solve first, so CUDA context and module loading do not
    land in the first main-path wall time."""
    from repro_torch.graphs import instance_sets
    from repro_torch.matching import Matcher, TorchCSR
    Matcher(warm_start="cheap").run(
        TorchCSR.from_host(instance_sets("mini")["rand"]))
    torch.cuda.synchronize()


def solve_once(g, cfg, ws: str) -> tuple:
    """One run through the user's entry points, every launch and solver
    count set to 0 just before it; returns (state, row of measurements)."""
    from repro_torch.kernels.frontier_expand import LAUNCHES, reset_launches
    from repro_torch.matching import Matcher, TorchCSR
    from repro_torch.matching.solve import COUNTERS

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    COUNTERS.reset()
    t0 = time.perf_counter()
    graph = TorchCSR.from_host(g)
    csc_s = 0.0
    if cfg.dirop:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        graph = graph.with_csc()
        torch.cuda.synchronize()
        csc_s = time.perf_counter() - t1
    state = Matcher(cfg, ws).run(graph)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    row = dict(wall_s=wall, with_csc_s=csc_s, phases=int(state.phases),
               fallbacks=int(state.fallbacks),
               certified=bool(state.certified),
               launches=dict(LAUNCHES), **COUNTERS.as_dict(),
               max_memory_allocated=torch.cuda.max_memory_allocated())
    return state, row


def main_path(graphs) -> list:
    """Phase 2: every run of ``MAIN_PATH`` and ``PATH_RUNS``, each checked
    against scipy and for its own kernel or branch.  ``graphs`` holds
    (graph, scipy cardinality) pairs."""
    from repro_torch.core import validate_matching
    from repro_torch.matching import SOLVE_PATHS, MatcherConfig

    runs = []
    for i, entry in enumerate(MAIN_PATH):
        body = "wr" if entry[3].get("kernel", "gpubfs_wr") == "gpubfs_wr" \
            else "plain"
        runs.append((i, "jnp", entry[3], entry[4],
                     f"frontier_expand_fused_{body}", ()))
    runs += PATH_RUNS
    results = []
    for gi, path, cfg_kw, ws, must, zero in runs:
        (g, want), expr = graphs[gi], label(MAIN_PATH[gi])
        cfg = SOLVE_PATHS[path].configure(MatcherConfig(**cfg_kw))
        state, row = solve_once(g, cfg, ws)
        cm, rm = state.to_host()
        card = validate_matching(g, cm, rm)
        row = dict(graph=expr, path=path, config=cfg.name,
                   overrides={k: v for k, v in dataclasses.asdict(cfg).items()
                              if v != getattr(MatcherConfig(), k)},
                   warm_start=ws, nc=g.nc, nr=g.nr, nnz=g.nnz,
                   cardinality=card, scipy_cardinality=want, **row)
        say("main path:", json.dumps(row))
        what = f"{expr} via {path}"
        if card != want:
            fail(f"{what}: cardinality {card} != scipy's {want}")
        if not row["certified"]:
            fail(f"{what}: result not certified maximum")
        seen = row["launches"].get(must, row.get(must))
        if not seen:
            fail(f"{what}: {must} is {seen}, the run did not take its path")
        for k in zero:
            if row["launches"][k]:
                fail(f"{what}: {k} launched {row['launches'][k]} times")
        results.append(row)
    return results


def check_levels(graph, warm, wr: bool, wr_exact: bool, extra: bool) -> dict:
    """The first BFS phase from ``warm``, level by level: the fused kernel
    against its plain version and, with ``extra``, the proposal kernel and
    the pull kernel against theirs (the pull also against the fused
    kernel), all bit for bit.  Returns, per kernel, the states and the
    bound of each level."""
    from repro_torch.kernels.frontier_expand import (
        frontier_expand, frontier_expand_fused, frontier_expand_fused_ref,
        frontier_expand_pull, frontier_expand_pull_ref, frontier_expand_ref)
    from repro_torch.matching.solve import _apply_winner, level0_state

    nc, nr = graph.nc, graph.nr
    bfs, root = level0_state(warm.cmatch)
    pred = torch.full((nr + 1,), nc, dtype=torch.int32,
                      device=warm.cmatch.device)
    rmatch, level = warm.rmatch, 2
    out = {k: ([], []) for k in ("fused", "proposals", "pull")}
    body = "WR" if wr else "plain"

    def check(name, got, want, args, nbytes):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"{name} ({body}) differs from its plain version at "
                 f"level {level}")
        out[name][0].append(args)
        out[name][1].append(bound_ms(nbytes))

    while True:
        rt = root if wr else None
        args = (graph.ecol, graph.cadj, bfs, rt, rmatch, level)
        win = frontier_expand_fused(*args)
        check("fused", win, frontier_expand_fused_ref(*args), args,
              push_bytes(*args))
        if extra:
            check("proposals", frontier_expand(*args),
                  frontier_expand_ref(*args), args, proposal_bytes(*args))
            pargs = (graph.radj, graph.erow, bfs, rt, rmatch, level)
            pull = frontier_expand_pull(*pargs)
            check("pull", pull, frontier_expand_pull_ref(*pargs), pargs,
                  pull_bytes(*pargs))
            if not torch.equal(pull, win):
                fail(f"pull kernel ({body}) differs from the fused kernel "
                     f"at level {level}")
        bfs, root, pred, rmatch, ins, _ = _apply_winner(
            win, bfs, root, pred, rmatch, level, wr=wr, wr_exact=wr_exact)
        level += 1
        if not bool(ins):
            return out


def kernel_checks(graphs) -> list:
    """Phase 3: each kernel against its plain version over the first BFS
    phase of the main-path graphs (the fused sweep on every graph and both
    bodies, the proposal and pull kernels on kron WR and random plain),
    timed with CUDA events."""
    from repro_torch.kernels.frontier_expand import (
        frontier_expand, frontier_expand_fused, frontier_expand_fused_ref,
        frontier_expand_pull, frontier_expand_pull_ref, frontier_expand_ref)
    from repro_torch.matching import Matcher, MatcherConfig, TorchCSR

    fns = {"fused": ("frontier_expand_fused", frontier_expand_fused,
                     frontier_expand_fused_ref),
           "proposals": ("frontier_expand", frontier_expand,
                         frontier_expand_ref),
           "pull": ("frontier_expand_pull", frontier_expand_pull,
                    frontier_expand_pull_ref)}
    rows = []
    for gi, (entry, (g, _)) in enumerate(zip(MAIN_PATH, graphs)):
        expr, cfg_kw, ws = label(entry), entry[3], entry[4]
        graph = TorchCSR.from_host(g)
        if gi in (KRON, RANDOM):
            graph = graph.with_csc()
        warm = Matcher(MatcherConfig(**cfg_kw), ws).init(graph)
        for wr in (True, False):
            extra = (gi, wr) in ((KRON, True), (RANDOM, False))
            per = check_levels(graph, warm, wr,
                               wr and cfg_kw.get("wr_exact", False), extra)
            for kind, (states, bounds) in per.items():
                if not states:
                    continue
                name, kernel, plain = fns[kind]
                n = len(states)
                k_ms = cuda_ms(lambda: [kernel(*a) for a in states]) / n
                p_ms = cuda_ms(lambda: [plain(*a) for a in states]) / n
                row = dict(graph=expr, kernel=f"{name}_{'wr' if wr else 'plain'}",
                           levels_checked=n, max_abs_err=0, kernel_ms=k_ms,
                           plain_ms=p_ms, bound_ms=sum(bounds) / n,
                           nnz_pad=graph.nnz_pad)
                say("kernel vs plain:", json.dumps(row))
                rows.append(row)
        del graph, warm
        torch.cuda.empty_cache()
    return rows


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


def small_sets_bit_exact(cpu_results) -> None:
    """Phase 4: every solve path on the card gives the CPU's answer, which
    worker processes computed (``cpu_results``: path -> pending result)."""
    from repro_torch.matching import SOLVE_PATHS

    for path in SOLVE_PATHS:
        t0 = time.perf_counter()
        cuda = {name: outcome(run_path(path, g, "cuda"))
                for name, g in small_sets().items()}
        cuda_s = time.perf_counter() - t0
        cpu = cpu_results[path].get()
        for name, (ca, ra, *rest) in cuda.items():
            cb, rb, *rest_b = cpu[name]
            if not ((ca == cb).all() and (ra == rb).all()
                    and rest == rest_b):
                fail(f"instance_sets('small')[{name!r}] via {path} differs "
                     f"between the card and the CPU")
        say(f"small sets via {path}: card == CPU on {len(cuda)} families, "
            f"phases {[v[2] for v in cuda.values()]}, all certified "
            f"{all(v[4] for v in cuda.values())}, card {cuda_s:.2f} s")


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
    use_src()
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

    from repro_torch.matching import SOLVE_PATHS

    # graphs and the CPU half of the small-set check, in worker processes;
    # terminated on the way out whatever happens
    pool = multiprocessing.get_context("spawn").Pool(
        len(MAIN_PATH) + 2)
    try:
        return run_phases(pool, list(SOLVE_PATHS))
    finally:
        pool.terminate()
        pool.join()


def run_phases(pool, paths) -> int:
    t0 = time.perf_counter()
    pending_graphs, cpu_small = start_workers(pool, paths)
    graphs = [(g, want) for g, want, *_ in collect_graphs(pending_graphs)]
    phase("graphs and scipy cardinalities", t0)

    t0 = time.perf_counter()
    warm_up()
    runs = main_path(graphs)
    phase("main path", t0)
    t0 = time.perf_counter()
    checks = kernel_checks(graphs)
    phase("kernel checks", t0)
    t0 = time.perf_counter()
    small_sets_bit_exact(cpu_small)
    phase("small sets", t0)
    t0 = time.perf_counter()
    profile_main_path(MAIN_PATH[KRON], graphs[KRON][0])
    phase("profile", t0)

    # one line for the kernels, each timed on the main-path graph of its
    # body: kron for WR, the random graph for plain
    timed_on = {"wr": label(MAIN_PATH[KRON]), "plain": label(MAIN_PATH[RANDOM])}
    kernels = []
    for name, replaces in KERNELS.items():
        mine = [r for r in checks if r["kernel"] == name]
        row = next(r for r in mine
                   if r["graph"] == timed_on[name.rsplit("_", 1)[1]])
        kernels.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/frontier_expand.cu",
            replaces=replaces,
            launches=sum(r["launches"][name] for r in runs),
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=row["kernel_ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by="bytes", library_ms=None,
            timed_on=row["graph"],
            levels_checked=sum(r["levels_checked"] for r in mine)))
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def phase(name: str, t0: float) -> None:
    say(f"phase {name}: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    sys.exit(main())
