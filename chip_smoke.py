#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the root of a checkout on a machine with a CUDA card::

    python3 chip_smoke.py

What it does, in order; any failure raises and the exit code is not 0:

1. prints the card's name and power limit (``nvidia-smi``) and builds every
   CUDA kernel of the port from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, ``sm_90a``, all started together), printing the build times and
   each kernel's registers and spills (the tensor-core flash body must not
   spill); then worker processes make the main-path graphs and
   their cardinalities by scipy, solve each main-path graph on the CPU
   (for step 2) and solve the small corpus on the CPU through every solve
   path (for step 4);
2. drives the matching main path, ``TorchCSR.from_host`` (then ``with_csc``
   for the direction-optimizing paths) -> warm start -> APFB/APsB solve, on
   three full-size graphs made by the port's own generators, through every
   solve path: the fused push sweep, the legacy proposal kernel, the pull
   kernel, the compact pull and the adaptive compact gather.  ``Matcher.
   run`` is one compile-cache entry per (bucket, config, warm start) whose
   steps are CUDA graphs and whose loops are conditional WHILE nodes: each
   run is made cold (the entry built and its graphs captured, as a jit
   compile) and then warm (a cache hit, no new capture), each timed with
   its upload (``upload_s``, ``TorchCSR.
   from_host`` alone, beside the wall), and once more under torch's sync
   debug mode, whose count of host waits must be the solver's own
   ``host_syncs``.  Every kernel launch counter (device counters, so
   replayed launches count) and solver counter is set to 0 just before each
   run and read just after; the warm run is the one the launch checks read.
   Each result is checked five ways: a valid matching, a cardinality equal
   to scipy's ``maximum_bipartite_matching`` (independent of the code under
   test), ``certified`` True, the CPU's state bit for bit (a worker's run of
   the main-path config on the same graph; every path gives the same
   state), and the run's own kernel launched or compact branch taken.  The
   entry's bytes are read: its static buffers, and the memory the card
   holds for it (buffers and the graphs' pool);
3. holds each frontier kernel against its plain PyTorch version on the
   card, over the first BFS phase of the main-path graphs, level by level,
   bit for bit (tolerance 0: the outputs are integers): the fused sweep on
   every graph and body (on kron also with the edge slots in a random
   order and with ``ecol``/``cadj`` as views 1-3 slots into their
   buffers), the proposal kernel, the pull kernel and the pull's column
   pass (``frontier_bits``) on kron (WR) and the random graph (plain), the
   pull kernel also against the fused one, and each sweep with its level
   read from a device scalar and an open gate (as the captured solve
   launches it) against the immediate; times each kernel (both ways) and
   plain version with CUDA events, each level alone too, prints the pull's
   and
   the fused sweep's times level by level side by side, and splits each
   kernel's device time (the pull's into column pass, sweep and fill)
   with ``torch.profiler``;
4. solves ``instance_sets("small")`` (all nine families) through every
   solve path on the card and requires the CPU's ``cmatch``, ``rmatch``,
   ``phases``, ``fallbacks`` and ``certified``;
5. profiles one more solve of each main-path graph with ``torch.profiler``
   (device time by kernel, the fused sweep's and torch's scatter kernels'
   share, the device's busy share of the wall time), and times one in CUDA
   events (the card's span from the first launch to the last);
6. the serving path: ``repro_torch.serving.MatchingService`` on the card
   over the ladder 16,384² .. 262,144² (edge factor 8, ``max_batch`` 16),
   a 256-request trace (the four families of ``serve_matching.FAMILIES``
   round-robin, size hints 2^14 / 2^16 / 2^18, made by the workers with
   scipy's cardinality): ``warm_up()`` (every step of its entries
   captured; their bytes, captures included, against the cache's budget;
   nothing evicted, and the two loops after it capture and evict nothing), a
   closed loop (saturation graphs/s), an open-loop Poisson replay at 0.7×
   that rate (latency, occupancy, dispatches, host syncs per flush, no
   compile miss), a burst through the plain push body, the legacy kernel
   and the pull kernel (forced, both bodies) on the 2^16 bucket, all three
   with the counts set to 0 just before and read just after (every
   body's batched instantiation, a flush of more than one lane, must
   launch; a flush of one lane launches the single-graph one), and the ``--chaos`` drill of
   ``serve_matching``.
   Every served request: a valid matching at scipy's cardinality,
   certified, and the card's single-graph ``Matcher.run`` of the same
   bucket-padded graph bit for bit; one batch of the 2^14 bucket equals the
   CPU's ``run_many``.  Then each frontier kernel body with its lane
   dimension on a 16-lane batch of the 2^18 bucket over the first BFS
   phase (lanes started at staggered levels, lanes gated off, at most
   ``LANE_CHECK_LEVELS`` levels): one launch against its plain version and
   against 16 single-graph launches, bit for bit, each timed (CUDA events)
   beside its bound;
7. holds the flash-attention kernel against its plain version on the card
   (TF32 off): the shapes of ``tests/test_kernels.py`` in fp32 (the CUDA-core
   body, 2e-5) and bf16 (the tensor-core body, 2e-2) and granite-20b's
   layer shape (B=4, S=4096, H=48, KV=1, hd=128, bf16), both masks, each
   launch counted on the body its dtype routes to; at granite's shape also
   in scaled norms (``FA_REL_TOL``: l2, max and the worst query row), each
   of which a control with one key tile dropped must exceed; times it
   (both masks, with its TFLOP/s), the plain version and
   ``scaled_dot_product_attention`` (the yardstick, never called by the
   port) at granite's shape; and the fp32 body at granite's shape against
   its plain version (2e-5), timed beside both in fp32;
8. granite-20b at full width with two layers in fp32: the forward through
   the kernel against the torch-op attention (1e-3), and teacher-forced
   ``decode_step`` over 64 tokens against the forward (2e-3);
9. the LM main path: granite-20b FULL, bf16, 52 layers, seeded weights.
   ``build_prefill_step`` on 4 prompts of 4096 tokens with the flash-kernel
   counts set to 0 just before and read just after (52 launches, all on the
   tensor-core body; finite logits); the same prefill through ``blockwise_attn`` (gap of the
   last-position logits within ``LOGIT_GAP_TOL``) and once more with one
   layer's attention zeroed (a control that must exceed the gap's gate);
   greedy serving (batch 4, a 64-token prompt stepped, 16 tokens
   generated); the prefill and serving profiled;
10. prints one ``{"kernels": [...]}`` line (the batched launch of each
   body as its own entry, ``lanes`` 16), then as its last line
   ``{"ok": true, "device": {...}}``.

It imports neither JAX nor the JAX package.  It needs a CUDA card and the
repository's ``src/``; without either it exits non-zero and prints no result.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import multiprocessing
import os
import re
import subprocess
import sys
import time
import warnings

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
    (KRON, "legacy", dict(), "cheap", ("frontier_expand_wr",),
     ("frontier_expand_fused_wr", "frontier_expand_fused_plain")),
    (RANDOM, "legacy", dict(kernel="gpubfs"), "karp_sipser",
     ("frontier_expand_plain",), ()),
    (KRON, "dirop_pallas", dict(), "cheap",
     ("frontier_expand_pull_wr", "frontier_bits_wr"), ()),
    # forced pull: every level streams the mirror
    (RANDOM, "dirop_pallas", dict(kernel="gpubfs", dirop_alpha=1e6,
                                  dirop_beta=1e6), "karp_sipser",
     ("frontier_expand_pull_plain", "frontier_bits_plain"), ()),
    # the auto pull geometry (1024 rows of degree <= 8) admits the compact
    # pull on no level of this grid (the first run shows it); a quarter of
    # the rows does, still a gather of fewer slots than the dense sweep's
    (GRID, "dirop", _APSB_EXACT, "cheap", ("push_levels",), ()),
    (GRID, "dirop", dict(_APSB_EXACT, pull_cap=1 << 18), "cheap",
     ("pull_levels",), ()),
    (GRID, "adaptive", _APSB_EXACT, "cheap", ("compact_levels",), ()),
]
_SRC = "src/repro/kernels/frontier_expand/frontier_expand.py"
KERNELS = {          # kernel body -> the TPU kernel it replaces
    "frontier_expand_fused_wr": f"{_SRC}:187",
    "frontier_expand_fused_plain": f"{_SRC}:195",
    "frontier_expand_wr": f"{_SRC}:146",
    "frontier_expand_plain": f"{_SRC}:154",
    "frontier_expand_pull_wr": f"{_SRC}:233",
    "frontier_expand_pull_plain": f"{_SRC}:241",
    # the pull's column pass: the column half of _proposals (:125) that
    # _kernel_pull_wr / _kernel_pull evaluate per edge
    "frontier_bits_wr": f"{_SRC}:233",
    "frontier_bits_plain": f"{_SRC}:241",
}


def ptxas_report(log: str) -> dict:
    """Registers and spill bytes of each kernel in ``nvcc -Xptxas -v``
    output, by kernel and template argument (``flash_fwd_tc<128>``); empty
    for a library that was already built.  The registers are those of the
    launch; a body that moves registers between warpgroups with
    ``setmaxnreg`` gives its consumer warpgroups more."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            k = re.search(r"\d+((?:flash_fwd|fused_sweep|proposals|"
                          r"pull_sweep|frontier_bits)\w*?)"
                          r"(?:I((?:L[a-z]\d+E)+)E|E)",
                          m.group(1))
            args = re.findall(r"L[a-z](\d+)E", k.group(2) or "") if k else []
            name = m.group(1) if k is None else k.group(1) + (
                f"<{','.join(args)}>" if args else "")
            out[name] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and name:
            out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


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


def main_path_cpu(entry) -> tuple:
    """Worker process: one main-path graph solved on the CPU with its
    main-path config and warm start.  Returns the outcome and the seconds
    it took."""
    use_src()
    torch.set_num_threads(2)
    from repro_torch import graphs
    from repro_torch.matching import Matcher, MatcherConfig, TorchCSR
    name, args, kw = entry[:3]
    g = getattr(graphs, name)(*args, **kw)
    t0 = time.perf_counter()
    state = Matcher(MatcherConfig(**entry[3]), entry[4]).run(
        TorchCSR.from_host(g, device="cpu"))
    return outcome(state), time.perf_counter() - t0


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
    """Start the graph workers, the CPU main-path workers and the CPU
    small-set workers together."""
    graphs = [pool.apply_async(make_graph, (e,)) for e in MAIN_PATH]
    cpu = [pool.apply_async(main_path_cpu, (e,)) for e in MAIN_PATH]
    small = {p: pool.apply_async(small_sets_cpu, (p,)) for p in paths}
    return graphs, cpu, small


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


def bits_bytes(bfs, root, level: int) -> int:
    """Bytes the pull's column pass must move: bfs whole, the
    ceil((nc+1)/32) words written; WR also root for each column on the
    frontier and bfs once per distinct root of those."""
    nc = bfs.numel() - 1
    nbytes = 4 * (nc + 1) + 4 * ((nc + 32) // 32)
    if root is not None:
        on = bfs == level
        nbytes += 4 * int(on.sum()) + 4 * distinct(root[on], nc)
    return nbytes


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


def counted_run(g, cfg, ws: str) -> tuple:
    """``TorchCSR.from_host`` (and ``with_csc``) then ``Matcher.run``, every
    launch and solver count set to 0 just before and read just after;
    returns (state, graph, row): the wall, the upload alone, the counts."""
    from repro_torch.kernels.frontier_expand import LAUNCHES, reset_launches
    from repro_torch.matching import Matcher, TorchCSR
    from repro_torch.matching.solve import COUNTERS

    torch.cuda.synchronize()
    reset_launches()
    COUNTERS.reset()
    t0 = time.perf_counter()
    graph = TorchCSR.from_host(g)
    torch.cuda.synchronize()
    upload = time.perf_counter() - t0
    csc_s = 0.0
    if cfg.dirop:
        t1 = time.perf_counter()
        graph = graph.with_csc()
        torch.cuda.synchronize()
        csc_s = time.perf_counter() - t1
    state = Matcher(cfg, ws).run(graph)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return state, graph, dict(wall_s=wall, upload_s=upload, with_csc_s=csc_s,
                              launches=dict(LAUNCHES), **COUNTERS.as_dict())


def sync_debug_count(matcher, graph) -> tuple:
    """``matcher.run(graph)`` under torch's sync debug mode: (waits of the
    host for the card that it reports, the solver's own host syncs)."""
    from repro_torch.matching.solve import COUNTERS
    torch.cuda.synchronize()
    before = COUNTERS.host_syncs
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            matcher.run(graph)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return (sum("synchroniz" in str(w.message) for w in caught),
            COUNTERS.host_syncs - before)


WARM_RUNS = 3


def solve_once(g, cfg, ws: str) -> tuple:
    """One configuration cold (its cache entry built, graphs captured) and
    ``WARM_RUNS`` times warm (hits: no new entry, no new capture), each
    through the user's entry points with every count set to 0 just before
    it; then one run under the sync debug mode.  Returns (last warm state,
    cold state, row): the last warm run's counts, the best warm wall and
    all of them, the cold wall, and the entry's bytes."""
    from repro_torch.matching import Matcher, compile_cache_info
    from repro_torch.matching.cache import compile_cache_entry

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    misses = compile_cache_info()["misses"]
    cold, graph, cold_row = counted_run(g, cfg, ws)
    key = compile_cache_info()["keys"][-1]
    prog = compile_cache_entry(key)
    if compile_cache_info()["misses"] != misses + 1 or prog is None:
        fail(f"the cold run of {cfg.name} built no cache entry")
    dev = graph.device
    captures = prog.captures(dev)
    del graph
    torch.cuda.empty_cache()
    # the entry's buffers and its graphs' pool, less the state it returned
    entry_reserved = (torch.cuda.memory_reserved() - reserved
                      - 4 * (cold.cmatch.numel() + cold.rmatch.numel()))
    torch.cuda.reset_peak_memory_stats()
    # three warm runs, each with its upload: the best wall is reported (the
    # upload from pageable host memory varies from run to run)
    walls = []
    for _ in range(WARM_RUNS):
        warm, graph, row = counted_run(g, cfg, ws)
        walls.append(row["wall_s"])
    if compile_cache_info()["misses"] != misses + 1:
        fail(f"the warm run of {cfg.name} missed the cache")
    if prog.captures(dev) != captures:
        fail(f"the warm run of {cfg.name} captured "
             f"{prog.captures(dev) - captures} more graphs")
    debug_waits, debug_syncs = sync_debug_count(Matcher(cfg, ws), graph)
    row.update(
        cold_wall_s=cold_row["wall_s"], cold_upload_s=cold_row["upload_s"],
        warm_wall_s=min(walls), warm_walls_s=walls,
        cold_host_syncs=cold_row["host_syncs"],
        cold_launches=cold_row["launches"], sync_debug_waits=debug_waits,
        sync_debug_host_syncs=debug_syncs, graphs_captured=captures,
        entry_static_bytes=prog.static_bytes(dev),
        entry_bytes=prog.nbytes(dev), entry_reserved_bytes=entry_reserved,
        phases=int(warm.phases), fallbacks=int(warm.fallbacks),
        certified=bool(warm.certified),
        max_memory_allocated=torch.cuda.max_memory_allocated())
    return warm, cold, row


def same_outcome(a, b) -> bool:
    ca, ra, *rest_a = a
    cb, rb, *rest_b = b
    return bool((ca == cb).all() and (ra == rb).all()) and rest_a == rest_b


def main_path(graphs) -> tuple:
    """Phase 2: every run of ``MAIN_PATH`` and ``PATH_RUNS``, cold and warm,
    each checked against scipy, the warm state against the cold one, for
    no wait beyond its host syncs and for its own kernel or branch.
    ``graphs`` holds (graph, scipy cardinality) pairs.  The cache is
    cleared after each graph's runs.  Returns the rows and, per run, its
    main-path graph and warm outcome (for :func:`check_cpu`)."""
    from repro_torch.core import validate_matching
    from repro_torch.matching import (SOLVE_PATHS, MatcherConfig,
                                      compile_cache_clear)

    runs = []
    for i, entry in enumerate(MAIN_PATH):
        body = "wr" if entry[3].get("kernel", "gpubfs_wr") == "gpubfs_wr" \
            else "plain"
        runs.append((i, "jnp", entry[3], entry[4],
                     (f"frontier_expand_fused_{body}",), ()))
    runs += PATH_RUNS
    runs.sort(key=lambda r: r[0])                     # graph by graph
    results, outcomes = [], []
    for i, (gi, path, cfg_kw, ws, must, zero) in enumerate(runs):
        (g, want), expr = graphs[gi], label(MAIN_PATH[gi])
        cfg = SOLVE_PATHS[path].configure(MatcherConfig(**cfg_kw))
        state, cold, row = solve_once(g, cfg, ws)
        got = outcome(state)
        outcomes.append((gi, path, got))
        same_cold = same_outcome(got, outcome(cold))
        cm, rm = state.to_host()
        card = validate_matching(g, cm, rm)
        row = dict(graph=expr, path=path, config=cfg.name,
                   overrides={k: v for k, v in dataclasses.asdict(cfg).items()
                              if v != getattr(MatcherConfig(), k)},
                   warm_start=ws, nc=g.nc, nr=g.nr, nnz=g.nnz,
                   cardinality=card, scipy_cardinality=want,
                   cold_equal_warm=same_cold, **row)
        say("main path:", json.dumps(row))
        what = f"{expr} via {path}"
        if card != want:
            fail(f"{what}: cardinality {card} != scipy's {want}")
        if not row["certified"]:
            fail(f"{what}: result not certified maximum")
        if not same_cold:
            fail(f"{what}: the warm run's state differs from the cold run's")
        if row["sync_debug_waits"] != row["sync_debug_host_syncs"]:
            fail(f"{what}: the sync debug mode saw "
                 f"{row['sync_debug_waits']} waits for "
                 f"{row['sync_debug_host_syncs']} host syncs")
        for m in must:
            seen = row["launches"].get(m, row.get(m))
            if not seen:
                fail(f"{what}: {m} is {seen}, the run did not take its path")
        for k in zero:
            if row["launches"][k]:
                fail(f"{what}: {k} launched {row['launches'][k]} times")
        results.append(row)
        if i + 1 == len(runs) or runs[i + 1][0] != gi:
            del state, cold
            compile_cache_clear()
            torch.cuda.empty_cache()
    return results, outcomes


def check_cpu(outcomes, cpu_pending) -> None:
    """Every main-path and path run's state equals the CPU's bit for bit:
    the workers' runs of each main-path graph with its main-path config
    (``cpu_pending``); every path gives that config's state."""
    cpu = {}
    for gi, path, got in outcomes:
        if gi not in cpu:
            cpu[gi], cpu_s = cpu_pending[gi].get()
            say(f"cpu run of {label(MAIN_PATH[gi])}: {cpu_s:.1f} s")
        if not same_outcome(got, cpu[gi]):
            fail(f"{label(MAIN_PATH[gi])} via {path}: the card's state "
                 f"differs from the CPU's")
    say(f"main path: all {len(outcomes)} runs equal the CPU's state")


def edge_variants(graph) -> dict:
    """The fused kernel's other edge layouts, each the same edge set:
    the slots in a seeded random order (ecol no longer sorted), and ecol /
    cadj as views 1, 2 and 3 int32 slots into larger buffers (offsets of
    4, 8 and 12 bytes, so the vector body has head and tail slots), also at
    two offsets that differ (cadj then read slot by slot)."""
    gen = torch.Generator(device=graph.ecol.device).manual_seed(15)
    perm = torch.randperm(graph.ecol.numel(), generator=gen,
                          device=graph.ecol.device)

    def view(t, offset):
        buf = torch.full((t.numel() + offset,), -99, dtype=torch.int32,
                         device=t.device)
        buf[offset:] = t
        return buf[offset:]

    out = {"permuted": (graph.ecol[perm], graph.cadj[perm])}
    for oe, oc in ((1, 1), (2, 2), (3, 3), (1, 3)):
        out[f"views at +{oe}/+{oc}"] = (view(graph.ecol, oe),
                                        view(graph.cadj, oc))
    return out


def device_args(kind: str, args: tuple) -> tuple:
    """A kernel's arguments as the captured solve passes them: the level a
    0-d int32 tensor on the card, and (the sweeps) an open gate."""
    level = torch.full((), args[-1], dtype=torch.int32, device=CARD)
    if kind == "bits":
        return (*args[:-1], level)
    return (*args[:-1], level, torch.ones_like(level))


def check_levels(graph, warm, wr: bool, wr_exact: bool, extra: bool,
                 variants=None) -> dict:
    """The first BFS phase from ``warm``, level by level: the fused kernel
    against its plain version and, with ``extra``, the proposal kernel,
    the pull kernel and the pull's column pass against theirs (the pull
    also against the fused kernel), all bit for bit; the fused kernel also
    on each of ``variants`` (name -> (ecol, cadj), the same edges in
    another layout) against the same winners; each also with its level
    read from a device scalar and an open gate (:func:`device_args`)
    against its immediate-level launch.  Returns, per kernel, one dict a
    level: its arguments, bound, level and rows won."""
    from repro_torch.kernels.frontier_expand import (
        frontier_bits, frontier_bits_ref, frontier_expand,
        frontier_expand_fused, frontier_expand_fused_ref,
        frontier_expand_pull, frontier_expand_pull_ref, frontier_expand_ref)
    from repro_torch.matching.solve import _apply_winner, level0_state

    nc, nr = graph.nc, graph.nr
    bfs, root = level0_state(warm.cmatch)
    pred = torch.full((nr + 1,), nc, dtype=torch.int32,
                      device=warm.cmatch.device)
    rmatch, level = warm.rmatch, 2
    out = {k: [] for k in ("fused", "proposals", "pull", "bits")}
    body = "WR" if wr else "plain"

    def check(name, fn, got, want, args, nbytes):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"{name} ({body}) differs from its plain version at "
                 f"level {level}")
        if not torch.equal(fn(*device_args(name, args)), got):
            fail(f"{name} ({body}) with its level on the card differs from "
                 f"its launch with the immediate at level {level}")
        out[name].append(dict(args=args, bound=bound_ms(nbytes),
                              level=level, won=won))

    while True:
        rt = root if wr else None
        args = (graph.ecol, graph.cadj, bfs, rt, rmatch, level)
        win = frontier_expand_fused(*args)
        won = int((win < 2**30).sum())
        check("fused", frontier_expand_fused, win,
              frontier_expand_fused_ref(*args), args, push_bytes(*args))
        for vname, (ve, vc) in (variants or {}).items():
            if not torch.equal(frontier_expand_fused(ve, vc, *args[2:]),
                               win):
                fail(f"fused kernel ({body}) on the {vname} edges differs "
                     f"from its plain version at level {level}")
        if extra:
            check("proposals", frontier_expand, frontier_expand(*args),
                  frontier_expand_ref(*args), args, proposal_bytes(*args))
            pargs = (graph.radj, graph.erow, bfs, rt, rmatch, level)
            pull = frontier_expand_pull(*pargs)
            check("pull", frontier_expand_pull, pull,
                  frontier_expand_pull_ref(*pargs), pargs, pull_bytes(*pargs))
            if not torch.equal(pull, win):
                fail(f"pull kernel ({body}) differs from the fused kernel "
                     f"at level {level}")
            bargs = (bfs, rt, level)
            check("bits", frontier_bits, frontier_bits(*bargs),
                  frontier_bits_ref(*bargs), bargs, bits_bytes(*bargs))
        bfs, root, pred, rmatch, ins, _ = _apply_winner(
            win, bfs, root, pred, rmatch, level, wr=wr, wr_exact=wr_exact)
        level += 1
        if not bool(ins):
            return out


# kernel -> the parts of its device time in the profiler: part -> a
# fragment of the device kernels' names
SPLITS = {"fused": {"sweep": "fused_sweep", "fill": "emset"},
          "proposals": {"sweep": "proposals"},
          "pull": {"bits": "frontier_bits", "sweep": "pull_sweep",
                   "fill": "emset"},
          "bits": {"bits": "frontier_bits"}}


def kernel_checks(graphs) -> list:
    """Phase 3: each kernel against its plain version over the first BFS
    phase of the main-path graphs (the fused sweep on every graph and both
    bodies, on kron also with its edge slots permuted and as misaligned
    views; the proposal kernel, the pull kernel and its column pass on
    kron WR and random plain), timed with CUDA events over the phase and
    each of its first 16 levels alone, and in profiler device time by
    part; the pull beside the fused sweep level by level."""
    from repro_torch.kernels.frontier_expand import (
        frontier_bits, frontier_bits_ref, frontier_expand,
        frontier_expand_fused, frontier_expand_fused_ref,
        frontier_expand_pull, frontier_expand_pull_ref, frontier_expand_ref)
    from repro_torch.matching import (Matcher, MatcherConfig, TorchCSR,
                                      compile_cache_clear)

    fns = {"fused": ("frontier_expand_fused", frontier_expand_fused,
                     frontier_expand_fused_ref),
           "proposals": ("frontier_expand", frontier_expand,
                         frontier_expand_ref),
           "pull": ("frontier_expand_pull", frontier_expand_pull,
                    frontier_expand_pull_ref),
           "bits": ("frontier_bits", frontier_bits, frontier_bits_ref)}
    rows = []
    for gi, (entry, (g, _)) in enumerate(zip(MAIN_PATH, graphs)):
        expr, cfg_kw, ws = label(entry), entry[3], entry[4]
        graph = TorchCSR.from_host(g)
        if gi in (KRON, RANDOM):
            graph = graph.with_csc()
        warm = Matcher(MatcherConfig(**cfg_kw), ws).init(graph)
        variants = edge_variants(graph) if gi == KRON else {}
        for wr in (True, False):
            extra = (gi, wr) in ((KRON, True), (RANDOM, False))
            per = check_levels(graph, warm, wr,
                               wr and cfg_kw.get("wr_exact", False), extra,
                               variants)
            mine = {}
            for kind, levels in per.items():
                if not levels:
                    continue
                name, kernel, plain = fns[kind]
                states = [lv["args"] for lv in levels]
                n = len(states)
                k_ms = cuda_ms(lambda: [kernel(*a) for a in states]) / n
                dev_states = [device_args(kind, a) for a in states]
                kd_ms = cuda_ms(lambda: [kernel(*a) for a in dev_states]) / n
                p_ms = cuda_ms(lambda: [plain(*a) for a in states]) / n
                row = dict(graph=expr, kernel=f"{name}_{'wr' if wr else 'plain'}",
                           levels_checked=n, max_abs_err=0, kernel_ms=k_ms,
                           kernel_ms_device_level=kd_ms, plain_ms=p_ms,
                           bound_ms=sum(lv["bound"] for lv in levels) / n,
                           nnz_pad=graph.nnz_pad)
                # each of the first 16 levels alone: [level, bound ms, ms,
                # rows won]
                row["per_level"] = [
                    [lv["level"], lv["bound"],
                     cuda_ms(lambda: kernel(*lv["args"])), lv["won"]]
                    for lv in levels[:16]]
                # device time by part (the pull: column pass, sweep, fill)
                prof = device_profile(lambda: [kernel(*a) for a in states],
                                      SPLITS[kind])
                for part in SPLITS[kind]:
                    v = prof[f"{part}_ms"]
                    row[f"device_ms_{part}"] = (
                        v / n if isinstance(v, float) else v)
                if kind == "fused" and variants:
                    row["variants_checked"] = list(variants)
                    ve, vc = variants["permuted"]
                    row["kernel_ms_permuted"] = cuda_ms(
                        lambda: [kernel(ve, vc, *a[2:]) for a in states]) / n
                say("kernel vs plain:", json.dumps(row))
                rows.append(row)
                mine[kind] = row
            if "pull" in mine:
                # does the pull pay on the card: [level, rows won, fused
                # ms, pull ms, its column pass ms, fused bound, pull bound]
                say("pull vs push per level:", json.dumps(dict(
                    graph=expr, body="WR" if wr else "plain", levels=[
                        [f[0], f[3], f[2], p[2], b[2], f[1], p[1]]
                        for f, p, b in zip(mine["fused"]["per_level"],
                                           mine["pull"]["per_level"],
                                           mine["bits"]["per_level"])])))
        del graph, warm, variants
        compile_cache_clear()
        torch.cuda.empty_cache()
    return rows


def device_profile(fn, share_of: dict, split_ops=()) -> dict:
    """``fn()`` once under ``torch.profiler``: the wall time, the device's
    kernel time and busy share of the wall time (the profiler's own cost
    lands in the wall time, so the share is a floor), for each ``name:
    text`` of ``share_of`` the device time, launches and share of device
    time of the kernels whose name holds ``text``, the top kernels, and
    for each torch op named in ``split_ops`` its device time by input
    shape."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=bool(split_ops)) as prof:
        t0 = time.perf_counter()
        fn()
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
    out = dict(wall_s=wall,
               device_s=device_s if rows else "not measured",
               busy_share=device_s / wall if rows else "not measured")
    for name, text in share_of.items():
        part = sum(r[0] for r in rows if text in r[2]) / 1e6
        out[f"{name}_ms"] = part * 1e3 if rows else "not measured"
        out[f"{name}_launches"] = sum(r[1] for r in rows if text in r[2])
        out[f"{name}_share_of_device"] = (part / device_s if rows
                                          else "not measured")
    out["top"] = [dict(kernel=k[:80], ms=us / 1e3, count=n)
                  for us, n, k in rows[:8]]
    if split_ops:
        ops = [(getattr(e, "device_time_total",
                        getattr(e, "cuda_time_total", 0)), e.count, e.key,
                str(e.input_shapes))
               for e in prof.key_averages(group_by_input_shape=True)
               if e.key in split_ops]
        out["by_shape"] = [dict(op=k, shapes=sh[:100], ms=us / 1e3, count=n)
                           for us, n, k, sh in sorted(ops, reverse=True)[:8]]
    return out


# kernel-name fragments read in the profiles: the fused sweep K1, and torch's
# scatter kernel (scatter_reduce and scatter_, the solver's min-scatters)
PROFILE_SHARES = {"sweep": "fused_sweep", "scatter": "scatter_gather"}


def profile_main_path(entry, g) -> dict:
    """Phase 5: one main-path solve again under ``torch.profiler``."""
    from repro_torch.matching import Matcher, MatcherConfig, TorchCSR

    graph = TorchCSR.from_host(g)
    matcher = Matcher(MatcherConfig(**entry[3]), entry[4])
    matcher.run(graph)                      # the cache entry and its graphs
    out = dict(graph=label(entry), **device_profile(
        lambda: matcher.run(graph), PROFILE_SHARES,
        ("aten::scatter_reduce", "aten::scatter_", "aten::where",
         "aten::arange")))
    # the card's span of one warm solve in CUDA events (the profiler may
    # not see every kernel inside a conditional node's body)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    matcher.run(graph)
    end.record()
    end.synchronize()
    out["event_wall_s"] = time.perf_counter() - t0
    out["event_span_s"] = start.elapsed_time(end) / 1e3
    # every wait of the host for the card, counted by torch's sync debug
    # mode, beside the solver's own count of the device values it reads
    out["device_syncs"], out["host_syncs"] = sync_debug_count(matcher, graph)
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


# ---------------------------------------------------------------------------
# the serving path: MatchingService on the card, batched run_many (phase 6)
# ---------------------------------------------------------------------------
SERVE_LADDER = dict(max_vertices=1 << 18, min_vertices=1 << 14)
SERVE_MAX_BATCH = 16
SERVE_DELAY_MS = 2.0
SERVE_REQUESTS = 256
SERVE_HINTS = (1 << 14, 1 << 16, 1 << 18)
SERVE_SEED = 0                     # request i: seed SERVE_SEED + i
SERVE_RATE_FRACTION = 0.7          # the open loop's rate / saturation
BURST_HINT = 1 << 16
BURST_REQUESTS = 16                # per configuration
# the batched bodies the default config (K1a) leaves out; the pull paths
# forced (every level pulls, as PATH_RUNS forces it), so that K3 launches
_FORCED_PULL = dict(dirop=True, use_pallas=True, dirop_alpha=1e6,
                    dirop_beta=1e6)
BURST_CONFIGS = {
    "gpubfs": dict(kernel="gpubfs"),
    "legacy": dict(use_pallas=True, pallas_fused=False),
    "legacy+gpubfs": dict(use_pallas=True, pallas_fused=False,
                          kernel="gpubfs"),
    "dirop_pallas": _FORCED_PULL,
    "dirop_pallas+gpubfs": dict(_FORCED_PULL, kernel="gpubfs"),
}
LANE_CHECK_LANES = 16
LANE_CHECK_LEVELS = 40             # levels of the first phase checked


def make_request(i: int) -> tuple:
    """Worker process: request ``i`` of the serving trace, its family
    (round-robin over ``serve_matching.FAMILIES``) at size hint
    ``SERVE_HINTS[i % 3]``, seed ``SERVE_SEED + i``; and its cardinality by
    scipy."""
    use_src()
    from scipy.sparse.csgraph import maximum_bipartite_matching
    from repro_torch.launch.serve_matching import FAMILIES
    names = list(FAMILIES)
    family, hint = names[i % len(names)], SERVE_HINTS[i % len(SERVE_HINTS)]
    g = FAMILIES[family](hint, SERVE_SEED + i)
    m = maximum_bipartite_matching(g.to_scipy().tocsr(), perm_type="column")
    return family, hint, g, int((m >= 0).sum())


def serve_cpu_batch(graphs) -> list:
    """Worker process: the bucket-padded ``graphs`` as one ``run_many`` on
    the CPU with the service's config and warm start; per lane the
    outcome."""
    use_src()
    torch.set_num_threads(2)
    from repro_torch.matching import Matcher, MatcherConfig, TorchCSR
    from repro_torch.serving import Bucketizer, ladder
    bz = Bucketizer(ladder(**SERVE_LADDER), device="cpu")
    out = Matcher(MatcherConfig(), "cheap").run_many(
        TorchCSR.stack([bz.admit(g).graph for g in graphs]))
    return [outcome(s) for s in out.unstack()]


def make_trace(pool) -> list:
    """The serving trace's graphs, made by the workers.  Started when the
    serving phase starts, so that no worker competes with the earlier
    phases' host-clock timings."""
    return pool.map(make_request, range(SERVE_REQUESTS), chunksize=4)


def served_rows(results, trace, singles) -> None:
    """Every served request: a valid matching at scipy's cardinality,
    certified, and the single-graph run's state bit for bit."""
    from repro_torch.core import validate_matching
    for i, res in enumerate(results):
        family, hint, g, want = trace[i]
        cm, rm = res.matching()
        card = validate_matching(g, cm, rm)
        what = f"served request {i} ({family}, hint {hint})"
        if card != want or res.cardinality != want:
            fail(f"{what}: cardinality {card} != scipy's {want}")
        if not res.certified:
            fail(f"{what}: not certified")
        if not same_outcome(outcome(res.state), singles[i]):
            fail(f"{what}: state differs from the card's Matcher.run of "
                 f"the same bucket-padded graph")


def run_loop(svc, graphs, rate=None) -> tuple:
    """All of ``graphs`` through ``svc`` (closed loop: submit all, then
    drain; open loop: Poisson arrivals at ``rate``), the counts set to 0
    just before; returns (results, wall seconds, snapshot, host syncs)."""
    from repro_torch.launch.serve_matching import replay
    from repro_torch.matching.solve import COUNTERS
    syncs0 = COUNTERS.host_syncs
    t0 = time.perf_counter()
    if rate is None:
        futs = [svc.submit(g) for g in graphs]
    else:
        futs = [f for _, _, f in replay(svc, [("", g) for g in graphs],
                                        rate, SERVE_SEED)]
    results = [f.result(timeout=600) for f in futs]
    svc.drain()
    wall = time.perf_counter() - t0
    return (results, wall, svc.metrics.snapshot(),
            COUNTERS.host_syncs - syncs0)


def serving_phase(pool) -> list:
    """Phase 6 (module doc): returns the batched bodies' kernel entries."""
    from repro_torch.kernels.frontier_expand import LAUNCHES, reset_launches
    from repro_torch.launch.serve_matching import chaos_drill
    from repro_torch.matching import (Matcher, MatcherConfig, TorchCSR,
                                      compile_cache_clear,
                                      compile_cache_info)
    from repro_torch.matching.cache import compile_cache_entry, max_bytes
    from repro_torch.matching.solve import COUNTERS
    from repro_torch.serving import (Bucketizer, FaultInjector,
                                     MatchingService, batch_ladder, ladder)

    compile_cache_clear()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    trace = make_trace(pool)
    graphs = [g for _, _, g, _ in trace]
    buckets = ladder(**SERVE_LADDER)
    cfg, ws = MatcherConfig(), "cheap"
    say("serving trace:", json.dumps(dict(
        requests=len(trace), seeds=[SERVE_SEED, SERVE_SEED + len(trace) - 1],
        hints=SERVE_HINTS, families=sorted({f for f, *_ in trace}),
        buckets=[b.key for b in buckets], max_batch=SERVE_MAX_BATCH,
        max_delay_ms=SERVE_DELAY_MS, edges=sum(g.nnz for g in graphs),
        graphs_s=time.perf_counter() - t0)))

    def service(**kw):
        return MatchingService(
            bucketizer=Bucketizer(buckets, validate=True), config=cfg,
            warm_start=ws, max_batch=SERVE_MAX_BATCH,
            max_delay_ms=SERVE_DELAY_MS, **kw)

    def held():
        """The cache's bytes and evictions, and the graphs its entries
        captured so far."""
        info = compile_cache_info()
        return dict(cache_bytes=info["bytes"], evictions=info["evictions"],
                    captures=sum(compile_cache_entry(k).captures(CARD)
                                 for k in info["keys"]))

    # 1. warm-up: every step of the grid's entries captured, their bytes
    # measured after
    svc = service()
    ev0 = compile_cache_info()["evictions"]
    report = svc.warm_up()
    warmed = held()
    warm = dict(cells=report.cells, compiled=report.compiled,
                seconds=report.seconds, entry_bytes=report.entry_bytes,
                budget_bytes=max_bytes(), **warmed,
                batch_ladder=batch_ladder(SERVE_MAX_BATCH))
    say("serving warm-up:", json.dumps(warm))
    if warmed["evictions"] != ev0 or report.compiled != report.cells \
            or not warmed["captures"]:
        fail(f"warm-up evicted {warmed['evictions'] - ev0} entries, built "
             f"{report.compiled} of {report.cells} or captured "
             f"{warmed['captures']} graphs")

    # 2.-4. the serving main path, the counts set to 0 just before
    torch.cuda.synchronize()
    reset_launches()
    closed, closed_s, snap1, syncs1 = run_loop(svc, graphs)
    svc.close()
    rate = SERVE_RATE_FRACTION * len(graphs) / closed_s
    svc = service()
    opened, open_s, snap2, syncs2 = run_loop(svc, graphs, rate)
    svc.close()
    # the loops ran on the warmed entries alone: nothing captured, nothing
    # evicted, the bytes as warm-up left them
    looped = held()
    if looped != warmed:
        fail(f"the loops after warm-up changed the cache: {warmed} -> "
             f"{looped}")
    burst_graphs = [g for _, h, g, _ in trace if h == BURST_HINT]
    burst_graphs = burst_graphs[:BURST_REQUESTS]
    svc = service()
    burst = {}
    for name, kw in BURST_CONFIGS.items():
        bcfg = dataclasses.replace(cfg, **kw)
        futs = [svc.submit(g, config=bcfg) for g in burst_graphs]
        burst[name] = (bcfg, [f.result(timeout=600) for f in futs])
    svc.drain()
    snap3 = svc.metrics.snapshot()
    svc.close()
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    loop = lambda snap, wall, syncs: dict(              # noqa: E731
        wall_s=wall, graphs_per_s=len(graphs) / wall,
        latency_p50_ms=snap["latency_p50_ms"],
        latency_p99_ms=snap["latency_p99_ms"],
        queue_wait_p50_ms=snap["queue_wait_p50_ms"],
        occupancy=snap["occupancy"], dispatches=snap["dispatches"],
        requests=snap["submitted"], host_syncs=syncs,
        host_syncs_per_flush=syncs / max(1, snap["dispatches"]),
        compile_hits=snap["compile_hits"],
        compile_misses=snap["compile_misses"],
        pad_edge_waste=snap["pad_edge_waste"],
        flushes=[snap["flushes_full"], snap["flushes_deadline"],
                 snap["flushes_drain"]])
    rows = dict(closed_loop=loop(snap1, closed_s, syncs1),
                open_loop=dict(loop(snap2, open_s, syncs2),
                               offered_rate=rate),
                burst=dict(dispatches=snap3["dispatches"],
                           requests=snap3["submitted"]),
                cache_after_loops=looped, launches=launches)
    say("serving main path:", json.dumps(rows))
    if snap2["compile_misses"] or snap1["compile_misses"]:
        fail(f"the warmed service missed the cache "
             f"({snap1['compile_misses']} closed, "
             f"{snap2['compile_misses']} open loop)")
    for body in KERNELS:
        if not launches[f"{body}_batched"]:
            fail(f"{body}_batched was not launched by the serving path")

    # every served request against scipy and the card's single-graph run
    t1 = time.perf_counter()
    bz = Bucketizer(buckets)
    single = Matcher(cfg, ws)
    singles = [outcome(single.run(bz.admit(g).graph)) for g in graphs]
    served_rows(closed, trace, singles)
    served_rows(opened, trace, singles)
    for name, (bcfg, results) in burst.items():
        m = Matcher(bcfg, ws)
        want = [outcome(m.run(bz.admit(g, csc=bcfg.dirop or None).graph))
                for g in burst_graphs]
        idx = [i for i, (_, h, _, _) in enumerate(trace)
               if h == BURST_HINT][:BURST_REQUESTS]
        served_rows(results, [trace[i] for i in idx], want)
    # one batch of the 2^14 bucket: the card's run_many against the CPU's
    small = [g for _, h, g, _ in trace if h == SERVE_HINTS[0]]
    small = small[:SERVE_MAX_BATCH]
    cpu_pending = pool.apply_async(serve_cpu_batch, (small,))
    card = single.run_many(TorchCSR.stack([bz.admit(g).graph
                                           for g in small]))
    for i, (a, b) in enumerate(zip([outcome(s) for s in card.unstack()],
                                   cpu_pending.get())):
        if not same_outcome(a, b):
            fail(f"lane {i} of the 2^14 batch differs from the CPU's "
                 f"run_many")
    say(f"serving checks: {len(closed) + len(opened)} loop requests and "
        f"{sum(len(r) for _, r in burst.values())} burst requests valid, at "
        f"scipy's cardinality, certified and equal to the single-graph "
        f"run; the {len(small)}-lane 2^14 batch equals the CPU's run_many "
        f"({time.perf_counter() - t1:.1f} s)")

    # 5. the chaos drill
    injector = FaultInjector(seed=SERVE_SEED)
    svc = service(faults=injector)
    failures = chaos_drill(svc, injector, SERVE_HINTS[0], SERVE_SEED)
    svc.close()
    if failures:
        fail(f"the chaos drill found {failures} violations")
    compile_cache_clear()
    torch.cuda.empty_cache()
    phase("serving", t0)

    t0 = time.perf_counter()
    lane = [g for _, h, g, _ in trace if h == SERVE_HINTS[-1]]
    entries = lane_checks(bz, lane[:LANE_CHECK_LANES], launches)
    phase("batched kernel checks", t0)
    return entries


def lane_checks(bz, graphs, launches) -> list:
    """Each kernel body with its lane dimension over the first BFS phase of
    a batch of ``graphs`` (module doc): the lanes start at staggered
    levels and leave as their BFS ends (gated off); one launch against the
    plain version and the single-graph launch of each lane, bit for bit;
    times and bounds.  Returns the batched entries of the kernels line."""
    from repro_torch.kernels.frontier_expand import (
        frontier_bits, frontier_bits_ref, frontier_expand,
        frontier_expand_fused, frontier_expand_fused_ref,
        frontier_expand_pull, frontier_expand_pull_ref, frontier_expand_ref)
    from repro_torch.matching import Matcher, MatcherConfig, TorchCSR
    from repro_torch.matching.solve import _apply_winner, level0_state

    b = TorchCSR.stack([bz.admit(g, csc=True).graph for g in graphs])
    nb, nr = b.batch_shape[0], b.nr
    warm = [Matcher(MatcherConfig(), "cheap").init(ln) for ln in b.unstack()]
    cm = torch.stack([w.cmatch for w in warm])
    rm = torch.stack([w.rmatch for w in warm])
    bfs, root = level0_state(cm)
    pred = torch.full_like(rm, b.nc)
    level = torch.full((nb,), 2, dtype=torch.int32, device=CARD)
    delay = torch.arange(nb, device=CARD) % 3
    alive = torch.ones(nb, dtype=torch.bool, device=CARD)
    bodies = {
        "frontier_expand_fused": (frontier_expand_fused,
                                  frontier_expand_fused_ref, "push"),
        "frontier_expand": (frontier_expand, frontier_expand_ref, "prop"),
        "frontier_expand_pull": (frontier_expand_pull,
                                 frontier_expand_pull_ref, "pull"),
        "frontier_bits": (frontier_bits, frontier_bits_ref, "bits")}
    states = []
    for step in range(LANE_CHECK_LEVELS):
        gate = (alive & (delay <= step)).to(torch.int32)
        if not bool(gate.any()):
            break
        lv = level.clone()
        st = (bfs.clone(), root.clone(), rm.clone(), lv, gate.clone())
        for name, (kernel, plain, kind) in bodies.items():
            for wr in (True, False):
                args = lane_args(b, st, kind, wr)
                got = kernel(*args)
                if not torch.equal(got, plain(*args)):
                    fail(f"{name} ({'WR' if wr else 'plain'}) with {nb} "
                         f"lanes differs from its plain version at step "
                         f"{step}")
                for i in range(nb):
                    one = kernel(*[a[i] if isinstance(a, torch.Tensor)
                                   else a for a in args])
                    if not torch.equal(got[i], one):
                        fail(f"{name} lane {i} differs from its single "
                             f"launch at step {step}")
        states.append(st)
        win = frontier_expand_fused(b.ecol, b.cadj, bfs, root, rm, lv, gate)
        live = gate != 0
        *_, ins, _ = _apply_winner(win, bfs, root, pred, rm, level,
                                   wr=True, wr_exact=False, inplace=True)
        level += live
        alive &= ~live | ins
    say(f"batched kernels: {len(states)} steps of {nb} lanes bit for bit "
        f"against the plain version and the single launches")
    entries = []
    for name, (kernel, plain, kind) in bodies.items():
        for wr in (True, False):
            body = f"{name}_{'wr' if wr else 'plain'}"
            per = [lane_args(b, st, kind, wr) for st in states]
            n = len(per)
            ms = cuda_ms(lambda: [kernel(*a) for a in per]) / n
            singles_ms = cuda_ms(lambda: [
                kernel(*[x[i] if isinstance(x, torch.Tensor) else x
                         for x in a]) for a in per for i in range(nb)],
                reps=5, warmup=1) / n
            plain_ms = cuda_ms(lambda: [plain(*a) for a in per], reps=3,
                               warmup=1) / n
            bound = sum(lane_bound(kind, a, nr) for a in per) / n
            entries.append(dict(
                name=f"{body}_batched", route="cuda",
                source="src/repro_torch/csrc/frontier_expand.cu",
                replaces=KERNELS[body],
                launches=launches[f"{body}_batched"],
                max_abs_err=0, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes", library_ms=None, lanes=nb,
                singles_ms=singles_ms, levels_checked=n,
                timed_on=f"{nb} lanes of the {b.nc}^2 bucket"))
            say("batched kernel:", json.dumps(entries[-1]))
    return entries


def lane_args(b, st, kind: str, wr: bool) -> tuple:
    """A batched kernel's arguments for one checked step."""
    bfs, root, rm, level, gate = st
    rt = root if wr else None
    if kind == "bits":
        return (bfs, rt, level)
    cols, rows = (b.radj, b.erow) if kind == "pull" else (b.ecol, b.cadj)
    return (cols, rows, bfs, rt, rm, level, gate)


def lane_bound(kind: str, args: tuple, nr: int) -> float:
    """Least time for one batched launch: each lane that runs moves its
    single-graph bytes, a gated-off lane only writes its output."""
    nbytes = 0
    for i in range(args[2 if kind != "bits" else 0].shape[0]):
        one = [a[i] if isinstance(a, torch.Tensor) else a for a in args]
        if kind == "bits":
            one[-1] = int(one[-1])
            nbytes += bits_bytes(*one)
            continue
        on, one = int(one[-1]), one[:-2] + [int(one[-2])]
        if kind == "push":
            nbytes += push_bytes(*one) if on else 4 * (nr + 1)
        elif kind == "prop":
            nbytes += (proposal_bytes(*one) if on
                       else 4 * one[0].numel())
        else:
            nbytes += pull_bytes(*one) if on else 4 * (nr + 1)
    return bound_ms(nbytes)


# ---------------------------------------------------------------------------
# the LM serving path: granite-20b, prefill + decode, flash attention (K4)
# ---------------------------------------------------------------------------
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16 tensor cores
FP32_FLOPS_PER_S = 67e12           # H100 SXM fp32 on the CUDA cores
CARD = "cuda"
LM_ARCH = "granite-20b"
LM_SEED = 0
PREFILL_BATCH, PREFILL_SEQ = 4, 4096
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 64, 16
# the two-layer full-width fp32 checks: batch, sequence
FP32_BATCH, FP32_SEQ = 2, 64
# (B, S, H, KV, hd) of tests/test_kernels.py, then granite-20b's layer
FA_SHAPES = [(2, 512, 4, 2, 64), (1, 1024, 8, 8, 128), (2, 256, 4, 1, 64),
             (1, 512, 6, 2, 128), (2, 256, 4, 4, 32)]
FA_GRANITE = (PREFILL_BATCH, PREFILL_SEQ, 48, 1, 128)
# the kernel tolerances of tests/test_kernels.py (rtol = atol)
FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# the body each dtype must launch (the port's routing table)
FA_BODY = {torch.float32: "flash_attention_simt",
           torch.bfloat16: "flash_attention_tc"}
# At granite's shape the output is a softmax average over thousands of keys,
# of typical magnitude ~sqrt(e / S), about as large as the elementwise 2e-2
# floor.  There K4 is also held to |got - want| / |want| in three norms,
# each gated between the kernel's reading and a control's.  The l2 norm
# over the whole output and the max norm face the plain version with one
# key tile (keys FA_DROP, one K4 tile in the middle) masked for every
# query, which is what a kernel that skips that tile returns.  The worst
# query row's l2 ratio faces the same tile masked for one 128-row query
# tile only (FA_DROP_ROWS): a fault confined to a few rows, which the
# whole-output norms hardly see, and the kind a wrong swizzle or diagonal
# mask in one tile makes.  Readings on an H100 (bf16, seed LM_SEED; causal
# / full): kernel l2 0.0043 / 0.0050, max 0.0050 / 0.0163, row 0.018 /
# 0.019; control l2 0.066 / 0.177, max 0.074 / 0.483; one-query-tile
# control row 0.90 / 0.79 (its whole-output l2 0.022 / 0.031).  The script
# fails if a control does not exceed its gate.
FA_REL_TOL = {"l2": 1.5e-2, "max": 3e-2, "row": 5e-2}
K4_TILE = 128                      # keys per tile of flash_fwd_tc<128>
FA_DROP = (PREFILL_SEQ // 2, PREFILL_SEQ // 2 + K4_TILE)
FA_DROP_ROWS = (FA_DROP[1], FA_DROP[1] + 128)     # sees FA_DROP either way
K4_REPLACES = "src/repro/kernels/flash_attention/flash_attention.py:29"
# Gate of the 52-layer bf16 prefill, pallas against xla: max |d| / max |ref|
# of the last-position logits.  Both run bf16 end to end and differ only in
# where the attention rounds (the kernel rounds p to bf16 and keeps its
# accumulator in fp32; blockwise_attn, as the JAX package's, rounds p and
# the accumulator to bf16), a perturbation of a few bf16 ulps (2^-8) per layer that the
# residual stream carries through 52 layers.  The gate lies between that
# reading and the same reading of a control prefill whose attention output
# is zero in one layer (skip_attention).  Readings on an H100: pallas
# 0.0112 (argmax 4/4), the control 0.20 (argmax 2/4).  A fault as small as
# one dropped key tile stays under this gate; the kernel's scaled check
# above is the one that sees it.  The script fails if the control does not
# exceed the gate.  The model path is also held at 1e-3 in fp32
# (fp32_checks).
LOGIT_GAP_TOL = 5e-2


def fa_flops(B, S, H, hd, causal: bool) -> int:
    """Flops of one attention call: q.k and p.v, 2 hd each per (query,
    key) pair the mask keeps."""
    pairs = S * (S + 1) // 2 if causal else S * S
    return 4 * B * H * hd * pairs


def fa_bytes(B, S, H, KV, hd, itemsize) -> int:
    """q, k and v read once, out written once."""
    return itemsize * hd * B * S * (2 * H + 2 * KV)


def fa_inputs(shape, dtype, gen):
    B, S, H, KV, hd = shape
    return [torch.randn(s, generator=gen, device=CARD).to(dtype)
            for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]


def fa_plain(q, k, v, causal):
    """The plain version one batch element at a time (its fp32 scores are
    12.9 GB at granite's shape for the whole batch)."""
    from repro_torch.kernels.flash_attention import flash_attention_ref
    return torch.cat([flash_attention_ref(q[i:i + 1], k[i:i + 1],
                                          v[i:i + 1], causal=causal)
                      for i in range(q.shape[0])])


def close(name, got, want, tol) -> float:
    """Fail unless ``got`` is finite and within rtol = atol = ``tol`` of
    ``want``; returns the largest absolute difference."""
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = int((err > tol + tol * want.abs()).sum())
    say(f"{name}: max |d| {float(err.max()):.3e}, {bad} outside "
        f"rtol = atol = {tol}")
    if bad or not torch.isfinite(got).all():
        fail(f"{name}: {bad} values outside rtol = atol = {tol}")
    return float(err.max())


def rel_gaps(got, want) -> dict:
    """|got - want| / |want| in the l2 norm over all values, in the max
    norm, and per query row (the worst row's l2 ratio over its hd
    values)."""
    d, w = (got.float() - want.float()), want.float()
    rows = d.norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)
    return {"l2": float(d.norm() / w.norm()),
            "max": float(d.abs().max() / w.abs().max()),
            "row": float(rows.max())}


def fa_tile_dropped(q, k, v, causal, lo, hi, rows=(0, None)):
    """Control: the plain version with keys [lo, hi) masked for the queries
    ``rows`` (all by default), one batch element at a time."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    keep = torch.ones(S, k.shape[1], dtype=torch.bool, device=q.device)
    keep = keep.tril() if causal else keep
    keep[rows[0]:rows[1], lo:hi] = False
    out = []
    for i in range(B):
        qg = q[i:i + 1].reshape(1, S, KV, H // KV, hd)
        s = torch.einsum("bskgh,btkh->bkgst", qg, k[i:i + 1]).float()
        s = (s * hd ** -0.5).masked_fill_(~keep, -1e30)
        p = torch.softmax(s, dim=-1).to(q.dtype)
        del s
        out.append(torch.einsum("bkgst,btkh->bskgh", p, v[i:i + 1])
                   .reshape(1, S, H, hd))
    return torch.cat(out)


def scaled_check(name, got, want, control, row_control) -> None:
    """Fail unless ``got`` is within FA_REL_TOL of ``want`` in every norm of
    ``rel_gaps`` and each control is outside its gate: ``control`` (the key
    tile dropped for every query) in the l2 and max norms, ``row_control``
    (dropped for one query tile) in the per-row norm."""
    mine = rel_gaps(got, want)
    ctrl, ctrl_rows = rel_gaps(control, want), rel_gaps(row_control, want)
    seen = {"l2": ctrl["l2"], "max": ctrl["max"], "row": ctrl_rows["row"]}
    say("flash scaled check:", json.dumps(dict(
        check=name, rel_gap=mine, control_rel_gap=ctrl,
        row_control_rel_gap=ctrl_rows, tolerance=FA_REL_TOL)))
    for norm, tol in FA_REL_TOL.items():
        if not mine[norm] <= tol:
            fail(f"{name}: |d| / |ref| in the {norm} norm {mine[norm]} > "
                 f"{tol}")
        what = (f"keys {FA_DROP} dropped" + (
            f" for queries {FA_DROP_ROWS}" if norm == "row" else ""))
        if not seen[norm] > tol:
            fail(f"{name}: the control ({what}) reads {seen[norm]} in the "
                 f"{norm} norm, within the gate {tol}: the gate would not "
                 f"see that fault")


def flash_checks() -> dict:
    """K4 against its plain version on the card at every checked shape and
    both masks, and at granite's layer shape also in scaled norms against
    a control; times at granite's layer shape.  Runs before the weights
    exist.  Returns the kernel's entry, without ``launches``."""
    from repro_torch.kernels.flash_attention import (LAUNCHES,
                                                     flash_attention)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("flash attention checks: TF32 off (torch.backends.cuda.matmul."
        "allow_tf32 = False); tolerance rtol = atol = 2e-5 fp32, 2e-2 bf16")
    gen = torch.Generator(device=CARD).manual_seed(LM_SEED)
    worst = 0.0
    cases = [(s, dt) for s in FA_SHAPES for dt in FA_TOL]
    cases.append((FA_GRANITE, torch.bfloat16))
    for shape, dtype in cases:
        q, k, v = fa_inputs(shape, dtype, gen)
        for causal in (True, False):
            what = f"flash vs plain, {shape} {str(dtype)[6:]} causal={causal}"
            before = LAUNCHES[FA_BODY[dtype]]
            got = flash_attention(q, k, v, causal=causal)
            if LAUNCHES[FA_BODY[dtype]] != before + 1:
                fail(f"{what}: not launched on {FA_BODY[dtype]}")
            want = fa_plain(q, k, v, causal)
            worst = max(worst, close(what, got, want, FA_TOL[dtype]))
            if shape == FA_GRANITE:
                scaled_check(what, got, want,
                             fa_tile_dropped(q, k, v, causal, *FA_DROP),
                             fa_tile_dropped(q, k, v, causal, *FA_DROP,
                                             rows=FA_DROP_ROWS))
            del got, want
        torch.cuda.empty_cache()
    # q, k, v are granite's now
    B, S, H, KV, hd = FA_GRANITE
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2)
    lib_err = float((lib.float() - fa_plain(q, k, v, True).float())
                    .abs().max())
    times = {}
    for causal in (True, False):
        times[causal] = dict(
            ms=cuda_ms(lambda: flash_attention(q, k, v, causal=causal),
                       reps=10),
            plain_ms=cuda_ms(lambda: fa_plain(q, k, v, causal), reps=2,
                             warmup=1),
            library_ms=cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=causal,
                                            enable_gqa=True), reps=10))
        times[causal]["tflops"] = (fa_flops(B, S, H, hd, causal)
                                   / times[causal]["ms"] / 1e9)
    flops = fa_flops(B, S, H, hd, True)
    nbytes = fa_bytes(B, S, H, KV, hd, 2)
    bound = max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    row = dict(shape=FA_GRANITE, dtype="bfloat16", flops_causal=flops,
               bytes=nbytes, bound_ms_causal=bound,
               bound_ms_full=max(fa_flops(B, S, H, hd, False)
                                 / BF16_FLOPS_PER_S,
                                 nbytes / HBM_BYTES_PER_S) * 1e3,
               causal=times[True], full=times[False],
               sdpa_vs_plain_max_abs_err=lib_err)
    say("flash attention at granite's layer shape:", json.dumps(row))
    del q, k, v, qt, kt, vt, lib
    torch.cuda.empty_cache()
    fp32 = fp32_granite(gen)
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces=K4_REPLACES, launches=0, max_abs_err=worst,
                ms=times[True]["ms"], plain_ms=times[True]["plain_ms"],
                bound_ms=bound,
                bound_by=("operations" if flops / BF16_FLOPS_PER_S
                          >= nbytes / HBM_BYTES_PER_S else "bytes"),
                library_ms=times[True]["library_ms"],
                body="flash_fwd_tc<128>", tflops=times[True]["tflops"],
                timed_on=f"B={B} S={S} H={H} KV={KV} hd={hd} bf16 causal",
                fp32=fp32)


def fp32_granite(gen) -> dict:
    """K4's fp32 body (``flash_fwd_simt``, CUDA cores) at granite's layer
    shape, both masks, TF32 off: against its plain version (2e-5), then
    timed beside the plain version and ``scaled_dot_product_attention`` in
    fp32.  Its bound: flops over the fp32 peak of the CUDA cores, or bytes
    over HBM bandwidth, whichever is larger."""
    from repro_torch.kernels.flash_attention import (LAUNCHES,
                                                     flash_attention)

    B, S, H, KV, hd = FA_GRANITE
    q, k, v = fa_inputs(FA_GRANITE, torch.float32, gen)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    nbytes = fa_bytes(B, S, H, KV, hd, 4)
    out = dict(body="flash_fwd_simt<128>", shape=FA_GRANITE, dtype="float32",
               tf32=torch.backends.cuda.matmul.allow_tf32)
    for causal in (True, False):
        what = f"flash vs plain, {FA_GRANITE} float32 causal={causal}"
        before = LAUNCHES["flash_attention_simt"]
        got = flash_attention(q, k, v, causal=causal)
        if LAUNCHES["flash_attention_simt"] != before + 1:
            fail(f"{what}: not launched on flash_attention_simt")
        err = close(what, got, fa_plain(q, k, v, causal),
                    FA_TOL[torch.float32])
        del got
        flops = fa_flops(B, S, H, hd, causal)
        ms = cuda_ms(lambda: flash_attention(q, k, v, causal=causal), reps=5)
        out["causal" if causal else "full"] = dict(
            ms=ms, tflops=flops / ms / 1e9, max_abs_err=err,
            plain_ms=cuda_ms(lambda: fa_plain(q, k, v, causal), reps=2,
                             warmup=1),
            library_ms=cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=causal,
                                            enable_gqa=True), reps=5),
            bound_ms=max(flops / FP32_FLOPS_PER_S,
                         nbytes / HBM_BYTES_PER_S) * 1e3,
            bound_by=("operations" if flops / FP32_FLOPS_PER_S
                      >= nbytes / HBM_BYTES_PER_S else "bytes"))
        torch.cuda.empty_cache()
    say("flash attention fp32 at granite's layer shape:", json.dumps(out))
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return out


def fp32_checks() -> None:
    """granite-20b at full width, two layers, fp32 on the card: forward
    with the kernel against forward with the torch-op attention (last
    position, 1e-3), and teacher-forced decode against forward (2e-3, the
    JAX package's test_decode_matches_forward tolerance)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import LAUNCHES, reset_launches
    from repro_torch.models import build_model

    cfg = get_config(LM_ARCH, n_layers=2, dtype="float32",
                     attn_impl="pallas")
    pallas = build_model(cfg)
    xla = build_model(dataclasses.replace(cfg, attn_impl="xla"))
    params = pallas.init(LM_SEED)
    gen = torch.Generator(device=CARD).manual_seed(LM_SEED + 1)
    toks = torch.randint(0, cfg.vocab, (FP32_BATCH, FP32_SEQ), generator=gen,
                         device=CARD)
    reset_launches()
    full, _ = pallas.forward(params, {"tokens": toks})
    torch.cuda.synchronize()
    say("fp32 2-layer forward, flash launches:", json.dumps(LAUNCHES))
    if LAUNCHES["flash_attention_simt"] != cfg.n_layers or \
            LAUNCHES["flash_attention"] != cfg.n_layers:
        fail(f"fp32 forward launched the flash kernel {dict(LAUNCHES)}, not "
             f"{cfg.n_layers} times on the CUDA-core body")
    ref, _ = xla.forward(params, {"tokens": toks})
    close("fp32 2-layer forward, pallas vs xla (last position)",
          full[:, -1], ref[:, -1], 1e-3)
    cache = pallas.init_cache(FP32_BATCH, FP32_SEQ)
    outs = []
    for t in range(FP32_SEQ):
        lg, cache = pallas.decode_step(params, cache, toks[:, t:t + 1], t)
        outs.append(lg[:, 0])
    close(f"fp32 2-layer teacher-forced decode ({FP32_SEQ} steps) vs "
          f"forward", torch.stack(outs, 1), full, 2e-3)
    del params, cache, full, ref, outs
    torch.cuda.empty_cache()


def skip_attention(layer: int):
    """A faulty flash kernel, for a control: its call for ``layer``
    (counted from 0) returns zeros, every other call the kernel's output."""
    from repro_torch.kernels.flash_attention import flash_attention
    calls = []

    def fault(q, k, v, *, causal=True):
        calls.append(None)
        out = flash_attention(q, k, v, causal=causal)
        return torch.zeros_like(out) if len(calls) == layer + 1 else out
    return fault


def with_attention(fault, fn):
    """``fn()`` with ``fault`` in place of the flash kernel in the model."""
    from repro_torch.models import attention as att
    real, att.flash_attention = att.flash_attention, fault
    try:
        return fn()
    finally:
        att.flash_attention = real


def timed(fn):
    """(result, wall seconds, peak device bytes) of ``fn()``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def lm_main_path() -> int:
    """granite-20b FULL, bf16, 52 layers, seeded weights: the serving
    prefill through the flash kernel (counts set to 0 just before, read
    just after), the same prefill through the torch-op attention, and
    greedy serving.  Returns the kernel's launches in the prefill."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeCell, make_inputs
    from repro_torch.kernels.flash_attention import LAUNCHES, reset_launches
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model
    from repro_torch.train import build_prefill_step

    cfg = get_config(LM_ARCH, attn_impl="pallas")
    model = build_model(cfg)
    params, init_s, _ = timed(lambda: model.init(LM_SEED))
    say(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.params_count():,} parameters (analytic), "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card, "
        f"initialised in {init_s:.1f} s")
    batch = make_inputs(cfg, ShapeCell("prefill", PREFILL_SEQ, PREFILL_BATCH,
                                       "prefill"), seed=LM_SEED)
    prefill = build_prefill_step(model)
    prefill(params, {"tokens": batch["tokens"][:1, :128]})   # warm-up
    reset_launches()
    logits, wall, peak = timed(lambda: prefill(params, batch))
    launches, by_body = LAUNCHES["flash_attention"], dict(LAUNCHES)
    tokens = PREFILL_BATCH * PREFILL_SEQ
    say("lm main path:", json.dumps(dict(
        run="prefill", attn_impl="pallas", batch=PREFILL_BATCH,
        seq=PREFILL_SEQ, wall_s=wall, prefill_tokens_per_s=tokens / wall,
        peak_memory_bytes=peak, flash_launches=by_body)))
    if launches != cfg.n_layers or \
            by_body["flash_attention_tc"] != cfg.n_layers:
        fail(f"prefill launched the flash kernel {by_body}, not "
             f"{cfg.n_layers} times on the tensor-core body")
    if logits.shape != (PREFILL_BATCH, 1, cfg.vocab) or \
            not torch.isfinite(logits.float()).all():
        fail(f"prefill logits {tuple(logits.shape)} not finite or not of "
             f"shape ({PREFILL_BATCH}, 1, {cfg.vocab})")

    xla = build_prefill_step(build_model(
        dataclasses.replace(cfg, attn_impl="xla")))
    ref, wall_x, peak_x = timed(lambda: xla(params, batch))
    got, want = logits[:, 0].float(), ref[:, 0].float()
    gap = float((got - want).abs().max() / want.abs().max())
    agree = int((got.argmax(-1) == want.argmax(-1)).sum())
    say("lm main path:", json.dumps(dict(
        run="prefill", attn_impl="xla (blockwise_attn)", wall_s=wall_x,
        prefill_tokens_per_s=tokens / wall_x, peak_memory_bytes=peak_x,
        pallas_vs_xla_rel_gap=gap, tolerance=LOGIT_GAP_TOL,
        argmax_agree=f"{agree}/{PREFILL_BATCH}")))
    if not gap <= LOGIT_GAP_TOL:
        fail(f"prefill logits, pallas vs xla: max |d| / max |ref| = {gap} "
             f"> {LOGIT_GAP_TOL}")
    skipped = cfg.n_layers // 2
    control, wall_c, _ = timed(lambda: with_attention(
        skip_attention(skipped), lambda: prefill(params, batch)))
    ctrl = control[:, 0].float()
    ctrl_gap = float((ctrl - want).abs().max() / want.abs().max())
    say("lm main path:", json.dumps(dict(
        run="prefill, control", fault=f"attention of layer {skipped} zero",
        wall_s=wall_c, control_vs_xla_rel_gap=ctrl_gap,
        tolerance=LOGIT_GAP_TOL,
        argmax_agree=f"{int((ctrl.argmax(-1) == want.argmax(-1)).sum())}"
                     f"/{PREFILL_BATCH}")))
    if not ctrl_gap > LOGIT_GAP_TOL:
        fail(f"the control prefill reads {ctrl_gap}, within the gate "
             f"{LOGIT_GAP_TOL}: the gate would not see that fault")
    del logits, ref, control

    prompt = make_inputs(cfg, ShapeCell("serve", SERVE_PROMPT, SERVE_BATCH,
                                        "prefill"), seed=LM_SEED)["tokens"]
    (out, t), wall_s, peak_s = timed(
        lambda: generate(model, params, prompt, SERVE_GEN))
    say("lm main path:", json.dumps(dict(
        run="serve (prefill by stepping, greedy decode)", batch=SERVE_BATCH,
        prompt=SERVE_PROMPT, generated=SERVE_GEN, wall_s=wall_s,
        prompt_ms_per_step=t["prompt_s"] / t["prompt_steps"] * 1e3,
        decode_ms_per_step=t["gen_s"] / t["gen_steps"] * 1e3,
        peak_memory_bytes=peak_s, first_tokens=out[:, :4].tolist())))
    if out.shape != (SERVE_BATCH, SERVE_GEN) or int(out.min()) < 0 or \
            int(out.max()) >= cfg.vocab:
        fail(f"serving gave tokens of shape {tuple(out.shape)} outside "
             f"[0, {cfg.vocab})")

    # where the time goes: the prefill and eight serve steps, profiled
    say("profile:", json.dumps(dict(run="prefill, pallas", **device_profile(
        lambda: prefill(params, batch), {"flash": "flash_fwd"}))))
    say("profile:", json.dumps(dict(
        run="serve, 4 prompt + 4 decode steps", **device_profile(
            lambda: generate(model, params, prompt[:, :4], 5), {}))))
    del params, batch
    torch.cuda.empty_cache()
    return launches


def lm_phases() -> dict:
    """Phases 7-9: K4 against its plain version, the fp32 two-layer checks,
    the granite-20b main path.  Returns the kernel's entry."""
    t0 = time.perf_counter()
    entry = flash_checks()
    phase("flash attention checks", t0)
    t0 = time.perf_counter()
    fp32_checks()
    phase("fp32 two-layer checks", t0)
    t0 = time.perf_counter()
    entry["launches"] = lm_main_path()
    phase("lm main path", t0)
    return entry


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
    from repro_torch.matching import SOLVE_PATHS

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    say(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}")
    say("torch", torch.__version__, "cuda", torch.version.cuda, "device",
        torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    sources = ["frontier_expand", "graph_loop", "flash_attention"]
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as ex:
        libs = dict(zip(sources, ex.map(load_library, sources)))
    say(f"kernel builds (one nvcc per source, in parallel): "
        f"{time.perf_counter() - t0:.2f} s")
    for name, lib in libs.items():
        report = ptxas_report(lib.build_log)
        say(f"  {name}.cu: nvcc {lib.build_seconds:.2f} s, "
            f"{json.dumps(report)}")
        spilled = {k: v for k, v in report.items()
                   if k.startswith("flash_fwd_tc") and v["spill_bytes"]}
        if spilled:
            fail(f"tensor-core flash bodies spill registers: {spilled}")

    # graphs and the CPU half of the small-set check, in worker processes;
    # terminated on the way out whatever happens
    pool = multiprocessing.get_context("spawn").Pool(2 * len(MAIN_PATH) + 1)
    try:
        kernels = run_phases(pool, list(SOLVE_PATHS))
    finally:
        pool.terminate()
        pool.join()
    torch.cuda.empty_cache()
    kernels.append(lm_phases())

    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_phases(pool, paths) -> list:
    """The matching paths (phases 2-6); returns their kernels' entries."""
    from repro_torch.matching import compile_cache_clear
    t0 = time.perf_counter()
    pending_graphs, cpu_main, cpu_small = start_workers(pool, paths)
    graphs = [(g, want) for g, want, *_ in collect_graphs(pending_graphs)]
    phase("graphs and scipy cardinalities", t0)

    t0 = time.perf_counter()
    warm_up()
    runs, outcomes = main_path(graphs)
    phase("main path", t0)
    t0 = time.perf_counter()
    checks = kernel_checks(graphs)
    phase("kernel checks", t0)
    t0 = time.perf_counter()
    small_sets_bit_exact(cpu_small)
    compile_cache_clear()
    check_cpu(outcomes, cpu_main)
    del outcomes
    phase("small sets and the main path against the CPU", t0)
    t0 = time.perf_counter()
    for entry, (g, _) in zip(MAIN_PATH, graphs):
        profile_main_path(entry, g)
        compile_cache_clear()
        torch.cuda.empty_cache()
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
            ms_device_level=row["kernel_ms_device_level"],
            bound_ms=row["bound_ms"], bound_by="bytes", library_ms=None,
            timed_on=row["graph"],
            levels_checked=sum(r["levels_checked"] for r in mine),
            **{k: v for k, v in row.items() if k.startswith("device_ms_")}))
    return kernels + serving_phase(pool)


def phase(name: str, t0: float) -> None:
    say(f"phase {name}: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    sys.exit(main())
