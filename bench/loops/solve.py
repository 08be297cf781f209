"""One caller matching large graphs back to back (a closed loop).

Each request is the user's whole call: the host graph uploaded
(``TorchCSR.from_host``), matched (``Matcher.run``: the warm start and the
solver), and the matching copied back to the host.  The graphs are the
traffic's pool, taken in a seeded cycle; their edge arrays are padded
alike, so they share one program, which set-up builds and captures.  The
window runs whole cycles: it closes at the end of the first cycle that
ends past ``seconds``, so every graph of the pool weighs alike in every
run, however unequal their costs.
"""
from __future__ import annotations

import time

from bench import graphs, system


def _solve(ctx, m, g):
    """One request; returns the matching and, when tracing, the upload's
    and the run's times (the run's on the device, by CUDA events)."""
    traced = ctx.tracer.enabled
    with ctx.tracer.span("upload"):
        t0 = time.perf_counter()
        dev = system.upload(g, ctx.device)
        if traced:
            ctx.sync()
        up = time.perf_counter() - t0
    with ctx.tracer.span("run"):
        clock = ctx.device_clock() if traced else None
        state = m.run(dev)
        run_s = clock() if traced else None
    with ctx.tracer.span("to_host"):
        t1 = time.perf_counter()
        cm, rm = state.to_host()
        down = time.perf_counter() - t1
    return cm, rm, dict(upload_s=up, run_s=run_s, to_host_s=down)


def setup(ctx) -> None:
    """The pool's graphs share one size bucket, so one program: its first
    solve builds and captures it, the second finds it built."""
    ctx.port_pool = [system.host_graph(g) for g in ctx.pool]
    ctx.matcher = system.matcher(ctx.config, **ctx.override)
    for _ in range(2):
        _solve(ctx, ctx.matcher, ctx.port_pool[0])
    ctx.order = graphs.permutation(len(ctx.pool), len(ctx.pool), ctx.gen)
    ctx.sync()


def window(ctx) -> None:
    m, pool, order = ctx.matcher, ctx.port_pool, ctx.order
    rec = ctx.rec
    rec.update(ends=[], upload_s=[], run_s=[], to_host_s=[],
               host_syncs=[], levels=[])
    i = 0
    t_end = ctx.t0 + ctx.seconds
    now = ctx.t0
    while now < t_end or i % len(order):
        k = order[i % len(order)]
        try:
            cm, rm, times = _solve(ctx, m, pool[k])
        except Exception as e:             # counted, and the run fails
            ctx.fail(f"solve of pool graph {k}: {e!r}")
            break
        now = time.perf_counter()
        rec["ends"].append(now)
        for key, v in times.items():
            rec[key].append(v)
        ctx.answers.append((k, cm, rm))
        if ctx.tracer.enabled:
            with ctx.tracer.span("counts"):
                counts = m.last_counts
            rec["host_syncs"].append(counts["host_syncs"])
            rec["levels"].append(counts["levels"])
        i += 1
    ctx.attempted = i + (1 if ctx.failures else 0)
    rec["window_s"] = now - ctx.t0
