"""Callers that each wait for their reply before sending again (a closed
loop through the matching service), as a pipeline matching many matrices
keeps the service's batches full.

Each of ``callers`` threads is one caller: it sends a graph through
``submit`` (admission runs on the caller's thread), waits for its future,
copies the matching to the host, and sends the next graph of a seeded
cycle through the pool, until the window closes.  A request counts for the
window if its result came before the close; those still open then finish
and are checked.  The profiler records no range from these threads, so
the loop marks none.
"""
from __future__ import annotations

import itertools
import threading
import time

from bench.loops import served

setup = served.setup
close = served.close


def window(ctx) -> None:
    svc, pool = ctx.svc, ctx.port_pool
    reqs = served.Requests(ctx)
    t_end = ctx.t0 + ctx.seconds
    count = itertools.count()
    take = threading.Lock()
    before = served.counters(svc)

    def caller():
        while time.perf_counter() < t_end:
            with take:
                i = next(count)
            k = ctx.order[i % len(ctx.order)]
            row = reqs.new(k)
            row["sent"] = time.perf_counter()
            try:
                fut = svc.submit(pool[k])
                row["admitted"] = time.perf_counter()
                res = fut.result(timeout=max(
                    0.0, t_end + served.WAIT_S - time.perf_counter()))
                row["done"] = time.perf_counter()
            except Exception as e:
                reqs.settle(row, error=e)
                return
            reqs.settle(row, res=res)

    threads = [threading.Thread(target=caller, name=f"bench-caller-{j}")
               for j in range(int(ctx.traffic["callers"]))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    ctx.rec["window_s"] = ctx.seconds
    served.finish(ctx, reqs, before)
