"""The service, its warm-up, and the record of every request.

The service is ``MatchingService`` over the ladder of buckets that the
traffic's ``service`` declares, every bucket of it warmed ahead of traffic
(``warm_up``: the whole bucket x batch grid captured), then a pass of the
pool's first graphs through ``submit``.  A request's record: the pool
graph, when it was sent, when ``submit`` returned (its admission:
validation, bucketing and upload run on the caller's thread), when its
future resolved, and the matching, copied to the host.
"""
from __future__ import annotations

import sys
import threading

from bench import graphs, system

WAIT_S = 60.0      # how long past the window's close an answer may come
WARM_PASS = 32     # pool graphs sent through submit in set-up


def setup(ctx) -> None:
    ctx.port_pool = [system.host_graph(g) for g in ctx.pool]
    ctx.svc = system.service(ctx.config, ctx.traffic["service"], ctx.device,
                             **ctx.override)
    print(ctx.svc.warm_up(), file=sys.stderr)
    futs = [ctx.svc.submit(g) for g in ctx.port_pool[:WARM_PASS]]
    for f in futs:
        f.result().matching()
    ctx.order = graphs.permutation(len(ctx.pool), len(ctx.pool), ctx.gen)
    ctx.sync()


class Requests:
    """The window's requests, filled from several threads."""

    FIELDS = ("graph", "sent", "admitted", "done")

    def __init__(self, ctx):
        self.ctx = ctx
        self.lock = threading.Lock()
        self.rows = []

    def new(self, graph: int) -> dict:
        row = dict.fromkeys(self.FIELDS)
        row["graph"] = graph
        with self.lock:
            self.rows.append(row)
        return row

    def settle(self, row: dict, res=None, error=None) -> None:
        """A request's end: its result (the matching is copied to the host
        here) or its error."""
        if res is not None:
            try:
                cm, rm = res.matching()
                self.ctx.answers.append((row["graph"], cm, rm))
            except Exception as e:           # a result that cannot be read
                error = e
        if error is not None:
            self.ctx.fail(f"request for pool graph {row['graph']}: "
                          f"{error!r}")
            row["done"] = None


def counters(svc) -> dict:
    snap = svc.metrics.snapshot()
    return {k: snap[k] for k in ("batch_real", "batch_padded")}


def finish(ctx, reqs: Requests, before: dict) -> None:
    after = counters(ctx.svc)
    ctx.rec["service"] = {k: after[k] - before[k] for k in after}
    ctx.rec["requests"] = reqs.rows
    ctx.attempted = len(reqs.rows)


def close(ctx) -> None:
    ctx.svc.close()
