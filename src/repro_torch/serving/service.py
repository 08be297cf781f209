"""``MatchingService``: the online facade over the device-resident matcher.

Request path::

    submit(graph) ── Bucketizer.admit ──► per-(bucket, config, warm-start)
        │            (validate first)     queue in the MicroBatcher
        └─► Future[MatchResult]                 │ full / deadline / drain
                                                ▼
                        flush thread: TorchCSR.stack + ONE
                        Matcher.run_many dispatch per flush,
                        then per-request MatchState slicing

``submit`` is non-blocking and returns a ``concurrent.futures.Future``; a
single background thread owns every device dispatch, so callers never
contend on the card.  A flush is one ``run_many`` entry of the compile
cache: CUDA graphs replayed, each BFS level of the whole batch one launch of
a frontier kernel with a lane dimension.  Flushed batches are padded to the
:func:`batch_ladder` rung with copies of the first graph (inert lanes,
results discarded) so the compile cache sees only the batch shapes the
warm-up declared.

Threads and captures.  Admission uploads each graph on the caller's thread
while the flush thread may be capturing a cold entry.  Captures run in
``"thread_local"`` error mode (:mod:`repro_torch.matching.device_loop`), so
another thread's allocations and copies do not fail them, and the uploads
(``TorchCSR.from_host``, ``with_csc``) and the captures take one lock,
``repro_torch._device.DEVICE_LOCK``, so no upload runs inside a capture.  ``drain()`` flushes everything queued and
blocks until every accepted request resolved; ``close()`` drains and stops
the thread (also via the context-manager protocol).

Fault tolerance (the "failure model & degradation ladder" section of
``docs/architecture.md``):

* **validate** — admission structurally checks every graph
  (``Bucketizer(validate=True)``, on by default for service-built
  bucketizers) so garbage never reaches a kernel;
* **quarantine** — a failed batched dispatch is retried by *bisection*:
  split, re-dispatch the halves with bounded exponential backoff, recurse;
  innocent co-batched requests succeed and the isolated poisoned request
  alone fails with the real error plus a ``repro-serving-quarantine/1``
  artifact (``quarantine_dir``);
* **shed** — ``submit(deadline_s=...)`` requests that expire while queued
  resolve with :class:`DeadlineExceededError` at flush time instead of
  occupying batch lanes, and a bounded admission queue (``max_queue``) sheds
  under overload per ``shed_policy``: ``"reject-newest"`` refuses the
  incoming submit with :class:`QueueFullError` (the backpressure signal),
  ``"reject-oldest"`` admits it and evicts the longest-waiting queued
  request with :class:`SheddedError`;
* **degrade** — a ``MatcherConfig(max_phases=k, degrade_maximal=True)``
  budget makes the solve return a valid *maximal* matching with
  ``MatchResult.certified == False`` when the budget truncates it;
* **restart** — a supervisor watches the flush thread, and on death (a
  crash no ``except Exception`` guard can see) fails the in-flight futures
  with :class:`FlushThreadDiedError`, restarts the thread, and the service
  keeps serving.  :class:`~repro_torch.serving.faults.FaultInjector` drives
  every one of these paths deterministically in tests.

Oversize graphs are rejected (:class:`OversizeGraphError`), unless the
service has a ``mesh``: then the bucketizer admits them whole
(``oversize="shard"``), they wait in a queue of their own, and the flush
thread serves each with one :class:`~repro_torch.matching.ShardedMatcher`
run over the mesh (``route="sharded"``, ``bucket=None``), taking the
oldest of the batched flushes and the sharded requests first.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.csr import BipartiteCSR
from repro_torch.matching import (GraphValidationError, Matcher,
                                  MatcherConfig, MatchState, MatchStats,
                                  ShardedMatcher, TorchCSR)
from repro_torch.matching.cache import compile_cache_thread_info

from .bucketizer import (Admission, Bucketizer, OversizeGraphError,
                         SizeBucket)
from .faults import FaultInjector, FlushThreadDeath
from .metrics import ServiceMetrics
from .scheduler import Flush, MicroBatcher, batch_bucket

QUARANTINE_SCHEMA = "repro-serving-quarantine/1"


class ServiceClosedError(RuntimeError):
    """submit() after close(), or a request stranded by shutdown."""


class QueueFullError(RuntimeError):
    """Backpressure: the bounded admission queue is full and the shed policy
    is ``"reject-newest"`` — the caller should retry later or back off."""

    def __init__(self, depth: int, max_queue: int):
        self.depth, self.max_queue = depth, max_queue
        super().__init__(
            f"admission queue full ({depth}/{max_queue}); backpressure — "
            "retry later (shed_policy='reject-newest')")


class SheddedError(RuntimeError):
    """This queued request was evicted to admit a newer one
    (``shed_policy="reject-oldest"`` under overload)."""


class DeadlineExceededError(TimeoutError):
    """The request's ``deadline_s`` expired before its flush dispatched."""


class FlushThreadDiedError(RuntimeError):
    """The flush thread crashed while this request was in flight; the
    supervisor failed it and restarted the thread (resubmitting is safe)."""


@dataclasses.dataclass(frozen=True)
class MatchResult:
    """One resolved request: the sliced device state + serving accounting."""

    state: MatchState                 # bucket-shaped (padded) matching state
    stats: MatchStats
    bucket: Optional[SizeBucket]      # None on the sharded route
    route: str                        # "bucket" | "sharded"
    nc: int                           # true submitted sizes
    nr: int
    batch_size: int                   # real requests in the flush served with
    queue_wait_s: float
    latency_s: float

    @property
    def cardinality(self) -> int:
        """Matched pairs (host sync; padding vertices are isolated, so this
        equals the true graph's maximum matching cardinality)."""
        return int(self.stats.cardinality)

    @property
    def certified(self) -> bool:
        """True iff the solver proved the matching maximum (Berge); False
        when a ``MatcherConfig.max_phases`` budget truncated the solve —
        the matching is still valid (and maximal under
        ``degrade_maximal=True``), just possibly sub-maximum."""
        return bool(self.stats.certified)

    def matching(self):
        """(cmatch, rmatch) as true-size numpy arrays (bucket padding cut)."""
        cm, rm = self.state.to_host()
        return cm[: self.nc], rm[: self.nr]


@dataclasses.dataclass
class _Request:
    admission: Admission
    config: MatcherConfig
    warm_start: str
    future: Future
    submitted_at: float
    deadline: Optional[float] = None  # absolute perf_counter() time
    tag: Optional[str] = None


class MatchingService:
    """Accepts concurrent matching requests, serves them micro-batched.

    >>> svc = MatchingService(bucketizer=Bucketizer(buckets), max_batch=8)
    >>> svc.warm_up()                        # first dispatch = cache hit
    >>> fut = svc.submit(host_graph)         # non-blocking
    >>> fut.result().cardinality

    Overload/fault knobs (all optional; see the module docstring):
    ``max_queue`` bounds queued-but-undispatched requests; ``shed_policy``
    picks who pays when it overflows; ``dispatch_retries`` /
    ``retry_backoff_s`` tune the bisection retry; ``quarantine_dir`` keeps
    a JSON reproducer per quarantined request; ``faults`` installs a
    :class:`~repro_torch.serving.faults.FaultInjector`; ``supervise`` (default
    on) arms the flush-thread watchdog.  ``device``: where a bucketizer the
    service builds itself uploads (None: the mesh's device where there is
    a mesh, else the CUDA card); a bucketizer passed in brings its own.
    ``mesh`` / ``shard_axis``: the sharded lane for oversize graphs (the
    service's own bucketizer then admits them, ``oversize="shard"``).
    """

    def __init__(self, bucketizer: Optional[Bucketizer] = None,
                 config: MatcherConfig = MatcherConfig(),
                 warm_start: str = "cheap",
                 max_batch: int = 8, max_delay_ms: float = 2.0,
                 mesh=None, shard_axis: str = "data",
                 adaptive: bool = True,
                 metrics: Optional[ServiceMetrics] = None,
                 max_queue: Optional[int] = None,
                 shed_policy: str = "reject-newest",
                 dispatch_retries: int = 1,
                 retry_backoff_s: float = 0.002,
                 quarantine_dir: Optional[str] = None,
                 faults: Optional[FaultInjector] = None,
                 supervise: bool = True,
                 supervisor_interval_s: float = 0.05,
                 device=None):
        if bucketizer is None:
            if device is None and mesh is not None:
                device = mesh.device
            bucketizer = Bucketizer(
                oversize="shard" if mesh is not None else "reject",
                validate=True, device=device)
        assert bucketizer.oversize != "shard" or mesh is not None, \
            "oversize='shard' needs a mesh to shard over"
        assert shed_policy in ("reject-newest", "reject-oldest"), shed_policy
        assert max_queue is None or max_queue >= 1, max_queue
        assert dispatch_retries >= 0 and retry_backoff_s >= 0
        self.bucketizer = bucketizer
        self.config = config
        self.warm_start = warm_start
        self.device = bucketizer.device
        self.mesh = mesh
        self.shard_axis = shard_axis
        self.metrics = metrics if metrics is not None else ServiceMetrics()
        self.max_queue = max_queue
        self.shed_policy = shed_policy
        self.dispatch_retries = dispatch_retries
        self.retry_backoff_s = retry_backoff_s
        self.quarantine_dir = quarantine_dir
        self.faults = faults
        self._batcher = MicroBatcher(max_batch=max_batch,
                                     max_delay_s=max_delay_ms / 1e3,
                                     adaptive=adaptive)
        self._matchers: Dict[Tuple[MatcherConfig, str], Matcher] = {}
        self._sharded: Dict[Tuple[MatcherConfig, str], ShardedMatcher] = {}
        self.matcher()     # validate the default config/warm start eagerly
        self._cond = threading.Condition()
        self._ready: List[Flush] = []
        self._sharded_q: List[_Request] = []
        self._taken: List[_Request] = []   # in flight on the flush thread
        self._stop = False
        self._thread = self._start_flush_thread()
        self._supervisor: Optional[threading.Thread] = None
        if supervise:
            self._supervisor = threading.Thread(
                target=self._supervise, args=(supervisor_interval_s,),
                name="matching-service-supervisor", daemon=True)
            self._supervisor.start()

    def _start_flush_thread(self) -> threading.Thread:
        t = threading.Thread(target=self._loop,
                             name="matching-service-flush", daemon=True)
        t.start()
        return t

    # -- matcher registry (shared with warmup so cache keys line up) ---------
    @property
    def max_batch(self) -> int:
        return self._batcher.max_batch

    @property
    def queue_depth(self) -> int:
        """Queued-but-undispatched requests (the bounded-admission gauge)."""
        with self._cond:
            return self._queue_depth_locked()

    def _queue_depth_locked(self) -> int:
        """Everything accepted but not yet claimed by the flush thread:
        accumulating in the batcher, staged in ready flushes, or waiting in
        the sharded lane.  In-flight (claimed) requests are not queue."""
        return (self._batcher.pending + len(self._sharded_q)
                + sum(len(f.items) for f in self._ready))

    def matcher(self, config: Optional[MatcherConfig] = None,
                warm_start: Optional[str] = None) -> Matcher:
        cfg = config if config is not None else self.config
        ws = warm_start if warm_start is not None else self.warm_start
        if cfg.adaptive_frontier:
            # run_many (the only dispatch path here) refuses this config;
            # surface that in the caller's thread, not on the flush thread
            # after the batching delay (dirop is the batch-safe variant)
            raise ValueError(
                "adaptive_frontier cannot be served (Matcher.run_many "
                "refuses it); use MatcherConfig(dirop=True)")
        key = (cfg, ws)
        m = self._matchers.get(key)
        if m is None:
            m = self._matchers[key] = Matcher(cfg, ws)
        return m

    def warm_up(self, grid=None):
        """Build and capture the declared grid ahead of traffic (see
        :mod:`repro_torch.serving.warmup`)."""
        from .warmup import warm_up
        return warm_up(self, grid)

    # -- request intake -------------------------------------------------------
    def submit(self, graph: Union[BipartiteCSR, TorchCSR], *,
               config: Optional[MatcherConfig] = None,
               warm_start: Optional[str] = None,
               deadline_s: Optional[float] = None,
               tag: Optional[str] = None) -> Future:
        """Admit ``graph`` and enqueue it; returns a Future[MatchResult].

        ``deadline_s`` bounds the time from submit to dispatch: a request
        still queued when it expires is shed at flush time and its future
        resolves with :class:`DeadlineExceededError`.  ``tag`` labels the
        request in quarantine artifacts (and is what
        :meth:`FaultInjector.poison` matches on).

        Raises :class:`OversizeGraphError` /
        :class:`~repro_torch.matching.GraphValidationError` synchronously on
        admission failure, :class:`QueueFullError` under backpressure
        (``shed_policy="reject-newest"``), and :class:`ServiceClosedError`
        after :meth:`close`.
        """
        cfg = config if config is not None else self.config
        ws = warm_start if warm_start is not None else self.warm_start
        self.matcher(cfg, ws)      # fail fast here, not on the flush thread
        try:
            # dirop configs solve through the CSC mirror: admission attaches
            # it so the dispatched batch keys the entry warm-up built
            adm = self.bucketizer.admit(graph, csc=cfg.dirop or None)
        except (OversizeGraphError, GraphValidationError):
            self.metrics.record_reject()
            raise
        now = time.perf_counter()
        fut: Future = Future()
        req = _Request(admission=adm, config=cfg, warm_start=ws,
                       future=fut, submitted_at=now,
                       deadline=(None if deadline_s is None
                                 else now + deadline_s),
                       tag=tag)
        shed: Optional[_Request] = None
        with self._cond:
            if self._stop:
                raise ServiceClosedError("submit() on a closed service")
            depth = self._queue_depth_locked()
            if self.max_queue is not None and depth >= self.max_queue:
                if self.shed_policy == "reject-newest":
                    self.metrics.record_shed("reject-newest")
                    raise QueueFullError(depth, self.max_queue)
                shed = self._evict_oldest_locked()
            self.metrics.record_submit(adm.nnz, adm.graph.nnz_pad)
            if adm.route == "sharded":
                self._sharded_q.append(req)
            else:
                flush = self._batcher.add((adm.bucket, cfg, ws), req,
                                          req.submitted_at)
                if flush is not None:
                    self._ready.append(flush)
            self._cond.notify_all()
        if shed is not None:
            # resolve OUTSIDE the lock: done-callbacks may re-enter submit
            self.metrics.record_shed("reject-oldest")
            if not shed.future.cancelled():
                shed.future.set_exception(SheddedError(
                    "shed from a full admission queue to admit a newer "
                    "request (shed_policy='reject-oldest')"))
        return fut

    def _evict_oldest_locked(self) -> Optional[_Request]:
        """Pop the longest-queued request — whether still accumulating in
        the batcher, already staged in a ready flush, or in the sharded
        lane — so ``reject-oldest`` really evicts the globally oldest."""
        best = None                       # (enqueued_at, kind, ready_index)
        bt = self._batcher.oldest_enqueued_at()
        if bt is not None:
            best = (bt, "batcher", -1)
        if self._sharded_q:
            t = self._sharded_q[0].submitted_at
            if best is None or t < best[0]:
                best = (t, "sharded", -1)
        for i, f in enumerate(self._ready):
            t = f.items[0].enqueued_at   # items keep enqueue order
            if best is None or t < best[0]:
                best = (t, "ready", i)
        if best is None:
            return None
        _, kind, i = best
        if kind == "batcher":
            q = self._batcher.evict_oldest()
            return q.payload if q is not None else None
        if kind == "sharded":
            return self._sharded_q.pop(0)
        f = self._ready[i]
        victim, rest = f.items[0], f.items[1:]
        if rest:
            self._ready[i] = dataclasses.replace(f, items=rest)
        else:
            del self._ready[i]
        return victim.payload

    # -- lifecycle ------------------------------------------------------------
    def flush(self) -> None:
        """Force-flush every queued request now (non-blocking)."""
        with self._cond:
            self._ready.extend(self._batcher.drain())
            self._cond.notify_all()

    def drain(self) -> None:
        """Flush everything and block until all accepted requests resolved."""
        with self._cond:
            self._ready.extend(self._batcher.drain())
            self._cond.notify_all()
            while (self._ready or self._sharded_q or self._taken
                   or self._batcher.pending):
                self._cond.wait(0.01)
                self._ready.extend(self._batcher.drain())

    def close(self) -> None:
        """Graceful shutdown: drain, stop the flush thread — and never
        strand a future: anything still pending after the join window (a
        hung or dead thread) fails with :class:`ServiceClosedError`."""
        with self._cond:
            if self._stop:
                return
            self._stop = True
            self._ready.extend(self._batcher.drain())
            self._cond.notify_all()
        self._thread.join(timeout=120)
        stranded: List[_Request] = []
        with self._cond:
            for flush in self._ready:
                stranded.extend(q.payload for q in flush.items)
            self._ready = []
            stranded.extend(self._sharded_q)
            self._sharded_q = []
            stranded.extend(self._taken)
            self._taken = []
            stranded.extend(q.payload
                            for f in self._batcher.drain() for q in f.items)
            self._cond.notify_all()
        still_alive = self._thread.is_alive()
        undone = [r for r in stranded if not r.future.done()]
        if undone:
            self.metrics.record_failed(len(undone))
            why = ("flush thread did not exit within the close() join "
                   "window" if still_alive else
                   "service closed with the request unresolved")
            for r in undone:
                r.future.set_exception(ServiceClosedError(why))

    def __enter__(self) -> "MatchingService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- the flush thread -----------------------------------------------------
    def _loop(self) -> None:
        try:
            self._loop_impl()
        except FlushThreadDeath:
            # injected crash: die without the default excepthook traceback —
            # the unresolved in-flight set is already parked in _taken and
            # recovery (fail over + restart) belongs to the supervisor
            return

    def _loop_impl(self) -> None:
        while True:
            with self._cond:
                while True:
                    now = time.perf_counter()
                    self._ready.extend(self._batcher.due(now))
                    if self._ready or self._sharded_q:
                        break
                    if self._stop:
                        if self._batcher.pending:
                            self._ready.extend(self._batcher.drain())
                            continue
                        return
                    deadline = self._batcher.next_deadline()
                    timeout = (None if deadline is None
                               else max(0.0, deadline - now))
                    self._cond.wait(timeout)
                ready, self._ready = self._ready, []
                sharded, self._sharded_q = self._sharded_q, []
                self._taken.extend(q.payload for f in ready
                                   for q in f.items)
                self._taken.extend(sharded)
            try:
                # per-item guards: an exception must resolve the affected
                # futures, never kill the flush thread (which would strand
                # every later request).  FlushThreadDeath is a
                # BaseException precisely so it is NOT survivable here.
                for flush in ready:
                    try:
                        self._dispatch(flush)
                    except Exception as e:
                        self._fail([q.payload for q in flush.items], e)
                for req in sharded:
                    try:
                        self._dispatch_sharded(req)
                    except Exception as e:
                        self._fail([req], e)
            except BaseException:
                # crash unwind (FlushThreadDeath): leave the unresolved
                # in-flight set in _taken — it is exactly what the
                # supervisor fails over before restarting the thread
                with self._cond:
                    self._taken = [r for r in self._taken
                                   if not r.future.done()]
                    self._cond.notify_all()
                raise
            # clean pass: every request taken this round was resolved by
            # its dispatch guard, so this empties _taken; anything left
            # was dropped by a dispatch bug — fail loudly, never strand
            with self._cond:
                leak = [r for r in self._taken if not r.future.done()]
                self._taken = []
                self._cond.notify_all()
            for r in leak:
                self._fail([r], RuntimeError(
                    "request dropped by dispatch without resolution"))

    # -- the supervisor -------------------------------------------------------
    def _supervise(self, interval_s: float) -> None:
        """Watchdog: detect a dead flush thread, fail its in-flight futures,
        restart it.  Exits when the service closes."""
        while True:
            time.sleep(interval_s)
            with self._cond:
                if self._stop:
                    return
                if self._thread.is_alive():
                    continue
                # thread died outside close(): take over its in-flight set
                dead, self._taken = self._taken, []
            undone = [r for r in dead if not r.future.done()]
            self.metrics.record_failed(len(undone))
            for r in undone:
                r.future.set_exception(FlushThreadDiedError(
                    "the flush thread died while this request was in "
                    "flight; it has been restarted — resubmit"))
            with self._cond:
                if self._stop:
                    return
                self._thread = self._start_flush_thread()
                self.metrics.record_restart()
                self._cond.notify_all()

    def _fail(self, reqs: List[_Request], exc: BaseException) -> None:
        """Resolve still-pending futures with ``exc`` (dispatch escaped)."""
        undone = [r for r in reqs if not r.future.done()]
        self.metrics.record_failed(len(undone))
        for r in undone:
            r.future.set_exception(exc)

    # -- dispatch -------------------------------------------------------------
    def _claim(self, reqs: List[_Request]) -> List[_Request]:
        """Claim futures and shed expired ones; returns the live set.

        ``set_running_or_notify_cancel`` wins the race against caller-side
        ``cancel()``; a request whose deadline passed while queued is shed
        here — at flush time, before it can occupy a batch lane."""
        now = time.perf_counter()
        live: List[_Request] = []
        for r in reqs:
            if not r.future.set_running_or_notify_cancel():
                self.metrics.record_cancelled()
                continue
            if r.deadline is not None and now >= r.deadline:
                self.metrics.record_deadline_miss()
                r.future.set_exception(DeadlineExceededError(
                    f"deadline expired {now - r.deadline:.4f}s before "
                    "dispatch (queued too long; see shed/deadline metrics)"))
                continue
            live.append(r)
        return live

    def _run_batch(self, reqs: List[_Request], cfg: MatcherConfig,
                   ws: str) -> Tuple[MatchState, int, float, float]:
        """ONE stacked run_many over ``reqs`` -> (out, padded, t0, done)."""
        t0 = time.perf_counter()
        if self.faults is not None:
            self.faults.before_dispatch(reqs)
        graphs = [r.admission.graph for r in reqs]
        padded = batch_bucket(len(graphs), self._batcher.max_batch)
        graphs = graphs + [graphs[0]] * (padded - len(graphs))  # inert lanes
        batch = TorchCSR.stack(graphs)
        out = self.matcher(cfg, ws).run_many(batch)
        if out.cmatch.is_cuda:
            torch.cuda.current_stream(out.cmatch.device).synchronize()
        return out, padded, t0, time.perf_counter()

    def _dispatch(self, flush: Flush) -> None:
        """One flushed bucket: claim, shed expired, then batch-dispatch
        with bisection recovery."""
        bucket, cfg, ws = flush.key
        reqs = self._claim([q.payload for q in flush.items])
        if not reqs:
            return
        self._dispatch_reqs(reqs, bucket, cfg, ws, flush.reason)

    def _dispatch_reqs(self, reqs: List[_Request], bucket, cfg, ws,
                       reason: str, depth: int = 0) -> None:
        """Dispatch ``reqs`` as one batch; on failure, isolate the poison.

        A multi-request batch that fails is split in half and each half
        re-dispatched after a bounded exponential backoff — innocent
        co-batched requests land in an all-good half within O(log batch)
        re-dispatches and succeed.  A singleton that still fails after
        ``dispatch_retries`` retries is the isolated poisoned request: its
        future gets the real error and a quarantine artifact is dumped.
        """
        retries = self.dispatch_retries if len(reqs) == 1 else 0
        for attempt in range(retries + 1):
            if depth or attempt:
                time.sleep(min(0.2, self.retry_backoff_s
                               * (2 ** (depth + attempt - 1))))
            info0 = compile_cache_thread_info()
            try:
                out, padded, t0, done = self._run_batch(reqs, cfg, ws)
            except FlushThreadDeath:
                raise                       # a crash is not a request error
            except Exception as e:
                if attempt < retries:
                    continue
                if len(reqs) == 1:
                    self._quarantine(reqs[0], e)
                    return
                mid = len(reqs) // 2
                self._dispatch_reqs(reqs[:mid], bucket, cfg, ws, reason,
                                    depth + 1)
                self._dispatch_reqs(reqs[mid:], bucket, cfg, ws, reason,
                                    depth + 1)
                return
            break
        info1 = compile_cache_thread_info()
        self._resolve_batch(reqs, out, padded, bucket, cfg, reason, t0, done,
                            hits=info1["hits"] - info0["hits"],
                            misses=info1["misses"] - info0["misses"])

    def _resolve_batch(self, reqs, out, padded, bucket, cfg, reason,
                       t0: float, done: float, hits: int = 0,
                       misses: int = 0) -> None:
        self.metrics.record_flush(reason, real=len(reqs), padded=padded,
                                  hits=hits, misses=misses)
        for i, r in enumerate(reqs):
            state = out.lane(i)
            qw = t0 - r.submitted_at
            lat = done - r.submitted_at
            self.metrics.record_done(qw, lat)
            r.future.set_result(MatchResult(
                state=state, stats=MatchStats.of(state, cfg.name),
                bucket=bucket, route="bucket",
                nc=r.admission.nc, nr=r.admission.nr,
                batch_size=len(reqs), queue_wait_s=qw, latency_s=lat))

    def _dispatch_sharded(self, req: _Request) -> None:
        """The oversize lane: one edge-sharded ``ShardedMatcher`` run over
        the mesh; a failure quarantines the request."""
        reqs = self._claim([req])
        if not reqs:
            return
        t0 = time.perf_counter()
        key = (req.config, req.warm_start)
        m = self._sharded.get(key)
        if m is None:
            m = self._sharded[key] = ShardedMatcher(
                self.mesh, self.shard_axis, req.config, req.warm_start)
        try:
            if self.faults is not None:
                self.faults.before_dispatch(reqs)
            graph = req.admission.graph.shard(self.mesh, self.shard_axis)
            out = m.run(graph)
            if out.cmatch.is_cuda:
                torch.cuda.current_stream(out.cmatch.device).synchronize()
        except FlushThreadDeath:
            raise
        except Exception as e:
            self._quarantine(req, e)
            return
        done = time.perf_counter()
        qw = t0 - req.submitted_at
        lat = done - req.submitted_at
        self.metrics.record_sharded()
        self.metrics.record_done(qw, lat)
        req.future.set_result(MatchResult(
            state=out, stats=m.stats(out), bucket=None, route="sharded",
            nc=req.admission.nc, nr=req.admission.nr,
            batch_size=1, queue_wait_s=qw, latency_s=lat))

    def _quarantine(self, req: _Request, exc: Exception) -> None:
        """The isolated poisoned request: fail it with the real error and
        keep a ``repro-serving-quarantine/1`` reproducer (mirroring the
        corpus harness's ddmin artifacts)."""
        self.metrics.record_quarantined()
        self.metrics.record_failed()
        artifact = ""
        if self.quarantine_dir:
            try:
                artifact = self._dump_quarantine(req, exc)
            except Exception:       # never let artifact IO mask the error
                artifact = ""
        exc.quarantine_artifact = artifact      # breadcrumb for the caller
        req.future.set_exception(exc)

    def _dump_quarantine(self, req: _Request, exc: Exception) -> str:
        os.makedirs(self.quarantine_dir, exist_ok=True)
        g = req.admission.graph
        nnz = int(g.nnz)
        ecol, cadj = g.ecol[:nnz].cpu().numpy(), g.cadj[:nnz].cpu().numpy()
        name = req.tag or f"req_{id(req):x}"
        out = os.path.join(self.quarantine_dir, f"quarantine_{name}.json")
        with open(out, "w") as f:
            json.dump({
                "schema": QUARANTINE_SCHEMA,
                "tag": req.tag,
                "error": f"{type(exc).__name__}: {exc}",
                "config": dataclasses.asdict(req.config),
                "warm_start": req.warm_start,
                "nc": req.admission.nc, "nr": req.admission.nr, "nnz": nnz,
                "bucket": (list(req.admission.bucket.key)
                           if req.admission.bucket else None),
                "edges": np.stack([ecol, cadj], axis=1).tolist(),
            }, f, indent=2, sort_keys=True)
        return out
