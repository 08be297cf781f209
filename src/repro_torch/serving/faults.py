"""Deterministic fault injection for the serving stack (chaos harness).

Real failure modes a long-running matching service meets — a poisoned graph
that kills its whole co-batched dispatch, a transient capture/build error, a
slow device, a crashed flush thread — are injected here as *deterministic,
seedable* hooks so every recovery path in :class:`~repro_torch.serving.service.
MatchingService` (bisection quarantine, retry backoff, supervisor restart)
is drivable from a unit test without real hardware faults::

    faults = FaultInjector(seed=7)
    faults.poison("bad-req")              # every batch containing it fails
    faults.script(RuntimeError("flaky"))  # next dispatch fails once
    faults.kill_thread_after(3)           # 4th dispatch kills the flush thread
    svc = MatchingService(..., faults=faults)

The service calls :meth:`FaultInjector.before_dispatch` on the flush thread
immediately before each device dispatch (batched and sharded lanes alike);
the injector may sleep (latency), raise :class:`InjectedFault` /
:class:`CompileFault` (recoverable — the service bisects/retries), or raise
:class:`FlushThreadDeath` (a ``BaseException``, so it sails past the
service's per-flush ``except Exception`` guards and genuinely kills the
thread, exactly like a native crash would).  All decisions draw from one
seeded ``random.Random`` under a lock, so a given (seed, request sequence)
replays identically.

``python -m repro_torch.launch.serve_matching --chaos`` drives a live service
through this injector; ``tests/test_torch_serving_faults.py`` is the scripted
matrix.
"""
from __future__ import annotations

import random
import threading
import time
from collections import deque
from typing import List, Optional


class InjectedFault(RuntimeError):
    """A deterministic dispatch failure planted by :class:`FaultInjector`."""


class PoisonedGraphFault(InjectedFault):
    """The injected failure a poisoned request causes in any batch that
    contains it — the stand-in for 'this graph crashes the kernel'."""

    def __init__(self, tag: str):
        self.tag = tag
        super().__init__(f"poisoned request {tag!r} crashed the dispatch")


class CompileFault(InjectedFault):
    """An injected compile-path failure (e.g. out of memory while capturing)."""


class FlushThreadDeath(BaseException):
    """Injected flush-thread crash.

    Deliberately a ``BaseException``: the service's dispatch guards catch
    ``Exception`` to keep the thread alive through request failures, and a
    simulated crash must NOT be survivable by those guards — the supervisor
    path is what's under test.
    """


class FaultInjector:
    """Seedable fault hooks for :class:`~repro_torch.serving.service.
    MatchingService` (see module docstring for the failure menu).

    Thread-safe: ``before_dispatch`` runs on the flush thread while tests
    poison/script from their own thread.
    """

    def __init__(self, seed: int = 0, dispatch_error_rate: float = 0.0,
                 compile_error_rate: float = 0.0, latency_s: float = 0.0):
        assert 0.0 <= dispatch_error_rate <= 1.0, dispatch_error_rate
        assert 0.0 <= compile_error_rate <= 1.0, compile_error_rate
        self.seed = seed
        self.dispatch_error_rate = dispatch_error_rate
        self.compile_error_rate = compile_error_rate
        self.latency_s = latency_s
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._poisoned = set()
        self._scripted: deque = deque()
        self._kill_after: Optional[int] = None
        # observability (read by tests/CLI after a run)
        self.dispatches = 0
        self.injected = 0
        self.kills = 0

    # -- planting -------------------------------------------------------------
    def poison(self, tag: str) -> None:
        """Mark the request tagged ``tag`` (``submit(..., tag=...)``) as
        poisoned: every dispatch whose batch contains it raises
        :class:`PoisonedGraphFault` — deterministically, retries included —
        until :meth:`cure` is called."""
        with self._lock:
            self._poisoned.add(tag)

    def cure(self, tag: str) -> None:
        with self._lock:
            self._poisoned.discard(tag)

    def script(self, *excs: BaseException) -> None:
        """Queue exceptions to raise on the next dispatches, one each, ahead
        of every probabilistic fault (transient-failure scenarios)."""
        with self._lock:
            self._scripted.extend(excs)

    def kill_thread_after(self, dispatches: int) -> None:
        """Arm a one-shot :class:`FlushThreadDeath` once ``dispatches`` more
        dispatches have completed (0 = the very next one dies)."""
        with self._lock:
            self._kill_after = dispatches

    # -- the service-side hook ------------------------------------------------
    def before_dispatch(self, reqs: List[object]) -> None:
        """Called by the service right before a device dispatch of ``reqs``
        (objects with a ``tag`` attribute).  Raises or sleeps per the
        planted faults; otherwise returns and the dispatch proceeds."""
        with self._lock:
            self.dispatches += 1
            if self._kill_after is not None:
                if self._kill_after <= 0:
                    self._kill_after = None
                    self.kills += 1
                    raise FlushThreadDeath()
                self._kill_after -= 1
            if self._scripted:
                self.injected += 1
                raise self._scripted.popleft()
            bad = [getattr(r, "tag", None) for r in reqs
                   if getattr(r, "tag", None) in self._poisoned]
            if bad:
                self.injected += 1
                raise PoisonedGraphFault(bad[0])
            if (self.dispatch_error_rate
                    and self._rng.random() < self.dispatch_error_rate):
                self.injected += 1
                raise InjectedFault("injected transient dispatch failure")
            if (self.compile_error_rate
                    and self._rng.random() < self.compile_error_rate):
                self.injected += 1
                raise CompileFault("injected compile failure")
            delay = self.latency_s
        if delay:
            time.sleep(delay)
