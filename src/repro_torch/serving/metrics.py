"""Service observability: queue wait, batch occupancy, pad waste, compile hits.

All counters live behind one lock (``submit`` threads, the flush thread, and
metric readers race them); latency-shaped series go into bounded reservoirs
so a long-running service reports percentiles at O(1) memory.  Occupancy and
pad waste are the two prices the bucketizer/scheduler pay for bounded
compilation — a deployment watches them to re-size its bucket ladder and
batch targets.
"""
from __future__ import annotations

import math
import threading
from collections import deque
from typing import Iterable, List


def percentile(xs: Iterable[float], p: float) -> float:
    """Nearest-rank percentile (p in [0, 100]); NaN on an empty series."""
    s: List[float] = sorted(xs)
    if not s:
        return math.nan
    k = max(0, min(len(s) - 1, round(p / 100.0 * (len(s) - 1))))
    return s[k]


class ServiceMetrics:
    """Thread-safe counters for one :class:`MatchingService`."""

    def __init__(self, reservoir: int = 4096):
        self._lock = threading.RLock()   # snapshot() reads the properties
        # request lifecycle
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.rejected = 0           # typed admission rejections
        self.sharded = 0            # oversize requests served by ShardedMatcher
        # fault-tolerance lifecycle (see docs/architecture.md, the
        # degradation ladder): with `pending` these make the flush mix sum
        # to submissions —
        #   submitted == completed + failed + cancelled + shed_oldest
        #                + deadline_misses + pending
        # (shed_newest requests were refused at submit and are NOT in
        # `submitted`, mirroring `rejected`)
        self.cancelled = 0          # futures cancelled before their flush
        self.shed_newest = 0        # submits refused by backpressure
        self.shed_oldest = 0        # queued requests evicted for new ones
        self.deadline_misses = 0    # expired before dispatch, shed at flush
        self.quarantined = 0        # poisoned requests isolated by bisection
        self.restarts = 0           # flush-thread supervisor restarts
        # dispatch accounting (one device dispatch per flush)
        self.dispatches = 0
        self.flushes = {"full": 0, "deadline": 0, "drain": 0}
        self.batch_real = 0         # real requests across all flushes
        self.batch_padded = 0       # padded batch lanes across all flushes
        # pad-waste accounting (admission time)
        self.edges_true = 0
        self.edges_padded = 0
        # compile-cache deltas attributed to dispatches
        self.compile_hits = 0
        self.compile_misses = 0
        # latency reservoirs (seconds)
        self.queue_wait_s: deque = deque(maxlen=reservoir)
        self.latency_s: deque = deque(maxlen=reservoir)

    # -- recording ------------------------------------------------------------
    def record_submit(self, nnz: int, nnz_pad: int) -> None:
        with self._lock:
            self.submitted += 1
            self.edges_true += nnz
            self.edges_padded += nnz_pad

    def record_reject(self) -> None:
        with self._lock:
            self.rejected += 1

    def record_sharded(self) -> None:
        with self._lock:
            self.sharded += 1
            self.dispatches += 1

    def record_flush(self, reason: str, real: int, padded: int,
                     hits: int, misses: int) -> None:
        with self._lock:
            self.dispatches += 1
            self.flushes[reason] = self.flushes.get(reason, 0) + 1
            self.batch_real += real
            self.batch_padded += padded
            self.compile_hits += hits
            self.compile_misses += misses

    def record_done(self, queue_wait_s: float, latency_s: float) -> None:
        with self._lock:
            self.completed += 1
            self.queue_wait_s.append(queue_wait_s)
            self.latency_s.append(latency_s)

    def record_failed(self, n: int = 1) -> None:
        with self._lock:
            self.failed += n

    def record_cancelled(self, n: int = 1) -> None:
        with self._lock:
            self.cancelled += n

    def record_shed(self, policy: str, n: int = 1) -> None:
        with self._lock:
            if policy == "reject-newest":
                self.shed_newest += n
            else:
                self.shed_oldest += n

    def record_deadline_miss(self, n: int = 1) -> None:
        with self._lock:
            self.deadline_misses += n

    def record_quarantined(self, n: int = 1) -> None:
        with self._lock:
            self.quarantined += n

    def record_restart(self) -> None:
        with self._lock:
            self.restarts += 1

    # -- reading --------------------------------------------------------------
    @property
    def occupancy(self) -> float:
        """Real requests per padded batch lane, over all flushes."""
        with self._lock:
            return self.batch_real / max(1, self.batch_padded)

    @property
    def pad_edge_waste(self) -> float:
        """Fraction of admitted edge slots that are padding."""
        with self._lock:
            return 1.0 - self.edges_true / max(1, self.edges_padded)

    def snapshot(self) -> dict:
        """One consistent host-side view of every counter."""
        with self._lock:
            qs, ls = list(self.queue_wait_s), list(self.latency_s)
            return {
                "submitted": self.submitted,
                "completed": self.completed,
                "failed": self.failed,
                "rejected": self.rejected,
                "sharded": self.sharded,
                "cancelled": self.cancelled,
                "shed_newest": self.shed_newest,
                "shed_oldest": self.shed_oldest,
                "deadline_misses": self.deadline_misses,
                "quarantined": self.quarantined,
                "restarts": self.restarts,
                "dispatches": self.dispatches,
                "flushes_full": self.flushes.get("full", 0),
                "flushes_deadline": self.flushes.get("deadline", 0),
                "flushes_drain": self.flushes.get("drain", 0),
                "batch_real": self.batch_real,
                "batch_padded": self.batch_padded,
                "occupancy": self.occupancy,
                "pad_edge_waste": self.pad_edge_waste,
                "compile_hits": self.compile_hits,
                "compile_misses": self.compile_misses,
                "queue_wait_p50_ms": percentile(qs, 50) * 1e3,
                "queue_wait_p99_ms": percentile(qs, 99) * 1e3,
                "latency_p50_ms": percentile(ls, 50) * 1e3,
                "latency_p99_ms": percentile(ls, 99) * 1e3,
            }
