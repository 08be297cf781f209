"""Adaptive micro-batcher: accumulate per-key, flush on batch-full or deadline.

Requests accumulate in per-``(bucket, config, warm start)`` queues — only
same-key requests can share one ``match_many`` dispatch.  A queue flushes
when it reaches its batch target ("full") or when its oldest request has
waited ``max_delay_s`` ("deadline"), so tail latency is bounded no matter how
quiet a bucket is.

The batch target is adaptive, per key: it starts at 1 — the
latency-optimal choice when traffic is sparse — doubles every time a flush
fills (arrivals are outpacing dispatch, so larger batches amortize more
per-call overhead, the paper's core premise), and drops to the observed
size on every deadline flush (a deadline firing is direct evidence the
target was not reachable in time).  Under sustained load the target climbs
to ``max_batch`` within ``log2(max_batch)`` flushes; when load thins, one
deadline flush pulls it straight back down.  ``adaptive=False`` pins the
target at ``max_batch`` (pure throughput mode).

Flushed sizes are rounded up to the :func:`batch_ladder` (powers of two
capped at ``max_batch``) by the dispatcher, so the compile cache sees
O(log max_batch) batch shapes per bucket — the exact grid AOT warmup
compiles.

This class is deliberately *not* thread-safe: :class:`~repro_torch.serving.service.
MatchingService` serializes access under its own condition variable, which
keeps the flush policy a plain data structure testable with a fake clock.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Hashable, List, Optional, Tuple


def batch_ladder(max_batch: int) -> Tuple[int, ...]:
    """Padded batch sizes a dispatcher may issue: 1, 2, 4, ... , max_batch."""
    assert max_batch >= 1, max_batch
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(dict.fromkeys(out))


def batch_bucket(n: int, max_batch: int) -> int:
    """Round a flush of ``n`` requests up to its ladder rung."""
    assert 1 <= n <= max_batch, (n, max_batch)
    b = 1
    while b < n and b < max_batch:
        b *= 2
    return min(b, max_batch)


@dataclasses.dataclass(frozen=True)
class Queued:
    """One enqueued request: opaque payload + its enqueue timestamp."""

    payload: object
    enqueued_at: float


@dataclasses.dataclass(frozen=True)
class Flush:
    """A batch ready to dispatch (one device dispatch per Flush)."""

    key: Hashable
    items: Tuple[Queued, ...]
    reason: str                  # "full" | "deadline" | "drain"
    target: int                  # the batch target when the flush fired


class MicroBatcher:
    """Per-key accumulation with full/deadline/drain flushes (see module doc).

    The caller drives time explicitly (``now``) — nothing here reads a clock.
    """

    def __init__(self, max_batch: int = 8, max_delay_s: float = 0.002,
                 adaptive: bool = True):
        assert max_batch >= 1 and max_delay_s >= 0
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        self.adaptive = adaptive
        self._queues: Dict[Hashable, List[Queued]] = {}
        self._target: Dict[Hashable, float] = {}

    # -- policy ---------------------------------------------------------------
    def target(self, key: Hashable) -> int:
        """Current batch target for ``key`` (clamped to [1, max_batch])."""
        if not self.adaptive:
            return self.max_batch
        t = self._target.get(key, 1.0)
        return max(1, min(self.max_batch, math.ceil(t)))

    def _adapt(self, key: Hashable, size: int, reason: str) -> None:
        if not self.adaptive:
            return
        t = self._target.get(key, 1.0)
        if reason == "full":
            self._target[key] = min(float(self.max_batch), max(2.0, 2.0 * t))
        elif reason == "deadline":
            # a deadline fired => arrivals did not fill the target in time;
            # drop straight to the observed size (an averaged decay never
            # reaches 1 under ceil(), leaving sparse traffic stuck paying
            # the full deadline on every request)
            self._target[key] = max(1.0, float(size))

    # -- queue operations -----------------------------------------------------
    def add(self, key: Hashable, payload: object, now: float
            ) -> Optional[Flush]:
        """Enqueue; returns a full-batch Flush if the target was reached."""
        q = self._queues.setdefault(key, [])
        q.append(Queued(payload, now))
        if len(q) >= self.target(key):
            return self._flush(key, "full")
        return None

    def _flush(self, key: Hashable, reason: str) -> Optional[Flush]:
        q = self._queues.pop(key, [])
        if not q:
            return None
        tgt = self.target(key)
        self._adapt(key, len(q), reason)
        return Flush(key=key, items=tuple(q), reason=reason, target=tgt)

    def due(self, now: float) -> List[Flush]:
        """Deadline flushes: every queue whose oldest request has expired."""
        expired = [k for k, q in self._queues.items()
                   if q and now - q[0].enqueued_at >= self.max_delay_s]
        return [f for k in expired if (f := self._flush(k, "deadline"))]

    def next_deadline(self) -> Optional[float]:
        """Absolute time of the earliest pending deadline (None if idle)."""
        ts = [q[0].enqueued_at + self.max_delay_s
              for q in self._queues.values() if q]
        return min(ts) if ts else None

    def evict_oldest(self) -> Optional[Queued]:
        """Pop the single oldest queued request across every key.

        The service's ``reject-oldest`` shed policy: when the bounded
        admission queue is full, the request that has waited longest — and
        is therefore the most likely to miss its deadline anyway — makes
        room for the incoming one.  Returns ``None`` when nothing is queued.
        """
        best_key, best = None, None
        for k, q in self._queues.items():
            if q and (best is None or q[0].enqueued_at < best.enqueued_at):
                best_key, best = k, q[0]
        if best is None:
            return None
        q = self._queues[best_key]
        q.pop(0)
        if not q:
            del self._queues[best_key]
        return best

    def oldest_enqueued_at(self) -> Optional[float]:
        """Enqueue time of the request :meth:`evict_oldest` would pop."""
        ts = [q[0].enqueued_at for q in self._queues.values() if q]
        return min(ts) if ts else None

    def drain(self) -> List[Flush]:
        """Flush every non-empty queue immediately (graceful drain)."""
        return [f for k in list(self._queues)
                if (f := self._flush(k, "drain"))]

    @property
    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())
