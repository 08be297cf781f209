"""``repro_torch.serving`` — the online matching service over
``repro_torch.matching``, the JAX package's ``repro.serving`` on the card.

Requests are admitted onto declared size buckets (:mod:`bucketizer`),
micro-batched per (bucket, config, warm start) with adaptive targets and
deadline flushes (:mod:`scheduler`), dispatched as ONE ``Matcher.run_many``
call per flush (:mod:`service`: one compile-cache entry of CUDA graphs,
each BFS level of the batch one kernel launch), with the whole (bucket x
config x warm start x batch) grid captured ahead of traffic (:mod:`warmup`)
and everything observable (:mod:`metrics`)::

    submit() ─► Bucketizer ─► MicroBatcher ─► stack + run_many ─► Future
                   │ oversize                    (1 dispatch/flush)
                   ├─► OversizeGraphError (oversize="reject", the default)
                   └─► the sharded lane (oversize="shard", mesh=...):
                       one ShardedMatcher.run per request; over a world's
                       ranks (:mod:`world_lane`) rank 0 serves and every
                       other rank joins each run (serve_followers)

``python -m repro_torch.launch.serve_matching`` replays a synthetic
open-loop traffic trace against this service.
"""
from .bucketizer import (Admission, Bucketizer, OversizeGraphError,
                         SizeBucket, ladder)
from .faults import (CompileFault, FaultInjector, FlushThreadDeath,
                     InjectedFault, PoisonedGraphFault)
from .metrics import ServiceMetrics, percentile
from .scheduler import Flush, MicroBatcher, batch_bucket, batch_ladder
from .service import (DeadlineExceededError, FlushThreadDiedError,
                      MatchingService, MatchResult, QueueFullError,
                      ServiceClosedError, SheddedError)
from .warmup import (WarmupGrid, WarmupReport, synthetic_bucket_graph,
                     warm_up)
from .world_lane import LaneRankError, WorldLane, serve_followers

__all__ = [
    "Admission", "Bucketizer", "OversizeGraphError", "SizeBucket", "ladder",
    "CompileFault", "FaultInjector", "FlushThreadDeath", "InjectedFault",
    "PoisonedGraphFault",
    "ServiceMetrics", "percentile",
    "Flush", "MicroBatcher", "batch_bucket", "batch_ladder",
    "MatchingService", "MatchResult", "ServiceClosedError",
    "DeadlineExceededError", "FlushThreadDiedError", "QueueFullError",
    "SheddedError",
    "WarmupGrid", "WarmupReport", "synthetic_bucket_graph", "warm_up",
    "LaneRankError", "WorldLane", "serve_followers",
]
