"""The service's oversize lane over a world of ranks: rank 0 serves, the
other ranks follow.

A :class:`~repro_torch.serving.MatchingService` whose ``mesh`` spans the
ranks of a ``torch.distributed`` world (``make_mesh`` inside one) runs on
rank 0 and serves every request there.  An in-bucket request is batched
and solved on rank 0 alone.  An oversize one is solved by every rank
together: one :class:`~repro_torch.matching.ShardedMatcher` run over the
mesh, each rank sweeping its own shard of the edges, the state on every
rank the single-device ``Matcher.run``'s of the bucketed graph bit for bit.
This is the counterpart of the JAX package's lane over a mesh of every
device, which one controller drives.  The other ranks call
:func:`serve_followers`, which the lane's messages drive:

* rank 0's flush thread alone sends them, in the order it takes the
  requests: a header of :data:`HEADER_BYTES` (JSON: the operation, the
  request's ``MatcherConfig`` and warm start, ``nc``, ``nr``, ``nnz``, the
  bucketed edge capacity and the tag), then, for a run, the host graph's
  ``cxadj``, ``cadj`` and ``ecol``;
* they go over a gloo group of the world's ranks created beside the
  default one (:class:`WorldLane`; every rank creates it, in the same
  order), as CPU tensors: under NCCL the whole edge list never crosses a
  follower's card.  Each rank uploads its own shard alone
  (``TorchCSR.from_host_shard``), rank 0 the whole graph only for the warm
  start and a ``degrade_maximal`` round (:mod:`repro_torch.matching.
  sharded`);
* every rank agrees twice a run, by an ``all_reduce_max_`` of a failure
  flag: before the solve (a follower that cannot take the request) and
  after it.  A failure on any rank fails the request on rank 0, where the
  service quarantines it, and every rank goes on to the next header.  A
  rank that raises between two collectives of a solve leaves the others in
  the next one until the world's timeout ends it with an error;
* an idle lane: a follower waits for the next header in a collective that
  the world's timeout bounds, so rank 0's flush thread sends an ``idle``
  header whenever a quarter of it (:attr:`WorldLane.idle_s`) has passed
  with no header, whether rank 0 is idle or busy with in-bucket requests
  (it looks on every pass and after each in-bucket flush).  A follower
  then outlives any stretch without oversize traffic, and still fails,
  after the timeout, when rank 0 is gone;
* ``stop``: the service's ``close()`` sends it once, after the drain (the
  flush thread as it exits, or ``close()`` itself where that thread died).
  :func:`serve_followers` then returns what the rank served.

A collective of the lane's own that fails (a rank gone) leaves the ranks
out of step: rank 0's lane keeps the error, sends nothing more, and fails
every later oversize request with it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import hashlib
import json
import threading
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.csr import BipartiteCSR
from repro_torch.distributed.comm import all_reduce_max_, broadcast_
from repro_torch.distributed.world import Axis, World, require_world
from repro_torch.matching import (MatcherConfig, MatchState, ShardedMatcher,
                                  make_mesh)

RUN, IDLE, STOP = "run", "idle", "stop"
HEADER_BYTES = 4096


class LaneRankError(RuntimeError):
    """Another rank of the world's lane could not take, or failed, this
    request."""


def matching_digest(cmatch, rmatch) -> str:
    """A sha256 of a matching: ``cmatch`` then ``rmatch`` as int32 bytes
    (tensors on any device, or numpy arrays)."""
    h = hashlib.sha256()
    for a in (cmatch, rmatch):
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        h.update(a.astype(np.int32).tobytes())
    return h.hexdigest()


class WorldLane:
    """The lane's channel on one rank of ``world`` (the current world where
    None): a gloo group of every rank, created here (collectively: every
    rank constructs its lane at the same point), whose collectives wait
    for a peer as long as the world's do.  Rank 0 sends (:meth:`run`,
    :meth:`idle`, :meth:`stop`); :func:`serve_followers` receives.
    ``sent`` counts rank 0's headers by operation; ``error`` is the failure
    of a collective of the lane's own, after which it sends nothing."""

    def __init__(self, world: Optional[World] = None):
        self.world = require_world(world)
        group = dist.new_group(
            backend="gloo",
            timeout=datetime.timedelta(seconds=self.world.timeout))
        self.axis = Axis("lane", self.world.rank, self.world.size,
                         tuple(range(self.world.size)), group)
        self.idle_s = self.world.timeout / 4
        self.sent = {RUN: 0, IDLE: 0, STOP: 0}
        self.stopped = False
        self.error: Optional[Exception] = None
        self._last = time.monotonic()
        self._lock = threading.Lock()

    # -- rank 0 ---------------------------------------------------------------
    def next_idle(self) -> Optional[float]:
        """The ``time.monotonic()`` by which rank 0 sends its next header
        (None once stopped or failed: no more)."""
        if self.stopped or self.error is not None:
            return None
        return self._last + self.idle_s

    def run(self, matcher: ShardedMatcher, g: BipartiteCSR,
            tag: Optional[str] = None) -> MatchState:
        """Rank 0: send the host graph ``g`` (its edge capacity bucketed)
        and ``matcher``'s config and warm start to every rank, then solve it
        with them (``matcher.run(g)``); the state, or the error of the rank
        that failed (:class:`LaneRankError` for another rank's)."""
        with self._lock:
            self._open()
            header = self._encode(dict(
                op=RUN, config=dataclasses.asdict(matcher.config),
                warm_start=matcher.warm_start, nc=int(g.nc), nr=int(g.nr),
                nnz=int(g.nnz), nnz_pad=g.nnz_pad, tag=tag))
            try:
                self._send(RUN, header)
                with self._failing():
                    for a in (g.cxadj, g.cadj, g.ecol):
                        broadcast_(torch.from_numpy(
                            np.ascontiguousarray(a, np.int32)), 0, self.axis)
                failed = self.agree(True)
                if failed is not None:
                    raise LaneRankError(
                        f"rank {failed} of {self.world.size} could not take "
                        f"the request")
                return self.solve(matcher, g)
            finally:
                self._last = time.monotonic()

    def idle(self) -> None:
        """Rank 0: an ``idle`` header, which keeps the followers' wait
        within the world's timeout (a failure is kept in ``error``)."""
        with self._lock:
            if not self.stopped and self.error is None:
                with contextlib.suppress(Exception):
                    self._send(IDLE, self._encode(dict(op=IDLE)))

    def stop(self) -> None:
        """Rank 0: the ``stop`` header, once (later calls, and calls after
        a failure, send nothing)."""
        with self._lock:
            if self.stopped:
                return
            self.stopped = True
            if self.error is None:
                self._send(STOP, self._encode(dict(op=STOP)))

    def _open(self) -> None:
        if self.error is not None:
            raise RuntimeError(f"the world's lane failed earlier: "
                               f"{self.error}") from self.error
        if self.stopped:
            raise RuntimeError("the world's lane was stopped")

    @contextlib.contextmanager
    def _failing(self):
        """Keep the error of a collective of the lane's own in ``error``."""
        try:
            yield
        except Exception as e:
            self.error = e
            raise

    @staticmethod
    def _encode(msg: dict) -> torch.Tensor:
        data = json.dumps(msg).encode()
        if len(data) > HEADER_BYTES:
            raise ValueError(f"a lane header of {len(data)} bytes exceeds "
                             f"{HEADER_BYTES} (a tag too long?)")
        buf = torch.zeros(HEADER_BYTES, dtype=torch.uint8)
        buf[:len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
        return buf

    def _send(self, op: str, header: torch.Tensor) -> None:
        with self._failing():
            broadcast_(header, 0, self.axis)
        self.sent[op] += 1
        self._last = time.monotonic()

    # -- every rank -------------------------------------------------------------
    def agree(self, ok: bool) -> Optional[int]:
        """Every rank: whether every rank is ``ok``; None if so, else the
        highest rank that is not."""
        flag = torch.tensor([0 if ok else self.world.rank + 1])
        with self._failing():
            all_reduce_max_(flag, self.axis)
        return int(flag) - 1 if int(flag) else None

    def solve(self, matcher: ShardedMatcher,
              graph: BipartiteCSR) -> MatchState:
        """Every rank: ``matcher.run(graph)``, then the agreement on its
        outcome; raises this rank's error, or :class:`LaneRankError` where
        another rank failed."""
        try:
            out, err = matcher.run(graph), None
        except Exception as e:      # agreed on first, then raised
            out, err = None, e
        failed = self.agree(err is None)
        if err is not None:
            raise err
        if failed is not None:
            raise LaneRankError(f"rank {failed} of {self.world.size} failed "
                                f"the request")
        return out

    # -- the followers ------------------------------------------------------------
    def receive(self) -> dict:
        """A follower: the next header."""
        buf = torch.zeros(HEADER_BYTES, dtype=torch.uint8)
        broadcast_(buf, 0, self.axis)
        return json.loads(bytes(buf.numpy()).rstrip(b"\0"))

    def receive_graph(self, msg: dict) -> BipartiteCSR:
        """A follower: the host graph a ``run`` header announced."""
        out = []
        for n in (msg["nc"] + 1, msg["nnz_pad"], msg["nnz_pad"]):
            t = torch.empty(n, dtype=torch.int32)
            broadcast_(t, 0, self.axis)
            out.append(t.numpy())
        return BipartiteCSR(nc=msg["nc"], nr=msg["nr"], nnz=msg["nnz"],
                            cxadj=out[0], cadj=out[1], ecol=out[2])


def serve_followers(world: Optional[World] = None,
                    axis: str = "data") -> dict:
    """A rank other than 0 of the world whose rank 0 runs a
    :class:`~repro_torch.serving.MatchingService` over a mesh of it
    (module doc): join every oversize request's solve until the service
    closes.  ``axis``: the mesh's axis (the service's ``shard_axis``).
    Returns ``served``
    (the runs every rank completed), ``failed``, ``idle`` (the idle headers
    received), ``errors`` (this rank's) and ``runs``: each served state's
    :func:`matching_digest` with its ``phases``, ``fallbacks``,
    ``certified`` and tag."""
    w = require_world(world)
    if w.rank == 0:
        raise ValueError("rank 0 runs the MatchingService; serve_followers "
                         "is for the other ranks")
    lane = WorldLane(w)
    mesh = make_mesh((w.size,), (axis,), world=w)
    matchers = {}
    out = dict(served=0, failed=0, idle=0, errors=[], runs=[])
    while True:
        msg = lane.receive()
        if msg["op"] == STOP:
            return out
        if msg["op"] == IDLE:
            out["idle"] += 1
            continue
        graph = lane.receive_graph(msg)
        err = None
        try:
            cfg = MatcherConfig(**msg["config"])
            ws = msg["warm_start"]
            m = matchers.get((cfg, ws))
            if m is None:
                m = matchers[(cfg, ws)] = ShardedMatcher(mesh, axis, cfg, ws)
        except Exception as e:      # agreed on, then the next header
            err = e
        try:
            if lane.agree(err is None) is not None:
                raise err or LaneRankError("another rank could not take "
                                           "the request")
            state = lane.solve(m, graph)
        except Exception as e:
            out["failed"] += 1
            out["errors"].append(f"{type(e).__name__}: {e}")
            continue
        out["served"] += 1
        out["runs"].append(dict(
            digest=matching_digest(state.cmatch, state.rmatch),
            phases=int(state.phases), fallbacks=int(state.fallbacks),
            certified=bool(state.certified), tag=msg["tag"]))
