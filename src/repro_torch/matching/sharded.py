"""The edge-sharded matcher: the JAX package's distributed-memory lane.

The paper closes with "an out-of-core or distributed-memory type algorithm
is amenable when the graph does not fit into the device".  The JAX package
answers it with a ``ShardedMatcher`` over a device mesh; this is its port,
the *same* solver as the single-device :class:`~repro_torch.matching.api.
Matcher` with the edge list cut into shards:

* the edge list is cut 1-D along one mesh axis (:meth:`TorchCSR.shard`):
  ``D`` contiguous slices of ``per_shard_nnz(nnz_pad, D)`` edges, each a
  power-of-two bucket of its own;
* the O(n) state (``bfs``, ``root``, ``pred``, ``cmatch``, ``rmatch``) is
  whole; every BFS level each shard sweeps its own slice into a winner
  vector of its own (the fused kernel K1 by default, K2 and a scatter on
  the legacy path, K3 over the shard's slice of the CSC mirror on
  ``dirop_pallas``), and the D vectors merge by their elementwise min
  (``solve._merge_shards``), where the reference's one ``lax.pmin`` a
  level stands;
* ``ALTERNATE`` and ``FIXMATCHING`` act on the whole O(n) state, as on
  every device of the reference's mesh.

Min depends on neither order nor partition, so the result is the
single-device ``Matcher.run``'s bit for bit: ``cmatch``, ``rmatch``,
``phases``, ``fallbacks`` and ``certified``.  A ring all-reduce of the
winners would move ``2 (D-1)/D * 4 (nr+1)`` bytes a level
(:func:`merge_bytes`); ``ShardedMatcher.last_counts`` counts the merges.

The warm start and the ``degrade_maximal`` round run over the whole edge
list, as the reference runs them outside its ``shard_map`` region.

One controller drives a mesh whose positions share a device, as JAX does.
A :class:`Mesh` names its devices, which may repeat: ``make_mesh((4,),
("data",), devices=["cuda:0"] * 4)`` puts four shards on one card (the
counterpart of the reference's forced four-device host).  Then the D sweeps
and the merge run inside the level step, captured into the level's CUDA
graph under the same WHILE node as the single-device level, so a sharded
solve makes the same host syncs.

A mesh over the ranks of a ``torch.distributed`` world
(:mod:`repro_torch.distributed`; ``make_mesh`` inside a world, or over
distinct devices) gives position ``i`` to rank ``i``: each rank holds its
own shard of the edges (:meth:`TorchCSR.shard`) and the whole O(n) state,
sweeps its shard into its winner vector, and the merge is one
``all_reduce_min_`` of the ``(nr+1,)`` winners a level, where the
reference's ``lax.pmin`` stands.  Every test of a loop reads the merged
winners or the whole state, equal on every rank, so the ranks never
disagree.  In an NCCL world of one rank the collective is captured with
the level step, under the same WHILE node, and a solve makes the
single-device host syncs.  gloo cannot be captured, and NCCL's collective
across several ranks, captured, cannot sit in a WHILE node's body
(instantiating it fails), so there the host drives the level loop: each
level it reads the loop's flag (a counted host sync), replays the sweep's
graph, merges, and replays the fold's; a phase of ``k`` levels makes ``k +
1`` more host syncs than on one device.  The warm start and the
``degrade_maximal`` round need the whole edge list: rank 0 runs them on the
whole graph and broadcasts the state, so every rank starts from the
single-device warm state bit for bit.  Every rank returns the single-device
``Matcher.run``'s state.  Given the host graph (``run(g)`` with ``g`` a
``BipartiteCSR``), a rank uploads only its shard of the edges and the O(n)
arrays; rank 0 uploads the whole graph for the warm start and for a degrade
round and drops the upload after each.  Rank 0's warm-start program keeps
its copy of the edge list in the compile cache, as on one device; no other
rank ever holds the whole edge list.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch._device import resolve_device
from repro_torch.distributed.comm import broadcast_
from repro_torch.distributed.world import World, current_world

from .api import Matcher
from .cache import mesh_cache_key
from .config import MatcherConfig
from .device_csr import TorchCSR
from .solve import _device_key
from .state import MatchState, MatchStats
from .warmstart import stages

__all__ = ["Mesh", "make_mesh", "every_device", "ShardedMatcher",
           "match_sharded", "merge_bytes", "mesh_cache_key"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device mesh, the counterpart of ``jax.sharding.Mesh``: the devices
    in row-major order over axes ``axis_names`` of sizes ``axis_sizes``.
    Without a ``world`` every position holds the same device (several
    shards on one card, one process); with one, position ``i`` is rank
    ``i``'s, on ``world.devices[i]``."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    world: Optional[World] = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axis names {self.axis_names} and sizes "
                             f"{self.axis_sizes} differ in length")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")
        if len(self.devices) != math.prod(self.axis_sizes):
            raise ValueError(
                f"a mesh of shape {self.axis_sizes} needs "
                f"{math.prod(self.axis_sizes)} devices, got "
                f"{len(self.devices)} (several shards on one device: "
                f"devices=[device] * n)")
        if self.world is not None:
            if tuple(self.devices) != tuple(self.world.devices):
                raise ValueError(
                    f"a mesh over a world of {self.world.size} ranks puts "
                    f"position i on rank i's device {self.world.devices}, "
                    f"not on {self.devices}")
            return
        distinct = sorted({str(d) for d in self.devices})
        if len(distinct) > 1:
            raise ValueError(
                f"a mesh over several devices ({', '.join(distinct)}) needs "
                f"a torch.distributed world of as many ranks, position i "
                f"rank i's: call repro_torch.distributed.init_world (or run "
                f"through run_world) first, or put every shard on one "
                f"device")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The one device every shard sits on; over a world, this rank's."""
        if self.world is not None:
            return self.world.device
        return self.devices[0]


def every_device(device=None) -> list:
    """The devices of a default mesh: ``[device]`` where one is named,
    else every CUDA card (raising, as every entry point does, where there
    is none)."""
    if device is not None:
        return [resolve_device(device)]
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str],
              devices: Optional[Sequence] = None, *, device=None,
              world: Optional[World] = None) -> Mesh:
    """The counterpart of ``jax.make_mesh``: a mesh of shape
    ``axis_shapes`` over ``devices`` (one a position, repeats allowed: one
    process; None: :func:`every_device` of ``device``).  Over the ranks of
    ``world``, or of the current world where neither ``devices`` nor
    ``device`` is given, or where ``devices`` are distinct and a world of
    as many ranks is current: position ``i`` is rank ``i``'s."""
    cur = current_world()
    if world is None and cur is not None and (
            (devices is None and device is None) or (
                devices is not None and len(set(map(str, devices))) > 1
                and len(devices) == cur.size)):
        world = cur
    if devices is None:
        devices = world.devices if world is not None else \
            every_device(device)
    return Mesh(devices=tuple(_device_key(d) for d in devices),
                axis_names=tuple(axis_names),
                axis_sizes=tuple(int(n) for n in axis_shapes), world=world)


def merge_bytes(ndev: int, nr: int) -> float:
    """Bytes a ring all-reduce of one level's ``(nr+1,)`` int32 winners
    moves per link over ``ndev`` shards: ``2 (ndev-1)/ndev * 4 (nr+1)``,
    the reference's price of its one ``pmin`` a level."""
    return 2 * (ndev - 1) / ndev * 4 * (nr + 1)


class ShardedMatcher(Matcher):
    """A paper variant + warm start, one cached program per (size bucket,
    mesh, axis).

    >>> mesh = make_mesh((4,), ("data",), devices=["cuda:0"] * 4)
    >>> m = ShardedMatcher(mesh, config=MatcherConfig(algo="apfb"),
    ...                    warm_start="cheap")
    >>> state = m.run(TorchCSR.from_host(g).shard(mesh, "data"))
    >>> int(state.cardinality)          # == single-device Matcher.run

    ``init``, ``solve`` and the state checks are the single-device
    matcher's; ``run`` is the sharded program (over a world's mesh, called
    on every rank with the host graph, the whole uploaded graph, or a
    rank's shard where no warm start or degrade round needs the whole);
    ``run_many`` is refused.
    ``last_counts`` adds ``merges`` (one a level) and ``merge_bytes``
    (:func:`merge_bytes` a merge).
    """

    def __init__(self, mesh: Mesh, axis: str = "data",
                 config: MatcherConfig = MatcherConfig(),
                 warm_start: str = "none"):
        super().__init__(config, warm_start)
        if self.config.adaptive_frontier:
            raise ValueError(
                "adaptive_frontier is single-device only; ShardedMatcher "
                "keeps the dense per-shard sweep + one merge per level "
                "(use MatcherConfig(dirop=True) for a direction heuristic "
                "that composes with sharding)")
        if axis not in mesh.axis_names:
            raise ValueError(f"axis {axis!r} is not in the mesh's axes "
                             f"{mesh.axis_names}")
        self.mesh = mesh
        self.axis = axis
        self._nr = 0

    @property
    def ndev(self) -> int:
        return int(self.mesh.shape[self.axis])

    @property
    def last_counts(self) -> Optional[dict]:
        counts = super().last_counts
        if counts is not None and "merge_bytes" not in counts:
            counts["merge_bytes"] = counts["merges"] * merge_bytes(
                self.ndev, self._nr)
        return counts

    def run(self, graph, state: Optional[MatchState] = None
            ) -> MatchState:
        """Maximum matching with the edges sharded over the mesh axis.

        ``graph`` is re-sharded if needed (:meth:`TorchCSR.shard` is a
        no-op on a graph already sharded so).  Over a world's mesh it may
        also be the host graph (a :class:`repro_torch.core.csr.
        BipartiteCSR`), of which each rank uploads its shard alone
        (:meth:`TorchCSR.from_host_shard`).  ``state=None``: warm start
        and solve in one entry; an explicit state resumes the solver from
        it."""
        world = self.mesh.world
        if not isinstance(graph, TorchCSR):
            if world is None:
                raise ValueError("ShardedMatcher.run takes a host graph over "
                                 "a world's mesh only; upload it with "
                                 "TorchCSR.from_host")
        elif graph.batch_shape:
            raise ValueError("ShardedMatcher.run takes a single "
                             "(edge-sharded) graph")
        elif self.config.dirop and not graph.has_csc:
            raise ValueError(
                "MatcherConfig(dirop=True) needs the CSC mirror; call "
                "graph.with_csc() before .shard(): the mirror shards with "
                "the graph")
        self._nr = int(graph.nr)
        entry = ("sharded_run",) + mesh_cache_key(self.mesh, self.axis)
        if world is None:
            graph = graph.shard(self.mesh, self.axis)
            return self._run(graph, state, entry, self.ndev)
        return self._run_world(graph, state, entry, world)

    def _run_world(self, graph, state: Optional[MatchState], entry,
                   world: World) -> MatchState:
        """``run`` over the ranks of ``world`` (module doc): the warm start
        and the ``degrade_maximal`` round on rank 0 over the whole graph,
        broadcast; the solve over this rank's shard.  From a host graph
        the whole edge list reaches rank 0's device only while one of
        those runs, and no other rank's."""
        warm = state is None and bool(stages(self.warm_start))
        degrade = self.config.degrade_maximal and self.config.max_phases > 0
        if isinstance(graph, TorchCSR):
            if graph.rank_shard and (warm or degrade):
                raise ValueError(
                    "the warm start and the degrade_maximal round run over "
                    "the whole edge list on rank 0: pass the whole graph "
                    "(run shards it), or a state with warm_start=\"none\"")
            whole = graph.to(world.device)
            upload = lambda: whole                              # noqa: E731
        else:
            host = graph
            upload = lambda: TorchCSR.from_host(                # noqa: E731
                host, device=world.device)
        if warm:
            state = self._rank0(upload, graph, None,
                                Matcher(warm_start=self.warm_start), world)
        if isinstance(graph, TorchCSR):
            shard = graph.shard(self.mesh, self.axis)
        else:
            shard = TorchCSR.from_host_shard(graph, self.mesh, self.axis,
                                             csc=self.config.dirop)
        out = self._run(shard, state, entry, self.ndev, world)
        if degrade and not bool(out.certified):
            out = self._rank0(upload, graph, out,
                              Matcher(warm_start="cheap"), world)
        return out

    @staticmethod
    def _rank0(upload, graph, state: Optional[MatchState], init: Matcher,
               world: World) -> MatchState:
        """``init.init(upload(), state)`` on rank 0 (``upload()``: the
        whole graph on its device), its matching broadcast to every rank
        (the other ranks keep ``state``'s counts, equal to rank 0's)."""
        if world.rank == 0:
            out = init.init(upload(), state)
        else:
            dev = world.device
            i32 = torch.int32
            zero = torch.zeros((), dtype=i32, device=dev)
            out = state if state is not None else MatchState(
                cmatch=zero, rmatch=zero, phases=zero, fallbacks=zero,
                certified=zero.bool())
            out = dataclasses.replace(
                out, cmatch=torch.empty(int(graph.nc) + 1, dtype=i32,
                                        device=dev),
                rmatch=torch.empty(int(graph.nr) + 1, dtype=i32, device=dev))
        broadcast_(out.cmatch, 0, world)
        broadcast_(out.rmatch, 0, world)
        return out

    def run_many(self, graphs, states=None):
        raise NotImplementedError(
            "ShardedMatcher shards edges over the mesh; batch with "
            "Matcher.run_many or one ShardedMatcher call per graph")

    def stats(self, state: MatchState) -> MatchStats:
        return MatchStats.of(state,
                             f"sharded-{self.config.name}@{self.ndev}")


def match_sharded(graph: TorchCSR, mesh: Mesh, axis: str = "data",
                  config: MatcherConfig = MatcherConfig(),
                  warm_start: str = "cheap",
                  state: Optional[MatchState] = None) -> MatchState:
    """Functional alias: ``ShardedMatcher(mesh, axis, config, ws).run(...)``."""
    return ShardedMatcher(mesh, axis, config, warm_start).run(graph, state)
