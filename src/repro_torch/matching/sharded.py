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

One controller drives the mesh, as JAX does.  A :class:`Mesh` names its
devices, which may repeat: ``make_mesh((4,), ("data",), devices=["cuda:0"]
* 4)`` puts four shards on one card (the counterpart of the reference's
forced four-device host).  Then the D sweeps and the merge run inside the
level step, captured into the level's CUDA graph under the same WHILE node
as the single-device level, so a sharded solve makes the same host syncs.
A mesh over several distinct devices needs ``torch.distributed`` (one
``all_reduce(MIN)`` of the winners a level) and is refused
(ROADMAP.md, Queue 1, item 13).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch._device import resolve_device

from .api import Matcher
from .cache import mesh_cache_key
from .config import MatcherConfig
from .device_csr import TorchCSR
from .solve import _device_key
from .state import MatchState, MatchStats

MESH_ITEM = "ROADMAP.md, Queue 1, item 13"

__all__ = ["Mesh", "make_mesh", "every_device", "ShardedMatcher",
           "match_sharded", "merge_bytes", "mesh_cache_key"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device mesh, the counterpart of ``jax.sharding.Mesh``: the devices
    in row-major order over axes ``axis_names`` of sizes ``axis_sizes``.
    Every position may hold the same device (several shards on one card);
    positions on distinct devices are refused."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

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
        distinct = sorted({str(d) for d in self.devices})
        if len(distinct) > 1:
            raise NotImplementedError(
                f"a mesh over several devices ({', '.join(distinct)}) "
                f"needs torch.distributed, one all_reduce(MIN) of the "
                f"winners a level ({MESH_ITEM}); put every shard on one "
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
        """The one device every shard sits on."""
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
              devices: Optional[Sequence] = None, *, device=None) -> Mesh:
    """The counterpart of ``jax.make_mesh``: a mesh of shape
    ``axis_shapes`` over ``devices`` (one a position, repeats allowed;
    None: :func:`every_device` of ``device``)."""
    if devices is None:
        devices = every_device(device)
    return Mesh(devices=tuple(_device_key(d) for d in devices),
                axis_names=tuple(axis_names),
                axis_sizes=tuple(int(n) for n in axis_shapes))


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
    matcher's; ``run`` is the sharded program; ``run_many`` is refused.
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

    def run(self, graph: TorchCSR, state: Optional[MatchState] = None
            ) -> MatchState:
        """Maximum matching with the edges sharded over the mesh axis.

        ``graph`` is re-sharded if needed (:meth:`TorchCSR.shard` is a
        no-op on a graph already sharded so).  ``state=None``: warm start
        and solve in one entry; an explicit state resumes the solver from
        it."""
        if graph.batch_shape:
            raise ValueError("ShardedMatcher.run takes a single "
                             "(edge-sharded) graph")
        if self.config.dirop and not graph.has_csc:
            raise ValueError(
                "MatcherConfig(dirop=True) needs the CSC mirror; call "
                "graph.with_csc() before .shard(): the mirror shards with "
                "the graph")
        graph = graph.shard(self.mesh, self.axis)
        self._nr = graph.nr
        entry = ("sharded_run",) + mesh_cache_key(self.mesh, self.axis)
        return self._run(graph, state, entry, self.ndev)

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
