"""A ``torch.distributed`` world: the ranks a mesh's positions belong to.

The JAX package runs one controller over a mesh (``jax.make_mesh`` over the
devices the multi-process runtime reports).  Here every position of a mesh
over several ranks is a process of its own: rank ``r`` drives position
``r`` on its device, and the ranks meet in collectives (:mod:`.comm`).

:func:`init_world` joins this process to a world of ``size`` ranks:

* each rank sits on card ``rank % device_count()`` (or on the device named,
  ``"cpu"`` for every rank on the CPU);
* the backend is chosen before anything runs, from where the ranks sit:
  ``"nccl"`` when every rank has a card of its own, ``"gloo"`` when ranks
  share a card or run on the CPU (NCCL refuses two ranks on one card);
* ``init_method`` is a store every rank reaches: a ``file://`` path (what
  :func:`~.spawn.run_world` gives, so that no port can collide between test
  workers) or ``tcp://host:port``;
* every world has a ``timeout``: a rank that dies ends its peers'
  collectives with an error after it, never a hang.

A world of ``D x M`` ranks (``mesh=(D, M)``) has two axes, as
``jax.make_mesh((D, M), ("data", "model"))`` has: rank ``r`` sits at data
index ``r // M`` and model index ``r % M``, so the model ranks of one data
group are neighbours.  Each axis is an :class:`Axis` of this rank: its
index, its size and the process group of the ranks along it (every rank
creates every group, in the same order).  ``mesh=None`` is ``(size, 1)``:
the data axis is the whole world.

Under ``torchrun`` call :func:`init_world` with no arguments: it reads
``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` and
``LOCAL_RANK`` (the card of this rank on its host).  As everywhere in the
port, the ranks run on the card unless ``device="cpu"`` is given: without a
card and without it, :func:`init_world` raises.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import os
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch._device import resolve_device

DEFAULT_TIMEOUT = 120.0          # seconds a collective may wait for a peer
_IDS = itertools.count(1)


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of a world's mesh as a rank sees it: its ``name``, this
    rank's index along it (``rank``), its ``size``, the global ranks along
    it (``ranks``) and their process ``group`` (None: the default group,
    where the axis is the whole world).  The collectives of
    :mod:`.comm` take an axis where they take a world."""

    name: str
    rank: int
    size: int
    ranks: Tuple[int, ...]
    group: Any = None


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place in a world: its ``rank`` of ``size``, the
    ``backend``, every rank's device (``devices[r]``), ``ident``, a
    number no other world of this process has had (captured programs and
    cache entries are keyed by it), the ``mesh`` ``(D, M)`` with this
    rank's ``data`` and ``model`` axes, and the ``timeout`` (seconds) a
    collective may wait for a peer."""

    rank: int
    size: int
    backend: str
    devices: Tuple[torch.device, ...]
    ident: int
    mesh: Tuple[int, int]
    data: Axis
    model: Axis
    timeout: float = DEFAULT_TIMEOUT

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        return self.devices[self.rank]

    @property
    def every(self) -> Axis:
        """The whole world as an axis (``"world"``, the default group)."""
        return Axis("world", self.rank, self.size, tuple(range(self.size)))

    def remesh(self, mesh) -> "World":
        """The same ranks as a mesh of another shape ``(D, M)`` (every
        rank calls it: it creates the new axes' groups); the returned
        world, with an ``ident`` of its own, becomes the current one."""
        global _CURRENT
        shape = mesh_shape(self.size, mesh)
        data, model = _axes(self.rank, self.size, shape)
        _CURRENT = dataclasses.replace(self, ident=next(_IDS), mesh=shape,
                                       data=data, model=model)
        return _CURRENT


def mesh_shape(size: int, mesh=None) -> Tuple[int, int]:
    """``(D, M)`` of a world of ``size`` ranks (``mesh`` None: ``(size,
    1)``); raises where ``D * M`` is not ``size``."""
    if mesh is None:
        return (size, 1)
    d, m = (int(x) for x in mesh)
    if d < 1 or m < 1 or d * m != size:
        raise ValueError(f"a mesh of {d} x {m} is not a world of {size} "
                         f"ranks")
    return (d, m)


def _axes(rank: int, size: int, mesh: Tuple[int, int]) -> Tuple[Axis, Axis]:
    """This rank's data and model axes; every rank creates every group of
    an axis that is neither one rank nor the whole world, data groups
    first, in the same order."""
    d, m = mesh
    lines = {"data": [tuple(j * m + i for j in range(d)) for i in range(m)],
             "model": [tuple(j * m + i for i in range(m)) for j in range(d)]}
    out = []
    for name in ("data", "model"):
        mine, group = None, None
        for ranks in lines[name]:
            g = None
            if 1 < len(ranks) < size:
                g = dist.new_group(ranks=list(ranks))
            if rank in ranks:
                mine, group = ranks, g
        out.append(Axis(name, mine.index(rank), len(mine), mine, group))
    return out[0], out[1]


_CURRENT: Optional[World] = None


def current_world() -> Optional[World]:
    """The world this process has joined (None: none)."""
    return _CURRENT


def rank_devices(size: int, device=None) -> Tuple[torch.device, ...]:
    """Every rank's device: rank ``r`` on card ``r % device_count()``, or
    on ``device`` where one is named (a card index in it is rank 0's; the
    ranks after it take the next cards, round the host)."""
    if device is None:
        resolve_device(None)                # raises without a card
        n = torch.cuda.device_count()
        return tuple(torch.device("cuda", r % n) for r in range(size))
    device = torch.device(device)
    if device.type != "cuda":
        return (device,) * size
    n = torch.cuda.device_count()
    first = device.index if device.index is not None else 0
    return tuple(torch.device("cuda", (first + r) % n) for r in range(size))


def choose_backend(devices) -> str:
    """``"nccl"`` when every rank has a card of its own, else ``"gloo"``."""
    devices = tuple(devices)
    if all(d.type == "cuda" for d in devices) and \
            len(set(devices)) == len(devices):
        return "nccl"
    return "gloo"


def _torchrun_rank() -> Tuple[int, int]:
    """(rank, size) from torchrun's environment."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                           "MASTER_PORT") if k not in os.environ]
    if missing:
        raise ValueError(f"init_world() with no rank reads torchrun's "
                         f"environment; {', '.join(missing)} not set")
    return int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])


def _torchrun() -> Tuple[int, int, Tuple[torch.device, ...], str]:
    """(rank, size, every rank's device, the backend) from torchrun's
    environment, on the cards: ``LOCAL_RANK`` is this rank's card on its
    host, and each rank has a card of its own (NCCL) when a host's ranks
    (``LOCAL_WORLD_SIZE``) fit its cards."""
    rank, size = _torchrun_rank()
    resolve_device(None)                    # raises without a card
    n = torch.cuda.device_count()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", size))
    devices = tuple(torch.device("cuda", (r % local) % n)
                    for r in range(size))
    return rank, size, devices, "nccl" if local <= n else "gloo"


def init_world(rank: Optional[int] = None, size: Optional[int] = None,
               init_method: Optional[str] = None, device=None,
               timeout: float = DEFAULT_TIMEOUT, mesh=None) -> World:
    """Join this process to a world as ``rank`` of ``size`` (module doc);
    ``rank=None``: torchrun's environment; ``mesh``: ``(D, M)`` with ``D *
    M = size`` (None: ``(size, 1)``).  Returns the :class:`World`, also
    :func:`current_world` until :func:`close_world`."""
    global _CURRENT
    if _CURRENT is not None:
        raise RuntimeError(f"this process is already rank {_CURRENT.rank} of "
                           f"a world of {_CURRENT.size}; close_world() first")
    if rank is None:
        if device is None:
            rank, size, devices, backend = _torchrun()
        else:
            rank, size = _torchrun_rank()
            devices = rank_devices(size, device)
            backend = choose_backend(devices)
        init_method = init_method or "env://"
    else:
        if size is None or init_method is None:
            raise ValueError("init_world needs rank, size and init_method "
                             "(or torchrun's environment)")
        devices = rank_devices(size, device)
        backend = choose_backend(devices)
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} is not in a world of {size}")
    shape = mesh_shape(size, mesh)
    mine = devices[rank]
    if mine.type == "cuda":
        torch.cuda.set_device(mine)
    kw = {"device_id": mine} if backend == "nccl" else {}
    dist.init_process_group(
        backend, init_method=init_method, world_size=size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout), **kw)
    data, model = _axes(rank, size, shape)
    _CURRENT = World(rank=rank, size=size, backend=backend, devices=devices,
                     ident=next(_IDS), mesh=shape, data=data, model=model,
                     timeout=float(timeout))
    return _CURRENT


def init_dry_world(rank: int, mesh) -> World:
    """Join this process to a dry world as ``rank`` of a mesh ``(D, M)``:
    a world that moves nothing.  Every rank's device is ``meta``, so
    tensors have shapes and no storage, and the axes' groups belong to
    torch's fake process group (``torch.testing._internal.distributed.
    fake_pg``), whose collectives return at once.  So one process traces
    one rank of a world of any size (the dry run, :mod:`repro_torch.
    launch.dryrun`): every :mod:`.comm` op counts its calls and bytes as
    on a real world and moves nothing.  Asked for by name only;
    :func:`init_world` never picks it.  Close it with :func:`close_world`
    (in a ``finally``: a process has one default group)."""
    global _CURRENT
    if _CURRENT is not None or dist.is_initialized():
        raise RuntimeError("init_dry_world: this process is already in a "
                           "world; close_world() first")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape = tuple(int(x) for x in mesh)
    size = shape[0] * shape[1]
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} is not in a world of {size}")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=size)
    data, model = _axes(rank, size, mesh_shape(size, shape))
    _CURRENT = World(rank=rank, size=size, backend="fake",
                     devices=(torch.device("meta"),) * size,
                     ident=next(_IDS), mesh=shape, data=data, model=model)
    return _CURRENT


def close_world() -> None:
    """Leave the current world (a no-op without one)."""
    global _CURRENT
    if _CURRENT is None:
        return
    _CURRENT = None
    if dist.is_initialized():
        dist.destroy_process_group()


def require_world(world: Optional[World] = None) -> World:
    """``world``, else the current one; raises without either."""
    world = world or _CURRENT
    if world is None:
        raise ValueError("no torch.distributed world: call "
                         "repro_torch.distributed.init_world (or run the "
                         "function through run_world) first")
    return world
