"""Admission control: map raw incoming graphs onto declared size buckets.

A serving deployment cannot afford one compiled program per arriving shape:
every novel ``(nc, nr, nnz_pad)`` would pay a build and CUDA-graph capture
on the request path and eventually thrash the compile cache.  The
bucketizer declares a finite grid of :class:`SizeBucket` shapes up front
(the same grid the warm-up in :mod:`repro_torch.serving.warmup` captures),
places each incoming graph in the smallest declared bucket that fits,
padding vertices (:meth:`TorchCSR.pad_vertices`) and edges with inert
sentinels, and accounts the padding waste per admission.  A graph that fits
no bucket is rejected with the typed :class:`OversizeGraphError`, so the
caller can tell admission failure from solver failure, unless
``oversize="shard"``: then it is admitted whole (its edge capacity bucketed,
no vertex padding) with ``route="sharded"`` and ``bucket=None``, for the
service's edge-sharded lane (``MatchingService(mesh=...)``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core.csr import BipartiteCSR
from repro_torch.matching.device_csr import (LANE, GraphValidationError,
                                             TorchCSR, bucket_nnz,
                                             validate_structure)


class OversizeGraphError(ValueError):
    """Typed admission rejection: the graph fits no declared bucket."""

    def __init__(self, nc: int, nr: int, nnz: int, largest: "SizeBucket"):
        self.nc, self.nr, self.nnz = nc, nr, nnz
        self.largest = largest
        super().__init__(
            f"graph ({nc}x{nr}, {nnz} edges) fits no declared bucket; "
            f"largest is ({largest.nc}x{largest.nr}, {largest.nnz_pad} edge "
            f"slots) — enlarge the ladder, or serve oversize graphs on the "
            f"sharded lane (Bucketizer(oversize='shard') and "
            f"MatchingService(mesh=...))")


@dataclasses.dataclass(frozen=True, order=True)
class SizeBucket:
    """One declared compiled shape: (nc, nr, edge capacity)."""

    nc: int
    nr: int
    nnz_pad: int

    def fits(self, nc: int, nr: int, nnz: int) -> bool:
        return nc <= self.nc and nr <= self.nr and nnz <= self.nnz_pad

    @property
    def cost(self) -> int:
        """Padded footprint in int32 words — the order buckets are tried in."""
        return 2 * self.nnz_pad + self.nc + self.nr

    @property
    def key(self) -> Tuple[int, int, int]:
        return (self.nc, self.nr, self.nnz_pad)


def ladder(max_vertices: int = 4096, min_vertices: int = 256,
           edge_factor: int = 8, lane: int = LANE) -> Tuple[SizeBucket, ...]:
    """Geometric default grid: square ``(v, v)`` buckets, doubling ``v`` from
    ``min_vertices`` to ``max_vertices``, each holding ``v * edge_factor``
    edges (rounded to the canonical power-of-two capacity)."""
    assert min_vertices <= max_vertices, (min_vertices, max_vertices)
    out, v = [], min_vertices
    while v <= max_vertices:
        out.append(SizeBucket(v, v, bucket_nnz(v * edge_factor, lane)))
        v *= 2
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Admission:
    """One admitted request: the bucket-shaped device graph + accounting."""

    graph: TorchCSR
    bucket: Optional[SizeBucket]
    route: str                        # "bucket" | "sharded"
    nc: int                           # true sizes of the submitted graph
    nr: int
    nnz: int

    @property
    def pad_edges(self) -> int:
        """Wasted edge slots this admission pays for."""
        return self.graph.nnz_pad - self.nnz

    @property
    def pad_vertex_slots(self) -> int:
        """Wasted vertex slots (isolated padding columns + rows)."""
        return (self.graph.nc - self.nc) + (self.graph.nr - self.nr)


def _pad_host_vertices(g: BipartiteCSR, nc: int, nr: int,
                       nnz_pad: int) -> BipartiteCSR:
    """Host-side vertex+edge padding in one rebuild (extra columns have an
    empty CSR segment; sentinels take the new ``nc``/``nr``)."""
    cxadj = g.cxadj
    if nc > g.nc:
        cxadj = np.concatenate(
            [cxadj, np.full(nc - g.nc, g.nnz, np.int32)])
    return BipartiteCSR.from_csr(cxadj, g.cadj[: g.nnz], nc, nr,
                                 pad_to=nnz_pad)


class Bucketizer:
    """Maps raw graphs onto the declared bucket grid.

    ``buckets`` default to :func:`ladder`.  A graph that fits no bucket
    raises :class:`OversizeGraphError` under ``oversize="reject"``, and
    under ``oversize="shard"`` is admitted whole for the sharded lane
    (``route="sharded"``, ``bucket=None``).  ``build_csc`` attaches the CSC mirror
    (:meth:`TorchCSR.with_csc`) to every admitted graph, which the
    direction-optimizing configs need; the service asks for it per
    admission when the request's config needs it.  ``validate`` checks the
    structural invariants (:func:`repro_torch.matching.validate_structure`)
    of every admission and raises the typed
    :class:`~repro_torch.matching.GraphValidationError` on malformed input.
    ``device``: where admitted graphs are uploaded (None: the CUDA card).
    """

    def __init__(self, buckets: Optional[Sequence[SizeBucket]] = None,
                 oversize: str = "reject", build_csc: bool = False,
                 validate: bool = False, device=None):
        assert oversize in ("reject", "shard"), oversize
        bs = tuple(sorted(buckets if buckets is not None else ladder(),
                          key=lambda b: b.cost))
        assert bs, "need at least one declared bucket"
        self.buckets = bs
        self.oversize = oversize
        self.build_csc = build_csc
        self.validate = validate
        self.device = resolve_device(device)

    def bucket_for(self, nc: int, nr: int, nnz: int) -> Optional[SizeBucket]:
        """Smallest (by padded footprint) declared bucket that fits."""
        for b in self.buckets:
            if b.fits(nc, nr, nnz):
                return b
        return None

    def admit(self, graph: Union[BipartiteCSR, TorchCSR],
              csc: Optional[bool] = None) -> Admission:
        """Place ``graph`` in a bucket (pad + upload) or reject it.

        Accepts the host container or an uploaded single ``TorchCSR`` (on
        this bucketizer's device; its padded edges must sit at the tail, as
        every constructor lays them out).  ``csc`` overrides ``build_csc``
        per admission (the service passes ``config.dirop``); the mirror is
        built on the bucket-shaped graph, so it pads and stacks with it.
        """
        csc = self.build_csc if csc is None else csc
        if isinstance(graph, BipartiteCSR):
            nc, nr, nnz = graph.nc, graph.nr, graph.nnz
        elif isinstance(graph, TorchCSR):
            if graph.batch_shape:
                raise ValueError("admit() takes a single graph")
            if graph.device != self.device:
                raise ValueError(f"graph on {graph.device}, the bucketizer "
                                 f"serves {self.device}")
            # a mirror would not survive the bucket reshaping below; it is
            # rebuilt on the bucket-shaped graph
            graph = graph.drop_csc()
            nc, nr, nnz = graph.nc, graph.nr, int(graph.nnz)
        else:
            raise TypeError(
                f"admit() takes BipartiteCSR or TorchCSR, got {type(graph)}"
                " — build edge lists with Bucketizer.from_edges")
        if self.validate:
            # garbage is rejected here, before a kernel reads it or it
            # poisons a whole co-batched dispatch
            if isinstance(graph, BipartiteCSR):
                problems = validate_structure(graph.cxadj, graph.cadj,
                                              graph.ecol, nnz, nc, nr)
                if problems:
                    raise GraphValidationError(problems)
            else:
                graph.validate()
        b = self.bucket_for(nc, nr, nnz)
        if b is None:
            if self.oversize == "reject":
                raise OversizeGraphError(nc, nr, nnz, self.buckets[-1])
            dev = (graph if isinstance(graph, TorchCSR)
                   else TorchCSR.from_host(graph, device=self.device)
                   ).bucketed()
            if csc:
                dev = dev.with_csc()
            return Admission(graph=dev, bucket=None, route="sharded",
                             nc=nc, nr=nr, nnz=nnz)
        if isinstance(graph, BipartiteCSR):
            dev = TorchCSR.from_host(
                _pad_host_vertices(graph, b.nc, b.nr, b.nnz_pad),
                device=self.device)
        else:
            dev = graph.pad_vertices(b.nc, b.nr)
            if dev.nnz_pad > b.nnz_pad:      # over-padded upload: trim tail
                dev = dataclasses.replace(
                    dev, cadj=dev.cadj[: b.nnz_pad].contiguous(),
                    ecol=dev.ecol[: b.nnz_pad].contiguous())
            else:
                dev = dev.pad_to(b.nnz_pad)
        if csc:
            dev = dev.with_csc()
        return Admission(graph=dev, bucket=b, route="bucket",
                         nc=nc, nr=nr, nnz=nnz)

    @staticmethod
    def from_edges(cols, rows, nc: int, nr: int) -> BipartiteCSR:
        """Convenience for raw edge-list requests (dedups, builds CSR)."""
        return BipartiteCSR.from_edges(np.asarray(cols), np.asarray(rows),
                                       nc, nr)
