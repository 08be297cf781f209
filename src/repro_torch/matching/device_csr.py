"""Device-resident bipartite CSR graph: int32 tensors on one device.

``TorchCSR`` holds the same arrays as the host :class:`repro_torch.core.csr.
BipartiteCSR` (``cxadj`` (nc+1,), ``cadj``/``ecol`` (nnz_pad,), sentinel
``nr``/``nc`` in the padding) as int32 tensors on the device the solver runs
on, the CUDA card unless the caller names another.  Values, padding and the
size-bucket rule (:func:`bucket_nnz`) are those of the JAX package's
``DeviceCSR``, so one instance pads to the same shapes in both packages.
So is the optional CSC mirror of :meth:`TorchCSR.with_csc`, which the
direction-optimizing solver pulls over.

A batch of graphs of one size bucket (:meth:`TorchCSR.stack`, what
``Matcher.run_many`` takes) carries one leading lane dimension on every
array and a true edge count per lane.  An edge-sharded graph
(:meth:`TorchCSR.shard`, what ``ShardedMatcher.run`` takes) keeps one edge
list, padded so that it cuts into ``D`` equal power-of-two shards, and
records the mesh and axis it was cut for.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch._device import DEVICE_LOCK, resolve_device

if TYPE_CHECKING:  # a runtime import would be circular (core imports matching)
    from repro_torch.core.csr import BipartiteCSR

LANE = 128  # every edge capacity is a multiple of this


class GraphValidationError(ValueError):
    """A graph's CSR arrays violate the structural invariants every kernel
    assumes (monotone offsets, in-range endpoints, sentinel tail discipline).

    Raised by :meth:`TorchCSR.validate` so a malformed or adversarial graph
    is rejected before a kernel reads it.  ``problems`` keeps
    the full finding list; ``str()`` shows them all.
    """

    def __init__(self, problems: Sequence[str]):
        self.problems = tuple(problems)
        super().__init__("invalid bipartite CSR: " + "; ".join(self.problems))


def validate_structure(cxadj: np.ndarray, cadj: np.ndarray, ecol: np.ndarray,
                       nnz: int, nc: int, nr: int) -> Tuple[str, ...]:
    """Structural findings for one graph's host-side CSR arrays (empty tuple
    = valid).  The checks mirror what the kernels silently assume:

    * ``cxadj`` is (nc+1,), starts at 0, is monotone nondecreasing and ends
      at the true edge count ``nnz`` (<= the padded capacity);
    * real edge slots carry in-range endpoints (``cadj`` row ids < nr,
      ``ecol`` column ids < nc) and ``ecol`` agrees with the offsets (edge
      slot ``e`` of column ``c`` has ``ecol[e] == c``);
    * padding slots carry the inert sentinels ``cadj = nr`` / ``ecol = nc``
      — a padding edge with a real endpoint would propose phantom matches.

    On a CUDA tensor an out-of-range id reads or writes out of bounds; on
    the CPU it raises inside the solver.  Run this on untrusted graphs
    before upload.
    """
    problems = []
    cxadj = np.asarray(cxadj)
    cadj = np.asarray(cadj)
    ecol = np.asarray(ecol)
    nnz_pad = int(cadj.shape[-1])
    if cxadj.shape != (nc + 1,):
        return (f"cxadj shape {cxadj.shape} != ({nc + 1},)",)
    if ecol.shape != cadj.shape:
        return (f"ecol shape {ecol.shape} != cadj shape {cadj.shape}",)
    if not (0 <= nnz <= nnz_pad):
        return (f"nnz {nnz} outside [0, nnz_pad={nnz_pad}]",)
    if cxadj[0] != 0:
        problems.append(f"cxadj[0] = {int(cxadj[0])} != 0")
    if np.any(np.diff(cxadj) < 0):
        bad = int(np.argmax(np.diff(cxadj) < 0))
        problems.append(f"cxadj not monotone at column {bad}")
    elif cxadj[-1] != nnz:
        problems.append(f"cxadj[-1] = {int(cxadj[-1])} != nnz {nnz}")
    real_r, real_c = cadj[:nnz], ecol[:nnz]
    if np.any((real_r < 0) | (real_r >= nr)):
        bad = int(np.argmax((real_r < 0) | (real_r >= nr)))
        problems.append(
            f"cadj[{bad}] = {int(real_r[bad])} outside rows [0, {nr})")
    if np.any((real_c < 0) | (real_c >= nc)):
        bad = int(np.argmax((real_c < 0) | (real_c >= nc)))
        problems.append(
            f"ecol[{bad}] = {int(real_c[bad])} outside columns [0, {nc})")
    elif not problems and cxadj[-1] == nnz:
        want = np.repeat(np.arange(nc, dtype=ecol.dtype), np.diff(cxadj))
        if not np.array_equal(real_c, want):
            bad = int(np.argmax(real_c != want))
            problems.append(
                f"ecol[{bad}] = {int(real_c[bad])} disagrees with cxadj "
                f"(expected column {int(want[bad])})")
    if np.any(cadj[nnz:] != nr):
        bad = nnz + int(np.argmax(cadj[nnz:] != nr))
        problems.append(
            f"padding cadj[{bad}] = {int(cadj[bad])} != sentinel {nr}")
    if np.any(ecol[nnz:] != nc):
        bad = nnz + int(np.argmax(ecol[nnz:] != nc))
        problems.append(
            f"padding ecol[{bad}] = {int(ecol[bad])} != sentinel {nc}")
    return tuple(problems)


def bucket_nnz(nnz: int, lane: int = LANE) -> int:
    """Smallest power-of-two multiple of ``lane`` holding ``nnz`` edges."""
    cap = lane
    while cap < nnz:
        cap *= 2
    return cap


def per_shard_nnz(nnz_pad: int, ndev: int, lane: int = LANE) -> int:
    """Per-shard edge capacity when sharding ``nnz_pad`` edges over ``ndev``
    shards: each shard is itself a canonical bucket."""
    return bucket_nnz(-(-nnz_pad // ndev), lane)


def _full(shape, value: int, device) -> torch.Tensor:
    return torch.full(shape if isinstance(shape, tuple) else (shape,), value,
                      dtype=torch.int32, device=device)


@dataclasses.dataclass(frozen=True)
class TorchCSR:
    """Column-major CSR bipartite graph on one device.

    ``cxadj`` (nc+1,), ``cadj``/``ecol`` (nnz_pad,) int32 tensors on the
    same device; ``nnz`` (the true edge count), ``nc`` and ``nr`` are
    Python ints, so reading them costs no device sync.  A stacked batch
    (:meth:`stack`) has a leading lane dimension on every array and
    ``nnz`` a tuple of Python ints, one a lane.

    Optional CSC mirror (all present or all ``None``, see :meth:`with_csc`):
    ``rxadj`` (nr+1,) row offsets into the row-sorted edge list,
    ``radj``/``erow`` (nnz_pad,) column/row endpoints in row-sorted order,
    ``eperm`` (nnz_pad,) the CSR position of each row-sorted edge.  The
    sentinels are those of the CSR side (``radj = nc``, ``erow = nr``).

    ``mesh``/``axis``: set by :meth:`shard` (the mesh and axis the edge
    list is cut for), else None.
    """

    cxadj: torch.Tensor
    cadj: torch.Tensor
    ecol: torch.Tensor
    nnz: Union[int, Tuple[int, ...]]
    nc: int
    nr: int
    rxadj: Optional[torch.Tensor] = None
    radj: Optional[torch.Tensor] = None
    erow: Optional[torch.Tensor] = None
    eperm: Optional[torch.Tensor] = None
    mesh: Optional[object] = None
    axis: Optional[str] = None

    @property
    def nnz_pad(self) -> int:
        return int(self.cadj.shape[-1])

    @property
    def device(self) -> torch.device:
        return self.cadj.device

    @property
    def has_csc(self) -> bool:
        return self.rxadj is not None

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        """``()`` for one graph, ``(B,)`` for a stacked batch."""
        return tuple(self.cadj.shape[:-1])

    @property
    def bucket_key(self) -> Tuple:
        """The size bucket: (*batch, nc, nr, nnz_pad), and ``"csc"`` when
        the mirror is attached (the JAX package's key, so both agree)."""
        key = self.batch_shape + (self.nc, self.nr, self.nnz_pad)
        return key + ("csc",) if self.has_csc else key

    def _single(self, what: str) -> None:
        if self.batch_shape:
            raise ValueError(f"{what} takes a single graph; unstack() a "
                             f"batched TorchCSR first")

    # -- host <-> device ------------------------------------------------------
    @classmethod
    def from_host(cls, g: "BipartiteCSR", pad_to: Optional[int] = None,
                  device=None) -> "TorchCSR":
        """Upload a host graph, optionally repadding the edge capacity.

        ``g`` is taken by its fields (``nc``, ``nr``, ``nnz``, ``cxadj``,
        ``cadj``, ``ecol``), so either package's host container works.
        ``device=None`` is the CUDA card, and raises where there is none.
        """
        dev = resolve_device(device)
        cadj, ecol = g.cadj, g.ecol
        if pad_to is not None and pad_to != int(np.shape(g.cadj)[0]):
            assert pad_to >= g.nnz, (pad_to, g.nnz)
            cadj = np.full(pad_to, g.nr, np.int32)
            ecol = np.full(pad_to, g.nc, np.int32)
            cadj[: g.nnz] = g.cadj[: g.nnz]
            ecol[: g.nnz] = g.ecol[: g.nnz]

        def put(x):
            return torch.from_numpy(
                np.ascontiguousarray(x, dtype=np.int32)).to(dev)

        with DEVICE_LOCK:         # never inside another thread's capture
            return cls(cxadj=put(g.cxadj), cadj=put(cadj), ecol=put(ecol),
                       nnz=int(g.nnz), nc=int(g.nc), nr=int(g.nr))

    def validate(self) -> "TorchCSR":
        """Check the structural invariants (one host copy); returns ``self``
        so it chains, raises :class:`GraphValidationError` otherwise."""
        self._single("validate()")
        problems = validate_structure(self.cxadj.cpu().numpy(),
                                      self.cadj.cpu().numpy(),
                                      self.ecol.cpu().numpy(),
                                      self.nnz, self.nc, self.nr)
        if problems:
            raise GraphValidationError(problems)
        return self

    def to_host(self) -> "BipartiteCSR":
        """Copy back to the numpy container."""
        from repro_torch.core.csr import BipartiteCSR
        self._single("to_host()")
        return BipartiteCSR(nc=self.nc, nr=self.nr, nnz=self.nnz,
                            cxadj=self.cxadj.cpu().numpy(),
                            cadj=self.cadj.cpu().numpy(),
                            ecol=self.ecol.cpu().numpy())

    # -- the CSC mirror -------------------------------------------------------
    def with_csc(self) -> "TorchCSR":
        """Attach the row-major mirror (no-op if already present).

        One stable sort of the edge list by row: padding edges carry
        ``cadj = nr``, so they sort to the tail and stay inert sentinels in
        the mirror too (``radj = nc``, ``erow = nr``).  ``rxadj[r]`` is the
        first row-sorted slot of row ``r`` and ``rxadj[nr]`` the true edge
        count; ``eperm`` maps each row-sorted slot back to its CSR position
        (identity on the sentinel tail).
        """
        if self.has_csc:
            return self
        if self.batch_shape:
            raise ValueError("with_csc() takes a single graph; build the "
                             "mirror before stack()")
        with DEVICE_LOCK:         # never inside another thread's capture
            order = torch.argsort(self.cadj, stable=True)
            erow = self.cadj.index_select(0, order)
            rxadj = torch.searchsorted(
                erow, torch.arange(self.nr + 1, dtype=torch.int32,
                                   device=self.device), out_int32=True)
            return dataclasses.replace(
                self, rxadj=rxadj, radj=self.ecol.index_select(0, order),
                erow=erow, eperm=order.to(torch.int32))

    def drop_csc(self) -> "TorchCSR":
        """Return the bare graph (the mirror removed)."""
        return dataclasses.replace(self, rxadj=None, radj=None, erow=None,
                                   eperm=None)

    # -- bucketing ------------------------------------------------------------
    def pad_to(self, nnz_pad: int) -> "TorchCSR":
        """Grow the edge capacity on device (sentinel-fill the new slots)."""
        cur = self.nnz_pad
        if nnz_pad == cur:
            return self
        assert nnz_pad > cur, f"cannot shrink edge capacity {cur} -> {nnz_pad}"
        extra = self.batch_shape + (nnz_pad - cur,)
        dev = self.device
        g = dataclasses.replace(
            self,
            cadj=torch.cat([self.cadj, _full(extra, self.nr, dev)], dim=-1),
            ecol=torch.cat([self.ecol, _full(extra, self.nc, dev)], dim=-1))
        if self.has_csc:
            # mirror sentinels live at the tail too; the new slots map to
            # the new CSR tail slots (identity), so eperm stays a permutation
            tail = torch.arange(cur, nnz_pad, dtype=torch.int32,
                                device=dev).expand(extra)
            g = dataclasses.replace(
                g,
                radj=torch.cat([self.radj, _full(extra, self.nc, dev)],
                               dim=-1),
                erow=torch.cat([self.erow, _full(extra, self.nr, dev)],
                               dim=-1),
                eperm=torch.cat([self.eperm, tail], dim=-1))
        return g

    def bucketed(self, lane: int = LANE) -> "TorchCSR":
        """Round the edge capacity up to the canonical power-of-two bucket."""
        return self.pad_to(bucket_nnz(self.nnz_pad, lane))

    def pad_vertices(self, nc: int, nr: int) -> "TorchCSR":
        """Grow the vertex counts on device.

        The extra columns/rows are isolated, so the maximum matching and
        every solver trajectory on the real vertices are unchanged.  Padding
        edges are re-sentineled (they encoded the old ``nc``/``nr``) and
        ``cxadj`` is extended with the terminal offset.
        """
        if (nc, nr) == (self.nc, self.nr):
            return self
        self._single("pad_vertices()")
        assert nc >= self.nc and nr >= self.nr, \
            f"cannot shrink vertex counts {(self.nc, self.nr)} -> {(nc, nr)}"
        cxadj = self.cxadj
        if nc > self.nc:
            cxadj = torch.cat([cxadj, cxadj[-1:].expand(nc - self.nc)])
        g = dataclasses.replace(
            self, cxadj=cxadj.contiguous(), cadj=self._resentinel("cadj", nr),
            ecol=self._resentinel("ecol", nc), nc=nc, nr=nr)
        if self.has_csc:
            rxadj = self.rxadj
            if nr > self.nr:
                # new rows are edgeless: offsets repeat the true edge count
                rxadj = torch.cat([rxadj, rxadj[-1:].expand(nr - self.nr)])
            g = dataclasses.replace(
                g, rxadj=rxadj.contiguous(),
                radj=self._resentinel("radj", nc),
                erow=self._resentinel("erow", nr))
        return g

    def _resentinel(self, field: str, n: int) -> torch.Tensor:
        """``field`` with its old sentinel (``nr`` for row endpoints, ``nc``
        for column endpoints) replaced by ``n``."""
        old = self.nr if field in ("cadj", "erow") else self.nc
        x = getattr(self, field)
        return torch.where(x == old, n, x).to(torch.int32)

    # -- edge sharding --------------------------------------------------------
    def shard(self, mesh, axis: str = "data") -> "TorchCSR":
        """Edge-partition the graph over one axis of ``mesh`` (for
        ``ShardedMatcher``).

        The edge capacity is padded to ``D * per_shard_nnz(nnz_pad, D)``
        with inert sentinel edges, so each of the ``D = mesh.shape[axis]``
        contiguous slices of ``ecol``/``cadj`` (and of ``radj``/``erow``/
        ``eperm`` when mirrored: a range of rows each) is itself a
        power-of-two bucket (:meth:`shard_slices`).  The O(n) arrays stay
        whole.  The graph moves to the mesh's device and records the mesh
        and axis; on a graph already sharded so, this is a no-op.
        """
        self._single("shard()")
        ndev = int(mesh.shape[axis])
        cap = ndev * per_shard_nnz(self.nnz_pad, ndev)
        if self.mesh == mesh and self.axis == axis and self.nnz_pad == cap:
            return self
        g = self.to(mesh.device).pad_to(cap)
        return dataclasses.replace(g, mesh=mesh, axis=axis)

    @property
    def shards(self) -> int:
        """How many edge shards the graph is cut into (1 if not sharded)."""
        return 1 if self.mesh is None else int(self.mesh.shape[self.axis])

    def shard_slices(self, name: str) -> Tuple[torch.Tensor, ...]:
        """The ``shards`` contiguous views of the edge array ``name``
        (``ecol``, ``cadj``, ``radj``, ``erow`` or ``eperm``)."""
        t = getattr(self, name)
        return tuple(t.chunk(self.shards, dim=-1))

    def to(self, device) -> "TorchCSR":
        """The graph on ``device`` (``self`` if it is there already)."""
        device = torch.device(device)
        if self.device == device or (device.index is None
                                     and self.device.type == device.type):
            return self
        fields = ("cxadj", "cadj", "ecol", "rxadj", "radj", "erow", "eperm")
        with DEVICE_LOCK:         # never inside another thread's capture
            return dataclasses.replace(
                self, **{f: getattr(self, f).to(device) for f in fields
                         if getattr(self, f) is not None})

    # -- batching -------------------------------------------------------------
    @staticmethod
    def stack(graphs: Sequence["TorchCSR"]) -> "TorchCSR":
        """Stack graphs of one vertex bucket into one batched graph (what
        ``Matcher.run_many`` takes): every lane padded to the largest edge
        capacity, as the JAX package's ``DeviceCSR.stack`` pads; the CSC
        mirror on all of them or on none."""
        if not graphs:
            raise ValueError("empty graph batch")
        g0 = graphs[0]
        if len({g.has_csc for g in graphs}) != 1:
            raise ValueError("cannot stack mirrored and bare graphs; "
                             "with_csc() all or none")
        for g in graphs:
            g._single("stack()")
            if (g.nc, g.nr) != (g0.nc, g0.nr):
                raise ValueError(f"bucket mismatch: {(g.nc, g.nr)} vs "
                                 f"{(g0.nc, g0.nr)}")
            if g.device != g0.device:
                raise ValueError(f"graphs on {g.device} and {g0.device}")
        cap = max(g.nnz_pad for g in graphs)
        graphs = [g.pad_to(cap) for g in graphs]
        fields = ["cxadj", "cadj", "ecol"]
        if g0.has_csc:
            fields += ["rxadj", "radj", "erow", "eperm"]
        return dataclasses.replace(
            g0, nnz=tuple(int(g.nnz) for g in graphs),
            **{f: torch.stack([getattr(g, f) for g in graphs])
               for f in fields})

    def lane(self, i: int) -> "TorchCSR":
        """Lane ``i`` of a batch as a single graph (views, no copy)."""
        if not self.batch_shape:
            raise ValueError("not a batched TorchCSR")
        fields = ("cxadj", "cadj", "ecol", "rxadj", "radj", "erow", "eperm")
        return dataclasses.replace(
            self, nnz=self.nnz[i],
            **{f: getattr(self, f)[i] for f in fields
               if getattr(self, f) is not None})

    def unstack(self) -> Tuple["TorchCSR", ...]:
        """Every lane of a batch as a single graph."""
        if not self.batch_shape:
            raise ValueError("not a batched TorchCSR")
        return tuple(self.lane(i) for i in range(self.batch_shape[0]))
