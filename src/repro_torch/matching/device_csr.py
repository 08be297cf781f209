"""Device-resident bipartite CSR graph: int32 tensors on one device.

``TorchCSR`` holds the same arrays as the host :class:`repro_torch.core.csr.
BipartiteCSR` (``cxadj`` (nc+1,), ``cadj``/``ecol`` (nnz_pad,), sentinel
``nr``/``nc`` in the padding) as int32 tensors on the device the solver runs
on, the CUDA card unless the caller names another.  Values, padding and the
size-bucket rule (:func:`bucket_nnz`) are those of the JAX package's
``DeviceCSR``, so one instance pads to the same shapes in both packages.

The CSC mirror, stacking into batches and sharding come in later slices.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device

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



def _full(n: int, value: int, device) -> torch.Tensor:
    return torch.full((n,), value, dtype=torch.int32, device=device)


@dataclasses.dataclass(frozen=True)
class TorchCSR:
    """Column-major CSR bipartite graph on one device.

    ``cxadj`` (nc+1,), ``cadj``/``ecol`` (nnz_pad,) int32 tensors on the
    same device; ``nnz`` (the true edge count), ``nc`` and ``nr`` are
    Python ints, so reading them costs no device sync.
    """

    cxadj: torch.Tensor
    cadj: torch.Tensor
    ecol: torch.Tensor
    nnz: int
    nc: int
    nr: int

    @property
    def nnz_pad(self) -> int:
        return int(self.cadj.shape[-1])

    @property
    def device(self) -> torch.device:
        return self.cadj.device

    @property
    def bucket_key(self) -> Tuple[int, int, int]:
        """The size bucket: (nc, nr, nnz_pad)."""
        return (self.nc, self.nr, self.nnz_pad)

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

        return cls(cxadj=put(g.cxadj), cadj=put(cadj), ecol=put(ecol),
                   nnz=int(g.nnz), nc=int(g.nc), nr=int(g.nr))

    def validate(self) -> "TorchCSR":
        """Check the structural invariants (one host copy); returns ``self``
        so it chains, raises :class:`GraphValidationError` otherwise."""
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
        return BipartiteCSR(nc=self.nc, nr=self.nr, nnz=self.nnz,
                            cxadj=self.cxadj.cpu().numpy(),
                            cadj=self.cadj.cpu().numpy(),
                            ecol=self.ecol.cpu().numpy())

    # -- bucketing ------------------------------------------------------------
    def pad_to(self, nnz_pad: int) -> "TorchCSR":
        """Grow the edge capacity on device (sentinel-fill the new slots)."""
        cur = self.nnz_pad
        if nnz_pad == cur:
            return self
        assert nnz_pad > cur, f"cannot shrink edge capacity {cur} -> {nnz_pad}"
        extra = nnz_pad - cur
        return dataclasses.replace(
            self,
            cadj=torch.cat([self.cadj, _full(extra, self.nr, self.device)]),
            ecol=torch.cat([self.ecol, _full(extra, self.nc, self.device)]))

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
        assert nc >= self.nc and nr >= self.nr, \
            f"cannot shrink vertex counts {(self.nc, self.nr)} -> {(nc, nr)}"
        cxadj = self.cxadj
        if nc > self.nc:
            cxadj = torch.cat([cxadj, cxadj[-1:].expand(nc - self.nc)])
        cadj = torch.where(self.cadj == self.nr, nr, self.cadj)
        ecol = torch.where(self.ecol == self.nc, nc, self.ecol)
        return dataclasses.replace(self, cxadj=cxadj.contiguous(),
                                   cadj=cadj.to(torch.int32),
                                   ecol=ecol.to(torch.int32), nc=nc, nr=nr)
