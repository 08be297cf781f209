"""Matching state and stats (device-resident results).

The fields are those of the JAX package's ``MatchState``/``MatchStats``:
``cmatch`` (nc+1,) / ``rmatch`` (nr+1,) int32 with the trailing sentinel
slot, and ``phases``/``fallbacks``/``certified`` as 0-d device tensors, so a
run needs no host sync until the caller reads a value.  A batch (the result
of ``Matcher.run_many``) has a leading lane dimension on every field:
``(B, nc+1)``, ``(B, nr+1)`` and ``(B,)``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device

SENTINEL = -3  # value of the trailing sentinel slot


def _scalar(value, dtype, device) -> torch.Tensor:
    """A 0-d device scalar made by a fill: ``torch.tensor(value,
    device=...)`` copies from the host and waits for the card."""
    return torch.full((), value, dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class MatchState:
    """Matching vectors with the solver's sentinel slot still attached.

    ``cmatch`` (nc+1,) / ``rmatch`` (nr+1,): matched partner or -1; the last
    slot is the kernels' scratch sentinel.  ``phases``/``fallbacks`` count
    the solver's outer iterations (0 for a freshly initialized state).
    ``certified`` is True iff the last BFS phase proved no augmenting path
    remains, i.e. the matching is maximum (Berge).
    """

    cmatch: torch.Tensor
    rmatch: torch.Tensor
    phases: torch.Tensor
    fallbacks: torch.Tensor
    certified: torch.Tensor

    @classmethod
    def fresh(cls, nc: int, nr: int, device=None,
              batch_shape: Tuple[int, ...] = ()) -> "MatchState":
        """All-unmatched state for an (nc, nr) graph, or for a batch of
        ``batch_shape`` of them."""
        dev = resolve_device(device)
        bs = tuple(batch_shape)
        cm = torch.full(bs + (nc + 1,), -1, dtype=torch.int32, device=dev)
        rm = torch.full(bs + (nr + 1,), -1, dtype=torch.int32, device=dev)
        # fills, not item assignment (a copy from the host, which waits)
        cm[..., nc:].fill_(SENTINEL)
        rm[..., nr:].fill_(SENTINEL)
        return cls(cmatch=cm, rmatch=rm,
                   phases=torch.zeros(bs, dtype=torch.int32, device=dev),
                   fallbacks=torch.zeros(bs, dtype=torch.int32, device=dev),
                   certified=torch.zeros(bs, dtype=torch.bool, device=dev))

    @classmethod
    def from_host(cls, cmatch: np.ndarray, rmatch: np.ndarray,
                  device=None) -> "MatchState":
        """Wrap true-size host vectors (appends the sentinel slot)."""
        dev = resolve_device(device)

        def put(x):
            v = np.append(np.asarray(x, np.int32), np.int32(SENTINEL))
            return torch.from_numpy(v).to(dev)

        return cls(cmatch=put(cmatch), rmatch=put(rmatch),
                   phases=_scalar(0, torch.int32, dev),
                   fallbacks=_scalar(0, torch.int32, dev),
                   certified=_scalar(False, torch.bool, dev))

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        return tuple(self.cmatch.shape[:-1])

    @property
    def cardinality(self) -> torch.Tensor:
        """Matched-pair count as a device tensor, one a lane (no host
        sync)."""
        return (self.cmatch[..., :-1] >= 0).sum(dim=-1, dtype=torch.int32)

    def to_host(self) -> Tuple[np.ndarray, np.ndarray]:
        """(cmatch, rmatch) as true-size numpy arrays."""
        return (self.cmatch[..., :-1].cpu().numpy(),
                self.rmatch[..., :-1].cpu().numpy())

    def lane(self, i: int) -> "MatchState":
        """Lane ``i`` of a batched state (views, no copy)."""
        if not self.batch_shape:
            raise ValueError("not a batched MatchState")
        return MatchState(*(getattr(self, f.name)[i]
                            for f in dataclasses.fields(self)))

    def unstack(self) -> Tuple["MatchState", ...]:
        """Every lane of a batched state."""
        if not self.batch_shape:
            raise ValueError("not a batched MatchState")
        return tuple(self.lane(i) for i in range(self.batch_shape[0]))


@dataclasses.dataclass(frozen=True)
class MatchStats:
    """Run statistics; scalars stay on device until :meth:`as_dict`."""

    cardinality: torch.Tensor
    phases: torch.Tensor
    fallbacks: torch.Tensor
    certified: torch.Tensor
    variant: str = ""

    @classmethod
    def of(cls, state: MatchState, variant: str = "") -> "MatchStats":
        return cls(cardinality=state.cardinality, phases=state.phases,
                   fallbacks=state.fallbacks, certified=state.certified,
                   variant=variant)

    def as_dict(self) -> dict:
        """Host-side stats dict (numpy arrays for a batch)."""
        out = {k: getattr(self, k).cpu().numpy()
               for k in ("phases", "fallbacks", "cardinality", "certified")}
        out = {k: (v.item() if v.ndim == 0 else
                   v.astype(bool if k == "certified" else int))
               for k, v in out.items()}
        out["variant"] = self.variant
        return out


def empty_like_graph(graph) -> MatchState:
    """Fresh all-unmatched state shaped for ``graph`` (a TorchCSR, single
    or batched), on the graph's device."""
    return MatchState.fresh(graph.nc, graph.nr, graph.device,
                            graph.batch_shape)
