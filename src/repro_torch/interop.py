"""Carry graphs and matching state across from the JAX package and back.

The JAX package's ``DeviceCSR`` and ``MatchState`` are pytrees; their leaves,
converted to numpy arrays (``[np.asarray(x) for x in
jax.tree_util.tree_leaves(obj)]``), are what these functions take and
give.  No JAX is needed on this side: a state the JAX package produced
(a warm start, a budget-truncated solve) resumes here, and the result can be
handed back and unflattened with the original tree definition.

Leaf orders (the dataclass field order of the JAX package):
``DeviceCSR``: ``cxadj, cadj, ecol, nnz``, then, for a graph with the CSC
mirror, ``rxadj, radj, erow, eperm``.
``MatchState``: ``cmatch, rmatch, phases, fallbacks, certified``.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.matching.device_csr import TorchCSR
from repro_torch.matching.state import MatchState


_MIRROR = ("rxadj", "radj", "erow", "eperm")   # the mirror's leaf order


def _to(x, dtype, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=dtype)).to(dev)


def csr_from_reference(leaves: Sequence[np.ndarray], nc: int, nr: int,
                       device=None) -> TorchCSR:
    """A :class:`TorchCSR` from the leaves of a JAX ``DeviceCSR`` (4
    leaves, or 8 with the CSC mirror)."""
    if len(leaves) not in (4, 8):
        raise ValueError(
            f"expected the 4 leaves cxadj, cadj, ecol, nnz (then rxadj, "
            f"radj, erow, eperm with the CSC mirror), got {len(leaves)}")
    cxadj, cadj, ecol, nnz = leaves[:4]
    if np.ndim(nnz) != 0 or np.ndim(cadj) != 1:
        raise ValueError("a batched DeviceCSR cannot be carried across yet")
    dev = resolve_device(device)
    mirror = dict(zip(_MIRROR, (_to(x, np.int32, dev) for x in leaves[4:])))
    return TorchCSR(cxadj=_to(cxadj, np.int32, dev),
                    cadj=_to(cadj, np.int32, dev),
                    ecol=_to(ecol, np.int32, dev),
                    nnz=int(nnz), nc=int(nc), nr=int(nr), **mirror)


def csr_to_reference(graph: TorchCSR) -> List[np.ndarray]:
    """The leaves of the equivalent JAX ``DeviceCSR``, as numpy arrays."""
    leaves = [graph.cxadj.cpu().numpy(), graph.cadj.cpu().numpy(),
              graph.ecol.cpu().numpy(), np.asarray(graph.nnz, np.int32)]
    if graph.has_csc:
        leaves += [getattr(graph, f).cpu().numpy() for f in _MIRROR]
    return leaves


def state_from_reference(leaves: Sequence[np.ndarray],
                         device=None) -> MatchState:
    """A :class:`MatchState` from the leaves of a JAX ``MatchState``
    (sentinel slots included)."""
    if len(leaves) != 5:
        raise ValueError(f"expected the 5 MatchState leaves, got "
                         f"{len(leaves)}")
    cmatch, rmatch, phases, fallbacks, certified = leaves
    dev = resolve_device(device)
    return MatchState(cmatch=_to(cmatch, np.int32, dev),
                      rmatch=_to(rmatch, np.int32, dev),
                      phases=_to(phases, np.int32, dev),
                      fallbacks=_to(fallbacks, np.int32, dev),
                      certified=_to(certified, np.bool_, dev))


def state_to_reference(state: MatchState) -> List[np.ndarray]:
    """The leaves of the equivalent JAX ``MatchState``, as numpy arrays."""
    return [state.cmatch.cpu().numpy(), state.rmatch.cpu().numpy(),
            state.phases.cpu().numpy(), state.fallbacks.cpu().numpy(),
            state.certified.cpu().numpy()]
