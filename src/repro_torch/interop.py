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
A stacked batch (``DeviceCSR.stack``, the states ``run_many`` returns)
carries across the same way: every leaf with its leading lane dimension,
``nnz`` of shape ``(B,)`` (a tuple of ints on this side).

LM weights and KV caches are nested dicts in both packages, leaf for leaf
(:func:`lm_params_from_reference`, :func:`lm_params_to_reference`).
"""
from __future__ import annotations

from typing import Any, List, Sequence

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
    leaves, or 8 with the CSC mirror), single or stacked."""
    if len(leaves) not in (4, 8):
        raise ValueError(
            f"expected the 4 leaves cxadj, cadj, ecol, nnz (then rxadj, "
            f"radj, erow, eperm with the CSC mirror), got {len(leaves)}")
    cxadj, cadj, ecol, nnz = leaves[:4]
    if np.ndim(cadj) not in (1, 2) or np.shape(nnz) != np.shape(cadj)[:-1]:
        raise ValueError(
            f"cadj of shape {np.shape(cadj)} and nnz of shape "
            f"{np.shape(nnz)}: expected one graph (1-D, a scalar) or a "
            f"stack along one batch dimension ((B, n), (B,))")
    nnz = int(nnz) if np.ndim(nnz) == 0 else tuple(int(x) for x in nnz)
    dev = resolve_device(device)
    mirror = dict(zip(_MIRROR, (_to(x, np.int32, dev) for x in leaves[4:])))
    return TorchCSR(cxadj=_to(cxadj, np.int32, dev),
                    cadj=_to(cadj, np.int32, dev),
                    ecol=_to(ecol, np.int32, dev),
                    nnz=nnz, nc=int(nc), nr=int(nr), **mirror)


def csr_to_reference(graph: TorchCSR) -> List[np.ndarray]:
    """The leaves of the equivalent JAX ``DeviceCSR`` (single or stacked),
    as numpy arrays."""
    leaves = [graph.cxadj.cpu().numpy(), graph.cadj.cpu().numpy(),
              graph.ecol.cpu().numpy(), np.asarray(graph.nnz, np.int32)]
    if graph.has_csc:
        leaves += [getattr(graph, f).cpu().numpy() for f in _MIRROR]
    return leaves


def state_from_reference(leaves: Sequence[np.ndarray],
                         device=None) -> MatchState:
    """A :class:`MatchState` from the leaves of a JAX ``MatchState``
    (sentinel slots included), single or batched."""
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


def _leaf_to_torch(x, dev) -> Any:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a)).to(dev)


def _leaf_to_numpy(x) -> Any:
    if isinstance(x, int):               # the cache's Python-int position
        return np.asarray(x, np.int32)
    if x.dtype == torch.bfloat16:
        import ml_dtypes                 # present wherever JAX is
        return (x.detach().cpu().view(torch.int16).numpy().view(np.uint16)
                .view(ml_dtypes.bfloat16))
    return x.detach().cpu().numpy()


def lm_params_from_reference(tree, device=None):
    """A nested dict of tensors from a JAX LM tree (``Model.init``'s
    params, or ``Model.init_cache``'s cache) converted with
    ``jax.tree.map(np.asarray, ...)``.  Dtypes are kept; bfloat16 arrays
    (``ml_dtypes``) become ``torch.bfloat16`` bit for bit."""
    dev = resolve_device(device)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return _leaf_to_torch(t, dev)

    return walk(tree)


def lm_params_to_reference(params):
    """The nested dict of numpy arrays the JAX package's functions take
    (``jax.tree.map(jnp.asarray, ...)`` restores its arrays): dtypes kept,
    ``torch.bfloat16`` as ``ml_dtypes.bfloat16``, a Python-int cache
    position as an int32 scalar."""
    if isinstance(params, dict):
        return {k: lm_params_to_reference(v) for k, v in params.items()}
    return _leaf_to_numpy(params)
