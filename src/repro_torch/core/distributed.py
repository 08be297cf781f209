"""Numpy-in, numpy-out wrapper over :class:`repro_torch.matching.
ShardedMatcher`, the JAX package's ``core.distributed`` entry point.

The edge-sharded matcher itself lives in :mod:`repro_torch.matching.
sharded` and shares the solve loop, warm starts, compile cache and frontier
kernels with the single-device ``Matcher``.  New code should call it
directly::

    graph = TorchCSR.from_host(g).shard(mesh, "data")
    state = ShardedMatcher(mesh, config=cfg, warm_start="cheap").run(graph)
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.matching import (MatcherConfig, MatchState, Mesh,
                                  ShardedMatcher, TorchCSR)


def maximum_matching_distributed(
    g,
    mesh: Mesh,
    cfg: MatcherConfig = MatcherConfig(),
    axis: str = "data",
    cmatch0: Optional[np.ndarray] = None,
    rmatch0: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, dict]:
    """Edge-partitioned matcher: edges sharded over ``axis`` of ``mesh``,
    the state whole.  Uploads to the mesh's device and shards once, runs
    :meth:`ShardedMatcher.run` (no warm start; ``cmatch0``/``rmatch0``
    resume from a given matching), downloads once.  ``g`` is a host
    :class:`repro_torch.core.csr.BipartiteCSR`."""
    graph = TorchCSR.from_host(g, device=mesh.device).shard(mesh, axis)
    state = None
    if cmatch0 is not None:
        state = MatchState.from_host(np.asarray(cmatch0, np.int32),
                                     np.asarray(rmatch0, np.int32),
                                     device=mesh.device)
    out = ShardedMatcher(mesh, axis, cfg).run(graph, state)
    cmatch, rmatch = out.to_host()
    return cmatch, rmatch, {
        "phases": int(out.phases), "fallbacks": int(out.fallbacks),
        "cardinality": int((cmatch >= 0).sum()),
        "devices": int(mesh.shape[axis]),
        "variant": f"dist-{cfg.name}",
    }
