"""Solve-path registry: every single-device way this package computes a
matching.

The counterpart of the JAX package's ``repro.matching.paths``, with the
same names and the same :class:`MatcherConfig` overrides: the dense push
sweep through the fused kernel (``jnp``, ``fused``), the legacy proposal
kernel merged by ``scatter_min`` (``legacy``), the compact adaptive-frontier
gather (``adaptive``), and the direction-optimizing engine with the compact
pull (``dirop``) or the pull kernel (``dirop_pallas``).  All give the same
matching bit for bit.  The edge-sharded path comes with the sharding slice
of the port.

:meth:`SolvePath.solve` runs a host graph through the path to a device
state, :meth:`SolvePath.run_host` to host matching vectors; tests,
``chip_smoke.py`` and differential harnesses call them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import numpy as np

from .api import Matcher
from .config import MatcherConfig
from .device_csr import TorchCSR
from .state import MatchState


@dataclasses.dataclass(frozen=True)
class SolvePath:
    """One registered solve configuration: ``overrides`` are
    :func:`dataclasses.replace` fields applied on top of a caller's base
    :class:`MatcherConfig`, so a path composes with any paper variant."""
    name: str
    overrides: Mapping[str, object]

    def configure(self, base: MatcherConfig = MatcherConfig()
                  ) -> MatcherConfig:
        return dataclasses.replace(base, **dict(self.overrides))

    def solve(self, g, base: MatcherConfig = MatcherConfig(),
              warm_start: str = "cheap", device=None) -> MatchState:
        """Upload the host graph ``g`` (with the CSC mirror where the path
        pulls) and run the path's matcher: the device-resident state.
        ``device=None`` is the CUDA card."""
        cfg = self.configure(base)
        graph = TorchCSR.from_host(g, device=device)
        if cfg.dirop:
            graph = graph.with_csc()
        return Matcher(cfg, warm_start).run(graph)

    def run_host(self, g, base: MatcherConfig = MatcherConfig(),
                 warm_start: str = "cheap", device=None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Host graph in, host ``(cmatch, rmatch)`` out."""
        return self.solve(g, base, warm_start, device).to_host()


# the paths, one per frontier-sweep strategy, with the reference's names
# and overrides.  Geometry knobs (compact_cap / pull_cap) stay on auto.
SOLVE_PATHS: Dict[str, SolvePath] = {p.name: p for p in (
    SolvePath("jnp", {}),
    SolvePath("legacy", dict(use_pallas=True, pallas_fused=False)),
    SolvePath("fused", dict(use_pallas=True, pallas_fused=True)),
    SolvePath("adaptive", dict(adaptive_frontier=True)),
    SolvePath("dirop", dict(dirop=True)),
    SolvePath("dirop_pallas", dict(dirop=True, use_pallas=True)),
)}
