"""Solve-path registry: every way this package computes a matching.

The counterpart of the JAX package's ``repro.matching.paths``, with the
same names and the same :class:`MatcherConfig` overrides: the dense push
sweep through the fused kernel (``jnp``, ``fused``), the legacy proposal
kernel merged by ``scatter_min`` (``legacy``), the compact adaptive-frontier
gather (``adaptive``), the direction-optimizing engine with the compact
pull (``dirop``) or the pull kernel (``dirop_pallas``), and the edge-sharded
matcher over a mesh (``sharded``).  All give the same matching bit for bit.

:meth:`SolvePath.solve` runs a host graph through the path to a device
state, :meth:`SolvePath.run_host` to host matching vectors, either in a
declared size bucket (``pad``); tests, ``chip_smoke.py`` and the
differential fuzzer (:mod:`repro_torch.corpus.verify`) call them.  Tests may
:func:`register_solve_path` a throwaway path (a ``runner`` replaces the
device round trip) and must unregister it again.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np

from .api import Matcher
from .config import MatcherConfig
from .device_csr import TorchCSR
from .sharded import ShardedMatcher, every_device, make_mesh
from .state import MatchState


@dataclasses.dataclass(frozen=True)
class SolvePath:
    """One registered solve configuration: ``overrides`` are
    :func:`dataclasses.replace` fields applied on top of a caller's base
    :class:`MatcherConfig`, so a path composes with any paper variant;
    ``sharded`` selects :class:`ShardedMatcher` over a mesh; ``runner``,
    when set, replaces :meth:`run_host`'s device round trip (a test hook)."""
    name: str
    overrides: Mapping[str, object]
    sharded: bool = False
    runner: Optional[Callable] = None

    def configure(self, base: MatcherConfig = MatcherConfig()
                  ) -> MatcherConfig:
        return dataclasses.replace(base, **dict(self.overrides))

    def matcher(self, base: MatcherConfig = MatcherConfig(),
                warm_start: str = "cheap", mesh=None, device=None
                ) -> Matcher:
        """The path's matcher; a sharded path's over ``mesh`` (None: a
        one-axis ``"data"`` mesh of every card, or of ``device``)."""
        cfg = self.configure(base)
        if self.sharded:
            if mesh is None:
                devices = every_device(device)
                mesh = make_mesh((len(devices),), ("data",), devices)
            return ShardedMatcher(mesh, "data", cfg, warm_start)
        return Matcher(cfg, warm_start)

    def solve(self, g, base: MatcherConfig = MatcherConfig(),
              warm_start: str = "cheap", device=None, mesh=None,
              pad: Optional[Tuple[int, int, int]] = None) -> MatchState:
        """Upload the host graph ``g`` (padded into ``pad``'s bucket, with
        the CSC mirror where the path pulls) and run the path's matcher:
        the device-resident state, of the bucket's size.  ``device=None``
        is the CUDA card (a sharded path: every card)."""
        graph = TorchCSR.from_host(g, device=device)
        if pad is not None:
            nc, nr, cap = pad
            graph = graph.pad_vertices(nc, nr).pad_to(cap)
        if self.configure(base).dirop:
            graph = graph.with_csc()       # sharded dirop: mirror pre-shard
        return self.matcher(base, warm_start, mesh, device).run(graph)

    def run_host(self, g, base: MatcherConfig = MatcherConfig(),
                 warm_start: str = "cheap", device=None, mesh=None,
                 pad: Optional[Tuple[int, int, int]] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Host graph in, host ``(cmatch, rmatch)`` out (padding stripped).

        ``pad=(nc, nr, nnz_cap)`` places the instance in a declared size
        bucket, so that many instances share one compile-cache entry: the
        differential fuzzer's compile budget rests on it.  Padded vertices
        are isolated, so the true-size matching is unaffected.
        """
        if self.runner is not None:
            return self.runner(g, base=base, warm_start=warm_start)
        cm, rm = self.solve(g, base, warm_start, device, mesh, pad).to_host()
        return cm[: g.nc], rm[: g.nr]


SOLVE_PATHS: Dict[str, SolvePath] = {}


def register_solve_path(name: str, overrides: Optional[Mapping] = None, *,
                        sharded: bool = False,
                        runner: Optional[Callable] = None) -> SolvePath:
    path = SolvePath(name, dict(overrides or {}), sharded, runner)
    SOLVE_PATHS[name] = path
    return path


def unregister_solve_path(name: str) -> None:
    SOLVE_PATHS.pop(name, None)


def solve_path_names() -> Tuple[str, ...]:
    return tuple(SOLVE_PATHS)


# the built-in paths, one per frontier-sweep strategy, with the reference's
# names and overrides.  Geometry knobs (compact_cap / pull_cap) stay on auto.
register_solve_path("jnp", {})
register_solve_path("legacy", dict(use_pallas=True, pallas_fused=False))
register_solve_path("fused", dict(use_pallas=True, pallas_fused=True))
register_solve_path("adaptive", dict(adaptive_frontier=True))
register_solve_path("dirop", dict(dirop=True))
register_solve_path("dirop_pallas", dict(dirop=True, use_pallas=True))
register_solve_path("sharded", {}, sharded=True)
