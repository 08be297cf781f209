"""Numpy-in, numpy-out wrapper of the parallel cheap-matching warm start.

The initializer itself is :mod:`repro_torch.matching.warmstart`'s
``"cheap"`` stage, which :class:`repro_torch.matching.Matcher` runs as the
first steps of one captured program.  This wrapper keeps the JAX package's
host entry point (``core.cheap.cheap_matching_jax`` there) for the
sequential baselines and benchmarks: one upload, the ``"init"`` entry of
the compile cache, one download.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.matching.api import Matcher
from repro_torch.matching.device_csr import TorchCSR

from .csr import BipartiteCSR


def _run_init(g: BipartiteCSR, name: str, device=None
              ) -> Tuple[np.ndarray, np.ndarray]:
    """The warm start ``name`` alone on ``g``, uploaded to ``device`` (the
    CUDA card by default): true-size host ``(cmatch, rmatch)``."""
    graph = TorchCSR.from_host(g, device=device)
    return Matcher(warm_start=name).init(graph).to_host()


def cheap_matching_torch(g: BipartiteCSR, device=None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Parallel greedy: each free column proposes to its lowest free row,
    each row takes its lowest proposer, for rounds until none is left."""
    return _run_init(g, "cheap", device)
