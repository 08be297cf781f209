"""Numpy-in, numpy-out wrapper of the Karp–Sipser warm start (beyond the
paper).

The peel-then-greedy initializer is :mod:`repro_torch.matching.warmstart`'s
``"karp_sipser"`` stage; see that module for the algorithm.  This wrapper
keeps the JAX package's host entry point (``core.karp_sipser.
karp_sipser_jax`` there).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .cheap import _run_init
from .csr import BipartiteCSR


def karp_sipser_torch(g: BipartiteCSR, device=None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Karp–Sipser degree-1 peeling rounds, then parallel greedy on the
    residual, on ``device`` (the CUDA card by default)."""
    return _run_init(g, "karp_sipser", device)
