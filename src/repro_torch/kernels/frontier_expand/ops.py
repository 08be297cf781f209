"""Public wrappers for the frontier-expansion kernels.

``frontier_expand``       — legacy per-edge proposal sweep (merge outside).
``frontier_expand_fused`` — sweep + per-row winner merge in one kernel.
``frontier_expand_pull``  — the fused sweep's winners over the CSC mirror.
``frontier_bits``         — the pull's column pass alone (one bit a column).
``uncounted``             — a block whose launches are not counted.

Each launches its CUDA kernel on CUDA tensors and takes its plain PyTorch
version on CPU tensors.
"""
from __future__ import annotations

from .frontier_expand import (LAUNCHES, frontier_bits, frontier_expand,
                              frontier_expand_fused, frontier_expand_pull,
                              reset_launches, uncounted)

__all__ = ["LAUNCHES", "frontier_bits", "frontier_expand",
           "frontier_expand_fused", "frontier_expand_pull", "reset_launches",
           "uncounted"]
