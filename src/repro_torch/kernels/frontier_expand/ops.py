"""Public wrapper for the frontier-expansion kernel.

``frontier_expand_fused`` — fused sweep + per-row winner merge: the CUDA
kernel on CUDA tensors, its plain PyTorch version on CPU tensors.  The
legacy per-edge kernel and the pull kernel come in later slices.
"""
from __future__ import annotations

from .frontier_expand import LAUNCHES, frontier_expand_fused, reset_launches

__all__ = ["LAUNCHES", "frontier_expand_fused", "reset_launches"]
