"""Public wrapper for the flash-attention kernel: it launches the CUDA
kernel on CUDA tensors and takes its plain PyTorch version on CPU
tensors."""
from __future__ import annotations

from .flash_attention import LAUNCHES, flash_attention, reset_launches

__all__ = ["LAUNCHES", "flash_attention", "reset_launches"]
