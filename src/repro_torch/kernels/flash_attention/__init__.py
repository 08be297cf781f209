from .ops import LAUNCHES, flash_attention, reset_launches
from .ref import flash_attention_ref

__all__ = ["LAUNCHES", "flash_attention", "flash_attention_ref",
           "reset_launches"]
