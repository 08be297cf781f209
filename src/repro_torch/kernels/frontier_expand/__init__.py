from .ops import LAUNCHES, frontier_expand_fused, reset_launches
from .ref import frontier_expand_fused_ref, frontier_expand_ref

__all__ = ["LAUNCHES", "frontier_expand_fused", "frontier_expand_fused_ref",
           "frontier_expand_ref", "reset_launches"]
