from .ops import (LAUNCHES, frontier_bits, frontier_expand,
                  frontier_expand_fused, frontier_expand_pull, reset_launches,
                  uncounted)
from .ref import (frontier_bits_ref, frontier_expand_fused_ref,
                  frontier_expand_pull_ref, frontier_expand_ref)

__all__ = ["LAUNCHES", "frontier_bits", "frontier_bits_ref",
           "frontier_expand", "frontier_expand_fused",
           "frontier_expand_fused_ref", "frontier_expand_pull",
           "frontier_expand_pull_ref", "frontier_expand_ref",
           "reset_launches", "uncounted"]
