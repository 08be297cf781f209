"""MoE routers of the port (the JAX package's ``repro.moe``): greedy
top-k, the paper's matching router, and the exact router that solves a
gadget graph with the port's matcher."""
from .matching_router import (route_matching, route_matching_exact,
                              route_topk, router_stats)

__all__ = ["route_matching", "route_matching_exact", "route_topk",
           "router_stats"]
