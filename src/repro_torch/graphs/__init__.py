"""Bipartite graph instance generation — the paper's experimental sets."""
from .generators import (
    INSTANCE_FAMILIES,
    banded,
    comb_chain,
    community_graph,
    grid_graph,
    instance_sets,
    kron_graph,
    random_bipartite,
    scaled_free,
)

__all__ = ["random_bipartite", "kron_graph", "grid_graph", "scaled_free",
           "banded", "community_graph", "comb_chain", "instance_sets",
           "INSTANCE_FAMILIES"]
