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
from .mtx import load_mtx, mtx_fixture

__all__ = ["random_bipartite", "kron_graph", "grid_graph", "scaled_free",
           "banded", "community_graph", "comb_chain", "instance_sets",
           "INSTANCE_FAMILIES", "load_mtx", "mtx_fixture"]
