"""Core: the paper's maximum-cardinality bipartite matching algorithms.

Host-centric surface (numpy in/out): the host container, the matcher and
warm-start wrappers, the sequential oracles (Hopcroft–Karp, Pothen–Fan,
push-relabel, scipy's cardinality).  The device-resident API of
:mod:`repro_torch.matching` is re-exported for convenience.
"""
from .csr import (BipartiteCSR, is_maximal, validate_matching,
                  UNMATCHED, ENDPOINT)
from .matcher import MatcherConfig, VARIANTS, maximum_matching
from .cheap import cheap_matching_torch
from .karp_sipser import karp_sipser_torch
from .oracles import (cheap_matching, hopcroft_karp, pfp,
                      maximum_cardinality, push_relabel)
from repro_torch.matching import (TorchCSR, Matcher, MatchState,
                                  MatchStats, match_many)

__all__ = [
    "BipartiteCSR", "is_maximal", "validate_matching", "UNMATCHED",
    "ENDPOINT",
    "MatcherConfig", "VARIANTS", "maximum_matching", "cheap_matching_torch",
    "cheap_matching", "hopcroft_karp", "pfp", "maximum_cardinality",
    "push_relabel", "karp_sipser_torch",
    "TorchCSR", "Matcher", "MatchState", "MatchStats", "match_many",
]
