"""Core: the paper's maximum-cardinality bipartite matching algorithms.

Host-centric surface (numpy in/out) plus the device-resident API of
:mod:`repro_torch.matching`, re-exported for convenience.
"""
from .csr import (BipartiteCSR, is_maximal, validate_matching,
                  UNMATCHED, ENDPOINT)
from .matcher import MatcherConfig, VARIANTS, maximum_matching
from repro_torch.matching import (TorchCSR, Matcher, MatchState,
                                  MatchStats, match_many)

__all__ = [
    "BipartiteCSR", "is_maximal", "validate_matching", "UNMATCHED",
    "ENDPOINT", "MatcherConfig", "VARIANTS", "maximum_matching",
    "TorchCSR", "Matcher", "MatchState", "MatchStats", "match_many",
]
