"""Device-resident matching API for the paper's GPU algorithms, in PyTorch.

* :class:`TorchCSR` — the bipartite graph as int32 tensors on one device;
* :class:`MatcherConfig` — one of the paper's eight variants;
* :class:`Matcher` — facade whose :meth:`Matcher.run` runs a registered warm
  start (``"none" | "cheap" | "karp_sipser"``) and the APFB/APsB solver;
* :class:`MatchState` / :class:`MatchStats` — results that stay on device
  until the caller asks.

Everything runs on the CUDA card unless the caller passes ``device="cpu"``
when uploading the graph.
"""
from .config import MatcherConfig, VARIANTS
from .device_csr import GraphValidationError, TorchCSR, validate_structure
from .state import MatchState, MatchStats
from .warmstart import WARM_STARTS, register_warm_start, warm_start_names
from .api import Matcher, maximum_matching_device

__all__ = [
    "MatcherConfig", "VARIANTS",
    "TorchCSR", "GraphValidationError", "validate_structure",
    "MatchState", "MatchStats",
    "Matcher", "maximum_matching_device",
    "WARM_STARTS", "register_warm_start", "warm_start_names",
]
