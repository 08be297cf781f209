"""Device-resident matching API for the paper's GPU algorithms, in PyTorch.

* :class:`TorchCSR` — the bipartite graph as int32 tensors on one device;
* :class:`MatcherConfig` — one of the paper's eight variants;
* :class:`Matcher` — facade whose :meth:`Matcher.run` runs a registered warm
  start (``"none" | "cheap" | "karp_sipser"``) and the APFB/APsB solver,
  and :meth:`Matcher.run_many` / :func:`match_many` a stacked batch of one
  size bucket;
* :class:`MatchState` / :class:`MatchStats` — results that stay on device
  until the caller asks;
* :data:`SOLVE_PATHS` — the registry of single-device solve paths (push,
  legacy, adaptive, direction-optimizing), all bit-identical;
* the compile cache (:mod:`.cache`): one program per (bucket shape,
  config, warm start, entry point), its CUDA graphs captured once.

Everything runs on the CUDA card unless the caller passes ``device="cpu"``
when uploading the graph.
"""
from .config import MatcherConfig, VARIANTS
from .device_csr import GraphValidationError, TorchCSR, validate_structure
from .state import MatchState, MatchStats
from .warmstart import WARM_STARTS, register_warm_start, warm_start_names
from .api import Matcher, match_many, maximum_matching_device
from .cache import (compile_cache_clear, compile_cache_info,
                    compile_cache_key, get_compiled)
from .paths import SOLVE_PATHS, SolvePath

__all__ = [
    "MatcherConfig", "VARIANTS",
    "TorchCSR", "GraphValidationError", "validate_structure",
    "MatchState", "MatchStats",
    "Matcher", "match_many", "maximum_matching_device",
    "WARM_STARTS", "register_warm_start", "warm_start_names",
    "SOLVE_PATHS", "SolvePath",
    "compile_cache_clear", "compile_cache_info", "compile_cache_key",
    "get_compiled",
]
