"""Device-resident matching API for the paper's GPU algorithms, in PyTorch.

* :class:`TorchCSR` — the bipartite graph as int32 tensors on one device;
* :class:`MatcherConfig` — one of the paper's eight variants;
* :class:`Matcher` — facade whose :meth:`Matcher.run` runs a registered warm
  start (``"none" | "cheap" | "karp_sipser"``) and the APFB/APsB solver,
  and :meth:`Matcher.run_many` / :func:`match_many` a stacked batch of one
  size bucket;
* :class:`MatchState` / :class:`MatchStats` — results that stay on device
  until the caller asks;
* :class:`ShardedMatcher` / :func:`match_sharded` — the same solve with
  the edge list cut into shards over a :class:`Mesh` axis
  (:meth:`TorchCSR.shard`, :func:`make_mesh`), one min-merge of the
  shards' winners per BFS level;
* :data:`SOLVE_PATHS` — the registry of solve paths (push, legacy,
  adaptive, direction-optimizing, sharded), all bit-identical, with
  :func:`register_solve_path` / :func:`unregister_solve_path` /
  :func:`solve_path_names`;
* the compile cache (:mod:`.cache`): one program per (bucket shape,
  config, warm start, entry point, and for the sharded path mesh and
  axis), its CUDA graphs captured once.

Everything runs on the CUDA card unless the caller passes ``device="cpu"``
when uploading the graph.
"""
from .config import MatcherConfig, VARIANTS
from .device_csr import GraphValidationError, TorchCSR, validate_structure
from .state import MatchState, MatchStats
from .warmstart import WARM_STARTS, register_warm_start, warm_start_names
from .api import Matcher, match_many, maximum_matching_device
from .cache import (compile_cache_clear, compile_cache_info,
                    compile_cache_key, get_compiled, mesh_cache_key)
from .sharded import Mesh, ShardedMatcher, make_mesh, match_sharded
from .paths import (SOLVE_PATHS, SolvePath, register_solve_path,
                    solve_path_names, unregister_solve_path)

__all__ = [
    "MatcherConfig", "VARIANTS",
    "TorchCSR", "GraphValidationError", "validate_structure",
    "MatchState", "MatchStats",
    "Matcher", "match_many", "maximum_matching_device",
    "WARM_STARTS", "register_warm_start", "warm_start_names",
    "ShardedMatcher", "match_sharded", "mesh_cache_key", "make_mesh",
    "Mesh",
    "SOLVE_PATHS", "SolvePath", "register_solve_path",
    "solve_path_names", "unregister_solve_path",
    "compile_cache_clear", "compile_cache_info", "compile_cache_key",
    "get_compiled",
]
