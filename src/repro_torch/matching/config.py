"""Matcher variant configuration (the paper's eight-variant matrix).

The same fields, defaults and validation as the JAX package's
``MatcherConfig``, field for field, so a config reads the same in both.
The sweep knobs pick the same sweep per level as in the JAX package, and
as there they never change the matching.  A kernel sweep over CUDA
tensors always launches a hand-written kernel, over CPU tensors it takes
the kernel's plain version.  ``use_pallas`` picks the kernel where the
reference picks a Pallas kernel: the legacy proposal kernel (with
``pallas_fused=False``) and the streaming pull kernel (with ``dirop``);
elsewhere it changes nothing, since the fused kernel also stands in for the
reference's jnp sweep.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    """One of the paper's eight variants (2 algos x 2 BFS kernels x 2
    schedules), plus the frontier-sweep execution knobs.

    The sweep knobs (``use_pallas`` .. ``pull_dmax``) select *how* the
    per-level frontier expansion runs; they never change the matching
    the solver returns — every path is bit-identical to the deterministic
    min-merge semantics (asserted in tests/test_frontier_paths.py).  All of
    them are fields of this frozen dataclass, so every one lands in the
    compile-cache key by construction — there are no untracked execution
    knobs hiding in kwarg defaults.
    """

    algo: str = "apfb"          # "apfb" (HKDW-like) | "apsb" (HK-like)
    kernel: str = "gpubfs_wr"   # "gpubfs" | "gpubfs_wr"
    schedule: str = "ct"        # "ct" | "mt" — edge-tile geometry (Pallas path)
    wr_exact: bool = False      # the APsB-GPUBFS-WR refinement (negative-row encoding)
    use_pallas: bool = False    # route frontier expansion through the Pallas kernel
    max_phases: int = 0         # 0 = until maximum (bounded internally)
    # When a positive max_phases budget exhausts before the solver certifies
    # the matching maximum, run one extra greedy augmentation round
    # (the `cheap` warm start's speculative pass, Birn-et-al maximal
    # matching) over the truncated result so the degraded answer is at
    # least MAXIMAL — no free column shares an edge with a free row.  The
    # serving degradation ladder turns this on for deadline-bounded solves;
    # it stays off by default because the corpus heuristic replay
    # (corpus/heuristic.py) steps the solver with max_phases=1 and its
    # CI-gated trajectories must not change under it.
    degrade_maximal: bool = False
    # beyond-paper: bound the BFS tail after the first augmenting level.
    # 0 = paper-faithful (APsB stops immediately, APFB exhausts the
    # frontier); k>0 on APFB = expand at most k more levels — interpolates
    # between the paper's two drivers (benchmarks/perf_matcher.py).
    tail_levels: int = 0
    # -- Pallas frontier-sweep geometry -------------------------------------
    # fused kernel (in-VMEM per-row winner merge, no (nnz,) proposal array);
    # False = legacy two-step path (proposal kernel + XLA scatter), kept for
    # benchmarking the fusion win (benchmarks/perf_smoke.py).
    pallas_fused: bool = True
    # None = auto: compile for real on accelerator backends, interpret only
    # on CPU.  Resolved once per Matcher (``canonical()``) so the concrete
    # bool — not the auto marker — lands in the compile-cache key.
    pallas_interpret: Optional[bool] = None
    # 0 = auto (default_block_edges: CT 4096 / MT 512, clamped to the padded
    # edge count); >0 = explicit tile size, e.g. from benchmarks/autotune.py.
    pallas_block_edges: int = 0
    # -- beyond-paper: frontier-adaptive dispatch (default off) -------------
    # Track the frontier size each level and switch to a compact
    # column-gather sweep (O(cap * dmax) instead of O(nnz)) whenever the
    # frontier fits `compact_cap` columns of degree <= `compact_dmax`;
    # falls back to the full sweep at runtime otherwise, so results stay
    # bit-identical.  0 = auto-size to the bucket (resolve_cap/resolve_dmax
    # below — the ONE definition of the auto geometry; solve.make_solver
    # resolves per bucket, a pure function of (config, bucket) so the 0
    # marker in the compile-cache key is unambiguous).  Single-device only
    # (the sharded path keeps the dense per-shard sweep + one pmin).
    adaptive_frontier: bool = False
    compact_cap: int = 0
    compact_dmax: int = 0
    # -- beyond-paper: direction-optimizing frontier engine (default off) ---
    # Beamer-style push/pull switching per BFS level, in-jit: estimate the
    # frontier's outgoing edges (push work actually useful) against the
    # unreached rows' incoming edges (pull work) and `lax.cond`-dispatch a
    # pull sweep over the CSC mirror (`DeviceCSR.with_csc`) when
    #     frontier_edges * dirop_alpha > pull_edges,
    # staying in pull — hysteresis — while
    #     frontier_edges * dirop_beta  > pull_edges   (beta > alpha).
    # On the jnp path the pull sweep is a compact row-gather of
    # O(pull_cap * pull_dmax) (0 = auto, same resolution rule as the
    # compact push geometry but sized on nr) and additionally requires the
    # unreached rows to fit that geometry; on the Pallas path it is the
    # streaming `frontier_expand_pull` kernel (row-sorted tiles whose merge
    # skips when the tile proposes nothing).  Either way the winners are
    # bit-identical to the push sweeps, so the dispatch never changes the
    # matching.  Composes with ShardedMatcher (per-shard pull over the CSC
    # shard, the one per-level pmin unchanged).  Mutually exclusive with
    # `adaptive_frontier`, which it generalizes.
    # The alpha/beta defaults come from the committed corpus sweep
    # (BENCH_PR7.json, ``corpus.alpha_sweep`` / ``_summary`` rows, tiny
    # scale; regenerate via benchmarks/run.py --update-baseline): 8/32 ties
    # the best geomean across the 10-family corpus (0.997 vs push-only) and
    # is the clear winner on the long-diameter families (grid 0.699) where
    # pull tile-skipping pays; RCP permutation erases most of that win
    # (grid_rcp 0.951), which is the paper's locality story.  The per-family
    # rows are gated in CI (``corpus.heuristic``), so changing these
    # defaults without refreshing the baseline fails the bench gate.
    dirop: bool = False
    dirop_alpha: float = 8.0
    dirop_beta: float = 32.0
    pull_cap: int = 0
    pull_dmax: int = 0

    def __post_init__(self):
        assert self.algo in ("apfb", "apsb")
        assert self.kernel in ("gpubfs", "gpubfs_wr")
        assert self.schedule in ("ct", "mt")
        if self.wr_exact:
            assert self.kernel == "gpubfs_wr"
        assert self.pallas_block_edges >= 0, self.pallas_block_edges
        assert self.compact_cap >= 0 and self.compact_dmax >= 0, \
            (self.compact_cap, self.compact_dmax)
        assert self.pull_cap >= 0 and self.pull_dmax >= 0, \
            (self.pull_cap, self.pull_dmax)
        assert self.dirop_alpha > 0 and self.dirop_beta >= self.dirop_alpha, \
            ("hysteresis needs 0 < dirop_alpha <= dirop_beta",
             self.dirop_alpha, self.dirop_beta)
        if self.dirop and self.adaptive_frontier:
            raise ValueError(
                "dirop generalizes adaptive_frontier; enable one, not both")

    @staticmethod
    def resolve_cap(auto_or_value: int, n: int) -> int:
        """The 0 = auto capacity rule for the compact sweeps: n/8 clamped to
        [64, 1024] (well under any dense O(nnz) sweep).  ``n`` is nc for the
        push-compact gather, nr for the pull gather."""
        return auto_or_value or max(64, min(1024, n // 8))

    @staticmethod
    def resolve_dmax(auto_or_value: int) -> int:
        """The 0 = auto per-vertex degree bound of the compact sweeps."""
        return auto_or_value or 8

    @property
    def name(self) -> str:
        s = f"{self.algo}-{self.kernel}-{self.schedule}"
        return s + ("-exact" if self.wr_exact else "")

    def canonical(self) -> "MatcherConfig":
        """Resolve the ``pallas_interpret=None`` auto marker to a concrete
        bool.  This package has no interpret mode: the device of the graph
        decides, the CUDA kernel for a CUDA tensor and its plain PyTorch
        version for a CPU tensor, so the marker resolves to False.  Pure:
        imports nothing."""
        if self.pallas_interpret is not None:
            return self
        return dataclasses.replace(self, pallas_interpret=False)


VARIANTS = tuple(
    MatcherConfig(algo=a, kernel=k, schedule=s,
                  wr_exact=(a == "apsb" and k == "gpubfs_wr"))
    for a in ("apfb", "apsb")
    for k in ("gpubfs", "gpubfs_wr")
    for s in ("ct", "mt")
)
