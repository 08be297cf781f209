"""Differential fuzz harness: every solve path × warm start × corpus family.

For each corpus instance (the unified :func:`repro_torch.graphs.
instance_sets` families plus the committed ``.mtx`` fixture, original +
RCP-permuted) and each registered solve path (:data:`repro_torch.matching.
SOLVE_PATHS`) × warm-start config, the harness asserts

* the :func:`repro_torch.core.csr.validate_matching` invariants (symmetry,
  range, edge membership), and
* cardinality equals the host Hopcroft-Karp oracle,

with deterministic seeds throughout.  On a mismatch it ddmin-minimizes the
instance's edge list against the failing (path, warm start) cell and dumps a
JSON artifact (``repro-corpus-failure/1``) with the minimized edges, the
config, and both cardinalities — a ready-to-replay reproducer.

Compile budget: all instances are padded into one shared size bucket
(:meth:`SolvePath.run_host`'s ``pad``), so each (path, warm start) cell
builds one compile-cache entry, its CUDA graphs captured once, for the
whole corpus instead of one per instance.

This is the JAX package's ``repro.corpus.verify``, cell for cell (the same
enumeration, oracles, minimisation and artifact schema), over this
package's solve paths, on the device the caller names: the CUDA card by
default, ``device="cpu"`` for the plain versions.

CLI::

    python -m repro_torch.corpus.verify --scale mini --artifact-dir artifacts
    python -m repro_torch.corpus.verify --scale mini --device cpu

exits non-zero on any failing cell.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core.csr import BipartiteCSR, is_maximal, validate_matching
from repro_torch.core.oracles import hopcroft_karp
from repro_torch.graphs import instance_sets, mtx_fixture
from repro_torch.matching import SOLVE_PATHS, MatcherConfig
from repro_torch.matching.device_csr import bucket_nnz

ARTIFACT_SCHEMA = "repro-corpus-failure/1"
DEFAULT_WARM_STARTS = ("none", "cheap")


def corpus_instances(scale: str = "mini", rcp: bool = True,
                     rcp_seed: int = 13,
                     families: Optional[Sequence[str]] = None
                     ) -> Dict[str, BipartiteCSR]:
    """The corpus: unified generator families + the committed mtx fixture,
    each optionally with its RCP-permuted twin."""
    insts = instance_sets(scale, rcp=False)
    insts["mtx"] = mtx_fixture()
    if families is not None:
        insts = {k: insts[k] for k in families}
    if rcp:
        insts.update({f"{k}_rcp": g.permuted(rcp_seed)
                      for k, g in tuple(insts.items())})
    return insts


def oracle_cardinality(g: BipartiteCSR) -> int:
    cm, rm = hopcroft_karp(g)
    return int(validate_matching(g, cm, rm))


def shared_bucket(insts) -> Tuple[int, int, int]:
    """One (nc, nr, nnz_cap) bucket every corpus instance pads into."""
    nc = max(g.nc for g in insts)
    nr = max(g.nr for g in insts)
    cap = bucket_nnz(max(g.nnz_pad for g in insts))
    return nc, nr, cap


@dataclasses.dataclass
class CellResult:
    instance: str
    path: str
    warm_start: str
    expected: int
    cardinality: int = -1
    ok: bool = False
    error: str = ""
    artifact: str = ""


@dataclasses.dataclass
class FuzzReport:
    results: List[CellResult]

    @property
    def failures(self) -> List[CellResult]:
        return [r for r in self.results if not r.ok]

    def summary(self) -> str:
        n = len(self.results)
        bad = self.failures
        lines = [f"corpus fuzz: {n - len(bad)}/{n} cells ok"]
        lines += [f"  FAIL {r.instance} path={r.path} ws={r.warm_start} "
                  f"card={r.cardinality} expected={r.expected} "
                  f"{r.error} artifact={r.artifact or '-'}" for r in bad]
        return "\n".join(lines)


def minimize_failing_edges(cols, rows, nc: int, nr: int,
                           fails: Callable[[np.ndarray], bool],
                           max_checks: int = 64) -> np.ndarray:
    """ddmin-style edge-list minimization, budgeted by solver re-checks.

    Repeatedly drops contiguous chunks of the (col, row) edge list while
    ``fails`` keeps reproducing; returns the reduced ``(k, 2)`` edge array.
    The budget bounds total solver invocations, so a pathological failure
    cannot hang the harness.
    """
    edges = np.stack([np.asarray(cols, np.int64)[: len(rows)],
                      np.asarray(rows, np.int64)], axis=1)
    n, checks = 2, 0
    while edges.shape[0] >= 2 and checks < max_checks:
        chunk = -(-edges.shape[0] // n)
        reduced = False
        for i in range(0, edges.shape[0], chunk):
            cand = np.concatenate([edges[:i], edges[i + chunk:]])
            if cand.shape[0] == 0:
                continue
            checks += 1
            if fails(cand):
                edges, n, reduced = cand, max(2, n - 1), True
                break
            if checks >= max_checks:
                break
        if not reduced:
            if n >= edges.shape[0]:
                break
            n = min(edges.shape[0], n * 2)
    return edges


def _run_cell(path, g: BipartiteCSR, base: MatcherConfig, ws: str,
              pad, oracle: str = "maximum", device=None) -> Tuple[int, str]:
    """(cardinality, error) for one solve on ``device``; -1 cardinality on
    exception.

    ``oracle`` picks the contract checked beyond validity:
    ``"maximum"`` (default) leaves the cardinality comparison to the
    caller; ``"maximal"`` — the degraded-mode contract of a
    ``max_phases``-budgeted solve — additionally asserts no free column
    shares an edge with a free row.
    """
    try:
        cm, rm = path.run_host(g, base=base, warm_start=ws, pad=pad,
                               device=device)
        card = int(validate_matching(g, cm, rm))
        if oracle == "maximal" and not is_maximal(g, cm, rm):
            return card, "not maximal: a free column-free row edge remains"
        return card, ""
    except Exception as e:  # noqa: BLE001 — fuzzing: any failure is a finding
        return -1, f"{type(e).__name__}: {e}"


def _dump_artifact(artifact_dir: str, res: CellResult, g: BipartiteCSR,
                   cfg: MatcherConfig, edges: np.ndarray, seed: int,
                   minimized: bool) -> str:
    os.makedirs(artifact_dir, exist_ok=True)
    out = os.path.join(
        artifact_dir,
        f"corpus_failure_{res.instance}_{res.path}_{res.warm_start}.json")
    with open(out, "w") as f:
        json.dump({
            "schema": ARTIFACT_SCHEMA,
            "instance": res.instance, "path": res.path,
            "warm_start": res.warm_start,
            "config": dataclasses.asdict(cfg),
            "nc": g.nc, "nr": g.nr, "seed": seed,
            "expected": res.expected, "got": res.cardinality,
            "error": res.error, "minimized": minimized,
            "edges": edges.tolist(),
        }, f, indent=2, sort_keys=True)
    return out


def verify_corpus(scale: str = "mini",
                  paths: Optional[Sequence[str]] = None,
                  warm_starts: Sequence[str] = DEFAULT_WARM_STARTS,
                  rcp: bool = True, seed: int = 13,
                  families: Optional[Sequence[str]] = None,
                  base: MatcherConfig = MatcherConfig(),
                  artifact_dir: str = ".",
                  budget: Optional[int] = None,
                  minimize: bool = True,
                  minimize_budget: int = 64,
                  oracle: str = "maximum",
                  device=None) -> FuzzReport:
    """Run the differential matrix on ``device`` (None: the CUDA card,
    which must exist: no card raises at once, before any cell); a failing
    cell never raises — read ``.failures``.

    ``budget`` caps the number of (instance, path, warm start) cells; the
    enumeration rotates the path order per instance so a small budget still
    touches every solve path early.

    ``oracle="maximum"`` (default) demands Hopcroft-Karp cardinality;
    ``oracle="maximal"`` is the degraded-mode gate for phase-budgeted
    configs (``base.max_phases`` small): the matching must be valid,
    maximal, and no larger than the true maximum.
    """
    if oracle not in ("maximum", "maximal"):
        raise ValueError(f"unknown oracle {oracle!r}")
    device = resolve_device(device)
    insts = corpus_instances(scale, rcp=rcp, rcp_seed=seed,
                             families=families)
    names = list(paths) if paths is not None else list(SOLVE_PATHS)
    pad = shared_bucket(insts.values())
    expected = {k: oracle_cardinality(g) for k, g in insts.items()}

    cells = []
    for i, iname in enumerate(insts):
        for j in range(len(names)):
            pn = names[(i + j) % len(names)]
            cells.extend((iname, pn, ws) for ws in warm_starts)
    if budget is not None:
        cells = cells[:budget]

    results = []
    for iname, pn, ws in cells:
        g = insts[iname]
        path = SOLVE_PATHS[pn]
        card, err = _run_cell(path, g, base, ws, pad, oracle=oracle,
                              device=device)
        ok = not err and (card <= expected[iname] if oracle == "maximal"
                          else card == expected[iname])
        res = CellResult(instance=iname, path=pn, warm_start=ws,
                         expected=expected[iname], cardinality=card,
                         ok=ok, error=err)
        if not res.ok:
            edges = np.stack([g.ecol[: g.nnz], g.cadj[: g.nnz]], axis=1)
            minimized = False
            if minimize:
                # fixed-size bucket per candidate: one compiled program
                # serves every minimization re-check
                mpad = (g.nc, g.nr, bucket_nnz(g.nnz_pad))

                def fails(cand):
                    gg = BipartiteCSR.from_edges(cand[:, 0], cand[:, 1],
                                                 g.nc, g.nr)
                    c, e = _run_cell(path, gg, base, ws, mpad,
                                     oracle=oracle, device=device)
                    if oracle == "maximal":
                        return bool(e) or c > oracle_cardinality(gg)
                    return bool(e) or c != oracle_cardinality(gg)

                edges = minimize_failing_edges(
                    g.ecol[: g.nnz], g.cadj[: g.nnz], g.nc, g.nr, fails,
                    max_checks=minimize_budget)
                minimized = True
            res.artifact = _dump_artifact(
                artifact_dir, res, g, path.configure(base), edges, seed,
                minimized)
        results.append(res)
    return FuzzReport(results=results)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="differential fuzz: solve paths x warm starts x corpus")
    ap.add_argument("--scale", default="mini",
                    choices=["mini", "tiny", "small", "large"])
    ap.add_argument("--paths", default="",
                    help="comma-separated solve paths (default: all)")
    ap.add_argument("--warm-starts", default=",".join(DEFAULT_WARM_STARTS))
    ap.add_argument("--families", default="",
                    help="comma-separated families (default: all + mtx)")
    ap.add_argument("--no-rcp", action="store_true")
    ap.add_argument("--seed", type=int, default=13)
    ap.add_argument("--budget", type=int, default=0,
                    help="max cells to run (0 = the full matrix)")
    ap.add_argument("--artifact-dir", default=".")
    ap.add_argument("--minimize-budget", type=int, default=64)
    ap.add_argument("--oracle", default="maximum",
                    choices=["maximum", "maximal"],
                    help="maximal = degraded-mode gate: valid + maximal + "
                         "card <= HK optimum (use with --max-phases)")
    ap.add_argument("--max-phases", type=int, default=0,
                    help="phase budget for the base config (0 = unlimited); "
                         "implies degrade_maximal when --oracle maximal")
    ap.add_argument("--device", default=None,
                    help="torch device to solve on (default: the CUDA card; "
                         "cpu runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    base = MatcherConfig()
    if args.max_phases:
        base = dataclasses.replace(
            base, max_phases=args.max_phases,
            degrade_maximal=args.oracle == "maximal")
    report = verify_corpus(
        scale=args.scale,
        paths=args.paths.split(",") if args.paths else None,
        warm_starts=tuple(args.warm_starts.split(",")),
        rcp=not args.no_rcp, seed=args.seed,
        families=args.families.split(",") if args.families else None,
        base=base,
        artifact_dir=args.artifact_dir,
        budget=args.budget or None,
        minimize_budget=args.minimize_budget,
        oracle=args.oracle, device=args.device)
    print(report.summary(), flush=True)
    return 1 if report.failures else 0


if __name__ == "__main__":
    sys.exit(main())
