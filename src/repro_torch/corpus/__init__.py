"""Corpus-driven differential verification, on the card.

Two pieces, both enumerating the registered surfaces instead of
hand-rolled lists, as the JAX package's ``repro.corpus`` does:

* :mod:`repro_torch.corpus.verify` — the differential fuzz harness: every
  registered solve path (:data:`repro_torch.matching.SOLVE_PATHS`) × warm
  start over every corpus family (original + RCP), cardinality checked
  against the host Hopcroft-Karp oracle, with a minimized failing-edge-list
  artifact dumped on mismatch.  ``python -m repro_torch.corpus.verify`` is
  the CLI.
* :mod:`repro_torch.corpus.heuristic` — a deterministic replay of the
  direction-optimizing push/pull decisions with a documented work model,
  so the dirop ``alpha``/``beta`` defaults can be priced per family without
  timing noise.
"""
from .heuristic import (PULL_STREAM_FRACTION, modelled_rel, sweep_grid,
                        trace_instance)
from .verify import (CellResult, FuzzReport, corpus_instances,
                     minimize_failing_edges, oracle_cardinality,
                     verify_corpus)

__all__ = [
    "CellResult", "FuzzReport", "corpus_instances", "minimize_failing_edges",
    "oracle_cardinality", "verify_corpus",
    "PULL_STREAM_FRACTION", "modelled_rel", "sweep_grid", "trace_instance",
]
