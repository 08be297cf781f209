"""The port's solve paths in the JAX package's differential corpus.

Each path of ``repro_torch.matching.SOLVE_PATHS`` joins the registry of
``repro.matching.paths`` through its ``runner`` hook, as ``torch_<name>``,
and ``repro.corpus.verify.verify_corpus`` runs it over every mini family,
its RCP twin and every warm start against the Hopcroft-Karp oracle: a valid
matching of maximum cardinality, or a finding with a minimized reproducer.
The port runs on the CPU.  The registrations are removed again in
``finally``: other tests assert the JAX registry's exact contents, and one
test worker may run several files in one process.
"""
import dataclasses

import pytest

from repro.corpus.verify import corpus_instances, verify_corpus
from repro.matching.paths import register_solve_path, unregister_solve_path

from repro_torch.matching import SOLVE_PATHS, MatcherConfig

WARM_STARTS = ("none", "cheap", "karp_sipser")


def _runner(path):
    def run(g, base, warm_start):
        cfg = MatcherConfig(**dataclasses.asdict(base))
        return path.run_host(g, base=cfg, warm_start=warm_start,
                             device="cpu")
    return run


@pytest.mark.parametrize("name", list(SOLVE_PATHS))
def test_port_path_passes_corpus(name, tmp_path):
    reg = f"torch_{name}"
    register_solve_path(reg, runner=_runner(SOLVE_PATHS[name]))
    try:
        report = verify_corpus(scale="mini", paths=[reg],
                               warm_starts=WARM_STARTS,
                               artifact_dir=str(tmp_path))
    finally:
        unregister_solve_path(reg)
    assert not report.failures, report.summary()
    assert len(report.results) == len(WARM_STARTS) * len(
        corpus_instances("mini"))
