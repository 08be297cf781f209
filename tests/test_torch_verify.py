"""The port's differential fuzzer (``repro_torch.corpus.verify``) against
the JAX package's harness.

The port's ``verify_corpus`` runs every port solve path × warm start over
the mini corpus (families, the ``.mtx`` fixture, their RCP twins) on the
CPU, against the port's Hopcroft–Karp, with no JAX.  It must find no
failure, and enumerate the reference harness's cells with the reference's
expectations: the reference harness is driven over the same names through
``runner`` hooks (which return an oracle matching, or the port's own
solve), so only its enumeration, oracle and checks run, no JAX solve.  A
path that drops one matched pair must give the reference harness's
minimised reproducer and artifact; the degraded-mode oracle holds a
phase-budgeted solve to maximality; the CLI runs on the CPU.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.corpus import verify as ref_verify
from repro.matching import MatcherConfig as RefConfig
from repro.matching import paths as ref_paths

from repro_torch.core.oracles import hopcroft_karp
from repro_torch.corpus import verify
from repro_torch.matching import (SOLVE_PATHS, MatcherConfig,
                                  register_solve_path, unregister_solve_path)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARM_STARTS = ("none", "cheap", "karp_sipser")


def _oracle_runner(g, base, warm_start):
    return hopcroft_karp(g)


def _port_runner(name):
    """A port path as a reference runner: the port's CPU solve."""
    def run(g, base, warm_start):
        return SOLVE_PATHS[name].run_host(
            g, base=MatcherConfig(**dataclasses.asdict(base)),
            warm_start=warm_start, device="cpu")
    return run


def _ref_report(runners, **kw):
    """The reference harness over ``runners`` (name -> runner), each
    registered as ``torch_<name>`` and unregistered again."""
    for name, runner in runners.items():
        ref_paths.register_solve_path(f"torch_{name}", runner=runner)
    try:
        return ref_verify.verify_corpus(
            paths=[f"torch_{n}" for n in runners], **kw)
    finally:
        for name in runners:
            ref_paths.unregister_solve_path(f"torch_{name}")


def _cells(report, strip=""):
    return [(r.instance, r.path[len(strip):], r.warm_start, r.expected)
            for r in report.results]


@pytest.mark.parametrize("name", list(SOLVE_PATHS))
def test_port_fuzz_matches_reference_cells(name, tmp_path):
    report = verify.verify_corpus(scale="mini", paths=[name],
                                  warm_starts=WARM_STARTS,
                                  artifact_dir=str(tmp_path), device="cpu")
    assert not report.failures, report.summary()
    ref = _ref_report({name: _oracle_runner}, scale="mini",
                      warm_starts=WARM_STARTS, artifact_dir=str(tmp_path))
    assert not ref.failures, ref.summary()
    assert _cells(report) == _cells(ref, "torch_")
    assert len(report.results) == 3 * len(verify.corpus_instances("mini"))
    assert all(r.cardinality == r.expected for r in report.results)


def test_budget_rotates_paths_as_reference(tmp_path):
    """One cell per instance under a budget of 7: the rotated path order
    touches every path, in the reference's order."""
    fams = ("rand", "sparse", "grid", "comb", "band", "kron", "free")
    kw = dict(scale="mini", warm_starts=("cheap",), families=fams,
              rcp=False, budget=7, artifact_dir=str(tmp_path))
    report = verify.verify_corpus(device="cpu", **kw)
    assert not report.failures, report.summary()
    assert {r.path for r in report.results} == set(SOLVE_PATHS)
    ref = _ref_report({n: _oracle_runner for n in SOLVE_PATHS}, **kw)
    assert _cells(report) == _cells(ref, "torch_")


def test_corpus_and_bucket_equal_reference():
    ours = verify.corpus_instances("mini")
    ref = ref_verify.corpus_instances("mini")
    assert list(ours) == list(ref)
    for k in ours:
        for f in ("cxadj", "cadj", "ecol"):
            np.testing.assert_array_equal(getattr(ours[k], f),
                                          getattr(ref[k], f), err_msg=k)
        assert verify.oracle_cardinality(ours[k]) == \
            ref_verify.oracle_cardinality(ref[k])
    assert verify.shared_bucket(ours.values()) == \
        ref_verify.shared_bucket(ref.values())


def _drop_one(g, base=None, warm_start="cheap"):
    """A broken path: Hopcroft–Karp's matching less its first pair."""
    cm, rm = hopcroft_karp(g)
    c = int(np.argmax(cm >= 0))
    rm[cm[c]] = -1
    cm[c] = -1
    return cm, rm


def test_broken_path_artifact_equals_reference(tmp_path):
    kw = dict(scale="mini", warm_starts=("cheap",), families=("mtx", "rand"),
              rcp=False, minimize_budget=32)
    register_solve_path("drop_one", runner=_drop_one)
    ref_paths.register_solve_path("drop_one", runner=_drop_one)
    try:
        ours = verify.verify_corpus(paths=("drop_one",), device="cpu",
                                    artifact_dir=str(tmp_path / "ours"), **kw)
        ref = ref_verify.verify_corpus(paths=("drop_one",),
                                       artifact_dir=str(tmp_path / "ref"),
                                       **kw)
    finally:
        unregister_solve_path("drop_one")
        ref_paths.unregister_solve_path("drop_one")
    assert "drop_one" not in SOLVE_PATHS
    assert len(ours.failures) == len(ref.failures) == 2
    for a, b in zip(ours.failures, ref.failures):
        assert (a.instance, a.expected, a.cardinality, a.error) == \
            (b.instance, b.expected, b.cardinality, b.error)
        assert a.cardinality == a.expected - 1
        with open(a.artifact) as f:
            art = json.load(f)
        with open(b.artifact) as f:
            want = json.load(f)
        assert art == want
        assert art["schema"] == verify.ARTIFACT_SCHEMA and art["minimized"]
        assert 1 <= len(art["edges"]) <= 4
    assert os.path.basename(ours.failures[0].artifact) == \
        os.path.basename(ref.failures[0].artifact)


@pytest.mark.parametrize("degrade", [True, False])
def test_maximal_oracle_under_a_phase_budget(degrade, tmp_path):
    """``max_phases=1``: with ``degrade_maximal`` every cell is valid,
    maximal and at most HK's; the reference harness, driving the port's
    solves, finds the same cells.  Without it the one phase leaves a free
    column beside a free row somewhere, which the oracle reports."""
    base = dataclasses.replace(MatcherConfig(), max_phases=1,
                               degrade_maximal=degrade)
    kw = dict(scale="mini", warm_starts=("none",), oracle="maximal",
              minimize=False, artifact_dir=str(tmp_path))
    names = ("jnp", "dirop_pallas")
    ours = verify.verify_corpus(paths=names, base=base, device="cpu", **kw)
    ref = _ref_report({n: _port_runner(n) for n in names},
                      base=RefConfig(**dataclasses.asdict(base)), **kw)
    got = [(r.instance, r.path, r.cardinality, r.ok, r.error)
           for r in ours.results]
    assert got == [(r.instance, r.path[len("torch_"):], r.cardinality, r.ok,
                    r.error) for r in ref.results]
    assert any(r.cardinality < r.expected for r in ours.results)
    if degrade:
        assert not ours.failures, ours.summary()
    else:
        assert ours.failures
        assert all(r.error.startswith("not maximal") for r in ours.failures)


def test_cli_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.corpus.verify", "--scale", "mini",
         "--families", "rand,comb", "--budget", "10", "--device", "cpu",
         "--artifact-dir", str(tmp_path)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "10/10 cells ok" in r.stdout


def test_default_device_is_the_card(tmp_path):
    """No device named: the CUDA card; with no card it raises before any
    cell."""
    if torch.cuda.is_available():
        report = verify.verify_corpus(scale="mini", budget=1,
                                      artifact_dir=str(tmp_path))
        assert not report.failures, report.summary()
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        verify.verify_corpus(scale="mini", budget=1,
                             artifact_dir=str(tmp_path))
