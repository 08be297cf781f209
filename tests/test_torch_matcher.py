"""``Matcher.run`` of the port against ``Matcher.run`` of the JAX package.

The matcher is deterministic, so the port must return the same matching bit
for bit: ``cmatch``/``rmatch`` with their sentinel slots, ``phases``,
``fallbacks`` and ``certified``, over the paper's eight variants, the three
warm starts on every corpus family (through every solve path), a phase
budget with maximal degradation, a bounded BFS tail, and the numpy-in,
numpy-out wrapper.  The
port runs on the CPU, the JAX package with ``JAX_PLATFORMS=cpu``; the same
comparison on the card is in ``chip_smoke.py``.
"""
import dataclasses
import functools

import numpy as np
import pytest

from repro.core import maximum_matching as ref_maximum_matching
from repro.core import validate_matching as ref_validate_matching
from repro.graphs import INSTANCE_FAMILIES, instance_sets
from repro.matching import DeviceCSR, Matcher as RefMatcher
from repro.matching import MatcherConfig as RefConfig, VARIANTS as REF_VARIANTS

from repro_torch.core import is_maximal, maximum_matching
from repro_torch.matching import (SOLVE_PATHS, VARIANTS, Matcher,
                                  MatcherConfig, TorchCSR,
                                  maximum_matching_device)


@functools.lru_cache(maxsize=None)
def _mini():
    return instance_sets("mini")


def _same(ours, ref):
    np.testing.assert_array_equal(ours.cmatch.numpy(), np.asarray(ref.cmatch))
    np.testing.assert_array_equal(ours.rmatch.numpy(), np.asarray(ref.rmatch))
    assert int(ours.phases) == int(ref.phases)
    assert int(ours.fallbacks) == int(ref.fallbacks)
    assert bool(ours.certified) == bool(ref.certified)


def _run_both(g, cfg_kw, ws):
    ref = RefMatcher(RefConfig(**cfg_kw), ws).run(DeviceCSR.from_host(g))
    ours = Matcher(MatcherConfig(**cfg_kw), ws).run(
        TorchCSR.from_host(g, device="cpu"))
    _same(ours, ref)
    return ours


@pytest.mark.parametrize("i", range(8), ids=[v.name for v in VARIANTS])
def test_run_equals_reference_over_variants(i):
    cfg = dataclasses.asdict(VARIANTS[i])
    assert dataclasses.asdict(REF_VARIANTS[i]) == cfg
    for ws in ("none", "karp_sipser"):
        out = _run_both(_mini()["rand_rect"], cfg, ws)
        assert bool(out.certified)


@functools.lru_cache(maxsize=None)
def _ref_default(family, ws):
    return RefMatcher(RefConfig(), ws).run(DeviceCSR.from_host(_mini()[family]))


@pytest.mark.parametrize("ws", ["none", "cheap", "karp_sipser"])
@pytest.mark.parametrize("family", INSTANCE_FAMILIES)
def test_run_equals_reference_over_families_and_warm_starts(family, ws):
    ours = Matcher(MatcherConfig(), ws).run(
        TorchCSR.from_host(_mini()[family], device="cpu"))
    _same(ours, _ref_default(family, ws))


@pytest.mark.parametrize("ws", ["none", "cheap", "karp_sipser"])
@pytest.mark.parametrize("family", INSTANCE_FAMILIES)
def test_paths_equal_reference_over_families_and_warm_starts(family, ws):
    """Every solve path of the port gives the JAX package's default-path
    result, which the JAX package holds its own paths to bit for bit
    (``tests/test_frontier_paths.py``)."""
    g = _mini()[family]
    for name in ("legacy", "adaptive", "dirop", "dirop_pallas"):
        cfg = SOLVE_PATHS[name].configure(MatcherConfig())
        t = TorchCSR.from_host(g, device="cpu")
        ours = Matcher(cfg, ws).run(t.with_csc() if cfg.dirop else t)
        _same(ours, _ref_default(family, ws))


@pytest.mark.parametrize("cfg_kw", [
    dict(max_phases=1, degrade_maximal=True),
    dict(max_phases=2),
    dict(tail_levels=2),
    dict(algo="apsb", kernel="gpubfs_wr", wr_exact=True, tail_levels=1),
    dict(use_pallas=True),
], ids=str)
@pytest.mark.parametrize("family", ["kron", "comb"])
def test_run_equals_reference_budget_and_tail(family, cfg_kw):
    g = _mini()[family]
    out = _run_both(g, cfg_kw, "none")
    if cfg_kw.get("degrade_maximal"):
        cm, rm = out.to_host()
        assert is_maximal(g, cm, rm)


def test_resume_from_explicit_state_and_numpy_wrapper():
    g = _mini()["community"]
    cfg = MatcherConfig(kernel="gpubfs", schedule="mt")
    rng = np.random.default_rng(0)
    # a partial, valid start: the first matched pairs of a cheap matching
    cm0, rm0, _ = ref_maximum_matching(g, RefConfig(max_phases=1))
    drop = rng.random(g.nc) < 0.5
    rm0 = np.where(np.isin(rm0, np.nonzero(drop)[0]), -1, rm0)
    cm0 = np.where(drop, -1, cm0)
    want_cm, want_rm, want = ref_maximum_matching(
        g, RefConfig(**dataclasses.asdict(cfg)), cm0, rm0)
    cm, rm, stats = maximum_matching(g, cfg, cm0, rm0, device="cpu")
    np.testing.assert_array_equal(cm, want_cm)
    np.testing.assert_array_equal(rm, want_rm)
    assert stats == want
    assert ref_validate_matching(g, cm, rm) == stats["cardinality"]


def test_stats_and_functional_entry():
    g = _mini()["band"]
    out = maximum_matching_device(TorchCSR.from_host(g, device="cpu"))
    m = Matcher()
    s = m.stats(out).as_dict()
    assert s["variant"] == MatcherConfig().name
    assert s["certified"] is True and s["cardinality"] == int(
        out.cardinality)
