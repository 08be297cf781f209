"""The port's dirop replay (``repro_torch.corpus.heuristic``) against the
JAX package's, and pinned to the port's own solves.

``trace_instance(device="cpu")`` must give the reference's trace exactly
(every phase's per-level ``(fe, pe, touched)``, and ``nnz_pad``) on every
mini family, its RCP twin and the ``.mtx`` fixture, under ``cheap`` and
``karp_sipser``, and ``modelled_rel`` the reference's numbers over
``sweep_grid()``.  Three relations to the port's solves of the same graph
and warm start are exact (offset 0), and ``chip_smoke.py`` holds the card
to them at full width:

(i)   traced phases == the default solve's ``phases`` (the trace also
      replays the last phase, the one that finds no augmenting path, as
      the solver runs it);
(ii)  traced levels == the default solve's BFS levels (``last_counts``:
      each phase's last level, the one that inserts nothing, on both
      sides);
(iii) ``modelled_rel(trace, a, b)[1]`` == the ``pull_levels`` of a
      ``dirop_pallas`` solve under the same ``a``, ``b`` (its pull kernel
      has no compact-geometry test, so its decision is the model's rule).
"""
import functools

import pytest

from repro.corpus import heuristic as ref_heuristic
from repro.graphs import instance_sets as ref_instance_sets
from repro.graphs import mtx_fixture as ref_mtx_fixture

from repro_torch.corpus import heuristic
from repro_torch.corpus.heuristic import modelled_rel, sweep_grid
from repro_torch.graphs import INSTANCE_FAMILIES, instance_sets, mtx_fixture
from repro_torch.matching import Matcher, MatcherConfig, TorchCSR

NAMES = (list(INSTANCE_FAMILIES) + [f"{f}_rcp" for f in INSTANCE_FAMILIES]
         + ["mtx"])
WARM_STARTS = ("cheap", "karp_sipser")


@functools.lru_cache(maxsize=None)
def _sets():
    ours, ref = instance_sets("mini", rcp=True), ref_instance_sets(
        "mini", rcp=True)
    ours["mtx"], ref["mtx"] = mtx_fixture(), ref_mtx_fixture()
    return ours, ref


def _solve(g, cfg, ws):
    graph = TorchCSR.from_host(g, device="cpu")
    m = Matcher(cfg, ws)
    state = m.run(graph.with_csc() if cfg.dirop else graph)
    return state, m.last_counts


@pytest.mark.parametrize("ws", WARM_STARTS)
@pytest.mark.parametrize("name", NAMES)
def test_trace_equals_reference_and_pins_the_solver(name, ws):
    ours, ref = _sets()
    g = ours[name]
    tr = heuristic.trace_instance(g, ws, device="cpu")
    want = ref_heuristic.trace_instance(ref[name], ws)
    assert tr.phases == want.phases
    assert tr.nnz_pad == want.nnz_pad == g.nnz_pad
    assert (tr.ntiles, tr.levels) == (want.ntiles, want.levels)
    for a, b in sweep_grid():
        assert modelled_rel(tr, a, b) == ref_heuristic.modelled_rel(
            want, a, b), (a, b)

    state, counts = _solve(g, MatcherConfig(), ws)
    assert len(tr.phases) == int(state.phases)                  # (i)
    assert tr.levels == counts["levels"]                        # (ii)
    for a, b in ((8.0, 32.0), (1.0, 4.0), (1e6, 1e6)):
        _, dc = _solve(g, MatcherConfig(dirop=True, use_pallas=True,
                                        dirop_alpha=a, dirop_beta=b), ws)
        assert modelled_rel(tr, a, b)[1] == dc["pull_levels"], (a, b)  # (iii)
        assert dc["levels"] == tr.levels


def test_model_constants_equal_reference():
    assert (heuristic.LANE, heuristic.PULL_TILE_OVERHEAD,
            heuristic.PULL_STREAM_FRACTION) == (
        ref_heuristic.LANE, ref_heuristic.PULL_TILE_OVERHEAD,
        ref_heuristic.PULL_STREAM_FRACTION)
    assert tuple(sweep_grid()) == tuple(ref_heuristic.sweep_grid())


def test_trace_under_a_phase_cap():
    """``max_phases`` stops the replay early, as in the reference."""
    ours, ref = _sets()
    tr = heuristic.trace_instance(ours["sparse"], "none", max_phases=2,
                                  device="cpu")
    want = ref_heuristic.trace_instance(ref["sparse"], "none", max_phases=2)
    assert len(tr.phases) == 2 and tr.phases == want.phases
