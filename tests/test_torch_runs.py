"""The port's ``Matcher.run`` against the JAX package.

Every loop of a solve is a step run while its ``live`` flag is set, the
flag tested before every step (by the host on the CPU, by the loop's
WHILE node on a card).  Each run must give the JAX ``Matcher.run``'s
``cmatch``, ``rmatch``, ``phases``, ``fallbacks`` and ``certified`` bit
for bit, on every ``instance_sets("mini")`` family, through every solve
path and from every warm start, also with a one-phase budget and maximal
degradation.  The JAX package holds its own solve paths to one result
(``tests/test_frontier_paths.py``), so each port path is held to the JAX
default path's.
"""
import functools

import numpy as np
import pytest

from repro.graphs import INSTANCE_FAMILIES, instance_sets
from repro.matching import DeviceCSR, Matcher as RefMatcher
from repro.matching import MatcherConfig as RefConfig

from repro_torch.matching import SOLVE_PATHS, Matcher, MatcherConfig, TorchCSR

_BUDGET = dict(max_phases=1, degrade_maximal=True)


@functools.lru_cache(maxsize=None)
def _mini():
    return instance_sets("mini")


def _ref(family, ws, budget):
    cfg = RefConfig(**(_BUDGET if budget else {}))
    return RefMatcher(cfg, ws).run(DeviceCSR.from_host(_mini()[family]))


@pytest.mark.parametrize("budget", [False, True], ids=["full", "budget"])
@pytest.mark.parametrize("ws", ["none", "cheap", "karp_sipser"])
@pytest.mark.parametrize("family", INSTANCE_FAMILIES)
def test_runs_equal_reference(family, ws, budget):
    want = _ref(family, ws, budget)
    g = _mini()[family]
    base = MatcherConfig(**(_BUDGET if budget else {}))
    for name, path in SOLVE_PATHS.items():
        cfg = path.configure(base)
        t = TorchCSR.from_host(g, device="cpu")
        got = Matcher(cfg, ws).run(t.with_csc() if cfg.dirop else t)
        np.testing.assert_array_equal(got.cmatch.numpy(),
                                      np.asarray(want.cmatch), name)
        np.testing.assert_array_equal(got.rmatch.numpy(),
                                      np.asarray(want.rmatch), name)
        assert (int(got.phases), int(got.fallbacks),
                bool(got.certified)) == (
            int(want.phases), int(want.fallbacks),
            bool(want.certified)), name
