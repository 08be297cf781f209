"""``Matcher.run`` through the port's solve paths against the JAX package.

The legacy (proposal kernel + ``scatter_min``), adaptive (compact column
gather), direction-optimizing (compact pull) and direction-optimizing
Pallas (pull kernel) paths must return the JAX package's matching bit for
bit: ``cmatch``/``rmatch`` with their sentinel slots, ``phases``,
``fallbacks`` and ``certified``.  Here each port path is held against the
same path of the JAX package over the paper's eight variants, pinned
directions and skewed degrees; ``tests/test_torch_matcher.py`` holds the
paths over the corpus families and warm starts.  The port runs on the CPU,
the JAX package with ``JAX_PLATFORMS=cpu`` and Pallas in interpret mode.
"""
import dataclasses
import functools

import numpy as np
import pytest

from repro.core import maximum_cardinality
from repro.graphs import instance_sets
from repro.graphs import random_bipartite, scaled_free
from repro.matching import DeviceCSR, Matcher as RefMatcher
from repro.matching import MatcherConfig as RefConfig
from repro.matching import SOLVE_PATHS as REF_PATHS

from repro_torch.core import validate_matching
from repro_torch.graphs import instance_sets as instance_sets_port
from repro_torch.matching import (SOLVE_PATHS, VARIANTS, Matcher,
                                  MatcherConfig, TorchCSR)

PATHS = ("legacy", "adaptive", "dirop", "dirop_pallas")


@functools.lru_cache(maxsize=None)
def _mini():
    return instance_sets("mini")


def _same(ours, ref):
    np.testing.assert_array_equal(ours.cmatch.numpy(), np.asarray(ref.cmatch))
    np.testing.assert_array_equal(ours.rmatch.numpy(), np.asarray(ref.rmatch))
    assert int(ours.phases) == int(ref.phases)
    assert int(ours.fallbacks) == int(ref.fallbacks)
    assert bool(ours.certified) == bool(ref.certified)


def _ref_run(g, cfg: RefConfig, ws):
    d = DeviceCSR.from_host(g)
    return RefMatcher(cfg, ws).run(d.with_csc() if cfg.dirop else d)


def _port_run(g, cfg: MatcherConfig, ws):
    """The port's state and its solver counts."""
    t = TorchCSR.from_host(g, device="cpu")
    m = Matcher(cfg, ws)
    out = m.run(t.with_csc() if cfg.dirop else t)
    c = m.last_counts
    assert c["levels"] == c["push_levels"] + c["pull_levels"] + \
        c["compact_levels"]
    return out, c


@pytest.mark.parametrize("i", range(8), ids=[v.name for v in VARIANTS])
@pytest.mark.parametrize("path", PATHS)
def test_path_equals_reference_path_over_variants(path, i):
    kw = dataclasses.asdict(VARIANTS[i])
    g = _mini()["rand_rect"]
    ref = _ref_run(g, REF_PATHS[path].configure(RefConfig(**kw)), "cheap")
    ours, _ = _port_run(g, SOLVE_PATHS[path].configure(MatcherConfig(**kw)),
                        "cheap")
    _same(ours, ref)
    assert bool(ours.certified)


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["dirop", "dirop_pallas"])
def test_dirop_forced_directions_agree(use_pallas):
    """Pinned to each extreme, always-pull-if-possible and never-pull give
    the JAX package's result, and the counters show the direction taken."""
    g = random_bipartite(220, 200, 3.5, seed=29)
    base = dict(algo="apfb", kernel="gpubfs_wr", dirop=True,
                use_pallas=use_pallas)
    for alpha in (1e6, 1e-6):
        kw = dict(base, dirop_alpha=alpha, dirop_beta=alpha)
        ours, c = _port_run(g, MatcherConfig(**kw), "none")
        _same(ours, _ref_run(g, RefConfig(**kw), "none"))
        if alpha == 1e6:
            assert c["pull_levels"] > 0, c
        else:
            assert c["push_levels"] > c["pull_levels"], c


@pytest.mark.parametrize("kw,seed,perm", [
    (dict(adaptive_frontier=True, compact_cap=64, compact_dmax=2), 3, None),
    (dict(dirop=True, pull_cap=64, pull_dmax=2), 7, 2),
], ids=["adaptive", "dirop"])
def test_compact_fallback_on_skewed_degrees(kw, seed, perm):
    """Power-law degrees exceed the compact geometry, so those levels fall
    back to the push sweep; the result stays the reference's, maximum."""
    g = scaled_free(300, 300, 5.0, seed=seed)
    if perm is not None:
        g = g.permuted(perm)
    kw = dict(kw, algo="apfb", kernel="gpubfs_wr")
    ours, c = _port_run(g, MatcherConfig(**kw), "none")
    _same(ours, _ref_run(g, RefConfig(**kw), "none"))
    assert c["push_levels"] > 0, c
    cm, rm = ours.to_host()
    assert validate_matching(g, cm, rm) == maximum_cardinality(g)


def test_registry_mirrors_reference():
    want = {n: (dict(p.overrides), p.sharded) for n, p in REF_PATHS.items()
            if p.runner is None}
    assert {n: (dict(p.overrides), p.sharded)
            for n, p in SOLVE_PATHS.items()} == want


@pytest.mark.parametrize("name", list(SOLVE_PATHS))
def test_run_host_pad_equals_reference(name):
    """``run_host(pad=(nc, nr, nnz_cap))`` solves the instance inside a
    declared bucket (one cache entry for every mini family) and strips the
    padding: the reference's ``run_host`` arrays with the same ``pad``, and
    without one.  The sharded path runs cold: the reference's sharded lane
    fails under a warm start (ROADMAP.md, Queue 3)."""
    from repro.corpus.verify import shared_bucket
    ws = "none" if name == "sharded" else "cheap"
    ref = _mini()
    ours = instance_sets_port("mini")
    pad = shared_bucket(ref.values())
    path, ref_path = SOLVE_PATHS[name], REF_PATHS[name]
    for k, g in ours.items():
        for p in (pad, None) if k in ("kron", "comb") else (pad,):
            cm, rm = path.run_host(g, warm_start=ws, device="cpu", pad=p)
            want = ref_path.run_host(ref[k], warm_start=ws, pad=p)
            assert cm.shape == (g.nc,) and rm.shape == (g.nr,), (k, p)
            np.testing.assert_array_equal(cm, want[0], err_msg=f"{k} {p}")
            np.testing.assert_array_equal(rm, want[1], err_msg=f"{k} {p}")
