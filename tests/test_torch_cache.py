"""The port's compile cache (``repro_torch.matching.cache``) on the CPU.

The counterpart of ``tests/test_matching_api.py::test_compile_cache_reuse``
and more: hits, misses, LRU eviction by count (``set_max_entries``) and
by bytes (``set_max_bytes``), clearing and the per-thread tallies, and which runs share an entry.  The key is the
JAX package's: (bucket shape with the CSC marker, canonical config, warm
start with its version or ``"<resume>"``, entry point).  An entry holds
static buffers, so two graphs of one bucket in turn must each get their
own answer.
"""
import threading

import numpy as np
import pytest
from scipy.sparse.csgraph import maximum_bipartite_matching

from repro_torch.core import validate_matching
from repro_torch.graphs import random_bipartite
from repro_torch.matching import Matcher, MatcherConfig, TorchCSR
from repro_torch.matching import cache
from repro_torch.matching.cache import (compile_cache_clear,
                                        compile_cache_info,
                                        compile_cache_thread_info,
                                        set_max_bytes, set_max_entries)
from repro_torch.matching.warmstart import (WARM_STARTS, _VERSIONS,
                                            cheap_init, register_warm_start)


@pytest.fixture(autouse=True)
def fresh_cache():
    """Each test starts from an empty cache and leaves the capacity as it
    found it."""
    compile_cache_clear()
    cap, budget = cache.MAX_ENTRIES, cache.MAX_BYTES
    yield
    set_max_entries(cap)
    set_max_bytes(budget)
    compile_cache_clear()


def _maximum(g) -> int:
    """The maximum cardinality by scipy."""
    m = maximum_bipartite_matching(g.to_scipy().tocsr(), perm_type="column")
    return int((m >= 0).sum())


def _graph(seed=0, nnz_pad=512, n=96):
    g = random_bipartite(n, n, 3.0, seed=seed, pad_to=nnz_pad)
    return g, TorchCSR.from_host(g, device="cpu")


def test_compile_cache_reuse():
    _, graph = _graph()
    before = compile_cache_info()
    m = Matcher(MatcherConfig(algo="apsb"), warm_start="cheap")
    m.run(graph)
    mid = compile_cache_info()
    m.run(graph)                                   # same bucket: cache hit
    after = compile_cache_info()
    assert mid["misses"] == before["misses"] + 1
    assert after["misses"] == mid["misses"]
    assert after["hits"] == mid["hits"] + 1
    assert after["entries"] == 1


def test_key_separates_configs_warm_starts_resume_init_and_csc():
    _, graph = _graph()
    st = Matcher().run(graph)                      # (none, run)
    Matcher(warm_start="cheap").run(graph)         # another warm start
    Matcher(MatcherConfig(kernel="gpubfs")).run(graph)   # another config
    Matcher().run(graph, st)                       # the resume entry
    Matcher().solve(graph, st)                     # ... which solve shares
    Matcher(warm_start="cheap").init(graph)        # the init entry
    Matcher(MatcherConfig(kernel="gpubfs"),
            "cheap").init(graph)                   # init ignores the config
    Matcher().run(graph.with_csc())                # the CSC marker
    info = compile_cache_info()
    assert (info["misses"], info["hits"], info["entries"]) == (6, 2, 6)
    bucket = graph.bucket_key
    keys = set(info["keys"])
    cfg = MatcherConfig().canonical()
    assert (bucket, cfg, ("none", 0), "run") in keys
    assert (bucket, cfg, "<resume>", "run") in keys
    assert (bucket, None, ("cheap", 0), "init") in keys
    assert (bucket + ("csc",), cfg, ("none", 0), "run") in keys


def test_lru_eviction_and_set_max_entries():
    graphs = [_graph(n=n)[1] for n in (64, 80, 96)]
    assert set_max_entries(2) == 256
    m = Matcher()
    for g in graphs:
        m.run(g)
    info = compile_cache_info()
    assert (info["entries"], info["evictions"]) == (2, 1)
    assert [k[0] for k in info["keys"]] == [graphs[1].bucket_key,
                                            graphs[2].bucket_key]
    m.run(graphs[1])                        # a hit moves it to the MRU end
    assert compile_cache_info()["keys"][-1][0] == graphs[1].bucket_key
    assert set_max_entries(1) == 2          # shrinking evicts at once
    info = compile_cache_info()
    assert (info["entries"], info["evictions"]) == (1, 2)
    assert info["keys"][0][0] == graphs[1].bucket_key
    compile_cache_clear()
    info = compile_cache_info()
    assert (info["entries"], info["hits"], info["misses"],
            info["evictions"]) == (0, 0, 0, 0)


def test_lru_eviction_by_bytes():
    """Entries keep their buffers between calls, so the cache is also held
    to a byte budget: LRU entries leave while the entries' bytes exceed
    it, never the entry just used."""
    graphs = [_graph(n=n)[1] for n in (96, 80, 64)]   # each smaller
    m = Matcher(warm_start="cheap")
    m.run(graphs[0])
    first = compile_cache_info()["bytes"]
    assert first > 0
    m.run(graphs[1])
    both = compile_cache_info()["bytes"]
    assert both > first and compile_cache_info()["evictions"] == 0
    assert set_max_bytes(both) is None      # the default: no card here
    m.run(graphs[2])                        # over budget: the LRU leaves
    info = compile_cache_info()
    assert (info["entries"], info["evictions"]) == (2, 1)
    assert info["max_bytes"] == both and info["bytes"] <= both
    assert [k[0] for k in info["keys"]] == [graphs[1].bucket_key,
                                            graphs[2].bucket_key]
    set_max_bytes(1)                        # shrinking evicts at once ...
    info = compile_cache_info()
    assert (info["entries"], info["evictions"]) == (1, 2)
    m.run(graphs[0])                        # ... and never the entry in use
    info = compile_cache_info()
    assert (info["entries"], info["evictions"]) == (1, 3)
    assert info["keys"][0][0] == graphs[0].bucket_key


def test_thread_tallies_are_per_thread():
    _, graph = _graph()
    mine = compile_cache_thread_info()
    seen = {}

    def other():
        Matcher().run(graph)
        Matcher().run(graph)
        seen.update(compile_cache_thread_info())

    t = threading.Thread(target=other)
    t.start()
    t.join()
    assert seen == {"hits": 1, "misses": 1}
    assert compile_cache_thread_info() == mine
    Matcher().run(graph)                          # this thread: one hit
    assert compile_cache_thread_info() == {"hits": mine["hits"] + 1,
                                           "misses": mine["misses"]}


def test_graphs_of_one_bucket_each_get_their_own_answer():
    """An entry's buffers hold the last graph; the next graph of the bucket
    must not see it.  Each answer equals a run through a fresh cache."""
    pairs = [_graph(seed=s) for s in (1, 2, 3)]
    assert len({t.bucket_key for _, t in pairs}) == 1
    m = Matcher(MatcherConfig(), "karp_sipser")
    shared = [m.run(t) for _, t in pairs + pairs[:1]]
    assert compile_cache_info()["misses"] == 1
    for (g, t), got in zip(pairs + pairs[:1], shared):
        compile_cache_clear()
        want = Matcher(MatcherConfig(), "karp_sipser").run(t)
        np.testing.assert_array_equal(got.cmatch.numpy(), want.cmatch.numpy())
        np.testing.assert_array_equal(got.rmatch.numpy(), want.rmatch.numpy())
        cm, rm = got.to_host()
        assert validate_matching(g, cm, rm) == _maximum(g)


def test_reregistered_warm_start_gets_a_new_entry():
    _, graph = _graph()
    calls = []

    def custom(ecol, cadj, cmatch, rmatch):
        calls.append(1)
        return cheap_init(ecol, cadj, cmatch, rmatch)

    try:
        register_warm_start("custom_cache_test", custom)
        a = Matcher(warm_start="custom_cache_test").run(graph)
        register_warm_start("custom_cache_test", custom)
        b = Matcher(warm_start="custom_cache_test").run(graph)
        keys = [k[2] for k in compile_cache_info()["keys"]]
        assert keys == [("custom_cache_test", 0), ("custom_cache_test", 1)]
        assert len(calls) == 2
        np.testing.assert_array_equal(a.cmatch.numpy(), b.cmatch.numpy())
        want = Matcher(warm_start="cheap").run(graph)
        np.testing.assert_array_equal(a.cmatch.numpy(), want.cmatch.numpy())
    finally:
        WARM_STARTS.pop("custom_cache_test", None)
        _VERSIONS.pop("custom_cache_test", None)
