"""The port's edge-sharded matcher against its single-device matcher and the
JAX package's.

* Graphs: ``per_shard_nnz`` and ``TorchCSR.shard`` against the JAX
  package's (each shard's slice of ``ecol``/``cadj``/``radj``/``erow``/
  ``eperm`` is the reference's ``pad_to(D * per_shard)`` leaf cut the same
  way), the graph taken through ``interop.csr_from_reference``.
* Port against port: ``ShardedMatcher`` over D = 1..4 shards on the CPU
  equals the single-device ``Matcher.run`` bit for bit (``cmatch``,
  ``rmatch``, ``phases``, ``fallbacks``, ``certified``) over the
  reference's four test graphs (``tests/test_distributed.py``), both
  algorithms, every warm start and the five kernel paths; each
  combination runs at one D, the D rotating so that each meets every path.
* Port against the JAX single-device ``Matcher``: the same graphs,
  algorithms and warm starts, bit for bit (the JAX sharded lane fails
  under a warm start, ROADMAP.md Queue 3).
* Port against the JAX ``ShardedMatcher`` and ``maximum_matching_
  distributed`` on a forced four-device host, under ``warm_start="none"``
  where the reference runs: one subprocess writes its states to an
  ``.npz``.
* The compile cache, resume, the phase budget, the mesh's refusals.

Every comparison is exact (tolerance 0: the outputs are integers).
"""
import itertools
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import cheap_matching_jax
from repro.graphs import grid_graph, random_bipartite, scaled_free
from repro.matching import DeviceCSR, Matcher as RefMatcher
from repro.matching import MatcherConfig as RefConfig
from repro.matching.device_csr import per_shard_nnz as ref_per_shard_nnz

from repro_torch.core import is_maximal, validate_matching
from repro_torch.core.distributed import maximum_matching_distributed
from repro_torch.interop import csr_from_reference
from repro_torch.matching import (SOLVE_PATHS, Matcher, MatcherConfig,
                                  MatchState, ShardedMatcher, TorchCSR,
                                  compile_cache_clear, compile_cache_info,
                                  make_mesh, match_sharded, mesh_cache_key)
from repro_torch.matching.device_csr import per_shard_nnz
from repro_torch.matching.sharded import merge_bytes
from repro_torch.matching.solve import Solver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("cmatch", "rmatch", "phases", "fallbacks", "certified")
GRAPHS = ("rand", "grid", "rect", "free")
ALGOS = ("apfb", "apsb")
WARM_STARTS = ("none", "cheap", "karp_sipser")
PATHS = ("jnp", "legacy", "fused", "dirop", "dirop_pallas")
SHARDS = (1, 2, 3, 4)

_CASES = {}


def case(name):
    """The reference's test graphs (``tests/test_distributed.py``)."""
    if name not in _CASES:
        _CASES[name] = {
            "rand": lambda: random_bipartite(500, 500, 4.0, seed=2),
            "grid": lambda: grid_graph(18),
            "rect": lambda: random_bipartite(300, 450, 3.0, seed=3),
            "free": lambda: scaled_free(400, 400, 5.0, seed=4).permuted(1),
        }[name]()
    return _CASES[name]


def mesh(d, axis="data"):
    return make_mesh((d,), (axis,), devices=["cpu"] * d)


def upload(g, cfg):
    t = TorchCSR.from_host(g, device="cpu")
    return t.with_csc() if cfg.dirop else t


def same(a, b, what=""):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        np.testing.assert_array_equal(x, y, err_msg=f"{what} {f}")


# ---------------------------------------------------------------------------
# Graphs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d", SHARDS)
def test_per_shard_nnz_equals_reference(d):
    for cap in (128, 256, 1000, 2048, 3072, 4096, 1 << 20):
        assert per_shard_nnz(cap, d) == ref_per_shard_nnz(cap, d), cap


@pytest.mark.parametrize("d", SHARDS)
def test_shard_slices_equal_reference_leaves(d):
    """Each shard's slices are the reference's ``pad_to(D * per_shard)``
    leaves cut into D, with and without the CSC mirror; the bucket key
    is the reference's; a second ``shard`` is a no-op."""
    g = case("free")
    for csc in (False, True):
        ref = DeviceCSR.from_host(g).bucketed()
        if csc:
            ref = ref.with_csc()
        leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(ref)]
        t = csr_from_reference(leaves, ref.nc, ref.nr, device="cpu")
        m = mesh(d)
        s = t.shard(m, "data")
        per = per_shard_nnz(ref.nnz_pad, d)
        want = ref.pad_to(d * per)
        assert s.nnz_pad == want.nnz_pad == d * per
        assert s.bucket_key == want.bucket_key
        assert (s.mesh, s.axis, s.shards) == (m, "data", d)
        names = ("ecol", "cadj") + (("radj", "erow", "eperm") if csc else ())
        for name in names:
            full = np.asarray(getattr(want, name))
            parts = s.shard_slices(name)
            assert len(parts) == d
            for i, part in enumerate(parts):
                np.testing.assert_array_equal(
                    part.numpy(), full[i * per:(i + 1) * per],
                    err_msg=f"{name} shard {i}")
        for name in ("cxadj",) + (("rxadj",) if csc else ()):
            np.testing.assert_array_equal(getattr(s, name).numpy(),
                                          np.asarray(getattr(want, name)))
        assert s.shard(m, "data") is s
        assert s.shard(mesh(d, "rows"), "rows").axis == "rows"


# ---------------------------------------------------------------------------
# Port against port: every combination at one D
# ---------------------------------------------------------------------------
COMBOS = list(itertools.product(GRAPHS, ALGOS, WARM_STARTS, PATHS))
# D rotates with the combination's index: 120 combinations over 4 shard
# counts, so each path (24 combinations) meets every D
_D = {c: SHARDS[i % len(SHARDS)] for i, c in enumerate(COMBOS)}


@pytest.mark.parametrize("graph,algo,ws,path", COMBOS,
                         ids=["-".join(c) + f"-D{_D[c]}" for c in COMBOS])
def test_sharded_equals_single_device(graph, algo, ws, path):
    d = _D[(graph, algo, ws, path)]
    g = case(graph)
    cfg = SOLVE_PATHS[path].configure(MatcherConfig(algo=algo,
                                                    kernel="gpubfs_wr"))
    t = upload(g, cfg)
    want = Matcher(cfg, ws).run(t)
    m = ShardedMatcher(mesh(d), "data", cfg, ws)
    got = m.run(t)
    same(got, want, (graph, algo, ws, path, d))
    c = m.last_counts
    assert c["merges"] == c["levels"] > 0
    assert c["merge_bytes"] == c["merges"] * merge_bytes(d, g.nr)
    cm, rm = got.to_host()
    assert validate_matching(g, cm, rm) == int(got.cardinality)


_REF_SINGLE = {}


@pytest.mark.parametrize("graph,algo,ws",
                         list(itertools.product(GRAPHS, ALGOS, WARM_STARTS)))
def test_sharded_equals_reference_single_device(graph, algo, ws):
    """The JAX single-device ``Matcher`` (its default path, to which it
    holds its own paths bit for bit) against the port's sharded matcher
    at D = 4 (the dirop path on ``apsb``)."""
    g = case(graph)
    ref = RefMatcher(RefConfig(algo=algo, kernel="gpubfs_wr"), ws).run(
        DeviceCSR.from_host(g))
    path = "dirop_pallas" if algo == "apsb" else "jnp"
    cfg = SOLVE_PATHS[path].configure(MatcherConfig(algo=algo,
                                                    kernel="gpubfs_wr"))
    got = ShardedMatcher(mesh(4), "data", cfg, ws).run(upload(g, cfg))
    same(got, ref, (graph, algo, ws))


# ---------------------------------------------------------------------------
# Port against the JAX ShardedMatcher on a forced four-device host
# ---------------------------------------------------------------------------
REF_SHARDED = """
import sys
import jax, numpy as np
from repro.core import MatcherConfig, cheap_matching_jax
from repro.core.distributed import maximum_matching_distributed
from repro.graphs import grid_graph, random_bipartite, scaled_free
from repro.matching import DeviceCSR, ShardedMatcher
assert jax.device_count() == 4, jax.device_count()
mesh = jax.make_mesh((4,), ("data",))
cases = {
    "rand": random_bipartite(500, 500, 4.0, seed=2),
    "grid": grid_graph(18),
    "rect": random_bipartite(300, 450, 3.0, seed=3),
    "free": scaled_free(400, 400, 5.0, seed=4).permuted(1),
}
out = {}
for name, g in cases.items():
    for algo in ("apfb", "apsb"):
        for sweep in ("push", "dirop"):
            cfg = MatcherConfig(algo=algo, kernel="gpubfs_wr",
                                dirop=sweep == "dirop")
            d = DeviceCSR.from_host(g)
            d = d.with_csc() if cfg.dirop else d
            st = ShardedMatcher(mesh, config=cfg).run(d.shard(mesh, "data"))
            for f in ("cmatch", "rmatch", "phases", "fallbacks",
                      "certified"):
                out[f"{name}-{algo}-{sweep}:{f}"] = np.asarray(getattr(st, f))
g = cases["rect"]
cm0, rm0 = cheap_matching_jax(g)
for algo in ("apfb", "apsb"):
    cm, rm, st = maximum_matching_distributed(
        g, mesh, MatcherConfig(algo=algo, kernel="gpubfs_wr"),
        cmatch0=cm0, rmatch0=rm0)
    out[f"dist-{algo}:cmatch"], out[f"dist-{algo}:rmatch"] = cm, rm
    out[f"dist-{algo}:stats"] = np.array(
        [st["phases"], st["fallbacks"], st["cardinality"], st["devices"]])
np.savez(sys.argv[1], **out)
print("REF_OK")
"""


@pytest.fixture(scope="module")
def ref_sharded(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref_sharded") / "states.npz")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=f"{REPO}/src")
    r = subprocess.run([sys.executable, "-c", REF_SHARDED, path], env=env,
                       capture_output=True, text=True, timeout=400)
    assert "REF_OK" in r.stdout, r.stderr[-3000:]
    return dict(np.load(path))


@pytest.mark.parametrize("graph,algo,sweep",
                         list(itertools.product(GRAPHS, ALGOS,
                                                ("push", "dirop"))))
def test_sharded_equals_reference_sharded(ref_sharded, graph, algo, sweep):
    cfg = MatcherConfig(algo=algo, kernel="gpubfs_wr",
                        dirop=sweep == "dirop")
    got = ShardedMatcher(mesh(4), config=cfg).run(upload(case(graph), cfg))
    key = f"{graph}-{algo}-{sweep}"
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      ref_sharded[f"{key}:{f}"], err_msg=f)


@pytest.mark.parametrize("algo", ALGOS)
def test_distributed_equals_reference(ref_sharded, algo):
    """``core.distributed.maximum_matching_distributed``, resumed from the
    reference's cheap matching, against the reference's on four
    devices."""
    g = case("rect")
    cm0, rm0 = (np.asarray(x) for x in cheap_matching_jax(g))
    cm, rm, st = maximum_matching_distributed(
        g, mesh(4), MatcherConfig(algo=algo, kernel="gpubfs_wr"),
        cmatch0=cm0, rmatch0=rm0)
    np.testing.assert_array_equal(cm, ref_sharded[f"dist-{algo}:cmatch"])
    np.testing.assert_array_equal(rm, ref_sharded[f"dist-{algo}:rmatch"])
    np.testing.assert_array_equal(
        [st["phases"], st["fallbacks"], st["cardinality"], st["devices"]],
        ref_sharded[f"dist-{algo}:stats"])
    assert st["variant"] == f"dist-{MatcherConfig(algo=algo).name}"


# ---------------------------------------------------------------------------
# Resume, budget, refusals, cache
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d", (2, 3))
def test_resume_from_an_explicit_state(d):
    g = case("rand")
    t = TorchCSR.from_host(g, device="cpu")
    warm = Matcher(MatcherConfig(), "karp_sipser").init(t)
    want = Matcher(MatcherConfig()).run(t, warm)
    got = ShardedMatcher(mesh(d)).run(t, warm)
    same(got, want)
    same(match_sharded(t, mesh(d), state=warm), want)


@pytest.mark.parametrize("d", (2, 4))
def test_phase_budget_degrades_to_a_maximal_matching(d):
    """A ``max_phases`` budget cuts the solve short: uncertified, and with
    ``degrade_maximal`` made maximal by one cheap round over the whole
    edge list, as the single-device matcher does."""
    g = case("grid")
    cfg = MatcherConfig(max_phases=1, degrade_maximal=True)
    t = TorchCSR.from_host(g, device="cpu")
    want = Matcher(cfg, "none").run(t)
    got = ShardedMatcher(mesh(d), config=cfg).run(t)
    same(got, want)
    assert not bool(got.certified)
    cm, rm = got.to_host()
    assert is_maximal(g, cm, rm)


def test_adaptive_frontier_and_batches_are_refused():
    with pytest.raises(ValueError, match="adaptive_frontier"):
        ShardedMatcher(mesh(2), config=MatcherConfig(adaptive_frontier=True))
    with pytest.raises(ValueError, match="adaptive_frontier"):
        Solver(MatcherConfig(adaptive_frontier=True), 8, 8, shards=2)
    with pytest.raises(ValueError, match="axis"):
        ShardedMatcher(mesh(2), axis="rows")
    t = TorchCSR.from_host(case("rand"), device="cpu")
    with pytest.raises(NotImplementedError, match="run_many"):
        ShardedMatcher(mesh(2)).run_many(TorchCSR.stack([t, t]))
    with pytest.raises(ValueError, match="with_csc"):
        ShardedMatcher(mesh(2), config=MatcherConfig(dirop=True)).run(t)


def test_mesh_rules():
    m = make_mesh((2, 3), ("data", "model"), devices=["cpu"] * 6)
    assert m.shape == {"data": 2, "model": 3} and m.size == 6
    assert m.device == torch.device("cpu")
    t = TorchCSR.from_host(case("rect"), device="cpu").shard(m, "model")
    assert t.shards == 3 and len(t.shard_slices("ecol")) == 3
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh((4,), ("data",), devices=["cpu"])
    with pytest.raises(NotImplementedError, match="Queue 1, item 13"):
        make_mesh((2,), ("data",), devices=["cpu", "cuda:0"])
    assert make_mesh((1,), ("data",), device="cpu").devices == (
        torch.device("cpu"),)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make_mesh((1,), ("data",))
    assert mesh_cache_key(mesh(2), "data") == (
        (("data", 2),), ("cpu", "cpu"), "data")
    st = ShardedMatcher(mesh(3), config=MatcherConfig()).stats(
        MatchState.fresh(4, 4, device="cpu"))
    assert st.variant == f"sharded-{MatcherConfig().name}@3"


def test_sharded_runs_share_the_compile_cache():
    """The reference's cache scenario: a repeated same-bucket call hits;
    another bucket, another axis name or another mesh size misses."""
    compile_cache_clear()
    rand = TorchCSR.from_host(case("rand"), device="cpu").shard(mesh(4),
                                                                 "data")
    m = ShardedMatcher(mesh(4), config=MatcherConfig(), warm_start="cheap")
    c0 = int(m.run(rand).cardinality)
    info1 = compile_cache_info()
    c1 = int(m.run(rand).cardinality)
    info2 = compile_cache_info()
    assert c0 == c1
    assert info2["misses"] == info1["misses"]
    assert info2["hits"] == info1["hits"] + 1
    m.run(TorchCSR.from_host(case("grid"), device="cpu"))   # other bucket
    info3 = compile_cache_info()
    assert info3["misses"] == info2["misses"] + 1
    ShardedMatcher(mesh(4, "rows"), "rows", warm_start="cheap").run(rand)
    info4 = compile_cache_info()
    assert info4["misses"] == info3["misses"] + 1
    ShardedMatcher(mesh(2), warm_start="cheap").run(rand)
    assert compile_cache_info()["misses"] == info4["misses"] + 1
    # the single-device entry of the same bucket is another program
    Matcher(MatcherConfig(), "cheap").run(rand)
    assert compile_cache_info()["misses"] == info4["misses"] + 2


def test_sharded_solve_path():
    """The registry's ``"sharded"`` path on the CPU: a one-shard CPU mesh,
    the single-device result."""
    g = case("free")
    path = SOLVE_PATHS["sharded"]
    assert path.sharded and dict(path.overrides) == {}
    m = path.matcher(device="cpu")
    assert isinstance(m, ShardedMatcher) and m.ndev == 1
    same(path.solve(g, device="cpu"), SOLVE_PATHS["jnp"].solve(g,
                                                              device="cpu"))
    cm, rm = path.run_host(g, device="cpu", mesh=mesh(3))
    want = SOLVE_PATHS["jnp"].run_host(g, device="cpu")
    np.testing.assert_array_equal(cm, want[0])
    np.testing.assert_array_equal(rm, want[1])
