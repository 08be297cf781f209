"""The edge-sharded matcher over the ranks of a world (gloo, the CPU), against
the port's single-device ``Matcher.run`` and the JAX package's
``ShardedMatcher``.

A mesh over a world of ``W`` = 2 and 4 ranks (``make_mesh`` inside the
world): each rank uploads one shard of the edges from the host graph
(``TorchCSR.from_host_shard``, held here array for array to the whole
graph's ``shard``), the level's winners merge by ``all_reduce_min_``, the
warm start runs on rank 0 and is broadcast.

* every sharded solve path (``jnp``, ``legacy``, ``fused``, ``dirop``,
  ``dirop_pallas``) x the three warm starts, on the nine mini families
  (the two long-path ones, band and comb, under one combination each; at
  ``W`` = 4, where each level's collective costs more, on kron) and one
  larger graph: every rank's ``cmatch``, ``rmatch``, ``phases``,
  ``fallbacks`` and ``certified`` equal the single-device ``Matcher.run``'s
  bit for bit; its levels and ``ALTERNATE`` steps, one merge a level (and
  the push/pull split, but on ``dirop``, whose sharded pull is the
  streamed one); on the CPU the host tests every loop's flag on either
  side, so a solve makes the single-device host syncs;
* the phase budget with ``degrade_maximal`` (the round on rank 0 over the
  whole graph) and a resume from an explicit state;
* the JAX ``ShardedMatcher`` and ``maximum_matching_distributed`` on a
  forced four-device host under ``warm_start="none"``, where the reference
  runs (one subprocess, started first and read last), against the world's
  (``maximum_matching_distributed`` runs in the world);
* the refusals: a rank's shard where the warm start needs the whole graph,
  a mesh over distinct devices outside a world.

Every comparison is exact (tolerance 0: the outputs are integers).  One
world of each size runs every case (a module fixture; its ``run_world``
timeout bounds it); the ranks run one thread each.
"""
import functools
import itertools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_world_ranks as ranks
from repro.core import cheap_matching_jax
from repro.graphs import random_bipartite as ref_random_bipartite

from repro_torch.core.csr import BipartiteCSR
from repro_torch.distributed import run_world
from repro_torch.graphs import grid_graph, instance_sets, random_bipartite
from repro_torch.matching import (SOLVE_PATHS, Matcher, MatcherConfig,
                                  ShardedMatcher, TorchCSR, make_mesh)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (2, 4)
PATHS = ("jnp", "legacy", "fused", "dirop", "dirop_pallas")
WARM_STARTS = ("none", "cheap", "karp_sipser")
ALGOS = ("apfb", "apsb")


def port_graph(g) -> BipartiteCSR:
    """Any package's host graph as the port's container (a rank imports
    only the port)."""
    return BipartiteCSR(nc=int(g.nc), nr=int(g.nr), nnz=int(g.nnz),
                        cxadj=np.asarray(g.cxadj), cadj=np.asarray(g.cadj),
                        ecol=np.asarray(g.ecol))


GRAPHS = dict(instance_sets("mini"),
              large=random_bipartite(3000, 3000, 4.0, seed=7))
# the long-path families (band: ~3,000 BFS levels a solve, comb ~1,500;
# each level a collective) run one combination only, to keep the file's
# worlds within a minute
LONG = {"band": ("jnp", "cheap"), "comb": ("dirop_pallas", "cheap")}
# a collective costs more across four ranks (on this CPU gloo's all-reduce
# takes ~1.5 ms across two, ~5 ms across four): there every path and warm
# start runs on these graphs
FOUR = ("kron", "large")
# the reference's ShardedMatcher cases: its own generators
REF_GRAPHS = {"rand": lambda: ref_random_bipartite(500, 500, 4.0, seed=2),
              "rect": lambda: ref_random_bipartite(300, 450, 3.0, seed=3)}
BUDGET = dict(max_phases=1, degrade_maximal=True)


def runs(size: int, name: str, path: str, ws: str) -> bool:
    """Whether a world of ``size`` solves graph ``name`` through ``path``
    under ``ws``."""
    if size == 4 and name not in FOUR:
        return False
    return LONG.get(name, (path, ws)) == (path, ws)


@functools.lru_cache(maxsize=None)
def cases(size: int = 2) -> list:
    out = [((name, path, ws), g, path, ws, {}, None)
           for path, ws in itertools.product(PATHS, WARM_STARTS)
           for name, g in GRAPHS.items() if runs(size, name, path, ws)]
    out.append((("budget",), grid_graph(18), "jnp", "none", BUDGET, None))
    rand = GRAPHS["rand"]
    out.append((("resume",), rand, "jnp", "cheap", {}, resume_state(rand)))
    for name, algo, sweep in itertools.product(REF_GRAPHS, ALGOS,
                                               ("push", "dirop")):
        out.append(((name, algo, sweep), port_graph(REF_GRAPHS[name]()),
                    "dirop" if sweep == "dirop" else "jnp", "none",
                    dict(algo=algo, kernel="gpubfs_wr"), None))
    return out


def resume_state(g):
    cm, rm = Matcher(MatcherConfig(), "karp_sipser").init(
        TorchCSR.from_host(g, device="cpu")).to_host()
    return cm, rm


def single(g, path, ws, kw, start=None):
    """The port's single-device ``Matcher.run`` of the case, and its
    counts."""
    from repro_torch.matching import MatchState
    cfg = SOLVE_PATHS[path].configure(MatcherConfig(**kw))
    t = TorchCSR.from_host(g, device="cpu")
    if cfg.dirop:
        t = t.with_csc()
    state = None if start is None else MatchState.from_host(*start,
                                                            device="cpu")
    m = Matcher(cfg, ws)
    return ranks.outcome(m.run(t, state)), m.last_counts


REF_SHARDED = """
import sys
import jax, numpy as np
from repro.core import MatcherConfig, cheap_matching_jax
from repro.core.distributed import maximum_matching_distributed
from repro.graphs import random_bipartite
from repro.matching import DeviceCSR, ShardedMatcher
assert jax.device_count() == 4, jax.device_count()
mesh = jax.make_mesh((4,), ("data",))
cases = {"rand": random_bipartite(500, 500, 4.0, seed=2),
         "rect": random_bipartite(300, 450, 3.0, seed=3)}
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
        [st["phases"], st["fallbacks"], st["cardinality"]])
np.savez(sys.argv[1], **out)
print("REF_OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX ``ShardedMatcher`` on four forced devices, started at once
    and read when first needed."""
    path = str(tmp_path_factory.mktemp("ref_world") / "states.npz")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=f"{REPO}/src")
    proc = subprocess.Popen([sys.executable, "-c", REF_SHARDED, path],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
    proc.wait()


@pytest.fixture(scope="module")
def ref_states(reference):
    proc, path = reference
    out, err = proc.communicate(timeout=400)
    assert "REF_OK" in out, err[-3000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def rect_start():
    g = REF_GRAPHS["rect"]()
    cm0, rm0 = (np.asarray(x) for x in cheap_matching_jax(g))
    return port_graph(g), cm0, rm0


@pytest.fixture(scope="module", params=SIZES)
def world(request, reference, rect_start):
    g, cm0, rm0 = rect_start
    got = run_world(ranks.sharded_suite, request.param,
                    cases(request.param), g, ALGOS, cm0, rm0, device="cpu",
                    timeout=300)
    return request.param, got


_SINGLE = {}


def single_of(key, g, path, ws, kw, start):
    if key not in _SINGLE:
        _SINGLE[key] = single(g, path, ws, kw, start)
    return _SINGLE[key]


def check_case(size, got, key):
    case = next(c for c in cases() if c[0] == key)
    want, want_counts = single_of(*case)
    for rank, out in enumerate(got):
        state, counts = out["cases"][key]
        for f, a, b in zip(ranks.FIELDS, state, want):
            np.testing.assert_array_equal(a, b, err_msg=f"{key} rank {rank} "
                                          f"of {size}: {f}")
        assert counts["merges"] == counts["levels"] == want_counts["levels"]
        assert counts["alternate_steps"] == want_counts["alternate_steps"]
        if case[2] != "dirop":
            # sharded dirop pulls by the streamed sweep (no compact fits
            # test), so its levels split otherwise than one device's
            for k in ("push_levels", "pull_levels"):
                assert counts[k] == want_counts[k], (key, k)
    return got[0]["cases"][key][1], want_counts


@pytest.mark.parametrize("path,ws", list(itertools.product(PATHS,
                                                           WARM_STARTS)))
def test_world_equals_single_device(world, path, ws):
    size, got = world
    for name in GRAPHS:
        if not runs(size, name, path, ws):
            continue
        counts, want = check_case(size, got, (name, path, ws))
        assert counts["host_syncs"] == want["host_syncs"], (name, counts,
                                                             want)


@pytest.mark.parametrize("key", (("budget",), ("resume",)))
def test_budget_and_resume(world, key):
    size, got = world
    check_case(size, got, key)
    if key == ("budget",):
        assert not got[0]["cases"][key][0][4]          # uncertified


@pytest.mark.parametrize("graph,algo,sweep",
                         list(itertools.product(REF_GRAPHS, ALGOS,
                                                ("push", "dirop"))))
def test_world_equals_reference_sharded(world, ref_states, graph, algo,
                                        sweep):
    size, got = world
    key = (graph, algo, sweep)
    check_case(size, got, key)
    for rank, out in enumerate(got):
        for f, a in zip(ranks.FIELDS, out["cases"][key][0]):
            np.testing.assert_array_equal(
                a, ref_states[f"{graph}-{algo}-{sweep}:{f}"],
                err_msg=f"{key} rank {rank}: {f}")


@pytest.mark.parametrize("algo", ALGOS)
def test_distributed_in_a_world_equals_reference(world, ref_states, algo):
    size, got = world
    for rank, out in enumerate(got):
        cm, rm, st = out["dist"][algo]
        np.testing.assert_array_equal(cm, ref_states[f"dist-{algo}:cmatch"])
        np.testing.assert_array_equal(rm, ref_states[f"dist-{algo}:rmatch"])
        np.testing.assert_array_equal(
            [st["phases"], st["fallbacks"], st["cardinality"]],
            ref_states[f"dist-{algo}:stats"])
        assert st["devices"] == size


def test_refusals_and_the_local_shard(world):
    size, got = world
    for out in got:
        errors = out["errors"]
        assert "whole edge list" in errors["warm on a shard"]
        assert "one rank's shard" in errors["with_csc of a shard"]
        assert "rank i's device" in errors["mesh of another device"]
        nnz_pad, shards, slices = out["nnz_pad"]
        assert shards == size and slices == 1
        whole, host = out["whole"]
        for f, a, b in zip(ranks.FIELDS, whole, host):
            np.testing.assert_array_equal(a, b, err_msg=f)
    with pytest.raises(ValueError, match="init_world"):
        make_mesh((2,), ("data",), devices=["cpu", "meta"])
    with pytest.raises(ValueError, match="host graph"):
        ShardedMatcher(make_mesh((2,), ("data",), devices=["cpu"] * 2)).run(
            GRAPHS["rand"])


@pytest.mark.parametrize("size", (2, 3, 4))
def test_host_shard_is_the_whole_graphs_shard(size):
    """``TorchCSR.from_host_shard`` on each rank (a world object only:
    slicing needs no collective) equals ``from_host(...).with_csc()
    .shard(...)`` array for array, on graphs whose shards cut rows of the
    mirror, hold only padding, or meet empty rows."""
    from repro_torch.distributed import Axis, World
    from repro_torch.matching import Mesh
    cpu = torch.device("cpu")
    graphs = dict(GRAPHS, tiny=random_bipartite(5, 40, 0.3, seed=1),
                  rect=random_bipartite(90, 300, 2.0, seed=4))
    fields = ("cxadj", "cadj", "ecol", "rxadj", "radj", "erow", "eperm")
    for name, g in graphs.items():
        whole = TorchCSR.from_host(g, device="cpu").with_csc()
        for rank in range(size):
            w = World(rank=rank, size=size, backend="gloo",
                      devices=(cpu,) * size, ident=-1, mesh=(size, 1),
                      data=Axis("data", rank, size, tuple(range(size))),
                      model=Axis("model", 0, 1, (rank,)))
            mesh = Mesh(devices=(cpu,) * size, axis_names=("data",),
                        axis_sizes=(size,), world=w)
            want = whole.shard(mesh, "data")
            for csc in (False, True):
                got = TorchCSR.from_host_shard(g, mesh, "data", csc=csc)
                assert (got.nnz, got.nc, got.nr, got.nnz_pad) == \
                    (want.nnz, want.nc, want.nr, want.nnz_pad)
                assert got.has_csc == csc and got.rank_shard
                for f in fields[:3] + (fields[3:] if csc else ()):
                    assert torch.equal(getattr(got, f), getattr(want, f)), \
                        (name, size, rank, f)
