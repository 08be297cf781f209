"""Exported names of the port that mirror the JAX package's: the solve-path
registry's functions (``register_solve_path``, ``unregister_solve_path``,
``solve_path_names``), ``configs.all_configs`` and the ``core.match_many``
re-export, each driven as the reference's is and held to its behaviour.
"""
import dataclasses

import numpy as np
import pytest

import repro.configs as ref_configs
import repro.core as ref_core
from repro.graphs import instance_sets
from repro.matching import DeviceCSR
from repro.matching import MatcherConfig as RefConfig
from repro.matching import paths as ref_paths

import repro_torch.configs as configs
import repro_torch.core as core
from repro_torch.matching import (SOLVE_PATHS, MatcherConfig, TorchCSR,
                                  register_solve_path, solve_path_names,
                                  unregister_solve_path)
from repro_torch.matching import paths


def test_solve_path_names_mirror_reference():
    assert solve_path_names() == ref_paths.solve_path_names() == tuple(
        SOLVE_PATHS)
    assert paths.solve_path_names is solve_path_names


@pytest.mark.parametrize("sharded", [False, True])
def test_register_and_unregister_mirror_reference(sharded):
    """A registered path joins the names at the end, with the reference's
    fields; it solves; unregistering (twice is harmless) restores the
    registry."""
    before = solve_path_names()
    ref_before = ref_paths.solve_path_names()
    over = dict(use_pallas=True, pallas_fused=False)
    try:
        ours = register_solve_path("tmp_path", over, sharded=sharded)
        ref = ref_paths.register_solve_path("tmp_path", over,
                                            sharded=sharded)
        assert solve_path_names() == before + ("tmp_path",)
        assert ref_paths.solve_path_names() == ref_before + ("tmp_path",)
        assert SOLVE_PATHS["tmp_path"] is ours
        assert (ours.name, dict(ours.overrides), ours.sharded,
                ours.runner) == (ref.name, dict(ref.overrides), ref.sharded,
                                 ref.runner)
        assert ours.configure(MatcherConfig()) == MatcherConfig(**over)
        # "none": the reference's sharded lane fails under a warm start
        # (ROADMAP.md, Queue 3)
        g = instance_sets("mini")["kron"]
        cm, rm = ours.run_host(g, warm_start="none", device="cpu")
        want = ref.run_host(g, warm_start="none")
        np.testing.assert_array_equal(cm, want[0])
        np.testing.assert_array_equal(rm, want[1])
    finally:
        unregister_solve_path("tmp_path")
        unregister_solve_path("tmp_path")
        ref_paths.unregister_solve_path("tmp_path")
    assert solve_path_names() == before
    assert ref_paths.solve_path_names() == ref_before


def test_runner_replaces_the_device_round_trip():
    calls = []

    def runner(g, base, warm_start):
        calls.append((g.nc, base, warm_start))
        return np.zeros(g.nc, np.int32), np.zeros(g.nr, np.int32)

    g = instance_sets("mini")["rand"]
    try:
        p = register_solve_path("tmp_runner", runner=runner)
        out = p.run_host(g, warm_start="none", device="cpu")
    finally:
        unregister_solve_path("tmp_runner")
    assert calls == [(g.nc, MatcherConfig(), "none")]
    assert out[0].shape == (g.nc,) and "tmp_runner" not in SOLVE_PATHS


@pytest.mark.parametrize("smoke", [True, False])
def test_all_configs_equal_reference(smoke):
    ours = configs.all_configs(smoke)
    ref = ref_configs.all_configs(smoke)
    assert list(ours) == list(ref) == configs.ARCH_NAMES
    for name, cfg in ours.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref[name]), name


def test_core_match_many_equals_reference():
    gs = [instance_sets("mini")[n] for n in ("rand", "kron")]
    cap = max(int(np.shape(g.cadj)[0]) for g in gs)
    nc = max(g.nc for g in gs)
    nr = max(g.nr for g in gs)
    ours = core.match_many(TorchCSR.stack(
        [TorchCSR.from_host(g, device="cpu").pad_vertices(nc, nr).pad_to(cap)
         for g in gs]))
    ref = ref_core.match_many(DeviceCSR.stack(
        [DeviceCSR.from_host(g).pad_vertices(nc, nr).pad_to(cap)
         for g in gs]), RefConfig())
    for f in ("cmatch", "rmatch", "phases", "fallbacks", "certified"):
        np.testing.assert_array_equal(getattr(ours, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    assert "match_many" in core.__all__ and "match_many" in ref_core.__all__
