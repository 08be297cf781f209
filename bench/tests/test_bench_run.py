"""A run's result line keeps to the contract, and nothing the harness or
its reference loads is JAX or the JAX package."""
import json
import os
import subprocess
import sys

import pytest
import torch

from bench import registry
from bench.tests import tiny

ROOT = str(registry.ROOT)
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", sorted(tiny.TRAFFIC))
def test_result_line_keeps_to_the_contract(cell):
    out = tiny.run(cell)
    out.pop("_notes")
    assert list(out) == KEYS + ["checks"]          # checks last
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    want = registry.end_to_end(registry.benchmark(), cell)
    assert sorted(out["metrics"]) == sorted(m["name"] for m in want)
    for m in want:
        got = out["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and got["value"] > 0
    assert out["checks"] == {k: {"value": 0, "limit": 0}
                             for k in ("missing", "bad_pairs", "aug_rows")}
    json.dumps(out)


@pytest.mark.parametrize("cell", sorted(tiny.TRAFFIC))
def test_traced_line_carries_the_trace(cell):
    out = tiny.run(cell, trace=True)
    out.pop("_notes")
    assert list(out) == KEYS + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert out["device"]["busy_s_is_lower_bound"] is True
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    names = {m["name"] for m in registry.per_layer(registry.benchmark(),
                                                   cell)}
    assert set(out["metrics"]) == names


def _python(code):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_without_a_card_it_prints_nothing_and_fails():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-m", "bench.run", "--workload",
                        "kron21.solve", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout == ""


def test_no_jax_or_reference_package_after_a_run():
    r = _python("from bench.tests import tiny\n"
                "from bench.run import forbidden_modules\n"
                "tiny.run('kron.batch', seconds=0.5)\n"
                "import repro_torch, sys\n"
                "print(forbidden_modules(), 'repro_torch' in sys.modules)\n")
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split()[-2:] == ["[]", "True"]


def test_the_reference_loads_nothing_of_the_program():
    r = _python("import sys\nimport bench.reference\n"
                "top = {m.split('.')[0] for m in sys.modules}\n"
                "print(sorted(top & {'jax', 'jaxlib', 'flax', 'repro', "
                "'repro_torch'}))\n")
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[]"


def test_a_solve_window_runs_whole_cycles_of_the_pool():
    pool = tiny.TRAFFIC["mesh20.solve"]["graphs"]["pool"]
    out = tiny.run("mesh20.solve", seconds=0.3)
    assert out["attempted"] > 0 and out["attempted"] % pool == 0
