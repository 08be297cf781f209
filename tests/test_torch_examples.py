"""Every ``examples/torch`` script runs to its end on the CPU.

Each script is the port's counterpart of one ``examples/*.py`` of the JAX
package and runs as a user would run it, in a subprocess, with
``--device cpu`` (the default is the CUDA card) and its own time limit.
The scripts check their own results (the quickstart every variant against
Hopcroft–Karp, the sharded and served matchings against scipy and the
direct ``Matcher``, the MoE logits finite) and exit non-zero otherwise.
"""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples", "torch")

# script -> (extra arguments, seconds allowed, text its output must hold)
RUNS = {
    "quickstart": ([], 120, "Hopcroft-Karp cardinality"),
    "distributed_matching": ([], 120, "cardinality matches the single-device"),
    "matching_service": ([], 120, "every request matched the direct Matcher"),
    "moe_matching_router": ([], 120, "router=matching"),
    "serve_lm": (["--gen", "8"], 120, "generated token ids"),
    "train_lm": (["--steps", "4"], 180, "done; checkpoints in"),
}


def test_every_example_is_run():
    assert sorted(f[:-3] for f in os.listdir(EXAMPLES)
                  if f.endswith(".py")) == sorted(RUNS)
    # one counterpart per example of the JAX package
    assert sorted(RUNS) == sorted(
        f[:-3] for f in os.listdir(os.path.join(REPO, "examples"))
        if f.endswith(".py"))


@pytest.mark.parametrize("name", sorted(RUNS))
def test_example_runs_on_the_cpu(name, tmp_path):
    args, timeout, want = RUNS[name]
    if name == "train_lm":
        args = args + ["--ckpt-dir", str(tmp_path / "ckpt")]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, f"{name}.py"), "--device",
         "cpu", *args], env=env, cwd=str(tmp_path), capture_output=True,
        text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    assert want in r.stdout, r.stdout[-4000:]
