"""The port stands alone: neither it nor its examples (``examples/torch``)
import JAX or the JAX package, and its entry points run on the CUDA card
unless the caller names the CPU."""
import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "src", "repro_torch")
EXAMPLES = os.path.join(REPO, "examples", "torch")
_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|repro)(?:[.\s,]|$)",
                     re.MULTILINE)


def _port_modules():
    mods = []
    for dirpath, _, names in os.walk(PKG):
        for n in sorted(names):
            if n.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, n),
                                      os.path.join(REPO, "src"))
                mod = rel[:-3].replace(os.sep, ".")
                mods.append(mod[: -len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return sorted(mods)


def test_importing_every_module_loads_no_jax():
    mods = _port_modules()
    assert {"repro_torch.matching.solve", "repro_torch.matching.paths",
            "repro_torch.distributed", "repro_torch.distributed.world",
            "repro_torch.distributed.comm",
            "repro_torch.distributed.spawn"} <= set(mods) and len(mods) >= 16
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith(('jax.', 'jaxlib')) or k == 'repro' or "
            "k.startswith('repro.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_source_imports_jax_or_reference():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root in (PKG, EXAMPLES):
        for dirpath, _, names in os.walk(root):
            files += [os.path.join(dirpath, n) for n in names
                      if n.endswith((".py", ".cu", ".cuh"))]
    assert any(f.startswith(EXAMPLES) for f in files)
    offenders = [f"{os.path.relpath(f, REPO)}: {m.group(0).strip()}"
                 for f in files for m in _IMPORT.finditer(open(f).read())]
    assert not offenders, offenders
    assert os.path.exists(files[0]), "chip_smoke.py is missing"


def test_port_needs_no_msgpack():
    """The checkpoint manifest has the port's own codec: no source imports
    ``msgpack`` (the card host has none), and importing every module
    loads none."""
    pat = re.compile(r"^\s*(?:import|from)\s+msgpack(?:[.\s,]|$)",
                     re.MULTILINE)
    files = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(d, n) for d, _, names in os.walk(PKG) for n in names
        if n.endswith(".py")]
    assert not [f for f in files if pat.search(open(f).read())]
    code = ("import importlib, sys\n"
            f"for m in {_port_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "sys.exit(1 if 'msgpack' in sys.modules else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_default_device_is_the_card():
    from repro_torch.graphs import random_bipartite
    from repro_torch.matching import MatchState, TorchCSR
    g = random_bipartite(30, 30, 2.0, seed=1)
    if torch.cuda.is_available():
        assert TorchCSR.from_host(g).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TorchCSR.from_host(g)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        MatchState.fresh(30, 30)
    assert TorchCSR.from_host(g, device="cpu").device.type == "cpu"
