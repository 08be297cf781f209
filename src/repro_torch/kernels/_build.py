"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled by ``nvcc``
for ``sm_90a`` into a shared library and loaded with :mod:`ctypes`; nothing
includes PyTorch's headers, so a build takes seconds.  Libraries go to
``build/repro_torch_kernels/`` at the root of the checkout, named by the hash
of their source and flags, so an edited source is rebuilt at its next use
and an unchanged one is loaded as it is.  A missing ``nvcc`` or a failed
build raises; nothing falls back.

Nothing here runs at import: the first kernel call builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built")
    return found


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.

    The library carries ``build_seconds`` and ``build_log`` (nvcc's output,
    register counts included) of the build this process made; 0.0 and
    ``"already built"`` when the library was already on disk.
    """
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    seconds, log = 0.0, "already built"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"kernel build of {src.name} failed: nvcc "
                               f"exited {proc.returncode}\n{log}")
        os.replace(tmp, out)            # atomic: concurrent builders agree
    lib = ctypes.CDLL(str(out))
    lib.build_seconds, lib.build_log = seconds, log
    _LOADED[name] = lib
    return lib
