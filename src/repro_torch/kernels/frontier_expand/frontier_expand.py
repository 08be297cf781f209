"""Fused frontier sweep: the wrapper of the hand-written CUDA kernel.

:func:`frontier_expand_fused` returns the ``(nr+1,)`` int32 per-row winner
vector of one BFS level (lowest proposing column per row, IINF = unreached,
slot ``nr`` sealed to IINF).  On CUDA tensors it launches the kernel of
``csrc/frontier_expand.cu``, which replaces the TPU kernels
``_kernel_fused_wr`` / ``_kernel_fused_plain`` of the JAX package: one
thread per edge slot, an ``atomicMin`` merge into a winner vector filled
with IINF (the design is written out in the source).  On CPU tensors it
returns its plain version, :func:`~.ref.frontier_expand_fused_ref`.  Any
other device, dtype, layout or shape raises.  Edge slots and roots out of
range are skipped on either device, so a malformed graph gives the same
winners on both and the kernel never reads or writes out of bounds.

The kernel is built and loaded at its first launch
(:mod:`repro_torch.kernels._build`), never at import.  :data:`LAUNCHES`
counts the launches of each body.
"""
from __future__ import annotations

import ctypes
import numbers
from typing import Dict, Optional

import torch

from repro_torch.kernels._build import load_library

from .ref import frontier_expand_fused_ref

# kernel body -> number of launches; the CPU path does not count
LAUNCHES: Dict[str, int] = {"frontier_expand_fused_wr": 0,
                            "frontier_expand_fused_plain": 0}

_FN = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _launcher():
    global _FN
    if _FN is None:
        fn = load_library("frontier_expand").frontier_expand_fused_launch
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, p, p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(ecol, cadj, bfs, root, rmatch, level) -> None:
    named = {"ecol": ecol, "cadj": cadj, "bfs": bfs, "rmatch": rmatch}
    if root is not None:
        named["root"] = root
    dev = bfs.device
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"frontier_expand_fused: {name} must be a tensor")
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(
                f"frontier_expand_fused: {name} must be a contiguous 1-D "
                f"int32 tensor, got {t.dtype} of shape {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(
                f"frontier_expand_fused: {name} is on {t.device}, bfs on "
                f"{dev}; all inputs must share one device")
    if ecol.shape != cadj.shape:
        raise ValueError(f"frontier_expand_fused: ecol {tuple(ecol.shape)} "
                         f"and cadj {tuple(cadj.shape)} differ")
    if root is not None and root.shape != bfs.shape:
        raise ValueError(f"frontier_expand_fused: root {tuple(root.shape)} "
                         f"and bfs {tuple(bfs.shape)} differ")
    if bfs.shape[0] < 1 or rmatch.shape[0] < 1:
        raise ValueError("frontier_expand_fused: bfs and rmatch need their "
                         "sentinel slot")
    if (not isinstance(level, numbers.Integral) or isinstance(level, bool)
            or not -2**31 <= int(level) < 2**31):
        raise TypeError(f"frontier_expand_fused: level must be an int32 "
                        f"Python int, got {level!r}")


def frontier_expand_fused(ecol: torch.Tensor, cadj: torch.Tensor,
                          bfs: torch.Tensor, root: Optional[torch.Tensor],
                          rmatch: torch.Tensor, level: int) -> torch.Tensor:
    """Per-row winners of one BFS level; ``root=None`` is the plain
    (non-WR) body.  ``level`` is a Python int, so no sync is needed."""
    _check(ecol, cadj, bfs, root, rmatch, level)
    dev = bfs.device
    if dev.type == "cpu":
        return frontier_expand_fused_ref(ecol, cadj, bfs, root, rmatch,
                                         int(level))
    if dev.type != "cuda":
        raise ValueError(f"frontier_expand_fused: no kernel for device {dev}")
    nc = bfs.shape[0] - 1
    nr = rmatch.shape[0] - 1
    fn = _launcher()
    win = torch.empty(nr + 1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):        # the launcher uses the current device
        err = fn(ecol.data_ptr(), cadj.data_ptr(), bfs.data_ptr(),
                 root.data_ptr() if root is not None else None,
                 rmatch.data_ptr(), int(level), int(ecol.shape[0]), nc, nr,
                 win.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"frontier_expand_fused: kernel launch failed with CUDA error "
            f"{err}")
    body = "wr" if root is not None else "plain"
    LAUNCHES[f"frontier_expand_fused_{body}"] += 1
    return win
