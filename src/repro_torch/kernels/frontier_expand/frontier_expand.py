"""Frontier sweeps: the wrappers of the hand-written CUDA kernels.

Three sweeps of one BFS level, one kernel each in ``csrc/frontier_expand.cu``:

* :func:`frontier_expand_fused` returns the ``(nr+1,)`` int32 per-row winner
  vector (lowest proposing column per row, IINF = unreached, slot ``nr``
  sealed to IINF).  Its kernel replaces the TPU kernels
  ``_kernel_fused_wr`` / ``_kernel_fused_plain`` of the JAX package: four
  edge slots a thread through 16-byte loads (``ecol``/``cadj`` may be views
  at any 4-byte offset and need not be sorted), an atomic-min merge, sent
  only where it lowers the winner, into a vector filled with IINF.
* :func:`frontier_expand` returns the ``(nnz_pad,)`` int32 per-edge
  proposals (the column, or IINF); the caller merges them.  Its kernel
  replaces ``_kernel_wr`` / ``_kernel_plain`` (the legacy path) and reads
  as the fused one does, writing four slots with one streaming store.
* :func:`frontier_expand_pull` returns the fused sweep's winners over the
  row-sorted CSC mirror (``radj``/``erow``).  It replaces
  ``_kernel_pull_wr`` / ``_kernel_pull`` with two kernels: the column pass
  (:func:`frontier_bits`, one bit per column into scratch the wrapper
  allocates) and a sweep that streams ``erow`` four slots a thread, tests
  the row side of the predicate first and the column side as one bit, so
  the edges of reached rows cost no column reads and no atomics.

On CUDA tensors each launches its kernel (the designs are written out in
the source); on CPU tensors each returns its plain version
(:mod:`.ref`).  Any other device, dtype, layout or shape raises.  Edge
slots and roots out of range are skipped on either device, so a malformed
graph gives the same result on both and no kernel reads or writes out of
bounds.

The solver captures these launches in CUDA graphs and replays them level
after level, so a captured launch cannot take its level as a number.  Each
sweep takes ``level`` as a Python int or as a 0-d int32 tensor on its
device, which the kernel reads when it runs, and an optional ``gate``, a 0-d
int32 tensor: where it is 0 the launch does nothing, and the sweep returns
no winner (all IINF) or no proposal.  The plain versions take the same.

Lanes.  Every wrapper also takes a batch of B graphs of one size bucket
(``Matcher.run_many``): each array a contiguous ``(B, n)`` tensor, lane by
lane, and ``level`` and ``gate`` then ``(B,)`` int32 tensors (or ``level``
one Python int for every lane), one launch for the batch.  Lane ``l``'s
output is what the single-graph call on lane ``l``'s arrays returns, bit
for bit; a lane whose gate is 0 returns what a gated-off single call does.

The kernels are built and loaded at their first launch
(:mod:`repro_torch.kernels._build`), never at import.  :data:`LAUNCHES`
counts the launches of each kernel body that ran (gate on), the batched
instantiation (more than one lane: ``*_batched``) apart from the
single-graph one: the kernels add to counters on the card, so launches
replayed from a CUDA graph count too, and reading :data:`LAUNCHES` reads
the counters (a host sync).  A pull counts one column pass
(``frontier_bits_*``) beside its sweep.
"""
from __future__ import annotations

import contextlib
import ctypes
import numbers
import threading
from typing import Dict, Iterator, Mapping, Optional, Union

import torch

from repro_torch.kernels._build import load_library

from .ref import (frontier_bits_ref, frontier_expand_fused_ref,
                  frontier_expand_pull_ref, frontier_expand_ref)

_P, _I = ctypes.c_void_p, ctypes.c_int
# (cols, rows, bfs, root, rmatch, level, level_ptr, gate, nnz, nc, nr,
#  lanes, out)
_SWEEP_ARGS = [_P, _P, _P, _P, _P, _I, _P, _P, ctypes.c_longlong, _I, _I, _I,
               _P]
# kernel -> (C launcher, its argument types, plain version); every launcher
# ends with (counts, stream), the pull takes its column bitmap before them
_KERNELS = {
    "frontier_expand": ("frontier_expand_launch", _SWEEP_ARGS + [_P, _P],
                        frontier_expand_ref),
    "frontier_expand_fused": ("frontier_expand_fused_launch",
                              _SWEEP_ARGS + [_P, _P],
                              frontier_expand_fused_ref),
    "frontier_expand_pull": ("frontier_expand_pull_launch",
                             _SWEEP_ARGS + [_P, _P, _P],
                             frontier_expand_pull_ref),
    # (bfs, root, level, level_ptr, gate, nc, lanes, bits, counts, stream)
    "frontier_bits": ("frontier_bits_launch",
                      [_P, _P, _I, _P, _P, _I, _I, _P, _P, _P],
                      frontier_bits_ref),
}
# the kernel bodies, in the order of the source's launch counters (Slot):
# the single-graph instantiations, then the batched ones (more than a lane)
_BODIES = tuple(f"{s}_{b}{lanes}" for lanes in ("", "_batched")
                for s in _KERNELS for b in ("wr", "plain"))

Level = Union[int, torch.Tensor]

_COUNTS: Dict[torch.device, torch.Tensor] = {}
_COUNTS_LOCK = threading.Lock()
_LOCAL = threading.local()          # .uncounted: launches of this thread


def _counts(dev) -> torch.Tensor:
    """The (16,) int64 launch counters of a card, made at its first launch.
    Made outside any CUDA graph capture: a graph that made them would zero
    them at every replay."""
    counts = _COUNTS.get(dev)
    if counts is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "frontier sweeps: the first launch on a device cannot be "
                "captured in a CUDA graph; launch once before capturing")
        with _COUNTS_LOCK:
            counts = _COUNTS.setdefault(
                dev, torch.zeros(len(_BODIES), dtype=torch.int64,
                                 device=dev))
    return counts


class _Launches(Mapping):
    """Kernel body -> launches that ran, summed over the cards: a read of
    the device counters, and so a host sync.  The CPU path counts nothing.
    """

    def __getitem__(self, body: str) -> int:
        i = _BODIES.index(body)
        return sum(int(c[i]) for c in list(_COUNTS.values()))

    def __iter__(self) -> Iterator[str]:
        return iter(_BODIES)

    def __len__(self) -> int:
        return len(_BODIES)

    def __repr__(self) -> str:
        return repr(dict(self))


LAUNCHES = _Launches()

_FNS: Dict[str, object] = {}


def reset_launches() -> None:
    """Set every launch counter to 0 (in place, on the card's stream)."""
    for counts in list(_COUNTS.values()):
        counts.zero_()


@contextlib.contextmanager
def uncounted():
    """Launches of the calling thread inside this block are not counted
    (the warm-up runs before a capture)."""
    before = getattr(_LOCAL, "uncounted", False)
    _LOCAL.uncounted = True
    try:
        yield
    finally:
        _LOCAL.uncounted = before


def _launcher(kernel: str):
    fn = _FNS.get(kernel)
    if fn is None:
        name, argtypes, _ = _KERNELS[kernel]
        fn = getattr(load_library("frontier_expand"), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[kernel] = fn
    return fn


def _check_scalar(sweep, name, t, dev, lanes=()) -> None:
    """``t`` an int32 tensor on ``dev`` of shape ``lanes``: 0-d for one
    graph, ``(B,)`` for a batch."""
    if (not isinstance(t, torch.Tensor) or t.dtype != torch.int32
            or tuple(t.shape) != tuple(lanes) or not t.is_contiguous()
            or t.device != dev):
        what = "a 0-d" if not lanes else f"a contiguous {tuple(lanes)}"
        raise TypeError(f"{sweep}: {name} must be {what} int32 tensor on "
                        f"{dev}, got {t!r}")


def _lanes(bfs) -> tuple:
    """``()`` for one graph, ``(B,)`` for a batch of B."""
    return tuple(bfs.shape[:-1])


def _check_state(sweep, named, bfs, root, level, gate=None) -> None:
    """Every tensor of ``named`` (and ``root`` unless None) a contiguous
    int32 tensor on ``bfs``'s device, 1-D for one graph or 2-D ``(B, n)``
    for a batch, as ``bfs`` is, with ``bfs``'s lanes; ``root`` shaped as
    ``bfs``; ``level`` an int32 Python int or an int32 tensor on that device
    with one value a lane (0-d for one graph), ``gate`` None or such a
    tensor."""
    if root is not None:
        named = dict(named, root=root)
    dev = bfs.device
    dims = bfs.dim()
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{sweep}: {name} must be a tensor")
        if (t.dtype != torch.int32 or t.dim() not in (1, 2)
                or t.dim() != dims or not t.is_contiguous()):
            raise ValueError(
                f"{sweep}: {name} must be a contiguous int32 tensor, 1-D "
                f"(one graph) or 2-D (a batch) as bfs {tuple(bfs.shape)} "
                f"is, got {t.dtype} of shape {tuple(t.shape)}")
        if t.shape[:-1] != bfs.shape[:-1]:
            raise ValueError(f"{sweep}: {name} has {tuple(t.shape[:-1])} "
                             f"lanes, bfs {tuple(bfs.shape[:-1])}")
        if t.device != dev:
            raise ValueError(f"{sweep}: {name} is on {t.device}, bfs on "
                             f"{dev}; all inputs must share one device")
    if root is not None and root.shape != bfs.shape:
        raise ValueError(f"{sweep}: root {tuple(root.shape)} and bfs "
                         f"{tuple(bfs.shape)} differ")
    if bfs.shape[-1] < 1:
        raise ValueError(f"{sweep}: bfs needs its sentinel slot")
    if dims == 2 and bfs.shape[0] < 1:
        raise ValueError(f"{sweep}: a batch needs at least one lane")
    lanes = _lanes(bfs)
    if isinstance(level, torch.Tensor):
        _check_scalar(sweep, "level", level, dev, lanes)
    elif (not isinstance(level, numbers.Integral) or isinstance(level, bool)
            or not -2**31 <= int(level) < 2**31):
        raise TypeError(f"{sweep}: level must be an int32 Python int or an "
                        f"int32 tensor (one value a lane), got {level!r}")
    if gate is not None:
        _check_scalar(sweep, "gate", gate, dev, lanes)


def _check(sweep, cols, rows, bfs, root, rmatch, level, gate) -> None:
    _check_state(sweep, {"cols": cols, "rows": rows, "bfs": bfs,
                         "rmatch": rmatch}, bfs, root, level, gate)
    if cols.shape != rows.shape:
        raise ValueError(f"{sweep}: the column endpoints "
                         f"{tuple(cols.shape)} and row endpoints "
                         f"{tuple(rows.shape)} differ")
    if rmatch.shape[-1] < 1:
        raise ValueError(f"{sweep}: rmatch needs its sentinel slot")


def _on_card(kernel: str, dev) -> bool:
    """False on the CPU (the plain version runs), True on a CUDA device."""
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{kernel}: no kernel for device {dev}")
    return True


def _level_args(level: Level, gate) -> tuple:
    """The launcher's (level, level_ptr, gate) for a Python int or a 0-d
    tensor level and an optional gate."""
    if isinstance(level, torch.Tensor):
        return 0, level.data_ptr(), None if gate is None else gate.data_ptr()
    return int(level), None, None if gate is None else gate.data_ptr()


def _launch(kernel: str, dev, *args) -> None:
    """``kernel``'s launcher with ``args`` on the current stream of
    ``dev``, then the launch counters (none inside :func:`uncounted`);
    raises on a CUDA error.  The kernels count each body that runs."""
    counts = _counts(dev)
    ptr = None if getattr(_LOCAL, "uncounted", False) else counts.data_ptr()
    with torch.cuda.device(dev):        # the launcher uses the current device
        err = _launcher(kernel)(*args, ptr,
                                torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"{kernel}: kernel launch failed with CUDA error {err}")


def _bitmap(bfs) -> torch.Tensor:
    """Scratch for the column bits: ``ceil((nc+1)/32)`` int32 words a
    lane."""
    return torch.empty(_lanes(bfs) + ((bfs.shape[-1] + 31) // 32,),
                       dtype=torch.int32, device=bfs.device)


def _sweep(sweep, cols, rows, bfs, root, rmatch, level, gate
           ) -> torch.Tensor:
    """Check, then the plain version on the CPU or the kernel on the card."""
    _check(sweep, cols, rows, bfs, root, rmatch, level, gate)
    dev = bfs.device
    if not _on_card(sweep, dev):
        return _KERNELS[sweep][2](cols, rows, bfs, root, rmatch, level,
                                  gate=gate)
    nc = bfs.shape[-1] - 1
    nr = rmatch.shape[-1] - 1
    lanes = _lanes(bfs)
    n_out = cols.shape[-1] if sweep == "frontier_expand" else nr + 1
    out = torch.empty(lanes + (n_out,), dtype=torch.int32, device=dev)
    scratch = [_bitmap(bfs)] if sweep == "frontier_expand_pull" else []
    _launch(sweep, dev, cols.data_ptr(), rows.data_ptr(),
            bfs.data_ptr(), root.data_ptr() if root is not None else None,
            rmatch.data_ptr(), *_level_args(level, gate),
            int(cols.shape[-1]), nc, nr, _count(lanes), out.data_ptr(),
            *[t.data_ptr() for t in scratch])
    return out


def _count(lanes: tuple) -> int:
    return lanes[0] if lanes else 1


def frontier_expand_fused(ecol: torch.Tensor, cadj: torch.Tensor,
                          bfs: torch.Tensor, root: Optional[torch.Tensor],
                          rmatch: torch.Tensor, level: Level,
                          gate: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Per-row winners of one BFS level; ``root=None`` is the plain
    (non-WR) body.  No host sync, whether ``level`` is an int or a device
    scalar.  Gate off: all IINF."""
    return _sweep("frontier_expand_fused", ecol, cadj, bfs, root, rmatch,
                  level, gate)


def frontier_expand(ecol: torch.Tensor, cadj: torch.Tensor,
                    bfs: torch.Tensor, root: Optional[torch.Tensor],
                    rmatch: torch.Tensor, level: Level,
                    gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-edge proposals of one BFS level, ``(nnz_pad,)``: the column of
    each proposing edge slot, IINF elsewhere (everywhere with the gate
    off).  The per-row merge is the caller's ``scatter_min``."""
    return _sweep("frontier_expand", ecol, cadj, bfs, root, rmatch, level,
                  gate)


def frontier_bits(bfs: torch.Tensor, root: Optional[torch.Tensor],
                  level: Level) -> torch.Tensor:
    """The pull's column pass alone: ``ceil((nc+1)/32)`` int32 words (a
    lane), bit ``c & 31`` of word ``c >> 5`` set where column c passes the
    column half of the predicate (``root=None``: the plain body)."""
    _check_state("frontier_bits", {"bfs": bfs}, bfs, root, level)
    if not _on_card("frontier_bits", bfs.device):
        return frontier_bits_ref(bfs, root, level)
    bits = _bitmap(bfs)
    _launch("frontier_bits", bfs.device, bfs.data_ptr(),
            root.data_ptr() if root is not None else None,
            *_level_args(level, None), bfs.shape[-1] - 1,
            _count(_lanes(bfs)), bits.data_ptr())
    return bits


def frontier_expand_pull(radj: torch.Tensor, erow: torch.Tensor,
                         bfs: torch.Tensor, root: Optional[torch.Tensor],
                         rmatch: torch.Tensor, level: Level,
                         gate: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Per-row winners of one BFS level over the CSC mirror's row-sorted
    edges (``TorchCSR.with_csc``): the same vector as
    :func:`frontier_expand_fused`, since min is the merge.  Gate off: all
    IINF."""
    return _sweep("frontier_expand_pull", radj, erow, bfs, root, rmatch,
                  level, gate)
