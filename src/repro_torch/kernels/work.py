"""The work of the hand-written kernels, for a cost model to count.

A cost model (:mod:`repro_torch.launch.hlo_cost`) sees every aten op, but
not a kernel launched through ``ctypes``.  So each wrapper that runs such
a kernel calls :func:`record` with the kernel's name, its FLOPs and the
bytes it must move (each input read once, each output written once), and
on the ``meta`` device, where it launches nothing, records the same work
it would do.  With no sink registered, :func:`record` does nothing.
"""
from __future__ import annotations

from typing import Callable, List

SINKS: List[Callable[[str, int, int], None]] = []


def record(name: str, flops: int, nbytes: int) -> None:
    """Hand one kernel call's work to every registered sink."""
    for sink in SINKS:
        sink(name, flops, nbytes)
