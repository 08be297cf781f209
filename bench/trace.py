"""The benchmark's own spans and the device trace of a ``--trace 1`` run.

:class:`Tracer` puts a ``torch.profiler.record_function`` range around each
call the benchmark makes into a layer of the program (the spans are
no-ops with tracing off) and, with tracing on, runs ``torch.profiler``
over the measured window.  :func:`reduce` turns the profile into what the
per-layer readers and the result's ``breakdown`` read: the window's length,
the seconds in which some operation ran on the device (the union of every
kernel, copy and fill), device seconds by operation name, and the device's
idle gaps, each named by the benchmark spans open on the host at its
middle.
"""
from __future__ import annotations

import bisect
import contextlib
from typing import Dict, List, Tuple

import torch

WINDOW = "bench.window"
OUTSIDE = "outside_bench_spans"


class Tracer:
    """Spans for the benchmark's calls; the profiler when ``enabled``."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.names = {WINDOW}
        self._prof = None
        self._window = None
        self.summary: dict = {}

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        self.names.add(name)
        return torch.profiler.record_function(name)

    def start(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()

    def stop(self) -> dict:
        if not self.enabled:
            return {}
        self._window.__exit__(None, None, None)
        self._prof.stop()
        events = _events(self._prof)
        self.summary = reduce(events, self.names)
        if self.summary:
            self.summary["events"] = len(events)
        self._prof = None
        return self.summary


def _events(prof) -> List[Tuple[str, bool, int, int]]:
    """``(name, on the device, start ns, end ns)`` of every event, from the
    profiler's raw results where it has them."""
    cuda = torch.autograd.DeviceType.CUDA
    res = getattr(prof.profiler, "kineto_results", None)
    if res is not None:
        return [(e.name(), e.device_type() == cuda, e.start_ns(),
                 e.start_ns() + e.duration_ns()) for e in res.events()]
    return [(e.name, e.device_type == cuda, int(e.time_range.start * 1e3),
             int(e.time_range.end * 1e3)) for e in prof.events()]


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class _Cover:
    """Which spans of one name are open at a time: starts sorted, with the
    running maximum of their ends."""

    def __init__(self, spans: List[Tuple[int, int]]):
        spans = sorted(spans)
        self.starts = [s for s, _ in spans]
        self.reach, top = [], -1
        for _, e in spans:
            top = max(top, e)
            self.reach.append(top)

    def covers(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and self.reach[i] > t


def reduce(events, span_names) -> dict:
    """The window's device busy time, device seconds by operation and idle
    gaps by host span (see the module doc)."""
    win = [(s, e) for name, dev, s, e in events
           if not dev and name == WINDOW]
    if not win:
        return {}
    w0, w1 = win[0]
    ops: Dict[str, float] = {}
    busy = []
    spans: Dict[str, List[Tuple[int, int]]] = {}
    for name, dev, s, e in events:
        if not dev:
            if name in span_names and name != WINDOW:
                spans.setdefault(name, []).append((s, e))
            continue
        if name in span_names:          # a span's own range on the device
            continue
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        ops[name] = ops.get(name, 0.0) + (e - s) / 1e9
        busy.append((s, e))
    merged = _union(busy)
    covers = {n: _Cover(v) for n, v in spans.items()}
    gaps: Dict[str, float] = {}
    t = w0
    for s, e in merged + [(w1, w1)]:
        if s > t:
            mid = (s + t) / 2
            label = "+".join(sorted(n for n, c in covers.items()
                                    if c.covers(mid))) or OUTSIDE
            gaps[label] = gaps.get(label, 0.0) + (s - t) / 1e9
        t = max(t, e)
    return dict(window_s=(w1 - w0) / 1e9,
                busy_s=sum(e - s for s, e in merged) / 1e9,
                ops=ops, gaps=gaps)


def short(name: str) -> str:
    """A kernel's name without its namespaces and return type, cut to 100
    characters."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::",
                  "at::cuda::"):
        name = name.replace(noise, "")
    return name[:100]


def breakdown(summary: dict, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device operations that took
    most time and the idle time by host span, each at most ``top``."""
    def head(d):
        merged: Dict[str, float] = {}
        for k, v in d.items():
            merged[short(k)] = merged.get(short(k), 0.0) + v
        return [[k, v] for k, v in
                sorted(merged.items(), key=lambda kv: -kv[1])[:top]]
    return dict(device_ops=head(summary.get("ops", {})),
                idle_gaps=head(summary.get("gaps", {})))
