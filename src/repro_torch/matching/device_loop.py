"""Device programs: the loops of a solve as steps on static device buffers.

The JAX package compiles ``Matcher.run`` into one program whose loops are
``lax.while_loop``s.  Here a :class:`Program` holds what one compile-cache
entry needs on one device:

* static buffers (:class:`Buffers`): the graph, the matching, the BFS and
  ``ALTERNATE`` state, and the loops' scalars (``level``, ``ins``, ``aug``,
  ``steps``, ``phases``, the ``live`` flags, ...), each a 0-d int32 view
  into one vector, so that one copy to the host reads them all;
* step functions: plain PyTorch on those buffers, in place, with no host
  read inside;
* on a CUDA device, every step captured into a CUDA graph (one memory pool
  for the entry).  A one-shot step is replayed as it is.  A loop runs on
  the device alone: its step's graph becomes the body of a CUDA conditional
  WHILE node on the ``live`` flag (``csrc/graph_loop.cu``), which tests the
  flag before every step, so the host launches the loop once and reads
  nothing until it ends, and no step runs with its flag down.  A loop
  whose body branches (:class:`Branch`) holds an IF node per branch, so
  only the taken branch runs.  A runaway guard ends any loop after
  ``loop_limit`` iterations and makes the next :meth:`Program.read` raise.
  A loop run inside another step's capture (a built-in warm start called
  by a registered one) adds its WHILE node to that capture
  (:meth:`Program.sub`).

On the CPU the same step functions run uncaptured; the host makes the
loop's test before every step, as the WHILE node does.  So does a program
built with ``capture=False`` on a card, for steps that hold a call no
capture can (the matcher's merge over a gloo world): there each test is a
counted host sync.

Capture.  Each step runs once on a side stream against scratch copies of
the buffers (kernel launches uncounted) before its capture, so that lazy
set-up (library loads, occupancy queries, the allocator) happens outside
it; then it is captured in ``"thread_local"`` error mode, holding
:data:`repro_torch._device.DEVICE_LOCK`: another thread may allocate, copy
or read results meanwhile (a serving caller), but not upload a graph.  A
step that reads the device on the host cannot be captured: the capture
raises :class:`CaptureError`.  Nothing falls back to an uncaptured run on a
card.

:data:`COUNTERS` counts the work: BFS levels (by sweep) and ``ALTERNATE``
steps in device counters the steps add to; host syncs, the reads the host
makes between loops (:meth:`Program.read`), on the host.  A loop's own test
is the device's (the WHILE node on a card; on the CPU, where the host is
the device, the same test made uncounted), so a solve counts the same host
syncs on either device; an uncaptured loop on a card counts each test.
"""
from __future__ import annotations

import ctypes
import dataclasses
import threading
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Union

import torch

from repro_torch._device import DEVICE_LOCK
from repro_torch.kernels._build import load_library
from repro_torch.kernels.frontier_expand import uncounted

class SolveCounters:
    """The solver's work: BFS levels, split by the sweep each ran
    (``push_levels`` the dense edge sweep, ``pull_levels`` a pull over the
    CSC mirror, ``compact_levels`` the adaptive column gather), and
    ``ALTERNATE`` steps, and ``merges``, the per-level merges of an
    edge-sharded solve's shard winners, counted on the device by the steps
    themselves (so replayed graphs count); ``host_syncs``, each read of
    device values the host waits for, counted on the host.  Reading a
    device count is a host sync of its own."""

    DEVICE = ("levels", "push_levels", "pull_levels", "compact_levels",
              "alternate_steps", "merges")

    def __init__(self):
        self.host_syncs = 0
        self._tensors: Dict[torch.device, torch.Tensor] = {}
        self._lock = threading.Lock()

    def tensor(self, device) -> torch.Tensor:
        """The (6,) int64 device counts of ``device`` (made on first use,
        never inside a capture)."""
        device = torch.device(device)
        t = self._tensors.get(device)
        if t is None:
            if device.type == "cuda" and \
                    torch.cuda.is_current_stream_capturing():
                raise RuntimeError("solver counters cannot be made inside a "
                                   "CUDA graph capture")
            with self._lock:
                t = self._tensors.setdefault(
                    device, torch.zeros(len(self.DEVICE), dtype=torch.int64,
                                        device=device))
        return t

    def reset(self) -> None:
        self.host_syncs = 0
        for t in list(self._tensors.values()):
            t.zero_()

    def _device_totals(self) -> List[int]:
        total = [0] * len(self.DEVICE)
        for t in list(self._tensors.values()):
            total = [a + b for a, b in zip(total, t.tolist())]
        return total

    def __getattr__(self, name):
        if name in SolveCounters.DEVICE:
            return self._device_totals()[SolveCounters.DEVICE.index(name)]
        raise AttributeError(name)

    def as_dict(self) -> dict:
        out = dict(zip(self.DEVICE, self._device_totals()))
        out["host_syncs"] = self.host_syncs
        return out

    def snapshot(self, device) -> tuple:
        """``(host_syncs, a copy of the device counts)``: no host sync."""
        return self.host_syncs, self.tensor(device).clone()

    @staticmethod
    def between(before: tuple, after: tuple) -> dict:
        """The counts from snapshot ``before`` to ``after`` (one sync)."""
        out = dict(zip(SolveCounters.DEVICE,
                       (after[1] - before[1]).tolist()))
        out["host_syncs"] = after[0] - before[0]
        return out


COUNTERS = SolveCounters()
# slots of the device counts
LEVELS, PUSH, PULL, COMPACT, ALT, MERGES = range(6)


class CaptureError(RuntimeError):
    """A step could not be captured into a CUDA graph."""


class Buffers(dict):
    """Name -> static tensor, also readable as attributes."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None


Step = Callable[[Buffers], None]


@dataclasses.dataclass(frozen=True)
class Once:
    """A one-shot step.  ``loops``: the step may run device loops of its
    own (a registered warm start calling a built-in one)."""
    name: str
    fn: Step
    loops: bool = False


@dataclasses.dataclass(frozen=True)
class Branch:
    """A loop body that runs ``if_true`` where the scalar ``flag`` is set,
    else ``if_false``."""
    flag: str
    if_true: Step
    if_false: Step


@dataclasses.dataclass(frozen=True)
class Loop:
    """A device loop: ``body`` (a step, or a :class:`Branch`) repeated
    while the scalar ``live`` is set.  ``start``: set ``live`` to 1 first
    (else an earlier step sets it)."""
    name: str
    body: Union[Step, Branch]
    live: str
    start: bool = True

    @property
    def step(self) -> Step:
        """One iteration, as the CPU runs it."""
        body = self.body
        if not isinstance(body, Branch):
            return body

        def step(B: Buffers) -> None:
            fn = body.if_true if int(B[body.flag]) else body.if_false
            fn(B)
        return step


# ---- conditional nodes, built by csrc/graph_loop.cu ------------------------
_P, _U64, _I = ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_int
_PP = ctypes.POINTER(_P)
_LG_ARGS = {
    "lg_graph_create": [_PP],
    "lg_graph_destroy": [_P],
    "lg_handle_create": [_P, ctypes.POINTER(_U64)],
    "lg_add_child": [_P, _P, _P, _PP],
    "lg_add_set": [_P, _P, _U64, _P, _I, _P, _I, _P, _I, _PP],
    "lg_add_cond": [_P, _P, _U64, _I, _PP, _PP],
    "lg_instantiate": [_P, _PP],
    "lg_launch": [_P, _P],
    "lg_exec_destroy": [_P],
    "lg_capture_tail": [_P, _PP, _PP],
    "lg_capture_continue": [_P, _P],
}
_LG: Dict[str, object] = {}


def _lg(name: str, *args) -> None:
    """Call ``name`` of the graph_loop library; raise on a CUDA error."""
    fn = _LG.get(name)
    if fn is None:
        fn = getattr(load_library("graph_loop"), name)
        fn.argtypes = _LG_ARGS[name]
        fn.restype = ctypes.c_int
        _LG[name] = fn
    err = fn(*args)
    if err != 0:
        raise CaptureError(f"{name}: CUDA error {err}")


class _LoopGraph:
    """One loop as an instantiated CUDA graph, ``set(h, live) -> WHILE h {
    body -> set(h, live) }``; the sets go through the runaway guard
    ``(iters, limit, runaway)``.  ``body`` lists ("child", cudaGraph_t) or
    ("branch", flag, true cudaGraph_t, false cudaGraph_t)."""

    def __init__(self, body: List[tuple], live: int, guard: tuple):
        g = _P()
        _lg("lg_graph_create", ctypes.byref(g))
        try:
            self.build(g, None, body, live, guard)
            ex = _P()
            _lg("lg_instantiate", g, ctypes.byref(ex))
        finally:
            _lg("lg_graph_destroy", g)
        self.exec = ex
        finalizer = weakref.finalize(self, _lg, "lg_exec_destroy", ex)
        finalizer.atexit = False      # the process's exit frees it anyway

    @classmethod
    def build(cls, graph, dep, body: List[tuple], live: int, guard: tuple):
        """Add ``set(h, live) -> WHILE h { body -> set(h, live) }`` to
        ``graph`` after node ``dep`` (may be None); returns the WHILE
        node."""
        h = cls._handle(graph)
        node = cls._set(graph, dep, h, live, 0, guard, reset=1)
        body_graph, cond = _P(), _P()
        _lg("lg_add_cond", graph, node, h, 1, ctypes.byref(body_graph),
            ctypes.byref(cond))
        last = cls._emit(body_graph, body)
        cls._set(body_graph, last, h, live, 0, guard, reset=0)
        return cond

    @staticmethod
    def _handle(graph) -> _U64:
        h = _U64()
        _lg("lg_handle_create", graph, ctypes.byref(h))
        return h

    @staticmethod
    def _set(graph, dep, h, flag: int, negate: int, guard=(None, 0, None),
             reset: int = 0):
        iters, limit, runaway = guard
        node = _P()
        _lg("lg_add_set", graph, dep, h, flag, negate, iters, limit, runaway,
            reset, ctypes.byref(node))
        return node

    @classmethod
    def _emit(cls, graph, items: List[tuple]):
        """Chain ``items`` in ``graph``.  A branch sets both IF handles
        before either branch runs, since a branch rewrites the flag for the
        next iteration."""
        last = None
        for item in items:
            if item[0] == "child":
                node = _P()
                _lg("lg_add_child", graph, last, item[1], ctypes.byref(node))
                last = node
                continue
            _, flag, if_true, if_false = item
            handles = [cls._handle(graph), cls._handle(graph)]
            for negate, h in enumerate(handles):
                last = cls._set(graph, last, h, flag, negate)
            for h, child in zip(handles, (if_true, if_false)):
                body, node, inner = _P(), _P(), _P()
                _lg("lg_add_cond", graph, last, h, 0, ctypes.byref(body),
                    ctypes.byref(node))
                _lg("lg_add_child", body, None, child, ctypes.byref(inner))
                last = node
        return last

    def launch(self, stream: int) -> None:
        _lg("lg_launch", self.exec, stream)


_CURRENT = threading.local()


def current_program() -> Optional["Program"]:
    """The :class:`Program` whose step this thread is warming up or
    capturing (None outside)."""
    return getattr(_CURRENT, "program", None)


class Program:
    """Static buffers on one device and the steps over them; on a CUDA
    device (unless ``capture=False``) every step runs as a CUDA graph and
    every loop as one conditional node.  ``loop_limit``: the runaway guard
    of the loops (more iterations than any loop of the entry can need)."""

    def __init__(self, device, capture: Optional[bool] = None,
                 loop_limit: int = 2**30):
        self.device = torch.device(device)
        self.capture = (self.device.type == "cuda" if capture is None
                        else bool(capture))
        self.loop_limit = int(loop_limit)
        self.buf = Buffers(counts=COUNTERS.tensor(self.device))
        self._scalars: Dict[str, int] = {}
        self._vector: Optional[torch.Tensor] = None
        self._graphs: Dict[str, torch.cuda.CUDAGraph] = {}
        self._loops: Dict[str, _LoopGraph] = {}
        self._warm: set = set()
        self._pool = None
        self._subs: Dict[tuple, "Program"] = {}
        self._unread = False        # a loop ran since the last read
        self._nbytes: Optional[int] = None
        self.pool_bytes = 0         # card memory the captures reserved
        self.captures = 0           # graphs captured so far
        self.lock = threading.RLock()

    # -- buffers --------------------------------------------------------------
    def alloc(self, name: str, shape, dtype=torch.int32) -> torch.Tensor:
        """An uninitialised buffer of ``shape`` (an int or a tuple)."""
        t = torch.empty(shape, dtype=dtype, device=self.device)
        self.buf[name] = t
        self._nbytes = None
        return t

    def constant(self, name: str, value: torch.Tensor) -> torch.Tensor:
        self.buf[name] = value.to(self.device)
        self._nbytes = None
        return self.buf[name]

    def scalars(self, names: Sequence[str]) -> None:
        """The loops' scalars: 0-d int32 views into one vector, in the
        order given (so a run of them can be set with one copy), then the
        runaway guard's ``loop_iters`` and ``runaway``."""
        names = tuple(names) + ("loop_iters", "runaway")
        self._vector = torch.zeros(len(names), dtype=torch.int32,
                                   device=self.device)
        self.buf["scalars"] = self._vector
        for i, name in enumerate(names):
            self._scalars[name] = i
            self.buf[name] = self._vector[i]
        self._nbytes = None

    def scalar_slice(self, first: str, last: str) -> torch.Tensor:
        """The scalars from ``first`` to ``last`` as one view."""
        i, j = self._scalars[first], self._scalars[last]
        return self._vector[i:j + 1]

    def sub(self, key: tuple, build: Callable[[], "Program"]) -> "Program":
        """The program kept under ``key`` for a part of a step that has
        loops of its own (a built-in warm start that a registered one
        calls), built on first use, never inside a capture.  Its loops
        share this program's runaway guard, and its bytes and captures
        count as this program's."""
        P = self._subs.get(key)
        if P is None:
            if self.device.type == "cuda" and \
                    torch.cuda.is_current_stream_capturing():
                raise CaptureError(
                    f"{key!r} first ran inside a capture: its loops need "
                    f"their own graphs, captured before")
            P = build()
            P.loop_limit = self.loop_limit
            P.buf["loop_iters"] = self.buf.loop_iters
            P.buf["runaway"] = self.buf.runaway
            self._subs[key] = P
            self._nbytes = None
        return P

    def nbytes(self) -> int:
        """Bytes of the static buffers (its subprograms' included; the
        graphs' pool is :meth:`total_bytes`)."""
        if self._nbytes is None:
            seen, total = set(), 0
            for P in (self, *self._subs.values()):
                for t in P.buf.values():
                    st = t.untyped_storage()
                    if st.data_ptr() not in seen:
                        seen.add(st.data_ptr())
                        total += st.nbytes()
            self._nbytes = total
        return self._nbytes

    def total_bytes(self) -> int:
        """The static buffers and the card memory the graphs' captures
        reserved: what this program holds."""
        return self.nbytes() + self.pool_bytes + sum(
            P.pool_bytes for P in self._subs.values())

    def total_captures(self) -> int:
        """Graphs captured so far, its subprograms' included."""
        return self.captures + sum(P.captures for P in self._subs.values())

    # -- running --------------------------------------------------------------
    def read(self, *names: str) -> List[int]:
        """The named scalars on the host: one copy, one counted sync.
        Raises if a loop hit its runaway guard."""
        COUNTERS.host_syncs += 1
        self._unread = False
        values = self._vector.tolist()
        if values[self._scalars["runaway"]]:
            raise RuntimeError(
                f"a device loop ran {self.loop_limit} iterations and was "
                f"stopped: the solve is not valid")
        return [values[self._scalars[n]] for n in names]

    def check(self) -> None:
        """If a loop ran since the last :meth:`read`, read (one counted
        sync), so that a runaway loop raises before its result is used."""
        if self._unread:
            self.read()

    def set(self, name: str, value: int) -> None:
        """Set one scalar (a fill: no host sync)."""
        self.buf[name].fill_(value)

    def _capturing(self) -> bool:
        return self.device.type == "cuda" and \
            torch.cuda.is_current_stream_capturing()

    def once(self, step: Once) -> None:
        self._unread |= step.loops
        if not self.capture or self._capturing():
            step.fn(self.buf)           # inside a capture: captured inline
            return
        self._graph(step.name, step.fn).replay()

    def loop(self, loop: Loop) -> None:
        """Run ``loop`` to its end: on a card one launch of its WHILE node
        (inside another step's capture, the node added to that capture);
        uncaptured its step while the flag is set, tested before every
        step by the host (on a card, a counted host sync a test)."""
        if loop.start:
            self.set(loop.live, 1)
        self._unread = True
        if self.capture:
            if self._capturing():
                self._emit(loop)
                return
            with torch.cuda.device(self.device):
                self._loop_graph(loop).launch(
                    torch.cuda.current_stream().cuda_stream)
            return
        if self._capturing():
            raise CaptureError(
                f"loop {loop.name!r} of an uncaptured program cannot run "
                f"inside a CUDA graph capture")
        step, live = loop.step, self.buf[loop.live]
        # on the CPU the host is the device: its test is the WHILE node's
        card = self.device.type == "cuda"
        for _ in range(self.loop_limit):
            COUNTERS.host_syncs += card
            if not int(live):
                return
            step(self.buf)
        if int(live):
            self.set("runaway", 1)

    def run_stages(self, stages: Sequence) -> None:
        for stage in stages:
            if isinstance(stage, Loop):
                self.loop(stage)
            else:
                self.once(stage)

    # -- capture --------------------------------------------------------------
    def _ptr(self, name: str) -> int:
        return self.buf[name].data_ptr()

    def _guard(self) -> tuple:
        return (self._ptr("loop_iters"), self.loop_limit,
                self._ptr("runaway"))

    def _loop_items(self, loop: Loop) -> List[tuple]:
        """The body of ``loop``'s WHILE node: its steps' captured graphs."""
        body = loop.body
        if isinstance(body, Branch):
            return [("branch", self._ptr(body.flag),
                     self._raw(f"{loop.name}.true", body.if_true),
                     self._raw(f"{loop.name}.false", body.if_false))]
        return [("child", self._raw(loop.name, body))]

    def _loop_graph(self, loop: Loop) -> _LoopGraph:
        lg = self._loops.get(loop.name)
        if lg is None:
            lg = self._loops[loop.name] = _LoopGraph(
                self._loop_items(loop), self._ptr(loop.live), self._guard())
        return lg

    def _emit(self, loop: Loop) -> None:
        """Add ``loop``'s WHILE node to the graph being captured on the
        current stream.  Its step's graph must have been captured before
        (the enclosing step's warm-up runs the loop for real)."""
        if loop.name not in self._loops:
            raise CaptureError(
                f"loop {loop.name!r} has no captured step: it must run once "
                f"before the capture that holds it")
        items = self._loop_items(loop)
        stream = torch.cuda.current_stream().cuda_stream
        graph, dep = _P(), _P()
        _lg("lg_capture_tail", stream, ctypes.byref(graph), ctypes.byref(dep))
        node = _LoopGraph.build(graph, dep if dep.value else None, items,
                                self._ptr(loop.live), self._guard())
        _lg("lg_capture_continue", stream, node)

    def _raw(self, name: str, fn: Step) -> int:
        """The captured graph of ``fn`` as a raw ``cudaGraph_t`` (kept by
        its torch graph, which keeps the pool memory it uses)."""
        return self._graph(name, fn, keep=True).raw_cuda_graph()

    def _graph(self, name: str, fn: Step,
               keep: bool = False) -> torch.cuda.CUDAGraph:
        """The graph of ``fn``, captured at first use; ``keep``: a graph
        kept for a loop's node, not instantiated for replay."""
        g = self._graphs.get(name)
        if g is not None:
            return g
        if self._capturing():
            raise CaptureError(f"step {name!r} has no graph, and none can be "
                               f"captured inside another capture")
        outer = current_program()
        DEVICE_LOCK.acquire()
        _CURRENT.program = self
        try:
            if name not in self._warm:
                self._warm_up(fn)
                self._warm.add(name)
            g = torch.cuda.CUDAGraph(keep_graph=keep)
            try:
                with torch.cuda.device(self.device), torch.cuda.graph(
                        g, pool=self._pool,
                        capture_error_mode="thread_local"):
                    # read after the capture's own empty_cache: what grows
                    # from here is this pool's
                    reserved = torch.cuda.memory_reserved(self.device)
                    fn(self.buf)
            except Exception as err:
                raise CaptureError(
                    f"step {name!r} could not be captured into a CUDA graph "
                    f"({type(err).__name__}: {err}); a step must run on the "
                    f"device alone, with no host read") from err
        finally:
            DEVICE_LOCK.release()
            _CURRENT.program = outer
        self.pool_bytes += max(
            0, torch.cuda.memory_reserved(self.device) - reserved)
        if self._pool is None:
            self._pool = g.pool()
        self._graphs[name] = g
        self.captures += 1
        return g

    def _warm_up(self, fn: Step) -> None:
        """``fn`` once on a side stream against scratch copies of the
        buffers, its kernel launches uncounted."""
        with torch.cuda.device(self.device):
            cur = torch.cuda.current_stream()
            scratch = Buffers({k: v.clone() for k, v in self.buf.items()})
            side = torch.cuda.Stream()
            side.wait_stream(cur)
            with torch.cuda.stream(side), uncounted():
                fn(scratch)
            cur.wait_stream(side)
            torch.cuda.synchronize()
            del scratch
