"""Op-level cost model of one rank's step (the JAX package's
``launch/hlo_cost.py``, under its name so that a reader finds it).

It prices aten ops, not HLO.  The reference reads the optimized HLO text
of a compiled program; the port runs eagerly, so there is no program to
read, and :func:`analyze` runs ``fn(*args)`` under :class:`CostMode`, a
``TorchDispatchMode`` that sees every aten op the call makes, the
backward's included, and sums:

* ``flops``: ``torch.utils.flop_counter``'s formulas (matrix products,
  convolutions, SDPA, forward and backward), plus the work the
  hand-written kernels record (:mod:`repro_torch.kernels.work`: K4, whose
  launch is no aten op).  Elementwise FLOPs are left out, as the
  reference leaves them out;
* ``bytes``: each op's tensor operands plus its outputs.  Views, metadata
  and allocations are free, and collectives are left to
  ``collective_bytes``.  Nothing is fused in the eager port, so this is
  the port's own traffic to memory, op by op: a fused program would move
  less;
* ``collective_bytes``: the bytes each :mod:`repro_torch.distributed.comm`
  op hands to its collective, from ``comm.axis_counts()``;
  ``collective_detail`` splits them (and the calls) by axis and op;
* ``peak_bytes``: the high-water mark of live storage over the call, the
  arguments' included (``argument_bytes``), each storage counted from
  the op that makes it until torch frees it.  It estimates the eager
  step's peak; the caching allocator's rounding and the libraries'
  workspaces are not in it.

``unknown_while`` is always 0: eager code has no while loops to count.
The same model runs on any device: on ``meta`` (the dry run,
:mod:`.dryrun`), where nothing is computed, and on the card, where the
same step runs for real, so that the two can be held together.
"""
from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed import comm
from repro_torch.kernels import work as kernel_work

# ops that allocate without writing, only read metadata, or make a 0-d
# tensor of a Python number (which some ops do on one device and not on
# another): no bytes
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh", "sym_size",
         "sym_stride", "sym_numel", "sym_storage_offset", "scalar_tensor",
         "_local_scalar_dense"}


def _tensors(tree) -> Iterator[torch.Tensor]:
    """The tensors in nested tuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostMode(TorchDispatchMode):
    """The counters of :func:`analyze` (module doc) over the ops run while
    the mode is active."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.kernels: Dict[str, Dict[str, int]] = {}
        self.by_op: Dict[str, int] = {}       # aten op -> its bytes
        self.live = 0
        self.peak = 0
        self._held: Dict[int, int] = {}       # id(storage) -> its bytes

    def hold(self, t: torch.Tensor) -> bool:
        """Count ``t``'s storage as live until torch frees it (once per
        storage); whether it was new."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._held:
            return False
        n = st.nbytes()
        self._held[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)
        return True

    def _free(self, key: int) -> None:
        self.live -= self._held.pop(key, 0)

    def kernel(self, name: str, flops: int, nbytes: int) -> None:
        """A hand-written kernel's work (a sink of
        :mod:`repro_torch.kernels.work`)."""
        self.flops += flops
        self.bytes += nbytes
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                           "bytes": 0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes

    def __enter__(self):
        kernel_work.SINKS.append(self.kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        kernel_work.SINKS.remove(self.kernel)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        formula = flop_registry.get(packet)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        for t in _tensors(out):
            self.hold(t)
        if func.is_view or func.namespace != "aten" or \
                packet.__name__ in _FREE:
            return out
        n = sum(_nbytes(t) for t in _tensors((args, kwargs, out)))
        self.bytes += n
        self.by_op[packet.__name__] = self.by_op.get(packet.__name__, 0) + n
        return out


def _counts_since(before: dict) -> Dict[str, Dict[str, Dict[str, int]]]:
    """``comm.axis_counts()`` less ``before``, by axis and op."""
    out = {}
    for axis, ops in comm.axis_counts().items():
        for op, c in ops.items():
            was = before.get(axis, {}).get(op, {"calls": 0, "bytes": 0})
            d = {k: c[k] - was[k] for k in ("calls", "bytes")}
            if d["calls"]:
                out.setdefault(axis, {})[op] = d
    return out


def analyze(fn: Callable, *args, **kwargs) -> Dict[str, Any]:
    """The costs of ``fn(*args, **kwargs)`` (module doc): ``flops``,
    ``bytes``, ``collective_bytes``, ``collective_detail`` (axis -> op ->
    calls and bytes), ``unknown_while`` (0), and the port's own
    ``kernels`` (name -> calls, FLOPs, bytes), ``bytes_by_op`` (aten op ->
    bytes), ``argument_bytes``,
    ``peak_bytes``, ``output_bytes`` (the storage the call's result
    holds that its arguments did not) and the ``result`` itself."""
    mode = CostMode()
    for t in _tensors((args, kwargs)):
        mode.hold(t)
    argument_bytes = mode.live
    before = comm.axis_counts()
    with mode:
        result = fn(*args, **kwargs)
    detail = _counts_since(before)
    held = {id(t.untyped_storage()) for t in _tensors((args, kwargs))}
    output_bytes = sum(t.untyped_storage().nbytes() for t in {
        id(t.untyped_storage()): t for t in _tensors(result)}.values()
        if id(t.untyped_storage()) not in held)
    return {"flops": float(mode.flops), "bytes": float(mode.bytes),
            "collective_bytes": float(sum(c["bytes"] for ops in
                                          detail.values()
                                          for c in ops.values())),
            "collective_detail": detail, "unknown_while": 0,
            "kernels": mode.kernels, "bytes_by_op": mode.by_op,
            "argument_bytes": argument_bytes,
            "peak_bytes": mode.peak, "output_bytes": output_bytes,
            "result": result}
