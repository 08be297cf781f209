"""The collectives of the port's data axis, on a rank's own tensors.

Where the JAX package reduces over a mesh axis inside one program
(``lax.pmin`` of the matcher's winners, ``psum`` and GSPMD's
reduce-scatter / all-gather of the train step), each rank of a
:class:`~.world.World` calls one of these:

* :func:`all_reduce_min_` / :func:`all_reduce_sum_` /
  :func:`all_reduce_max_`: in place;
* :func:`broadcast_`: in place, from rank ``src``;
* :func:`reduce_scatter_mean`: the mean over the ranks of a whole tensor,
  of which this rank keeps slice ``rank`` along ``dim``;
* :func:`all_gather_into`: every rank's slice along ``dim`` into a whole
  tensor.

Each takes a :class:`~.world.World` (every rank: its ``every`` axis) or
one of its :class:`~.world.Axis` (``world.data``, ``world.model``: the
ranks along that axis, through the axis's group).  Over a mesh axis of one
rank each is the identity and calls nothing; over the whole world each is
called, a world of one included (under NCCL its collective is then
captured with a CUDA graph like any other).

The model axis's differentiable collectives (Megatron's four, each
backward the conjugate collective) are ``torch.autograd.Function``s over
an axis: :func:`copy_to` (identity forward, all-reduce backward),
:func:`reduce_from` (all-reduce forward, identity backward),
:func:`gather_from` (all-gather forward, reduce-scatter backward; sequence
parallelism and FSDP) and :func:`scatter_to` (reduce-scatter forward,
all-gather backward), with :func:`split_to` (this rank's slice forward,
all-gather backward).

Every op takes the rank's tensors as they are, on the CPU or on the card.
NCCL runs them on the card (and a collective inside a CUDA graph capture
is captured with it).  gloo takes card tensors too, for all four ops,
copying through the host itself: read on the card host's PyTorch (2.11,
CUDA 12.8; a gloo world of two ranks sharing an H100), and held there by
the ``gpu`` test ``test_cuda_gloo_device_ops``.  Nothing is staged by
hand, and nothing is tried and retried another way.

:data:`COUNTS` records, per op, the calls and the bytes handed to the
collective, and :data:`AXIS_COUNTS` the same per axis (``"data"``,
``"model"``, or ``"world"`` for a whole world's).  A collective captured
into a CUDA graph counts once, at its capture, not at its replays.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from .world import Axis, World, require_world

OPS = ("all_reduce", "broadcast", "reduce_scatter", "all_gather", "gather")

# torch 2.13 renamed the two tensor collectives; the card host's torch may
# have only the old names
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor

COUNTS: Dict[str, Dict[str, int]] = {op: {"calls": 0, "bytes": 0}
                                     for op in OPS}
AXIS_COUNTS: Dict[str, Dict[str, Dict[str, int]]] = {}


def reset_counts() -> None:
    for c in COUNTS.values():
        for k in c:
            c[k] = 0
    AXIS_COUNTS.clear()


def counts() -> Dict[str, Dict[str, int]]:
    """A copy of :data:`COUNTS`."""
    return {op: dict(c) for op, c in COUNTS.items()}


def axis_counts() -> Dict[str, Dict[str, Dict[str, int]]]:
    """A copy of :data:`AXIS_COUNTS`."""
    return {a: {op: dict(c) for op, c in ops.items()}
            for a, ops in AXIS_COUNTS.items()}


def _axis(world) -> Axis:
    """The axis a collective runs over: ``world`` an axis, or the whole of
    ``world`` (the current world where None)."""
    w = require_world(world)
    return w.every if isinstance(w, World) else w


def _count(op: str, t: torch.Tensor, ax: Axis) -> None:
    n = t.numel() * t.element_size()
    for c in (COUNTS[op], AXIS_COUNTS.setdefault(ax.name, {}).setdefault(
            op, {"calls": 0, "bytes": 0})):
        c["calls"] += 1
        c["bytes"] += n


def _one(ax: Axis) -> bool:
    """A mesh axis of one rank: every collective over it is the
    identity."""
    return ax.size == 1 and ax.name != "world"


def _all_reduce(t: torch.Tensor, op, world: Optional[World]
                ) -> torch.Tensor:
    w = _axis(world)
    if _one(w):
        return t
    _count("all_reduce", t, w)
    dist.all_reduce(t, op=op, group=w.group)
    return t


def all_reduce_min_(t: torch.Tensor, world: Optional[World] = None
                    ) -> torch.Tensor:
    """``t`` <- the elementwise min of every rank's ``t``."""
    return _all_reduce(t, dist.ReduceOp.MIN, world)


def all_reduce_sum_(t: torch.Tensor, world: Optional[World] = None
                    ) -> torch.Tensor:
    """``t`` <- the sum of every rank's ``t``."""
    return _all_reduce(t, dist.ReduceOp.SUM, world)


def all_reduce_max_(t: torch.Tensor, world: Optional[World] = None
                    ) -> torch.Tensor:
    """``t`` <- the elementwise max of every rank's ``t``."""
    return _all_reduce(t, dist.ReduceOp.MAX, world)


def broadcast_(t: torch.Tensor, src: int = 0,
               world: Optional[World] = None) -> torch.Tensor:
    """``t`` <- rank ``src``'s ``t`` (``src`` an index along the axis
    given)."""
    w = _axis(world)
    if _one(w):
        return t
    _count("broadcast", t, w)
    dist.broadcast(t, src=w.ranks[src], group=w.group)
    return t


def _front(t: torch.Tensor, dim: int) -> torch.Tensor:
    return (t if dim == 0 else t.movedim(dim, 0)).contiguous()


def reduce_scatter_sum(t: torch.Tensor, dim: int = 0,
                       world: Optional[World] = None) -> torch.Tensor:
    """The sum over the ranks of the whole tensor ``t``, of which this
    rank gets slice ``rank`` along ``dim`` (``t.shape[dim]`` divided by
    the ranks' number), as a new contiguous tensor."""
    w = _axis(world)
    if t.shape[dim] % w.size:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"over {w.size} ranks")
    if _one(w):
        return t.contiguous()
    x = _front(t, dim)
    out = torch.empty((x.shape[0] // w.size,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _count("reduce_scatter", x, w)
    _REDUCE_SCATTER(out, x, op=dist.ReduceOp.SUM, group=w.group)
    del x
    return out if dim == 0 else out.movedim(0, dim).contiguous()


def reduce_scatter_mean(t: torch.Tensor, dim: int = 0,
                        world: Optional[World] = None) -> torch.Tensor:
    """:func:`reduce_scatter_sum` divided by the ranks' number."""
    w = _axis(world)
    out = reduce_scatter_sum(t, dim, w)
    if out is t:
        out = out.clone()
    return out.div_(w.size)


def all_gather_into(out: torch.Tensor, t: torch.Tensor, dim: int = 0,
                    world: Optional[World] = None) -> torch.Tensor:
    """``out`` <- every rank's ``t`` (this rank's slice of ``out`` along
    ``dim``), in rank order; returns ``out``."""
    w = _axis(world)
    if _one(w):
        return out.copy_(t)
    x = _front(t, dim)
    whole = (out if dim == 0 and out.is_contiguous() else torch.empty(
        (x.shape[0] * w.size,) + tuple(x.shape[1:]), dtype=x.dtype,
        device=x.device))
    _count("all_gather", x, w)
    _ALL_GATHER(whole, x, group=w.group)
    if whole is not out:
        out.copy_(whole if dim == 0 else whole.movedim(0, dim))
    return out


def all_gather(t: torch.Tensor, dim: int = 0,
               world: Optional[World] = None) -> torch.Tensor:
    """Every rank's ``t`` joined along ``dim`` in rank order, as a new
    tensor."""
    w = _axis(world)
    shape = list(t.shape)
    shape[dim] *= w.size
    return all_gather_into(t.new_empty(shape), t, dim, w)


def gather_to_first(t: torch.Tensor, dim: int = 0,
                    world: Optional[World] = None) -> Optional[torch.Tensor]:
    """Every rank's ``t`` joined along ``dim`` in rank order on the axis's
    first rank; the others get None.  gloo gathers host tensors, NCCL card
    tensors."""
    w = _axis(world)
    if _one(w):
        return t
    parts = ([torch.empty_like(t) for _ in range(w.size)]
             if w.rank == 0 else None)
    _count("gather", t, w)
    dist.gather(t, parts, dst=w.ranks[0], group=w.group)
    return None if parts is None else torch.cat(parts, dim)


def barrier(world: Optional[World] = None) -> None:
    """Every rank waits for every other."""
    w = _axis(world)
    if not _one(w):
        dist.barrier(group=w.group)


# ---------------------------------------------------------------------------
# differentiable collectives over an axis (module doc)
# ---------------------------------------------------------------------------
class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum_(g.contiguous(), ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce_sum_(x.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return all_gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_sum(g, ctx.dim, ctx.axis), None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return reduce_scatter_sum(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.dim, ctx.axis), None, None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        k = x.shape[dim] // axis.size
        return x.narrow(dim, axis.rank * k, k).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.dim, ctx.axis), None, None


def copy_to(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x`` (every rank's the same) into a region cut over ``axis``: the
    identity forward, the sum of the ranks' gradients backward."""
    return x if axis.size == 1 else _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum over ``axis`` of the ranks' partial ``x``; the gradient
    passes through unchanged (every rank's the same)."""
    return x if axis.size == 1 else _ReduceFrom.apply(x, axis)


def gather_from(x: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    """The ranks' slices of a tensor along ``dim`` joined whole; backward,
    the sum over the ranks of the whole gradient, this rank's slice of
    it."""
    return x if axis.size == 1 else _GatherFrom.apply(x, dim, axis)


def scatter_to(x: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    """This rank's slice along ``dim`` of the sum over ``axis`` of the
    ranks' partial ``x``; backward, the slices' gradients joined whole."""
    return x if axis.size == 1 else _ScatterTo.apply(x, dim, axis)


def split_to(x: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    """This rank's slice along ``dim`` of ``x`` (every rank's the same);
    backward, the slices' gradients joined whole."""
    return x if axis.size == 1 else _SplitTo.apply(x, dim, axis)
