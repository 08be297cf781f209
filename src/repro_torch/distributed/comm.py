"""The collectives of the port's data axis, on a rank's own tensors.

Where the JAX package reduces over a mesh axis inside one program
(``lax.pmin`` of the matcher's winners, ``psum`` and GSPMD's
reduce-scatter / all-gather of the train step), each rank of a
:class:`~.world.World` calls one of these:

* :func:`all_reduce_min_` / :func:`all_reduce_sum_`: in place;
* :func:`broadcast_`: in place, from rank ``src``;
* :func:`reduce_scatter_mean`: the mean over the ranks of a whole tensor,
  of which this rank keeps slice ``rank`` along ``dim``;
* :func:`all_gather_into`: every rank's slice along ``dim`` into a whole
  tensor.

Every op takes the rank's tensors as they are, on the CPU or on the card.
NCCL runs them on the card (and a collective inside a CUDA graph capture
is captured with it).  gloo takes card tensors too, for all four ops,
copying through the host itself: read on the card host's PyTorch (2.11,
CUDA 12.8; a gloo world of two ranks sharing an H100), and held there by
the ``gpu`` test ``test_cuda_gloo_device_ops``.  Nothing is staged by
hand, and nothing is tried and retried another way.

:data:`COUNTS` records, per op, the calls and the bytes handed to the
collective.  A collective captured into a CUDA graph counts once, at its
capture, not at its replays.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from .world import World, require_world

OPS = ("all_reduce", "broadcast", "reduce_scatter", "all_gather")

# torch 2.13 renamed the two tensor collectives; the card host's torch may
# have only the old names
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor

COUNTS: Dict[str, Dict[str, int]] = {op: {"calls": 0, "bytes": 0}
                                     for op in OPS}


def reset_counts() -> None:
    for c in COUNTS.values():
        for k in c:
            c[k] = 0


def counts() -> Dict[str, Dict[str, int]]:
    """A copy of :data:`COUNTS`."""
    return {op: dict(c) for op, c in COUNTS.items()}


def _count(op: str, t: torch.Tensor) -> None:
    c = COUNTS[op]
    c["calls"] += 1
    c["bytes"] += t.numel() * t.element_size()


def _all_reduce(t: torch.Tensor, op, world: Optional[World]
                ) -> torch.Tensor:
    require_world(world)
    _count("all_reduce", t)
    dist.all_reduce(t, op=op)
    return t


def all_reduce_min_(t: torch.Tensor, world: Optional[World] = None
                    ) -> torch.Tensor:
    """``t`` <- the elementwise min of every rank's ``t``."""
    return _all_reduce(t, dist.ReduceOp.MIN, world)


def all_reduce_sum_(t: torch.Tensor, world: Optional[World] = None
                    ) -> torch.Tensor:
    """``t`` <- the sum of every rank's ``t``."""
    return _all_reduce(t, dist.ReduceOp.SUM, world)


def broadcast_(t: torch.Tensor, src: int = 0,
               world: Optional[World] = None) -> torch.Tensor:
    """``t`` <- rank ``src``'s ``t``."""
    require_world(world)
    _count("broadcast", t)
    dist.broadcast(t, src=src)
    return t


def _front(t: torch.Tensor, dim: int) -> torch.Tensor:
    return (t if dim == 0 else t.movedim(dim, 0)).contiguous()


def reduce_scatter_mean(t: torch.Tensor, dim: int = 0,
                        world: Optional[World] = None) -> torch.Tensor:
    """The mean over the ranks of the whole tensor ``t``, of which this
    rank gets slice ``rank`` along ``dim`` (``t.shape[dim]`` divided by
    the world's size), as a new contiguous tensor."""
    w = require_world(world)
    if t.shape[dim] % w.size:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"over {w.size} ranks")
    x = _front(t, dim)
    out = torch.empty((x.shape[0] // w.size,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _count("reduce_scatter", x)
    _REDUCE_SCATTER(out, x, op=dist.ReduceOp.SUM)
    del x
    out.div_(w.size)
    return out if dim == 0 else out.movedim(0, dim).contiguous()


def all_gather_into(out: torch.Tensor, t: torch.Tensor, dim: int = 0,
                    world: Optional[World] = None) -> torch.Tensor:
    """``out`` <- every rank's ``t`` (this rank's slice of ``out`` along
    ``dim``), in rank order; returns ``out``."""
    w = require_world(world)
    x = _front(t, dim)
    whole = (out if dim == 0 and out.is_contiguous() else torch.empty(
        (x.shape[0] * w.size,) + tuple(x.shape[1:]), dtype=x.dtype,
        device=x.device))
    _count("all_gather", x)
    _ALL_GATHER(whole, x)
    if whole is not out:
        out.copy_(whole if dim == 0 else whole.movedim(0, dim))
    return out


def barrier(world: Optional[World] = None) -> None:
    """Every rank waits for every other."""
    require_world(world)
    dist.barrier()
