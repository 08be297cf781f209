"""Step-atomic checkpoints (the JAX package's ``ckpt/checkpoint.py``), in
its on-disk layout, so either package restores the other's:

  <dir>/step_<n:09d>/
    manifest.msgpack    {step, leaves: {key: {file, shape, dtype}}}  (LAST)
    <key with / -> __>.npy   one file per leaf of the nested dict

A leaf's key is the ``/``-joined path of dict keys (sorted at each level,
the JAX package's leaf order).  ``save_checkpoint`` writes every leaf,
then the manifest, into ``step_<n>.tmp`` and publishes it with
``os.replace``: a crash mid-save leaves no manifest under ``step_<n>``, so
``latest_step`` never picks a torn checkpoint.  Only the newest ``keep``
steps stay.

bfloat16 leaves are written as the JAX package writes them (its
``ml_dtypes`` arrays): 2-byte ``<V2`` records with ``"bfloat16"`` in the
manifest; they are read back by viewing the bytes as int16 and then as
``torch.bfloat16``.  The JAX package's own restore cannot read them
(``astype`` from ``V2`` fails, ROADMAP.md, Queue 3); this one reads its
files and its own.  The manifest codec is :mod:`._msgpack`.

Over a world's ranks a leaf may be cut over the data axis (ZeRO-1, FSDP)
and the model axis: ``dims`` holds, per leaf, its cuts
(:data:`~repro_torch.models.common.Cut` tuples: the model's
:func:`~repro_torch.models.common.leaf_place` for the params,
:func:`~repro_torch.optim.adamw.state_cuts` for the state).
``save_checkpoint(..., world=, dims=)`` gathers each cut leaf over its
axes onto rank 0 (``gather_cuts(..., root=True)``, one leaf whole at a
time: on the host under gloo, on the card under NCCL), and rank 0 alone
writes the reference's layout of whole leaves and publishes it; then
every rank waits for the others.  So one device, any world and the JAX
package (fp32 leaves) all restore it.
``restore_checkpoint(..., world=, dims=)`` reads each whole leaf and
keeps this rank's part of it by the ``dims`` given for the world it runs
in: elastic restore, from any ``D x M`` to any other (``2x2 -> 1``, ``1
-> 1x2``, ``2x2 -> 2``), the counterpart of the JAX function's ``mesh``
and ``sharding_tree``.
"""
from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from numpy.lib import format as npy_format

from repro_torch._device import resolve_device
from repro_torch.distributed.comm import barrier
from repro_torch.models.common import gather_cuts, take_cuts

from . import _msgpack

MANIFEST = "manifest.msgpack"


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    if isinstance(tree, dict):
        out: Dict[str, Any] = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """The leaf's host array and the dtype name the manifest records."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _save_leaf(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:             # the JAX package's <V2 records
        npy_format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": tuple(arr.shape)})
        f.write(arr.tobytes())


def save_checkpoint(directory: str, step: int, tree, keep: int = 3,
                    world=None, dims=None) -> str:
    """Write ``tree`` as step ``step`` (module doc); returns its directory.
    ``world``: called on every rank, ``dims`` a tree over the subtrees
    whose leaves are cut (``{"params": ..., "opt": adamw.state_cuts(...)}``),
    each leaf's cuts (``()``: whole, equal on every rank); the gathered
    whole leaves written by rank 0."""
    d = os.path.join(directory, f"step_{step:09d}")
    tmp = d + ".tmp"
    writer = world is None or world.rank == 0
    if writer:
        os.makedirs(tmp, exist_ok=True)
    cut = _flatten(dims) if dims is not None else {}
    meta: Dict[str, Any] = {"step": step, "leaves": {}}
    for key, leaf in _flatten(tree).items():
        if world is not None and cut.get(key):
            leaf = gather_cuts(leaf, cut[key], world, root=True)
        if not writer:
            continue
        arr, dtype = _to_numpy(leaf)
        del leaf
        fn = key.replace("/", "__") + ".npy"
        _save_leaf(os.path.join(tmp, fn), arr, dtype)
        meta["leaves"][key] = {"file": fn, "shape": list(arr.shape),
                               "dtype": dtype}
    if writer:
        with open(os.path.join(tmp, MANIFEST), "wb") as f:
            f.write(_msgpack.packb(meta))
        os.replace(tmp, d)                  # atomic publish
        _gc(directory, keep)
    if world is not None:
        barrier(world)
    return d


def _gc(directory: str, keep: int) -> None:
    steps = sorted(_steps(directory))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:09d}"),
                      ignore_errors=True)


def _steps(directory: str):
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name, MANIFEST)):
            out.append(int(m.group(1)))
    return out


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return max(steps) if steps else None


def _load_leaf(path: str, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore_checkpoint(directory: str, tree_like, step: Optional[int] = None,
                       device=None, world=None, dims=None
                       ) -> Tuple[Any, int]:
    """Restore into the structure of ``tree_like`` (nested dicts), each
    leaf cast to the dtype of ``tree_like``'s leaf there and put on
    ``device`` (the card unless given).  A leaf of ``tree_like`` that is
    already a tensor of that shape and dtype on that device is filled in
    place and returned, so restoring a model's state on the card needs no
    second copy of it.  ``world`` and ``dims`` (as :func:`save_checkpoint`
    takes it, for the world restored in): the leaves it cuts are cut to
    this rank's part.  Returns ``(tree, step)``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    dev = resolve_device(device)
    d = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(d, MANIFEST), "rb") as f:
        meta = _msgpack.unpackb(f.read())
    cut = _flatten(dims) if dims is not None else {}
    out = {}
    for key, like in _flatten(tree_like).items():
        info = meta["leaves"].get(key)
        if info is None:
            raise KeyError(f"checkpoint at step {step} missing leaf {key}")
        t = _load_leaf(os.path.join(d, info["file"]), info["dtype"])
        if world is not None and cut.get(key):
            t = take_cuts(t, cut[key], world).contiguous()
        if isinstance(like, torch.Tensor):
            t = t.to(like.dtype)
            if like.device == dev and like.shape == t.shape:
                out[key] = like.copy_(t)
                continue
        out[key] = t.to(dev)

    def rebuild(tree, prefix: str = ""):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in tree.items()}
        return out[prefix[:-1]]

    return rebuild(tree_like), step
