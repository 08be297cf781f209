"""The benchmark's inputs: host graphs made on the device from the seed.

A graph family is a module ``bench/families/<family>.py`` with one function,
``edges(spec, gen, device) -> (cols, rows, nc, nr)``: an unsorted int64 edge
list on ``device`` drawn from the ``torch.Generator`` ``gen``.  This module
turns such a list into the column-major CSR both sides read (duplicates
dropped, edges sorted by column then row, padding slots holding the
sentinels ``nr`` / ``nc``) and copies it to the host once.  The program gets
these arrays as its host graph; the reference reads the same arrays.

Nothing here imports the program.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import List

import numpy as np
import torch

LANE = 128


@dataclasses.dataclass(frozen=True)
class HostGraph:
    """Column-major CSR on the host: ``cxadj`` (nc+1,), ``cadj`` / ``ecol``
    (nnz_pad,) int32, the first ``nnz`` slots real, the rest sentinels."""

    nc: int
    nr: int
    nnz: int
    cxadj: np.ndarray
    cadj: np.ndarray
    ecol: np.ndarray

    @property
    def nnz_pad(self) -> int:
        return int(self.cadj.shape[0])


def padded_size(nnz: int, pad: str) -> int:
    """Edge slots for ``nnz`` edges: ``"lane"`` rounds up to a multiple of
    128, ``"bucket"`` to the power-of-two multiple of 128 that holds them
    (the size buckets the program's compile cache is keyed on)."""
    if pad == "lane":
        return max(LANE, -(-nnz // LANE) * LANE)
    if pad == "bucket":
        cap = LANE
        while cap < nnz:
            cap *= 2
        return cap
    raise ValueError(f"unknown padding rule {pad!r}")


def to_csr(cols: torch.Tensor, rows: torch.Tensor, nc: int, nr: int,
           pad: str = "lane") -> HostGraph:
    """Deduplicate and sort an edge list on its device, then copy the CSR
    arrays to the host."""
    keys = torch.unique(cols.to(torch.int64) * nr + rows.to(torch.int64))
    c = keys // nr
    r = keys - c * nr
    nnz = int(keys.numel())
    cap = padded_size(nnz, pad)
    dev = keys.device
    cxadj = torch.zeros(nc + 1, dtype=torch.int64, device=dev)
    cxadj[1:] = torch.cumsum(torch.bincount(c, minlength=nc), 0)
    cadj = torch.full((cap,), nr, dtype=torch.int32, device=dev)
    ecol = torch.full((cap,), nc, dtype=torch.int32, device=dev)
    cadj[:nnz] = r.to(torch.int32)
    ecol[:nnz] = c.to(torch.int32)
    return HostGraph(nc=nc, nr=nr, nnz=nnz,
                     cxadj=cxadj.to(torch.int32).cpu().numpy(),
                     cadj=cadj.cpu().numpy(), ecol=ecol.cpu().numpy())


def family(name: str):
    """The module of graph family ``name`` (``bench/families/<name>.py``)."""
    return importlib.import_module(f"bench.families.{name}")


def generator(seed: int, device) -> torch.Generator:
    """The run's one source of randomness: every input is drawn from it in
    a fixed order, so a seed gives the same inputs on the same device."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    return gen


def make_pool(spec: dict, gen: torch.Generator, device) -> List[HostGraph]:
    """The traffic's graphs, in the order its ``graphs`` spec lists them.

    ``spec``: ``family`` and its parameters, ``pad`` (``"lane"`` or
    ``"bucket"``) and either ``pool`` (that many graphs of the one
    parameter set) or ``sizes``: a list of parameter sets, each with a
    ``count``.  Every seed makes the same number of graphs of each size."""
    fam = family(spec["family"])
    pad = spec.get("pad", "lane")
    sets = spec.get("sizes") or [dict(count=spec.get("pool", 1))]
    out = []
    for size in sets:
        params = {k: v for k, v in spec.items()
                  if k not in ("family", "pad", "pool", "sizes")}
        params.update({k: v for k, v in size.items() if k != "count"})
        for _ in range(int(size["count"])):
            cols, rows, nc, nr = fam.edges(params, gen, device)
            out.append(to_csr(cols, rows, nc, nr, pad))
            del cols, rows
    return out


def permutation(n: int, count: int, gen: torch.Generator) -> List[int]:
    """``count`` indices cycling through a seeded order of ``range(n)``:
    every index once per cycle."""
    out: List[int] = []
    while len(out) < count:
        out += torch.randperm(n, generator=gen,
                              device=gen.device).tolist()
    return out[:count]
