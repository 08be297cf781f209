"""Warm-up ahead of traffic: build and capture the declared (bucket x config
x warm start x batch) grid before requests arrive.

The scheduler's batched dispatch hits the compile cache with the key
``((batch, nc, nr, nnz_pad[, "csc"]), config, (warm start, version),
"run_many")``; the mirror marker appears for direction-optimizing configs,
whose admissions carry the CSC mirror.  Warming exactly that grid (every
declared :class:`SizeBucket`, every served config / warm-start pair, every
:func:`batch_ladder` rung) means the first real request on a warmed bucket
never pays an entry build or a capture: its dispatch is a cache hit.

Warm-up drives each entry with a synthetic *empty* graph of the bucket's
exact shape: every edge an inert sentinel, so the solve ends after one
BFS, with no augmenting path.  That run reaches (and on a card captures)
the BFS's steps only, so each entry is then run once more with the
``ALTERNATE`` walk's steps forced on (:meth:`~repro_torch.matching.batch.
BatchProgram.warm`; they change nothing where no lane walks): no real
flush captures.  The entries stay resident only if their bytes, captures
included, fit the cache's budget: the report gives what the built entries
hold, read after every capture.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Optional, Tuple

import torch

from repro_torch.matching import MatcherConfig
from repro_torch.matching.cache import (compile_cache_entry,
                                        compile_cache_fit,
                                        compile_cache_thread_info)
from repro_torch.matching.device_csr import TorchCSR

from .bucketizer import SizeBucket
from .scheduler import batch_ladder


def synthetic_bucket_graph(bucket: SizeBucket, csc: bool = False,
                           device=None) -> TorchCSR:
    """An empty (all-sentinel-edges) graph of exactly the bucket's shape on
    ``device`` (None: the CUDA card); ``csc`` attaches the CSC mirror,
    whose presence is part of the cache key."""
    from repro_torch._device import resolve_device
    dev = resolve_device(device)
    g = TorchCSR(
        cxadj=torch.zeros(bucket.nc + 1, dtype=torch.int32, device=dev),
        cadj=torch.full((bucket.nnz_pad,), bucket.nr, dtype=torch.int32,
                        device=dev),
        ecol=torch.full((bucket.nnz_pad,), bucket.nc, dtype=torch.int32,
                        device=dev),
        nnz=0, nc=bucket.nc, nr=bucket.nr)
    return g.with_csc() if csc else g


@dataclasses.dataclass(frozen=True)
class WarmupGrid:
    """The declared serving surface to capture ahead of time."""

    buckets: Tuple[SizeBucket, ...]
    configs: Tuple[MatcherConfig, ...]
    warm_starts: Tuple[str, ...]
    batch_sizes: Tuple[int, ...]

    def cells(self):
        return itertools.product(self.buckets, self.configs,
                                 self.warm_starts, self.batch_sizes)

    def __len__(self) -> int:
        return (len(self.buckets) * len(self.configs)
                * len(self.warm_starts) * len(self.batch_sizes))


@dataclasses.dataclass(frozen=True)
class WarmupReport:
    cells: int          # grid cells driven
    compiled: int       # entries actually built (cache misses)
    already: int        # cells that were already resident (cache hits)
    seconds: float
    entry_bytes: int = 0    # bytes the grid's entries hold after warm-up

    def __str__(self) -> str:
        return (f"warmup: {self.cells} cells, {self.compiled} compiled, "
                f"{self.already} already resident, {self.seconds:.2f}s, "
                f"{self.entry_bytes / 1e9:.3f} GB of entries")


def warm_up(service, grid: Optional[WarmupGrid] = None) -> WarmupReport:
    """Drive every grid cell through the service's matchers.

    With ``grid=None`` the grid is the service's declared surface: its
    bucketizer's buckets, its default config and warm start, and the batch
    ladder up to its ``max_batch``.  Returns once every entry has finished
    its solve, every graph of its steps captured on a card.
    """
    if grid is None:
        grid = WarmupGrid(buckets=tuple(service.bucketizer.buckets),
                          configs=(service.config,),
                          warm_starts=(service.warm_start,),
                          batch_sizes=batch_ladder(service.max_batch))
    device = service.bucketizer.device
    t0 = time.perf_counter()
    # per-thread deltas: warm-up builds on the calling thread, so another
    # thread's builds (a flush, a second service warming) can't skew it
    info0 = compile_cache_thread_info()
    keys, cells = [], 0
    for bucket, cfg, ws, bs in grid.cells():
        # the mirror marker must match what admission attaches for this
        # config, or the warmed entry would not be the served one
        csc = cfg.dirop or service.bucketizer.build_csc
        g = synthetic_bucket_graph(bucket, csc=csc, device=device)
        m = service.matcher(cfg, ws)
        batch = TorchCSR.stack([g] * bs)
        m.run_many(batch)
        key = (batch.bucket_key, m.config, m._cache_tag(True), "run_many")
        compile_cache_entry(key).warm(batch)
        compile_cache_fit(keep=key)     # the captures' bytes count now
        keys.append(key)
        cells += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    info1 = compile_cache_thread_info()
    compiled = info1["misses"] - info0["misses"]
    held = [compile_cache_entry(k) for k in keys]
    return WarmupReport(cells=cells, compiled=compiled,
                        already=cells - compiled,
                        seconds=time.perf_counter() - t0,
                        entry_bytes=sum(e.nbytes() for e in held
                                        if e is not None))
