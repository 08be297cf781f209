"""Explicit compile cache for matcher programs.

The counterpart of the JAX package's ``repro.matching.cache``: one
process-wide table keyed on ``(bucket shape, MatcherConfig, warm start,
entry point)``, the things that force a new program here as they force a
recompile there.  An entry is a :class:`~repro_torch.matching.solve.
MatcherProgram`: per device, the static buffers of one size bucket (the
graph's arrays, its CSC mirror where the config pulls, the matching and
the solver's state, the loops' scalars) and, on a CUDA card, the CUDA
graphs captured from its steps.  A call copies its graph and state into
the buffers and replays, so every graph of the bucket shares the entry.
A ``"run_many"`` entry (:class:`~repro_torch.matching.batch.BatchProgram`)
is the same for a batch: its key's bucket shape leads with the batch size
(``TorchCSR.bucket_key``), and its bytes are those of its ``(B, n)``
buffers and captures.

``ShardedMatcher``'s entries add the mesh and axis to the entry point
(:func:`mesh_cache_key`), so another mesh size or axis name builds
another program.

The table is guarded by a reentrant lock (a serving layer hits it from
several threads).  Capacity is ``MAX_ENTRIES``, overridable with
:func:`set_max_entries`, and a byte budget, since an entry keeps its
buffers and graphs on the card between calls: the entries' bytes (static
buffers and the memory their captures reserved) may not exceed
``MAX_BYTES`` (:func:`set_max_bytes`; by default :data:`BYTES_FRACTION` of
the card's memory where there is a card, else no bound by bytes) beyond
the entry last used.  Entries leave in LRU order, and evictions are
counted in :func:`compile_cache_info`.  An evicted entry's buffers and
graphs are freed once nothing else holds it.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Hashable, Optional, Tuple

import torch

MAX_ENTRIES = 256   # parity with the JAX package's cache
MAX_BYTES: Optional[int] = None   # None: BYTES_FRACTION of the card's memory
BYTES_FRACTION = 0.125

_CACHE: Dict[Hashable, object] = {}
_HITS = 0
_MISSES = 0
_EVICTIONS = 0
_LOCK = threading.RLock()
_TLS = threading.local()      # per-thread hit/miss tallies (see below)


def _thread_counts() -> dict:
    counts = getattr(_TLS, "counts", None)
    if counts is None:
        counts = _TLS.counts = {"hits": 0, "misses": 0}
    return counts


def set_max_entries(n: int) -> int:
    """Override the cache capacity; returns the previous value.

    Shrinking below the current population evicts LRU entries immediately
    (counted as evictions).
    """
    global MAX_ENTRIES, _EVICTIONS
    assert n >= 1, f"cache capacity must be positive, got {n}"
    with _LOCK:
        old, MAX_ENTRIES = MAX_ENTRIES, int(n)
        while len(_CACHE) > MAX_ENTRIES:
            del _CACHE[next(iter(_CACHE))]
            _EVICTIONS += 1
    return old


def _entry_bytes(entry) -> int:
    nbytes = getattr(entry, "nbytes", None)
    return int(nbytes()) if callable(nbytes) else 0


def max_bytes() -> Optional[int]:
    """The byte budget in force: ``MAX_BYTES``, or by default
    :data:`BYTES_FRACTION` of card 0's memory (None on a host with no
    card: no bound by bytes)."""
    if MAX_BYTES is not None:
        return MAX_BYTES
    if not torch.cuda.is_available():
        return None
    total = torch.cuda.get_device_properties(0).total_memory
    return int(BYTES_FRACTION * total)


def set_max_bytes(n: Optional[int]) -> Optional[int]:
    """Override the byte budget (None: the default); returns the previous
    override.  A smaller budget evicts LRU entries at once."""
    global MAX_BYTES
    assert n is None or n >= 0, f"byte budget must not be negative, got {n}"
    with _LOCK:
        old, MAX_BYTES = MAX_BYTES, n
        compile_cache_fit()
    return old


def compile_cache_fit(keep: Optional[Hashable] = None) -> int:
    """Evict LRU entries, never ``keep`` (by default the most recently
    used), while the entries' bytes exceed the budget; returns the bytes
    they hold after.  ``Matcher`` calls it after every call, when its entry
    has grown."""
    global _EVICTIONS
    with _LOCK:
        if keep is None and _CACHE:
            keep = next(reversed(_CACHE))
        sizes = {k: _entry_bytes(v) for k, v in _CACHE.items()}
        total, budget = sum(sizes.values()), max_bytes()
        if budget is not None:
            for k in [k for k in _CACHE if k != keep]:
                if total <= budget:
                    break
                del _CACHE[k]
                total -= sizes[k]
                _EVICTIONS += 1
    return total


def compile_cache_key(bucket_key: Tuple, cfg, warm_start, entry: str
                      ) -> Hashable:
    """Canonical key: (bucket shape, config, warm start, entry point).

    ``cfg`` is the *canonical* MatcherConfig (``Matcher.__init__`` applies
    ``canonical()``), or None for the warm-start-only ``"init"`` entry;
    every execution-path knob lands in the key by being a field of the
    frozen dataclass.  ``bucket_key`` (``TorchCSR.bucket_key``) carries the
    CSC-mirror marker, so a mirrored graph never shares an entry with a
    bare one.  ``warm_start`` is ``(name, version)``, or ``"<resume>"``
    when the caller passes the state.
    """
    return (bucket_key, cfg, warm_start, entry)


def mesh_cache_key(mesh, axis: str) -> Tuple:
    """Hashable mesh identity for the compile cache: the mesh's axes and
    sizes, its devices (by name, so a rebuilt but identical mesh still
    hits) and the axis sharded over.  ``ShardedMatcher``'s entry is
    ``("sharded_run",) + mesh_cache_key(mesh, axis)``; a mesh over a
    world's ranks adds the world (its number in this process, the rank, the
    size and the backend: a captured collective belongs to one world)."""
    key = (tuple(mesh.shape.items()), tuple(str(d) for d in mesh.devices),
           axis)
    w = getattr(mesh, "world", None)
    if w is not None:
        key += (("world", w.ident, w.rank, w.size, w.backend),)
    return key


def get_compiled(key: Hashable, build: Callable[[], object]) -> object:
    """The program for ``key``, built on first use."""
    global _HITS, _MISSES, _EVICTIONS
    counts = _thread_counts()
    with _LOCK:
        prog = _CACHE.get(key)
        if prog is None:
            _MISSES += 1
            counts["misses"] += 1
            prog = build()
            while len(_CACHE) >= MAX_ENTRIES:        # LRU eviction
                del _CACHE[next(iter(_CACHE))]
                _EVICTIONS += 1
            _CACHE[key] = prog
        else:
            _HITS += 1
            counts["hits"] += 1
            _CACHE[key] = _CACHE.pop(key)            # move to MRU position
    return prog


def compile_cache_entry(key: Hashable):
    """The program held for ``key``, or None: a look that counts no hit and
    leaves the LRU order as it is (for measurements)."""
    with _LOCK:
        return _CACHE.get(key)


def compile_cache_thread_info() -> dict:
    """Hits/misses made by the *calling thread* (since it first touched the
    cache), so concurrent builds on other threads are never misattributed
    to it."""
    return dict(_thread_counts())


def compile_cache_info() -> dict:
    with _LOCK:
        return {"entries": len(_CACHE), "hits": _HITS, "misses": _MISSES,
                "evictions": _EVICTIONS, "max_entries": MAX_ENTRIES,
                "bytes": sum(_entry_bytes(v) for v in _CACHE.values()),
                "max_bytes": max_bytes(), "keys": tuple(_CACHE)}


def compile_cache_clear() -> None:
    global _HITS, _MISSES, _EVICTIONS
    with _LOCK:
        _CACHE.clear()
        _HITS = 0
        _MISSES = 0
        _EVICTIONS = 0
