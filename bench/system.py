"""The system under test, reached only through its public entry points.

``repro_torch`` (the PyTorch and CUDA package under ``src/``): the host
graph container, ``TorchCSR.from_host`` and ``Matcher(config,
warm_start).run`` for single solves, and ``MatchingService`` (``submit``,
``warm_up``, the futures' ``MatchResult``) for served traffic.  A
configuration file (``bench/configs/<name>.json``) gives the solver's
``MatcherConfig`` fields and the warm start; a traffic file's ``service``
gives the service's settings.
"""
from __future__ import annotations

import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"


def port():
    """The package under test, imported from the checkout's ``src/``."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    import repro_torch
    return repro_torch


def host_graph(g):
    """The benchmark's :class:`~bench.graphs.HostGraph` as the program's
    host container, sharing its arrays."""
    port()
    from repro_torch.core.csr import BipartiteCSR
    return BipartiteCSR(nc=g.nc, nr=g.nr, nnz=g.nnz, cxadj=g.cxadj,
                        cadj=g.cadj, ecol=g.ecol)


def matcher_config(config: dict, **override):
    port()
    from repro_torch.matching import MatcherConfig
    return MatcherConfig(**{**config["solver"], **override})


def matcher(config: dict, **override):
    port()
    from repro_torch.matching import Matcher
    return Matcher(matcher_config(config, **override), config["warm_start"])


def upload(g, device):
    """``TorchCSR.from_host`` of the program's host graph ``g``."""
    from repro_torch.matching import TorchCSR
    return TorchCSR.from_host(g, device=device)


def service(config: dict, spec: dict, device, **override):
    """A ``MatchingService`` over the ladder of buckets ``spec`` declares,
    validating every graph it admits, as the service does by default.
    ``spec["cache_gib"]``, where given, is the compile cache's byte budget,
    sized so that every program the service warms stays resident."""
    port()
    from repro_torch.serving import Bucketizer, MatchingService, ladder
    if "cache_gib" in spec:
        from repro_torch.matching.cache import set_max_bytes
        set_max_bytes(int(spec["cache_gib"] * 2**30))
    buckets = ladder(max_vertices=spec["max_vertices"],
                     min_vertices=spec["min_vertices"],
                     edge_factor=spec["edge_factor"])
    return MatchingService(
        bucketizer=Bucketizer(buckets, validate=True, device=device),
        config=matcher_config(config, **override),
        warm_start=config["warm_start"], max_batch=spec["max_batch"],
        max_delay_ms=spec["max_delay_ms"])


def cache_info() -> dict:
    from repro_torch.matching import compile_cache_info
    return compile_cache_info()


def release() -> None:
    """Drop every cached program (buffers and captured graphs)."""
    from repro_torch.matching import compile_cache_clear
    compile_cache_clear()
