"""Numpy-in, numpy-out wrapper over the device-resident matcher."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.matching.api import Matcher
from repro_torch.matching.config import MatcherConfig, VARIANTS    # noqa: F401
from repro_torch.matching.device_csr import TorchCSR
from repro_torch.matching.state import MatchState

from .csr import BipartiteCSR


def maximum_matching(
    g: BipartiteCSR,
    cfg: MatcherConfig = MatcherConfig(),
    cmatch0: Optional[np.ndarray] = None,
    rmatch0: Optional[np.ndarray] = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, dict]:
    """Run one of the paper's matcher variants to a maximum matching.

    Returns (cmatch, rmatch, stats) as numpy arrays of true (unpadded) size.
    Uploads once to ``device`` (the CUDA card by default), runs
    :meth:`Matcher.run`, downloads once.
    """
    graph = TorchCSR.from_host(g, device=device)
    state = None
    if cmatch0 is not None:
        state = MatchState.from_host(np.asarray(cmatch0, np.int32),
                                     np.asarray(rmatch0, np.int32),
                                     device=graph.device)
    out = Matcher(cfg).run(graph, state)
    cmatch, rmatch = out.to_host()
    stats = {"phases": int(out.phases), "fallbacks": int(out.fallbacks),
             "cardinality": int((cmatch >= 0).sum()),
             "certified": bool(out.certified), "variant": cfg.name}
    return cmatch, rmatch, stats
