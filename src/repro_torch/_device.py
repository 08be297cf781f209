"""The one rule for where this package runs.

Entry points run on the CUDA card unless the caller names another device.
With no card and no explicit device they raise: a caller who wants the CPU
(the tests, a laptop) says ``device="cpu"``, and nothing falls back to it
quietly.

It also holds the one lock between uploads and CUDA-graph captures
(:data:`DEVICE_LOCK`).
"""
from __future__ import annotations

import threading

import torch

# Held while a CUDA graph is captured (matching/device_loop.py) and while a
# graph is uploaded (TorchCSR.from_host, TorchCSR.with_csc), so that an
# upload on one thread (a serving submit) never runs inside a capture on
# another (a cold flush).  Reentrant: a capture may upload.
DEVICE_LOCK = threading.RLock()


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; anything else is taken as given."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")
