"""Production mesh definitions (the JAX package's ``launch/mesh.py``).

Functions, not module constants, and none of them touches device state:
the mesh is a shape, the world that takes it is made by
:mod:`repro_torch.distributed` (for the dry run, by
:func:`repro_torch.distributed.world.init_dry_world`).  One pod is 16 x
16 (256 ranks); two pods add a leading ``pod`` axis in the reference (2 x
16 x 16, 512 ranks).  A port's world has two axes, ``data`` and
``model``, so the ``pod`` axis is folded into ``data``, as the
reference's :func:`logical_rules` folds it for every spec: ``(32, 16)``.
"""
from __future__ import annotations

from typing import Dict, Tuple


def production_mesh(multi_pod: bool = False) -> Tuple[int, int]:
    """``(D, M)`` of the production mesh: ``(16, 16)``, or ``(32, 16)``
    for two pods (the ``pod`` axis folded into ``data``)."""
    return (32, 16) if multi_pod else (16, 16)


def mesh_name(multi_pod: bool) -> str:
    """The reference's name of the mesh: ``16x16`` or ``2x16x16``."""
    return "2x16x16" if multi_pod else "16x16"


def logical_rules(multi_pod: bool) -> Dict[str, Tuple[str, ...]]:
    """The reference's logical axes in terms of its mesh axes."""
    return {"data": ("pod", "data") if multi_pod else ("data",),
            "model": ("model",)}


def data_axis_size(mesh: Tuple[int, int]) -> int:
    """The data axis's ranks of a mesh ``(D, M)`` (the pods' included)."""
    return mesh[0]
