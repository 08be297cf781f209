"""Int8 gradient compression (the JAX package's ``optim/compress.py``).

Per-tensor symmetric int8 quantization with stochastic rounding: each leaf
is scaled by ``max(max|g|, 1e-12) / 127``, a uniform draw in [-0.5, 0.5)
is added, and the sum is rounded half to even and clipped to +-127.

The JAX function draws its noise from a key split once per leaf.  Here the
noise comes from an explicit ``torch.Generator`` (one ``torch.rand`` of the
leaf's shape per leaf, in leaf order), or from ``draws``: one array of
uniforms in [0, 1) per leaf, as the caller made them (the tests pass the
JAX package's ``jax.random.uniform`` draws, and the codes then match it
bit for bit).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .adamw import _sorted_leaves


def compress_grads(grads, gen: Optional[torch.Generator] = None,
                   draws: Optional[Sequence[torch.Tensor]] = None
                   ) -> Tuple[object, List[Tuple[torch.Tensor,
                                                 torch.Tensor]]]:
    """``(structure, [(int8 codes, fp32 scale), ...])`` in the JAX
    package's leaf order (dict keys sorted); the structure is ``grads``
    itself, which :func:`decompress_grads` refills."""
    leaves = _sorted_leaves(grads)
    if (gen is None) == (draws is None):
        raise ValueError("compress_grads needs exactly one of gen= (a "
                         "torch.Generator) and draws= (one uniform array "
                         "per leaf)")
    if draws is not None and len(draws) != len(leaves):
        raise ValueError(f"{len(draws)} draws for {len(leaves)} leaves")
    out = []
    for i, g in enumerate(leaves):
        g32 = g.float()
        scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
        q = g32 / scale
        if draws is not None:
            d = draws[i]
            u = (d if isinstance(d, torch.Tensor)
                 else torch.from_numpy(np.array(d, np.float32)))
            u = u.to(device=g.device, dtype=torch.float32)
            if u.shape != g.shape:
                raise ValueError(f"draw {i} of shape {tuple(u.shape)} for "
                                 f"a leaf of shape {tuple(g.shape)}")
        else:
            u = torch.rand(g.shape, generator=gen, dtype=torch.float32,
                           device=g.device)
        q = torch.clamp(torch.round(q + (u - 0.5)), -127, 127).to(torch.int8)
        out.append((q, scale))
    return grads, out


def decompress_grads(structure, compressed, dtype=torch.float32):
    """The tree of ``q * scale`` (in fp32, then cast to ``dtype``)."""
    it = iter(compressed)

    def refill(tree):
        if isinstance(tree, dict):
            return {k: refill(tree[k]) for k in sorted(tree)}
        q, s = next(it)
        return (q.float() * s).to(dtype)

    return refill(structure)
