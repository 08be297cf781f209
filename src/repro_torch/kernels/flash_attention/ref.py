"""The plain PyTorch version of the flash-attention kernel (GQA,
causal/full): the JAX package's ``flash_attention_ref`` in torch ops."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q: (B,S,H,hd); k/v: (B,Sk,KV,hd) with H % KV == 0.  Scores and the
    softmax in fp32; ``p`` is cast to q's dtype before the PV product."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qg, k).float()
    s = s * hd ** -0.5
    if causal:
        mask = torch.ones(S, k.shape[1], dtype=torch.bool,
                          device=q.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", p, v)
    return out.reshape(B, S, H, hd)
