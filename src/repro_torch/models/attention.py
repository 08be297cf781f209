"""GQA attention: full / sliding-window / chunked / prefix masks, KV-cache
decode, and a memory-safe blockwise (flash-style) path (the JAX package's
``models/attention.py``).

Shapes: x (B, S, D); q (B, S, H, hd); k/v (B, S, KV, hd); GQA groups
H//KV.  ``attention`` dispatches as the JAX function does: the flash
kernel (``attn_impl="pallas"``, self-attention, causal or full mask) ->
``blockwise_attn`` above 2048 positions -> ``_plain_attn``.  With
``kv_x`` it is cross-attention (the enc-dec family): K and V from
``kv_x``, no rope, the full mask over ``kv_pos``, never the flash kernel.

Not ported yet: the H-flat layout ``hflat_blockwise_attn``
(``opt_attn_layout``, a sharding layout) and the int8 KV cache
(``opt_kv_quant``), ROADMAP.md, Queue 1, item 8; ``build_model`` refuses
configs that set either knob.

The KV cache is updated in place (``update_cache`` writes this token's
slot into the tensors it is given), where the JAX function returns new
arrays: a decode step then moves one slot, not the whole cache.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import flash_attention

from .common import ModelConfig, dense_init, rope

NEG_INF = -1e30


def init_attn(gen: torch.Generator, cfg: ModelConfig):
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = cfg.tdtype
    return {"wq": dense_init(gen, (D, H, hd), dt),
            "wk": dense_init(gen, (D, KV, hd), dt),
            "wv": dense_init(gen, (D, KV, hd), dt),
            "wo": dense_init(gen, (H, hd, D), dt)}


def _mask_fn(kind: str, window: int, prefix_len: int):
    """Returns mask(qpos, kpos) -> bool (True = attend)."""
    def mask(qpos, kpos):
        causal = kpos[None, :] <= qpos[:, None]
        if kind == "bidir":
            return torch.ones((qpos.shape[0], kpos.shape[0]),
                              dtype=torch.bool, device=qpos.device)
        if kind == "causal":
            return causal
        if kind == "swa":
            return causal & (qpos[:, None] - kpos[None, :] < window)
        if kind == "chunked":
            return causal & (qpos[:, None] // window
                             == kpos[None, :] // window)
        if kind == "prefix":
            bidir = (qpos[:, None] < prefix_len) & (kpos[None, :] < prefix_len)
            return causal | bidir
        raise ValueError(kind)
    return mask


def _plain_attn(q, k, v, qpos, kpos, mask_kind, window, prefix_len):
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k).float()
    scores = scores * hd ** -0.5
    m = _mask_fn(mask_kind, window, prefix_len)(qpos, kpos)
    scores = torch.where(m[None, None, None], scores,
                         scores.new_tensor(NEG_INF))
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", p, v)
    return out.reshape(B, S, H, hd)


def blockwise_attn(q, k, v, qpos, kpos, mask_kind, window, prefix_len,
                   q_block: int = 1024, kv_block: int = 1024):
    """Online-softmax attention, O(S*B) memory: a loop over KV blocks per Q
    block (the JAX function's two scans), no causal skip, the accumulator
    in q's dtype."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    Skv = k.shape[1]
    q_block = min(q_block, S)
    kv_block = min(kv_block, Skv)
    if S % q_block or Skv % kv_block:
        raise ValueError(f"blockwise_attn: S={S} and Skv={Skv} must divide "
                         f"into q_block={q_block} and kv_block={kv_block}")
    nq, nk = S // q_block, Skv // kv_block
    mask = _mask_fn(mask_kind, window, prefix_len)
    scale = hd ** -0.5
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=q.device)

    outs = []
    for i in range(nq):
        qs = slice(i * q_block, (i + 1) * q_block)
        qblk = q[:, qs].reshape(B, q_block, KV, G, hd)
        m_run = torch.full((B, KV, G, q_block), NEG_INF, dtype=torch.float32,
                           device=q.device)
        l_run = torch.zeros((B, KV, G, q_block), dtype=torch.float32,
                            device=q.device)
        acc = torch.zeros((B, KV, G, q_block, hd), dtype=q.dtype,
                          device=q.device)
        for j in range(nk):
            ks = slice(j * kv_block, (j + 1) * kv_block)
            s = torch.einsum("bqkgh,btkh->bkgqt", qblk, k[:, ks])
            s = (s * scale).float()
            mm = mask(qpos[qs], kpos[ks])[None, None, None]
            s = torch.where(mm, s, neg)
            m_new = torch.maximum(m_run, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(-1)
            pv = torch.einsum("bkgqt,btkh->bkgqh", p.to(q.dtype), v[:, ks])
            acc = acc * corr[..., None].to(acc.dtype) + pv
            m_run = m_new
        out = acc / torch.clamp(l_run, min=1e-30)[..., None].to(acc.dtype)
        outs.append(out.permute(0, 3, 1, 2, 4))          # (B,q,KV,G,hd)
    return torch.cat(outs, dim=1).reshape(B, S, H, hd)


def attention(params, x, pos, cfg: ModelConfig, *, mask_kind: str,
              kv_x: Optional[torch.Tensor] = None,
              kv_pos: Optional[torch.Tensor] = None,
              prefix_len: int = 0):
    """Full-sequence attention (training / prefill); ``kv_x`` switches to
    cross-attention (keys and values from the encoder output)."""
    B, S, D = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    src = x if kv_x is None else kv_x
    k = torch.einsum("bsd,dhk->bshk", src, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", src, params["wv"])
    if kv_x is None:
        q, k = rope(q, k, pos, cfg.rope_theta)
        kpos = pos
    else:
        kpos = kv_pos
        mask_kind = "bidir"
    if cfg.attn_impl == "pallas" and kv_x is None and \
            mask_kind in ("causal", "bidir"):
        out = flash_attention(q, k, v, causal=(mask_kind == "causal"))
    elif S > 2048 or k.shape[1] > 2048:
        out = blockwise_attn(q, k, v, pos, kpos, mask_kind, cfg.window,
                             prefix_len)
    else:
        out = _plain_attn(q, k, v, pos, kpos, mask_kind, cfg.window,
                          prefix_len)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"])


# ---------------------------------------------------------------------------
# KV-cache decode
# ---------------------------------------------------------------------------
def init_kv_cache(cfg: ModelConfig, n_layers: int, batch: int, max_len: int,
                  dtype: Optional[torch.dtype] = None, *, device):
    """Ring-buffer KV cache. For swa/chunked archs max_len = window size."""
    dtype = dtype or cfg.tdtype
    KV, hd = cfg.n_kv_heads, cfg.hd
    cache_len = min(max_len, cfg.window) if cfg.attn in ("swa", "chunked") \
        else max_len
    shape = (n_layers, batch, cache_len, KV, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "idx": torch.full((cache_len,), -1, dtype=torch.int32,
                              device=device)}        # absolute positions


def decode_attention(params, x, cache_k, cache_v, cache_idx, pos: int,
                     cfg: ModelConfig):
    """One-token attention against the cache (already holding this token's
    k/v, written by the caller via ``update_cache``).  Rotates q only."""
    B = x.shape[0]
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])    # (B,1,H,hd)
    posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, _ = rope(q, q, posv, cfg.rope_theta)
    k, v = cache_k, cache_v                              # (B,Sc,KV,hd)
    valid = (cache_idx >= 0) & (cache_idx <= pos)
    if cfg.attn == "swa":
        valid &= pos - cache_idx < cfg.window
    elif cfg.attn == "chunked":
        valid &= cache_idx // cfg.window == pos // cfg.window
    H, hd = q.shape[2], q.shape[3]
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, hd)
    s = torch.einsum("bkgh,btkh->bkgt", qg, k).float() * hd ** -0.5
    s = torch.where(valid[None, None, None], s, s.new_tensor(NEG_INF))
    p = torch.softmax(s, dim=-1).to(x.dtype)
    out = torch.einsum("bkgt,btkh->bkgh", p, v).reshape(B, 1, H, hd)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"])


def update_cache(params, x, cache_k, cache_v, cache_idx, pos: int,
                 cfg: ModelConfig):
    """Write this token's k/v into the ring buffer, in place; returns the
    same (cache_k, cache_v, cache_idx)."""
    B = x.shape[0]
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])    # (B,1,KV,hd)
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    _, k = rope(k, k, posv, cfg.rope_theta)
    slot = pos % cache_k.shape[1]
    cache_k[:, slot:slot + 1] = k
    cache_v[:, slot:slot + 1] = v
    cache_idx[slot] = pos
    return cache_k, cache_v, cache_idx
