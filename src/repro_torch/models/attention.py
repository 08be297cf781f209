"""GQA attention: full / sliding-window / chunked / prefix masks, KV-cache
decode, and a memory-safe blockwise (flash-style) path (the JAX package's
``models/attention.py``).

Shapes: x (B, S, D); q (B, S, H, hd); k/v (B, S, KV, hd); GQA groups
H//KV.  ``attention`` dispatches as the JAX function does: the flash
kernel (``attn_impl="pallas"``, self-attention, causal or full mask) ->
``hflat_blockwise_attn`` (``opt_attn_layout``, self-attention) ->
``blockwise_attn`` above 2048 positions -> ``_plain_attn``.  With
``kv_x`` it is cross-attention (the enc-dec family): K and V from
``kv_x``, no rope, the full mask over ``kv_pos``, never the flash kernel.
The flash kernel has no backward, in either package: under autograd
``attention`` refuses ``attn_impl="pallas"`` (ROADMAP.md, Queue 1, item
12) rather than train through other ops.

The KV cache is updated in place (``update_cache`` writes this token's
slot into the tensors it is given), where the JAX function returns new
arrays: a decode step then moves one slot, not the whole cache.  With
``opt_kv_quant`` it stores int8 K/V and a bf16 scale per (position, K/V
head).
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


def hflat_blockwise_attn(q, k, v, qpos, kpos, mask_kind, window, prefix_len,
                         q_block: int = 1024, kv_block: int = 1024):
    """``blockwise_attn`` in the H-flat layout (``opt_attn_layout``): the
    K/V heads broadcast to all H query heads, so every tensor carries one
    head axis (B, H, ., hd).  In the JAX package the layout is there so H
    shards over the model axis (its ``constrain`` calls are sharding hints,
    the identity on one card); the arithmetic is ``blockwise_attn``'s in
    another loop order."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    Skv = k.shape[1]
    q_block = min(q_block, S)
    kv_block = min(kv_block, Skv)
    if S % q_block or Skv % kv_block:
        raise ValueError(f"hflat_blockwise_attn: S={S} and Skv={Skv} must "
                         f"divide into q_block={q_block} and "
                         f"kv_block={kv_block}")
    nq, nk = S // q_block, Skv // kv_block
    mask = _mask_fn(mask_kind, window, prefix_len)
    scale = hd ** -0.5
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=q.device)

    qh = q.transpose(1, 2)                               # (B,H,S,hd)
    kh = k.transpose(1, 2)[:, :, None].expand(B, KV, G, Skv, hd) \
        .reshape(B, H, Skv, hd)
    vh = v.transpose(1, 2)[:, :, None].expand(B, KV, G, Skv, hd) \
        .reshape(B, H, Skv, hd)
    outs = []
    for i in range(nq):
        qs = slice(i * q_block, (i + 1) * q_block)
        qblk = qh[:, :, qs]
        m_run = torch.full((B, H, q_block), NEG_INF, dtype=torch.float32,
                           device=q.device)
        l_run = torch.zeros((B, H, q_block), dtype=torch.float32,
                            device=q.device)
        acc = torch.zeros((B, H, q_block, hd), dtype=q.dtype,
                          device=q.device)
        for j in range(nk):
            ks = slice(j * kv_block, (j + 1) * kv_block)
            s = torch.einsum("bhqd,bhtd->bhqt", qblk, kh[:, :, ks])
            s = (s * scale).float()
            mm = mask(qpos[qs], kpos[ks])[None, None]
            s = torch.where(mm, s, neg)
            m_new = torch.maximum(m_run, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(-1)
            pv = torch.einsum("bhqt,bhtd->bhqd", p.to(q.dtype), vh[:, :, ks])
            acc = acc * corr[..., None].to(acc.dtype) + pv
            m_run = m_new
        outs.append(acc / torch.clamp(l_run, min=1e-30)[..., None]
                    .to(acc.dtype))
    return torch.cat(outs, dim=2).transpose(1, 2)        # (B,S,H,hd)


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
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            raise NotImplementedError(
                f"{cfg.name}: attn_impl='pallas' cannot be differentiated: "
                f"the flash kernel has no backward (neither has the JAX "
                f"package's, whose jax.grad fails on it); train with "
                f"attn_impl='xla' (ROADMAP.md, Queue 1, item 12)")
        out = flash_attention(q, k, v, causal=(mask_kind == "causal"))
    elif cfg.opt_attn_layout and kv_x is None:
        out = hflat_blockwise_attn(q, k, v, pos, kpos, mask_kind, cfg.window,
                                   prefix_len)
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
    """Ring-buffer KV cache. For swa/chunked archs max_len = window size.

    ``opt_kv_quant``: int8 ``k``/``v`` and bf16 ``k_scale``/``v_scale`` of
    shape (L, B, Sc, KV), one scale per (position, K/V head): half the
    bytes a decode step reads from the cache."""
    dtype = dtype or cfg.tdtype
    KV, hd = cfg.n_kv_heads, cfg.hd
    cache_len = min(max_len, cfg.window) if cfg.attn in ("swa", "chunked") \
        else max_len
    shape = (n_layers, batch, cache_len, KV, hd)
    store = torch.int8 if cfg.opt_kv_quant else dtype
    cache = {"k": torch.zeros(shape, dtype=store, device=device),
             "v": torch.zeros(shape, dtype=store, device=device),
             "idx": torch.full((cache_len,), -1, dtype=torch.int32,
                               device=device)}       # absolute positions
    if cfg.opt_kv_quant:
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                      device=device)
    return cache


def decode_attention(params, x, cache_k, cache_v, cache_idx, pos: int,
                     cfg: ModelConfig, k_scale=None, v_scale=None):
    """One-token attention against the cache (already holding this token's
    k/v, written by the caller via ``update_cache``).  Rotates q only.  An
    int8 cache is dequantised in ``cfg.tdtype`` with its bf16 scales."""
    B = x.shape[0]
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])    # (B,1,H,hd)
    if k_scale is not None:                               # int8 cache
        cache_k = cache_k.to(cfg.tdtype) * k_scale[..., None]
        cache_v = cache_v.to(cfg.tdtype) * v_scale[..., None]
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


def _quantize(x: torch.Tensor):
    """int8 codes and the unrounded scale ``max|x| / 127`` over the head
    dim: ``x / max(scale, 1e-8)`` rounded half to even, clipped to
    +-127."""
    scale = x.abs().amax(-1) / 127.0
    codes = torch.round(x / torch.clamp(scale[..., None], min=1e-8))
    return torch.clamp(codes, -127, 127).to(torch.int8), scale


def update_cache(params, x, cache_k, cache_v, cache_idx, pos: int,
                 cfg: ModelConfig, k_scale=None, v_scale=None):
    """Write this token's k/v into the ring buffer, in place; returns the
    same (cache_k, cache_v, cache_idx), and the scales after them when
    given.  With ``k_scale``/``v_scale`` (an int8 cache) the slot holds the
    int8 codes and the scales rounded to bf16."""
    B = x.shape[0]
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])    # (B,1,KV,hd)
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    _, k = rope(k, k, posv, cfg.rope_theta)
    slot = pos % cache_k.shape[1]
    if k_scale is not None:
        k, ks = _quantize(k)
        v, vs = _quantize(v)
        k_scale[:, slot:slot + 1] = ks
        v_scale[:, slot:slot + 1] = vs
    cache_k[:, slot:slot + 1] = k
    cache_v[:, slot:slot + 1] = v
    cache_idx[slot] = pos
    if k_scale is not None:
        return cache_k, cache_v, cache_idx, k_scale, v_scale
    return cache_k, cache_v, cache_idx
