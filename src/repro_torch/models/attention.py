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
Over a world's model axis (``par``, a :class:`~.common.Par`) the weights
given are this rank's: ``wq``, ``wk``, ``wv`` cut by heads (column
parallel), ``wo`` by heads (row parallel: the output is this rank's part
of the sum, which the block reduces).  A rank holds a block of
``ceil(H / M)`` query heads, the last block short or empty, and the K/V
heads they read (:meth:`~.common.Par.kv_range`): its cut of them, or,
where the K/V weights are replicated (``M`` does not divide
``n_kv_heads``), the ones its heads read, sliced from the whole weights
(:func:`kv_weights`).  Where those heads read them in equal contiguous
groups, GQA runs on them as it runs on all heads; where a block straddles
groups unevenly (deepseek-coder-33b's 56 heads in groups of 7 over 3
ranks), the K/V heads are expanded to one a query head on read
(:func:`kv_index`, :func:`per_head`; the cache keeps the rank's distinct
K/V heads).  Every attention function then runs on the local heads as it
runs on all of them, K4 included.  A rank with no heads skips the
attention: its part of ``wo``'s product is zero (still a tensor of the
autograd graph, so its backward joins the block's collectives).
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

from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import flash_attention

from .common import ModelConfig, dense_init, rope

NEG_INF = -1e30


def kv_weights(params, cfg: ModelConfig, par=None):
    """``(wk, wv)`` of this rank's K/V heads: the weights as given, or,
    where they are replicated over the model axis, the heads this rank's
    query heads read."""
    wk, wv = params["wk"], params["wv"]
    if par is not None and par.kv_replicated(cfg):
        lo, hi = par.kv_range(cfg)
        wk, wv = wk[:, lo:hi], wv[:, lo:hi]
    return wk, wv


def kv_index(cfg: ModelConfig, par=None) -> Optional[Tuple[int, ...]]:
    """The local K/V head each of this rank's query heads reads, where its
    heads do not read its K/V heads in equal contiguous groups (a block
    straddling groups unevenly); None where they do (or on one device,
    or with no heads)."""
    if par is None:
        return None
    lo, hi = par.head_range(cfg)
    klo, khi = par.kv_range(cfg)
    h, n = hi - lo, khi - klo
    if h == 0:
        return None
    g = cfg.n_heads // cfg.n_kv_heads
    idx = tuple(x // g - klo for x in range(lo, hi))
    if h % n == 0 and idx == tuple(i // (h // n) for i in range(h)):
        return None
    return idx


def per_head(t: torch.Tensor, idx) -> torch.Tensor:
    """K or V ``(B, T, KV_local, hd)`` with one head a query head where
    ``idx`` (:func:`kv_index`) is given, else as it is."""
    if idx is None:
        return t
    return t.index_select(2, torch.tensor(idx, device=t.device))


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
              prefix_len: int = 0, par=None):
    """Full-sequence attention (training / prefill); ``kv_x`` switches to
    cross-attention (keys and values from the encoder output).  With
    ``par``: this rank's heads, its part of the output (module doc)."""
    B, S, D = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    if q.shape[2] == 0:                  # a rank with no heads
        return torch.einsum("bshk,hkd->bsd", q, params["wo"])
    src = x if kv_x is None else kv_x
    wk, wv = kv_weights(params, cfg, par)
    idx = kv_index(cfg, par)
    k = per_head(torch.einsum("bsd,dhk->bshk", src, wk), idx)
    v = per_head(torch.einsum("bsd,dhk->bshk", src, wv), idx)
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
                  dtype: Optional[torch.dtype] = None, *, device, par=None):
    """Ring-buffer KV cache. For swa/chunked archs max_len = window size.
    With ``par``: this rank's K/V heads (:meth:`~.common.Par.kv_range`).

    ``opt_kv_quant``: int8 ``k``/``v`` and bf16 ``k_scale``/``v_scale`` of
    shape (L, B, Sc, KV), one scale per (position, K/V head): half the
    bytes a decode step reads from the cache."""
    dtype = dtype or cfg.tdtype
    KV, hd = cfg.n_kv_heads, cfg.hd
    if par is not None:
        lo, hi = par.kv_range(cfg)
        KV = hi - lo
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
                     cfg: ModelConfig, k_scale=None, v_scale=None, par=None):
    """One-token attention against the cache (already holding this token's
    k/v, written by the caller via ``update_cache``).  Rotates q only.  An
    int8 cache is dequantised in ``cfg.tdtype`` with its bf16 scales.
    ``par``: this rank's heads over the cache's K/V heads (module doc)."""
    B = x.shape[0]
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])    # (B,1,H,hd)
    if q.shape[2] == 0:                  # a rank with no heads
        return torch.einsum("bshk,hkd->bsd", q, params["wo"])
    if k_scale is not None:                               # int8 cache
        cache_k = cache_k.to(cfg.tdtype) * k_scale[..., None]
        cache_v = cache_v.to(cfg.tdtype) * v_scale[..., None]
    posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, _ = rope(q, q, posv, cfg.rope_theta)
    idx = kv_index(cfg, par)
    k, v = per_head(cache_k, idx), per_head(cache_v, idx)  # (B,Sc,KV,hd)
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
                 cfg: ModelConfig, k_scale=None, v_scale=None, par=None):
    """Write this token's k/v into the ring buffer, in place; returns the
    same (cache_k, cache_v, cache_idx), and the scales after them when
    given.  With ``k_scale``/``v_scale`` (an int8 cache) the slot holds the
    int8 codes and the scales rounded to bf16."""
    B = x.shape[0]
    wk, wv = kv_weights(params, cfg, par)
    k = torch.einsum("bsd,dhk->bshk", x, wk)              # (B,1,KV,hd)
    v = torch.einsum("bsd,dhk->bshk", x, wv)
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
