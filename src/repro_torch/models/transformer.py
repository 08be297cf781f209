"""Model assembly: decoder-only LM, MoE LM, SSM, hybrid, enc-dec and the
vision prefix (the JAX package's ``models/transformer.py``).

The JAX ``lax.scan`` over parameters stacked on a leading L axis becomes a
Python loop over that axis; the stacked ``(L, ...)`` layout is kept, so a
parameter tree carries across leaf for leaf.  ``build_model(cfg)`` returns
a ``Model`` with:

  init(rng, device)              -> params        (no sharding specs)
  forward(params, batch)         -> (logits, aux) (train / prefill)
  init_cache(batch, max_len)     -> cache
  prefill_encoder(params, cache, batch) -> cache  (enc-dec only)
  decode_step(params, cache, tokens, pos) -> (logits, cache)

``batch`` is a dict ``{"tokens": (B, S) int}`` plus, for the vision
prefix, ``{"frontend": (B, F, D)}`` patch embeddings and, for the
encoder-decoder, ``{"enc_frames": (B, Se, D)}``.  Blocks are ``attn``
(dense FFN), ``moe`` (:mod:`.moe`) or ``mamba`` (:mod:`.ssm`); the hybrid
runs one shared ``attn`` block under the sliding window after every
``shared_every``-th mamba block.  ``forward``'s ``aux["lb_loss"]`` is the
load-balance loss summed over the layers.

``cfg.remat`` runs each layer's body (the block, and the hybrid's shared
block after it) under ``torch.utils.checkpoint`` when autograd records
it (grad mode on, and the stack's input or a weight needing a gradient),
as the JAX package wraps the body in ``jax.checkpoint``: only the
layer inputs are kept for the backward.  ``opt_attn_layout`` routes
self-attention through ``hflat_blockwise_attn``; ``opt_kv_quant`` makes
the KV cache int8 with bf16 scales (a no-op for the SSM, which has no KV
cache; refused for the hybrid, see ``init_cache``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device

from . import attention as att
from . import mlp as mlp_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .common import ModelConfig, dense_init, rms_norm, tree_leaves, tree_map


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str,
               cross: bool = False):
    def norm():
        return torch.zeros((cfg.d_model,), dtype=torch.float32,
                           device=gen.device)

    if kind == "mamba":
        return {"ln1": norm(), "mix": ssm_mod.init_mamba(gen, cfg)}
    params = {"ln1": norm(), "ln2": norm(), "attn": att.init_attn(gen, cfg)}
    if cross:
        params["xattn"] = att.init_attn(gen, cfg)
        params["lnx"] = norm()
    ffn = moe_mod.init_moe if kind == "moe" else mlp_mod.init_mlp
    params["ffn"] = ffn(gen, cfg)
    return params


def ffn_fwd(params, h, cfg: ModelConfig, kind: str):
    """The block's feed-forward: (output, aux); aux is empty for a dense
    block."""
    if kind == "moe":
        return moe_mod.moe_ffn(params, h, cfg)
    return mlp_mod.mlp(params, h, cfg), {}


def block_fwd(params, x, pos, cfg: ModelConfig, kind: str, mask_kind: str,
              enc_out=None, enc_pos=None, prefix_len: int = 0):
    if kind == "mamba":
        h = rms_norm(x, params["ln1"], cfg.norm_eps)
        y, _ = ssm_mod.mamba_forward(params["mix"], h, cfg)
        return x + y, {}
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    x = x + att.attention(params["attn"], h, pos, cfg, mask_kind=mask_kind,
                          prefix_len=prefix_len)
    if enc_out is not None:
        h = rms_norm(x, params["lnx"], cfg.norm_eps)
        x = x + att.attention(params["xattn"], h, pos, cfg,
                              mask_kind="bidir", kv_x=enc_out,
                              kv_pos=enc_pos)
    h = rms_norm(x, params["ln2"], cfg.norm_eps)
    y, aux = ffn_fwd(params["ffn"], h, cfg, kind)
    return x + y, aux


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------
def init_embed(gen: torch.Generator, cfg: ModelConfig):
    dt = cfg.tdtype
    params = {"tok": dense_init(gen, (cfg.vocab, cfg.d_model), dt),
              "ln_f": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                  device=gen.device)}
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(gen, (cfg.d_model, cfg.vocab), dt)
    return params


def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig
                 ) -> torch.Tensor:
    return params["tok"][tokens.long()]


def vocab_padded(cfg: ModelConfig) -> int:
    """Vocab rounded up to a multiple of 128, as in the JAX package (there
    so logits shard over the model axis; kept so shapes agree).  Params
    keep the exact vocab."""
    return -(-cfg.vocab // 128) * 128


def lm_head(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    V, Vp = cfg.vocab, vocab_padded(cfg)
    if cfg.tie_embeddings:
        w = params["tok"]
        if Vp != V:
            w = torch.nn.functional.pad(w, (0, 0, 0, Vp - V))
        logits = torch.einsum("bsd,vd->bsv", x, w)
    else:
        w = params["unembed"]
        if Vp != V:
            w = torch.nn.functional.pad(w, (0, Vp - V))
        logits = torch.einsum("bsd,dv->bsv", x, w)
    if Vp != V:
        pad = torch.arange(Vp, device=x.device) >= V
        logits = torch.where(pad[None, None, :],
                             torch.tensor(-1e30, dtype=x.dtype,
                                          device=x.device), logits)
    return logits


def _layer(stacked, i: int):
    """Layer ``i`` of a tree stacked on a leading L axis (views)."""
    return tree_map(lambda t: t[i], stacked)


def _unstack(stacked, n: int) -> list:
    """The ``n`` layers of a stacked tree as views, from one ``unbind``
    per leaf: its backward stacks the layers' gradients once, where
    indexing each layer would add a zero-filled gradient of the whole
    stack per layer (L^2 traffic in training)."""
    parts = tree_map(lambda t: t.unbind(0), stacked)
    return [tree_map(lambda u: u[i], parts) for i in range(n)]


def _stack_init(gen: torch.Generator, cfg: ModelConfig, n: int, kind: str,
                cross: bool = False):
    """``n`` blocks stacked on a leading axis, filled one layer at a time:
    beside the stack, one layer and one leaf's fp32 draw are alive."""
    stacked = None
    for i in range(n):
        block = init_block(gen, cfg, kind, cross)
        if stacked is None:
            stacked = tree_map(lambda t: t.new_empty((n,) + t.shape), block)
        for dst, src in zip(tree_leaves(stacked), tree_leaves(block)):
            dst[i].copy_(src)
        del block
    return stacked


# ---------------------------------------------------------------------------
# the Model
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    # ---------------- init -------------------------------------------------
    def init(self, rng: Union[int, torch.Generator] = 0, device=None
             ) -> Dict[str, Any]:
        """Parameters drawn from ``rng`` (a seed, or a generator whose
        device is then used)."""
        if isinstance(rng, torch.Generator):
            gen = rng
        else:
            gen = torch.Generator(device=resolve_device(device))
            gen.manual_seed(int(rng))
        cfg = self.cfg
        params = {"embed": init_embed(gen, cfg),
                  "layers": _stack_init(gen, cfg, cfg.n_layers,
                                        self._block_kind(),
                                        cross=cfg.enc_layers > 0)}
        if cfg.family == "hybrid" and cfg.shared_every:
            params["shared"] = init_block(gen, cfg, "attn")
        if cfg.enc_layers:
            params["enc"] = _stack_init(gen, cfg, cfg.enc_layers, "attn")
        if cfg.frontend == "vision":
            # projection of the (stub) patch embeddings into d_model
            params["vproj"] = dense_init(gen, (cfg.d_model, cfg.d_model),
                                         cfg.tdtype)
        return params

    def _block_kind(self) -> str:
        if self.cfg.family == "moe":
            return "moe"
        if self.cfg.family in ("ssm", "hybrid"):
            return "mamba"
        return "attn"

    def _mask_kind(self) -> str:
        return {"full": "causal", "swa": "swa", "chunked": "chunked"}[
            self.cfg.attn]

    # ---------------- stacks ----------------------------------------------
    def _run_stack(self, layer_params, x, pos, kind, mask_kind, shared=None,
                   enc_out=None, enc_pos=None, prefix_len: int = 0):
        """The blocks of a stack in order (the shared block after every
        ``shared_every``-th); returns (x, the summed load-balance loss)."""
        cfg = self.cfg
        n = tree_leaves(layer_params)[0].shape[0]
        zero = torch.zeros((), dtype=torch.float32, device=x.device)

        def body(lp, x, with_shared: bool):
            x, aux = block_fwd(lp, x, pos, cfg, kind, mask_kind,
                               enc_out=enc_out, enc_pos=enc_pos,
                               prefix_len=prefix_len)
            if with_shared:
                x, _ = block_fwd(shared, x, pos, cfg, "attn", "swa")
            return x, aux.get("lb_loss", zero)

        # only where autograd records the layer: a forward under grad mode
        # over weights and inputs that need no gradient (serving) saves
        # nothing for a backward, and the checkpoint would cost it
        # nothing but its overhead
        remat = cfg.remat and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, enc_out, *tree_leaves(layer_params),
                      *(tree_leaves(shared) if shared is not None else ())))
        lbs = []
        for i, lp in enumerate(_unstack(layer_params, n)):
            args = (lp, x, shared is not None and self._shared_after(i))
            if remat:
                x, lb = checkpoint(body, *args, use_reentrant=False)
            else:
                x, lb = body(*args)
            lbs.append(lb)
        return x, torch.stack(lbs).sum()

    def _shared_after(self, i: int) -> bool:
        """Whether the hybrid's shared block runs after mamba block i."""
        every = self.cfg.shared_every
        return self.cfg.family == "hybrid" and bool(every) and \
            i % every == every - 1

    def _encode(self, params, batch):
        """The encoder stack over the frame embeddings, bidirectional, rope
        on the frame positions; its raw output (no final norm)."""
        frames = batch["enc_frames"].to(self.cfg.tdtype)
        enc_pos = torch.arange(frames.shape[1], dtype=torch.int32,
                               device=frames.device)
        enc_out, _ = self._run_stack(params["enc"], frames, enc_pos, "attn",
                                     "bidir")
        return enc_out, enc_pos

    # ---------------- forward (train / prefill) ---------------------------
    def forward(self, params, batch, last_only: bool = False
                ) -> Tuple[torch.Tensor, Dict]:
        cfg = self.cfg
        tokens = batch["tokens"]
        x = embed_tokens(params["embed"], tokens, cfg)
        prefix_len = 0
        if cfg.frontend == "vision":
            v = torch.einsum("bfd,de->bfe",
                             batch["frontend"].to(cfg.tdtype),
                             params["vproj"])
            x = torch.cat([v, x], dim=1)
            prefix_len = cfg.frontend_len
        pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        enc_out = enc_pos = None
        if cfg.enc_layers:
            enc_out, enc_pos = self._encode(params, batch)
        mask_kind = "prefix" if prefix_len else self._mask_kind()
        x, lb = self._run_stack(params["layers"], x, pos, self._block_kind(),
                                mask_kind, shared=params.get("shared"),
                                enc_out=enc_out, enc_pos=enc_pos,
                                prefix_len=prefix_len)
        if last_only:
            # serving prefill needs only the next-token logits
            return lm_head(params["embed"], x[:, -1:], cfg), {"lb_loss": lb}
        logits = lm_head(params["embed"], x, cfg)
        if cfg.frontend == "vision":
            logits = logits[:, cfg.frontend_len:]
        return logits, {"lb_loss": lb}

    # ---------------- decode ----------------------------------------------
    def init_cache(self, batch_size: int, max_len: int, enc_len: int = 0,
                   device=None) -> Dict[str, Any]:
        """The decode cache; ``pos`` is a Python int (the next position).
        SSM and hybrid: the state and convolution caches, the hybrid also
        one KV slice per shared-block invocation (``shared_kv``, one ring
        of ``min(max_len, window)`` positions); the others the KV cache
        (int8 with ``k_scale``/``v_scale`` under ``opt_kv_quant``).
        Enc-dec also ``xk``/``xv`` (L, B, enc_len, KV, hd), which
        ``prefill_encoder`` fills."""
        cfg = self.cfg
        dev = resolve_device(device)
        if cfg.opt_kv_quant and cfg.family == "hybrid":
            raise TypeError(
                f"{cfg.name}: opt_kv_quant has no int8 cache for the "
                f"hybrid's shared attention block: the JAX package's "
                f"_shared_decode writes float K/V into its int8 shared_kv "
                f"and raises TypeError on the first decode step, so there "
                f"is no reference to hold one to (ROADMAP.md, Queue 3)")
        cache: Dict[str, Any] = {"pos": 0}
        if cfg.family in ("ssm", "hybrid"):
            cache.update(ssm_mod.init_ssm_cache(cfg, cfg.n_layers,
                                                batch_size, device=dev))
            if cfg.family == "hybrid" and cfg.shared_every:
                # each invocation sees other activations: its own slice
                n_inv = cfg.n_layers // cfg.shared_every
                cache["shared_kv"] = att.init_kv_cache(
                    cfg, n_inv, batch_size, min(max_len, cfg.window),
                    device=dev)
        else:
            cache.update(att.init_kv_cache(cfg, cfg.n_layers, batch_size,
                                           max_len, device=dev))
        if cfg.enc_layers:
            shape = (cfg.n_layers, batch_size, enc_len, cfg.n_kv_heads,
                     cfg.hd)
            cache["xk"] = torch.zeros(shape, dtype=cfg.tdtype, device=dev)
            cache["xv"] = torch.zeros_like(cache["xk"])
        return cache

    def prefill_encoder(self, params, cache, batch):
        """Enc-dec: run the encoder and fill the cross-attention K/V cache
        of every decoder layer from its raw output."""
        enc_out, _ = self._encode(params, batch)
        layers = params["layers"]
        xk, xv = [], []
        for i in range(self.cfg.n_layers):
            xp = _layer(layers, i)["xattn"]
            xk.append(torch.einsum("bsd,dhk->bshk", enc_out, xp["wk"]))
            xv.append(torch.einsum("bsd,dhk->bshk", enc_out, xp["wv"]))
        return dict(cache, xk=torch.stack(xk), xv=torch.stack(xv))

    def decode_step(self, params, cache, tokens, pos):
        """tokens: (B, 1); pos: the position (int, or a 0-d tensor, read
        once), the same across the batch.  Writes this token's state (K/V
        slot, SSM state and convolution window) into the cache tensors in
        place and returns the cache with ``pos + 1``."""
        cfg = self.cfg
        pos = int(pos)
        x = embed_tokens(params["embed"], tokens, cfg)
        layers = params["layers"]
        kind = self._block_kind()
        quant = "k_scale" in cache
        for i in range(cfg.n_layers):
            lp = _layer(layers, i)
            if kind != "mamba":
                cross = ((cache["xk"][i], cache["xv"][i]) if cfg.enc_layers
                         else (None, None))
                scales = ((cache["k_scale"][i], cache["v_scale"][i])
                          if quant else (None, None))
                x = self._block_decode(lp, x, cache["k"][i], cache["v"][i],
                                       cache["idx"], pos, kind, *cross,
                                       *scales)
                continue
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            y, h_new, conv = ssm_mod.mamba_decode_step(
                lp["mix"], h, cache["h"][i], cache["conv"][i], cfg)
            cache["h"][i].copy_(h_new)
            cache["conv"][i].copy_(conv)
            x = x + y
            if self._shared_after(i):
                # invocation i // shared_every's KV slice; the slices share
                # one ``idx``
                kv, inv = cache["shared_kv"], i // cfg.shared_every
                x = self._block_decode(params["shared"], x, kv["k"][inv],
                                       kv["v"][inv], kv["idx"], pos, "attn")
        logits = lm_head(params["embed"], x, cfg)
        return logits, dict(cache, pos=pos + 1)

    def _block_decode(self, lp, x, cache_k, cache_v, cache_idx, pos: int,
                      kind: str, xk=None, xv=None, k_scale=None,
                      v_scale=None):
        """One attention block in decode: this token's K/V written into
        the cache slice in place (with its scales, for an int8 cache),
        attention over it, the cross-attention over the encoder's
        ``xk``/``xv`` when given, the feed-forward."""
        cfg = self.cfg
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        att.update_cache(lp["attn"], h, cache_k, cache_v, cache_idx, pos,
                         cfg, k_scale, v_scale)
        x = x + att.decode_attention(lp["attn"], h, cache_k, cache_v,
                                     cache_idx, pos, cfg, k_scale, v_scale)
        if xk is not None:
            h = rms_norm(x, lp["lnx"], cfg.norm_eps)
            x = x + self._cross_decode(lp["xattn"], h, xk, xv)
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        y, _ = ffn_fwd(lp["ffn"], h, cfg, kind)
        return x + y

    def _cross_decode(self, p, x, xk, xv):
        """One token's cross-attention over the encoder's K/V (no rope, no
        mask)."""
        cfg = self.cfg
        B = x.shape[0]
        q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
        H, hd = cfg.n_heads, cfg.hd
        KV = xk.shape[2]
        qg = q.reshape(B, KV, H // KV, hd)
        s = torch.einsum("bkgh,btkh->bkgt", qg, xk).float() * hd ** -0.5
        pr = torch.softmax(s, dim=-1).to(x.dtype)
        out = torch.einsum("bkgt,btkh->bkgh", pr, xv).reshape(B, 1, H, hd)
        return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
