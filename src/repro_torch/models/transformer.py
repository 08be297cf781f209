"""Model assembly for the decoder-only LM (the JAX package's
``models/transformer.py``, ``attn`` block kind).

The JAX ``lax.scan`` over parameters stacked on a leading L axis becomes a
Python loop over that axis; the stacked ``(L, ...)`` layout is kept, so a
parameter tree carries across leaf for leaf.  ``build_model(cfg)`` returns
a ``Model`` with:

  init(rng, device)              -> params        (no sharding specs)
  forward(params, batch)         -> (logits, aux) (train / prefill)
  init_cache(batch, max_len)     -> cache
  decode_step(params, cache, tokens, pos) -> (logits, cache)

``batch`` is a dict ``{"tokens": (B, S) int}``.  Blocks are ``attn``
(dense FFN) or, for the MoE family, ``moe`` (:mod:`.moe`); ``forward``'s
``aux["lb_loss"]`` is the load-balance loss summed over the layers.  Not
ported yet: the SSM and hybrid families, the encoder-decoder and the
vision prefix, and the ``opt_attn_layout`` and ``opt_kv_quant`` knobs
(ROADMAP.md, Queue 1, item 7); ``build_model`` refuses a config that needs
any.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple, Union

import torch

from repro_torch._device import resolve_device

from . import attention as att
from . import mlp as mlp_mod
from . import moe as moe_mod
from .common import ModelConfig, dense_init, rms_norm, tree_leaves, tree_map

_ROADMAP = "ROADMAP.md, Queue 1, item 7"


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str):
    dev = gen.device
    ffn = moe_mod.init_moe if kind == "moe" else mlp_mod.init_mlp
    return {"ln1": torch.zeros((cfg.d_model,), dtype=torch.float32,
                               device=dev),
            "ln2": torch.zeros((cfg.d_model,), dtype=torch.float32,
                               device=dev),
            "attn": att.init_attn(gen, cfg),
            "ffn": ffn(gen, cfg)}


def ffn_fwd(params, h, cfg: ModelConfig, kind: str):
    """The block's feed-forward: (output, aux); aux is empty for a dense
    block."""
    if kind == "moe":
        return moe_mod.moe_ffn(params, h, cfg)
    return mlp_mod.mlp(params, h, cfg), {}


def block_fwd(params, x, pos, cfg: ModelConfig, kind: str, mask_kind: str,
              prefix_len: int = 0):
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    x = x + att.attention(params["attn"], h, pos, cfg, mask_kind=mask_kind,
                          prefix_len=prefix_len)
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


# ---------------------------------------------------------------------------
# the Model
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        cfg = self.cfg
        missing = []
        if cfg.family in ("ssm", "hybrid"):
            missing.append(f"the {cfg.family} family")
        if cfg.enc_layers:
            missing.append("the encoder-decoder")
        if cfg.frontend:
            missing.append(f"the {cfg.frontend} frontend")
        if cfg.opt_attn_layout:
            missing.append("opt_attn_layout (hflat_blockwise_attn)")
        if cfg.opt_kv_quant:
            missing.append("opt_kv_quant (the int8 KV cache)")
        if missing:
            raise NotImplementedError(
                f"{cfg.name}: {', '.join(missing)} not ported yet "
                f"({_ROADMAP})")

    # ---------------- init -------------------------------------------------
    def init(self, rng: Union[int, torch.Generator] = 0, device=None
             ) -> Dict[str, Any]:
        """Parameters drawn from ``rng`` (a seed, or a generator whose
        device is then used).  The stacked (L, ...) tensors are filled one
        layer at a time: beside the stack, one layer and one leaf's fp32
        draw are alive at a time."""
        if isinstance(rng, torch.Generator):
            gen = rng
        else:
            gen = torch.Generator(device=resolve_device(device))
            gen.manual_seed(int(rng))
        cfg = self.cfg
        params = {"embed": init_embed(gen, cfg)}
        layers = None
        for i in range(cfg.n_layers):
            block = init_block(gen, cfg, self._block_kind())
            if layers is None:
                layers = tree_map(
                    lambda t: t.new_empty((cfg.n_layers,) + t.shape), block)
            for dst, src in zip(tree_leaves(layers), tree_leaves(block)):
                dst[i].copy_(src)
            del block
        params["layers"] = layers
        return params

    def _block_kind(self) -> str:
        return "moe" if self.cfg.family == "moe" else "attn"

    def _mask_kind(self) -> str:
        return {"full": "causal", "swa": "swa", "chunked": "chunked"}[
            self.cfg.attn]

    # ---------------- forward (train / prefill) ---------------------------
    def forward(self, params, batch, last_only: bool = False
                ) -> Tuple[torch.Tensor, Dict]:
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = embed_tokens(params["embed"], tokens, cfg)
        pos = torch.arange(S, dtype=torch.int32, device=x.device)
        mask_kind, kind = self._mask_kind(), self._block_kind()
        layers = params["layers"]
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        lbs = []
        for i in range(cfg.n_layers):
            x, aux = block_fwd(_layer(layers, i), x, pos, cfg, kind,
                               mask_kind)
            lbs.append(aux.get("lb_loss", zero))
        lb = torch.stack(lbs).sum()
        if last_only:
            # serving prefill needs only the next-token logits
            return lm_head(params["embed"], x[:, -1:], cfg), {"lb_loss": lb}
        return lm_head(params["embed"], x, cfg), {"lb_loss": lb}

    # ---------------- decode ----------------------------------------------
    def init_cache(self, batch_size: int, max_len: int, enc_len: int = 0,
                   device=None) -> Dict[str, Any]:
        """The KV cache; ``pos`` is a Python int (the next position)."""
        cache: Dict[str, Any] = {"pos": 0}
        cache.update(att.init_kv_cache(self.cfg, self.cfg.n_layers,
                                       batch_size, max_len,
                                       device=resolve_device(device)))
        return cache

    def decode_step(self, params, cache, tokens, pos):
        """tokens: (B, 1); pos: the position (int, or a 0-d tensor, read
        once), the same across the batch.  Writes this token's K/V into the
        cache tensors in place and returns the cache with ``pos + 1``."""
        cfg = self.cfg
        pos = int(pos)
        x = embed_tokens(params["embed"], tokens, cfg)
        layers = params["layers"]
        ck, cv, cidx = cache["k"], cache["v"], cache["idx"]
        for i in range(cfg.n_layers):
            lp = _layer(layers, i)
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            k_i, v_i, cidx = att.update_cache(lp["attn"], h, ck[i], cv[i],
                                              cidx, pos, cfg)
            x = x + att.decode_attention(lp["attn"], h, k_i, v_i, cidx, pos,
                                         cfg)
            h = rms_norm(x, lp["ln2"], cfg.norm_eps)
            y, _ = ffn_fwd(lp["ffn"], h, cfg, self._block_kind())
            x = x + y
        logits = lm_head(params["embed"], x, cfg)
        return logits, dict(cache, pos=pos + 1)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
