"""Model assembly: decoder-only LM, MoE LM, SSM, hybrid, enc-dec and the
vision prefix (the JAX package's ``models/transformer.py``).

The JAX ``lax.scan`` over parameters stacked on a leading L axis becomes a
Python loop over that axis; the stacked ``(L, ...)`` layout is kept, so a
parameter tree carries across leaf for leaf.  ``build_model(cfg)`` returns
a ``Model`` with:

  init(rng, device)              -> params        (this rank's, in a world)
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
layer inputs are kept for the backward.  Over a world with FSDP the body
gathers the layer's cut leaves, so the backward gathers them again, as
the reference's GSPMD re-gathers them each scan step.
``opt_attn_layout`` routes
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
from repro_torch.distributed.comm import (all_gather, copy_to, gather_from,
                                          reduce_from, scatter_to, split_to)

from . import attention as att
from . import mlp as mlp_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .common import (MetaDraws, ModelConfig, Par, dense_init, gather_cuts,
                     model_block, rms_norm, take_cuts, tree_leaves, tree_map,
                     tree_map_paths, tree_places, vocab_padded)


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


def _axis(par):
    """The model axis of ``par`` (None on one device)."""
    return None if par is None else par.model


def ffn_fwd(params, h, cfg: ModelConfig, kind: str, par=None):
    """The block's feed-forward: (output, aux); aux is empty for a dense
    block.  ``par``: ``h`` entered, the output this rank's part."""
    if kind == "moe":
        return moe_mod.moe_ffn(params, h, cfg, _axis(par))
    return mlp_mod.mlp(params, h, cfg), {}


def enter(h: torch.Tensor, par) -> torch.Tensor:
    """``h`` into a region cut over the model axis: the whole sequence
    gathered under sequence parallelism, else ``copy_to``."""
    if par is None:
        return h
    if par.sp:
        return gather_from(h, 1, par.model)
    return copy_to(h, par.model)


def leave(y: torch.Tensor, par) -> torch.Tensor:
    """The ranks' parts of a row-parallel product summed: into this rank's
    sequence shard under sequence parallelism, else whole."""
    if par is None:
        return y
    if par.sp:
        return scatter_to(y, 1, par.model)
    return reduce_from(y, par.model)


def block_fwd(params, x, pos, cfg: ModelConfig, kind: str, mask_kind: str,
              enc_out=None, enc_pos=None, prefix_len: int = 0, par=None):
    if kind == "mamba":
        h = rms_norm(x, params["ln1"], cfg.norm_eps)
        y, _ = ssm_mod.mamba_forward(params["mix"], enter(h, par), cfg,
                                     axis=_axis(par))
        return x + leave(y, par), {}
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    x = x + leave(att.attention(params["attn"], enter(h, par), pos, cfg,
                                mask_kind=mask_kind, prefix_len=prefix_len,
                                par=par), par)
    if enc_out is not None:
        h = rms_norm(x, params["lnx"], cfg.norm_eps)
        x = x + leave(att.attention(params["xattn"], enter(h, par), pos,
                                    cfg, mask_kind="bidir", kv_x=enc_out,
                                    kv_pos=enc_pos, par=par), par)
    h = rms_norm(x, params["ln2"], cfg.norm_eps)
    y, aux = ffn_fwd(params["ffn"], enter(h, par), cfg, kind, par)
    return x + leave(y, par), aux


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


def vocab_block(cfg: ModelConfig, par=None) -> tuple:
    """``(first id, block)`` of this rank's columns of the padded vocab
    (one device: ``(0, vocab_padded)``): blocks of ``ceil(Vp / M)``, the
    last one's columns past ``Vp`` padding like the padded vocab's."""
    m = 1 if par is None else par.model.size
    blk = model_block(vocab_padded(cfg), m)
    return (0 if par is None else par.model.rank) * blk, blk


def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig, par=None
                 ) -> torch.Tensor:
    """The token embeddings; over a model axis this rank's part of them
    (its vocab rows looked up, every other token zero), which the caller
    sums over the axis."""
    if par is None or par.model.size == 1:
        return params["tok"][tokens.long()]
    tok = params["tok"]
    ids = tokens.long() - vocab_block(cfg, par)[0]
    hit = (ids >= 0) & (ids < tok.shape[0])
    e = tok[ids.clamp(0, tok.shape[0] - 1)]
    return torch.where(hit[..., None], e, e.new_zeros(()))


def lm_head(params, x: torch.Tensor, cfg: ModelConfig, par=None
            ) -> torch.Tensor:
    """The final norm and the logits over the padded vocab, its padded
    columns -1e30; over a model axis this rank's block of columns, ``(B,
    S, ceil(Vp/M))`` (:func:`vocab_block`), from ``x`` entered as a block
    enters it (``par.sp``: ``x`` this rank's sequence shard)."""
    x = enter(rms_norm(x, params["ln_f"], cfg.norm_eps), par)
    V = cfg.vocab
    lo, blk = vocab_block(cfg, par)
    if cfg.tie_embeddings:
        w = params["tok"]
        if w.shape[0] < blk:
            w = torch.nn.functional.pad(w, (0, 0, 0, blk - w.shape[0]))
        logits = torch.einsum("bsd,vd->bsv", x, w)
    else:
        w = params["unembed"]
        if w.shape[1] < blk:
            w = torch.nn.functional.pad(w, (0, blk - w.shape[1]))
        logits = torch.einsum("bsd,dv->bsv", x, w)
    if lo + blk > V:
        pad = torch.arange(lo, lo + blk, device=x.device) >= V
        logits = torch.where(pad[None, None, :],
                             torch.tensor(-1e30, dtype=x.dtype,
                                          device=x.device), logits)
    return logits


def fsdp_gather(tree, places, par, shift: int = 0):
    """Every FSDP leaf of ``tree`` gathered whole over the data axis
    (``gather_from``: its backward reduce-scatters the gradient); ``shift``
    1 for a layer of a stacked tree."""
    if par is None or not par.fsdp:
        return tree
    return tree_map_paths(
        lambda path, t: t if _at(places, path).data is None else
        gather_from(t, _at(places, path).data - shift, par.data), tree)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


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
                cross: bool = False, cut=None):
    """``n`` blocks stacked on a leading axis, filled one layer at a time:
    beside the stack, one layer and one leaf's fp32 draw are alive.
    ``cut(path, leaf)``: the part of a whole layer's leaf to keep."""
    stacked = None
    for i in range(n):
        block = init_block(gen, cfg, kind, cross)
        if cut is not None:
            block = tree_map_paths(cut, block)
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
    world: Any = dataclasses.field(default=None, compare=False)

    @property
    def par(self) -> Any:
        """The model's view of its world (None on one device)."""
        return Par.of(self.cfg, self.world)

    def places(self, params) -> Any:
        """:func:`~.common.leaf_place` of every leaf of ``params`` over the
        world's mesh (``(1, 1)`` on one device)."""
        mesh = (1, 1) if self.world is None else self.world.mesh
        return tree_places(params, self.cfg, mesh)

    # ---------------- init -------------------------------------------------
    def init(self, rng: Union[int, torch.Generator] = 0, device=None
             ) -> Dict[str, Any]:
        """Parameters drawn from ``rng`` (a seed, or a generator whose
        device is then used); in a world this rank's slices of them, drawn
        whole a layer at a time (on the rank's device by default).  On
        ``meta`` their shapes alone (:class:`~.common.MetaDraws`)."""
        if isinstance(rng, (torch.Generator, MetaDraws)):
            gen = rng
        else:
            if device is None and self.world is not None:
                device = self.world.device
            device = resolve_device(device)
            if device.type == "meta":       # shapes only (the dry run)
                gen = MetaDraws()
            else:
                gen = torch.Generator(device=device)
                gen.manual_seed(int(rng))
        cfg = self.cfg
        cut = None
        if self.world is not None:
            mesh = self.world.mesh

            def cut(path, t, stacked=None):
                from .common import leaf_place
                place = leaf_place(((stacked,) if stacked else ()) + path,
                                   cfg, mesh)
                cuts = [(c[0] - (1 if stacked else 0),) + c[1:]
                        for c in place.cuts]
                part = take_cuts(t, cuts, self.world)
                return part if part is t else part.clone()

        def stack(n, kind, name, cross=False):
            return _stack_init(gen, cfg, n, kind, cross, cut and (
                lambda p, t: cut(p, t, name)))

        embed = init_embed(gen, cfg)
        params = {"embed": embed if cut is None else tree_map_paths(
                      lambda p, t: cut(("embed",) + p, t), embed),
                  "layers": stack(cfg.n_layers, self._block_kind(), "layers",
                                  cross=cfg.enc_layers > 0)}
        del embed
        if cfg.family == "hybrid" and cfg.shared_every:
            shared = init_block(gen, cfg, "attn")
            params["shared"] = shared if cut is None else tree_map_paths(
                lambda p, t: cut(("shared",) + p, t), shared)
            del shared
        if cfg.enc_layers:
            params["enc"] = stack(cfg.enc_layers, "attn", "enc")
        if cfg.frontend == "vision":
            # projection of the (stub) patch embeddings into d_model
            params["vproj"] = dense_init(gen, (cfg.d_model, cfg.d_model),
                                         cfg.tdtype)
        return params

    def shard(self, params) -> Dict[str, Any]:
        """This rank's slices of a whole params tree (copies)."""
        if self.world is None:
            return params
        places = self.places(params)
        return tree_map_paths(lambda p, t: take_cuts(
            t, _at(places, p).cuts, self.world).contiguous(), params)

    def gather(self, params) -> Dict[str, Any]:
        """The whole params tree from every rank's slices (every rank
        calls it; a leaf at a time)."""
        if self.world is None:
            return params
        places = self.places(params)
        return tree_map_paths(lambda p, t: gather_cuts(
            t, _at(places, p).cuts, self.world), params)

    def gather_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """The whole padded vocab's logits from every model rank's columns
        (the identity on one device; the last block's columns past the
        padded vocab dropped)."""
        par = self.par
        if par is None or par.model.size == 1:
            return logits
        return all_gather(logits.contiguous(), -1, par.model)[
            ..., :vocab_padded(self.cfg)]

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
                   enc_out=None, enc_pos=None, prefix_len: int = 0,
                   par=None, places=None, shared_places=None):
        """The blocks of a stack in order (the shared block after every
        ``shared_every``-th); returns (x, the summed load-balance loss).
        ``places``: the stack's, whose FSDP leaves each layer's body
        gathers (``shared_places``: the shared block's)."""
        cfg = self.cfg
        n = tree_leaves(layer_params)[0].shape[0]
        zero = torch.zeros((), dtype=torch.float32, device=x.device)

        def body(lp, x, with_shared: bool):
            lp = fsdp_gather(lp, places, par, shift=1)
            x, aux = block_fwd(lp, x, pos, cfg, kind, mask_kind,
                               enc_out=enc_out, enc_pos=enc_pos,
                               prefix_len=prefix_len, par=par)
            if with_shared:
                x, _ = block_fwd(fsdp_gather(shared, shared_places, par), x,
                                 pos, cfg, "attn", "swa", par=par)
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

    def _par(self, seq: int):
        """The model's :class:`~.common.Par` for a pass over ``seq``
        positions: sequence parallelism only where there is more than one
        (the sequence then split evenly over the model axis)."""
        par = self.par
        if par is None or not par.sp:
            return par
        if seq == 1:
            return dataclasses.replace(par, sp=False)
        if seq % par.model.size:
            raise ValueError(f"{self.cfg.name}: {seq} positions do not split "
                             f"over a model axis of {par.model.size} "
                             f"(sequence parallelism under cfg.fsdp)")
        return par

    def _encode(self, params, batch, places=None):
        """The encoder stack over the frame embeddings, bidirectional, rope
        on the frame positions; its raw output (no final norm), whole on
        every model rank."""
        frames = batch["enc_frames"].to(self.cfg.tdtype)
        par = self._par(frames.shape[1])
        enc_pos = torch.arange(frames.shape[1], dtype=torch.int32,
                               device=frames.device)
        if par is not None and par.sp:
            frames = split_to(frames, 1, par.model)
        enc_out, _ = self._run_stack(
            params["enc"], frames, enc_pos, "attn", "bidir", par=par,
            places=None if places is None else places["enc"])
        if par is not None:
            # whole for every decoder layer's K/V; backward, the ranks'
            # parts of its gradient summed
            enc_out = (gather_from(enc_out, 1, par.model) if par.sp
                       else copy_to(enc_out, par.model))
        return enc_out, enc_pos

    # ---------------- forward (train / prefill) ---------------------------
    def forward(self, params, batch, last_only: bool = False
                ) -> Tuple[torch.Tensor, Dict]:
        """``(logits, aux)``; in a world the logits are this rank's
        columns of the padded vocab (:meth:`gather_logits`)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        seq = tokens.shape[1] + (cfg.frontend_len
                                 if cfg.frontend == "vision" else 0)
        par = self._par(seq)
        places = None if par is None else self.places(params)
        embed = params["embed"] if places is None else fsdp_gather(
            params["embed"], places["embed"], par)
        x = embed_tokens(embed, tokens, cfg, par)
        prefix_len = 0
        if cfg.frontend == "vision":
            if par is not None:
                x = reduce_from(x, par.model)
            v = torch.einsum("bfd,de->bfe",
                             batch["frontend"].to(cfg.tdtype),
                             params["vproj"])
            x = torch.cat([v, x], dim=1)
            prefix_len = cfg.frontend_len
            if par is not None and par.sp:
                x = split_to(x, 1, par.model)
        elif par is not None:
            x = (scatter_to(x, 1, par.model) if par.sp
                 else reduce_from(x, par.model))
        pos = torch.arange(seq, dtype=torch.int32, device=x.device)
        enc_out = enc_pos = None
        if cfg.enc_layers:
            enc_out, enc_pos = self._encode(params, batch, places)
        mask_kind = "prefix" if prefix_len else self._mask_kind()
        x, lb = self._run_stack(params["layers"], x, pos, self._block_kind(),
                                mask_kind, shared=params.get("shared"),
                                enc_out=enc_out, enc_pos=enc_pos,
                                prefix_len=prefix_len, par=par,
                                places=None if places is None
                                else places["layers"],
                                shared_places=None if places is None
                                else places.get("shared"))
        if last_only:
            # serving prefill needs only the next-token logits
            if par is not None and par.sp:
                x = gather_from(x, 1, par.model)
                par = dataclasses.replace(par, sp=False)
            return lm_head(embed, x[:, -1:], cfg, par), {"lb_loss": lb}
        logits = lm_head(embed, x, cfg, par)
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
        if device is None and self.world is not None:
            device = self.world.device
        dev = resolve_device(device)
        if cfg.opt_kv_quant and cfg.family == "hybrid":
            raise TypeError(
                f"{cfg.name}: opt_kv_quant has no int8 cache for the "
                f"hybrid's shared attention block: the JAX package's "
                f"_shared_decode writes float K/V into its int8 shared_kv "
                f"and raises TypeError on the first decode step, so there "
                f"is no reference to hold one to (ROADMAP.md, Queue 3)")
        cache: Dict[str, Any] = {"pos": 0}
        par = self.par
        if cfg.family in ("ssm", "hybrid"):
            lo, hi = (0, cfg.ssm_heads) if par is None else \
                par.ssm_head_range(cfg)
            cache.update(ssm_mod.init_ssm_cache(
                cfg, cfg.n_layers, batch_size, device=dev, heads=hi - lo))
            if cfg.family == "hybrid" and cfg.shared_every:
                # each invocation sees other activations: its own slice
                n_inv = cfg.n_layers // cfg.shared_every
                cache["shared_kv"] = att.init_kv_cache(
                    cfg, n_inv, batch_size, min(max_len, cfg.window),
                    device=dev, par=par)
        else:
            cache.update(att.init_kv_cache(cfg, cfg.n_layers, batch_size,
                                           max_len, device=dev, par=par))
        if cfg.enc_layers:
            shape = (cfg.n_layers, batch_size, enc_len,
                     cache["k"].shape[3], cfg.hd)
            cache["xk"] = torch.zeros(shape, dtype=cfg.tdtype, device=dev)
            cache["xv"] = torch.zeros_like(cache["xk"])
        return cache

    def prefill_encoder(self, params, cache, batch):
        """Enc-dec: run the encoder and fill the cross-attention K/V cache
        of every decoder layer from its raw output."""
        par = self.par
        places = None if par is None else self.places(params)
        enc_out, _ = self._encode(params, batch, places)
        layers = params["layers"]
        xk, xv = [], []
        for i in range(self.cfg.n_layers):
            xp = self._layer(layers, i, places)["xattn"]
            wk, wv = att.kv_weights(xp, self.cfg, par)
            xk.append(torch.einsum("bsd,dhk->bshk", enc_out, wk))
            xv.append(torch.einsum("bsd,dhk->bshk", enc_out, wv))
        return dict(cache, xk=torch.stack(xk), xv=torch.stack(xv))

    def _layer(self, layers, i: int, places=None):
        """Layer ``i`` of the decoder stack, its FSDP leaves gathered."""
        lp = _layer(layers, i)
        if places is None:
            return lp
        return fsdp_gather(lp, places["layers"], self._par(1), shift=1)

    def decode_step(self, params, cache, tokens, pos):
        """tokens: (B, 1); pos: the position (int, or a 0-d tensor, read
        once), the same across the batch.  Writes this token's state (K/V
        slot, SSM state and convolution window) into the cache tensors in
        place and returns the cache with ``pos + 1``."""
        cfg = self.cfg
        pos = int(pos)
        par = self._par(1)
        places = None if par is None else self.places(params)
        embed = params["embed"] if places is None else fsdp_gather(
            params["embed"], places["embed"], par)
        x = embed_tokens(embed, tokens, cfg, par)
        if par is not None:
            x = reduce_from(x, par.model)
        layers = params["layers"]
        shared = params.get("shared")
        if shared is not None and places is not None:
            shared = fsdp_gather(shared, places["shared"], par)
        kind = self._block_kind()
        quant = "k_scale" in cache
        for i in range(cfg.n_layers):
            lp = self._layer(layers, i, places)
            if kind != "mamba":
                cross = ((cache["xk"][i], cache["xv"][i]) if cfg.enc_layers
                         else (None, None))
                scales = ((cache["k_scale"][i], cache["v_scale"][i])
                          if quant else (None, None))
                x = self._block_decode(lp, x, cache["k"][i], cache["v"][i],
                                       cache["idx"], pos, kind, *cross,
                                       *scales)
                continue
            h = enter(rms_norm(x, lp["ln1"], cfg.norm_eps), par)
            y, h_new, conv = ssm_mod.mamba_decode_step(
                lp["mix"], h, cache["h"][i], cache["conv"][i], cfg,
                _axis(par))
            cache["h"][i].copy_(h_new)
            cache["conv"][i].copy_(conv)
            x = x + leave(y, par)
            if self._shared_after(i):
                # invocation i // shared_every's KV slice; the slices share
                # one ``idx``
                kv, inv = cache["shared_kv"], i // cfg.shared_every
                x = self._block_decode(shared, x, kv["k"][inv],
                                       kv["v"][inv], kv["idx"], pos, "attn")
        logits = lm_head(embed, x, cfg, par)
        return logits, dict(cache, pos=pos + 1)

    def _block_decode(self, lp, x, cache_k, cache_v, cache_idx, pos: int,
                      kind: str, xk=None, xv=None, k_scale=None,
                      v_scale=None):
        """One attention block in decode: this token's K/V written into
        the cache slice in place (with its scales, for an int8 cache),
        attention over it, the cross-attention over the encoder's
        ``xk``/``xv`` when given, the feed-forward."""
        cfg = self.cfg
        par = self._par(1)
        h = enter(rms_norm(x, lp["ln1"], cfg.norm_eps), par)
        att.update_cache(lp["attn"], h, cache_k, cache_v, cache_idx, pos,
                         cfg, k_scale, v_scale, par)
        x = x + leave(att.decode_attention(lp["attn"], h, cache_k, cache_v,
                                           cache_idx, pos, cfg, k_scale,
                                           v_scale, par), par)
        if xk is not None:
            h = enter(rms_norm(x, lp["lnx"], cfg.norm_eps), par)
            x = x + leave(self._cross_decode(lp["xattn"], h, xk, xv, par),
                          par)
        h = enter(rms_norm(x, lp["ln2"], cfg.norm_eps), par)
        y, _ = ffn_fwd(lp["ffn"], h, cfg, kind, par)
        return x + leave(y, par)

    def _cross_decode(self, p, x, xk, xv, par=None):
        """One token's cross-attention over the encoder's K/V (no rope, no
        mask); ``par``: this rank's heads (:mod:`.attention`'s doc)."""
        cfg = self.cfg
        B = x.shape[0]
        q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
        H, hd = q.shape[2], cfg.hd
        if H == 0:                       # a rank with no heads
            return torch.einsum("bshk,hkd->bsd", q, p["wo"])
        idx = att.kv_index(cfg, par)
        xk, xv = att.per_head(xk, idx), att.per_head(xv, idx)
        KV = xk.shape[2]
        qg = q.reshape(B, KV, H // KV, hd)
        s = torch.einsum("bkgh,btkh->bkgt", qg, xk).float() * hd ** -0.5
        pr = torch.softmax(s, dim=-1).to(x.dtype)
        out = torch.einsum("bkgt,btkh->bkgh", pr, xv).reshape(B, 1, H, hd)
        return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def build_model(cfg: ModelConfig, world=None) -> Model:
    """The model of ``cfg``, over ``world``'s ranks where one is given
    (module doc; a model axis the family cannot take is refused)."""
    model = Model(cfg, world)
    model.par                               # the refusals, now
    return model
