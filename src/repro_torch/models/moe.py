"""Mixture-of-Experts layer: slot-table dispatch + top-k/matching routers
(the JAX package's ``models/moe.py``).

Dispatch is scatter-based (a MegaBlocks-style slot table), not the
(T, E, C) one-hot einsum of GShard:

  route   : logits -> (assign, slot, prob) per (token, choice)
  dispatch: scatter tokens into an (E*C+1, D) buffer whose last row is a
            dump for dropped instances
  expert  : batched GEMMs over the (E, C, D) buffer (``torch.bmm``; the
            JAX package leaves them to XLA, outside any Pallas kernel)
  combine : gather expert outputs back per (token, choice), weight, sum.

The JAX package's sharding specs and mesh are not ported (one card): the
local dispatch (``opt_moe_dispatch``) runs the one-shard form it takes with
no mesh.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.moe import route_matching, route_topk

from .common import ModelConfig, activate, dense_init, gelu


def init_moe(gen: torch.Generator, cfg: ModelConfig):
    """The JAX package's tree: router fp32 ``(D, E)``; ``w_in`` /
    ``w_gate`` ``(E, D, F)``, ``w_out`` ``(E, F, D)`` in the model dtype
    (``dense_init``'s ``fan_in`` is their first axis, E, as there); the
    shared expert's ``sh_*`` when ``moe_shared_expert``."""
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = cfg.tdtype
    gated = cfg.act in ("swiglu", "geglu")
    params = {"router": dense_init(gen, (D, E), torch.float32),
              "w_in": dense_init(gen, (E, D, F_), dt),
              "w_out": dense_init(gen, (E, F_, D), dt)}
    if gated:
        params["w_gate"] = dense_init(gen, (E, D, F_), dt)
    if cfg.moe_shared_expert:
        # llama4-style always-on shared expert (dense FFN in parallel)
        params["sh_in"] = dense_init(gen, (D, F_), dt)
        params["sh_out"] = dense_init(gen, (F_, D), dt)
        if gated:
            params["sh_gate"] = dense_init(gen, (D, F_), dt)
    return params


def capacity_for(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(math.ceil(cfg.capacity_factor * n_tokens * cfg.top_k
                      / cfg.n_experts))
    return max(8, ((c + 7) // 8) * 8)                   # lane-align


def _router(cfg: ModelConfig):
    return route_matching if cfg.router == "matching" else route_topk


def _expert_ffn(params, buf: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(E, N, D) -> (E, N, D): each expert's FFN on its rows."""
    h = torch.bmm(buf, params["w_in"])
    g = None
    if cfg.act in ("swiglu", "geglu"):
        g = torch.bmm(buf, params["w_gate"])
    return torch.bmm(activate(cfg.act, h, g), params["w_out"])


def _shared_expert(params, x: torch.Tensor, cfg: ModelConfig
                   ) -> torch.Tensor:
    h = torch.einsum("bsd,df->bsf", x, params["sh_in"])
    if cfg.act in ("swiglu", "geglu"):
        g = torch.einsum("bsd,df->bsf", x, params["sh_gate"])
        h = (F.silu(g) if cfg.act == "swiglu" else gelu(g)) * h
    else:
        h = gelu(h)
    return torch.einsum("bsf,fd->bsd", h, params["sh_out"])


def _aux(logits: torch.Tensor, assign: torch.Tensor, keep: torch.Tensor,
         E: int, n_inst: int) -> dict:
    """Switch-style load-balance loss and the drop rate, over every axis
    but the last of ``logits`` / ``assign``."""
    me = torch.softmax(logits, -1).reshape(-1, E).mean(0)
    live = (assign >= 0).reshape(-1)
    onehot = torch.zeros(E, dtype=torch.float32, device=logits.device)
    onehot = onehot.index_add(0, assign.reshape(-1).clamp(0, E - 1).long(),
                              live.float()) / max(1, n_inst)
    return {"lb_loss": E * torch.sum(me * onehot),
            "drop_rate": 1.0 - keep.sum() / n_inst}


def _routed(params, x: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, dict]:
    """What both dispatches share: route the B*S tokens, scatter each kept
    (token, choice) instance into an (E*C+1, D) buffer whose last row is
    the dump, run the experts over (E, C, D), gather each instance's
    output back and weight it.  Returns the (T, k, D) weighted outputs,
    zero for dropped instances, and ``aux``."""
    B, S, D = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.top_k
    C = capacity_for(cfg, T)
    xt = x.reshape(T, D)

    logits = xt.float() @ params["router"]
    assign, slot, prob = _router(cfg)(logits, k, C)

    flat_e = assign.reshape(T * k)
    keep = flat_e >= 0
    slot_id = torch.where(keep, flat_e * C + slot.reshape(T * k), E * C).long()
    # instance i is token i // k: a broadcast, not a gather
    inst = xt[:, None].expand(T, k, D).reshape(T * k, D)
    buf = x.new_zeros((E * C + 1, D)).index_copy_(0, slot_id, inst)
    out_buf = _expert_ffn(params, buf[: E * C].reshape(E, C, D), cfg)

    gathered = torch.where(
        keep[:, None], out_buf.reshape(E * C, D)[slot_id.clamp(0, E * C - 1)],
        0.0)
    w = prob.reshape(T * k, 1).to(x.dtype)
    return (gathered * w).reshape(T, k, D), _aux(logits, assign, keep, E,
                                                 T * k)


def _finish(params, x: torch.Tensor, out: torch.Tensor, cfg: ModelConfig
            ) -> torch.Tensor:
    out = out.reshape(x.shape)
    if cfg.moe_shared_expert:
        out = out + _shared_expert(params, x, cfg)
    return out


def moe_ffn_local_dispatch(params, x: torch.Tensor, cfg: ModelConfig
                           ) -> Tuple[torch.Tensor, dict]:
    """``opt_moe_dispatch``: locality-first expert dispatch, in the form
    the JAX function takes with no mesh, one shard, which routes and
    dispatches as :func:`moe_ffn` does.  Only its combine differs: a
    reshape-sum over the contiguous instances of each token."""
    contrib, aux = _routed(params, x, cfg)
    return _finish(params, x, contrib.sum(dim=1), cfg), aux


def moe_ffn(params, x: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, D) -> (B, S, D), aux metrics (load-balance loss, drops)."""
    if cfg.opt_moe_dispatch:
        return moe_ffn_local_dispatch(params, x, cfg)
    contrib, aux = _routed(params, x, cfg)
    # the JAX function's scatter-add over the token ids, whose k instances
    # of a token are contiguous: added in order, in x's dtype, no atomics
    out = contrib[:, 0]
    for j in range(1, cfg.top_k):
        out = out + contrib[:, j]
    return _finish(params, x, out, cfg), aux
